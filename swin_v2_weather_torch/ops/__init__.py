"""Numerics: the zenith angle, quadrature, losses and metrics, and the
hand-written CUDA kernels with their plain PyTorch versions (counterpart of
``swin_v2_weather_tpu.ops``)."""
