"""Logging, the metrics sink, profiling hooks and visualization (counterpart of
``swin_v2_weather_tpu.utils``)."""
