"""swin_v2_weather_torch -- PyTorch/CUDA port of swin_v2_weather_tpu.

The port runs on an NVIDIA H100: plain tensor work is PyTorch, and every
Pallas kernel of the JAX package on a ported path is a CUDA kernel written by
hand for Hopper (``ops/csrc/``), built with nvcc at first use. The JAX package
stays the reference each slice is held against; the port never imports it.

Subpackages mirror the JAX layout:

config     YAML configuration system (shares the JAX package's swin.yaml)
data       static conditioning inputs, channel bookkeeping, the preprocessor,
           the synthetic and ERA5 datasets (native pread reader), the
           threaded loader with its pinned ring and the CUDA-stream
           prefetch, archive statistics
ops        zenith angle, quadrature, losses, metrics; the fused
           window-attention, fc1+GELU and whole-MLP kernels (forward and
           backward) with their plain PyTorch versions
models     SwinV2 in PyTorch (train mode with drop-path, the CPB dropout and
           JAX's proj/attn/MLP dropout on every attention route, outside
           spatial sharding), the single- and multi-step wrappers, JAX
           weight conversion
training   Adam, the LR schedules, the train and eval steps, the Trainer,
           torch checkpoints, preemption, the native sweep agent
inference  model registry and the autoregressive rollout engine
utils      logging, the metrics sink, the profiler window, plots
train      the training CLI (``python -m swin_v2_weather_torch.train``)
"""

__version__ = "0.1.0"

# Lazy top-level re-exports: importing the package loads no submodule (and
# builds nothing).
_LAZY = {
    "YParams": ("swin_v2_weather_torch.config.yparams", "YParams"),
    "default_config_path": ("swin_v2_weather_torch.config.yparams", "default_config_path"),
    "get_model": ("swin_v2_weather_torch.models.wrappers", "get_model"),
    "SwinTransformerV2": ("swin_v2_weather_torch.models.swin", "SwinTransformerV2"),
    "params_from_jax": ("swin_v2_weather_torch.models.convert", "params_from_jax"),
    "RolloutEngine": ("swin_v2_weather_torch.inference.rollout", "RolloutEngine"),
    "LossHandler": ("swin_v2_weather_torch.ops.losses", "LossHandler"),
    "Preprocessor": ("swin_v2_weather_torch.data.preprocess", "Preprocessor"),
    "build_optimizer": ("swin_v2_weather_torch.training.optim", "build_optimizer"),
    "build_train_step": ("swin_v2_weather_torch.training.step", "build_train_step"),
    "build_eval_step": ("swin_v2_weather_torch.training.step", "build_eval_step"),
    "load_model": ("swin_v2_weather_torch.inference.registry", "load_model"),
    "Trainer": ("swin_v2_weather_torch.training.trainer", "Trainer"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
