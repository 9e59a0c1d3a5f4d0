"""Model registry: rebuild a trained model for serving.

Counterpart of ``swin_v2_weather_tpu/inference/registry.py``. The port's
registry directory keeps the JAX layout except for the weights:

    registry/<name>/
      weights.pt           - the model's state_dict (torch.save)
      hyperparams.yaml     - the dumped training config
      global_means.npy     - normalization stats
      global_stds.npy
      metadata.json        - channel names, grid info

A JAX registry stores its weights with orbax, which needs JAX to read; its
tree converts with ``models.convert.params_from_jax`` once read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import yaml
from torch import nn


class _DictParams(dict):
    """Attribute/dict hybrid over a plain config dict (YParams-compatible)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def get(self, k, default=None):
        return dict.get(self, k, default)

    @property
    def params(self):
        return self


def swin_from_yaml(yaml_path: str, dtype: Optional[torch.dtype] = None, device="cuda"):
    """(model on ``device``, params) from a dumped hyperparams.yaml.

    Serving rebuilds the single-step core: multi-step wrapping and spatial
    sharding are training-time constructs, so both are switched off.
    """
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.models.wrappers import get_model

    with open(yaml_path) as f:
        hp = yaml.safe_load(f)
    params = _DictParams(hp)
    params["in_channels"] = np.asarray(params["in_channels"])
    params["out_channels"] = np.asarray(params["out_channels"])
    if "n_in_channels" not in params:
        n_in, n_out = derived_channel_counts(params)
        params["n_in_channels"] = n_in
        params["n_out_channels"] = n_out
    params["n_future"] = 0
    params["spatial_shards"] = 1
    model = get_model(params, dtype=dtype, device=device)
    return model, params


def load_model(
    registry_dir: str, device, dtype: Optional[torch.dtype] = None
) -> Tuple[nn.Module, dict]:
    """(model on ``device`` in eval mode, params) from a registry directory."""
    device = torch.device(device)
    model, params = swin_from_yaml(
        os.path.join(registry_dir, "hyperparams.yaml"), dtype=dtype, device=device
    )
    state = torch.load(
        os.path.join(registry_dir, "weights.pt"), map_location=device, weights_only=True
    )
    model.load_state_dict(state)
    model.eval()
    # point stats paths at the registry copies when present
    for key in ("global_means_path", "global_stds_path", "time_means_path"):
        src = params.get(key)
        if src:
            local = os.path.join(registry_dir, os.path.basename(str(src)))
            if os.path.exists(local):
                params[key] = local
    return model, params
