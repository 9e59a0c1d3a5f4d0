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
:func:`export_model` writes a registry from a port experiment directory (the
Trainer's ``hyperparams.yaml`` and ``training_checkpoints/<name>/checkpoint.pt``);
:func:`load_model` reads it back and :func:`load_stats` its statistics.
"""

from __future__ import annotations

import json
import os
import shutil
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


def export_model(experiment_dir: str, out_dir: str, checkpoint: str = "best_ckpt") -> str:
    """Export a trained experiment into a registry directory: the model's
    state_dict alone as ``weights.pt``, the dumped config, the statistics files
    it names and ``metadata.json`` with the JAX registry's fields."""
    from swin_v2_weather_torch.training.checkpoint import CHECKPOINT_FILE

    os.makedirs(out_dir, exist_ok=True)
    hp_path = os.path.join(experiment_dir, "hyperparams.yaml")
    with open(hp_path) as f:
        hp = yaml.safe_load(f)

    ckpt = os.path.join(experiment_dir, "training_checkpoints", checkpoint, CHECKPOINT_FILE)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    torch.save(payload["model"], os.path.join(out_dir, "weights.pt"))

    shutil.copy(hp_path, os.path.join(out_dir, "hyperparams.yaml"))
    for stats_key in ("global_means_path", "global_stds_path", "time_means_path"):
        src = hp.get(stats_key)
        if src and os.path.exists(str(src)):
            shutil.copy(src, os.path.join(out_dir, os.path.basename(str(src))))

    grid = hp.get("img_size", [720, 1440])
    metadata = {
        "architecture": hp.get("nettype", "swin"),
        "n_history": 0,
        "channel_names": hp.get("channel_names"),
        "in_channels": hp.get("in_channels"),
        "out_channels": hp.get("out_channels"),
        "grid": [grid[0], grid[1]],
        "dt_hours": 6 * int(hp.get("dt", 1)),
        "add_zenith": bool(hp.get("add_zenith", False)),
        "add_orography": bool(hp.get("add_orography", False)),
        "add_landmask": bool(hp.get("add_landmask", False)),
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)
    return out_dir


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


def load_stats(params) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(means[C_out], stds[C_out], time_means[C_out, H, W] or None) of the
    output channels, from the paths in ``params``."""
    out_ch = np.asarray(params["out_channels"])
    means = np.load(params["global_means_path"])[0, out_ch, 0, 0]
    stds = np.load(params["global_stds_path"])[0, out_ch, 0, 0]
    tm = None
    tm_path = params.get("time_means_path")
    if tm_path and os.path.exists(str(tm_path)):
        tm = np.load(tm_path)[0, out_ch]
    return means, stds, tm
