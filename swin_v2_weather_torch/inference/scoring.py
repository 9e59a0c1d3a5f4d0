"""Forecast scoring: latitude-weighted RMSE and anomaly correlation (ACC).

Counterpart of ``swin_v2_weather_tpu/inference/scoring.py``. ACC is the
latitude-weighted uncentered pattern correlation of anomalies: fields minus a
time-mean climatology (the registry's ``time_means.npy``), as the reference's
metrics define it.

The metric math runs on the engine's device in fp32; only per-(step, channel)
rows reach the host: once a step on the host-stepped path, once a chunk on
the chunked one (the same numbers, fewer synchronizations). Each target's
copy to the device, each step's scoring and each copy of rows to the host is
a profiler span (``swin/forecast/upload``, ``.../score``, ``.../flush``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from swin_v2_weather_torch.ops.metrics import weighted_acc, weighted_rmse
from swin_v2_weather_torch.utils.profiling import span


def acc_against_climatology(pred, target, climatology) -> torch.Tensor:
    """Latitude-weighted ACC [C] of anomalies with respect to a time-mean
    climatology, on the device of ``pred`` (a tensor) or on the CPU."""
    dev = pred.device if torch.is_tensor(pred) else None
    clim = torch.as_tensor(climatology, dtype=torch.float32, device=dev)
    return weighted_acc(
        torch.as_tensor(pred, dtype=torch.float32, device=dev) - clim,
        torch.as_tensor(target, dtype=torch.float32, device=dev) - clim,
    )


def _on(x, device, shape=None) -> torch.Tensor:
    """An array or tensor as fp32 on ``device``, reshaped to ``shape`` if given."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return t if shape is None else t.reshape(shape)


def score_rollout(
    engine,
    initial_state,  # [B, C_out, H, W] normalized
    targets: Sequence[np.ndarray],  # [B, C_out, H, W] normalized, one a lead time
    start_time,
    means: np.ndarray,  # [C_out, 1, 1] denormalization
    stds: np.ndarray,
    climatology: Optional[np.ndarray] = None,  # [C_out, H, W] physical units
    channel_names: Optional[Sequence[str]] = None,
    scanned: bool = False,
    chunk: int = 8,
) -> Dict[str, np.ndarray]:
    """Run a rollout and score each lead time against its target.

    Returns {'rmse': [T, C], 'acc': [T, C], 'lead_hours': [T]} ('acc' only
    with a climatology; 'channels' with names). Targets are streamed: one
    step of them on the device at a time.

    ``scanned=True`` takes the chunked path: ``chunk``-step calls of
    :meth:`RolloutEngine.rollout_chunk` carry the state from chunk to chunk,
    with the zenith stack computed up front and copied over once a chunk and
    one copy of the rows to the host a chunk, where the host-stepped loop
    synchronizes every step. Same math, same results; the device holds one
    chunk of predictions, so any trajectory length fits.
    """
    dev = engine.device
    means_d = _on(means, dev, (1, -1, 1, 1))
    stds_d = _on(stds, dev, (1, -1, 1, 1))
    clim = None if climatology is None else _on(climatology, dev,
                                                (1,) + tuple(np.shape(climatology)[-3:]))

    rows = {"rmse": [], "acc": []}
    pending = {"rmse": [], "acc": []}

    def score_one(pred, tar):
        with span("forecast/upload"):
            tar_d = _on(tar, dev)
        with span("forecast/score"):
            pred_phys = pred * stds_d + means_d
            tar_phys = tar_d * stds_d + means_d
            pending["rmse"].append(weighted_rmse(pred_phys, tar_phys))
            if clim is not None:
                pending["acc"].append(weighted_acc(pred_phys - clim, tar_phys - clim))

    def flush():  # one device -> host copy of the rows scored since the last
        with span("forecast/flush"):
            for key, vals in pending.items():
                if vals:
                    rows[key].extend(torch.stack(vals).cpu().numpy())
                    vals.clear()

    with torch.inference_mode():
        if scanned:
            state = initial_state
            for done, zstack in engine.zenith_chunks(start_time, len(targets), chunk):
                state, preds = engine.rollout_chunk(state, zstack)
                for s in range(len(zstack)):
                    score_one(preds[s], targets[done + s])
                flush()
        else:
            targets_it = iter(targets)
            for pred in engine.steps(initial_state, start_time, n_steps=len(targets)):
                score_one(pred, next(targets_it))
                flush()

    out: Dict[str, np.ndarray] = {
        "rmse": np.stack(rows["rmse"]),
        "lead_hours": np.arange(1, len(rows["rmse"]) + 1) * engine.hours_per_step,
    }
    if rows["acc"]:
        out["acc"] = np.stack(rows["acc"])
    if channel_names is not None:
        out["channels"] = np.asarray(list(channel_names))
    return out
