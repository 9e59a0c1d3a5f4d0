"""Latitude-weighted forecast verification metrics (PyTorch port).

Counterpart of the deterministic metrics of ``swin_v2_weather_tpu/ops/metrics.py``.
The latitude weight at row j of an H-row grid is

    w_j = H * cos(lat_j) / sum_i cos(lat_i),   lat_j = 90 - j * 180 / (H - 1)

with the literal 3.1416 for pi, as the reference's torch twins use it, so
validation curves are comparable. Reductions run in the input dtype (callers
pass fp32). The probabilistic (ensemble) metrics come with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's torch twins hard-code 3.1416 for pi; keep it for parity
_TORCH_PI = 3.1416


def lat_np(j: np.ndarray, num_lat: int) -> np.ndarray:
    """Latitude in degrees of row j (0 = north pole row)."""
    return 90.0 - j * 180.0 / (num_lat - 1)


def latitude_weights(num_lat: int, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """[H] latitude weights (3.1416-pi, computed in float64, then cast)."""
    j = np.arange(num_lat, dtype=np.float64)
    coslat = np.cos(_TORCH_PI / 180.0 * lat_np(j, num_lat))
    return torch.as_tensor(num_lat * coslat / np.sum(coslat), dtype=dtype, device=device)


def _weight(pred: torch.Tensor) -> torch.Tensor:
    return latitude_weights(pred.shape[-2], pred.dtype, pred.device).reshape(1, 1, -1, 1)


def weighted_rmse_channels(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C] latitude-weighted RMSE per channel."""
    return torch.sqrt(torch.mean(_weight(pred) * (pred - target) ** 2, dim=(-1, -2)))


def weighted_rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [C]: per-channel RMSE averaged over the batch."""
    return torch.mean(weighted_rmse_channels(pred, target), dim=0)


def weighted_acc_channels(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C] latitude-weighted (uncentered) anomaly correlation;
    anomalies are the caller's responsibility."""
    weight = _weight(pred)
    num = torch.sum(weight * pred * target, dim=(-1, -2))
    den = torch.sqrt(
        torch.sum(weight * pred * pred, dim=(-1, -2))
        * torch.sum(weight * target * target, dim=(-1, -2))
    )
    return num / den


def weighted_acc(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [C]: per-channel ACC averaged over the batch."""
    return torch.mean(weighted_acc_channels(pred, target), dim=0)
