"""Forecast scores, written from their definitions, in float64.

Latitude weight of row j of H: w_j = H cos(lat_j) / sum_i cos(lat_i), lat_j =
90 - j * 180 / (H - 1) degrees, with pi taken as 3.1416 (the convention the
weather-model literature's scoring code fixed). Per channel:

  * RMSE: sqrt(mean over the grid of w (f - y)^2);
  * ACC: sum w f' y' / sqrt(sum w f'^2 * sum w y'^2), anomalies from the
    climatology;
  * fair CRPS of M members: mean_m |x_m - y| - sum_{m, m'} |x_m - x_m'| /
    (2 M (M - 1)), then the latitude-weighted mean;
  * spread: sqrt(latitude-weighted mean of the members' variance, ddof 1).

Fields are in physical units: normalized state * std + mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def lat_weight(h: int, device) -> torch.Tensor:
    lat = 90.0 - np.arange(h, dtype=np.float64) * 180.0 / (h - 1)
    cos = np.cos(3.1416 / 180.0 * lat)
    return torch.as_tensor(h * cos / cos.sum(), device=device).reshape(-1, 1)


def _wmean(x: torch.Tensor) -> torch.Tensor:
    """Latitude-weighted mean over the last two axes."""
    return torch.mean(x * lat_weight(x.shape[-2], x.device), dim=(-2, -1))


def rmse(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., C]."""
    return torch.sqrt(_wmean((f - y) ** 2))


def acc(f: torch.Tensor, y: torch.Tensor, clim: torch.Tensor) -> torch.Tensor:
    fa, ya = f - clim, y - clim
    w = lat_weight(f.shape[-2], f.device)
    dims = (-2, -1)
    return torch.sum(w * fa * ya, dims) / torch.sqrt(
        torch.sum(w * fa * fa, dims) * torch.sum(w * ya * ya, dims))


def deterministic(f, y, clim) -> Dict[str, torch.Tensor]:
    """Scores of one [C, H, W] forecast against its target, as [C] rows."""
    return {"rmse": rmse(f, y), "acc": acc(f, y, clim)}


def ensemble(members: torch.Tensor, y: torch.Tensor, clim) -> Dict[str, torch.Tensor]:
    """Scores of [M, C, H, W] members against the [C, H, W] target."""
    m = members.shape[0]
    mae = torch.mean(torch.abs(members - y), dim=0)
    disp = torch.zeros_like(mae)
    for a in range(m):
        disp += torch.sum(torch.abs(members[a] - members), dim=0)
    crps = _wmean(mae - disp / (2.0 * m * (m - 1)))
    mean = torch.mean(members, dim=0)
    out = {"crps": crps,
           "spread": torch.sqrt(_wmean(torch.var(members, dim=0, correction=1))),
           "rmse_mean": rmse(mean, y), "rmse_control": rmse(members[0], y)}
    if clim is not None:
        out["acc_mean"] = acc(mean, y, clim)
    return out
