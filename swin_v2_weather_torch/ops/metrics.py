"""Latitude-weighted forecast verification metrics (PyTorch port).

Counterpart of the deterministic metrics of ``swin_v2_weather_tpu/ops/metrics.py``.
The latitude weight at row j of an H-row grid is

    w_j = H * cos(lat_j) / sum_i cos(lat_i),   lat_j = 90 - j * 180 / (H - 1)

with the literal 3.1416 for pi, as the reference's torch twins use it, so
validation curves are comparable; the numpy oracles (``*_np``) use true pi,
as the reference's numpy functions do. Reductions run in the input dtype
(callers pass fp32).

Beside the deterministic RMSE and ACC: the unweighted ACC, the top-quantile
error (extremes skill) and the probabilistic metrics of
``inference/ensemble.py`` (CRPS with the sorted-member identity, ensemble
spread), with the numpy oracles the tests hold them to.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's torch twins hard-code 3.1416 for pi; keep it for parity
_TORCH_PI = 3.1416


def lat_np(j: np.ndarray, num_lat: int) -> np.ndarray:
    """Latitude in degrees of row j (0 = north pole row)."""
    return 90.0 - j * 180.0 / (num_lat - 1)


def latitude_weights_np(num_lat: int) -> np.ndarray:
    """[H] latitude weights with true pi (the reference's numpy functions)."""
    j = np.arange(num_lat, dtype=np.float64)
    coslat = np.cos(np.pi / 180.0 * lat_np(j, num_lat))
    return num_lat * coslat / np.sum(coslat)


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


def unweighted_acc_channels(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C] uncentered pattern correlation with no latitude
    weight."""
    num = torch.sum(pred * target, dim=(-1, -2))
    den = torch.sqrt(
        torch.sum(pred * pred, dim=(-1, -2)) * torch.sum(target * target, dim=(-1, -2))
    )
    return num / den


def _quantiles(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [Q, ...]: quantiles with linear interpolation between the
    sorted values, as ``jnp.quantile``'s default (position q * (n - 1) in
    q's dtype). Taken from one sort, so it has no size limit (``torch.quantile``
    refuses inputs above 2**24 elements, a few full-resolution channels)."""
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    pos = q * (n - 1)
    low = torch.floor(pos)
    hi_w = pos - low
    lo_i = low.long()
    hi_i = torch.clamp(lo_i + 1, max=n - 1)
    out = srt[..., lo_i] * (1 - hi_w) + srt[..., hi_i] * hi_w
    return out.movedim(-1, 0)


def top_quantiles_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [C] mean error of the top quantiles (extremes skill): 100
    log-spaced quantiles in [1 - 10^-0.1, 1 - 1e-3], linearly interpolated."""
    n, c, h, w = pred.shape
    qtile = 1.0 - torch.logspace(-3, -0.1, steps=100, dtype=pred.dtype, device=pred.device)
    p_tar = _quantiles(target.reshape(n, c, h * w), qtile)  # [Q, N, C]
    p_pred = _quantiles(pred.reshape(n, c, h * w), qtile)
    return torch.mean(torch.mean(p_pred - p_tar, dim=0), dim=0)


# ---------------------------------------------------------------------------
# probabilistic (ensemble) verification, used by inference/ensemble.py
# ---------------------------------------------------------------------------


def weighted_crps_channels(ensemble: torch.Tensor, target: torch.Tensor,
                           fair: bool = True) -> torch.Tensor:
    """[M, N, C, H, W] ensemble + [N, C, H, W] target -> [N, C] CRPS.

    Pointwise CRPS of the empirical ensemble distribution, E|X - y| - 1/2
    E|X - X'|, then the latitude-weighted spatial mean. The dispersion term
    takes the sorted-member identity sum_{m<m'} (x_(m') - x_(m)) = sum_i
    (2i - M + 1) x_(i): O(M log M), not the pairwise O(M^2). ``fair=True``
    divides by M (M - 1) (the finite-ensemble-unbiased estimator),
    ``fair=False`` by M^2 (the PWM estimator); one member gives the
    latitude-weighted MAE under both.
    """
    m = ensemble.shape[0]
    weight = _weight(ensemble[0])
    pointwise = torch.mean(torch.abs(ensemble - target[None]), dim=0)  # [N, C, H, W]
    if m > 1:
        srt = torch.sort(ensemble, dim=0).values
        coef = (2.0 * torch.arange(m, dtype=ensemble.dtype, device=ensemble.device)
                - m + 1).reshape((m,) + (1,) * (ensemble.dim() - 1))
        denom = m * (m - 1) if fair else m * m
        pointwise = pointwise - torch.sum(coef * srt, dim=0) / denom  # disp = E|X - X'| / 2
    return torch.mean(weight * pointwise, dim=(-1, -2))


def weighted_crps(ensemble: torch.Tensor, target: torch.Tensor, fair: bool = True) -> torch.Tensor:
    """[M, N, C, H, W] + [N, C, H, W] -> [C]: CRPS averaged over the batch."""
    return torch.mean(weighted_crps_channels(ensemble, target, fair=fair), dim=0)


def ensemble_spread_channels(ensemble: torch.Tensor) -> torch.Tensor:
    """[M, N, C, H, W] -> [N, C] spread = sqrt(latitude-weighted mean member
    variance), the variance with ddof = 1 (zero for one member)."""
    if ensemble.shape[0] > 1:
        var = torch.var(ensemble, dim=0, correction=1)
    else:
        var = torch.zeros_like(ensemble[0])
    return torch.sqrt(torch.mean(_weight(var) * var, dim=(-1, -2)))


def ensemble_spread(ensemble: torch.Tensor) -> torch.Tensor:
    """[M, N, C, H, W] -> [C]: spread averaged over the batch."""
    return torch.mean(ensemble_spread_channels(ensemble), dim=0)


# ---------------------------------------------------------------------------
# numpy oracles (the reference's utils/weighted_acc_rmse.py), for tests and
# offline scoring
# ---------------------------------------------------------------------------


def weighted_crps_np(ensemble: np.ndarray, target: np.ndarray, fair: bool = True) -> np.ndarray:
    """fp64 pairwise oracle of :func:`weighted_crps` ([M,N,C,H,W] -> [C]), on
    the same 3.1416-pi weights."""
    ensemble = np.asarray(ensemble, np.float64)
    target = np.asarray(target, np.float64)
    m = ensemble.shape[0]
    num_lat = ensemble.shape[-2]
    j = np.arange(num_lat, dtype=np.float64)
    coslat = np.cos(_TORCH_PI / 180.0 * lat_np(j, num_lat))
    weight = (num_lat * coslat / coslat.sum()).reshape(1, 1, -1, 1)
    mae = np.mean(np.abs(ensemble - target[None]), axis=0)
    disp = np.zeros_like(mae)
    if m > 1:
        for a in range(m):
            for b in range(m):
                disp += np.abs(ensemble[a] - ensemble[b])
        disp /= 2.0 * (m * (m - 1) if fair else m * m)
    return np.mean(np.mean(weight * (mae - disp), axis=(-1, -2)), axis=0)


def weighted_rmse_np(pred: np.ndarray, target: np.ndarray) -> float:
    """Single-field [H, W] or [1, H, W] latitude-weighted RMSE (true pi)."""
    if pred.ndim == 2:
        pred = pred[None]
    if target.ndim == 2:
        target = target[None]
    weight = latitude_weights_np(pred.shape[1])[:, None]
    return float(np.sqrt(np.mean(weight * (pred[0] - target[0]) ** 2)))


def weighted_acc_np(pred: np.ndarray, target: np.ndarray, weighted: bool = True) -> float:
    """Single-field latitude-weighted pattern correlation (true pi)."""
    if pred.ndim == 2:
        pred = pred[None]
    if target.ndim == 2:
        target = target[None]
    weight = latitude_weights_np(pred.shape[1])[:, None] if weighted else 1.0
    return float(
        (weight * pred * target).sum()
        / np.sqrt((weight * pred * pred).sum() * (weight * target * target).sum())
    )


def top_quantiles_error_np(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """[N, C, H, W] -> [C] numpy oracle of :func:`top_quantiles_error` (the
    reference's torch variant: 100 log-spaced quantiles in [1 - 1e-3,
    1 - 10^-0.1], linear interpolation), batch-averaged."""
    n, c, h, w = pred.shape
    qtile = 1.0 - np.logspace(-3, -0.1, num=100)
    p_tar = np.quantile(target.reshape(n, c, h * w), qtile, axis=-1)  # [Q, N, C]
    p_pred = np.quantile(pred.reshape(n, c, h * w), qtile, axis=-1)
    return np.mean(np.mean(p_pred - p_tar, axis=0), axis=0)
