"""Geometric (sphere-aware) training losses (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/ops/losses.py``: ``LossHandler`` parses a
space-separated loss spec (the flagship's is ``'weighted absolute temp-std
squared geometric l2'``) into channel weights and a quadrature-based Lp loss
on the sphere. The weights are computed once on the host in float64 and held
as fp32 tensors; the loss itself is plain torch and differentiates through
autograd.

Spec words:
  weighted      per-channel weights: the 'auto' rule by variable class or an
                explicit list, renormalized to sum 1
  temp-std      times global_std / (sqrt(dt) * time_diff_std + eps), squared if
                the loss is squared; unit stats under
                ``data_loader_config: synthetic`` when the stats files are absent
  absolute      absolute norms instead of relative
  squared       skip the 1/p root
  geometric     sphere quadrature (the naive rule unless the model grid is
                legendre-gauss; plain 'l2' integrates with the same rule, as in
                the JAX package)
  l2 / l1       norm choice
  pole-masked   zero the first and last row of the quadrature weights
  h1            the SHT-based H1 loss (:class:`GeometricH1Loss`; it takes no
                channel weights, as in the JAX package)

The multistep weight is uniform over n_future + 1 steps and is applied in
training mode, which is also the default in validation, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from swin_v2_weather_torch.ops.quadrature import GridQuadrature
from swin_v2_weather_torch.ops.sht import RealSHT

_SURFACE_LOW = ("u10m", "v10m", "u100m", "v100m", "tp", "sp", "msl", "tcwv")
_SURFACE_T = ("t2m", "2d")
_PRESSURE_PREFIXES = ("z", "u", "v", "t", "r", "q")


def auto_channel_weights(channel_names: Sequence[str]) -> np.ndarray:
    """'auto' per-channel weights by variable class: surface winds, pressure and
    moisture 0.1, 2m temperature 1.0, pressure-level variables 0.001 * level,
    anything else 0.01."""
    weights = np.ones(len(channel_names), dtype=np.float64)
    for c, chn in enumerate(channel_names):
        if chn in _SURFACE_LOW:
            weights[c] = 0.1
        elif chn in _SURFACE_T:
            weights[c] = 1.0
        elif chn[0] in _PRESSURE_PREFIXES:
            weights[c] = 0.001 * float(chn[1:])
        else:
            weights[c] = 0.01
    return weights


class GeometricLpLoss:
    """Lp loss on the sphere via grid quadrature: ``__call__(prd, tar, chw)``
    with [B, C', H, W] fields and [1, C'] channel weights returns the summed
    scalar loss (sum over batch and channels)."""

    def __init__(
        self,
        img_shape: Tuple[int, int],
        crop_shape: Optional[Tuple[int, int]] = None,
        crop_offset: Tuple[int, int] = (0, 0),
        p: float = 2.0,
        size_average: bool = False,
        reduction: bool = True,
        absolute: bool = False,
        squared: bool = False,
        pole_mask: int = 0,
        quadrature_rule: str = "naive",
    ):
        self.p = p
        self.absolute = absolute
        self.squared = squared
        self.reduction = reduction
        self.size_average = size_average
        self.quadrature = GridQuadrature(
            quadrature_rule, img_shape=img_shape, crop_shape=crop_shape,
            crop_offset=crop_offset, normalize=True, pole_mask=pole_mask,
        )

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduction:
            return torch.mean(x) if self.size_average else torch.sum(x)
        return x

    def __call__(self, prd: torch.Tensor, tar: torch.Tensor, chw: torch.Tensor) -> torch.Tensor:
        b = prd.shape[0]
        norms = self.quadrature(torch.abs(prd - tar) ** self.p).reshape(b, -1)
        if not self.absolute:
            norms = norms / self.quadrature(torch.abs(tar) ** self.p).reshape(b, -1)
        if not self.squared:
            norms = norms ** (1.0 / self.p)
        return self._reduce(chw * norms)


class GeometricH1Loss:
    """Weighted H1 loss on the sphere through the SHT: per sample, the L2 norm
    and the H1 seminorm (weights l(l+1)) of the field from its spherical
    harmonic power, combined as alpha |.|_L2 + (1 - alpha) |.|_H1 (their
    squares when ``squared``), absolute or relative to the target's; summed
    over the batch (or averaged with ``size_average``). ``dtype`` is the
    transform's (fp32, as the JAX package's; fp64 for a reference). The
    Legendre matrix moves to the fields' device on the first call."""

    def __init__(self, img_shape: Tuple[int, int], size_average: bool = False,
                 reduction: bool = True, absolute: bool = False, squared: bool = False,
                 alpha: float = 0.5, dtype: torch.dtype = torch.float32):
        self.reduction = reduction
        self.size_average = size_average
        self.absolute = absolute
        self.squared = squared
        self.alpha = alpha
        self.sht = RealSHT(img_shape[0], img_shape[1], grid="equiangular", dtype=dtype)
        l = np.arange(self.sht.lmax, dtype=np.float64)
        self.h1_weights = torch.as_tensor(l * (l + 1.0), dtype=dtype)

    def _norms(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        coeffs = self.sht(x)
        power = coeffs.real ** 2 + coeffs.imag ** 2  # [..., l, m]
        # m = 0 counted once, m > 0 twice (the negative orders), per Parseval
        norm2 = power[..., :, 0] + 2.0 * torch.sum(power[..., :, 1:], dim=-1)
        l2_norm2 = norm2.reshape(b, -1).sum(dim=-1)
        h1_norm2 = (norm2 * self.h1_weights).reshape(b, -1).sum(dim=-1)
        return l2_norm2, h1_norm2

    def _combine(self, l2_norm2: torch.Tensor, h1_norm2: torch.Tensor) -> torch.Tensor:
        if not self.squared:
            return self.alpha * torch.sqrt(l2_norm2) + (1 - self.alpha) * torch.sqrt(h1_norm2)
        return self.alpha * l2_norm2 + (1 - self.alpha) * h1_norm2

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduction:
            return torch.mean(x) if self.size_average else torch.sum(x)
        return x

    def __call__(self, prd: torch.Tensor, tar: torch.Tensor,
                 chw: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.h1_weights.device != prd.device:  # once per device
            self.sht.to(prd.device)
            self.h1_weights = self.h1_weights.to(prd.device)
        l2_norm2, h1_norm2 = self._norms(prd - tar)
        if self.absolute:
            return self._reduce(self._combine(l2_norm2, h1_norm2))
        tl2, th1 = self._norms(tar)
        return self._reduce(self._combine(l2_norm2, h1_norm2) / self._combine(tl2, th1))


class LossHandler:
    """Parses the loss spec and computes the training/validation loss.

    Needs from params: loss, n_future, img_shape_x/y, n_out_channels,
    channel_names, channel_weights, out_channels, dt, global_stds_path,
    time_diff_stds_path, model_grid_type, data_loader_config.
    """

    def __init__(self, params):
        self.n_future = int(params.n_future)
        img_shape = (int(params.img_shape_x), int(params.img_shape_y))
        spec = set(str(params.loss).split())
        self.loss_type = params.loss
        pole_mask = 1 if "pole-masked" in spec else 0

        n_out = int(params.n_out_channels)
        if "weighted" in spec:
            if params.channel_weights == "auto":
                channel_weights = auto_channel_weights(params.channel_names)[:n_out]
            else:
                channel_weights = np.asarray(params.channel_weights, dtype=np.float64)
        else:
            channel_weights = np.ones(n_out, dtype=np.float64)
        channel_weights = channel_weights.reshape(1, -1, 1, 1)
        channel_weights = channel_weights / np.sum(channel_weights)

        absolute = "absolute" in spec
        squared = "squared" in spec
        if "temp-std" in spec:
            eps = 1e-6
            out_ch = np.asarray(params.out_channels)
            if os.path.exists(str(params.global_stds_path)) and os.path.exists(
                str(params.time_diff_stds_path)
            ):
                global_stds = np.load(params.global_stds_path).reshape(1, -1, 1, 1)[:, out_ch]
                raw_diff_stds = np.load(params.time_diff_stds_path).reshape(1, -1, 1, 1)[:, out_ch]
            elif str(getattr(params, "data_loader_config", "")) == "synthetic":
                # synthetic-data runs: unit-variance fields, no stats files
                global_stds = np.ones((1, len(out_ch), 1, 1))
                raw_diff_stds = np.ones((1, len(out_ch), 1, 1))
            else:
                raise FileNotFoundError(
                    "temp-std loss requires global_stds_path and "
                    f"time_diff_stds_path (got {params.global_stds_path!r}, "
                    f"{params.time_diff_stds_path!r})"
                )
            time_var_weights = global_stds / (np.sqrt(params.dt) * raw_diff_stds + eps)
            if squared:
                time_var_weights = time_var_weights**2
            channel_weights = channel_weights * time_var_weights
        self.channel_weights = torch.as_tensor(channel_weights, dtype=torch.float32)

        rule = "naive"
        if getattr(params, "model_grid_type", "equiangular") == "legendre_gauss":
            rule = "legendre-gauss"
        if "l2" in spec or "l1" in spec:
            self.loss_obj = GeometricLpLoss(
                img_shape, img_shape, (0, 0), p=2 if "l2" in spec else 1, absolute=absolute,
                squared=squared, pole_mask=pole_mask, quadrature_rule=rule,
            )
        elif "h1" in spec:
            self.loss_obj = GeometricH1Loss(img_shape, absolute=absolute, squared=squared)
        else:
            raise ValueError(f"Unknown loss function: {self.loss_type}")

        msw = np.ones(self.n_future + 1, dtype=np.float64) / float(self.n_future + 1)
        self.multistep_weight = torch.as_tensor(msw.reshape(-1, 1, 1, 1), dtype=torch.float32)

    def __call__(self, prd: torch.Tensor, tar: torch.Tensor, inp: Optional[torch.Tensor] = None,
                 training: bool = True) -> torch.Tensor:
        if self.channel_weights.device != prd.device:  # once per device: no copy per step
            self.channel_weights = self.channel_weights.to(prd.device)
            self.multistep_weight = self.multistep_weight.to(prd.device)
        chw = self.channel_weights
        if training:
            chw = chw * self.multistep_weight
        return self.loss_obj(prd, tar, chw.reshape(1, -1))
