"""Quadrature rules on the sphere (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/ops/quadrature.py``: the node and weight
generators and ``quadrature_weights`` are host-side numpy, copied so that the
port never imports the JAX package; :class:`GridQuadrature` holds the weights
as a tensor and integrates over the last two (lat, lon) axes.

  * 'naive': sin(colatitude) on nodes linspace(0, pi, H) including both
    endpoints, renormalized so the weights sum to 4 pi;
  * 'clenshaw-curtiss' and 'legendre-gauss': the classical rules in
    latitude times 2 pi / W in longitude;
  * ``normalize`` divides by 4 pi; ``pole_mask`` zeroes the first and last
    ``pole_mask`` rows.

:class:`GridConverter` interpolates fields from the equiangular grid to the
Legendre-Gauss latitudes (scoring and grid conversion, not the train path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def legendre_gauss_weights(n: int, a: float = -1.0, b: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes (ascending) and weights on [a, b]."""
    nodes, weights = np.polynomial.legendre.leggauss(n)
    nodes = 0.5 * (b - a) * nodes + 0.5 * (b + a)
    weights = 0.5 * (b - a) * weights
    return nodes.astype(np.float64), weights.astype(np.float64)


def clenshaw_curtiss_weights(n: int, a: float = -1.0, b: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Clenshaw-Curtis nodes (ascending, endpoints included) and weights on [a, b].

    Nodes are x_j = cos(pi j / (n - 1)), the equiangular latitude grid; the
    weights use the classical closed form.
    """
    if n < 2:
        raise ValueError("Clenshaw-Curtis requires n >= 2")
    l = n - 1
    j = np.arange(n)
    theta = np.pi * j / l
    k = np.arange(1, l // 2 + 1)
    b_k = np.where(k == l / 2.0, 1.0, 2.0)
    # w_j = (c_j / l) * (1 - sum_k b_k cos(2 k theta_j) / (4k^2 - 1))
    s = np.cos(2.0 * np.outer(theta, k)) @ (b_k / (4.0 * k**2 - 1.0))
    c_j = np.where((j == 0) | (j == l), 1.0, 2.0)
    w = (c_j / l) * (1.0 - s)
    nodes = np.cos(theta)
    order = np.argsort(nodes)
    nodes = 0.5 * (b - a) * nodes[order] + 0.5 * (b + a)
    w = 0.5 * (b - a) * w[order]
    return nodes, w


def quadrature_weights(
    quadrature_rule: str,
    img_shape: Tuple[int, int],
    crop_shape: Optional[Tuple[int, int]] = None,
    crop_offset: Tuple[int, int] = (0, 0),
    normalize: bool = False,
    pole_mask: Optional[int] = None,
) -> np.ndarray:
    """Per-pixel quadrature weights [H, W] (float64) for integrating over the sphere."""
    h, w = img_shape
    if quadrature_rule == "naive":
        jacobian = np.clip(np.sin(np.linspace(0.0, np.pi, h)), 0.0, None)
        dtheta = np.pi / h
        dlambda = 2.0 * np.pi / w
        quad_weight = np.tile((dlambda * dtheta) * jacobian[:, None], (1, w))
        quad_weight = quad_weight * (4.0 * np.pi) / np.sum(quad_weight)
    elif quadrature_rule in ("clenshaw-curtiss", "legendre-gauss"):
        rule = clenshaw_curtiss_weights if quadrature_rule == "clenshaw-curtiss" else (
            legendre_gauss_weights
        )
        _, wlat = rule(h, -1, 1)
        quad_weight = np.tile((2.0 * np.pi / w) * wlat[:, None], (1, w))
    else:
        raise ValueError(f"Unknown quadrature rule {quadrature_rule}")

    if normalize:
        quad_weight = quad_weight / (4.0 * np.pi)
    if pole_mask is not None and pole_mask > 0:
        quad_weight = quad_weight.copy()
        quad_weight[:pole_mask, :] = 0.0
        quad_weight[h - pole_mask :, :] = 0.0
    if crop_shape is not None:
        quad_weight = quad_weight[
            crop_offset[0] : crop_offset[0] + crop_shape[0],
            crop_offset[1] : crop_offset[1] + crop_shape[1],
        ]
    return np.ascontiguousarray(quad_weight)


class GridQuadrature:
    """Integrates fields over the last two (lat, lon) axes with precomputed
    [1, 1, H, W] fp32 weights, moved to the field's device on first use there."""

    def __init__(
        self,
        quadrature_rule: str,
        img_shape: Tuple[int, int],
        crop_shape: Optional[Tuple[int, int]] = None,
        crop_offset: Tuple[int, int] = (0, 0),
        normalize: bool = False,
        pole_mask: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
    ):
        w = quadrature_weights(
            quadrature_rule, img_shape, crop_shape, crop_offset, normalize, pole_mask
        )
        self.quad_weight = torch.as_tensor(w[None, None], dtype=dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.quad_weight.device != x.device:
            self.quad_weight = self.quad_weight.to(x.device)
        return torch.sum(x * self.quad_weight, dim=(-2, -1))


class GridConverter:
    """Equiangular -> Legendre-Gauss latitude interpolation (reference
    ``utils/grids.py:21-59``), linear between the two bracketing source rows.
    Latitudes are in radians; ``lat_rad`` is the source (descending, north to
    south, like ERA5) latitude array. The same grid on both sides is the
    identity; another destination raises ``NotImplementedError``."""

    def __init__(self, src_grid: str, dst_grid: str, lat_rad: np.ndarray, lon_rad: np.ndarray):
        self.src = src_grid
        self.dst = dst_grid
        self.src_lat = np.asarray(lat_rad, dtype=np.float64)
        self.src_lon = np.asarray(lon_rad, dtype=np.float64)
        self.dst_lon = self.src_lon
        self.indices = self.interp_weights = None
        if self.src == self.dst:
            self.dst_lat = self.src_lat
            return
        if self.dst != "legendre-gauss":
            raise NotImplementedError(f"destination grid type {self.dst} not implemented")
        cost_lg, _ = legendre_gauss_weights(self.src_lat.shape[0], -1, 1)
        # colatitude of the LG nodes, shifted to latitude in radians
        self.dst_lat = np.arccos(cost_lg) - np.pi / 2.0
        # the source latitudes descend: bracket each node in the ascending
        # copy, then translate the index back
        n = self.src_lat.shape[0]
        jj = np.searchsorted(self.src_lat[::-1], self.dst_lat) - 1
        self.indices = (n - 2 - jj).clip(0, n - 2)
        denom = np.diff(self.src_lat)[self.indices]
        self.interp_weights = ((self.dst_lat - self.src_lat[self.indices]) / denom).reshape(-1, 1)

    def get_src_coords(self):
        return self.src_lat, self.src_lon

    def get_dst_coords(self):
        return self.dst_lat, self.dst_lon

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        """``data`` [..., lat, lon] on the source grid -> the destination's."""
        if self.src == self.dst:
            return data
        idx = torch.as_tensor(self.indices, device=data.device)
        w = torch.as_tensor(self.interp_weights, dtype=data.dtype, device=data.device)
        lo = data[..., idx, :]
        hi = data[..., idx + 1, :]
        return lo + (hi - lo) * w
