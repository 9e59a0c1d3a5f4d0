"""Real spherical harmonic transform (SHT) in matmul form (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/ops/sht.py``, which the H1 loss
(``ops/losses.py`` ``GeometricH1Loss``) needs: an rFFT over longitude, then
per order m a Legendre transform over latitude as one batched product
against a precomputed associated Legendre matrix (``torch.fft.rfft`` and
``torch.bmm``; the JAX package computes it outside any Pallas kernel too).

Conventions (torch_harmonics' defaults, as in the JAX package):
  - grid='equiangular': latitude nodes cos(theta_j), theta_j = pi*j/(nlat-1)
    (poles included), Clenshaw-Curtis weights; grid='legendre-gauss':
    Gauss-Legendre nodes and weights;
  - lmax = nlat, mmax = nlon // 2 + 1;
  - orthonormal spherical harmonics with the Condon-Shortley phase, so
    |f|^2 = sum_l |f_hat[l, 0]|^2 + 2 sum_{m>0} |f_hat[l, m]|^2.

The Legendre matrix is computed on the host in float64 by the three-term
recursion (:func:`legendre_matrix`, a copy of the JAX package's) and kept on
the module's device as a non-persistent buffer, order-major [mmax, nlat,
lmax] so each order's slice is one operand of the batched product. At the
full 720 x 1440 grid that is [721, 720, 720]: 1.5 GB in fp32 per transform.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from swin_v2_weather_torch.ops.quadrature import clenshaw_curtiss_weights, legendre_gauss_weights


def legendre_matrix(nlat: int, lmax: int, mmax: int,
                    grid: str = "equiangular") -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal associated Legendre values Pbar_l^m(cos theta_j).

    Returns (pct [nlat, lmax, mmax] float64, weights [nlat] float64); entries
    with l < m are zero. The JAX package's recursion, bit for bit, run on an
    [mmax, lmax, nlat] array (each step reads and writes contiguous latitude
    rows) and returned as a transposed view.
    """
    if grid == "equiangular":
        theta = np.pi * np.arange(nlat) / (nlat - 1)
        x = np.cos(theta)
        _, w_asc = clenshaw_curtiss_weights(nlat, -1, 1)
        # weights for ascending nodes; x here is descending -> reverse
        w = w_asc[::-1].copy()
    elif grid == "legendre-gauss":
        nodes, w_asc = legendre_gauss_weights(nlat, -1, 1)
        # colatitude ascending => cos(theta) descending
        x = nodes[::-1].copy()
        w = w_asc[::-1].copy()
    else:
        raise ValueError(f"unknown grid {grid}")

    sint = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    work = np.zeros((mmax, lmax, nlat), dtype=np.float64)

    mmax_eff = min(mmax, lmax)
    # diagonal terms Pbar_m^m via recursion (Condon-Shortley phase)
    pmm = np.full(nlat, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(mmax_eff):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sint * pmm
        work[m, m] = pmm
        if m + 1 < lmax:
            work[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            work[m, l] = a * (x * work[m, l - 1] - b * work[m, l - 2])
    return work.transpose(2, 1, 0), w


def _order_major(pct: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """[nlat, lmax, mmax] float64 -> [mmax, nlat, lmax] in ``dtype``."""
    return torch.from_numpy(pct.transpose(2, 0, 1)).to(dtype, memory_format=torch.contiguous_format)


def _per_order(f: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """out[..., b, m] = sum_a f[..., a, m] mat[m, a, b] for complex f: the real
    and imaginary parts of every leading index in one batched product over
    m."""
    lead, (na, m) = f.shape[:-2], f.shape[-2:]
    fr = torch.view_as_real(f).reshape(-1, na, m, 2)  # [N, a, m, 2]
    n = fr.shape[0]
    fr = fr.permute(2, 3, 0, 1).reshape(m, 2 * n, na)  # [m, 2N, a]
    out = torch.bmm(fr, mat).reshape(m, 2, n, -1)  # [m, 2, N, b]
    out = torch.complex(out[:, 0], out[:, 1]).permute(1, 2, 0)  # [N, b, m]
    return out.reshape(*lead, out.shape[-2], m)


class RealSHT(nn.Module):
    """Forward real SHT: [..., nlat, nlon] -> complex [..., lmax, mmax]."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or (nlon // 2 + 1)
        self.grid = grid
        pct, w = legendre_matrix(nlat, self.lmax, self.mmax, grid)
        # fold the quadrature weights and the 2 pi / nlon longitude measure
        # into the Legendre matrix, so the transform is one contraction
        pct *= w[:, None, None] * (2.0 * np.pi / nlon)
        self.register_buffer("weighted_pct", _order_major(pct, dtype), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # rfft over longitude (unnormalized sums; the measure is in the matrix)
        f = torch.fft.rfft(x.to(self.weighted_pct.dtype), dim=-1)[..., : self.mmax]
        return _per_order(f, self.weighted_pct)


class InverseRealSHT(nn.Module):
    """Inverse real SHT: complex [..., lmax, mmax] -> [..., nlat, nlon]."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or (nlon // 2 + 1)
        pct, _ = legendre_matrix(nlat, self.lmax, self.mmax, grid)
        self.register_buffer("pct", _order_major(pct, dtype), persistent=False)

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        # per-order latitude profiles, then the inverse rfft of unnormalized sums
        f = _per_order(coeffs, self.pct.transpose(1, 2))  # [..., nlat, mmax]
        full_m = self.nlon // 2 + 1
        if self.mmax < full_m:  # orders past mmax are zero
            f = torch.nn.functional.pad(f, (0, full_m - self.mmax))
        return torch.fft.irfft(f, n=self.nlon, dim=-1) * self.nlon
