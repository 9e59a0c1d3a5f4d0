"""The train step's loss and optimizer, written from their definitions.

Loss ('weighted absolute temp-std squared geometric l2'): per channel c the
squared error integrated over the sphere with the naive rule (weights
sin(colatitude) on linspace(0, pi, H), renormalized to 4 pi, divided by 4
pi), times w_c = a_c / sum(a) * (sigma_c / (sqrt(dt) * sigma_dt_c + 1e-6))^2,
a_c the variable class weight ('auto': surface winds, pressure, moisture
0.1; 2 m temperature 1; level variables 0.001 * level; else 0.01), summed
over channels and the batch.

Adam at (lr, beta1, beta2, eps): m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2)
g^2, p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

_SURFACE = ("u10m", "v10m", "u100m", "v100m", "tp", "sp", "msl", "tcwv")


def channel_weights(names: Sequence[str], global_stds: np.ndarray, diff_stds: np.ndarray,
                    dt: float) -> torch.Tensor:
    """[C] float32 loss weights of the squared temp-std loss."""
    a = np.array([0.1 if n in _SURFACE else 1.0 if n in ("t2m", "2d")
                  else 0.001 * float(n[1:]) if n[0] in "zuvtrq" else 0.01 for n in names])
    a = a / a.sum()
    ratio = np.ravel(global_stds) / (math.sqrt(dt) * np.ravel(diff_stds) + 1e-6)
    return torch.from_numpy((a * ratio**2).astype(np.float32))


def quadrature(h: int, w: int) -> torch.Tensor:
    """[H, W] float32 weights summing to 1."""
    jac = np.clip(np.sin(np.linspace(0.0, np.pi, h)), 0.0, None)
    q = np.tile(jac[:, None], (1, w))
    return torch.from_numpy((q / q.sum()).astype(np.float32))


def loss(pred: torch.Tensor, tar: torch.Tensor, chw: torch.Tensor,
         quad: torch.Tensor) -> torch.Tensor:
    """Sum over batch and channels of w_c * integral of (pred - tar)^2."""
    per = torch.sum((pred - tar) ** 2 * quad, dim=(-2, -1))  # [B, C]
    return torch.sum(per * chw)


class Adam:
    """Adam over a dict of leaf tensors (updated in place)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.95),
                 eps: float = 1e-8):
        self.params, self.lr, (self.b1, self.b2), self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
