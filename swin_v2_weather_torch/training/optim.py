"""Optimizer and learning-rate schedules (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/training/optim.py``:

  * ``optimizer_type: 'adam'`` -- Adam with betas (0.9, 0.95) and eps 1e-8,
    the update optax.adam makes: lr * m_hat / (sqrt(v_hat) + eps);
  * ``'FusedLAMB'`` / ``'lamb'`` -- :class:`Lamb`, the update of optax's
    ``chain(clip_by_global_norm(max_grad_norm or 5), lamb(lr))``;
  * the schedules are stepped once per epoch on the host, and the learning
    rate goes into the optimizer's ``param_groups`` from the host
    (:func:`set_learning_rate`), as the JAX package injects it into the optax
    state.

Under ZeRO-1 (``ZeroRedundancyOptimizer``, each rank stepping whole
parameters of its own) and FSDP2 (each rank holding a shard of every
parameter) the optimizer is built from :func:`optimizer_spec` by
``training/step.shard_state``; :class:`Lamb` then takes ``norm_group``, the
group whose ranks hold the other parameters or shards, so that its global
clip norm and its per-parameter trust ratios are of whole parameters.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


def optimizer_spec(params):
    """(optimizer class, its keyword arguments) of the config's optimizer."""
    opt_type = str(params.optimizer_type)
    if opt_type == "adam":
        return torch.optim.Adam, dict(lr=float(params.lr), betas=(0.9, 0.95), eps=1e-8)
    if opt_type in ("FusedLAMB", "lamb"):
        return Lamb, dict(lr=float(params.lr),
                          max_grad_norm=float(getattr(params, "max_grad_norm", None) or 5.0))
    raise ValueError(f"optimizer type {opt_type} not implemented")


def build_optimizer(params, parameters: Iterable[torch.nn.Parameter],
                    norm_group=None) -> torch.optim.Optimizer:
    """Optimizer factory over the model's parameters; ``norm_group`` goes to
    :class:`Lamb` (Adam's update is elementwise)."""
    cls, kwargs = optimizer_spec(params)
    optimizer = cls(parameters, **kwargs)
    if isinstance(optimizer, Lamb):
        optimizer.norm_group = norm_group
    return optimizer


def local_part(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP2), else the tensor."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _sq_norms(tensors) -> torch.Tensor:
    """The squared L2 norm of each tensor, stacked."""
    return torch.stack(torch._foreach_norm(tensors)) ** 2


def _bias_correction(decay: float, step: int) -> float:
    """1 - decay^step in fp32, as optax computes it (1 - 0.999 is 1.3e-5 off
    0.001 there)."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(step)))


class Lamb(torch.optim.Optimizer):
    """LAMB after a global-norm clip, as optax's ``chain(clip_by_global_norm(
    max_grad_norm), lamb(lr, b1, b2, eps))`` (eps_root 0, weight decay 0):

      * g <- g if |g| < max_grad_norm else g / |g| * max_grad_norm, |g| the
        norm over every parameter's gradient (``torch.nn.utils.
        clip_grad_norm_`` adds 1e-6 to the norm, so it is not used);
      * m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2 and the Adam update
        u = m_hat / (sqrt(v_hat) + eps) with the bias corrections 1 - b^t;
      * u <- u * |p| / |u| per parameter tensor (each is one JAX leaf,
        ``models/convert.py``), 1 where either norm is 0 (the blocks'
        LayerNorm scales start at 0);
      * p <- p - lr u, the learning rate read from the group at each step
        (:func:`set_learning_rate`).

    A parameter without a gradient takes a zero one, as an optax leaf does.
    Plain tensor ops (``torch._foreach_*``), no host sync; the state per
    parameter is its step count and the two moments, so it goes through the
    torch checkpoint as Adam's does.

    ``norm_group``: the ranks that hold the rest of the state. The squared
    norms are summed over it: the global clip's alone where each rank holds
    whole parameters (ZeRO-1), the per-parameter ones too where the
    parameters are DTensor shards (FSDP2, whose every rank lists every
    parameter). The elementwise update runs on each rank's local part.
    """

    def __init__(self, params, lr: float, max_grad_norm: float = 5.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6):
        super().__init__(params, dict(lr=float(lr), b1=float(b1), b2=float(b2),
                                      eps=float(eps)))
        self.max_grad_norm = float(max_grad_norm)
        self.norm_group = None  # set where the state is sharded (build_optimizer)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [g for g in self.param_groups if g["params"]]
        grads = [[local_part(torch.zeros_like(p) if p.grad is None else p.grad)
                  for p in g["params"]] for g in groups]
        flat = [t for gs in grads for t in gs]
        group_norms = self.norm_group is not None
        # FSDP2: every parameter a shard, so its norms are sums over the group
        sharded = group_norms and any(local_part(p) is not p for g in groups for p in g["params"])
        if group_norms:
            sq = torch.sum(_sq_norms(flat)) if flat else torch.zeros(())
            dist.all_reduce(sq, group=self.norm_group)
            norm = torch.sqrt(sq)
        else:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(flat)))
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        for group, gs in zip(groups, grads):
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                         exp_avg_sq=torch.zeros_like(p))
            states = [self.state[p] for p in group["params"]]
            params = [local_part(p) for p in group["params"]]
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for st in states:
                st["step"] += 1
            t = states[0]["step"]
            gs = torch._foreach_mul(gs, clip)
            ms = [local_part(st["exp_avg"]) for st in states]
            vs = [local_part(st["exp_avg_sq"]) for st in states]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
            den = torch._foreach_div(vs, _bias_correction(b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(torch._foreach_div(ms, _bias_correction(b1, t)), den)
            if sharded:
                sq = torch.stack([_sq_norms(params), _sq_norms(upd)])
                dist.all_reduce(sq, group=self.norm_group)
                p_norm, u_norm = torch.sqrt(sq).unbind()
            else:
                p_norm = torch.stack(torch._foreach_norm(params))
                u_norm = torch.stack(torch._foreach_norm(upd))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            torch._foreach_mul_(upd, list(ratio.unbind()))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
        return loss


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class CosineAnnealingLR:
    """lr(epoch) = eta_min + (base - eta_min) * (1 + cos(pi * epoch / T_max)) / 2,
    stepped per epoch."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0, last_epoch: int = -1):
        self.base_lr = float(base_lr)
        self.t_max = int(t_max)
        self.eta_min = float(eta_min)
        self.epoch = last_epoch + 1  # epochs completed

    @property
    def lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * self.epoch / self.t_max)
        )

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        return self.lr

    def state_dict(self) -> dict:
        return {"epoch": float(self.epoch)}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", self.epoch))


class ReduceLROnPlateau:
    """ReduceLROnPlateau(factor=0.2, patience=5, mode='min') with the relative
    improvement test: an epoch improves only if metric < best * (1 - threshold)."""

    def __init__(self, base_lr: float, factor: float = 0.2, patience: int = 5,
                 threshold: float = 1e-4):
        self.lr = float(base_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = float(threshold)
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "bad_epochs": float(self.bad_epochs)}

    def load_state_dict(self, state: dict) -> None:
        self.lr = float(state.get("lr", self.lr))
        self.best = float(state.get("best", self.best))
        self.bad_epochs = int(state.get("bad_epochs", self.bad_epochs))


class ConstantLR:
    def __init__(self, base_lr: float):
        self.lr = float(base_lr)

    def step(self, metric: Optional[float] = None) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def build_scheduler(params, last_epoch: int = -1):
    """Scheduler factory: cosine, plateau, or constant."""
    name = getattr(params, "scheduler", None)
    lr = float(params.lr)
    if name == "CosineAnnealingLR":
        return CosineAnnealingLR(lr, int(params.max_epochs), last_epoch=last_epoch)
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(lr)
    return ConstantLR(lr)
