"""Optimizer and learning-rate schedules (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/training/optim.py``:

  * ``optimizer_type: 'adam'`` -- Adam with betas (0.9, 0.95) and eps 1e-8,
    the update optax.adam makes: lr * m_hat / (sqrt(v_hat) + eps);
  * ``'FusedLAMB'`` / ``'lamb'`` -- not ported yet (raises);
  * the schedules are stepped once per epoch on the host, and the learning
    rate goes into the optimizer's ``param_groups`` from the host
    (:func:`set_learning_rate`), as the JAX package injects it into the optax
    state.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def build_optimizer(params, parameters: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Optimizer factory over the model's parameters."""
    opt_type = str(params.optimizer_type)
    if opt_type == "adam":
        return torch.optim.Adam(parameters, lr=float(params.lr), betas=(0.9, 0.95), eps=1e-8)
    if opt_type in ("FusedLAMB", "lamb"):
        raise NotImplementedError("the LAMB optimizer is not ported yet")
    raise ValueError(f"optimizer type {opt_type} not implemented")


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
