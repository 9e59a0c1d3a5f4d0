"""Single-device train and eval steps (PyTorch port).

Counterpart of ``build_train_step`` / ``build_eval_step`` of
``swin_v2_weather_tpu/training/step.py``. One train step is: preprocess ->
forward with ``train=True`` (drop-path live) -> output cast to fp32 -> loss *
loss_scale -> backward -> the global gradient norm and one per top-level
module -> the optimizer update. Unlike the JAX step, which returns a new
state, this one updates the model's parameters and the optimizer's moments
in place. Metrics come back as device tensors and the step performs no host
sync: the caller reads them when it logs.

The train step's ``loss_scale`` reproduces the reference's DDP averaging
(1 / n_data_shards); on one device it is 1. The mesh, the sharded ``TrainState`` and the
multi-device layouts come with the parallel slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from swin_v2_weather_torch.models.convert import jax_top_level_name
from swin_v2_weather_torch.ops.metrics import weighted_acc, weighted_rmse


def grad_norms(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The global gradient norm and the norm of each top-level module's
    gradients, under the JAX step's names (``grad_norm``,
    ``grad_norm/patch_embed``, ``grad_norm/pos_embed``, ``grad_norm/block{i}``,
    ``grad_norm/head``), as fp32 device tensors."""
    squares: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        key = f"grad_norm/{jax_top_level_name(name)}"
        sq = torch.sum(p.grad.float() ** 2)
        squares[key] = squares[key] + sq if key in squares else sq
    out = {"grad_norm": torch.sqrt(sum(squares.values()))}
    out.update({k: torch.sqrt(v) for k, v in squares.items()})
    return out


def build_train_step(
    model: nn.Module,
    loss_handler,
    preprocessor,
    optimizer: torch.optim.Optimizer,
    loss_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Return ``step(batch) -> metrics``; the batch lies on the model's device.

    ``generator`` (on that device) draws the drop-path masks; it is needed
    when the model's drop_path_rate is above 0.
    """

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, tar, tzen = preprocessor(batch)
        optimizer.zero_grad(set_to_none=True)
        gen = model(inp, coszen=tzen, train=True, generator=generator).float()
        loss = loss_handler(gen, tar, inp) * loss_scale
        loss.backward()
        metrics = {"loss": loss.detach(), **grad_norms(model)}
        optimizer.step()
        return metrics

    return step


def build_eval_step(
    model: nn.Module,
    loss_handler,
    preprocessor,
    n_out_channels: int,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Return ``eval_step(batch) -> {'loss', 'rmse'[C], 'acc'[C]}``.

    RMSE and ACC are latitude-weighted, per channel, on the last
    ``n_out_channels`` channels (the final rollout step), in normalized
    units. The loss keeps the multistep weight, as the JAX eval step does.
    """

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, tar, tzen = preprocessor(batch)
        gen = model(inp, coszen=tzen, train=False).float()
        loss = loss_handler(gen, tar, inp)
        gen_last = gen[:, -n_out_channels:]
        tar_last = tar[:, -n_out_channels:]
        return {
            "loss": loss,
            "rmse": weighted_rmse(gen_last, tar_last),
            "acc": weighted_acc(gen_last, tar_last),
        }

    return eval_step
