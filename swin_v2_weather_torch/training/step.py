"""Train and eval steps, and the parallel layout of the training state
(PyTorch port).

Counterpart of ``build_train_step`` / ``build_eval_step`` / ``state_shardings``
of ``swin_v2_weather_tpu/training/step.py``. One train step is: preprocess ->
forward with ``train=True`` (drop-path live) -> output cast to fp32 -> loss *
loss_scale -> backward -> the global gradient norm and one per top-level
module -> the optimizer update, each phase in a profiler span
``swin/train/<phase>`` (``utils/profiling.span``). Unlike the JAX step, which
returns a new state, this one updates the model's parameters and the
optimizer's moments in place. Metrics come back as device tensors and the step
performs no host sync: the caller reads them when it logs.

The parallel layout (:func:`shard_state`, the counterpart of
``state_shardings``; it needs the mesh of ``parallel/mesh.py``, so a process
group) is one of:

  * replicated parameters and optimizer state (the default), the model under
    ``DistributedDataParallel``;
  * ``shard_opt_state`` (ZeRO-1): the same, with the optimizer a
    ``ZeroRedundancyOptimizer`` over the ``data`` group (each rank steps the
    whole parameters of its partition, then broadcasts them);
  * ``shard_params`` (FSDP2): ``fully_shard`` per block and at the root over
    ``data``, parameters kept fp32 (no mixed-precision policy), as JAX keeps
    them; with spatial sharding the mesh is (model, data): sharded over
    ``data``, replicated over ``model``.

The loss is a sum over the batch (``LossHandler`` never averages) and JAX
computes it on the global batch times ``loss_scale = 1 / n_data_shards``, so
the gradient JAX takes is the sum over data shards of each shard's
gradient, over n_data_shards. Here every rank computes its shard's loss
times ``loss_scale`` and the gradients are *summed* (DDP's comm hook
:func:`sum_hook`; FSDP2's divide factor 1) over the ranks that hold
different work: the ``data`` group, or with spatial sharding every rank.
Under spatial sharding (``spatial_shards > 1``) every rank of a ``model``
group holds the whole preprocessed sample, runs the model on its band
(JAX's ``_apply_model`` under ``shard_map``), and the bands' outputs are
gathered before the loss (``parallel/spatial.gather_h``), whose backward
keeps each band's rows once; each rank's parameter gradient is then its
band's part, and the sum over the ``model`` ranks completes it. The logged
loss is the sum over ``data`` of the shards' scaled losses, JAX's value.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from swin_v2_weather_torch.models.convert import jax_top_level_name
from swin_v2_weather_torch.ops.metrics import (
    weighted_acc,
    weighted_acc_channels,
    weighted_rmse,
    weighted_rmse_channels,
)
from swin_v2_weather_torch.parallel import spatial
from swin_v2_weather_torch.parallel.mesh import MeshCoords, mesh_coords
from swin_v2_weather_torch.training.optim import (
    Lamb,
    build_optimizer,
    local_part,
    optimizer_spec,
)
from swin_v2_weather_torch.utils.profiling import span

def grad_norms(model: nn.Module, group=None) -> Dict[str, torch.Tensor]:
    """The global gradient norm and the norm of each top-level module's
    gradients, under the JAX step's names (``grad_norm``,
    ``grad_norm/patch_embed``, ``grad_norm/pos_embed``, ``grad_norm/block{i}``,
    ``grad_norm/head``), as fp32 device tensors. Sharded gradients (FSDP2's
    DTensors) add their local shards' squares, summed over ``group``."""
    squares: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        key = f"grad_norm/{jax_top_level_name(name)}"
        sq = torch.sum(local_part(p.grad).float() ** 2)
        squares[key] = squares[key] + sq if key in squares else sq
    if group is not None:
        stacked = torch.stack(list(squares.values()))
        dist.all_reduce(stacked, group=group)
        squares = dict(zip(squares, stacked.unbind()))
    out = {"grad_norm": torch.sqrt(sum(squares.values()))}
    out.update({k: torch.sqrt(v) for k, v in squares.items()})
    return out


def sum_hook(group, bucket):
    """DDP comm hook: the bucket's gradients summed over ``group`` (DDP's
    default divides by the group's size)."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


@dataclass
class ParallelLayout:
    """How the step runs on this rank (:func:`shard_state`): ``forward`` is the
    module the step calls (the model, its DDP wrapper, or the model under
    FSDP2); ``coords`` where the rank sits on the mesh; ``spatial`` whether
    the model runs on a latitude band of its ``model`` group; ``data_group``
    the group the loss and the validation metrics are summed over;
    ``norm_group`` the group sharded gradients' norms are summed over."""

    forward: nn.Module
    coords: MeshCoords = field(default_factory=MeshCoords)
    spatial: bool = False
    data_group: Any = None
    model_group: Any = None
    norm_group: Any = None

    def apply(self, inp: torch.Tensor, tzen: Optional[torch.Tensor],
              **kwargs) -> torch.Tensor:
        """The model's output for the rank's whole (data-shard) batch: with
        spatial sharding the band's forward, gathered over ``model``."""
        if not self.spatial:
            return self.forward(inp, coszen=tzen, **kwargs)
        return spatial.spatial_forward(self.forward, inp, self.model_group, coszen=tzen,
                                       **kwargs)

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data shards (in place; a no-op on one)."""
        if self.coords.dp > 1:
            dist.all_reduce(t, group=self.data_group)
        return t


def _core(model: nn.Module) -> nn.Module:
    return getattr(model, "model", model)


def shard_state(model: nn.Module, params, mesh=None):
    """Lay the training state out over ``mesh`` (the counterpart of JAX's
    ``state_shardings`` and of its ``_apply_model``) and build the optimizer:
    returns ``(ParallelLayout, optimizer)``. Without a mesh (one process, no
    process group) the model runs as it is with the config's optimizer, and
    ``spatial_shards > 1`` raises. With a mesh, every rank first takes rank
    0's parameters and buffers (the same initial weights everywhere), the
    core learns its data shard (``data_shard``, the drop-path draws) and,
    spatially sharded, its ``model`` group; then ``shard_params`` (FSDP2),
    ``shard_opt_state`` (ZeRO-1) or neither (DDP) as the module docstring
    says. Every rank must call it (it creates process groups)."""
    core = _core(model)
    n_sp = int(core.spatial_shards)
    if mesh is None:
        if n_sp > 1:
            raise ValueError(f"spatial_shards={n_sp} needs a mesh with a 'model' axis of that "
                             "size (a process group: parallel.init_distributed)")
        return ParallelLayout(forward=model), build_optimizer(params, model.parameters())
    coords = mesh_coords(mesh)
    sp = n_sp > 1
    if sp and n_sp != coords.mp:
        raise ValueError(f"model.spatial_shards={n_sp} != mesh[model]={coords.mp}")
    data_group, model_group = mesh.get_group("data"), mesh.get_group("model")
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src=0)
    core.data_shard = (coords.data_index, coords.dp)
    if sp:
        core.spatial_group = model_group
    layout = ParallelLayout(forward=model, coords=coords, spatial=sp, data_group=data_group,
                            model_group=model_group)
    if bool(getattr(params, "shard_params", False)):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.fsdp import fully_shard

        # with bands, HSDP: replicated over model (the bands' partial
        # gradients summed), sharded over data
        if sp:
            fsdp_mesh = DeviceMesh(mesh.device_type, mesh.mesh.t(),
                                   mesh_dim_names=("model", "data"))
        else:
            fsdp_mesh = mesh["data"]
        units = [*core.blocks, model]
        for unit in units:
            fully_shard(unit, mesh=fsdp_mesh)
        for unit in units:  # a plain sum (gloo has no pre-multiplied sum)
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)
        layout.norm_group = data_group
        return layout, build_optimizer(params, model.parameters(), norm_group=data_group)
    grad_group = dist.group.WORLD if sp else data_group
    ddp = nn.parallel.DistributedDataParallel(model, process_group=grad_group,
                                              broadcast_buffers=False)
    ddp.register_comm_hook(grad_group, sum_hook)
    layout.forward = ddp
    if bool(getattr(params, "shard_opt_state", False)):
        from torch.distributed.optim import ZeroRedundancyOptimizer

        cls, kwargs = optimizer_spec(params)
        zero = ZeroRedundancyOptimizer(model.parameters(), optimizer_class=cls,
                                       process_group=data_group, **kwargs)
        if isinstance(zero.optim, Lamb):  # its global clip norm spans the partitions
            zero.optim.norm_group = data_group
        return layout, zero
    return layout, build_optimizer(params, model.parameters())


def build_train_step(
    model: nn.Module,
    loss_handler,
    preprocessor,
    optimizer: torch.optim.Optimizer,
    loss_scale: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    layout: Optional[ParallelLayout] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Return ``step(batch) -> metrics``; the batch (this rank's data shard of
    the global batch, whole in H) lies on the model's device.

    ``generator`` (on that device) draws the drop-path masks and the
    proj/attn dropout seeds; it is needed when the model's drop_path_rate or
    a dropout rate is above 0, or with ``rel_pos``. ``layout`` (from
    :func:`shard_state`) runs the step on the mesh; ``loss_scale`` defaults
    to 1 / n_data_shards.
    """
    layout = layout or ParallelLayout(forward=model)
    if loss_scale is None:
        loss_scale = 1.0 / layout.coords.dp

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("train/preprocess"):
            inp, tar, tzen = preprocessor(batch)
        optimizer.zero_grad(set_to_none=True)
        with span("train/forward"):
            gen = layout.apply(inp, tzen, train=True, generator=generator).float()
        with span("train/loss"):
            loss = loss_handler(gen, tar, inp) * loss_scale
        with span("train/backward"):
            loss.backward()
        with span("train/grad_norms"):
            metrics = {"loss": layout.sum_over_data(loss.detach()),
                       **grad_norms(model, layout.norm_group)}
        with span("train/optimizer"):
            optimizer.step()
        return metrics

    return step


def build_eval_step(
    model: nn.Module,
    loss_handler,
    preprocessor,
    n_out_channels: int,
    loss_scale: Optional[float] = None,
    layout: Optional[ParallelLayout] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Return ``eval_step(batch) -> {'loss', 'rmse'[C], 'acc'[C]}`` of the
    global batch (every rank gets the same values).

    RMSE and ACC are latitude-weighted, per channel, on the last
    ``n_out_channels`` channels (the final rollout step), in normalized
    units, averaged over the global batch's samples. The loss keeps the
    multistep weight, as the JAX eval step does, times ``loss_scale`` (1 /
    n_data_shards by default).
    """
    layout = layout or ParallelLayout(forward=model)
    if loss_scale is None:
        loss_scale = 1.0 / layout.coords.dp

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, tar, tzen = preprocessor(batch)
        gen = layout.apply(inp, tzen, train=False).float()
        loss = loss_handler(gen, tar, inp) * loss_scale
        gen_last = gen[:, -n_out_channels:]
        tar_last = tar[:, -n_out_channels:]
        if layout.coords.dp == 1:
            return {"loss": loss, "rmse": weighted_rmse(gen_last, tar_last),
                    "acc": weighted_acc(gen_last, tar_last)}
        # per-sample metrics summed over the global batch's samples
        packed = torch.cat([loss.reshape(1),
                            weighted_rmse_channels(gen_last, tar_last).sum(0),
                            weighted_acc_channels(gen_last, tar_last).sum(0)])
        layout.sum_over_data(packed)
        n = gen.shape[0] * layout.coords.dp
        return {"loss": packed[0], "rmse": packed[1:1 + n_out_channels] / n,
                "acc": packed[1 + n_out_channels:] / n}

    return eval_step
