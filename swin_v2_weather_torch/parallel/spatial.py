"""Spatial (latitude) sharding: the H axis of the token grid split over the
mesh's ``model`` axis (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/parallel/spatial.py``. Each rank of a
``model`` group holds a band of ``H / n`` token rows, a whole number of
window rows, so every window's attention stays on one rank; the only
cross-band mixing in a block is the H part of the shifted roll, which
becomes :func:`roll_h_sharded`: ``|shift|`` rows to one neighbour and back
(point-to-point). The pole-boundary mask is gated to the band that owns the
last window row (``models/swin.py``).

Collectives on CUDA tensors take NCCL. Where the group's backend is gloo
(two ranks sharing one card: NCCL refuses two ranks on one device) the
halos and the gathered output go through host copies, since gloo's
point-to-point and all-gather take CPU tensors only; nothing else changes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from swin_v2_weather_torch.parallel.mesh import shard_rows


def _host_staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on ``x`` over ``group`` goes through the host
    (a CUDA tensor on a gloo group)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    """The group's size; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def _exchange(halo: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``halo`` to group rank ``dst`` and receive a tensor of its shape
    from group rank ``src``; returns the received tensor on halo's device."""
    staged = _host_staged(halo, group)
    send = halo.contiguous()
    if staged:
        send = send.to("cpu")
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(halo.device, non_blocking=False) if staged else recv


def _roll(x: torch.Tensor, shift_h: int, group) -> torch.Tensor:
    n, i = group_size(group), group_rank(group)
    if shift_h < 0:
        # roll up: rank i's rows = local[sh:] ++ (rank i+1)'s first sh
        sh = -shift_h
        recv = _exchange(x[:, :sh], group, (i - 1) % n, (i + 1) % n)
        return torch.cat([x[:, sh:], recv], dim=1)
    # roll down: rank i's rows = (rank i-1)'s last sh ++ local[:-sh]
    sh = shift_h
    recv = _exchange(x[:, -sh:], group, (i + 1) % n, (i - 1) % n)
    return torch.cat([recv, x[:, :-sh]], dim=1)


class _RollH(torch.autograd.Function):
    """The halo roll; its backward is the opposite roll of the cotangent (a
    roll's adjoint), the same exchange in the other direction."""

    @staticmethod
    def forward(ctx, x, shift_h, group):
        ctx.shift_h, ctx.group = shift_h, group
        return _roll(x, shift_h, group)

    @staticmethod
    def backward(ctx, g):
        return _roll(g, -ctx.shift_h, ctx.group), None, None


def roll_h_sharded(x: torch.Tensor, shift_h: int, group) -> torch.Tensor:
    """Global cyclic roll along the sharded H axis (dim 1) of the local
    [B, H_local, W, C] band: equal to ``torch.roll`` of the gathered array by
    ``shift_h`` along H, this rank's band of it. Only ``|shift_h|`` rows cross
    to one neighbour on ``group`` (the ``model`` group); on one rank (or
    None) it is ``torch.roll``. Differentiable. Raises for ``|shift_h|`` not
    smaller than the local rows, as JAX does."""
    if shift_h == 0:
        return x
    if group_size(group) == 1:
        return torch.roll(x, shift_h, dims=1)
    if abs(shift_h) >= x.shape[1]:
        raise ValueError(f"halo roll supports |shift| < local rows, got {shift_h}")
    return _RollH.apply(x, int(shift_h), group)


def _all_gather_h(x: torch.Tensor, group) -> torch.Tensor:
    staged = _host_staged(x, group)
    src = x.contiguous().to("cpu") if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=-2)
    return out.to(x.device) if staged else out


class _GatherH(torch.autograd.Function):
    """All-gather of the bands along H (dim -2 of NCHW); the backward keeps this
    rank's rows of the cotangent and sends nothing. That is the gradient of
    the band only where every rank of the group computes the same function
    of the gathered array (the train step's loss: each rank holds the whole
    preprocessed sample), so each band's gradient is counted once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[-2]
        return _all_gather_h(x, group)

    @staticmethod
    def backward(ctx, g):
        i = group_rank(ctx.group)
        return g[..., i * ctx.rows:(i + 1) * ctx.rows, :].contiguous(), None


def gather_h(x: torch.Tensor, group) -> torch.Tensor:
    """The bands' NCHW outputs [B, C, H_local, W] gathered into [B, C, H, W] on
    every rank of ``group`` (the identity on one rank); see :class:`_GatherH`
    for the backward's contract."""
    if group_size(group) == 1:
        return x
    return _GatherH.apply(x, group)


def local_band(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's band of an NCHW array: its rows of dim 2 over ``group``."""
    return x[:, :, shard_rows(x.shape[2], group_size(group), group_rank(group))]


def spatial_forward(model, x: torch.Tensor, group, coszen: Optional[torch.Tensor] = None,
                    train: bool = False, **kwargs) -> torch.Tensor:
    """Run a ``spatial_shards > 1`` model on this rank's band of the full
    NCHW batch ``x`` (and of ``coszen``) and return the full output,
    gathered over ``group`` (JAX's ``spatial_forward`` with the batch held
    whole on the ranks of one ``model`` group). ``model`` may be wrapped
    (a forecast wrapper, DDP); its core must hold ``group``
    (``SwinTransformerV2.spatial_group``; ``training/step.py`` attaches it)
    with ``spatial_shards`` equal to the group's size."""
    core = getattr(model, "module", model)  # DDP's
    core = getattr(core, "model", core)
    n_sp = group_size(group)
    if int(core.spatial_shards) != n_sp:
        raise ValueError(f"model.spatial_shards={core.spatial_shards} != the model group's "
                         f"size {n_sp}")
    if core.spatial_group is not group:
        raise ValueError("the model runs on another group than the one given")
    if coszen is not None:  # a wrapper's future zenith, banded as x
        kwargs["coszen"] = local_band(coszen, group)
    return gather_h(model(local_band(x, group), train=train, **kwargs), group)
