"""Process groups, the (data, model) device mesh and the batch layout
(PyTorch port).

Counterpart of ``swin_v2_weather_tpu/parallel/mesh.py``. On the TPU the
parallel layout is a ``jax.sharding.Mesh`` plus sharding annotations that
XLA turns into collectives. In eager PyTorch it is a process group per GPU
(one process drives one card, as torchrun starts them), a
``torch.distributed.device_mesh.DeviceMesh`` of the ranks with dims
``("data", "model")``, and plain functions that give each rank the rows of a
global batch it holds:

  * ``data``  -- data parallelism: the batch is split over it, gradients are
    summed over it (``training/step.py``);
  * ``model`` -- spatial sharding (``parallel/spatial.py``): with
    ``spatial_shards > 1`` the latitude axis H is split over it; otherwise
    its ranks hold the same batch rows and compute the same step.

:func:`init_distributed` starts the process group from the launcher's
environment (torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``, or JAX's ``COORDINATOR_ADDRESS`` /
``NPROCS`` / ``PROCESS_ID``); without a multi-process environment it starts
nothing and returns ``(0, 1)``, as JAX does.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

MESH_DIMS = ("data", "model")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def local_rank() -> int:
    """The rank's index among the processes of its host (torchrun's
    ``LOCAL_RANK``; 0 when unset)."""
    return _env_int("LOCAL_RANK") or 0


def rank_device(device="cuda") -> torch.device:
    """The device a rank drives: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index, else ``device`` as given (the CPU for the tests)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> Tuple[int, int]:
    """Start the process group if the environment describes more than one
    process; return ``(rank, world size)``.

    The world size comes from ``WORLD_SIZE`` (or JAX's ``NPROCS``), the rank
    from ``RANK`` (or ``PROCESS_ID``); the rendezvous is ``init_method`` when
    given, else ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``), or
    ``tcp://COORDINATOR_ADDRESS`` where only JAX's name is set. The backend is
    NCCL for a CUDA ``device`` and gloo for the CPU; a CUDA rank first
    selects ``cuda:LOCAL_RANK``. An existing default
    group is taken as it is. One process starts nothing and returns (0, 1).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = _env_int("WORLD_SIZE", "NPROCS")
    if world is None or world <= 1:
        return 0, 1
    rank = _env_int("RANK", "PROCESS_ID") or 0
    device = rank_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:
        coord = os.environ.get("COORDINATOR_ADDRESS")
        init_method = ("env://" if os.environ.get("MASTER_ADDR") or not coord
                       else f"tcp://{coord}")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    logger.info("torch.distributed initialized: rank %d/%d, backend %s", rank, world, backend)
    return rank, world


def broadcast_config(cfg: Optional[dict], group=None) -> dict:
    """The chief's config dict on every rank (the sweep agent mutates the
    chief's params only; JAX's ``broadcast_config``). JSON round trip, as in
    JAX, through ``broadcast_object_list``; the identity at one process."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return dict(cfg or {})
    src = dist.get_global_rank(group, 0) if group is not None else 0
    box = [json.dumps(cfg, default=str) if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return json.loads(box[0])


@dataclass(frozen=True)
class RankInfo:
    """A rank and the host it runs on: on GPUs the host is the counterpart of
    the TPU's ``slice_index`` (ranks of one host share NVLink; between hosts
    traffic takes the network). ``host`` None: one host."""

    rank: int
    host: Optional[str] = None


def hybrid_device_order(devices: Sequence) -> np.ndarray:
    """Order ranks host-major (all of host 0, then host 1, ...), keeping the
    given order within a host, so that the mesh's minor ``model`` axis stays
    inside a host and the data axis's collectives reduce inside each host
    first (JAX's slice-major order for multi-slice TPUs). Each item carries
    ``host`` (:class:`RankInfo`); where no item names one, the order is the
    identity. Raises on hosts of unequal size: a rectangular mesh cannot
    tile a ragged topology."""
    devices = list(devices)
    keys = [getattr(d, "host", None) for d in devices]
    if all(k is None for k in keys):
        return np.asarray(devices, dtype=object)
    groups: dict = {}
    for d, k in zip(devices, keys):
        groups.setdefault(k, []).append(d)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"unequal host sizes {sorted((str(k), len(g)) for k, g in groups.items())}: "
            "a rectangular mesh cannot tile a ragged multi-host topology")
    ordered = []
    for k in sorted(groups, key=lambda h: keys.index(h)):  # hosts in order of first rank
        ordered.extend(groups[k])
    return np.asarray(ordered, dtype=object)


def mesh_shape(params, n: int) -> Tuple[int, int]:
    """(dp, mp) of the mesh over ``n`` ranks: ``params.mesh_shape`` 'auto' (the
    default) puts every rank on ``data``; ``[dp, mp]`` selects a 2-D layout.
    Raises unless dp * mp == n."""
    shape = getattr(params, "mesh_shape", "auto") if params is not None else "auto"
    if isinstance(shape, (list, tuple)) and len(shape) == 2:
        dp, mp = int(shape[0]), int(shape[1])
    else:
        dp, mp = n, 1
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} does not cover {n} devices")
    return dp, mp


def mesh_layout(params, devices: Sequence) -> np.ndarray:
    """The [dp, mp] array of the ``devices`` (:class:`RankInfo`) that
    :func:`make_mesh` lays out: host-major order (:func:`hybrid_device_order`),
    row-major over (data, model). With ranks on more than one host the model
    axis must fit inside a host. Raises JAX's errors."""
    devices = list(devices)
    n = len(devices)
    dp, mp = mesh_shape(params, n)
    ordered = hybrid_device_order(devices)
    hosts = {getattr(d, "host", None) for d in devices}
    if mp > 1 and len(hosts) > 1:
        host_size = n // len(hosts)
        if host_size % mp != 0:
            raise ValueError(
                f"model_parallel={mp} does not divide the host size {host_size}; the model "
                "axis would straddle hosts")
    return ordered.reshape(dp, mp)


def rank_hosts() -> list:
    """Every rank's :class:`RankInfo` (its hostname), gathered over the default
    group."""
    import socket

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return [RankInfo(r, h) for r, h in enumerate(names)]


def make_mesh(params):
    """The (data, model) ``DeviceMesh`` over every rank of the default process
    group (which must exist): :func:`mesh_layout` of the ranks and their
    hosts, on CUDA for an NCCL group, else on the CPU. Every rank must call
    it (it creates the sub-groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (init_distributed)")
    layout = mesh_layout(params, rank_hosts())
    ranks = torch.tensor([[d.rank for d in row] for row in layout], dtype=torch.int64)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_DIMS)


@dataclass(frozen=True)
class MeshCoords:
    """Where a rank sits on the mesh: the dims' sizes and its index on each."""

    dp: int = 1
    mp: int = 1
    data_index: int = 0
    model_index: int = 0


def mesh_coords(mesh) -> MeshCoords:
    """:class:`MeshCoords` of this rank on ``mesh`` (None: one process)."""
    if mesh is None:
        return MeshCoords()
    return MeshCoords(mesh.size(0), mesh.size(1), mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))


def shard_rows(n: int, parts: int, index: int) -> slice:
    """The ``index``-th of ``parts`` equal blocks of ``n`` rows; raises unless
    ``parts`` divides ``n``."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal shards")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def batch_shard(x: torch.Tensor, coords: MeshCoords, spatial: bool = False) -> torch.Tensor:
    """This rank's part of a global [B, ...] array (JAX's ``batch_sharding``):
    the batch split over ``data``; with ``spatial`` also dim 2 (H of an NCHW
    batch) split over ``model``. A view; model-axis ranks of a batch without
    ``spatial`` hold the same rows."""
    x = x[shard_rows(x.shape[0], coords.dp, coords.data_index)]
    if spatial:
        x = x[:, :, shard_rows(x.shape[2], coords.mp, coords.model_index)]
    return x

