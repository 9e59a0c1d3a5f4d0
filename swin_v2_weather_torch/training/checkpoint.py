"""Checkpoint save / restore / finetune / resume (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/training/checkpoint.py`` in a torch
format: one directory per checkpoint holding ``checkpoint.pt``, a
``torch.save`` of

    {"iters": global step, "epoch": int, "step_in_epoch": int,
     "model": model.state_dict(), "optimizer": optimizer.state_dict()
     [, "scheduler": {name: float}]}

written every epoch (plus ``best_ckpt`` on validation improvement). The
*finetune* path restores the model weights only; *resume* also restores the
step counter, the epoch, ``step_in_epoch`` (nonzero after a graceful
preemption), Adam's moments and step counts, and the host-side scheduler
state. Every tensor is saved as it is and restored as it was saved (Adam's
``step`` counts stay fp32 on the host), so a resumed run continues bit for
bit.

Across ranks the format stays the same, so a checkpoint saved at N ranks
restores at any other count, as orbax restores into any sharding: every
rank takes part in collecting the full state (FSDP2's DTensor shards
gathered, ZeRO-1's optimizer state consolidated to rank 0), the chief
alone writes, and every rank restores the full state and keeps its part.

Writes are asynchronous: :meth:`CheckpointWriter.save` blocks only for the
device-to-host copy of the state, a background thread writes a temporary
directory and renames it into place, and the next ``save`` waits for the
previous write. Restore refuses a partial restore: a model key (or, when
resuming, an optimizer state) missing on disk or of another shape raises,
so a depth mismatch can never load as a "successful" restore of fresh
weights. The orbax layout of the JAX package and its scan <-> unrolled
block-layout conversion are not read here.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"


def _to_host(obj):
    """A copy of a nested state with every tensor copied to the host: device
    tensors into page-locked buffers with asynchronous copies (the caller
    synchronizes once), host tensors cloned."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu":
            return obj.detach().clone()
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
        return out.copy_(obj.detach(), non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def is_chief() -> bool:
    """Rank 0 of the process group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def full_state(obj):
    """``obj`` with every DTensor (FSDP2's shards) gathered into a whole
    tensor (a collective on every rank of its mesh; every rank walks the
    same structure in the same order)."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: full_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_state(v) for v in obj)
    return obj


def _optimizer_state(optimizer, chief: bool) -> Optional[dict]:
    """The optimizer's whole state dict on the chief (None elsewhere): a
    ZeRO-1 optimizer consolidated to rank 0 first, DTensor state gathered."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if chief else None
    state = full_state(optimizer.state_dict())
    return state if chief else None


def _payload(model, optimizer, iters: int, epoch: int, scheduler_state: Optional[dict],
             step_in_epoch: int, chief: bool = True) -> Optional[dict]:
    """The checkpoint's content, on the host, on the chief; None on the
    other ranks (which take part in gathering it)."""
    model_state = full_state(model.state_dict())
    optimizer_state = _optimizer_state(optimizer, chief)
    if not chief:
        return None
    payload = {
        "iters": int(iters),
        "epoch": int(epoch),
        # nonzero only for graceful-preemption saves (training/preempt.py): how
        # many steps of `epoch` are already applied; resume skips that many
        # batches of the deterministic epoch order
        "step_in_epoch": int(step_in_epoch),
        "model": model_state,
        "optimizer": optimizer_state,
    }
    if scheduler_state:
        payload["scheduler"] = {k: float(v) for k, v in scheduler_state.items()}
    payload = _to_host(payload)
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the asynchronous device-to-host copies have landed
    return payload


def _write(path: str, payload: dict) -> None:
    """Write ``payload`` as the checkpoint directory ``path``: a temporary
    directory beside it, renamed into place once the file is complete."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=parent)
    old = None
    try:
        torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{name}.old-", dir=parent)
            os.rename(path, os.path.join(old, name))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


class CheckpointWriter:
    """Asynchronous checkpoint writer; holds the background write thread.

    ``save`` returns once the state is copied to the host (so the next step
    may update the parameters in place); the disk write overlaps the next
    epoch's compute. A new save waits for the previous one to finish.
    ``last_blocking_s`` and ``last_write_s`` are the last save's host-copy
    and background-write seconds. Every rank saves (the state is gathered
    collectively); only the chief (:func:`is_chief`) writes.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer"
        )
        self._pending: Optional[concurrent.futures.Future] = None
        self.last_blocking_s: Optional[float] = None
        self.last_write_s: Optional[float] = None

    def save(self, path: str, model, optimizer, iters: int, epoch: int,
             scheduler_state: Optional[dict] = None, step_in_epoch: int = 0) -> None:
        self.wait()
        t0 = time.perf_counter()
        payload = _payload(model, optimizer, iters, epoch, scheduler_state, step_in_epoch,
                           is_chief())
        self.last_blocking_s = time.perf_counter() - t0
        if payload is None:
            return

        def write():
            t1 = time.perf_counter()
            _write(path, payload)
            self.last_write_s = time.perf_counter() - t1

        self._pending = self._pool.submit(write)

    def wait(self) -> None:
        """Block until the pending write is on disk (re-raising its error)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def save_checkpoint(path: str, model, optimizer, iters: int, epoch: int,
                    scheduler_state: Optional[dict] = None, step_in_epoch: int = 0) -> None:
    """One-shot synchronous save (tests, export); the trainer uses
    CheckpointWriter. Every rank calls it; the chief writes."""
    payload = _payload(model, optimizer, iters, epoch, scheduler_state, step_in_epoch,
                       is_chief())
    if payload is not None:
        _write(path, payload)


def _refuse(path: str, what: str, keys) -> None:
    keys = sorted(keys)
    if keys:
        raise ValueError(
            f"checkpoint at {path} is {what} {keys[:8]}{'...' if len(keys) > 8 else ''} — "
            "refusing a partial restore"
        )


def _check_optimizer_state(path: str, disk: dict, optimizer) -> None:
    """Every parameter of ``optimizer`` must have a saved state of its shape
    in ``disk`` (an ``optimizer.state_dict()``), group by group."""
    groups = disk.get("param_groups", [])
    if len(groups) != len(optimizer.param_groups) or any(
        len(g["params"]) != len(live["params"])
        for g, live in zip(groups, optimizer.param_groups)
    ):
        raise ValueError(f"checkpoint at {path}: the optimizer's parameter groups differ "
                         "from the live optimizer's — refusing a partial restore")
    missing, mismatched = [], []
    for g, live in zip(groups, optimizer.param_groups):
        for idx, p in zip(g["params"], live["params"]):
            state = disk["state"].get(idx)
            if not state:
                missing.append(f"optimizer/state/{idx}")
                continue
            for name, t in state.items():
                if name != "step" and tuple(t.shape) != tuple(p.shape):
                    mismatched.append(f"optimizer/state/{idx}/{name}")
    _refuse(path, "missing requested keys", missing)
    _refuse(path, "holding keys of another shape", mismatched)


def _shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` as ``like`` holds it: this rank's shard where ``like`` is a
    DTensor (FSDP2; sliced locally, no communication), else unchanged."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements,
                             src_data_rank=None)


def _optimizer_state_like(disk: dict, optimizer) -> dict:
    """A saved optimizer state dict with each parameter's state tensors
    sharded as its live parameter is (:func:`_shard_like`)."""
    state = {}
    for g, live in zip(disk["param_groups"], optimizer.param_groups):
        for idx, p in zip(g["params"], live["params"]):
            state[idx] = {k: v if k == "step" else _shard_like(v, p)
                          for k, v in disk["state"][idx].items()}
    return {**disk, "state": state}


def restore_checkpoint(
    path: str,
    model,
    optimizer=None,
    resuming: bool = False,
    scheduler_template: Optional[dict] = None,
) -> Dict[str, Any]:
    """Restore a checkpoint into ``model`` (and, resuming, ``optimizer``).

    Returns {'epoch': int, 'step_in_epoch': int, 'iters': int [, 'scheduler':
    dict]}. With ``resuming`` False (the finetune path) only the weights are
    loaded; the optimizer and the counters keep their fresh values and the
    result's counters are 0. Every key of the live model must be on disk with
    its shape (extra keys on disk are ignored); resuming, every parameter's
    optimizer state too. A checkpoint written before ``step_in_epoch`` or the
    scheduler state existed restores with step_in_epoch 0 and no
    'scheduler' entry. Every rank restores: FSDP2's parameters and moments
    take their shards of the saved whole tensors, a ZeRO-1 optimizer its
    partition.
    """
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                         weights_only=True)
    live = model.state_dict()
    disk = payload["model"]
    _refuse(path, "missing requested keys", [f"model/{k}" for k in live if k not in disk])
    _refuse(path, "holding keys of another shape",
            [f"model/{k}" for k in live if tuple(disk[k].shape) != tuple(live[k].shape)])
    out: Dict[str, Any] = {"epoch": 0, "step_in_epoch": 0, "iters": 0}
    if resuming:
        _refuse(path, "missing requested keys",
                [k for k in ("iters", "epoch", "optimizer") if k not in payload])
        _check_optimizer_state(path, payload["optimizer"], optimizer)
    model.load_state_dict({k: _shard_like(disk[k], live[k]) for k in live})
    if resuming:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        state = payload["optimizer"]
        if not isinstance(optimizer, ZeroRedundancyOptimizer):
            state = _optimizer_state_like(state, optimizer)
        optimizer.load_state_dict(state)
        out["epoch"] = int(payload["epoch"])
        out["iters"] = int(payload["iters"])
        out["step_in_epoch"] = int(payload.get("step_in_epoch", 0))
        if scheduler_template and "scheduler" in payload:
            out["scheduler"] = {k: float(v) for k, v in payload["scheduler"].items()}
    return out


def latest_checkpoint_exists(path: str) -> bool:
    """A finished checkpoint directory (written under a temporary name and
    renamed, so a partial write never carries this name)."""
    return os.path.isdir(path) and bool(os.listdir(path))
