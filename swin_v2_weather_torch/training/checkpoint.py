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


def _payload(model, optimizer, iters: int, epoch: int, scheduler_state: Optional[dict],
             step_in_epoch: int) -> dict:
    payload = {
        "iters": int(iters),
        "epoch": int(epoch),
        # nonzero only for graceful-preemption saves (training/preempt.py): how
        # many steps of `epoch` are already applied; resume skips that many
        # batches of the deterministic epoch order
        "step_in_epoch": int(step_in_epoch),
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
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
    and background-write seconds.
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
        payload = _payload(model, optimizer, iters, epoch, scheduler_state, step_in_epoch)
        self.last_blocking_s = time.perf_counter() - t0

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
    """One-shot synchronous save (tests, export); the trainer uses CheckpointWriter."""
    _write(path, _payload(model, optimizer, iters, epoch, scheduler_state, step_in_epoch))


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
    'scheduler' entry.
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
    model.load_state_dict({k: disk[k] for k in live})
    if resuming:
        optimizer.load_state_dict(payload["optimizer"])
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
