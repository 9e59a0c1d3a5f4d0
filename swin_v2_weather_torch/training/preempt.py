"""Graceful-preemption handling: checkpoint at a step boundary, exit clean.

A copy of ``swin_v2_weather_tpu/training/preempt.py`` for the PyTorch port.
Cluster schedulers send a warning signal before the hard kill (Slurm
``--signal=USR1@120``, cloud maintenance events send SIGTERM); this module
turns that warning into a mid-epoch checkpoint:

  * a signal flips an ``Event`` (async-signal-safe; no work in the handler),
  * the trainer polls it once per step and stops at the next step boundary,
  * the checkpoint carries ``step_in_epoch`` so resume skips exactly the
    consumed batches of the deterministic epoch-seeded sample order — the
    continued run is bit-identical to an uninterrupted one (the drop-path
    generator of each step is seeded from the seed, the epoch and the
    restored global step);
  * with several ranks the ranks agree on the stop step (:func:`agreed`: a
    MAX all-reduce of the flags after every step). JAX lets each process
    read its own flag; with eager collectives a rank that stopped a step
    early would leave the others waiting in a collective.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


class PreemptionHandler:
    """Latches termination-warning signals; poll ``triggered`` per step."""

    def __init__(self, signals: Optional[Sequence[int]] = None):
        self.signals = tuple(signals) if signals is not None else (
            signal.SIGTERM, signal.SIGUSR1,
        )
        self._event = threading.Event()
        self._previous: dict = {}

    # -- signal plumbing ----------------------------------------------------

    def _handle(self, signum, frame):
        # async-signal-safe: set the flag, nothing else; the training loop
        # does the checkpointing from its own thread at a step boundary
        self._event.set()
        logger.warning(
            "received signal %s: will checkpoint at the next step boundary",
            signal.Signals(signum).name,
        )

    def install(self) -> "PreemptionHandler":
        """Register handlers (main thread only — a no-op elsewhere)."""
        if threading.current_thread() is not threading.main_thread():
            logger.warning("not the main thread; preemption signals not installed")
            return self
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self) -> None:
        """Restore whatever handlers were registered before ``install``."""
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    # -- queries ------------------------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Programmatic preemption (tests, external schedulers)."""
        self._event.set()


def agreed(flag: bool, group=None) -> bool:
    """Whether any rank of ``group`` has its flag set (a MAX all-reduce of a
    host tensor: ``group`` must take CPU tensors, e.g. a gloo group, so no
    device work is waited for); the flag itself without a process group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())
