"""Profiling and tracing hooks (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/utils/profiling.py``, with three pieces:

  * :func:`span`: a named range ``swin/<name>`` of the program's host loops
    (the train step, the forecast loop), on the profiler's own clock, so a
    trace puts each device interval, busy or idle, beside what the host was
    doing; with no profiler recording it is one flag read;
  * :class:`StepProfiler`: a config-driven ``torch.profiler`` window that
    traces the host and, where the steps run on a GPU, the device over a
    chosen span of training steps and writes it as a Chrome trace (viewable
    in Perfetto), the spans included;
  * :class:`StepTimer`: per-step times; on a GPU from CUDA events recorded
    on the stream between the steps (the device's time, no host
    synchronization a step), elsewhere from the host clock.

Config keys (all optional):
  profile_dir:        directory for the trace (default exp_dir/traces)
  profile_start_step: first profiled step   (default 10)
  profile_num_steps:  how many steps to capture (default 0 = disabled)
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

SPAN_PREFIX = "swin/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``swin/<name>`` while a ``torch.profiler``
    trace is recording, else a shared no-op context (one flag read). For the
    program's host loops only, never inside an ``nn.Module.forward``: the
    forecast step is exported by ``torch.export``.

    The range is a host op (``_RecordFunctionFast``, function scope), not a
    user annotation (``record_function``): the profiler mirrors each user
    annotation on the device as an event of its own, spanning the range's
    first to last kernel, which a trace's busy time and per-kernel sums
    would then count as device work."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
    return _NO_SPAN


class StepProfiler:
    """Start/stop a torch.profiler trace around a window of training steps."""

    def __init__(self, params, exp_dir: str, enabled: bool = True):
        self.num_steps = int(getattr(params, "profile_num_steps", None) or 0)
        self.start_step = int(getattr(params, "profile_start_step", None) or 10)
        self.trace_dir = str(
            getattr(params, "profile_dir", None) or os.path.join(exp_dir, "traces")
        )
        self.enabled = enabled and self.num_steps > 0
        self._prof = None
        self._done = False

    def step(self, global_step: int) -> None:
        """Call once per training step with the global step index."""
        if not self.enabled or self._done:
            return
        if self._prof is None and global_step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._first = global_step
            logger.info("profiler: tracing steps %d..%d -> %s",
                        global_step, global_step + self.num_steps, self.trace_dir)
        elif self._prof is not None and global_step >= self.start_step + self.num_steps:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's device work lands in the trace
        self._prof.stop()
        path = os.path.join(self.trace_dir, f"trace_steps{self._first}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        self._done = True
        logger.info("profiler: trace written to %s", path)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


class StepTimer:
    """Per-step times: the interval between consecutive :meth:`tick` calls.

    On a CUDA ``device`` each tick records an event on the current stream
    into a ring of the last ``RING`` ticks and waits for nothing; the times
    are then the device's, from one step's enqueued end to the next's.
    :meth:`reset` waits on the last event (call it where the caller
    synchronizes anyway, e.g. once an epoch). Elsewhere the host clock."""

    RING = 1024

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._events: collections.deque = collections.deque(maxlen=self.RING)
        self._last: Optional[float] = None
        self.times: List[float] = []

    def tick(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._events.append(event)
            return
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def reset(self) -> dict:
        """Summarize and clear. Returns {mean, p50, max} in seconds."""
        if self._events:
            self._events[-1].synchronize()
            events = list(self._events)
            self.times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
        out = {}
        if self.times:
            s = sorted(self.times)
            out = {
                "step_time_mean": sum(s) / len(s),
                "step_time_p50": s[len(s) // 2],
                "step_time_max": s[-1],
            }
        self.times = []
        self._events.clear()
        self._last = None
        return out
