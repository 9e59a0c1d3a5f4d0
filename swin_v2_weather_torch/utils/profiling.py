"""Profiling and tracing hooks (PyTorch port).

Counterpart of ``swin_v2_weather_tpu/utils/profiling.py``: a config-driven
``torch.profiler`` window that traces the host and, where the steps run on a
GPU, the device over a chosen span of training steps and writes it as a
Chrome trace (viewable in Perfetto), plus a step timer that records per-step
wall times without any device synchronization (it timestamps dispatches).

Config keys (all optional):
  profile_dir:        directory for the trace (default exp_dir/traces)
  profile_start_step: first profiled step   (default 10)
  profile_num_steps:  how many steps to capture (default 0 = disabled)
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

logger = logging.getLogger(__name__)


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
            import torch
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
        import torch

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
    """Dispatch-side per-step wall times (no device sync)."""

    def __init__(self):
        self._last: Optional[float] = None
        self.times: List[float] = []

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def reset(self) -> dict:
        """Summarize and clear. Returns {mean, p50, max} in seconds."""
        out = {}
        if self.times:
            s = sorted(self.times)
            out = {
                "step_time_mean": sum(s) / len(s),
                "step_time_p50": s[len(s) // 2],
                "step_time_max": s[-1],
            }
        self.times = []
        self._last = None
        return out
