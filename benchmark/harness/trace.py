"""Device time from a torch.profiler trace, attributed to the launcher that
issued each kernel.

A kernel is linked (by the profiler's correlation id) to the innermost
profiler op that was open when it was launched. Hand kernels launch from
inside the port's custom ops (no-grad forwards), its autograd Functions
(train forwards) and their backward nodes; ``launchers.json`` names those
ops, the kernel each launches and its family, and each op is one launch.
Any other kernel is cuBLAS's where its name says so, else PyTorch's own
(elementwise, reductions, copies). A runtime event (a "Command Buffer Full"
stall) carries its launching op's correlation id, so the profiler lists the
op's kernels under it a second time: those copies are skipped.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch


@dataclass
class Launch:
    kernel: str  # K1 ... K6
    family: str  # attn, mlp
    tokens: Optional[int]  # from the op's first input, where recorded
    seconds: float


@dataclass
class Trace:
    wall_s: float
    busy_s: float
    launches: List[Launch] = field(default_factory=list)
    cublas_s: float = 0.0
    torch_ops_s: float = 0.0
    unlinked_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    by_op: Dict[str, float] = field(default_factory=dict)


_RUNTIME = re.compile(r"^(cuda|cu[A-Z])|^Command Buffer Full$")


def _launchers(data_dir: str) -> dict:
    with open(os.path.join(data_dir, "launchers.json")) as f:
        return json.load(f)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _tokens(ev) -> Optional[int]:
    shapes = getattr(ev, "input_shapes", None) or []
    first = next((s for s in shapes if s), None)
    return math.prod(first[:-1]) if first and len(first) > 1 else None


def profile(fn: Callable[[], None], data_dir: str) -> Trace:
    """Run ``fn`` under the profiler, the device synchronized before and after."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof.events(), wall, data_dir)


def summarize(events, wall_s: float, data_dir: str) -> Trace:
    table = _launchers(data_dir)
    ops, words = table["ops"], table["cublas_kernel_words"]
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    spans = _union([(e.time_range.start, e.time_range.end) for e in device])
    tr = Trace(wall_s=wall_s, busy_s=sum(b - a for a, b in spans) / 1e6)
    linked_us = 0.0
    for ev in events:
        if ev.device_type == cuda or not ev.kernels or _RUNTIME.match(ev.name):
            continue
        us = sum(k.duration for k in ev.kernels)
        linked_us += us
        tr.by_op[ev.name] = tr.by_op.get(ev.name, 0.0) + us / 1e6
        if ev.name in ops:
            kernel, family = ops[ev.name]
            tr.launches.append(Launch(kernel, family, _tokens(ev), us / 1e6))
            continue
        for k in ev.kernels:
            if any(w in k.name.lower() for w in words):
                tr.cublas_s += k.duration / 1e6
            else:
                tr.torch_ops_s += k.duration / 1e6
    total_us = sum(e.time_range.elapsed_us() for e in device)
    tr.unlinked_s = max(0.0, total_us - linked_us) / 1e6
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    tr.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    tr.idle_gaps = _idle_gaps(events, spans)
    return tr


def _idle_gaps(events, spans) -> List[Tuple[str, float]]:
    """The ten longest gaps between device work, each named by the innermost
    host op open at its start."""
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(spans, spans[1:])), reverse=True)[:10]
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda and not _RUNTIME.match(e.name)]
    out = []
    for length, at in gaps:
        inner = None
        for e in host:
            if e.time_range.start <= at < e.time_range.end and (
                    inner is None or e.time_range.start >= inner.time_range.start):
                inner = e
        out.append((inner.name if inner is not None else "(no host op)", length / 1e6))
    return out
