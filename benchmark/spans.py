"""The program's spans in a traced run of a cell.

    python3 benchmark/spans.py --workload e2048-forecast --seed 7 --seconds 20 --trace 1

runs the cell as ``run.py`` does, with the same result line and check lines,
and in a traced run prints one more line on standard error, before the check
lines: ``trace: program spans {name: [count, host_ms, device_ms, idle_ms]}``
over the traced segment, from the profiler events that ``harness/trace.py``
summarizes.

The spans are the port's ``swin/...`` profiler ranges
(``swin_v2_weather_torch/utils/profiling.span``), on the profiler's clock:

  * ``host_ms``: the spans' own durations, nested spans inside their parent's;
  * ``device_ms``: the device activities (kernels, copies) whose launching op
    started inside the span, in any thread (the backward runs in autograd's),
    each counted in every span that holds it;
  * ``idle_ms``: each instant of every gap between the merged device
    intervals, given to the innermost span open on the host then, or to
    ``(no span)``.

The profiler's device-side copies of user annotations (``is_user_annotation``
or a ``swin/`` name) are not device activities here.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PREFIX = "swin/"
NO_SPAN = "(no span)"


class _Spans:
    """The spans of one thread's nesting, for looking up the innermost span
    open at an instant."""

    def __init__(self, events):
        self.items = sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end))
        self.starts = [e.time_range.start for e in self.items]
        self.parent: List[int] = []
        open_: List[int] = []
        for i, e in enumerate(self.items):
            while open_ and self.items[open_[-1]].time_range.end <= e.time_range.start:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)
        self.bounds = sorted({t for e in self.items for t in (e.time_range.start,
                                                               e.time_range.end)})

    def innermost(self, t: float) -> int:
        """Index of the innermost span with start <= t < end, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i].time_range.end <= t:
            i = self.parent[i]
        return i

    def chain(self, t: float) -> List[int]:
        out, i = [], self.innermost(t)
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out


def span_table(events) -> Dict[str, List[float]]:
    """name -> [count, host_s, device_s, idle_s] over the ``swin/`` spans of
    ``events`` (``torch.profiler`` events), with ``(no span)``: the device time
    and the idle time outside every span."""
    import torch

    from benchmark.harness import trace

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    spans = _Spans([e for e in host if e.name.startswith(PREFIX)])
    table: Dict[str, List[float]] = {}
    for e in spans.items:
        row = table.setdefault(e.name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us() / 1e6
    none = table.setdefault(NO_SPAN, [0, 0.0, 0.0, 0.0])
    for ev in host:
        if not ev.kernels or trace._RUNTIME.match(ev.name):
            continue
        s = sum(k.duration for k in ev.kernels if not k.name.startswith(PREFIX)) / 1e6
        chain = spans.chain(ev.time_range.start)
        for i in chain:
            table[spans.items[i].name][2] += s
        if not chain:
            none[2] += s
    device = [e for e in events if e.device_type == cuda and not e.name.startswith(PREFIX)
              and not getattr(e, "is_user_annotation", False)]
    busy = trace._union([(e.time_range.start, e.time_range.end) for e in device])
    for (_, a), (b, _) in zip(busy, busy[1:]):
        lo, hi = bisect.bisect_right(spans.bounds, a), bisect.bisect_left(spans.bounds, b)
        cuts = [a] + spans.bounds[lo:hi] + [b]
        for x, y in zip(cuts, cuts[1:]):
            i = spans.innermost((x + y) / 2)
            (table[spans.items[i].name] if i >= 0 else none)[3] += (y - x) / 1e6
    return table


def line(table: Dict[str, List[float]]) -> str:
    """The stderr line: counts, then host, device and idle milliseconds."""
    rows = {k: [v[0]] + [round(1e3 * x, 3) for x in v[1:]] for k, v in sorted(table.items())}
    return "trace: program spans " + json.dumps(rows)


def main(argv=None) -> int:
    import benchmark.run as bench_run
    from benchmark.harness import trace

    summarize = trace.summarize

    def with_spans(events, wall_s, data_dir):
        tr = summarize(events, wall_s, data_dir)
        print(line(span_table(events)), file=sys.stderr)
        return tr

    trace.summarize = with_spans
    try:
        return bench_run.run(argv, t_start=bench_run.T_START)
    finally:
        trace.summarize = summarize


if __name__ == "__main__":
    sys.exit(main())
