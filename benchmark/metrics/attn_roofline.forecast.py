"""The attn family's launches in the traced segment: the sum of their bounds
(the frozen counts of benchmark/counts.py at each launch's tokens) over the
sum of their device time. None where the segment launched none."""

from benchmark.metrics_common import roofline


def read(ctx):
    if ctx["kind"] != "forecast":
        return None
    return roofline(ctx, "attn")
