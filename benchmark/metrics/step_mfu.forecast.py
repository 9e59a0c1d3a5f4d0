"""Model FLOPs of the window's forward steps (every call of the stepper,
members and breeding steps included, by its batch) over the window's
seconds, as a share of the card's bf16 peak."""

from benchmark import counts


def read(ctx):
    if ctx["kind"] != "forecast" or ctx["peak"] is None:
        return None
    flops = counts.model_flops(ctx["cfg"]) * ctx["forward_samples"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]["bf16_flops_s"]
