"""Model FLOPs of the window's train steps (3 forwards a step, recompute not
counted) over the window's seconds, as a share of the card's bf16 peak."""

from benchmark import counts


def read(ctx):
    if ctx["kind"] != "train" or ctx["peak"] is None:
        return None
    flops = 3.0 * counts.model_flops(ctx["cfg"]) * ctx["train_samples"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]["bf16_flops_s"]
