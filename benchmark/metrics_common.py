"""Arithmetic the per-layer readers share."""

from benchmark import counts


def roofline(ctx, family: str):
    """100 * sum(bound) / sum(device seconds) over the traced launches of a
    kernel family; a launch whose tokens the trace did not record is taken
    at the tokens of one sample times the segment's batch."""
    tr = ctx["trace"]
    if tr is None or ctx["peak"] is None:
        return None
    launches = [x for x in tr.launches if x.family == family]
    if not launches:
        return None
    cfg = ctx["cfg"]
    default = counts.Shapes(cfg).tokens * int(ctx["traffic"].get("members", 1))
    bound = sum(counts.bound_s(x.kernel, cfg, x.tokens or default, ctx["peak"])
                for x in launches)
    return 100.0 * bound / sum(x.seconds for x in launches)
