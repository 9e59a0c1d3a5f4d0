"""Share of the traced segment's wall time in which no kernel ran on the
device: 1 - (union of the kernel intervals / wall time)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
