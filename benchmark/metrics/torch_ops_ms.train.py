"""Device milliseconds per step, in the traced segment, of the kernels that
neither a hand kernel's launcher nor cuBLAS issued (PyTorch's elementwise
ops, reductions and copies)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None or not ctx["segment_steps"]:
        return None
    return 1e3 * tr.torch_ops_s / ctx["segment_steps"]
