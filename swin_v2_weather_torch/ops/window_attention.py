"""qkv-fused scaled-cosine window attention: plain PyTorch versions and CUDA kernels.

Counterpart of the v3 kernel pair of ``swin_v2_weather_tpu/ops/window_attention.py``
(forward ``_make_qkv_kernel`` / ``_qkv_forward``, backward
``_make_qkv_bwd_kernel`` / ``_qkv_backward``, custom_vjps ``_build_qkv`` and,
with the CPB relative-position bias, ``_build_qkv_bias``; entry point
``fused_window_attention_qkv``). The input is the model's NHWC grid
``[B, H, W, C_in]``, already rolled for shifted blocks; the qkv projection,
the windowing, per-head q/k L2 normalization, the max-free softmax and the
e @ v product happen in one call, and the output comes back in grid layout
``[B, H, W, C]``.

  * :func:`window_attention_qkv_reference` /
    :func:`window_attention_qkv_backward_reference` -- the plain versions (CPU
    path and test oracles), with the kernels' rounding sites;
    :func:`window_attention_qkv_bias_reference` /
    :func:`window_attention_qkv_bias_backward_reference` the same with the
    pre-folded CPB term ``badd`` (:func:`fold_cpb_bias`).
  * :func:`window_attention_qkv` / :func:`window_attention_qkv_bwd` -- launch
    ``csrc/window_attention_qkv.cu`` (K1) and
    ``csrc/window_attention_qkv_bwd.cu`` (K2) on CUDA tensors;
    :func:`window_attention_qkv_bias` / :func:`window_attention_qkv_bias_bwd`
    launch the bias instances of the same sources (K7). Each counts its
    launches.
  * :class:`WindowAttentionQKV` -- the autograd Function: it saves only
    (x, w_qkv, b_qkv, scale), as ``_build_qkv``'s ``f_fwd`` does, and its
    backward recomputes everything else. :class:`WindowAttentionQKVBias`
    saves (x, w_qkv, b_qkv, scale, badd) and also returns d(bias), as
    ``_build_qkv_bias`` does.
  * :func:`fused_window_attention_qkv` -- the entry point the model calls; a
    CPU tensor takes the plain versions, a CUDA tensor the kernels (or an
    error).

The shifted-window mask is latitude-only: every masked window lies in the
last window row and all of them share one [L, L] pattern
(``make_shift_mask(...)[-1]``), added there times ``boundary_flag``.

Rounding sites (the TPU kernel's contract, kept by both versions): qkv is
accumulated in fp32 from bf16-cast x and W whatever the input dtype, plus the
fp32 bias, then rounded to bf16; q16 = bf16(q * rsqrt(max(sum q^2, 1e-24))),
likewise k16; s = q16 @ k16^T in fp32; z = (s - 1) * scale (+ mask), or with
the CPB bias z = s * scale + badd[h] (+ mask); e = exp(z) with no max pass
(|s| <= 1, and badd is row-max-shifted, so z <= 0 with one z = 0 a row);
out = (bf16(e) @ v16 in fp32) / sum(e), cast to x's dtype. The backward's
sites are listed in :func:`window_attention_qkv_backward_reference`.

Gradient dtypes follow ``_build_qkv``'s ``f_bwd``: dx in x's dtype, dW in the
dtype of the w_qkv handed in (bf16 in the model, which casts the fp32
parameter first, so the cast's backward lifts it to fp32), db, dscale and
dbias in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from swin_v2_weather_torch.ops import _build


def _window_grid(x: torch.Tensor, window: Tuple[int, int]) -> Tuple[int, int]:
    wh, ww = int(window[0]), int(window[1])
    if x.shape[1] % wh or x.shape[2] % ww:
        raise ValueError(f"grid {tuple(x.shape[1:3])} not divisible by window {window}")
    return x.shape[1] // wh, x.shape[2] // ww


def fold_cpb_bias(bias: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel-ready CPB term ``badd = (bias - rowmax(bias)) - scale``, fp32
    [heads, L, L] (``fold_cpb_bias`` of the JAX package).

    The row max is detached, so d(badd)/d(bias) is the identity; the
    ``- scale`` contributes ``-sum(d_badd)`` over [L, L] to d(scale) through
    autograd, beside the kernel's own dscale. The shift keeps the kernels'
    max-free softmax rigorous: every row keeps one entry with z = 0.
    """
    b32 = bias.float()
    shifted = b32 - torch.amax(b32, dim=-1, keepdim=True).detach()
    return shifted - scale.float()[:, None, None]


def _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd=None):
    """The forward's recompute in plain ops: (v16, qn16, kn16, inv_q, inv_k, e,
    r), each [Bw, heads, L, *] fp32 (v16, qn16 and kn16 hold bf16 values)."""
    from swin_v2_weather_torch.models.swin import window_partition

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    nwh, nww = _window_grid(x, window)
    l = wh * ww
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads

    bf = torch.bfloat16
    qkv = torch.matmul(x.to(bf).float(), w_qkv.to(bf).float()) + b_qkv.float()
    qkv = window_partition(qkv.to(bf), (wh, ww)).reshape(-1, l, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).float()  # each [Bw, heads, L, hd]

    def unit(t):
        inv = torch.rsqrt(torch.clamp_min(torch.sum(t * t, -1, keepdim=True), 1e-24))
        return (t * inv).to(bf).float(), inv

    qn, inv_q = unit(q)
    kn, inv_k = unit(k)
    s = torch.matmul(qn, kn.transpose(-1, -2))  # [Bw, heads, L, L]
    sc = scale.float().reshape(1, heads, 1, 1)
    if badd is None:
        z = (s - 1.0) * sc
    else:
        z = s * sc + badd.float().reshape(1, heads, l, l)
    if mask_pattern is not None:
        flag = 1.0 if boundary_flag is None else float(boundary_flag)
        mask = torch.as_tensor(mask_pattern, dtype=torch.float32, device=x.device)
        row_gate = torch.zeros(nwh, dtype=torch.float32, device=x.device)
        row_gate[-1] = flag
        z = z.reshape(b, nwh, nww, heads, l, l) + row_gate.reshape(1, nwh, 1, 1, 1, 1) * mask
        z = z.reshape(-1, heads, l, l)
    e = torch.exp(z)
    r = 1.0 / torch.sum(e, -1, keepdim=True)
    return v, qn, kn, inv_q, inv_k, e, r


def _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd):
    from swin_v2_weather_torch.models.swin import window_reverse

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    c = w_qkv.shape[-1] // 3
    v, _, _, _, _, e, r = _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern,
                                     boundary_flag, badd)
    out = torch.matmul(e.to(torch.bfloat16).float(), v) * r  # [Bw, heads, L, hd]
    out = out.to(x.dtype).permute(0, 2, 1, 3).reshape(-1, wh, ww, c)
    return window_reverse(out, (wh, ww), (h, w))


def window_attention_qkv_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask; None means 1
) -> torch.Tensor:
    """Plain version of the fused kernel: [B, H, W, C_in] -> [B, H, W, C]."""
    return _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, None)


def window_attention_qkv_bias_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    badd: torch.Tensor,  # [heads, L, L] fp32, fold_cpb_bias(bias, scale)
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
) -> torch.Tensor:
    """Plain version of K7's forward: the fused kernel with the pre-folded CPB
    term, z = s * scale + badd[h] (+ mask) in fp32 with no max pass."""
    return _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd)


def _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag, badd):
    from swin_v2_weather_torch.models.swin import window_partition, window_reverse

    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    l = wh * ww
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads
    bf = torch.bfloat16
    sc = scale.float().reshape(1, heads, 1, 1)

    v, qn, kn, inv_q, inv_k, e, r = _recompute(
        x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd
    )
    g16 = window_partition(g.to(bf), (wh, ww)).reshape(-1, l, heads, hd)
    g16 = g16.permute(0, 2, 1, 3).float()  # [Bw, heads, L, hd]

    p16 = (e * r).to(bf).float()
    dv = torch.matmul(p16.transpose(-1, -2), g16)
    dp = torch.matmul(g16, v.transpose(-1, -2))
    u = torch.sum(dp * e, -1, keepdim=True)
    ds = (dp - u * r) * e * (r * sc)
    # d(badd) = ds / scale as the reciprocal product, summed over windows
    dbias = None if badd is None else torch.sum(ds * (1.0 / sc), dim=0)
    dsb = ds.to(bf).float()
    dqn = torch.matmul(dsb, kn)
    dkn = torch.matmul(dsb.transpose(-1, -2), qn)
    qd = torch.sum(qn * dqn, -1, keepdim=True)
    kd = torch.sum(kn * dkn, -1, keepdim=True)
    dscale = torch.sum(qd, dim=(0, 2, 3)) / scale.float()
    dq = (dqn - qn * qd) * inv_q
    dk = (dkn - kn * kd) * inv_k

    # [Bw, heads, L, hd] x 3 -> [Bw, L, 3, heads, hd] -> grid [B, H, W, 3C]
    dqkv = torch.stack([dq, dk, dv], dim=2).to(bf).permute(0, 3, 2, 1, 4)
    dqkv = window_reverse(dqkv.reshape(-1, wh, ww, 3 * c), (wh, ww), (h, w))
    d2 = dqkv.reshape(-1, 3 * c).float()
    x2 = x.reshape(-1, c_in).to(bf).float()
    dx = torch.matmul(d2, w_qkv.to(bf).float().t()).to(x.dtype).reshape(x.shape)
    dw = torch.matmul(x2.t(), d2)
    db = torch.sum(d2, 0)
    return dx, dw, db, dscale, dbias


def window_attention_qkv_backward_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    g: torch.Tensor,  # [B, H, W, C]: cotangent of the output
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
):
    """Plain version of the backward kernel: (dx, dW, db, dscale).

    Follows ``_make_qkv_bwd_kernel``'s rounding sites, not autograd through
    the forward: qkv, qn16, kn16, e and r recomputed as the forward computes
    them; g16 = bf16(g); p16 = bf16(e r); dv = p16^T g16 and dp = g16 v^T in
    fp32; u = sum(dp e); ds = (dp - u r) e (r scale); dsb = bf16(ds);
    dqn = dsb kn16 and dkn = dsb^T qn16; dscale_h = sum(qn16 dqn) / scale_h;
    dq = (dqn - qn16 <qn16, dqn>) inv_q, likewise dk; dqkv = bf16([dq|dk|dv]);
    dx = dqkv bf16(W)^T in x's dtype; dW = bf16(x)^T dqkv, db = sum dqkv and
    dscale in fp32 (the cast to the inputs' dtypes is the caller's, as in
    ``f_bwd``).
    """
    return _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag,
                           None)[:4]


def window_attention_qkv_bias_backward_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    badd: torch.Tensor,  # [heads, L, L] fp32
    g: torch.Tensor,  # [B, H, W, C]
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
):
    """Plain version of K7's backward: (dx, dW, db, dscale, dbias).

    The sites of :func:`window_attention_qkv_backward_reference` with the
    forward's z = s * scale + badd; dbias[h] = sum over windows of
    ds * (1 / scale_h) in fp32, ds unrounded (``_make_qkv_bwd_kernel``'s
    ``dsf * (1.0 / scl)``). The dscale identity sum(ds s) = sum(qn16 dqn) /
    scale holds with the bias, since the softmax VJP's rows sum to zero.
    """
    return _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag,
                           badd)


def _check_operands(name, x, w_qkv, b_qkv, scale, window, mask_pattern, g=None, badd=None):
    """Device, dtypes, shapes and shape limits of a kernel call, or raise;
    returns (b, h, w, c_in, c, heads, wh, ww, l)."""
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D CUDA tensor, got {x.dim()}-D on {x.device}")
    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    _window_grid(x, window)
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    l = wh * ww
    dev = x.device
    _build.check_operand(name, "x", x, torch.bfloat16, (b, h, w, c_in), dev)
    _build.check_operand(name, "w_qkv", w_qkv, torch.bfloat16, (c_in, 3 * c), dev)
    _build.check_operand(name, "b_qkv", b_qkv, torch.float32, (3 * c,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (b, h, w, c), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if badd is not None:
        _build.check_operand(name, "badd", badd, torch.float32, (heads, l, l), dev)
    if c % heads or c // heads not in (32, 64, 96, 128) or c_in % 32 or l > 256:
        raise ValueError(
            f"{name}: needs head dim in (32, 64, 96, 128), C_in % 32 == 0 and "
            f"L <= 256; got C={c}, heads={heads}, C_in={c_in}, L={l}"
        )
    return b, h, w, c_in, c, heads, wh, ww, l


def _launch_forward(fn, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd):
    name = fn.__name__
    b, h, w, c_in, c, heads, wh, ww, _ = _check_operands(
        name, x, w_qkv, b_qkv, scale, window, mask_pattern, badd=badd)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    mask_ptr = None if mask_pattern is None else mask_pattern.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr())
        tail = (mask_ptr, float(boundary_flag), out.data_ptr(),
                b, h, w, c_in, c, heads, wh, ww, stream)
        if badd is None:
            code = lib.swin_window_attention_qkv_fwd(*head, *tail)
        else:
            code = lib.swin_window_attention_qkv_bias_fwd(*head, badd.data_ptr(), *tail)
    _build.check(code, name)
    fn.launches += 1
    return out


def window_attention_qkv(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
) -> torch.Tensor:
    """The CUDA kernel: x [B, H, W, C_in] bf16, w_qkv [C_in, 3C] bf16,
    b_qkv [3C] fp32, scale [heads] fp32, mask_pattern [L, L] fp32 or None
    -> [B, H, W, C] bf16.

    C_in must be a multiple of 32, the head dim one of 32/64/96/128 and
    L = wh * ww at most 256. Launches on the current stream and does not
    synchronize.
    """
    return _launch_forward(window_attention_qkv, x, w_qkv, b_qkv, scale, window, mask_pattern,
                           boundary_flag, None)


window_attention_qkv.launches = 0


def window_attention_qkv_bias(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    badd: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
) -> torch.Tensor:
    """K7's forward kernel: :func:`window_attention_qkv` plus the pre-folded CPB
    term badd [heads, L, L] fp32 (row-max-shifted, so the max-free softmax
    holds). Same limits; launches on the current stream."""
    return _launch_forward(window_attention_qkv_bias, x, w_qkv, b_qkv, scale, window,
                           mask_pattern, boundary_flag, badd)


window_attention_qkv_bias.launches = 0


def _launch_backward(fn, x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag, badd):
    name = fn.__name__
    b, h, w, c_in, c, heads, wh, ww, l = _check_operands(
        name, x, w_qkv, b_qkv, scale, window, mask_pattern, g=g, badd=badd)
    nwh, nww = h // wh, w // ww
    dev = x.device
    t = b * h * w
    # token ranges of the split-K dW GEMM and of the db column sums
    dw_splits = max(1, min(16, -(-t // 2048)))
    db_splits = max(1, min(64, -(-t // 512)))
    f32 = dict(dtype=torch.float32, device=dev)
    dqkv = torch.empty((b, h, w, 3 * c), dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((dw_splits, c_in, 3 * c), **f32)
    db_part = torch.empty((db_splits, 3 * c), **f32)
    dscale_part = torch.empty((b * nwh * nww, heads), **f32)
    dx = torch.empty_like(x)
    dw = torch.empty((c_in, 3 * c), **f32)
    db = torch.empty((3 * c,), **f32)
    dscale = torch.empty((heads,), **f32)
    lib = _build.load_library()
    mask_ptr = None if mask_pattern is None else mask_pattern.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr())
        mid = (mask_ptr, float(boundary_flag), g.data_ptr(), dqkv.data_ptr(),
               dw_part.data_ptr(), db_part.data_ptr(), dscale_part.data_ptr())
        outs = (dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dscale.data_ptr())
        dims = (b, h, w, c_in, c, heads, wh, ww, dw_splits, db_splits, stream)
        if badd is None:
            code = lib.swin_window_attention_qkv_bwd(*head, *mid, *outs, *dims)
        else:
            # one fp32 [LP, LP] d(bias) partial per (window, head), LP = L
            # rounded up to 16, summed in window order by the last kernel
            lp = -(-l // 16) * 16
            dbias_part = torch.empty((b * nwh * nww, heads, lp, lp), **f32)
            dbias = torch.empty((heads, l, l), **f32)
            code = lib.swin_window_attention_qkv_bias_bwd(
                *head, badd.data_ptr(), *mid, dbias_part.data_ptr(), *outs, dbias.data_ptr(),
                *dims)
    _build.check(code, name)
    fn.launches += 1
    return (dx, dw, db, dscale) if badd is None else (dx, dw, db, dscale, dbias)


def window_attention_qkv_bwd(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    g: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
):
    """The CUDA backward kernels: x [B, H, W, C_in] bf16, w_qkv [C_in, 3C] bf16,
    b_qkv [3C] fp32, scale [heads] fp32, g [B, H, W, C] bf16, mask_pattern
    [L, L] fp32 or None -> (dx [B, H, W, C_in] bf16, dW [C_in, 3C] fp32,
    db [3C] fp32, dscale [heads] fp32).

    Same shape limits as the forward kernel, and the shared memory of the
    attention pass must fit (at head dim 96, L up to 176). Launches on the
    current stream and does not synchronize; dW, db and dscale are summed in a
    fixed order, so two calls give the same bits.
    """
    return _launch_backward(window_attention_qkv_bwd, x, w_qkv, b_qkv, scale, g, window,
                            mask_pattern, boundary_flag, None)


window_attention_qkv_bwd.launches = 0


def window_attention_qkv_bias_bwd(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    badd: torch.Tensor,
    g: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
):
    """K7's backward kernels: :func:`window_attention_qkv_bwd` with the
    pre-folded CPB term badd [heads, L, L] fp32, returning also dbias
    [heads, L, L] fp32. Every (window, head) writes its d(bias) partial to a
    [B * nW, heads, LP, LP] fp32 workspace (336 MB at the flagship shape) that
    one kernel sums in window order: no atomics, two calls give the same
    bits."""
    return _launch_backward(window_attention_qkv_bias_bwd, x, w_qkv, b_qkv, scale, g, window,
                            mask_pattern, boundary_flag, badd)


window_attention_qkv_bias_bwd.launches = 0


def _flag(boundary_flag) -> float:
    return 1.0 if boundary_flag is None else float(boundary_flag)


class WindowAttentionQKV(torch.autograd.Function):
    """Forward K1, backward K2 (or their plain versions for CPU tensors).

    Saves (x, w_qkv, b_qkv, scale) and nothing larger, like ``_build_qkv``'s
    ``f_fwd``: the backward recomputes the projection and the softmax. The
    mask pattern and the flag are constants (no gradient, as in JAX, where
    d(flag) is zero).
    """

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
        ctx.save_for_backward(x, w_qkv, b_qkv, scale)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        if x.device.type == "cpu":
            return window_attention_qkv_reference(
                x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag
            )
        return window_attention_qkv(
            x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(), b_qkv.float().contiguous(),
            scale.float().contiguous(), window, mask_pattern, _flag(boundary_flag),
        )

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, db, dscale = window_attention_qkv_backward_reference(
                x, w_qkv, b_qkv, scale, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag
            )
        else:
            dx, dw, db, dscale = window_attention_qkv_bwd(
                x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(),
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                _flag(ctx.boundary_flag),
            )
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype),
                None, None, None)


class WindowAttentionQKVBias(torch.autograd.Function):
    """Forward and backward of K7 (or their plain versions for CPU tensors).

    ``bias`` is the pre-folded term badd when ``prefolded`` (the model folds
    it with :func:`fold_cpb_bias`, so the fold's ``- scale`` reaches d(scale)
    through autograd there); otherwise the raw [heads, L, L] bias, which is
    row-max-shifted and folded here with no gradient through the fold, as
    ``_build_qkv_bias(prefolded=False)`` does. Saves (x, w_qkv, b_qkv, scale,
    badd), as ``f_fwd`` does; the returned d(bias) is d(badd), in fp32 cast to
    the bias's dtype.
    """

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, bias, prefolded, window, mask_pattern,
                boundary_flag):
        badd = bias.float() if prefolded else fold_cpb_bias(bias, scale)
        ctx.save_for_backward(x, w_qkv, b_qkv, scale, badd)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        ctx.bias_dtype = bias.dtype
        if x.device.type == "cpu":
            return window_attention_qkv_bias_reference(
                x, w_qkv, b_qkv, scale, badd, window, mask_pattern, boundary_flag
            )
        return window_attention_qkv_bias(
            x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(), b_qkv.float().contiguous(),
            scale.float().contiguous(), badd.contiguous(), window, mask_pattern,
            _flag(boundary_flag),
        )

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale, badd = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, db, dscale, dbias = window_attention_qkv_bias_backward_reference(
                x, w_qkv, b_qkv, scale, badd, g, ctx.window, ctx.mask_pattern,
                ctx.boundary_flag
            )
        else:
            dx, dw, db, dscale, dbias = window_attention_qkv_bias_bwd(
                x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(), badd.contiguous(),
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                _flag(ctx.boundary_flag),
            )
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None, None)


def fused_window_attention_qkv(
    x: torch.Tensor,  # [B, H, W, C_in] (already rolled for shifted blocks)
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask (spatial sharding)
    bias: Optional[torch.Tensor] = None,  # CPB [heads, L, L]
    bias_prefolded: bool = False,  # bias is already fold_cpb_bias(raw, scale)
) -> torch.Tensor:
    """qkv projection + window attention fused: [B,H,W,Cin] -> [B,H,W,C],
    differentiable in x, w_qkv, b_qkv, scale and the CPB bias (K7's route
    when a bias is given, K1/K2's otherwise)."""
    _window_grid(x, window)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention_qkv: no implementation for device {x.device}")
    if mask_pattern is not None and x.device.type == "cuda":
        mask_pattern = torch.as_tensor(mask_pattern).to(device=x.device, dtype=torch.float32)
        mask_pattern = mask_pattern.contiguous()
    if bias is None:
        return WindowAttentionQKV.apply(
            x, w_qkv, b_qkv, scale, tuple(window), mask_pattern, boundary_flag
        )
    l = int(window[0]) * int(window[1])
    if tuple(bias.shape) != (int(scale.shape[0]), l, l):
        raise ValueError(f"fused_window_attention_qkv: the CPB bias must be [heads, L, L] = "
                         f"{(int(scale.shape[0]), l, l)}, got {tuple(bias.shape)}")
    return WindowAttentionQKVBias.apply(
        x, w_qkv, b_qkv, scale, bias, bool(bias_prefolded), tuple(window), mask_pattern,
        boundary_flag,
    )
