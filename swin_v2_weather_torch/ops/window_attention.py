"""qkv-fused scaled-cosine window attention: plain PyTorch versions and CUDA kernels.

Counterpart of the v3 kernel pair of ``swin_v2_weather_tpu/ops/window_attention.py``
(forward ``_make_qkv_kernel`` / ``_qkv_forward``, backward
``_make_qkv_bwd_kernel`` / ``_qkv_backward``, custom_vjp ``_build_qkv``, entry
point ``fused_window_attention_qkv``). The input is the model's NHWC grid
``[B, H, W, C_in]``, already rolled for shifted blocks; the qkv projection,
the windowing, per-head q/k L2 normalization, the max-free softmax and the
e @ v product happen in one call, and the output comes back in grid layout
``[B, H, W, C]``.

  * :func:`window_attention_qkv_reference` /
    :func:`window_attention_qkv_backward_reference` -- the plain versions (CPU
    path and test oracles), with the kernels' rounding sites.
  * :func:`window_attention_qkv` / :func:`window_attention_qkv_bwd` -- launch
    ``csrc/window_attention_qkv.cu`` (K1) and
    ``csrc/window_attention_qkv_bwd.cu`` (K2) on CUDA tensors; each counts
    its launches.
  * :class:`WindowAttentionQKV` -- the autograd Function: it saves only
    (x, w_qkv, b_qkv, scale), as ``_build_qkv``'s ``f_fwd`` does, and its
    backward recomputes everything else.
  * :func:`fused_window_attention_qkv` -- the entry point the model calls; a
    CPU tensor takes the plain versions, a CUDA tensor the kernels (or an
    error).

The shifted-window mask is latitude-only: every masked window lies in the
last window row and all of them share one [L, L] pattern
(``make_shift_mask(...)[-1]``), added there times ``boundary_flag``.

Rounding sites (the TPU kernel's contract, kept by both versions): qkv is
accumulated in fp32 from bf16-cast x and W whatever the input dtype, plus the
fp32 bias, then rounded to bf16; q16 = bf16(q * rsqrt(max(sum q^2, 1e-24))),
likewise k16; s = q16 @ k16^T in fp32; z = (s - 1) * scale (+ mask); e = exp(z)
with no max pass (|s| <= 1); out = (bf16(e) @ v16 in fp32) / sum(e), cast to
x's dtype. The backward's sites are listed in
:func:`window_attention_qkv_backward_reference`.

Gradient dtypes follow ``_build_qkv``'s ``f_bwd``: dx in x's dtype, dW in the
dtype of the w_qkv handed in (bf16 in the model, which casts the fp32
parameter first, so the cast's backward lifts it to fp32), db and dscale in
fp32.
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


def _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
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
    z = (s - 1.0) * scale.float().reshape(1, heads, 1, 1)
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
    from swin_v2_weather_torch.models.swin import window_reverse

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    c = w_qkv.shape[-1] // 3
    v, _, _, _, _, e, r = _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag)
    out = torch.matmul(e.to(torch.bfloat16).float(), v) * r  # [Bw, heads, L, hd]
    out = out.to(x.dtype).permute(0, 2, 1, 3).reshape(-1, wh, ww, c)
    return window_reverse(out, (wh, ww), (h, w))


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
        x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag
    )
    g16 = window_partition(g.to(bf), (wh, ww)).reshape(-1, l, heads, hd)
    g16 = g16.permute(0, 2, 1, 3).float()  # [Bw, heads, L, hd]

    p16 = (e * r).to(bf).float()
    dv = torch.matmul(p16.transpose(-1, -2), g16)
    dp = torch.matmul(g16, v.transpose(-1, -2))
    u = torch.sum(dp * e, -1, keepdim=True)
    dsb = ((dp - u * r) * e * (r * sc)).to(bf).float()
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
    return dx, dw, db, dscale


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
    name = "window_attention_qkv"
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D CUDA tensor, got {x.dim()}-D on {x.device}")
    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    _window_grid(x, window)
    heads = int(scale.shape[0])
    c3 = w_qkv.shape[-1]
    c = c3 // 3
    l = wh * ww
    dev = x.device
    _build.check_operand(name, "x", x, torch.bfloat16, (b, h, w, c_in), dev)
    _build.check_operand(name, "w_qkv", w_qkv, torch.bfloat16, (c_in, 3 * c), dev)
    _build.check_operand(name, "b_qkv", b_qkv, torch.float32, (3 * c,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if c % heads or c // heads not in (32, 64, 96, 128) or c_in % 32 or l > 256:
        raise ValueError(
            f"{name}: needs head dim in (32, 64, 96, 128), C_in % 32 == 0 and "
            f"L <= 256; got C={c}, heads={heads}, C_in={c_in}, L={l}"
        )
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swin_window_attention_qkv_fwd(
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(),
            float(boundary_flag), out.data_ptr(),
            b, h, w, c_in, c, heads, wh, ww, stream,
        )
    _build.check(code, name)
    window_attention_qkv.launches += 1
    return out


window_attention_qkv.launches = 0


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
    name = "window_attention_qkv_bwd"
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D CUDA tensor, got {x.dim()}-D on {x.device}")
    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    nwh, nww = _window_grid(x, window)
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    l = wh * ww
    dev = x.device
    _build.check_operand(name, "x", x, torch.bfloat16, (b, h, w, c_in), dev)
    _build.check_operand(name, "w_qkv", w_qkv, torch.bfloat16, (c_in, 3 * c), dev)
    _build.check_operand(name, "b_qkv", b_qkv, torch.float32, (3 * c,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    _build.check_operand(name, "g", g, torch.bfloat16, (b, h, w, c), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if c % heads or c // heads not in (32, 64, 96, 128) or c_in % 32 or l > 256:
        raise ValueError(
            f"{name}: needs head dim in (32, 64, 96, 128), C_in % 32 == 0 and "
            f"L <= 256; got C={c}, heads={heads}, C_in={c_in}, L={l}"
        )
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swin_window_attention_qkv_bwd(
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(),
            float(boundary_flag), g.data_ptr(), dqkv.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dscale_part.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            db.data_ptr(), dscale.data_ptr(),
            b, h, w, c_in, c, heads, wh, ww, dw_splits, db_splits, stream,
        )
    _build.check(code, name)
    window_attention_qkv_bwd.launches += 1
    return dx, dw, db, dscale


window_attention_qkv_bwd.launches = 0


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
            scale.float().contiguous(), window, mask_pattern,
            1.0 if boundary_flag is None else float(boundary_flag),
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
                1.0 if ctx.boundary_flag is None else float(ctx.boundary_flag),
            )
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype),
                None, None, None)


def fused_window_attention_qkv(
    x: torch.Tensor,  # [B, H, W, C_in] (already rolled for shifted blocks)
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask (spatial sharding)
    bias: Optional[torch.Tensor] = None,  # CPB [heads, L, L]: not ported yet
) -> torch.Tensor:
    """qkv projection + window attention fused: [B,H,W,Cin] -> [B,H,W,C],
    differentiable in x, w_qkv, b_qkv and scale."""
    if bias is not None:
        raise NotImplementedError("the CPB bias (rel_pos) kernel is not ported yet")
    _window_grid(x, window)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention_qkv: no implementation for device {x.device}")
    if mask_pattern is not None and x.device.type == "cuda":
        mask_pattern = torch.as_tensor(mask_pattern).to(device=x.device, dtype=torch.float32)
        mask_pattern = mask_pattern.contiguous()
    return WindowAttentionQKV.apply(
        x, w_qkv, b_qkv, scale, tuple(window), mask_pattern, boundary_flag
    )
