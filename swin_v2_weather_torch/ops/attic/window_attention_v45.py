"""K12: the v4 and v5 qkv-fused window-attention schedules.

Counterpart of ``swin_v2_weather_tpu/ops/attic/window_attention_v45.py``
(v5: ``_make_qkv5_kernel`` / ``_qkv5_forward``, ``_make_qkv5_bwd_kernel`` /
``_qkv5_backward``, custom_vjp ``_build_qkv5``; v4: ``_make_qkv4_kernel`` /
``_qkv4_forward``, ``_make_qkv4_bwd_kernel`` / ``_qkv4_backward``, custom_vjp
``_build_qkv4`` with ``QKV_PAD_HEADS``). Both are selected through
:func:`~swin_v2_weather_torch.ops.window_attention.fused_window_attention_qkv`
(``impl='v4'``/``'v5'``, or ``QKV_IMPL``), which imports this module on first
use, as JAX's dispatch does; with a CPB bias the v3 schedule (K7) runs
whatever the selection, as in JAX.

  * **v5** computes v3's function (K1/K2's rounding sites) from the weight
    reordered once to [3 * heads, C_in, hd] (:func:`w5_reorder`), each (role,
    head) slab a dense [C_in, hd] box. The CUDA kernels are K1/K2's: the
    projection on the GEMM core one slab at a time (in the packed product's
    K order), then K1's pass, or K2's backward (``QKV_V5``, one-block or
    streamed as :func:`~swin_v2_weather_torch.ops.window_attention.
    qkv_variant` says), which takes dx and dW from the packed weight, as the
    TPU kernel does. The plain versions are v3's on the packed weight
    (bit-equal).
  * **v4** reads window-major rows [B, nW, Lp, C_in] (:func:`window_major`,
    Lp = L rounded up to 8, zero pad rows) and is a different function at the
    bf16 level: the forward rounds p16 = bf16(e * (1 / sum e)) before p16 @ v
    (v3: (bf16(e) @ v) / sum e), and the backward takes the fp32 qn = q *
    inv_q, not qn16, in qd = sum(qn dqn), in d(scale) and in the normalization
    VJP (likewise kn). The softmax is K1's max-free one with the pad keys
    masked out (e = 0); the pad query rows are computed (their x is zero, so q
    = bf16(b_q)) and thrown away by :func:`window_major_inverse`; their g rows
    are zero, so they add nothing to dW, db or d(scale). Its kernels are K1/K2's
    with the window-major layout and v4's rounding: the forward's pass in
    layout ``QKV4`` (two key sweeps, p16 rounded before p @ v; the plain
    order of its sums is :func:`v4_pass`), the backward ``QKV_V4``; the
    padded-head v4 (``QKV_PAD_HEADS``, from ``SWIN_QKV_PAD_HEADS``, read at call
    time) is their head-pitch-128 instance, computing on the live lanes with
    exact zeros in the pad lanes, as K10 does.

v4's kernels take K1/K2's shapes: the forward any L at head dims 32-256
(padded heads up to 128); the backward its one-block instances where those
fit shared memory, beyond that (at L = 162: head dim 256; every head dim
past L = 256, padded heads too) v4 instances of the streamed variant
(``csrc/window_attention_qkv_large.cu``), which park the raw q, k rows in
dqkv for the fp32 qn (the one-block backward reads them from its
projection scratch). Any other shape raises a ValueError before a launch,
as for K1/K2. JAX's
``SWIN_QKV_FWD_WC`` / ``SWIN_QKV_BWD_WC`` and ``_pick_nwc`` size the TPU's grid
steps (windows per step); one block per (window, head) has no counterpart of
them. ``QKV_BWD_IMPL`` does not apply here: JAX reads it only in
``_build_qkv``; v4 and v5 have their own backwards.

Gradient dtypes follow ``f_bwd``: dx in x's dtype, dW in w_qkv's, db and
d(scale) in their inputs' dtypes (fp32 from the kernels).
"""

from __future__ import annotations

import os as _os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from swin_v2_weather_torch.ops import _build, gemm_core
from swin_v2_weather_torch.ops import window_attention as wa

# v4's padded heads (each head's qkv columns zero-padded to 128 lanes), as
# JAX's attic module reads SWIN_QKV_PAD_HEADS; read at call time
QKV_PAD_HEADS = _os.environ.get("SWIN_QKV_PAD_HEADS", "0") == "1"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# layouts (plain tensor ops, as JAX runs them in XLA outside the kernels)
# ---------------------------------------------------------------------------


def w5_reorder(w_qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """[C_in, 3C] -> [3 * heads, C_in, hd] bf16 (``_w5_reorder``)."""
    c_in, c3 = w_qkv.shape
    hd = c3 // 3 // heads
    w = w_qkv.reshape(c_in, 3, heads, hd).permute(1, 2, 0, 3)
    return w.reshape(3 * heads, c_in, hd).to(torch.bfloat16)


def w5_inverse(w5: torch.Tensor) -> torch.Tensor:
    """[3 * heads, C_in, hd] -> [C_in, 3C] (the packed order), w5's dtype."""
    n, c_in, hd = w5.shape
    return w5.permute(1, 0, 2).reshape(c_in, n * hd)


def b5_reorder(b_qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """[3C] -> [3 * heads, hd] fp32 (``_b5_reorder``: the packed order)."""
    return b_qkv.reshape(3 * heads, -1).float()


def window_major(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, nW, Lp, C], window-major token order, Lp = L
    rounded up to 8, the pad rows zero (``window_major``)."""
    b, h, w, c = x.shape
    wh, ww = int(window[0]), int(window[1])
    nwh, nww = h // wh, w // ww
    l = wh * ww
    xw = x.reshape(b, nwh, wh, nww, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nwh * nww, l, c)
    lp = _round_up(l, 8)
    return F.pad(xw, (0, 0, 0, lp - l)) if lp != l else xw.contiguous()


def window_major_inverse(xw: torch.Tensor, window: Tuple[int, int],
                         hw: Tuple[int, int]) -> torch.Tensor:
    """[B, nW, Lp, C] -> [B, H, W, C], the pad rows dropped
    (``window_major_inverse``)."""
    b, _, _, c = xw.shape
    wh, ww = int(window[0]), int(window[1])
    h, w = int(hw[0]), int(hw[1])
    x = xw[:, :, : wh * ww].reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def pad_mask_lp(mask_pattern, l: int, lp: int, device=None) -> torch.Tensor:
    """The [L, L] mask zero-padded to [Lp, Lp] fp32 (``_pad_mask_lp``)."""
    patt = torch.zeros((lp, lp), dtype=torch.float32, device=device)
    patt[:l, :l] = torch.as_tensor(mask_pattern, dtype=torch.float32, device=device)
    return patt


# ---------------------------------------------------------------------------
# v5: plain versions, kernels, autograd Function
# ---------------------------------------------------------------------------


def window_attention_qkv5_reference(x, w5, b_qkv, scale, window, mask_pattern=None,
                                    boundary_flag=None):
    """Plain version of v5's forward: x [B, H, W, C_in], w5 [3 * heads, C_in,
    hd], b_qkv [3C], scale [heads] -> [B, H, W, C]: v3's plain version on the
    packed weight (v5 computes v3's function)."""
    return wa.window_attention_qkv_reference(x, w5_inverse(w5), b_qkv, scale, window,
                                             mask_pattern, boundary_flag)


def window_attention_qkv5_backward_reference(x, w5, w_qkv, b_qkv, scale, g, window,
                                             mask_pattern=None, boundary_flag=None):
    """Plain version of v5's backward: (dx, dW, db, dscale), v3's plain
    backward (the recompute from w5 equals the one from the packed w_qkv)."""
    del w5
    return wa.window_attention_qkv_backward_reference(x, w_qkv, b_qkv, scale, g, window,
                                                      mask_pattern, boundary_flag)


def window_attention_qkv5(x, w5, b_qkv, scale, window, mask_pattern=None, boundary_flag=1.0):
    """K12 v5's forward kernel: x [B, H, W, C_in] bf16, w5 [3 * heads, C_in,
    hd] bf16, b_qkv [3C] fp32, scale [heads] fp32, mask_pattern [L, L] fp32 or
    None -> [B, H, W, C] bf16. K1's shapes; launches on the current
    stream."""
    return wa._launch_forward(window_attention_qkv5, x, None, b_qkv, scale, window, mask_pattern,
                              boundary_flag, None, w5=w5)


window_attention_qkv5.launches = 0


@torch.library.custom_op("swin::window_attention_qkv5", mutates_args=())
def window_attention_qkv5_op(x: torch.Tensor, w5: torch.Tensor, b_qkv: torch.Tensor,
                             scale: torch.Tensor, window: List[int],
                             mask_pattern: Optional[torch.Tensor],
                             boundary_flag: float) -> torch.Tensor:
    """v5's forward launch (:func:`window_attention_qkv5`) as the custom op
    ``swin::window_attention_qkv5``."""
    return window_attention_qkv5(x, w5, b_qkv, scale, tuple(window), mask_pattern,
                                 boundary_flag)


@window_attention_qkv5_op.register_fake
def _window_attention_qkv5_fake(x, w5, b_qkv, scale, window, mask_pattern, boundary_flag):
    return x.new_empty((*x.shape[:-1], b_qkv.shape[0] // 3), dtype=torch.bfloat16)


def served_qkv5(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
    """The serving forward of v5 on CUDA tensors: :class:`WindowAttentionQKV5`'s
    forward through ``swin::window_attention_qkv5``."""
    w5 = w5_reorder(w_qkv, int(scale.shape[0]))
    return window_attention_qkv5_op(x.contiguous(), w5.contiguous(), b_qkv.float().contiguous(),
                                    scale.float().contiguous(), list(window), mask_pattern,
                                    wa._flag(boundary_flag))


def window_attention_qkv5_bwd(x, w5, w_qkv, b_qkv, scale, g, window, mask_pattern=None,
                              boundary_flag=1.0):
    """K12 v5's backward kernels: the forward's operands, the packed w_qkv
    [C_in, 3C] bf16 (for dx and dW) and g [B, H, W, C] bf16 -> (dx bf16, dW,
    db, dscale fp32), summed in a fixed order (two calls give the same
    bits)."""
    return wa._launch_backward(window_attention_qkv5_bwd, x, w_qkv, b_qkv, scale, g, window,
                               mask_pattern, boundary_flag, None, w5=w5)


window_attention_qkv5_bwd.launches = 0


class WindowAttentionQKV5(torch.autograd.Function):
    """v5 forward and backward (kernels on CUDA tensors, plain versions on CPU
    tensors). Saves (x, w_qkv, b_qkv, scale), as ``_build_qkv5``'s ``f_fwd``
    does; the weight is reordered in each pass."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
        ctx.save_for_backward(x, w_qkv, b_qkv, scale)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        w5 = w5_reorder(w_qkv, int(scale.shape[0]))
        if x.device.type == "cpu":
            return window_attention_qkv5_reference(x, w5, b_qkv, scale, window, mask_pattern,
                                                   boundary_flag)
        return window_attention_qkv5(x.contiguous(), w5.contiguous(), b_qkv.float().contiguous(),
                                     scale.float().contiguous(), window, mask_pattern,
                                     wa._flag(boundary_flag))

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale = ctx.saved_tensors
        w5 = w5_reorder(w_qkv, int(scale.shape[0]))
        if x.device.type == "cpu":
            dx, dw, db, dscale = window_attention_qkv5_backward_reference(
                x, w5, w_qkv, b_qkv, scale, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag)
        else:
            dx, dw, db, dscale = window_attention_qkv5_bwd(
                x.contiguous(), w5.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(),
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                wa._flag(ctx.boundary_flag))
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype), None, None,
                None)


# ---------------------------------------------------------------------------
# v4: plain versions
# ---------------------------------------------------------------------------


def _v4_recompute(xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern, boundary_flag,
                  quad=False):
    """v4's forward in plain ops on [B, nW, Lp, C_in] rows: (qn, kn, qn16,
    kn16, inv_q, inv_k, v16, e, r), each [B * nW, heads, Lp, *] fp32; qn, kn
    the fp32 q * inv_q, k * inv_k; e = 0 at the pad keys. ``quad``: the sum
    of squares in the forward projection epilogue's order
    (:func:`~swin_v2_weather_torch.ops.window_attention.quad_unit`)."""
    b, nw, lp, _ = xw.shape
    l = int(window[0]) * int(window[1])
    nwh, nww = int(window_grid[0]), int(window_grid[1])
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads
    bf = torch.bfloat16
    qkv = (torch.matmul(xw.to(bf).float(), w_qkv.to(bf).float()) + b_qkv.float()).to(bf)
    q, k, v = qkv.reshape(b * nw, lp, 3, heads, hd).permute(2, 0, 3, 1, 4).float()

    def unit(t):
        if quad:
            _, inv = wa.quad_unit(t)
            return t * inv, inv
        inv = torch.rsqrt(torch.clamp_min(torch.sum(t * t, -1, keepdim=True), 1e-24))
        return t * inv, inv

    qn, inv_q = unit(q)
    kn, inv_k = unit(k)
    qn16, kn16 = qn.to(bf).float(), kn.to(bf).float()
    s = torch.matmul(qn16, kn16.transpose(-1, -2))  # [Bw, heads, Lp, Lp]
    z = (s - 1.0) * scale.float().reshape(1, heads, 1, 1)
    if mask_pattern is not None:
        flag = 1.0 if boundary_flag is None else float(boundary_flag)
        gate = torch.zeros(nwh, dtype=torch.float32, device=xw.device)
        gate[-1] = flag  # the last window row (window index // nww == nwh - 1)
        gate = gate.repeat_interleave(nww).reshape(1, nw, 1, 1, 1)
        z = (z.reshape(b, nw, heads, lp, lp)
             + gate * pad_mask_lp(mask_pattern, l, lp, xw.device)).reshape(z.shape)
    z = z.masked_fill(torch.arange(lp, device=xw.device) >= l, float("-inf"))  # pad keys
    e = torch.exp(z)
    r = 1.0 / torch.sum(e, -1, keepdim=True)
    return qn, kn, qn16, kn16, inv_q, inv_k, v, e, r


def window_attention_qkv4_reference(xw, w_qkv, b_qkv, scale, window, window_grid,
                                    mask_pattern=None, boundary_flag=None):
    """Plain version of v4's forward: xw [B, nW, Lp, C_in] window-major,
    w_qkv [C_in, 3C], b_qkv [3C], scale [heads], window (wh, ww), window_grid
    (nwh, nww), mask_pattern [L, L] -> [B, nW, Lp, C] in xw's dtype, every
    row (the pad rows' output is thrown away by the caller). Sites: qkv =
    bf16(bf16(x) @ bf16(W) + b) (fp32 sum); qn16 = bf16(q * rsqrt(max(sum
    q^2, 1e-24))); z = (s - 1) * scale (+ gate * mask), -inf at the pad keys;
    e = exp(z); p16 = bf16(e * (1 / sum e)); out = p16 @ v16 in fp32."""
    b, nw, lp, _ = xw.shape
    *_, v, e, r = _v4_recompute(xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern,
                                boundary_flag)
    out = torch.matmul((e * r).to(torch.bfloat16).float(), v)  # [Bw, heads, Lp, hd]
    return out.to(xw.dtype).permute(0, 2, 1, 3).reshape(b, nw, lp, -1)


def v4_pass(e: torch.Tensor, v16: torch.Tensor) -> torch.Tensor:
    """v4's attention pass (layout QKV4 of ``csrc/qkv_attention.cuh``) in
    plain fp32 ops, from e = exp(z) [..., Lp, Lp] (0 at the pad keys) and the
    bf16-valued v16: p16 = bf16(e * (1 / sum e)), sum e in
    :func:`~swin_v2_weather_torch.ops.window_attention.lane_sums`' order;
    out = p16 @ v16 accumulated by key chunk; fp32."""
    p16 = (e * (1.0 / wa.lane_sums(e))[..., None]).to(torch.bfloat16)
    return wa.chunked_pv(p16, v16)


def window_attention_qkv4_pass_order(xw, w_qkv, b_qkv, scale, window, window_grid,
                                     mask_pattern=None, boundary_flag=None):
    """The plain version of v4's forward with the CUDA kernels' order of fp32
    sums (the projection epilogue's head normalization and :func:`v4_pass`);
    rounding sites as :func:`window_attention_qkv4_reference`'s."""
    b, nw, lp, _ = xw.shape
    *_, v, e, _ = _v4_recompute(xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern,
                                boundary_flag, quad=True)
    return v4_pass(e, v).to(xw.dtype).permute(0, 2, 1, 3).reshape(b, nw, lp, -1)


def window_attention_qkv4_backward_reference(xw, w_qkv, b_qkv, scale, gw, window, window_grid,
                                             mask_pattern=None, boundary_flag=None):
    """Plain version of v4's backward: (dxw [B, nW, Lp, C_in] in xw's dtype,
    dW [C_in, 3C], db [3C], dscale [heads] fp32), gw [B, nW, Lp, C] (zero pad
    rows). v3's backward sites, except that qd = sum(qn dqn), kd and the
    normalization VJP take the fp32 qn and kn: g16 = bf16(g); p16 = bf16(e r);
    dv = p16^T g16, dp = g16 v16^T; u = sum(dp e); dsb = bf16((dp - u r) e (r
    scale)); dqn = dsb kn16, dkn = dsb^T qn16; dscale = sum(qd) / scale; dq =
    (dqn - qn qd) inv_q; dqkv = bf16([dq | dk | dv]); dx = dqkv bf16(W)^T,
    dW = bf16(x)^T dqkv and db = sum dqkv in fp32."""
    b, nw, lp, c_in = xw.shape
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads
    bf = torch.bfloat16
    sc = scale.float().reshape(1, heads, 1, 1)
    qn, kn, qn16, kn16, inv_q, inv_k, v, e, r = _v4_recompute(
        xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern, boundary_flag)
    g16 = gw.to(bf).float().reshape(b * nw, lp, heads, hd).permute(0, 2, 1, 3)
    p16 = (e * r).to(bf).float()
    dv = torch.matmul(p16.transpose(-1, -2), g16)
    dp = torch.matmul(g16, v.transpose(-1, -2))
    u = torch.sum(dp * e, -1, keepdim=True)
    dsb = ((dp - u * r) * e * (r * sc)).to(bf).float()
    dqn = torch.matmul(dsb, kn16)
    dkn = torch.matmul(dsb.transpose(-1, -2), qn16)
    qd = torch.sum(qn * dqn, -1, keepdim=True)
    kd = torch.sum(kn * dkn, -1, keepdim=True)
    dscale = torch.sum(qd, dim=(0, 2, 3)) / scale.float()
    dq = (dqn - qn * qd) * inv_q
    dk = (dkn - kn * kd) * inv_k
    # [Bw, heads, Lp, hd] x 3 -> [Bw, Lp, 3, heads, hd] -> [B * nW * Lp, 3C]
    d2 = torch.stack([dq, dk, dv], dim=2).to(bf).permute(0, 3, 2, 1, 4).reshape(-1, 3 * c).float()
    x2 = xw.reshape(-1, c_in).to(bf).float()
    dxw = torch.matmul(d2, w_qkv.to(bf).float().t()).to(xw.dtype).reshape(xw.shape)
    return dxw, torch.matmul(x2.t(), d2), torch.sum(d2, 0), dscale


def window_attention_qkv4_padded_reference(xw, wp, bp, scale, hd, window, window_grid,
                                           mask_pattern=None, boundary_flag=None):
    """Plain version of the padded-head v4 forward: wp [C_in, 3 * heads *
    128], bp [3 * heads * 128] (head-padded), the live head dim ``hd`` -> [B,
    nW, Lp, heads * 128] with the pad lanes exactly zero: v4's sites on the
    live lanes (JAX's padded kernel adds only exact zeros in the pad lanes)."""
    heads = int(scale.shape[0])
    out = window_attention_qkv4_reference(xw, wa.unpad_heads(wp, 3 * heads, hd),
                                          wa.unpad_heads(bp, 3 * heads, hd), scale, window,
                                          window_grid, mask_pattern, boundary_flag)
    return wa.pad_heads_x(out, heads, hd)


def window_attention_qkv4_padded_backward_reference(xw, wp, bp, scale, hd, gw, window,
                                                    window_grid, mask_pattern=None,
                                                    boundary_flag=None):
    """Plain version of the padded-head v4 backward: (dxw, dWp, dbp with exact
    zero pad columns, dscale); gw's pad lanes are not read."""
    heads = int(scale.shape[0])
    dxw, dw, db, dscale = window_attention_qkv4_backward_reference(
        xw, wa.unpad_heads(wp, 3 * heads, hd), wa.unpad_heads(bp, 3 * heads, hd), scale,
        wa.unpad_heads(gw, heads, hd), window, window_grid, mask_pattern, boundary_flag)
    return dxw, wa.pad_heads_w(dw, heads), wa.pad_heads_vec(db, heads), dscale


# ---------------------------------------------------------------------------
# v4: kernels
# ---------------------------------------------------------------------------


def _check_v4(name, xw, w, b, scale, hd, window, window_grid, mask_pattern, g=None):
    """-> (b, nwh, nww, lp, c_in, c, variant); c = heads * hd, or heads * 128
    padded; the variant as :func:`~swin_v2_weather_torch.ops.window_attention.
    qkv_variant` picks it for K1/K2 (the one-block backward or the streamed
    one). Raises on a shape that v4's kernels do not take."""
    if xw.device.type != "cuda" or xw.dim() != 4:
        raise ValueError(f"{name}: xw must be a 4-D CUDA tensor, got {xw.dim()}-D on {xw.device}")
    bsz, nw, lp, c_in = xw.shape
    wh, ww = int(window[0]), int(window[1])
    nwh, nww = int(window_grid[0]), int(window_grid[1])
    heads, l, dev = int(scale.shape[0]), wh * ww, xw.device
    c = w.shape[-1] // 3
    if nwh * nww != nw or lp != _round_up(l, 8) or c not in (heads * hd, heads * wa.HD_PAD):
        raise ValueError(f"{name}: xw {tuple(xw.shape)} is not [B, {nwh} * {nww}, "
                         f"{_round_up(l, 8)}, C_in], or {c} columns a role for {heads} heads "
                         f"of {hd}")
    _build.check_operand(name, "xw", xw, torch.bfloat16, (bsz, nw, lp, c_in), dev)
    _build.check_operand(name, "w", w, torch.bfloat16, (c_in, 3 * c), dev)
    _build.check_operand(name, "b", b, torch.float32, (3 * c,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (bsz, nw, lp, c), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if c_in % 32:
        raise ValueError(f"{name}: needs C_in % 32 == 0, got {c_in}")
    variant = wa.qkv_variant(name, hd, l, g is not None)
    if c != heads * hd and hd > wa.HD_PAD:
        raise ValueError(f"{name}: the padded-head v4 takes no head dim {hd} (head dims up to "
                         f"{wa.HD_PAD})")
    return bsz, nwh, nww, lp, c_in, c, variant


def _launch_v4_forward(fn, xw, w, b, scale, hd, window, window_grid, mask_pattern,
                       boundary_flag):
    name = fn.__name__
    bsz, nwh, nww, lp, c_in, c, _ = _check_v4(name, xw, w, b, scale, hd, window, window_grid,
                                               mask_pattern)
    heads, t = int(scale.shape[0]), bsz * nwh * nww * lp
    out = torch.empty((bsz, nwh * nww, lp, c), dtype=torch.bfloat16, device=xw.device)
    # the projection's scratch, dropped on return
    qkv = torch.empty((t, 3 * c), dtype=torch.bfloat16, device=xw.device)
    lib = _build.load_library()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        code = lib.swin_window_attention_qkv4_fwd(
            xw.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
            qkv.data_ptr(), out.data_ptr(), bsz, nwh, nww, lp, c_in, c, heads, hd,
            int(window[0]), int(window[1]), stream)
    _build.check(code, name)
    fn.launches += 1
    gemm_core.count_launches(1)  # the projection on the GEMM core
    return out


def _launch_v4_backward(fn, xw, w, b, scale, hd, gw, window, window_grid, mask_pattern,
                        boundary_flag):
    name = fn.__name__
    bsz, nwh, nww, lp, c_in, c, variant = _check_v4(name, xw, w, b, scale, hd, window,
                                                    window_grid, mask_pattern, gw)
    if variant == "streamed":
        out = wa.qkv_streamed_bwd(xw, w, w, b, scale, None, gw, window, mask_pattern,
                                  boundary_flag, hd=hd, nwh=nwh, nww=nww, lm=lp, var="v4")
        fn.launches += 1
        gemm_core.count_launches(3)  # the projection, dx and dW on the GEMM core
        return out
    dev, t, heads = xw.device, bsz * nwh * nww * lp, int(scale.shape[0])
    # token ranges of the split-K dW product and of the db column sums (K2's)
    dw_splits = gemm_core.split_k(c_in, 3 * c, t)
    db_splits = max(1, min(64, -(-t // 512)))
    f32 = dict(dtype=torch.float32, device=dev)
    # the recomputed projection (the GEMM core's: its raw q, k rows give v4's
    # fp32 qn) and its cotangent
    qkv = torch.empty((t, 3 * c), dtype=torch.bfloat16, device=dev)
    dqkv = torch.empty((t, 3 * c), dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((dw_splits, c_in, 3 * c), **f32)
    db_part = torch.empty((db_splits, 3 * c), **f32)
    dscale_part = torch.empty((bsz * nwh * nww, heads), **f32)  # one d(scale) partial a window
    dxw = torch.empty_like(xw)
    dw, db, dscale = (torch.empty((c_in, 3 * c), **f32), torch.empty((3 * c,), **f32),
                      torch.empty((heads,), **f32))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (xw.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
                gw.data_ptr())
        work = (dqkv.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), dscale_part.data_ptr(),
                dxw.data_ptr(), dw.data_ptr(), db.data_ptr(), dscale.data_ptr(), bsz, nwh, nww,
                lp, c_in, c, heads)
        code = lib.swin_window_attention_qkv4_bwd(*head, qkv.data_ptr(), *work, hd,
                                                  int(window[0]), int(window[1]), dw_splits,
                                                  db_splits, stream)
    _build.check(code, name)
    fn.launches += 1
    gemm_core.count_launches(3)  # the projection, dx and dW on the GEMM core
    return dxw, dw, db, dscale


def window_attention_qkv4(xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern=None,
                          boundary_flag=1.0):
    """K12 v4's forward kernel: xw [B, nW, Lp, C_in] bf16 window-major (zero
    pad rows), w_qkv [C_in, 3C] bf16, b_qkv [3C] fp32, scale [heads] fp32,
    mask_pattern [L, L] fp32 or None -> [B, nW, Lp, C] bf16 (every row).
    Launches on the current stream."""
    hd = w_qkv.shape[-1] // 3 // int(scale.shape[0])
    return _launch_v4_forward(window_attention_qkv4, xw, w_qkv, b_qkv, scale, hd, window,
                              window_grid, mask_pattern, boundary_flag)


window_attention_qkv4.launches = 0


@torch.library.custom_op("swin::window_attention_qkv4", mutates_args=())
def window_attention_qkv4_op(xw: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                             scale: torch.Tensor, window: List[int], window_grid: List[int],
                             mask_pattern: Optional[torch.Tensor],
                             boundary_flag: float) -> torch.Tensor:
    """v4's forward launch (:func:`window_attention_qkv4`) as the custom op
    ``swin::window_attention_qkv4``."""
    return window_attention_qkv4(xw, w_qkv, b_qkv, scale, tuple(window), tuple(window_grid),
                                 mask_pattern, boundary_flag)


@window_attention_qkv4_op.register_fake
def _window_attention_qkv4_fake(xw, w_qkv, b_qkv, scale, window, window_grid, mask_pattern,
                                boundary_flag):
    return xw.new_empty((*xw.shape[:-1], w_qkv.shape[-1] // 3), dtype=torch.bfloat16)


def window_attention_qkv4_bwd(xw, w_qkv, b_qkv, scale, gw, window, window_grid,
                              mask_pattern=None, boundary_flag=1.0):
    """K12 v4's backward kernels: the forward's operands and gw [B, nW, Lp, C]
    bf16 (zero pad rows) -> (dxw [B, nW, Lp, C_in] bf16, dW, db, dscale fp32),
    summed in a fixed order."""
    hd = w_qkv.shape[-1] // 3 // int(scale.shape[0])
    return _launch_v4_backward(window_attention_qkv4_bwd, xw, w_qkv, b_qkv, scale, hd, gw,
                               window, window_grid, mask_pattern, boundary_flag)


window_attention_qkv4_bwd.launches = 0


def window_attention_qkv4_padded(xw, wp, bp, scale, hd, window, window_grid, mask_pattern=None,
                                 boundary_flag=1.0):
    """The padded-head v4 forward kernel: xw as v4's, wp [C_in, 3 * heads *
    128] bf16 and bp [3 * heads * 128] fp32 head-padded, the live head dim
    ``hd`` (32/64/96) -> [B, nW, Lp, heads * 128] bf16, pad lanes zero."""
    return _launch_v4_forward(window_attention_qkv4_padded, xw, wp, bp, scale, hd, window,
                              window_grid, mask_pattern, boundary_flag)


window_attention_qkv4_padded.launches = 0


@torch.library.custom_op("swin::window_attention_qkv4_padded", mutates_args=())
def window_attention_qkv4_padded_op(xw: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                                    scale: torch.Tensor, hd: int, window: List[int],
                                    window_grid: List[int], mask_pattern: Optional[torch.Tensor],
                                    boundary_flag: float) -> torch.Tensor:
    """The padded-head v4 forward launch (:func:`window_attention_qkv4_padded`)
    as the custom op ``swin::window_attention_qkv4_padded``."""
    return window_attention_qkv4_padded(xw, wp, bp, scale, hd, tuple(window),
                                        tuple(window_grid), mask_pattern, boundary_flag)


@window_attention_qkv4_padded_op.register_fake
def _window_attention_qkv4_padded_fake(xw, wp, bp, scale, hd, window, window_grid,
                                       mask_pattern, boundary_flag):
    return xw.new_empty((*xw.shape[:-1], wp.shape[-1] // 3), dtype=torch.bfloat16)


def window_attention_qkv4_padded_bwd(xw, wp, bp, scale, hd, gw, window, window_grid,
                                     mask_pattern=None, boundary_flag=1.0):
    """The padded-head v4 backward kernels: gw [B, nW, Lp, heads * 128] bf16
    (its pad lanes not read) -> (dxw, dWp, dbp with exact-zero pad columns,
    dscale)."""
    return _launch_v4_backward(window_attention_qkv4_padded_bwd, xw, wp, bp, scale, hd, gw,
                               window, window_grid, mask_pattern, boundary_flag)


window_attention_qkv4_padded_bwd.launches = 0


def qkv4_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, pad_heads: bool,
                 served: bool = False):
    """v4's forward on the NHWC grid: the window-major rearrangement, the
    kernel (its plain version on CPU tensors; through its custom op with
    ``served``, the serving forward) and the inverse rearrangement."""
    heads = int(scale.shape[0])
    hd = w_qkv.shape[-1] // 3 // heads
    grid = (x.shape[1] // int(window[0]), x.shape[2] // int(window[1]))
    xw = window_major(x, window)
    w16, b32 = w_qkv.to(torch.bfloat16), b_qkv.float()
    if pad_heads:
        w16, b32 = wa.pad_heads_w(w16, heads), wa.pad_heads_vec(b32, heads)
    if x.device.type == "cpu":
        if pad_heads:
            ow = window_attention_qkv4_padded_reference(xw, w16, b32, scale, hd, window, grid,
                                                        mask_pattern, boundary_flag)
        else:
            ow = window_attention_qkv4_reference(xw, w16, b32, scale, window, grid,
                                                 mask_pattern, boundary_flag)
    elif served:
        tail = (list(window), list(grid), mask_pattern, wa._flag(boundary_flag))
        args = (xw, w16.contiguous(), b32.contiguous(), scale.float().contiguous())
        ow = (window_attention_qkv4_padded_op(*args, hd, *tail) if pad_heads
              else window_attention_qkv4_op(*args, *tail))
    else:
        tail = (window, grid, mask_pattern, wa._flag(boundary_flag))
        args = (xw, w16.contiguous(), b32.contiguous(), scale.float().contiguous())
        ow = (window_attention_qkv4_padded(*args, hd, *tail) if pad_heads
              else window_attention_qkv4(*args, *tail))
    if pad_heads:
        ow = wa.unpad_heads(ow, heads, hd)
    return window_major_inverse(ow, window, tuple(x.shape[1:3]))


class WindowAttentionQKV4(torch.autograd.Function):
    """v4 forward and backward on the NHWC grid (kernels on CUDA tensors,
    plain versions on CPU tensors): the window-major rearrangement and its
    inverse in plain ops around them, as ``_build_qkv4``'s ``fused`` and
    ``f_bwd`` do. Saves (x, w_qkv, b_qkv, scale); ``pad_heads`` takes the
    padded-head instance (the weights padded in both passes, dW and db
    unpadded before they leave)."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, pad_heads):
        ctx.save_for_backward(x, w_qkv, b_qkv, scale)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        ctx.pad_heads = bool(pad_heads)
        return qkv4_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag,
                            ctx.pad_heads)

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale = ctx.saved_tensors
        heads = int(scale.shape[0])
        hd = w_qkv.shape[-1] // 3 // heads
        window = ctx.window
        grid = (x.shape[1] // int(window[0]), x.shape[2] // int(window[1]))
        xw, gw = window_major(x, window), window_major(g, window)
        w16, b32 = w_qkv.to(torch.bfloat16), b_qkv.float()
        if ctx.pad_heads:
            w16, b32 = wa.pad_heads_w(w16, heads), wa.pad_heads_vec(b32, heads)
            gw = wa.pad_heads_x(gw, heads, hd)
        tail = (window, grid, ctx.mask_pattern)
        if x.device.type == "cpu":
            if ctx.pad_heads:
                dxw, dw, db, dscale = window_attention_qkv4_padded_backward_reference(
                    xw, w16, b32, scale, hd, gw, *tail, ctx.boundary_flag)
            else:
                dxw, dw, db, dscale = window_attention_qkv4_backward_reference(
                    xw, w16, b32, scale, gw, *tail, ctx.boundary_flag)
        else:
            args = (xw, w16.contiguous(), b32.contiguous(), scale.float().contiguous())
            gw = gw.to(torch.bfloat16).contiguous()
            if ctx.pad_heads:
                dxw, dw, db, dscale = window_attention_qkv4_padded_bwd(
                    *args, hd, gw, *tail, wa._flag(ctx.boundary_flag))
            else:
                dxw, dw, db, dscale = window_attention_qkv4_bwd(
                    *args, gw, *tail, wa._flag(ctx.boundary_flag))
        if ctx.pad_heads:
            dw = wa.unpad_heads(dw, 3 * heads, hd).reshape(w_qkv.shape)
            db = wa.unpad_heads(db, 3 * heads, hd).reshape(b_qkv.shape)
        dx = window_major_inverse(dxw, window, tuple(x.shape[1:3]))
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype), None, None,
                None, None)
