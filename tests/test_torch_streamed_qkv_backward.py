"""PyTorch port, the qkv-fused family's streamed backward (form FORM_QKV of
``csrc/streamed_bwd.cuh``, after the recompute of
``csrc/window_attention_qkv_large.cu``) in its order of fp32 sums, on the
CPU.

On the card K2's backward (K7's with the folded CPB bias, K10's and the
padded v4's at head pitch 128, v5's and v4's) runs there wherever the
one-block kernel does not: head dims 128 and 256, and every head dim past
L = 256. The recompute rounds qkv = bf16(x W + b) and
normalizes q and k per head in the projection's epilogue (the forward's
``quad_unit`` order; the pad columns of a head pitch of 128 are exact zeros
and add nothing), keeping inv = 1 / |q|. The rows kernel takes the keys in
steps of 32, each warp of a pair 16 of them (two 8-key tiles, each lane two
adjacent keys of a tile): the max-free softmax's sum of e = exp(z) (adds)
and u = sum(dp e) (multiply-adds), each per lane in key order, then the
quad (xor 1, then 2), then warp 0's plus warp 1's; r = 1 / sum e; ds = (dp -
u r) e (r scale) (the subtraction contracted to one multiply-add), dsb =
bf16(ds), d(bias) = ds (1 / scale); dqn = dsb @ kn16 by 16-key products in
key order; qd = <qn, dqn> per lane over its columns (hd / 2 a warp, two
adjacent columns of each 8-column tile), the quad, the pair; dq = (dqn - qn
qd) inv_q with qn = qn16, or v4's fp32 q inv_q from the raw row. Up to
L = 192 (head dim 256 only) z and dp stay in registers from the first sweep;
elsewhere the rows kernel recomputes them in a second sweep, and since each
statistic is exact over the lane's keys before the merges, both paths sum
in this one order. The d(scale) partial of a block of 64 rows sums qd over
its attending rows (v4: its lm rows), as K8's does. The columns kernel forms
dv = p16^T @ g16 (p16 = bf16(e r)) and dkn = dsb^T @ qn16 by 16-query
products in query order, and dk likewise. The projection backward forms
dx, dW and db from the bf16 dqkv (its pad lanes exact zeros).
``streamed_qkv_backward`` repeats that order in plain fp32 ops
(multiply-adds in fp64, rounded once, where the kernels contract them to
fma) and is held to JAX's interpret-mode ``_qkv_backward`` (bias-free and
with the folded CPB bias), ``_qkv5_backward``, ``_qkv4_backward`` (the
fp32 qn, pad query rows attending) and ``_qkv6_backward`` (head pitch 128),
and to the port's plain versions: at head dim 96, L = 162 (window 9 x 18,
the kept path's statistics order) and head dim 32, L = 288 (window 12 x 24,
the recompute sweeps; v4 at window 17 x 17, L = 289, lm = 296), 2 x 2
windows of 2 heads, shifted.

Tolerance: the flagship backward's (``assert_close_backward`` of
tests/test_torch_kernels.py: dx 2 bf16 ulps max, 0.05 mean; dW, db, dbias
4 / 0.05; dscale 2 / 0.25 of each output's scale), the bar every qkv-fused
backward is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_tpu.ops.attic import window_attention_v45 as jax_v45
from swin_v2_weather_torch.ops import window_attention as wa
from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

from test_torch_kernels import assert_close_backward
from test_torch_streamed_grid_backward import dscale_rows
from test_torch_streamed_v1_backward import fma, lane_fma_sums, row_dot

torch.set_num_threads(1)

HEADS = 2
GRID = (2, 2)  # window rows, windows a row
C_IN = 64
# (head dim, L) -> window: the flagship's window (the kept path's order) and
# one past L = 256
CASES = {(96, 162): (9, 18), (32, 288): (12, 24)}
V4_WINDOW = (17, 17)  # L = 289, lm = 296: pad query rows that attend


def to_windows(t, window, heads, hp, lm=None):
    """Token rows [B, H, W, heads * hp] (grid), or window-major [B, nW, lm,
    heads * hp] when ``lm`` is given -> [Bw, heads, rows, hp]."""
    if lm is None:
        return wa._grid_to_windows(t, window, heads)
    return t.reshape(-1, lm, heads, hp).permute(0, 2, 1, 3)


def from_windows(t, window, hw, lm=None):
    """The inverse of :func:`to_windows` (``hw`` the grid, or (B, nW))."""
    if lm is None:
        return wa._windows_to_grid(t, window, hw)
    bw, heads, _, hp = t.shape
    return t.permute(0, 2, 1, 3).reshape(*hw, lm, heads * hp)


def streamed_qkv_backward(x, w, b, scale, g, window, patt, hd, badd=None, lm=None):
    """The streamed backward at its rounding sites and order of fp32 sums:
    bf16-valued x [B, H, W, C_in] (v4: window-major [B, nW, lm, C_in], pad
    rows zero), w [C_in, 3 heads hp], b, g in x's layout [.., heads hp]
    (fp32), head pitch hp = w's columns / 3 / heads (hd, or 128 padded) ->
    (dx, dW, db, dscale, and with ``badd`` dbias [heads, L, L]); v4 (``lm``)
    takes the fp32 qn and kn from the raw rows."""
    bf = torch.bfloat16
    heads = scale.shape[0]
    hp = w.shape[-1] // 3 // heads
    wh, ww = window
    l = wh * ww
    c = heads * hp
    lq = l if lm is None else lm  # query rows that attend (and are written)
    x2 = x.reshape(-1, x.shape[-1])
    qkv = (torch.matmul(x2, w) + b).to(bf).float().reshape(*x.shape[:-1], 3 * c)
    q, k, v = (to_windows(qkv[..., i * c:(i + 1) * c], window, heads, hp, lm) for i in range(3))
    gw = to_windows(g, window, heads, hp, lm)[..., :hd]
    qn16, inv_q = wa.quad_unit(q)
    kn16, inv_k = wa.quad_unit(k)
    q, k, v, qn16, kn16 = (t[..., :hd] for t in (q, k, v, qn16, kn16))
    if lm is None:
        qn, kn = qn16, kn16
    else:  # v4: the fp32 q inv_q and k inv_k from the raw rows
        qn, kn = q * inv_q, k * inv_k
    # z of every query row that attends against the L keys; the mask on the
    # last window row, rows < L
    s = torch.matmul(qn16, kn16[..., :l, :].transpose(-1, -2))  # [Bw, heads, lq, L]
    sc = scale.reshape(1, heads, 1, 1)
    z = (s - 1.0) * sc if badd is None else s * sc
    if badd is not None:
        z[..., :l, :] = z[..., :l, :] + badd.reshape(1, heads, l, l)
    if patt is not None:
        nwh = GRID[0]
        zv = z.reshape(-1, nwh, GRID[1], heads, lq, l)
        zv[:, -1, :, :, :l, :] = zv[:, -1, :, :, :l, :] + torch.from_numpy(patt)
        z = zv.reshape(z.shape)
    e = torch.exp(z)
    r = 1.0 / wa.lane_sums(e)[..., None]
    dp = torch.matmul(gw[..., :lq, :], v[..., :l, :].transpose(-1, -2))
    u = lane_fma_sums(dp, e)[..., None]
    ds = fma(-u.expand_as(dp), r.expand_as(dp), dp) * e * (r * sc)
    dsb = ds.to(bf)
    dqn = wa.chunked_pv(dsb, kn16[..., :l, :])
    dkn = wa.chunked_pv(dsb.transpose(-1, -2), qn16[..., :lq, :])
    dv = wa.chunked_pv((e * r).to(bf).transpose(-1, -2), gw[..., :lq, :])

    def vjp(xn, dxn, inv):
        xd = row_dot(xn, dxn)
        return (fma(-xn, xd.expand_as(xn), dxn) * inv).to(bf).float(), xd

    dq, qd = vjp(qn[..., :lq, :], dqn, inv_q[..., :lq, :])
    dk, _ = vjp(kn[..., :l, :], dkn, inv_k[..., :l, :])
    rows = q.shape[2]  # the window's rows in memory: L, or lm
    parts = []
    for t in (dq, dk, dv.to(bf).float()):  # pad rows and pad lanes exact zeros
        full = torch.zeros((*t.shape[:2], rows, hp))
        full[..., :t.shape[2], :hd] = t
        parts.append(full)
    hw = tuple(x.shape[1:3]) if lm is None else tuple(x.shape[:2])
    dqkv = torch.cat([from_windows(t, window, hw, lm) for t in parts], -1)
    d2 = dqkv.reshape(-1, 3 * c)
    dx = torch.matmul(d2, w.t()).to(bf).reshape(x.shape)
    dscale = dscale_rows(qd[..., 0], scale, hd)
    grads = (dx, torch.matmul(x2.t(), d2), torch.sum(d2, 0), dscale)
    if badd is None:
        return grads
    dbias = torch.zeros((heads, l, l))
    for win in range(ds.shape[0]):
        dbias = dbias + ds[win, :, :l, :] * (1.0 / sc[0])
    return (*grads, dbias)


def bf16(t):
    return np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)


def operands(hd, window, seed=17):
    """bf16-valued x [1, H, W, C_IN], W [C_IN, 3C] and g [1, H, W, C] on the
    grid of GRID windows, b, scale, a folded CPB term and the shifted block's
    mask, numpy."""
    rng = np.random.default_rng(seed)
    l = window[0] * window[1]
    h, w = GRID[0] * window[0], GRID[1] * window[1]
    c = HEADS * hd
    x = bf16(rng.standard_normal((1, h, w, C_IN)))
    wq = bf16(rng.standard_normal((C_IN, 3 * c)) / 8.0)
    b = (0.1 * rng.standard_normal(3 * c)).astype(np.float32)
    g = bf16(rng.standard_normal((1, h, w, c)))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    raw = torch.from_numpy((2.0 * rng.standard_normal((HEADS, l, l))).astype(np.float32))
    badd = wa.fold_cpb_bias(raw, torch.from_numpy(scale)).numpy()
    patt = make_shift_mask((h, w), window, (window[0] // 2, window[1] // 2))[-1]
    return x, wq, b, g, scale, badd, patt


def check(got, ref, plain):
    names = ("dx", "dW", "db", "dscale", "dbias")
    assert len(got) == len(ref) == len(plain)
    for name, a, r, p in zip(names, got, ref, plain):
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        assert_close_backward(name, a, np.asarray(r, np.float32))
        assert_close_backward(name, a, p.float().numpy())


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hd, l", list(CASES))
def test_streamed_qkv_order_matches_jax_and_plain(hd, l, use_bias):
    """K2 (K7 with the folded CPB bias) in the streamed order against JAX's
    ``_qkv_backward`` (interpret mode) and the port's plain version: dx, dW,
    db, dscale (and dbias)."""
    window = CASES[hd, l]
    x, wq, b, g, scale, badd, patt = operands(hd, window)
    t = [torch.from_numpy(a) for a in (x, wq, b, scale, g)]
    tb = torch.from_numpy(badd) if use_bias else None
    got = streamed_qkv_backward(t[0], t[1], t[2], t[3], t[4], window, patt, hd, badd=tb)
    ref = jax_wa._qkv_backward(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16),
                               jnp.asarray(b), jnp.asarray(scale), jnp.asarray(g, jnp.bfloat16),
                               patt, window, True,
                               bias=jnp.asarray(badd) if use_bias else None, prefolded=True)
    args = (t[0].bfloat16(), t[1].bfloat16(), t[2], t[3])
    plain = (wa.window_attention_qkv_bias_backward_reference(*args, tb, t[4].bfloat16(), window,
                                                             patt)
             if use_bias else
             wa.window_attention_qkv_backward_reference(*args, t[4].bfloat16(), window, patt))
    check(got, ref, plain)


@pytest.mark.parametrize("variant", ["v5", "v4", "v6"])
def test_streamed_qkv_variants_match_jax_and_plain(variant):
    """v5 (its own JAX backward; the port's plain version is v3's), v4 (the
    fp32 qn and kn, window-major rows with pad query rows that attend, their
    dx rows exactly zero) and K10 (head pitch 128: the pad lanes of dqkv
    exact zeros, so dW's and db's pad columns are) in the streamed order at
    head dim 32 past L = 256, against JAX's ``_qkv5_backward``,
    ``_qkv4_backward`` and ``_qkv6_backward`` (interpret mode) and the
    port's plain versions."""
    hd = 32
    window = V4_WINDOW if variant == "v4" else CASES[32, 288]
    l = window[0] * window[1]
    x, wq, b, g, scale, _, patt = operands(hd, window)
    jx, jw, jb, js = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16),
                      jnp.asarray(b), jnp.asarray(scale))
    t = [torch.from_numpy(a) for a in (x, wq, b, scale, g)]
    if variant == "v5":
        got = streamed_qkv_backward(t[0], t[1], t[2], t[3], t[4], window, patt, hd)
        w5 = v45.w5_reorder(t[1], HEADS)
        ref = jax_v45._qkv5_backward(jx, jw, jnp.asarray(w5.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(v45.b5_reorder(t[2], HEADS).numpy()), js,
                                     jnp.asarray(g, jnp.bfloat16), patt, window, True)
        plain = v45.window_attention_qkv5_backward_reference(
            t[0].bfloat16(), w5.bfloat16(), t[1].bfloat16(), t[2], t[3], t[4].bfloat16(), window,
            patt)
    elif variant == "v4":
        lm = -(-l // 8) * 8
        xw = v45.window_major(t[0], window)
        gw = v45.window_major(t[4], window)
        assert xw.shape[2] == lm == 296
        got = streamed_qkv_backward(xw, t[1], t[2], t[3], gw, window, patt, hd, lm=lm)
        ref = jax_v45._qkv4_backward(jnp.asarray(xw.numpy(), jnp.bfloat16), jw, jb, js,
                                     jnp.asarray(gw.numpy(), jnp.bfloat16), patt, GRID, l, True)
        plain = v45.window_attention_qkv4_backward_reference(
            xw.bfloat16(), t[1].bfloat16(), t[2], t[3], gw.bfloat16(), window, GRID, patt)
        assert torch.count_nonzero(got[0][:, :, l:]) == 0
    else:
        wp, bp = wa.pad_heads_w(t[1], HEADS), wa.pad_heads_vec(t[2], HEADS)
        gp = wa.pad_heads_x(t[4], HEADS, hd)
        got = streamed_qkv_backward(t[0], wp, bp, t[3], gp, window, patt, hd)
        ref = jax_wa._qkv6_backward(jx, jnp.asarray(wp.numpy(), jnp.bfloat16),
                                    jnp.asarray(bp.numpy()).reshape(1, -1), js,
                                    jnp.asarray(gp.numpy(), jnp.bfloat16), patt, window, True)
        plain = wa.window_attention_qkv_padded_backward_reference(
            t[0].bfloat16(), wp.bfloat16(), bp, t[3], hd, gp.bfloat16(), window, patt)
        for grad in got[1:3]:
            assert torch.count_nonzero(grad.reshape(-1, 3, HEADS, 128)[..., hd:]) == 0
    check(got, ref, plain)
