"""PyTorch port, K8's streamed backward (form FORM_GRID of
``csrc/streamed_bwd.cuh``) in its order of fp32 sums, on the CPU.

On the card K8's backward is two kernels of 8 warps on the NHWC grid's
pixels, qn and kn arriving normalized (the normalization VJP stays outside,
in ``normalize_vjp``). The rows kernel takes the keys in steps of 32, each
warp of a pair 16 of them (two 8-key tiles, each lane two adjacent keys of a
tile): the exact row max, then the sum of e = exp(z - m) (adds) and u =
sum(dp e) (multiply-adds), each per lane in key order, then across the quad
(shuffle xor 1, then 2), then warp 0's plus warp 1's; r = 1 / sum e; db =
(dp - u r) e r (the subtraction contracted to one multiply-add), dsb =
bf16(db scale); dqn = dsb @ kn16 by 16-key products in key order, left in
bf16. Up to L = 192 z and dp stay in registers from the first sweep (at head
dims up to 96 db replaces dp there as soon as the sums are known); longer
windows recompute z and dp in a sweep per statistic, and since each
statistic is exact over the lane's keys before the merges, both paths sum
in this one order. The d(scale) partial of a block of 64 rows: qd = <qn16,
dqn> per row (per lane over its columns, hd / 2 a warp, two adjacent
columns of each 8-column tile, multiply-adds in column order; the quad; the
pair), each lane of a quad's first lane in warp 0 adding its two rows, the
warp's butterfly (xor 16 .. 1), the block's warps in order; then the blocks
of each window and the windows in order, divided by the scale. The columns
kernel forms dv = p16^T @ g16 (p16 = bf16(e r)) and dkn = dsb^T @ qn16 by
16-query products in query order; d(bias) sums db over the windows in
order. ``streamed_grid_backward`` repeats that order in plain fp32 ops
(multiply-adds in fp64, rounded once, where the kernels contract them to
fma) and is held to the plain version (``_grid_backward_plain``) and to
JAX's ``_grid_backward`` (its Pallas kernel in interpret mode): at head dim
96 and L = 162 (window 9 x 18, shifted: the flagship's, on the kept path)
and at head dim 32 and L = 288 (window 12 x 24, shifted: the path past
L = 192), 2 x 2 windows of 2 heads, bias-free and with the raw CPB bias.

Tolerance: ``GRAD_ULPS`` of tests/test_torch_grid_attention.py (dq, dk, dv 2
bf16 ulps max and 0.02 mean of each output's scale; dscale 1 ulp; dbias 1
max, 0.05 mean), the bar every K8 backward is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_grid_attention import GRAD_ULPS
from test_torch_kernels import assert_close_ulps
from test_torch_streamed_v1_backward import butterfly, fma, lane_fma_sums, row_dot

torch.set_num_threads(1)

HEADS = 2
GRID = (2, 2)  # window rows, windows a row
# (head dim, L) -> window: the flagship's window on the kept path, and one
# past KEEP_L = 192
CASES = {(96, 162): (9, 18), (32, 288): (12, 24)}


def dscale_rows(qd, scale, hd):
    """sum(qd) / scale per head [heads] in the rows kernel's order: qd [Bw,
    heads, L] of each block of ``rt`` 16-row tiles (two warps a tile): lane
    4 g4 of warp 0 of tile wt adds its rows 16 wt + g4 and + 8 (0 past L),
    the warp's butterfly, the block's warps in order, then the blocks of each
    window and the windows in order, divided by the scale."""
    bw, heads, l = qd.shape
    plan = wa.streamed_bwd_plan(hd, l, grid=True)
    rt, nchunk = plan["rt"], plan["nchunk"]
    t = torch.zeros((bw, heads, nchunk * rt * 16))
    t[..., :l] = qd
    t = t.reshape(bw, heads, nchunk, rt, 2, 8)  # [.., chunk, wt, y, g4]
    part = (torch.zeros(()) + t[..., 0, :]) + t[..., 1, :]  # [.., chunk, wt, g4]
    lanes = torch.zeros((bw, heads, nchunk, rt, 32))
    lanes[..., 0::4] = part
    warp = butterfly(lanes, (16, 8, 4, 2, 1))  # warp 0 of each tile; warp 1 adds 0
    block = torch.zeros((bw, heads, nchunk))
    for wt in range(rt):
        block = block + warp[..., wt]
    total = torch.zeros(heads)
    for w in range(bw):
        for ch in range(nchunk):
            total = total + block[w, :, ch]
    return total / scale


def streamed_grid_backward(qn, kn, v, scale, bias, g, window, mask_pattern):
    """K8's backward at the streamed kernels' rounding sites and order of
    fp32 sums: bf16-valued qn, kn, v, g [B, H, W, C] (fp32) -> (dqn, dkn, dv
    [B, H, W, C] in bf16, dscale [heads], and with the bias dbias [heads, L,
    L])."""
    bf = torch.bfloat16
    heads, hd = scale.shape[0], qn.shape[-1] // scale.shape[0]
    grid = wa._window_grid(qn, window)
    qw, kw, vw, gw = (wa._grid_to_windows(t, window, heads) for t in (qn, kn, v, g))
    s = torch.matmul(qw, kw.transpose(-1, -2))
    z = wa._logits(s, scale, bias, mask_pattern, 1.0, grid)
    e = torch.exp(z - torch.amax(z, -1, keepdim=True))
    r = 1.0 / wa.lane_sums(e)[..., None]
    dp = torch.matmul(gw, vw.transpose(-1, -2))
    u = lane_fma_sums(dp, e)[..., None]
    db = fma(-u.expand_as(dp), r.expand_as(dp), dp) * e * r  # (dp - u r) e r
    dsb = (db * scale.reshape(1, heads, 1, 1)).to(bf)
    dqn = wa.chunked_pv(dsb, kw)
    dkn = wa.chunked_pv(dsb.transpose(-1, -2), qw)
    dv = wa.chunked_pv((e * r).to(bf).transpose(-1, -2), gw)
    dscale = dscale_rows(row_dot(qw, dqn)[..., 0], scale, hd)
    hw = tuple(qn.shape[1:3])
    grads = tuple(wa._windows_to_grid(t.to(bf), window, hw) for t in (dqn, dkn, dv)) + (dscale,)
    if bias is None:
        return grads
    dbias = torch.zeros(db.shape[1:])
    for w in range(db.shape[0]):
        dbias = dbias + db[w]
    return (*grads, dbias)


def operands(hd, window, seed=13):
    """bf16-valued qn, kn (unit rows per head), v and g on the grid of GRID
    windows, scale, a raw bias and the shifted block's mask."""
    rng = np.random.default_rng(seed)
    l = window[0] * window[1]
    h, w = GRID[0] * window[0], GRID[1] * window[1]
    shape = (1, h, w, HEADS * hd)

    def bf16(t):
        return np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)

    def unit(t):
        t = t.reshape(*shape[:3], HEADS, hd)
        return (t / np.linalg.norm(t, axis=-1, keepdims=True)).reshape(shape)

    qn, kn = (bf16(unit(rng.standard_normal(shape))) for _ in range(2))
    v, g = (bf16(rng.standard_normal(shape)) for _ in range(2))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, l, l)) * 2.0).astype(np.float32)
    patt = make_shift_mask((h, w), window, (window[0] // 2, window[1] // 2))[-1]
    return qn, kn, v, g, scale, bias, patt


def test_dscale_rows_is_a_sum():
    """The emulated d(scale) order against a plain sum: within a few fp32
    ulps, at both windows' plans (one and several blocks a window)."""
    rng = np.random.default_rng(5)
    for l in (162, 288):
        qd = torch.from_numpy(rng.standard_normal((4, HEADS, l)).astype(np.float32))
        scale = torch.tensor([2.0, 4.0])
        torch.testing.assert_close(dscale_rows(qd, scale, 32), torch.sum(qd, (0, 2)) / scale,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hd, l", list(CASES))
def test_streamed_grid_order_matches_jax_and_plain(hd, l, use_bias):
    """The streamed order of sums against JAX's ``_grid_backward``
    (interpret mode) and the port's plain version: dqn, dkn, dv, dscale (and
    dbias), within ``GRAD_ULPS``."""
    window = CASES[hd, l]
    qn, kn, v, g, scale, bias, patt = operands(hd, window)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (qn, kn, v, g))
    tscale = torch.from_numpy(scale)
    tbias = torch.from_numpy(bias) if use_bias else None
    got = streamed_grid_backward(tq, tk, tv, tscale, tbias, tg, window, patt)
    jbias = jnp.asarray(bias) if use_bias else None
    ref = jax_wa._grid_backward(*(jnp.asarray(t, jnp.bfloat16) for t in (qn, kn, v)),
                                jnp.asarray(scale), jnp.asarray(g, jnp.bfloat16), jbias, patt,
                                window, True)
    plain = wa._grid_backward_plain(*(t.bfloat16() for t in (tq, tk, tv)), tscale, tbias,
                                    tg.bfloat16(), window, patt, 1.0)
    assert len(got) == len(ref) == len(plain) == 4 + use_bias
    for name, a, r, p in zip(("dq", "dk", "dv", "dscale", "dbias"), got, ref, plain):
        assert torch.isfinite(a.float()).all(), name
        a = a.float().numpy()
        assert_close_ulps(a, np.asarray(r, np.float32), *GRAD_ULPS[name])
        assert_close_ulps(a, p.float().numpy(), *GRAD_ULPS[name])
