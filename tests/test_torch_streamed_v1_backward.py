"""PyTorch port, K9's streamed backward (form FORM_V1 of
``csrc/streamed_bwd.cuh``) in its order of fp32 sums, on the CPU.

On the card K9's backward is a prepass that writes qn16, kn16 and the norms
(one warp a row: each lane sums q^2 over its columns lane + 32 i, then the
warp's butterfly), then two kernels of 8 warps. The rows kernel takes the
keys in steps of 32, each warp of a pair 16 of them (two 8-key tiles, each
lane two adjacent keys of a tile): the exact row max, the sum of e = exp(z -
m) and u = sum(dp p) with p = e / sum e (fp32), each per lane in key order,
then across the quad (shuffle xor 1, then 2), then warp 0's plus warp 1's;
dqn = dsb @ kn16 by 16-key products in key order; qd = <qn, dqn> per lane
over its columns (hd / 2 a warp, two adjacent columns of each 8-column
tile), the quad, the pair, with the fp32 qn = q inv from the raw row. The
columns kernel forms dv and dkn by 16-query products in query order and
takes d(scale) = sum(ds s): per lane over its (query, key) entries in step
order, the warp's butterfly (xor 16 .. 1), the block's warps in order, then
the blocks (64 keys each) of each window, the windows in order; d(bias) is
summed over the windows in order. ``streamed_v1_backward`` below repeats
that order in plain fp32 ops (multiply-adds in fp64, rounded once, where
the kernel contracts them to fma), so the CPU can show the order moves no
rounding site beyond the tolerance: at L = 162 (window 9 x 18, shifted),
head dims 96 and 256, and at L = 288 (window 12 x 24, shifted), head dim
32, 2 x 2 windows of 2 heads, bias-free and with the raw CPB bias, it is
held to the plain version (``_v1_backward_plain``) and to JAX's
``_v1_backward`` (its Pallas kernel in interpret mode). Past L = 192 the
rows kernel recomputes z and dp in a sweep per statistic (four sweeps);
each statistic is exact over the lane's keys before the merges, so its
order of sums is the kept path's and one emulation serves both.

Tolerance: ``GRAD_ULPS`` of tests/test_torch_grid_attention.py (dq, dk, dv 2
bf16 ulps max and 0.02 mean of each output's scale; dscale 1 ulp; dbias 1
max, 0.05 mean), the bar every K9 backward is held to.
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

torch.set_num_threads(1)

HEADS = 2
WINDOW = (9, 18)
GRID = (2, 2)
L = WINDOW[0] * WINDOW[1]
BW = GRID[0] * GRID[1]


def fma(a, b, c):
    """a * b + c rounded once to fp32 (fp32 operands)."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(x, offsets):
    """The shuffle-xor reduction of x [..., n] over its last dim: lane l adds
    lane l ^ o for each o in turn; lane 0's value."""
    n = x.shape[-1]
    for o in offsets:
        x = x + x[..., [i ^ o for i in range(n)]]
    return x[..., 0]


def lane_fma_sums(a, b):
    """The rows kernel's sum over the keys of a * b [..., L, Lk] in its order:
    each lane's multiply-adds over its keys in key order (a step of 32 keys,
    16 a warp of the pair in two 8-key tiles, two adjacent keys a lane), then
    the quad (xor 1, then 2), then warp 0's plus warp 1's."""
    lk = a.shape[-1]
    nstep = -(-lk // 32)

    def view(t):
        tp = torch.zeros((*t.shape[:-1], nstep * 32), dtype=torch.float32)
        tp[..., :lk] = t
        return tp.reshape(*t.shape[:-1], nstep, 2, 2, 4, 2)  # [.., step, warp, tile, lane, key]

    av, bv = view(a), view(b)
    acc = torch.zeros((*a.shape[:-1], 2, 4))
    for st in range(nstep):
        for n in range(2):
            for x in range(2):
                acc = fma(av[..., st, :, n, :, x], bv[..., st, :, n, :, x], acc)
    acc = acc + acc[..., [c ^ 1 for c in range(4)]]
    acc = acc + acc[..., [c ^ 2 for c in range(4)]]
    return acc[..., 0, 0] + acc[..., 1, 0]


def prepass(t):
    """The prepass's inv = 1 / sqrt(max(sum t^2, 1e-24)) of each row of the
    bf16-valued t [..., hd] (lane l sums columns l + 32 i, then the warp's
    butterfly) -> (fp32 qn = t inv, inv [..., 1])."""
    hd = t.shape[-1]
    nv = -(-hd // 32)
    tp = torch.zeros((*t.shape[:-1], nv * 32))
    tp[..., :hd] = t
    tp = tp.reshape(*t.shape[:-1], nv, 32)
    ss = torch.zeros((*t.shape[:-1], 32))
    for i in range(nv):
        ss = fma(tp[..., i, :], tp[..., i, :], ss)
    ss = butterfly(ss, (16, 8, 4, 2, 1))[..., None]
    inv = 1.0 / torch.sqrt(torch.clamp_min(ss, 1e-24))
    return t * inv, inv


def row_dot(x, y):
    """qd = <x, y> over the head dim in the rows kernel's order: each warp of
    the pair its half, each lane of a quad two adjacent columns of every
    8-column tile (multiply-adds in column order), the quad (xor 1, then 2),
    then warp 0's plus warp 1's -> [..., 1]."""
    hd = x.shape[-1]
    xv = x.reshape(*x.shape[:-1], 2, hd // 16, 4, 2)  # [.., warp, tile, lane, column]
    yv = y.reshape(*y.shape[:-1], 2, hd // 16, 4, 2)
    acc = torch.zeros((*x.shape[:-1], 2, 4))
    for j in range(hd // 16):
        for c in range(2):
            acc = fma(xv[..., j, :, c], yv[..., j, :, c], acc)
    acc = acc + acc[..., [c ^ 1 for c in range(4)]]
    acc = acc + acc[..., [c ^ 2 for c in range(4)]]
    return (acc[..., 0, 0] + acc[..., 1, 0])[..., None]


def dscale_columns(ds, s):
    """sum(ds s) per head [heads] in the columns kernel's order: blocks of
    ``rt`` 16-key tiles (two warps a tile), each lane's multiply-adds over
    its entries (query steps of 32, 16 a warp in two 8-query tiles, two
    adjacent queries and two keys g4, g4 + 8 a lane) in step order, the warp's
    butterfly, the block's warps in order, then the blocks of each window and
    the windows in order."""
    bw, heads, l, _ = ds.shape
    plan = wa.streamed_bwd_plan(96, l, v1=True)  # rt and nchunk do not depend on hd
    rt, nchunk = plan["rt"], plan["nchunk"]
    nk, nq = nchunk * rt * 16, -(-l // 32) * 32
    t = torch.zeros((bw, heads, nq, nk, 2))
    t[:, :, :l, :l, 0], t[:, :, :l, :l, 1] = ds, s
    # query = 32 i + 16 hf + 8 n + 2 cq + c; key = 16 (rt chunk + wt) + 8 y + g4
    t = t.reshape(bw, heads, nq // 32, 2, 2, 4, 2, nchunk, rt, 2, 8, 2)
    acc = torch.zeros((bw, heads, nchunk, rt, 2, 8, 4))  # [.., chunk, wt, hf, g4, cq]
    for i in range(nq // 32):
        for n in range(2):
            for c in range(2):
                for y in range(2):
                    e = t[:, :, i, :, n, :, c, :, :, y, :, :]  # [.., hf, cq, chunk, wt, g4, 2]
                    e = e.permute(0, 1, 4, 5, 2, 6, 3, 7)  # [.., chunk, wt, hf, g4, cq, 2]
                    acc = fma(e[..., 0], e[..., 1], acc)
    lane = butterfly(acc.reshape(bw, heads, nchunk, rt, 2, 32), (16, 8, 4, 2, 1))
    block = torch.zeros((bw, heads, nchunk))
    for wt in range(rt):
        for hf in range(2):
            block = block + lane[..., wt, hf]
    total = torch.zeros(heads)
    for w in range(bw):
        for ch in range(nchunk):
            total = total + block[w, :, ch]
    return total


def streamed_v1_backward(q, k, v, scale, bias, g, window_grid, mask_pattern):
    """K9's backward at the streamed kernels' rounding sites and order of
    fp32 sums: bf16-valued q, k, v, g [Bw, heads, L, hd] (fp32) -> (dq, dk,
    dv in bf16, dscale [heads], and with the bias dbias [heads, L, L])."""
    bf = torch.bfloat16
    heads = q.shape[1]
    qn, inv_q = prepass(q)
    kn, inv_k = prepass(k)
    qn16, kn16 = qn.to(bf).float(), kn.to(bf).float()
    s = torch.matmul(qn16, kn16.transpose(-1, -2))
    z = wa._logits(s, scale, bias, mask_pattern, 1.0, window_grid)
    m = torch.amax(z, -1, keepdim=True)
    e = torch.exp(z - m)
    p = e / wa.lane_sums(e)[..., None]
    dp = torch.matmul(g, v.transpose(-1, -2))
    u = lane_fma_sums(dp, p)[..., None]
    ds = p * (dp - u)
    dsb = (ds * scale.reshape(1, heads, 1, 1)).to(bf)
    dqn = wa.chunked_pv(dsb, kn16)
    dkn = wa.chunked_pv(dsb.transpose(-1, -2), qn16)
    dv = wa.chunked_pv(p.to(bf).transpose(-1, -2), g)

    def vjp(xn, dxn, inv):
        xd = row_dot(xn, dxn)
        return ((dxn.double() - xn.double() * xd.double()).float() * inv).to(bf)

    grads = (vjp(qn, dqn, inv_q), vjp(kn, dkn, inv_k), dv.to(bf), dscale_columns(ds, s))
    if bias is None:
        return grads
    dbias = torch.zeros(ds.shape[1:])
    for w in range(ds.shape[0]):
        dbias = dbias + ds[w]
    return (*grads, dbias)


def operands(hd, seed=11, window=WINDOW):
    rng = np.random.default_rng(seed)
    l = window[0] * window[1]
    shape = (BW, HEADS, l, hd)
    q, k, v, g = (np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16), np.float32)
                  for _ in range(4))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, l, l)) * 2.0).astype(np.float32)
    patt = make_shift_mask((GRID[0] * window[0], GRID[1] * window[1]), window,
                           (window[0] // 2, window[1] // 2))[-1]
    return q, k, v, g, scale, bias, patt


def test_row_sums_follow_the_lanes():
    """The emulation's sums against plain ones: lane_fma_sums and row_dot
    within a few fp32 ulps of torch.sum, butterfly exact on integers."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal((3, L, L)).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(lane_fma_sums(a, b), torch.sum(a * b, -1), rtol=2e-6, atol=2e-5)
    x, y = (torch.from_numpy(rng.standard_normal((3, L, 96)).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(row_dot(x, y)[..., 0], torch.sum(x * y, -1), rtol=2e-6, atol=2e-5)
    assert butterfly(torch.arange(32.0), (16, 8, 4, 2, 1)).item() == 496.0


def check_against_jax_and_plain(hd, use_bias, window=WINDOW):
    """The streamed order of sums against JAX's ``_v1_backward`` (interpret
    mode) and the port's plain version: dq, dk, dv, dscale (and dbias),
    within ``GRAD_ULPS``."""
    q, k, v, g, scale, bias, patt = operands(hd, window=window)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    tscale = torch.from_numpy(scale)
    tbias = torch.from_numpy(bias) if use_bias else None
    got = streamed_v1_backward(tq, tk, tv, tscale, tbias, tg, GRID, patt)
    jbias = jnp.asarray(bias) if use_bias else None
    ref = jax_wa._v1_backward(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                              jnp.asarray(scale), jnp.asarray(g, jnp.bfloat16), jbias, patt,
                              GRID, interpret=True)
    plain = wa._v1_backward_plain(*(t.bfloat16() for t in (tq, tk, tv)), tscale, tbias,
                                  tg.bfloat16(), GRID, patt)
    assert len(got) == len(ref) == len(plain) == 4 + use_bias
    for name, a, r, p in zip(("dq", "dk", "dv", "dscale", "dbias"), got, ref, plain):
        assert torch.isfinite(a.float()).all(), name
        a = a.float().numpy()
        assert_close_ulps(a, np.asarray(r, np.float32), *GRAD_ULPS[name])
        assert_close_ulps(a, p.float().numpy(), *GRAD_ULPS[name])


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hd", [96, 256])
def test_streamed_order_matches_jax_and_plain(hd, use_bias):
    """At L = 162 (the kept path), head dims 96 and 256."""
    check_against_jax_and_plain(hd, use_bias)


@pytest.mark.parametrize("use_bias", [False, True])
def test_streamed_order_past_keep_matches_jax_and_plain(use_bias):
    """At L = 288 (window 12 x 24: the path past KEEP_L, four sweeps), head
    dim 32."""
    check_against_jax_and_plain(32, use_bias, window=(12, 24))
