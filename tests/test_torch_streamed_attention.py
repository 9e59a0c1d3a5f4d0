"""PyTorch port, the K8/K9 forward's softmax statistics order on the CPU.

The CUDA forward (``csrc/qkv_attention.cuh``) takes keys in steps of 32,
each warp of a pair taking 16 of them (NT = 2 8-key tiles) and each lane two
adjacent keys of each of its tiles. Two orders of the softmax statistics
follow:

* the z-in-registers path (L <= 192, every config of the repo): every warp
  keeps z of its keys, the row max is exact, and the sum of e = exp(z -
  max) is taken per lane in key order, then across the quad (shuffle xor 1,
  then 2) and then warp 0's plus warp 1's;
* the streamed path (longer windows): one sweep takes each lane's running
  max and a sum rescaled when that max moves, merged across the quad (xor
  1, then 2) and then the pair.

A second sweep rounds p16 from the final max and sum and forms out =
bf16(p16 v16). ``registers_stats`` and ``streamed_stats`` below repeat those
orders in plain fp32 ops (the kernel itself runs only on the card), so the
CPU can show that neither moves a rounding site beyond the tolerance: at
L = 162 (window 9 x 18), head dim 96, 2 x 2 windows, 2 heads, the raw CPB
bias and the shift mask, each is held to the plain version
(``window_attention_*_reference``, max-then-sum) and to the JAX package's
``fused_window_attention_grid`` / ``fused_window_attention`` (Pallas
kernels in interpret mode).

Tolerance: ``GRAD_ULPS["dv"]`` of tests/test_torch_grid_attention.py, 2 bf16
ulps max and 0.02 mean of the output's scale -- out, like dv, is a bf16
product of p16 with a bf16 operand, and a sum of e whose last fp32 bits
differ can flip a p16 rounding now and then, which moves an output entry by
well under an ulp.
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

B, H, W, HEADS, HD = 1, 18, 36, 2, 96
WINDOW = (9, 18)
GRID = (H // WINDOW[0], W // WINDOW[1])
L = WINDOW[0] * WINDOW[1]
C = HEADS * HD
NEG_INF = float("-inf")


def merge(m1, l1, m2, l2):
    """The kernel's ``merge_stat``: the max, and each sum rescaled to it (an
    empty part has m = -inf and l = 0)."""
    mm = torch.maximum(m1, m2)
    a = torch.where(m1 == NEG_INF, torch.zeros_like(l1), l1 * torch.exp(m1 - mm))
    b = torch.where(m2 == NEG_INF, torch.zeros_like(l2), l2 * torch.exp(m2 - mm))
    return mm, a + b


def lane_view(z, nt):
    """z [..., L, Lk] padded with -inf to whole steps and split by the lanes
    that hold it: [..., steps, 2 (warp of the pair), nt (tile), 4 (lane of
    the quad), 2 (key of the lane)], key = 16 nt step + 8 nt d + 8 n + 2 c + e."""
    lk = z.shape[-1]
    nstep = -(-lk // (16 * nt))
    zp = torch.full((*z.shape[:-1], nstep * 16 * nt), NEG_INF)
    zp[..., :lk] = z
    return zp.reshape(*z.shape[:-1], nstep, 2, nt, 4, 2)


def streamed_stats(z, nt=2):
    """Row max and sum of e of z [..., L, L] (fp32) in the streamed path's
    order: (m, l) [..., L]."""
    zs = lane_view(z, nt)
    m = torch.full((*z.shape[:-1], 2, 4), NEG_INF)
    lsum = torch.zeros((*z.shape[:-1], 2, 4))
    for st in range(zs.shape[-5]):
        zt = zs[..., st, :, :, :, :]  # [..., d, n, c, e]
        tmax = torch.amax(zt, dim=(-3, -1))  # [..., d, c]
        up = tmax > m
        lsum = torch.where(up, lsum * torch.exp(m - tmax), lsum)
        m = torch.where(up, tmax, m)
        for n in range(nt):
            for e in range(2):
                zz = zt[..., n, :, e]
                lsum = lsum + torch.where(zz == NEG_INF, torch.zeros_like(zz), torch.exp(zz - m))
    for x in (1, 2):  # the quad's shuffles: lane c with lane c ^ x
        perm = [c ^ x for c in range(4)]
        m, lsum = merge(m, lsum, m[..., perm], lsum[..., perm])
    # the pair: warp 0's statistics, then warp 1's merged into them
    return merge(m[..., 0, 0], lsum[..., 0, 0], m[..., 1, 0], lsum[..., 1, 0])


def registers_stats(z, nt=2):
    """Row max and sum of e of z in the z-in-registers path's order: the
    exact max; e summed per lane in key order, then the quad (xor 1, then 2),
    then warp 0's plus warp 1's."""
    m = torch.amax(z, -1)
    zs = lane_view(z, nt)
    lsum = torch.zeros((*z.shape[:-1], 2, 4))
    for st in range(zs.shape[-5]):
        for n in range(nt):
            for e in range(2):
                lsum = lsum + torch.exp(zs[..., st, :, n, :, e] - m[..., None, None])
    for x in (1, 2):
        lsum = lsum + lsum[..., [c ^ x for c in range(4)]]
    return m, lsum[..., 0, 0] + lsum[..., 1, 0]


def streamed_forward(q16, k16, v16, z, layout, path):
    """out = bf16(p16 v16) [..., L, HD] from the bf16-valued q16, k16, v16 and
    the logits z, with p16 = bf16(e * (1 / sum e)) (K8, ``layout`` "grid") or
    bf16(e / sum e) (K9) from the statistics of ``path`` ("registers" or
    "streamed")."""
    m, lsum = (registers_stats if path == "registers" else streamed_stats)(z)
    e = torch.exp(z - m[..., None])
    p = e * (1.0 / lsum)[..., None] if layout == "grid" else e / lsum[..., None]
    return torch.matmul(p.to(torch.bfloat16).float(), v16).to(torch.bfloat16)


def operands(seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((B, H, W, C)), jnp.bfloat16),
                          np.float32) for _ in range(3))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, L, L)) * 2.0).astype(np.float32)
    patt = make_shift_mask((H, W), WINDOW, (4, 9))[-1]
    return q, k, v, scale, bias, patt


@pytest.mark.parametrize("path", ["registers", "streamed"])
def test_statistics_match_two_pass(path):
    """Each path's (max, sum e) against the plain max-then-sum: the max bit
    for bit, the sum within 1e-6 relative (both sides add about 170 fp32
    terms near 1 in different orders: a few fp32 ulps of 1.2e-7 each)."""
    rng = np.random.default_rng(5)
    z = torch.from_numpy((rng.standard_normal((3, L, L)) * 4.0).astype(np.float32))
    m, lsum = (registers_stats if path == "registers" else streamed_stats)(z)
    ref_m = torch.amax(z, -1)
    assert torch.equal(m, ref_m)
    torch.testing.assert_close(lsum, torch.sum(torch.exp(z - ref_m[..., None]), -1), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("path", ["registers", "streamed"])
@pytest.mark.parametrize("layout", ["grid", "windowed"])
def test_streamed_forward_matches_plain_and_jax(layout, path):
    """K8 ("grid": q and k normalized per head outside, as WindowAttentionGrid
    does) or K9 ("windowed": normalized inside) with either path's
    statistics, against the plain version and JAX's kernel, bias and mask
    on."""
    q, k, v, scale, bias, patt = operands()
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    tscale, tbias = torch.from_numpy(scale), torch.from_numpy(bias)
    jargs = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)] + [jnp.asarray(scale)]
    if layout == "grid":
        qn, _ = wa.normalize_heads(tq, HEADS)
        kn, _ = wa.normalize_heads(tk, HEADS)
        q16, k16, v16 = (wa._grid_to_windows(t, WINDOW, HEADS).float() for t in (qn, kn, tv))
        plain = wa.window_attention_grid_bias_reference(qn, kn, tv, tscale, tbias, WINDOW, patt,
                                                        1.0)
        ref = jax_wa.fused_window_attention_grid(*jargs, WINDOW, bias=jnp.asarray(bias),
                                                 mask_pattern=patt)
    else:
        tq, tk, tv = (wa._grid_to_windows(t, WINDOW, HEADS).contiguous() for t in (tq, tk, tv))

        def unit(t):
            tf = t.float()
            return tf * torch.rsqrt(torch.clamp_min(torch.sum(tf * tf, -1, keepdim=True), 1e-24))

        q16, k16 = (unit(t).to(torch.bfloat16).float() for t in (tq, tk))
        v16 = tv.float()
        plain = wa.window_attention_v1_bias_reference(tq, tk, tv, tscale, tbias, GRID, patt)
        ref = jax_wa.fused_window_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                              for t in (tq, tk, tv)), jnp.asarray(scale),
                                            bias=jnp.asarray(bias), mask_pattern=patt,
                                            window_grid=GRID)
    z = wa._logits(torch.matmul(q16, k16.transpose(-1, -2)), tscale, tbias, patt, 1.0, GRID)
    out = streamed_forward(q16, k16, v16, z, layout, path)
    if layout == "grid":
        out = wa._windows_to_grid(out, WINDOW, (H, W))
    assert out.shape == plain.shape and torch.isfinite(out.float()).all()
    tol = GRAD_ULPS["dv"]
    assert_close_ulps(out.float().numpy(), plain.float().numpy(), *tol)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), *tol)
