"""PyTorch port, the qkv-fused forward's attention pass on the CPU: its order
of sums, and its launch plan.

The CUDA forward of K1, K7, K10 and K12 (``csrc/window_attention_qkv.cu``)
runs the qkv projection on the GEMM core into a scratch, q and k
L2-normalized per head in its epilogue, then an attention pass built on the
K8/K9 forward template (``csrc/qkv_attention.cuh``, layouts QKV and QKV4).
It keeps every rounding site of the TPU kernel and changes only the order of
three fp32 sums:

* sum q^2 (and k^2) of a head: each lane of a quad over its columns 8 j +
  2 c + {0, 1} in column order, fused multiply-adds, then across the quad
  (``window_attention.quad_unit``);
* sum e: each lane's in key order (steps of 32 keys, each warp of a pair 16
  of them in two 8-key tiles, each lane two adjacent keys of a tile), then
  the quad (shuffle xor 1, then 2), then warp 0's plus warp 1's
  (``window_attention.lane_sums``);
* e @ v: one 16-key product at a time, in key order
  (``window_attention.chunked_pv``).

K1's max-free softmax takes one key sweep (``one_sweep_pass``: out =
(bf16(e) @ v16) * (1 / sum e)); v4 rounds p16 = bf16(e * (1 / sum e)) first
and sweeps twice (``v4_pass``). Those plain versions repeat the kernel's
order (the kernel itself runs only on the card), and are held here to the
plain versions (``window_attention_qkv_reference`` and friends, plain row
sums) and to the JAX package's kernels in interpret mode, at L = 162 (window
9 x 18), head dim 96, 2 x 2 windows, 2 heads, with and without the shift
mask and the folded CPB bias.

Tolerance: 2 bf16 ulps max and 0.02 mean of the output's scale
(``GRAD_ULPS["dv"]`` of tests/test_torch_grid_attention.py, as
tests/test_torch_streamed_attention.py takes for K8/K9's orders). out is a
bf16 rounding of an fp32 product of bf16 operands; a sum of e whose last
fp32 bits differ moves an output by well under an ulp, and can flip a p16
rounding (v4) now and then. The sums themselves agree within 1e-6 relative
(about 170 fp32 terms near 1 in two orders).
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

from test_torch_grid_attention import GRAD_ULPS
from test_torch_kernels import assert_close_ulps

torch.set_num_threads(1)

B, H, W, C_IN, HEADS, HD = 1, 18, 36, 64, 2, 96
WINDOW = (9, 18)
GRID = (H // WINDOW[0], W // WINDOW[1])
L = WINDOW[0] * WINDOW[1]
LM = -(-L // 8) * 8  # v4's rows a window
C = HEADS * HD
TOL = GRAD_ULPS["dv"]


def operands(seed=4):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, H, W, C_IN)), jnp.bfloat16), np.float32)
    w = np.asarray(jnp.asarray(rng.standard_normal((C_IN, 3 * C)) / np.sqrt(C_IN), jnp.bfloat16),
                   np.float32)
    b = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    scale = np.exp(np.log(10.0) + 0.3 * rng.standard_normal(HEADS)).astype(np.float32)
    raw = (2.0 * rng.standard_normal((HEADS, L, L))).astype(np.float32)
    badd = wa.fold_cpb_bias(torch.from_numpy(raw), torch.from_numpy(scale)).numpy()
    return x, w, b, scale, badd


def pattern(use_mask):
    return make_shift_mask((H, W), WINDOW, (4, 9))[-1] if use_mask else None


def test_lane_sums_match_a_plain_sum():
    """The pass's order of sum e against a plain row sum, within 1e-6
    relative, at L = 162 and at L = 288 (more than one step past 256)."""
    rng = np.random.default_rng(5)
    for lk in (L, 288):
        e = torch.from_numpy(np.exp(rng.standard_normal((3, 40, lk)) * 2.0 - 3.0).astype(np.float32))
        torch.testing.assert_close(wa.lane_sums(e), torch.sum(e, -1), rtol=1e-6, atol=0)


def test_quad_unit_matches_a_plain_norm():
    """The epilogue's head normalization against a plain row sum: inv within
    1e-6 relative (96 squares in two orders), the bf16 rows equal but for a
    rare flipped rounding (one ulp), at head dims 32, 96 and 256."""
    rng = np.random.default_rng(8)
    for hd in (32, 96, 256):
        t = torch.from_numpy(rng.standard_normal((4, 50, hd)).astype(np.float32)).bfloat16().float()
        t16, inv = wa.quad_unit(t)
        ref_inv = 1.0 / torch.sqrt(torch.clamp_min(torch.sum(t * t, -1, keepdim=True), 1e-24))
        torch.testing.assert_close(inv, ref_inv, rtol=1e-6, atol=0)
        assert_close_ulps(t16.numpy(), (t * ref_inv).bfloat16().float().numpy(), 1, 0.01)


def test_chunked_pv_matches_one_product():
    """e @ v by 16-key chunks against one product: fp32 sums in two orders."""
    rng = np.random.default_rng(6)
    p16 = torch.from_numpy(rng.random((2, 40, L)).astype(np.float32)).bfloat16()
    v16 = torch.from_numpy(rng.standard_normal((2, L, HD)).astype(np.float32)).bfloat16()
    torch.testing.assert_close(wa.chunked_pv(p16, v16), torch.matmul(p16.float(), v16.float()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_one_sweep_matches_plain_and_jax(use_mask, use_bias):
    """K1's pass order (K7's with the folded CPB bias) against the plain
    version and JAX's ``fused_window_attention_qkv`` (interpret mode)."""
    x, w, b, scale, badd = operands()
    patt = pattern(use_mask)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    tb, tscale, tbadd = torch.from_numpy(b), torch.from_numpy(scale), torch.from_numpy(badd)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
             jnp.asarray(scale), WINDOW, patt)
    if use_bias:
        out = wa.window_attention_qkv_pass_order(tx, tw, tb, tscale, WINDOW, patt, 1.0, tbadd)
        plain = wa.window_attention_qkv_bias_reference(tx, tw, tb, tscale, tbadd, WINDOW, patt)
        ref = jax_wa.fused_window_attention_qkv(*jargs, bias=jnp.asarray(badd),
                                                bias_prefolded=True)
    else:
        out = wa.window_attention_qkv_pass_order(tx, tw, tb, tscale, WINDOW, patt)
        plain = wa.window_attention_qkv_reference(tx, tw, tb, tscale, WINDOW, patt)
        ref = jax_wa.fused_window_attention_qkv(*jargs)
    assert out.shape == plain.shape == (B, H, W, C) and torch.isfinite(out.float()).all()
    assert_close_ulps(out.float().numpy(), plain.float().numpy(), *TOL)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), *TOL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_v4_two_sweeps_match_plain_and_jax(use_mask):
    """v4's pass order (p16 = bf16(e * (1 / sum e)) before p @ v) on the
    window-major rows, pad query rows included, against v4's plain version
    and JAX's ``_qkv4_forward`` (interpret mode)."""
    x, w, b, scale, _ = operands()
    patt = pattern(use_mask)
    xw = np.asarray(jax_v45.window_major(jnp.asarray(x, jnp.bfloat16), WINDOW), np.float32)
    targs = (torch.from_numpy(xw).bfloat16(), torch.from_numpy(w).bfloat16(),
             torch.from_numpy(b), torch.from_numpy(scale))
    out = v45.window_attention_qkv4_pass_order(*targs, WINDOW, GRID, patt)
    plain = v45.window_attention_qkv4_reference(*targs, WINDOW, GRID, patt)
    ref = jax_v45._qkv4_forward(jnp.asarray(xw, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(b), jnp.asarray(scale), patt, GRID, L, True)
    assert out.shape == plain.shape == (B, GRID[0] * GRID[1], LM, C)
    assert_close_ulps(out.float().numpy(), plain.float().numpy(), *TOL)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), *TOL)


def test_v4_pass_is_not_the_one_sweep():
    """At the bf16 level v4's pass (p16 rounded first) and K1's (e16, then
    1 / sum e) are different functions of the same e and v."""
    rng = np.random.default_rng(7)
    e = torch.from_numpy(np.exp(rng.standard_normal((2, 32, L)) - 2.0).astype(np.float32))
    v16 = torch.from_numpy(rng.standard_normal((2, L, HD)).astype(np.float32)).bfloat16().float()
    one = wa.one_sweep_pass(e, v16).bfloat16()
    two = v45.v4_pass(e, v16).bfloat16()
    assert not torch.equal(one, two)


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

_MAX_SMEM = 232448


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("l", [8, 162, 256, 288])
def test_forward_plan(hd, l):
    """The pass's launch at every head dim and window length: the row tiles
    of a (window, head) split evenly over its blocks, two warps a tile,
    shared memory within a block's 232,448 B, with room for two blocks an SM
    (the template's launch bound) wherever e stays in registers (L <= 192)
    and up to head dim 128 beyond (one streamed sweep of k and v tiles), and
    the forward's variant at each shape."""
    lp = -(-l // 16) * 16
    for lq in (l, -(-l // 8) * 8):  # v3's rows, v4's
        p = wa.qkv_fwd_plan(hd, l, lq)
        assert p["rt"] * 16 * p["nchunk"] >= lp > (p["rt"] * p["nchunk"] - p["rt"]) * 16
        assert p["rt"] <= (3 if hd > 128 else 4) and p["threads"] == 64 * p["rt"]
        assert p["z"] == (l <= 192)
        assert p["ks"] == (64 if p["z"] and hd <= 128 else 32)
        assert p["smem"] <= _MAX_SMEM and (hd > 128 and not p["z"] or 2 * p["smem"] <= 228 * 1024)
    assert wa.qkv_variant("t", hd, l, False) == "streamed"
    assert wa.qkv_smem_bytes(hd, l)["fwd"] == wa.qkv_fwd_plan(hd, l)["smem"]


@pytest.mark.parametrize("hd", [48, 160, 192])
def test_forward_refuses_head_dims_no_instance_takes(hd):
    with pytest.raises(ValueError, match="no forward kernel"):
        wa.qkv_variant("t", hd, 162, False)
