"""PyTorch port, the e2048 widths: the qkv-fused attention at head dim 256
(K1's streamed pass, the streamed backward), the whole-MLP forward at
C_out above 768 (K5's schedule) and the fused LayerNorm above 2048 channels.

On the CPU the plain versions run: at head dim 256 they are held to the JAX
kernels (interpret mode), and the e2048 block geometry (embed 2048, 8 heads
of 256, mlp_ratio 2, ``mlp_impl: fused2``, depth 2, at the micro image) to
the JAX model, forward and gradients. Which kernel variant runs where, and
the shared memory each needs, is computed by the wrappers from the same
formulas as the CUDA sources; the table here pins those numbers (at L = 162
the forward's streamed pass needs 96,912 B at head dim 128 and 100,496 B at
256, the one-block backward 194,368 B at 128 and 374,592 B at 256, against
the 232,448 B a block may use; the backward takes the streamed variant at
both, at 128 because it is the faster one). The CUDA kernels themselves are held to these
plain versions on the GPU (tests/test_torch_kernels.py, ``-m cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.ops import ln_kernels, mlp_kernels
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_kernels import assert_close_backward, assert_close_ulps
from test_torch_model import leaf_rel_errors, micro_configs, micro_models
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# which kernel runs, and its shared memory
# --------------------------------------------------------------------------

# (head dim, L) -> bytes of (K1's forward pass, K2 backward) as the CUDA
# sources compute them (fwd_plan, bwd_smem_bytes), and the variant of each
SMEM_TABLE = {
    (96, 162): ((76432, 149312), ("streamed", "base")),
    (128, 162): ((96912, 194368), ("streamed", "streamed")),
    (256, 162): ((100496, 374592), ("streamed", "streamed")),
    (128, 144): ((90176, 159040), ("streamed", "streamed")),
    (256, 8): ((78368, 34112), ("streamed", "streamed")),
}


@pytest.mark.parametrize("hd, l", list(SMEM_TABLE))
def test_qkv_variant_table(hd, l):
    (fwd, bwd), variants = SMEM_TABLE[hd, l]
    sm = wa.qkv_smem_bytes(hd, l)
    assert (sm["fwd"], sm["bwd"]) == (fwd, bwd)
    assert (wa.qkv_variant("t", hd, l, False), wa.qkv_variant("t", hd, l, True)) == variants
    # the streamed backward fits wherever it is chosen
    assert max(sm["streamed_rows"], sm["streamed_cols"]) <= 232448


@pytest.mark.parametrize("hd, l", [(96, 256), (64, 256), (192, 162), (256, 256), (48, 8)])
def test_qkv_variant_refuses_what_no_kernel_takes(hd, l):
    """Every shape the wrappers let through has a kernel whose shared memory
    fits; the others raise a ValueError, never reach a launch. The forward
    (the projection on the GEMM core, then the streamed pass) takes every L
    at head dims 32-256, so only head dims 192 and 48 refuse, both ways. The
    backward's one-block kernel takes head dims 64 and 96 at L = 256
    (217,152 B and 151,616 B); head dim 256 at L = 256 does not fit it and
    takes the streamed variant, whose kernels' shared memory (176,160 /
    182,272 B) does not grow with L beyond two small tables."""
    if hd in (192, 48):
        for backward in (False, True):
            with pytest.raises(ValueError):
                wa.qkv_variant("t", hd, l, backward)
        return
    assert wa.qkv_variant("t", hd, l, False) == "streamed"
    assert wa.qkv_smem_bytes(hd, l)["fwd"] <= 232448
    if (hd, l) in ((96, 256), (64, 256)):
        assert wa.qkv_variant("t", hd, l, True) == "base"
        assert wa.qkv_smem_bytes(hd, l)["bwd"] == {96: 217152, 64: 151616}[hd]
    else:
        sm = wa.qkv_smem_bytes(hd, l)
        assert sm["bwd"] > 232448
        assert (sm["streamed_rows"], sm["streamed_cols"]) == (176160, 182272)
        assert wa.qkv_variant("t", hd, l, True) == "streamed"


# (head dim, L, rows a window, K8) -> the streamed backward's
# launch (csrc/streamed_bwd.cuh plan_of, rows_smem, cols_smem): 16-row tiles
# a block, blocks a (window, head), rows and columns kernels' shared memory
STREAMED_PLAN = {
    (256, 162, 162, False): (4, 3, 175792, 181264),  # K2 at the e2048 shape
    (256, 162, 168, False): (4, 3, 175808, 181280),  # v4 there (lm = 168)
    (256, 162, 162, True): (4, 3, 175792, 181968),   # K8 at the e2048 shape
    (128, 162, 162, True): (4, 3, 93872, 100048),    # K8 at head dim 128
    (128, 224, 224, False): (4, 4, 94112, 99968),    # K2 at head dim 128, L = 224
    (256, 8, 8, False): (1, 1, 119872, 120992),      # one tile
}


@pytest.mark.parametrize("hd, l, ls, grid", list(STREAMED_PLAN))
def test_streamed_bwd_plan(hd, l, ls, grid):
    """The streamed backward's launch as the CUDA source computes it: at most
    four 16-row tiles a block (8 warps), the tiles of a (window, head) split
    evenly (11 tiles at L = 162: three blocks of four, one d(scale) partial a
    block, as ``_row_chunks`` counts them), shared memory within a block's
    232,448 B and independent of L but for the token and statistics tables."""
    rt, nchunk, rows, cols = STREAMED_PLAN[hd, l, ls, grid]
    plan = wa.streamed_bwd_plan(hd, l, ls, grid=grid)
    assert (plan["rt"], plan["nchunk"], plan["rows_smem"], plan["cols_smem"]) == (
        rt, nchunk, rows, cols)
    assert plan["threads"] == 64 * rt and max(rows, cols) <= 232448
    lp = -(-l // 16) * 16
    assert nchunk == wa._row_chunks("streamed", lp)
    far = wa.streamed_bwd_plan(hd, 256, 256, grid=grid)  # the longest L it takes
    assert max(far["rows_smem"], far["cols_smem"]) <= 232448


@pytest.mark.parametrize("family", ["qkv", "attn"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("l", [288, 576])
def test_backward_variant_beyond_256(family, hd, l):
    """Past L = 256 the qkv-fused family's backward (K2/K7/K10/K12) and
    K8/K9's (both layouts) take the streamed kernels, whose shared memory
    grows with L only by their tables (the qkv family's by 16 B a row past
    L = 288's); they fit a block at every head dim the forward takes, with
    one d(scale) partial a block of 64 rows."""
    assert wa.qkv_variant("t", hd, l, False) == wa.attn_variant("t", hd, l, False) == "streamed"
    if family == "qkv":
        assert wa.qkv_variant("t", hd, l, True) == "streamed"
        sm, sm288 = wa.qkv_smem_bytes(hd, l), wa.qkv_smem_bytes(hd, 288)
        assert max(sm["streamed_rows"], sm["streamed_cols"]) <= 232448
        assert sm["streamed_cols"] - sm288["streamed_cols"] == 12 * (l - 288)
        assert wa._row_chunks("streamed", l) == -(-l // 64)
    else:
        for layout in wa.ATTN_LAYOUTS:
            assert wa.attn_variant("t", hd, l, True, layout) == "streamed"
            sm = wa.attn_smem_bytes(hd, l, layout)
            assert max(sm["streamed_rows"], sm["streamed_cols"]) <= 232448


def test_wrappers_check_before_device():
    """A CPU tensor never reaches a kernel: the wrappers refuse it first."""
    x = torch.zeros((1, 18, 36, 512), dtype=torch.bfloat16)
    w = torch.zeros((512, 1536), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_qkv(x, w, torch.zeros(1536), torch.ones(2), (9, 18))


@pytest.mark.parametrize("c_in, c_out, variant", [
    (768, 768, 256), (128, 128, 128), (2048, 2048, 256), (2048, 768, 256),
    (768, 1024, 256), (256, 800, 256)])
def test_mlp_fwd_variant(c_in, c_out, variant):
    """What picks K5's schedule now: one design at every width (the narrow
    and wide instances are gone), two launches of the GEMM core whose block
    width ``variant`` follows C_out (256 columns, 128 where C_out <= 128);
    fc1 is computed once (its grid covers the hidden columns once), and each
    launch's shared memory fits the 227 KB a block may use."""
    hidden = 4 * c_in
    p = mlp_kernels.mlp_fwd_plan(1000, c_in, hidden, c_out)
    assert p["launches"] == 2
    assert p["fc2"]["bn"] == variant and p["fc1"]["bn"] == 256
    assert p["fc1"]["grid"] == (-(-hidden // 256), 8, 1)
    assert p["fc2"]["grid"] == (-(-c_out // variant), 8, 1)
    assert max(p["fc1"]["smem"], p["fc2"]["smem"]) <= 232448


@pytest.mark.parametrize("tokens, channels", [(64, 768), (64, 2048), (60, 768), (64, 4096),
                                              (64, 2000)])
def test_ln_supported_matches_the_kernel_condition(tokens, channels):
    """``supported`` is JAX's shape condition (both models fall back alike),
    and every width it admits has a K11 entry point: rows up to 2048 channels in
    registers, wider ones streamed (the wrappers' only condition is C % 128
    == 0; their GPU cases are in tests/test_torch_kernels.py). Models of any
    width build on the fused route; a block takes the unfused branch where
    ``supported`` refuses."""
    assert ln_kernels.supported(tokens, channels) == (channels % 128 == 0 and tokens % 8 == 0)
    _, tp = micro_configs(lnadd_impl="fused", embed_dim=channels)
    assert swin.build_swin_from_params(tp).blocks[0].lnadd_impl == "fused"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lnadd_route_at_4096_matches_the_unfused_route(dtype):
    """At C = 4096, above the register kernels' width, the fused route's plain
    versions in a block: eval mode (m = 1), where the fused and unfused
    branches round alike, so they agree to the last bit."""
    rng = np.random.default_rng(6)
    z = torch.from_numpy(rng.standard_normal((2, 4, 4096)).astype(np.float32)).to(
        getattr(torch, dtype))
    x = torch.from_numpy(rng.standard_normal((2, 4, 4096)).astype(np.float32)).to(z.dtype)
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(4096)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(4096)).astype(np.float32))
    fused = ln_kernels.fused_ln_droppath_add(z, x, gamma, beta, torch.ones(2))
    norm = swin.Fp32LayerNorm(4096)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
        assert torch.equal(fused, x + norm(z))


# --------------------------------------------------------------------------
# head dim 256: the plain versions against the JAX kernels
# --------------------------------------------------------------------------

B, H, W, HEADS, HD = 1, 6, 8, 2, 256
C = HEADS * HD
WINDOW = (3, 4)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    scale = np.exp(np.log(10.0) + 0.3 * rng.standard_normal(HEADS)).astype(np.float32)
    return x, w, b, scale


@pytest.mark.parametrize("use_mask", [False, True])
def test_head_dim_256_matches_jax(use_mask):
    """K1/K2's plain versions at head dim 256 (the e2048 heads; the GPU runs
    K1's streamed pass and the streamed backward there) against the JAX v3
    kernels, forward and
    jax.vjp, in bf16 (the bounds of tests/test_torch_kernels.py)."""
    import jax

    from swin_v2_weather_torch.models.swin import make_shift_mask

    x, w, b, scale = inputs()
    patt = make_shift_mask((H, W), WINDOW, (1, 2))[-1] if use_mask else None
    ct = np.random.default_rng(3).standard_normal((B, H, W, C)).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv(*a, WINDOW, patt),
                       jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                       jnp.asarray(scale))
    ref_grads = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(),
              torch.from_numpy(w).bfloat16().requires_grad_(),
              torch.from_numpy(b).requires_grad_(), torch.from_numpy(scale).requires_grad_()]
    out = wa.fused_window_attention_qkv(*leaves, WINDOW, patt)
    assert_close_ulps(out.float().detach().numpy(), np.asarray(ref, np.float32), 2, 0.01)
    out.backward(torch.from_numpy(ct).bfloat16())
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), leaves, ref_grads):
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


WIN288 = (12, 24)  # L = 288, past the 256 rows of the one-block backward


@pytest.mark.parametrize("use_mask", [False, True])
def test_window_288_matches_jax(use_mask):
    """At L = 288 (window 12 x 24; the GPU runs K1's streamed pass and the
    streamed backward there) K1/K2's plain versions against the JAX v3
    kernels at head dim 32, two windows of two heads: forward and jax.vjp in
    bf16 (the bounds of tests/test_torch_kernels.py)."""
    import jax

    from swin_v2_weather_torch.models.swin import make_shift_mask

    rng = np.random.default_rng(9)
    h, w, heads, hd = 12, 48, 2, 32
    c = heads * hd
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    wq = (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(3 * c)).astype(np.float32)
    scale = np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(np.float32)
    patt = make_shift_mask((h, w), WIN288, (6, 12))[-1] if use_mask else None
    ct = rng.standard_normal((1, h, w, c)).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv(*a, WIN288, patt),
                       jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq, jnp.bfloat16),
                       jnp.asarray(b), jnp.asarray(scale))
    ref_grads = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(),
              torch.from_numpy(wq).bfloat16().requires_grad_(),
              torch.from_numpy(b).requires_grad_(), torch.from_numpy(scale).requires_grad_()]
    assert wa.qkv_variant("t", hd, 288, True) == "streamed"
    out = wa.fused_window_attention_qkv(*leaves, WIN288, patt)
    assert_close_ulps(out.float().detach().numpy(), np.asarray(ref, np.float32), 2, 0.01)
    out.backward(torch.from_numpy(ct).bfloat16())
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), leaves, ref_grads):
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def test_wide_mlp_plain_matches_jax():
    """K5/K6's plain versions at the e2048 widths scaled down in tokens
    (T 64, C_in = C_out 2048, hidden 4096) against the JAX whole-MLP kernels,
    bf16 (the bounds of the whole-MLP test: 2 ulps max, 0.02 mean)."""
    from swin_v2_weather_tpu.ops import mlp_kernels as jax_mlp

    rng = np.random.default_rng(4)
    t, c, hidden = 64, 2048, 4096
    x2 = rng.standard_normal((t, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hidden)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c)) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = jax_mlp.mlp_fwd_pallas(jnp.asarray(x2, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
                                 jnp.asarray(w2), jnp.asarray(b2))
    out = mlp_kernels.mlp_fwd_reference(torch.from_numpy(x2).bfloat16(), torch.from_numpy(w1),
                                        torch.from_numpy(b1), torch.from_numpy(w2),
                                        torch.from_numpy(b2))
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 2, 0.02)


# --------------------------------------------------------------------------
# the e2048 block geometry in the model
# --------------------------------------------------------------------------

E2048 = dict(embed_dim=2048, num_heads=8, mlp_ratio=2, mlp_impl="fused2", depth=2,
             drop_path_rate=0.0, scan_blocks=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e2048_block_geometry_matches_jax(dtype):
    """The micro model at the e2048 block geometry (embed 2048, 8 heads of
    256, mlp_ratio 2 on ``fused2``, depth 2) against the JAX model: the
    output and every parameter gradient of sum(out * ct). Bounds of the
    fused2 model test (tests/test_torch_multistep.py): fp32 forward 5e-3
    max of the output scale, gradients 2e-2 / 1e-2 per leaf; bf16 3e-2 /
    4e-3 and 0.15 / 0.08. The fp32 forward's mean bound is 4e-4, not 1e-4:
    both sides stage q, k and v in bf16 inside the attention kernel, and at
    embed 2048 each output sums 32 times as many staged entries as at the
    micro width, so single-ulp flips of them from the fp32 sum order add
    up. Measured at seeds 1 and 2: fp32 forward 1.2e-3 / 1.6e-4, gradients
    5.2e-3 / 2.0e-3 (logit_scale); bf16 8.3e-3 / 1.6e-3 and 4.5e-2 /
    1.3e-2."""
    jm, tree, tm = micro_models(dtype, seed=1, **E2048)
    blk = tm.model.blocks[0]
    assert blk.mlp.impl == "fused2" and blk.attn.num_heads == 8
    assert blk.attn.qkv.weight.shape == (3 * 2048, 2048) and blk.mlp.fc1.weight.shape == (4096, 2048)
    jp, _ = micro_configs(dtype, **E2048)
    x, _, ct = rollout_inputs(jp, 0, batch=1)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    out, grads = port_forward_and_grads(tm, x, None, ct)
    fwd_tol, grad_tol = {"float32": ((5e-3, 4e-4), (2e-2, 1e-2)),
                         "bfloat16": ((3e-2, 4e-3), (0.15, 0.08))}[dtype]
    scale = np.abs(ref).max()
    diff = np.abs(out - ref)
    assert diff.max() <= fwd_tol[0] * scale and diff.mean() <= fwd_tol[1] * scale
    errs = leaf_rel_errors(grads, ref_grads)
    assert max(e[0] for e in errs.values()) <= grad_tol[0], errs
    assert max(e[1] for e in errs.values()) <= grad_tol[1], errs
