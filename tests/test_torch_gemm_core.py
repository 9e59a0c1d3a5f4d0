"""PyTorch port, the Hopper GEMM core (``ops/csrc/wgmma_gemm.cuh``) and the
whole-MLP kernels on it: the forward (K5, two launches) and the backward's
recompute (K6, one launch of the core's pair kernel).

On the CPU: the core's Python side (block tile, ring, grid and split
planning, the shape checks that raise before a launch, the CPU dispatch of
its entry point) and K5's schedule: its launches, and the plain two-phase
version (fc1 and its epilogue into a bf16 scratch, then fc2 and its
epilogue), held bit-equal to ``mlp_fwd_reference`` and through it to the JAX
kernel ``mlp_fwd_pallas`` (interpret mode), which shows that the
decomposition moves no rounding site; K6's launch plan and the shapes it
refuses.

On a GPU only (``-m cuda``; skipped here): the core at ragged M, N and K with
either operand K-major or MN-major against the exact product of the same
bf16 values, its split-K sums bit-equal across two calls, and K5 at the
flagship and e2048 widths and a ragged T against its plain version.
``python -m pytest --noconftest -m cuda tests/test_torch_gemm_core.py`` runs
them where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from swin_v2_weather_torch.ops import gemm_core, mlp_kernels

torch.set_num_threads(1)


def bf16_ulp(ref: np.ndarray) -> float:
    """bf16 spacing (8 significant bits) at the largest magnitude of ref."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def mlp_leaves(t, c_in, hidden, c_out, seed=2, dtype=torch.bfloat16):
    """x2 [t, c_in] in ``dtype``; w1, b1, w2, b2 fp32 (seeded, numpy)."""
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((t, c_in)).astype(np.float32)
    w1 = (rng.standard_normal((c_in, hidden)) / np.sqrt(c_in)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c_out)) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    return [torch.from_numpy(x2).to(dtype)] + [torch.from_numpy(a) for a in (w1, b1, w2, b2)]


# --------------------------------------------------------------------------
# on the CPU: planning and shape checks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m, n, k, a_mn, b_mn, bn, grid", [
    (64800, 3072, 768, False, True, 256, (12, 507, 1)),    # K5 fc1, flagship
    (64800, 768, 3072, False, True, 256, (3, 507, 1)),     # K5 fc2, flagship
    (64800, 4096, 2048, False, True, 256, (16, 507, 1)),   # K5 fc1, e2048
    (64800, 768, 2304, False, False, 256, (3, 507, 1)),    # K2 dx, flagship
    (104, 96, 40, True, False, 128, (1, 1, 1)),            # ragged, narrow
])
def test_plan_tiles(m, n, k, a_mn, b_mn, bn, grid):
    """Block tile 128 x 256 (128 where N <= 128), ring of 4 (6) 64-deep
    stages within the 227 KB a block may use, one block per output tile."""
    p = gemm_core.plan(m, n, k, a_mn=a_mn, b_mn=b_mn)
    assert (p["bn"], p["grid"], p["threads"]) == (bn, grid, 384)
    assert p["smem"] == p["stages"] * (128 + bn) * 64 * 2 + 16 * p["stages"] + 1024 <= 232448
    assert p["k_chunk"] % 64 == 0 and p["k_chunk"] >= k


@pytest.mark.parametrize("kwargs", [
    dict(m=100, n=96, k=36),                          # K-major A: K not a multiple of 8
    dict(m=100, n=96, k=40, a_mn=True),               # MN-major A: M not a multiple of 8
    dict(m=96, n=90, k=40, b_mn=True),                # MN-major B: N not a multiple of 8
    dict(m=96, n=96, k=40, lda=44),                   # leading dimension
    dict(m=96, n=0, k=40),                            # empty
    dict(m=96, n=96, k=640, splits=12),               # more splits than 64-deep chunks
    dict(m=128 * 65536, n=96, k=64),                  # more than 65535 row tiles
])
def test_plan_refuses(kwargs):
    """Shapes the kernel does not take raise before any launch."""
    with pytest.raises(ValueError):
        gemm_core.plan(**kwargs)


@pytest.mark.parametrize("m, n, k", [(768, 2304, 64800), (2048, 6144, 16200), (768, 3072, 64800),
                                     (64, 192, 96), (1024, 3072, 4096)])
def test_split_k(m, n, k):
    """Every split of the dW product holds K (at least 8 slices of 64 when it
    splits at all), the plan takes it, and the choice is stable."""
    s = gemm_core.split_k(m, n, k)
    p = gemm_core.plan(m, n, k, a_mn=True, b_mn=True, splits=s)
    assert 1 <= s <= 32 and p["grid"][2] == s
    assert s == 1 or (p["k_chunk"] >= 512 and (s - 1) * p["k_chunk"] < k)
    assert gemm_core.split_k(m, n, k) == s


def test_split_k_flagship_fills_the_card():
    """At the flagship dW (768 x 2304 over 64800 rows: 54 tiles) the split
    takes more than one wave of the 132 SMs."""
    s = gemm_core.split_k(768, 2304, 64800)
    assert s > 1 and 54 * s > gemm_core.SMS


def test_gemm_cpu_takes_the_plain_version():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((20, 24)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32)).bfloat16()
    before = gemm_core.gemm.launches
    out = gemm_core.gemm(a, b)
    assert gemm_core.gemm.launches == before
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    assert gemm_core.gemm(a, b, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("shape, strides, operand, mn", [
    ((8, 16), (16, 1), "a", False), ((8, 16), (1, 8), "a", True),
    ((8, 16), (16, 1), "b", True), ((8, 16), (1, 8), "b", False)])
def test_operand_majors(shape, strides, operand, mn):
    """A row-contiguous a is K-major, its transpose view MN-major; a
    row-contiguous b is MN-major, its transpose view K-major."""
    t = torch.empty_strided(shape, strides, dtype=torch.bfloat16)
    got, ld = gemm_core._major(operand, t, operand == "b")
    assert got == mn and ld == max(strides)


def test_operand_layout_refused():
    t = torch.zeros((8, 16, 2), dtype=torch.bfloat16)[:, :, 0]
    with pytest.raises(ValueError, match="row-contiguous"):
        gemm_core._major("a", t, False)


# --------------------------------------------------------------------------
# on the CPU: K5's schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, c_in, hidden, c_out", [(96, 64, 256, 64), (100, 256, 512, 1024),
                                                    (37, 128, 256, 96)])
def test_two_phase_is_the_reference_bit_for_bit(dtype, t, c_in, hidden, c_out):
    """fc1 -> bf16 scratch -> fc2, each product's epilogue apart, gives the
    plain version's bits: the decomposition moves no rounding site."""
    leaves = mlp_leaves(t, c_in, hidden, c_out, dtype=dtype)
    out = mlp_kernels.mlp_fwd_two_phase(*leaves)
    ref = mlp_kernels.mlp_fwd_reference(*leaves)
    assert out.dtype == dtype and tuple(out.shape) == (t, c_out)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_phase_matches_jax(dtype):
    """The two-phase schedule against the JAX kernel mlp_fwd_pallas
    (interpret mode), same inputs, the bounds of the plain version's JAX test
    (tests/test_torch_kernels.py): both round at the same sites, so only the
    fp32 sum order and the erf evaluation differ."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from swin_v2_weather_tpu.ops import mlp_kernels as jax_mlp

    leaves = mlp_leaves(96, 64, 256, 64, dtype=getattr(torch, dtype))
    x2, w1, b1, w2, b2 = (t.float().numpy() for t in leaves)
    ref = np.asarray(jax_mlp.mlp_fwd_pallas(jnp.asarray(x2, dtype), jnp.asarray(w1),
                                            jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2)),
                     np.float32)
    out = mlp_kernels.mlp_fwd_two_phase(*leaves).float().numpy()
    diff = np.abs(out - ref)
    assert diff.max() <= 2 * bf16_ulp(ref) and diff.mean() <= 0.02 * bf16_ulp(ref)


@pytest.mark.parametrize("c_in, hidden, c_out", [(768, 3072, 768), (2048, 4096, 2048),
                                                 (256, 512, 1024)])
def test_mlp_fwd_plan(c_in, hidden, c_out):
    """K5 is two launches of the core at any width: fc1 over the hidden
    columns, fc2 over the output columns, 128-row tiles, nothing recomputed;
    the scratch is the bf16 [T, hidden] activation."""
    p = mlp_kernels.mlp_fwd_plan(64800, c_in, hidden, c_out)
    assert p["launches"] == 2
    assert p["fc1"]["grid"] == (-(-hidden // 256), 507, 1)
    assert p["fc2"]["grid"] == (-(-c_out // 256), 507, 1)
    assert p["scratch_bytes"] == 2 * 64800 * hidden


@pytest.mark.parametrize("t, c_in, hidden, c_out", [(64800, 768, 3072, 768),
                                                    (64800, 2048, 4096, 2048),
                                                    (16200, 2048, 4096, 2048), (100, 32, 136, 40)])
def test_mlp_bwd_plan(t, c_in, hidden, c_out):
    """K6 is one launch of the core's pair kernel at every width: one grid
    over the [T, hidden] output tiles (256 columns, 128 rows), x @ W1 over
    C_in then g @ W2^T over C_out on each tile, the pre-activation kept in
    64 registers a consumer thread (half the 128 accumulators) and no
    [T, hidden] scratch; the ring fits a block's shared memory."""
    p = mlp_kernels.mlp_bwd_plan(t, c_in, hidden, c_out)
    assert p["launches"] == 1 and p["scratch_bytes"] == 0
    assert p["bn"] == 256 and p["grid"] == (-(-hidden // 256), -(-t // 128))
    assert p["kept_words"] == 64 and p["fc1"]["k_chunk"] >= c_in and p["dpre"]["k_chunk"] >= c_out
    assert p["smem"] <= 232448


@pytest.mark.parametrize("t, c_in, hidden, c_out", [(100, 36, 128, 64), (100, 64, 130, 64),
                                                    (100, 64, 128, 20), (128 * 65536, 64, 128, 64)])
def test_mlp_bwd_plan_refuses_what_the_core_does_not_take(t, c_in, hidden, c_out):
    """Widths that are not multiples of 8 (16-byte TMA rows) and more than
    65535 row tiles raise before any launch."""
    with pytest.raises(ValueError):
        mlp_kernels.mlp_bwd_plan(t, c_in, hidden, c_out)


# --------------------------------------------------------------------------
# on the GPU: the core and K5 against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def operands(m, n, k, a_mn, b_mn, dev, seed=0):
    """a [m, k] and b [k, n] bf16 on dev, each stored in the requested major
    (a transpose view where MN-major A or K-major B)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).bfloat16()
    a = a.t().contiguous().to(dev).t() if a_mn else a.contiguous().to(dev)
    b = b.contiguous().to(dev) if b_mn else b.t().contiguous().to(dev).t()
    return a, b


def exact_product(a, b):
    """The fp64 product of the bf16 values and the elementwise bound on any
    fp32 accumulation of it: K 2^-22 (|a| @ |b|), four times the
    round-to-nearest bound K 2^-24, which covers an adder that truncates."""
    a64, b64 = a.double().cpu(), b.double().cpu()
    return a64 @ b64, a.shape[1] * 2.0 ** -22 * (a64.abs() @ b64.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("a_mn", [False, True])
@pytest.mark.parametrize("b_mn", [False, True])
@pytest.mark.parametrize("m, n, k", [(200, 136, 72), (64, 272, 1000), (384, 512, 256)])
def test_core_matches_the_exact_product(cuda_device, a_mn, b_mn, m, n, k):
    """Ragged M, N and K (not multiples of 128, 256 or 64), with either
    operand in either major, fp32 out, against the fp64 product within the
    fp32 accumulation bound; and bf16 out within one bf16 rounding of it."""
    a, b = operands(m, n, k, a_mn, b_mn, cuda_device)
    before = gemm_core.gemm.launches
    out = gemm_core.gemm(a, b)
    out16 = gemm_core.gemm(a, b, torch.bfloat16)
    torch.cuda.synchronize()
    assert gemm_core.gemm.launches == before + 2
    ref, tol = exact_product(a, b)
    assert ((out.double().cpu() - ref).abs() <= tol).all()
    half_ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 8)
    assert ((out16.double().cpu() - ref).abs() <= half_ulp + tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("a_mn, b_mn", [(True, True), (False, True)])
def test_core_split_k_is_deterministic(cuda_device, a_mn, b_mn):
    """Split-K writes fixed fp32 partials summed in split order: within the
    accumulation bound, and two calls give the same bits (dW's contract)."""
    m, n, k = 192, 320, 3000
    a, b = operands(m, n, k, a_mn, b_mn, cuda_device, seed=1)
    out = gemm_core.gemm(a, b, splits=5)
    again = gemm_core.gemm(a, b, splits=5)
    torch.cuda.synchronize()
    ref, tol = exact_product(a, b)
    assert ((out.double().cpu() - ref).abs() <= tol).all()
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("t, c_in, hidden, c_out", [(64800, 768, 3072, 768),
                                                    (4100, 2048, 4096, 2048), (100, 256, 512, 1024),
                                                    (300, 768, 3072, 768)])
def test_k5_matches_plain(cuda_device, t, c_in, hidden, c_out):
    """K5 on the core at the flagship width (all 64800 tokens), the e2048
    width and two ragged T, against its plain version within MLP2_TOL (2, 0.02)
    bf16 ulps: the same rounding sites, so only the fp32 sum order differs,
    which now and then flips one rounding of pre, a or the fc2 product."""
    leaves = [x.to(cuda_device) for x in mlp_leaves(t, c_in, hidden, c_out, seed=7)]
    x2, w1, b1, w2, b2 = leaves
    before = mlp_kernels.mlp_fwd.launches
    out = mlp_kernels.mlp_fwd(x2, w1.bfloat16(), b1, w2.bfloat16(), b2)
    torch.cuda.synchronize()
    assert mlp_kernels.mlp_fwd.launches == before + 1
    ref = mlp_kernels.mlp_fwd_reference(x2, w1, b1, w2, b2).float().cpu().numpy()
    diff = np.abs(out.float().cpu().numpy() - ref)
    ulp = bf16_ulp(ref)
    assert diff.max() <= 2 * ulp and diff.mean() <= 0.02 * ulp, (diff.max() / ulp,
                                                                   diff.mean() / ulp)



# --------------------------------------------------------------------------
# on the GPU: every instance of K2's redesigned backward at every head dim
# --------------------------------------------------------------------------

K2_INSTANCES = ("v3", "bias", "padded", "v5", "v4", "v4_padded")


@pytest.mark.cuda
@pytest.mark.parametrize("instance", K2_INSTANCES)
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_k2_instance_matches_plain(cuda_device, instance, hd):
    """K2's backward (the projection and dx, dW on the GEMM core, the
    attention pass in mma registers) in each of its instances -- v3, the CPB
    bias (K7), the head pitch 128 (K10), v5 and v4 (K12) and v4's padded
    heads -- at head dims 32-128 (2 heads, L = 162, shifted; at head dim 128
    the streamed variant, which takes that head dim) against its
    plain version with the bounds the existing tests of each instance use
    (tests/test_torch_kernels.py: BWD_ULPS, dx (2, 0.05) for K12 and at head
    dim 128, the dscale bound), and two calls bit-equal."""
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45
    from test_torch_kernels import (BWD_ULPS, WINDOW, assert_close_ulps, assert_dscale_close,
                                    k12_operands)

    heads, h, w = 2, 18, 36
    c = heads * hd
    x, wq, bq, scale, g, mask = k12_operands(cuda_device, h, w, c, heads, seed=70 + hd)
    w16 = wq.bfloat16()
    grid = (h // WINDOW[0], w // WINDOW[1])
    l = WINDOW[0] * WINDOW[1]
    if instance == "v3":
        call = lambda: wa.window_attention_qkv_bwd(x, w16, bq, scale, g, WINDOW, mask, 1.0)
        ref = wa.window_attention_qkv_backward_reference(x, w16, bq, scale, g, WINDOW, mask)
    elif instance == "bias":
        raw = torch.from_numpy(np.random.default_rng(9).standard_normal((heads, l, l)).astype(
            np.float32)).to(cuda_device)
        badd = wa.fold_cpb_bias(2.0 * raw, scale)
        call = lambda: wa.window_attention_qkv_bias_bwd(x, w16, bq, scale, badd, g, WINDOW, mask,
                                                        1.0)
        ref = wa.window_attention_qkv_bias_backward_reference(x, w16, bq, scale, badd, g, WINDOW,
                                                              mask)
    elif instance == "padded":
        wp, bp = wa.pad_heads_w(wq, heads).bfloat16(), wa.pad_heads_vec(bq, heads)
        gp = torch.randn((1, h, w, heads * 128), device=cuda_device).bfloat16()
        call = lambda: wa.window_attention_qkv_padded_bwd(x, wp, bp, scale, hd, gp, WINDOW, mask,
                                                          1.0)
        ref = wa.window_attention_qkv_padded_backward_reference(x, wp, bp, scale, hd, gp, WINDOW,
                                                                mask)
    elif instance == "v5":
        w5 = v45.w5_reorder(w16, heads).contiguous()
        call = lambda: v45.window_attention_qkv5_bwd(x, w5, w16, bq, scale, g, WINDOW, mask, 1.0)
        ref = v45.window_attention_qkv5_backward_reference(x, w5, w16, bq, scale, g, WINDOW, mask)
    else:
        xw, gw = v45.window_major(x, WINDOW), v45.window_major(g, WINDOW)
        if instance == "v4":
            lead, bwd = (w16, bq, scale), v45.window_attention_qkv4_bwd
            ref_bwd = v45.window_attention_qkv4_backward_reference
        else:
            lead = (wa.pad_heads_w(w16, heads), wa.pad_heads_vec(bq, heads), scale, hd)
            gw = torch.randn((*gw.shape[:-1], heads * 128), device=cuda_device).bfloat16()
            gw[:, :, l:] = 0
            bwd = v45.window_attention_qkv4_padded_bwd
            ref_bwd = v45.window_attention_qkv4_padded_backward_reference
        call = lambda: bwd(xw, *lead, gw, WINDOW, grid, mask, 1.0)
        ref = ref_bwd(xw, *lead, gw, WINDOW, grid, mask)
    assert wa.qkv_variant("t", hd, l, True) == ("streamed" if hd == 128 else "base")
    grads = call()
    again = call()
    torch.cuda.synchronize()
    wide_dx = instance.startswith(("v4", "v5")) or hd == 128
    for name, a, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            bounds = (2, 0.05) if name == "dx" and wide_dx else BWD_ULPS[name]
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(), *bounds)
    assert all(torch.equal(a, r) for a, r in zip(grads, again))
