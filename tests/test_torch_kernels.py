"""PyTorch port, kernel modules: each plain version against the JAX kernel it
replaces (Pallas in interpret mode on the CPU; backward kernels through
``jax.vjp`` of the custom_vjps), the backward plain versions against an
unrounded fp64 autograd oracle, the CPU dispatch of the entry points and
autograd Functions, and -- on a GPU only -- each CUDA kernel against its plain
version and gradients flowing through the kernels. The kernels: window
attention (K1, K2, and K7, their CPB-bias instances), fc1 + GELU (K3, K4),
the whole MLP (K5, K6), the fused LayerNorm + drop-path + add (K11), and the
attention on pre-projected q, k, v of the grid route (K8) and the windowed
route (K9), each with its bias instance; then the e2048 widths (the
large-head variant of K1/K2/K7, K5's wide instance, K11 above 2048
channels), K10 and the micro model on v6 and the xla backward. The CPU
parity tests of K7, K11, K8, K9, K10 and the wide shapes are in
tests/test_torch_cpb.py, tests/test_torch_lnadd.py,
tests/test_torch_grid_attention.py, tests/test_torch_v1_attention.py,
tests/test_torch_qkv_variants.py and tests/test_torch_wide.py.

Tolerances are stated in bf16 ulps of the output scale: ``ulp(m)`` is the bf16
spacing at the largest reference magnitude ``m``. Both sides keep the same
rounding sites, so differences come only from the order of fp32 sums (and
rsqrt/erf evaluations), which now and then flips one bf16 rounding of an
intermediate (qkv, q16/k16, e16) or of the output. The max bound allows such
one-ulp flips; the mean bound, far tighter, shows they stay rare.

The JAX package is imported inside a fixture, so that the GPU cases also run
where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swin_v2_weather_torch.models.swin import make_shift_mask
from swin_v2_weather_torch.ops import ln_kernels, mlp_kernels, window_attention

torch.set_num_threads(1)

# window 9x18 (L = 162) on an 18x36 token grid: 2x2 windows, so the last
# window row (where the shift mask applies) and an unmasked row both exist
B, H, W, C, HEADS = 1, 18, 36, 64, 2
WINDOW = (9, 18)
SHIFT = (4, 9)
T, C_IN, HIDDEN = 96, 64, 256
C_OUT = 64  # the whole-MLP kernels' output width (C_OUT % 32 == 0)


def bf16_ulp(ref: np.ndarray) -> float:
    """bf16 spacing (8 significant bits) at the largest magnitude of ref."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def assert_close_ulps(out, ref, max_ulps, mean_ulps):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = bf16_ulp(ref)
    diff = np.abs(out - ref)
    assert diff.max() <= max_ulps * ulp, (diff.max(), max_ulps * ulp)
    assert diff.mean() <= mean_ulps * ulp, (diff.mean(), mean_ulps * ulp)


def attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    scale = np.exp(np.log(10.0) + 0.5 * rng.standard_normal(HEADS)).astype(np.float32)
    return x, w, b, scale


def mlp_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((T, C_IN)).astype(np.float32)
    w = (rng.standard_normal((C_IN, HIDDEN)) / np.sqrt(C_IN)).astype(np.float32)
    b = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    return x2, w, b


def whole_mlp_inputs(seed=2, t=T):
    """x2 [t, C_IN], w1, b1, w2 [HIDDEN, C_OUT], b2 and a cotangent g [t, C_OUT]."""
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((t, C_IN)).astype(np.float32)
    w1 = (rng.standard_normal((C_IN, HIDDEN)) / np.sqrt(C_IN)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    w2 = (rng.standard_normal((HIDDEN, C_OUT)) / np.sqrt(HIDDEN)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C_OUT)).astype(np.float32)
    g = rng.standard_normal((t, C_OUT)).astype(np.float32)
    return x2, w1, b1, w2, b2, g


def mask_pattern():
    return make_shift_mask((H, W), WINDOW, SHIFT)[-1]


def cotangent(seed=3):
    return np.random.default_rng(seed).standard_normal((B, H, W, C)).astype(np.float32)


def cpb_badd(seed=9):
    """A seeded raw CPB bias [HEADS, L, L], folded as the model folds it
    (row-max shift, minus the attention_inputs() scale): fp32."""
    l = WINDOW[0] * WINDOW[1]
    raw = 2.0 * np.random.default_rng(seed).standard_normal((HEADS, l, l))
    scale = torch.from_numpy(attention_inputs()[3])
    return window_attention.fold_cpb_bias(torch.from_numpy(raw.astype(np.float32)), scale)


def ln_inputs(t=T, c=256, seed=11, keep=0.9):
    """z, x [t, c], gamma, beta [c], m [t, 1] and a cotangent g [t, c], fp32;
    m mixes dropped rows (0), kept rows (1 / keep) and deterministic ones (1)."""
    rng = np.random.default_rng(seed)
    z = (2.0 * rng.standard_normal((t, c)) + 0.5).astype(np.float32)
    x = rng.standard_normal((t, c)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    u = rng.random(t)
    m = np.where(u < 0.3, 0.0, np.where(u < 0.8, np.float32(1.0) / np.float32(keep), 1.0))
    g = rng.standard_normal((t, c)).astype(np.float32)
    return z, x, gamma, beta, m.astype(np.float32).reshape(t, 1), g


# Backward tolerances, (max, mean) in bf16 ulps of the gradient's scale. The
# two sides differ by the order of fp32 sums, which now and then flips a bf16
# rounding of dqkv (or of the pre-activation cotangent); dW and db then sum
# that flip with hundreds of token rows. dscale is a sum over every query row
# of <qn16, dqn> with heavy cancellation, so its bound is absolute (plus 1 %).
BWD_ULPS = {"dx": (2, 0.01), "dW": (4, 0.05), "db": (4, 0.05),
            "dW1": (4, 0.05), "db1": (4, 0.05), "dW2": (4, 0.05), "db2": (4, 0.05),
            # K7's d(bias): fp32 ds / scale summed over the windows; a flipped
            # bf16 rounding of qkv or q16/k16 moves a few entries
            "dbias": (4, 0.05),
            # K8/K9: dq, dk, dv leave the kernels in bf16; a flipped bf16
            # rounding of p16 or dsb moves an entry by about an ulp
            "dq": (2, 0.02), "dk": (2, 0.02), "dv": (2, 0.02)}
DSCALE_TOL = dict(atol=4e-3, rtol=1e-2)


def assert_close_backward(name, out, ref):
    if name == "dscale":
        np.testing.assert_allclose(out, ref, **DSCALE_TOL)
    else:
        assert_close_ulps(out, ref, *BWD_ULPS[name])


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from swin_v2_weather_tpu.ops import mlp_kernels as jax_mlp
    from swin_v2_weather_tpu.ops import window_attention as jax_wa

    return SimpleNamespace(jnp=jnp, mlp=jax_mlp, wa=jax_wa)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_plain_matches_jax(jax_ref, dtype, use_mask):
    jnp = jax_ref.jnp
    x, w, b, scale = attention_inputs()
    patt = mask_pattern() if use_mask else None
    ref = jax_ref.wa.fused_window_attention_qkv(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b), jnp.asarray(scale),
        WINDOW, patt,
    )
    tdt = getattr(torch, dtype)
    out = window_attention.window_attention_qkv_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b),
        torch.from_numpy(scale), WINDOW, patt,
    )
    assert out.dtype == tdt and tuple(out.shape) == (B, H, W, C)
    # measured: max 1/4 ulp (one flipped bf16 intermediate), mean 1e-4 ulp
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 2, 0.01)


def test_window_attention_mask_and_flag_take_effect():
    x, w, b, scale = attention_inputs()
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            torch.from_numpy(scale), WINDOW)
    plain = window_attention.window_attention_qkv_reference(*args)
    masked = window_attention.window_attention_qkv_reference(*args, mask_pattern())
    gated = window_attention.window_attention_qkv_reference(
        *args, mask_pattern(), boundary_flag=0.0
    )
    # the mask changes the last window row only; flag 0 switches it off
    torch.testing.assert_close(masked[:, : WINDOW[0]], plain[:, : WINDOW[0]], rtol=0, atol=0)
    assert (masked[:, WINDOW[0]:] - plain[:, WINDOW[0]:]).abs().max() > 1e-2
    torch.testing.assert_close(gated, plain, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc1_gelu_plain_matches_jax(jax_ref, dtype):
    jnp = jax_ref.jnp
    x2, w, b = mlp_inputs()
    ref = jax_ref.mlp.fc1_gelu_pallas(jnp.asarray(x2, dtype), jnp.asarray(w), jnp.asarray(b))
    tdt = getattr(torch, dtype)
    out = mlp_kernels.fc1_gelu_reference(
        torch.from_numpy(x2).to(tdt), torch.from_numpy(w), torch.from_numpy(b)
    )
    assert out.dtype == tdt and tuple(out.shape) == (T, HIDDEN)
    # the JAX kernel's erf (Abramowitz-Stegun, |err| <= 1.5e-7) differs from
    # torch.erf far below bf16 resolution; measured max 1/64 ulp in fp32
    # (sum order), one flipped bf16 rounding in bf16
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 1, 0.01)


def attention_leaves(dtype, seed=0):
    tdt = getattr(torch, dtype)
    x, w, b, scale = attention_inputs(seed)
    return [torch.from_numpy(x).to(tdt).requires_grad_(), torch.from_numpy(w).to(tdt).requires_grad_(),
            torch.from_numpy(b).requires_grad_(), torch.from_numpy(scale).requires_grad_()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_backward_matches_jax(jax_ref, dtype, use_mask):
    """dx, dW, db, dscale of the port's Function (plain backward on the CPU)
    against jax.vjp of the JAX entry point, whose custom_vjp runs the fused
    Pallas backward (_qkv_backward) in interpret mode. Measured: dx max 1/4
    ulp, dW max 1 ulp (bf16) / 0.05 ulp (fp32), dscale max 1.1e-3."""
    import jax

    jnp = jax_ref.jnp
    x, w, b, scale = attention_inputs()
    ct = cotangent()
    patt = mask_pattern() if use_mask else None
    _, vjp = jax.vjp(
        lambda *a: jax_ref.wa.fused_window_attention_qkv(*a, WINDOW, patt),
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b), jnp.asarray(scale),
    )
    ref = vjp(jnp.asarray(ct, dtype))
    leaves = attention_leaves(dtype)
    out = window_attention.fused_window_attention_qkv(*leaves, WINDOW, patt)
    out.backward(torch.from_numpy(ct).to(getattr(torch, dtype)))
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype and str(r.dtype) == str(leaf.dtype).split(".")[1]
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def unrounded_attention(x, w, b, scale, patt):
    """The attention in fp64 without any bf16 rounding (the JAX XLA
    composition's math), for autograd."""
    from swin_v2_weather_torch.models.swin import window_partition, window_reverse

    l, hd = WINDOW[0] * WINDOW[1], C // HEADS
    qkv = window_partition(x @ w + b, WINDOW).reshape(-1, l, 3, HEADS, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    z = (q @ k.transpose(-1, -2) - 1.0) * scale.reshape(1, HEADS, 1, 1)
    if patt is not None:
        nwh, nww = H // WINDOW[0], W // WINDOW[1]
        gate = torch.zeros(nwh, dtype=z.dtype)
        gate[-1] = 1.0
        z = z.reshape(B, nwh, nww, HEADS, l, l) + gate.reshape(1, nwh, 1, 1, 1, 1) * torch.from_numpy(
            patt).double()
        z = z.reshape(-1, HEADS, l, l)
    out = (torch.softmax(z, -1) @ v).permute(0, 2, 1, 3).reshape(-1, *WINDOW, C)
    return window_reverse(out, WINDOW, (H, W))


@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_backward_matches_unrounded_oracle(use_mask):
    """The plain backward against autograd through the unrounded fp64 math,
    as tests/test_window_attention.py holds the Pallas backward to the XLA
    composition. The kernel's bf16 sites (qkv, qn/kn, p, ds, dqkv) bound the
    agreement: measured max 0.8 % of the gradient scale for dx, dW and db and
    4 % for dscale, a sum with cancellation; the bounds are 3 % and 10 %."""
    patt = mask_pattern() if use_mask else None
    ct = torch.from_numpy(cotangent())
    leaves = attention_leaves("float32")
    window_attention.fused_window_attention_qkv(*leaves, WINDOW, patt).backward(ct)
    oracle = [t.detach().double().requires_grad_() for t in leaves]
    unrounded_attention(*oracle, patt).backward(ct.double())
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), leaves, oracle):
        ref = r.grad.numpy()
        bound = (0.1 if name == "dscale" else 0.03) * np.abs(ref).max()
        assert np.abs(leaf.grad.double().numpy() - ref).max() <= bound, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc1_backward_matches_jax(jax_ref, dtype):
    """K4's plain version against fc1_dpre_pallas (interpret mode), and the
    Function's dx, dW, db against jax.vjp of the JAX fused_fc1_gelu. dW and
    db come back fp32 and unrounded, as JAX's do."""
    import jax

    jnp = jax_ref.jnp
    x2, w, b = mlp_inputs()
    gm = np.random.default_rng(5).standard_normal((T, HIDDEN)).astype(np.float32)
    tdt = getattr(torch, dtype)
    dpre_ref = jax_ref.mlp.fc1_dpre_pallas(
        jnp.asarray(x2, dtype), jnp.asarray(w), jnp.asarray(b), jnp.asarray(gm, dtype)
    )
    dpre = mlp_kernels.fc1_dpre_reference(
        torch.from_numpy(x2).to(tdt), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(gm).to(tdt),
    )
    assert dpre.dtype == tdt
    # erf differs below bf16 resolution; in bf16 a flipped pre-activation
    # rounding moves g * gelu' by about one ulp
    assert_close_ulps(dpre.float().numpy(), np.asarray(dpre_ref, np.float32), 2, 0.01)

    _, vjp = jax.vjp(jax_ref.mlp.fused_fc1_gelu, jnp.asarray(x2, dtype), jnp.asarray(w),
                     jnp.asarray(b))
    ref = vjp(jnp.asarray(gm, dtype))
    leaves = [torch.from_numpy(x2).to(tdt).requires_grad_(), torch.from_numpy(w).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    mlp_kernels.fused_fc1_gelu(*leaves).backward(torch.from_numpy(gm).to(tdt))
    assert [t.grad.dtype for t in leaves] == [tdt, torch.float32, torch.float32]
    for name, leaf, r in zip(("dx", "dW1", "db1"), leaves, ref):
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))
    # dW is the fp32 product of the (rounded) operands, not rounded to bf16
    want = x2.astype(np.float64) if dtype == "float32" else (
        torch.from_numpy(x2).bfloat16().double().numpy())
    exact = want.T @ dpre.double().numpy()
    np.testing.assert_allclose(leaves[1].grad.numpy(), exact, rtol=1e-5, atol=1e-5)
    assert not torch.equal(leaves[1].grad, leaves[1].grad.bfloat16().float())


def test_cpu_functions_return_the_plain_backward():
    """On CPU tensors both autograd Functions return exactly what the plain
    backward versions compute (with the Functions' dtype casts)."""
    x, w, b, scale = attention_inputs()
    ct = torch.from_numpy(cotangent()).bfloat16()
    leaves = attention_leaves("bfloat16")
    window_attention.fused_window_attention_qkv(*leaves, WINDOW, mask_pattern()).backward(ct)
    ref = window_attention.window_attention_qkv_backward_reference(
        *(t.detach() for t in leaves), ct, WINDOW, mask_pattern()
    )
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.to(leaf.dtype), rtol=0, atol=0)

    x2, w1, b1 = (torch.from_numpy(a) for a in mlp_inputs())
    gm = torch.from_numpy(np.random.default_rng(5).standard_normal((T, HIDDEN))).bfloat16()
    leaves = [x2.bfloat16().requires_grad_(), w1.clone().requires_grad_(), b1.clone().requires_grad_()]
    mlp_kernels.fused_fc1_gelu(*leaves).backward(gm)
    dpre = mlp_kernels.fc1_dpre_reference(leaves[0].detach(), w1, b1, gm)
    torch.testing.assert_close(
        leaves[0].grad, (dpre.float() @ w1.bfloat16().float().t()).bfloat16(), rtol=0, atol=0
    )
    torch.testing.assert_close(leaves[1].grad, leaves[0].detach().float().t() @ dpre.float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(leaves[2].grad, dpre.float().sum(0), rtol=0, atol=0)


def test_cpu_entry_points_take_the_plain_versions():
    x, w, b, scale = attention_inputs()
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            torch.from_numpy(scale), WINDOW, mask_pattern())
    torch.testing.assert_close(
        window_attention.fused_window_attention_qkv(*args),
        window_attention.window_attention_qkv_reference(*args), rtol=0, atol=0,
    )
    x2, w1, b1 = (torch.from_numpy(a) for a in mlp_inputs())
    x4 = x2.reshape(2, 3, 16, C_IN).to(torch.bfloat16)
    y = mlp_kernels.fused_fc1_gelu(x4, w1, b1)
    assert tuple(y.shape) == (2, 3, 16, HIDDEN)
    torch.testing.assert_close(
        y.reshape(T, HIDDEN), mlp_kernels.fc1_gelu_reference(x4.reshape(T, C_IN), w1, b1),
        rtol=0, atol=0,
    )


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor: only the entry points
    dispatch, and a CPU tensor there takes the plain version."""
    x, w, b, scale = (torch.from_numpy(a) for a in attention_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        window_attention.window_attention_qkv(x.bfloat16(), w.bfloat16(), b, scale, WINDOW)
    with pytest.raises(ValueError, match="CUDA"):
        window_attention.window_attention_qkv_bwd(
            x.bfloat16(), w.bfloat16(), b, scale, x.bfloat16(), WINDOW
        )
    x2, w1, b1 = (torch.from_numpy(a) for a in mlp_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        mlp_kernels.fc1_gelu(x2.bfloat16(), w1.bfloat16(), b1)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_kernels.fc1_dpre(x2.bfloat16(), w1.bfloat16(), b1, x2.bfloat16())


def test_entry_point_refuses_cpb_bias():
    """The entry point takes a CPB bias of shape [heads, L, L] (K7's route,
    tests/test_torch_cpb.py) and refuses any other shape."""
    x, w, b, scale = (torch.from_numpy(a) for a in attention_inputs())
    l = WINDOW[0] * WINDOW[1]
    for shape in ((HEADS, l, l + 1), (HEADS + 1, l, l), (l, l)):
        with pytest.raises(ValueError, match="CPB"):
            window_attention.fused_window_attention_qkv(
                x, w, b, scale, WINDOW, bias=torch.zeros(shape)
            )
    out = window_attention.fused_window_attention_qkv(
        x, w, b, scale, WINDOW, bias=torch.zeros(HEADS, l, l))
    assert tuple(out.shape) == (B, H, W, C)


# --------------------------------------------------------------------------
# the whole-MLP pair (K5, K6)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_mlp_plain_matches_jax(jax_ref, dtype):
    """K5's plain version against mlp_fwd_pallas and K6's against
    mlp_bwd_pallas (interpret mode), same inputs. Both sides round at the same
    sites (pre, a, the fc2 product, then + b2 in the compute dtype), so only
    the fp32 sum order and the erf evaluation differ, and a flipped rounding
    of pre or a would move an output by about one ulp. Measured: no flip at
    this size, max 5e-4 ulp in either dtype; the bounds allow flips."""
    jnp = jax_ref.jnp
    x2, w1, b1, w2, b2, g = whole_mlp_inputs()
    tdt = getattr(torch, dtype)
    ref = jax_ref.mlp.mlp_fwd_pallas(jnp.asarray(x2, dtype), jnp.asarray(w1), jnp.asarray(b1),
                                     jnp.asarray(w2), jnp.asarray(b2))
    out = mlp_kernels.mlp_fwd_reference(torch.from_numpy(x2).to(tdt), torch.from_numpy(w1),
                                        torch.from_numpy(b1), torch.from_numpy(w2),
                                        torch.from_numpy(b2))
    assert out.dtype == tdt and tuple(out.shape) == (T, C_OUT)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 2, 0.02)

    a_ref, dpre_ref = jax_ref.mlp.mlp_bwd_pallas(
        jnp.asarray(x2, dtype), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(g, dtype))
    a, dpre = mlp_kernels.mlp_bwd_reference(
        torch.from_numpy(x2).to(tdt), torch.from_numpy(w1), torch.from_numpy(b1),
        torch.from_numpy(w2), torch.from_numpy(g).to(tdt))
    assert a.dtype == dpre.dtype == tdt and tuple(a.shape) == tuple(dpre.shape) == (T, HIDDEN)
    assert_close_ulps(a.float().numpy(), np.asarray(a_ref, np.float32), 1, 0.01)
    assert_close_ulps(dpre.float().numpy(), np.asarray(dpre_ref, np.float32), 2, 0.01)


def whole_mlp_leaves(dtype, seed=2):
    tdt = getattr(torch, dtype)
    x2, w1, b1, w2, b2, g = whole_mlp_inputs(seed)
    leaves = [torch.from_numpy(x2).to(tdt)] + [torch.from_numpy(a) for a in (w1, b1, w2, b2)]
    return [t.requires_grad_() for t in leaves], torch.from_numpy(g).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_mlp_backward_matches_jax(jax_ref, dtype):
    """The five gradients of FusedMlp (K6's plain version + five plain
    products) against jax.vjp of the JAX fused_mlp, whose custom_vjp runs
    mlp_bwd_pallas in interpret mode. dx leaves in x's dtype, the weight and
    bias gradients in fp32 and unrounded, as JAX's do."""
    import jax

    jnp = jax_ref.jnp
    x2, w1, b1, w2, b2, g = whole_mlp_inputs()
    _, vjp = jax.vjp(jax_ref.mlp.fused_mlp, jnp.asarray(x2, dtype), *map(jnp.asarray, (w1, b1, w2, b2)))
    ref = vjp(jnp.asarray(g, dtype))
    leaves, gt = whole_mlp_leaves(dtype)
    out = mlp_kernels.fused_mlp(*leaves)
    assert out.dtype == leaves[0].dtype
    out.backward(gt)
    assert [t.grad.dtype for t in leaves] == [leaves[0].dtype] + [torch.float32] * 4
    for name, leaf, r in zip(("dx", "dW1", "db1", "dW2", "db2"), leaves, ref):
        assert str(r.dtype) == str(leaf.grad.dtype).split(".")[1], name
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))
    # dW2 is the fp32 product of the rounded activation and cotangent, not rounded
    a, _ = mlp_kernels.mlp_bwd_reference(*(t.detach() for t in leaves[:2]), leaves[2].detach(),
                                         leaves[3].detach(), gt)
    np.testing.assert_allclose(leaves[3].grad.numpy(), a.double().numpy().T @ gt.double().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not torch.equal(leaves[3].grad, leaves[3].grad.bfloat16().float())


def test_whole_mlp_backward_matches_unrounded_oracle():
    """FusedMlp in fp32 against autograd through the unrounded fp64 MLP
    (gelu(x w1 + b1) w2 + b2). In fp32 compute nothing rounds to bf16, so the
    agreement is that of fp32 sums: measured at most 7.1e-7 of a gradient's
    scale, bound 1e-5."""
    leaves, g = whole_mlp_leaves("float32")
    mlp_kernels.fused_mlp(*leaves).backward(g)
    oracle = [t.detach().double().requires_grad_() for t in leaves]
    x, w1, b1, w2, b2 = oracle
    (torch.nn.functional.gelu(x @ w1 + b1) @ w2 + b2).backward(g.double())
    for name, leaf, r in zip(("dx", "dW1", "db1", "dW2", "db2"), leaves, oracle):
        ref = r.grad.numpy()
        assert np.abs(leaf.grad.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name


def test_whole_mlp_cpu_dispatch():
    """On CPU tensors the entry point and the Function return exactly what the
    plain versions compute, for x of any leading shape; the kernel wrappers
    refuse CPU tensors."""
    leaves, g = whole_mlp_leaves("bfloat16")
    x4 = leaves[0].detach().reshape(2, 3, 16, C_IN)
    y = mlp_kernels.fused_mlp(x4, *(t.detach() for t in leaves[1:]))
    assert tuple(y.shape) == (2, 3, 16, C_OUT)
    args = [t.detach() for t in leaves]
    torch.testing.assert_close(y.reshape(T, C_OUT), mlp_kernels.mlp_fwd_reference(*args),
                               rtol=0, atol=0)
    mlp_kernels.fused_mlp(*leaves).backward(g)
    a, dpre = mlp_kernels.mlp_bwd_reference(*args[:4], g)
    x2, w1 = args[0], args[1]
    want = [(dpre.float() @ w1.bfloat16().float().t()).bfloat16(), x2.float().t() @ dpre.float(),
            dpre.float().sum(0), a.float().t() @ g.float(), g.float().sum(0)]
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    w16 = [t.bfloat16() if t.dim() == 2 else t for t in args[1:]]
    with pytest.raises(ValueError, match="CUDA"):
        mlp_kernels.mlp_fwd(args[0], *w16)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_kernels.mlp_bwd(args[0], *w16[:3], g)


# --------------------------------------------------------------------------
# on the GPU: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_kernel_matches_plain(cuda_device, use_mask):
    x, w, b, scale = (torch.from_numpy(a).to(cuda_device) for a in attention_inputs())
    x = x.bfloat16()
    mask = torch.from_numpy(mask_pattern()).to(cuda_device) if use_mask else None
    before = window_attention.window_attention_qkv.launches
    out = window_attention.window_attention_qkv(
        x, w.bfloat16(), b, scale, WINDOW, mask, 1.0
    )
    torch.cuda.synchronize()
    assert window_attention.window_attention_qkv.launches == before + 1
    ref = window_attention.window_attention_qkv_reference(x, w, b, scale, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)


@pytest.mark.cuda
def test_fc1_gelu_kernel_matches_plain(cuda_device):
    # T = 100 is not a multiple of the 128-row tile: the ragged edge is masked
    x2, w, b = (torch.from_numpy(a).to(cuda_device) for a in mlp_inputs())
    x2 = torch.cat([x2, x2[:4]]).bfloat16()
    before = mlp_kernels.fc1_gelu.launches
    out = mlp_kernels.fc1_gelu(x2, w.bfloat16(), b)
    torch.cuda.synchronize()
    assert mlp_kernels.fc1_gelu.launches == before + 1
    ref = mlp_kernels.fc1_gelu_reference(x2, w, b)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 1, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_bwd_kernel_matches_plain(cuda_device, use_mask):
    x, w, b, scale = (torch.from_numpy(a).to(cuda_device) for a in attention_inputs())
    g = torch.from_numpy(cotangent()).to(cuda_device).bfloat16()
    x, w16 = x.bfloat16(), w.bfloat16()
    mask = torch.from_numpy(mask_pattern()).to(cuda_device) if use_mask else None
    before = window_attention.window_attention_qkv_bwd.launches
    out = window_attention.window_attention_qkv_bwd(x, w16, b, scale, g, WINDOW, mask, 1.0)
    torch.cuda.synchronize()
    assert window_attention.window_attention_qkv_bwd.launches == before + 1
    ref = window_attention.window_attention_qkv_backward_reference(
        x, w16, b, scale, g, WINDOW, mask
    )
    assert out[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in out[1:])
    for name, a, r in zip(("dx", "dW", "db", "dscale"), out, ref):
        assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    # dW, db and dscale are reduced in a fixed order: a second call gives the same bits
    again = window_attention.window_attention_qkv_bwd(x, w16, b, scale, g, WINDOW, mask, 1.0)
    for a, r in zip(out, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_fc1_dpre_kernel_matches_plain(cuda_device):
    x2, w, b = (torch.from_numpy(a).to(cuda_device) for a in mlp_inputs())
    x2 = torch.cat([x2, x2[:4]]).bfloat16()  # T = 100: ragged last tile
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((100, HIDDEN))).to(
        cuda_device).bfloat16()
    before = mlp_kernels.fc1_dpre.launches
    out = mlp_kernels.fc1_dpre(x2, w.bfloat16(), b, g)
    torch.cuda.synchronize()
    assert mlp_kernels.fc1_dpre.launches == before + 1
    ref = mlp_kernels.fc1_dpre_reference(x2, w, b, g)
    # a flipped bf16 pre-activation moves g * gelu' by up to |g| * 1.13 ulp of
    # pre, plus the output rounding
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)


@pytest.mark.cuda
def test_gradients_flow_through_the_kernels(cuda_device):
    """Autograd on CUDA tensors runs K1/K3 forward and K2/K4 backward, and the
    gradients (with their JAX dtypes) match the same Functions on the CPU,
    which take the plain versions."""
    x, w, b, scale = (torch.from_numpy(a) for a in attention_inputs())
    g = torch.from_numpy(cotangent()).bfloat16()
    mask = torch.from_numpy(mask_pattern())

    def attn_grads(dev):
        leaves = [x.bfloat16().to(dev), w.bfloat16().to(dev), b.to(dev), scale.to(dev)]
        leaves = [t.requires_grad_() for t in leaves]
        out = window_attention.fused_window_attention_qkv(*leaves, WINDOW, mask.to(dev))
        out.backward(g.to(dev))
        return [t.grad.cpu() for t in leaves]

    launches = window_attention.window_attention_qkv_bwd.launches
    got, want = attn_grads(cuda_device), attn_grads(torch.device("cpu"))
    assert window_attention.window_attention_qkv_bwd.launches == launches + 1
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]
    for name, a, r in zip(("dx", "dW", "db", "dscale"), got, want):
        assert_close_backward(name, a.float().numpy(), r.float().numpy())

    x2, w1, b1 = (torch.from_numpy(a) for a in mlp_inputs())
    gm = torch.from_numpy(np.random.default_rng(5).standard_normal((T, HIDDEN))).bfloat16()

    def mlp_grads(dev):
        leaves = [x2.bfloat16().to(dev), w1.to(dev), b1.to(dev)]
        leaves = [t.requires_grad_() for t in leaves]
        mlp_kernels.fused_fc1_gelu(*leaves).backward(gm.to(dev))
        return [t.grad.cpu() for t in leaves]

    launches = mlp_kernels.fc1_dpre.launches
    got, want = mlp_grads(cuda_device), mlp_grads(torch.device("cpu"))
    assert mlp_kernels.fc1_dpre.launches == launches + 1
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for name, a, r in zip(("dx", "dW1", "db1"), got, want):
        assert_close_backward(name, a.float().numpy(), r.float().numpy())


@pytest.mark.cuda
def test_window_attention_kernel_batch_and_head_dim(cuda_device):
    """Batch 2 and head dim 64 (another template instance), shifted."""
    rng = np.random.default_rng(7)
    b, c, heads = 2, 128, 2
    x = torch.from_numpy(rng.standard_normal((b, H, W, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32))
    scale = torch.full((heads,), 10.0)
    x, w, bias, scale = (t.to(cuda_device) for t in (x, w, bias, scale))
    mask = torch.from_numpy(mask_pattern()).to(cuda_device)
    out = window_attention.fused_window_attention_qkv(x.bfloat16(), w, bias, scale, WINDOW, mask)
    ref = window_attention.window_attention_qkv_reference(x.bfloat16(), w, bias, scale, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)


@pytest.mark.cuda
def test_micro_model_kernel_path_matches_cpu_plain_path(cuda_device):
    """The micro config on the GPU (window 2x4: L = 8 pads to one 16-row
    tile) through both kernels, against the same model on the CPU, which takes
    the plain versions. bf16 rounding flips between cuBLAS and the CPU GEMMs
    add to the kernels' own; the bound is the one chip_smoke.py uses for the
    flagship (8 ulps max, 0.5 mean)."""
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.models.wrappers import get_model

    p = YParams(default_config_path(), "swin_micro_test")
    p["attn_impl"] = "pallas_qkv"
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    torch.manual_seed(0)
    model = get_model(p, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            noise = torch.randn(prm.shape, generator=gen)
            if name.endswith("norm1.weight") or name.endswith("norm2.weight"):
                prm.copy_(1.0 + 0.1 * noise)  # non-zero: blocks are not the identity
    x = torch.randn((1, p["n_in_channels"], *p.img_size), generator=gen)
    with torch.inference_mode():
        ref = model(x)
        launches = (window_attention.window_attention_qkv.launches, mlp_kernels.fc1_gelu.launches)
        out = model.to(cuda_device)(x.to(cuda_device)).cpu()
    assert window_attention.window_attention_qkv.launches == launches[0] + 2
    assert mlp_kernels.fc1_gelu.launches == launches[1] + 2
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)


@pytest.mark.cuda
def test_whole_mlp_kernels_match_plain(cuda_device):
    """K5 and K6 at a ragged T (100 is not a multiple of their 128-row
    tiles) against their plain versions on the card:
    one flipped bf16 rounding of pre or a moves an output by about an ulp."""
    x2, w1, b1, w2, b2, g = (torch.from_numpy(a).to(cuda_device)
                             for a in whole_mlp_inputs(t=100))
    x2, g = x2.bfloat16(), g.bfloat16()
    launches = (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches)
    out = mlp_kernels.mlp_fwd(x2, w1.bfloat16(), b1, w2.bfloat16(), b2)
    a, dpre = mlp_kernels.mlp_bwd(x2, w1.bfloat16(), b1, w2.bfloat16(), g)
    torch.cuda.synchronize()
    assert (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = mlp_kernels.mlp_fwd_reference(x2, w1, b1, w2, b2)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.02)
    a_ref, dpre_ref = mlp_kernels.mlp_bwd_reference(x2, w1, b1, w2, g)
    assert_close_ulps(a.float().cpu().numpy(), a_ref.float().cpu().numpy(), 1, 0.01)
    assert_close_ulps(dpre.float().cpu().numpy(), dpre_ref.float().cpu().numpy(), 2, 0.01)


@pytest.mark.cuda
def test_whole_mlp_gradients_flow_through_the_kernels(cuda_device):
    """Autograd on CUDA tensors runs K5 forward and K6 backward, and the five
    gradients (with their JAX dtypes) match the same Function on the CPU."""
    leaves, g = whole_mlp_leaves("bfloat16")

    def grads(dev):
        ls = [t.detach().to(dev).requires_grad_() for t in leaves]
        mlp_kernels.fused_mlp(*ls).backward(g.to(dev))
        return [t.grad.cpu() for t in ls]

    launches = (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches)
    got, want = grads(cuda_device), grads(torch.device("cpu"))
    assert (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 4
    for name, a, r in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        assert_close_backward(name, a.float().numpy(), r.float().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [False, True])
def test_window_attention_bias_kernels_match_plain(cuda_device, use_mask):
    """K7 forward and backward (the CPB-bias instances of K1/K2) against their
    plain versions on the card, with a seeded bias folded as the model folds
    it; K1 and K2 do not launch. The backward twice gives the same bits, d(bias)
    included: its per-(window, head) partials are summed in window order."""
    x, w, b, scale = (torch.from_numpy(a).to(cuda_device) for a in attention_inputs())
    x, w16 = x.bfloat16(), w.bfloat16()
    g = torch.from_numpy(cotangent()).to(cuda_device).bfloat16()
    badd = cpb_badd().to(cuda_device)
    mask = torch.from_numpy(mask_pattern()).to(cuda_device) if use_mask else None
    fns = (window_attention.window_attention_qkv_bias, window_attention.window_attention_qkv_bias_bwd,
           window_attention.window_attention_qkv, window_attention.window_attention_qkv_bwd)
    before = [f.launches for f in fns]
    out = window_attention.window_attention_qkv_bias(x, w16, b, scale, badd, WINDOW, mask, 1.0)
    grads = window_attention.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, g, WINDOW, mask,
                                                            1.0)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [before[0] + 1, before[1] + 1, before[2], before[3]]
    ref = window_attention.window_attention_qkv_bias_reference(x, w, b, scale, badd, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = window_attention.window_attention_qkv_bias_backward_reference(
        x, w16, b, scale, badd, g, WINDOW, mask)
    assert grads[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads[1:])
    for name, a, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref_grads):
        assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    again = window_attention.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, g, WINDOW, mask,
                                                            1.0)
    for a, r in zip(grads, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("t, c", [(100, 256), (2600, 768), (100, 4096), (2600, 2176),
                                  (2600, 3072)])
def test_ln_dp_add_kernels_match_plain(cuda_device, t, c):
    """K11 forward and backward against their plain versions on the card, at a
    ragged row count (not a multiple of a block's 8 rows), the flagship width
    and rows wider than 2048 (the streamed entry points; the backward's
    two-stage ring at 8, 6 and 8 rows a stage, several stages a block at
    T = 2600), with m mixed between 0, 1 and 1/keep. Both sides round at the same
    sites; the statistics' fp32 sums differ in order, which now and then flips
    one bf16 rounding (1 ulp). dgamma/dbeta are fp32 sums over the rows in
    another order (rtol 1e-5). Two backward calls give the same bits."""
    z, x, gamma, beta, m, g = (torch.from_numpy(a).to(cuda_device)
                               for a in ln_inputs(t=t, c=c))
    z, x, g = z.bfloat16(), x.bfloat16(), g.bfloat16()
    before = (ln_kernels.ln_dp_add_fwd.launches, ln_kernels.ln_dp_add_bwd.launches)
    out = ln_kernels.ln_dp_add_fwd(z, x, gamma, beta, m)
    dz, dgamma, dbeta = ln_kernels.ln_dp_add_bwd(z, g, gamma, m)
    torch.cuda.synchronize()
    assert (ln_kernels.ln_dp_add_fwd.launches, ln_kernels.ln_dp_add_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = ln_kernels.ln_dp_add_fwd_reference(z, x, gamma, beta, m)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 1, 0.01)
    rdz, rdg, rdb = ln_kernels.ln_dp_add_bwd_reference(z, g, gamma, m)
    assert dz.dtype == torch.bfloat16 and dgamma.dtype == dbeta.dtype == torch.float32
    assert_close_ulps(dz.float().cpu().numpy(), rdz.float().cpu().numpy(), 1, 0.01)
    for a, r in ((dgamma, rdg), (dbeta, rdb)):
        r = r.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    again = ln_kernels.ln_dp_add_bwd(z, g, gamma, m)
    for a, r in zip((dz, dgamma, dbeta), again):
        assert torch.equal(a, r)


def micro_model_cpu_and_gpu(dev, over, fns):
    """The micro config with the overrides ``over`` on seeded noise weights
    (LayerNorm scales 1 + 0.1 N), forward and an eval-mode backward of
    sum(out * ct) on the CPU (plain versions), then on ``dev`` (kernels):
    (cpu out, cpu grads, gpu out, gpu grads, depth, launches of ``fns`` in
    the GPU run)."""
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.models.wrappers import get_model

    p = YParams(default_config_path(), "swin_micro_test")
    for k, v in over.items():
        p[k] = v
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    model = get_model(p, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            noise = torch.randn(prm.shape, generator=gen)
            if name.endswith("norm1.weight") or name.endswith("norm2.weight"):
                prm.copy_(1.0 + 0.1 * noise)
            elif prm.dim() == 2:
                prm.copy_(noise / np.sqrt(prm.shape[1]))
            else:
                prm.copy_(0.1 * noise)
    x = torch.randn((1, p["n_in_channels"], *p.img_size), generator=gen)
    ct = torch.randn((1, p["n_out_channels"], *p.img_size), generator=gen)

    def run(m, d):
        m.zero_grad()
        out = m(x.to(d))
        torch.sum(out * ct.to(d)).backward()
        return out.detach().cpu(), {n: q.grad.detach().cpu().clone() for n, q in m.named_parameters()}

    ref, ref_grads = run(model, torch.device("cpu"))
    before = [f.launches for f in fns]
    out, grads = run(model.to(dev), dev)
    launches = [f.launches - b for f, b in zip(fns, before)]
    return ref, ref_grads, out, grads, len(model.model.blocks), launches


def assert_micro_grads_close(ref_grads, grads, noisy=()):
    """Per leaf max 15 %, mean 8 % of the leaf's scale (the bf16 bounds of the
    port-against-JAX gradient test); leaves named in ``noisy`` (sums with
    heavy cancellation) are held to 15 % in the mean too. meta_mlp.fc2.bias,
    whose exact gradient is 0, is rounding noise on both sides and is held to
    2 % of the fc2 weight gradient's scale, as in tests/test_torch_cpb.py."""
    errs = {}
    for name, gr in ref_grads.items():
        r, got = gr.float().numpy(), grads[name].float().numpy()
        if name.endswith("meta_mlp.fc2.bias"):
            scale = np.abs(ref_grads[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(r).max(), np.abs(got).max()) <= 0.02 * scale, name
            continue
        d = np.abs(got - r)
        errs[name] = (d.max() / np.abs(r).max(), d.mean() / np.abs(r).max())
    assert all(e[0] <= 0.15 and e[1] <= (0.15 if any(k in n for k in noisy) else 0.08)
               for n, e in errs.items()), errs


@pytest.mark.cuda
def test_cpb_lnadd_micro_model_kernel_path_matches_cpu_plain_path(cuda_device):
    """The micro config with the CPB (``rel_pos``, K7) and the fused LayerNorm
    route (``lnadd_impl: fused``, K11; embed 128 so that its shape condition
    holds) on the GPU against the same model on the CPU, which takes the
    plain versions: the eval forward (bound of the bias-free micro test, 8
    ulps max, 0.5 mean) and the parameter gradients of an eval-mode backward
    (``assert_micro_grads_close``). K1 and K2 never launch."""
    over = dict(attn_impl="pallas_qkv", rel_pos=True, full_pos_embed=False,
                lnadd_impl="fused", embed_dim=128)
    fns = (window_attention.window_attention_qkv_bias, window_attention.window_attention_qkv_bias_bwd,
           ln_kernels.ln_dp_add_fwd, ln_kernels.ln_dp_add_bwd,
           window_attention.window_attention_qkv, window_attention.window_attention_qkv_bwd)
    ref, ref_grads, out, grads, depth, launches = micro_model_cpu_and_gpu(cuda_device, over, fns)
    assert launches == [depth, depth, 2 * depth, 2 * depth, 0, 0]
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)
    assert_micro_grads_close(ref_grads, grads)


# --------------------------------------------------------------------------
# K8 (grid route) and K9 (windowed route) on the GPU
# --------------------------------------------------------------------------

WA = window_attention
QKV_KERNELS = (WA.window_attention_grid, WA.window_attention_grid_bwd,
               WA.window_attention_grid_bias, WA.window_attention_grid_bias_bwd,
               WA.window_attention_v1, WA.window_attention_v1_bwd,
               WA.window_attention_v1_bias, WA.window_attention_v1_bias_bwd,
               WA.window_attention_qkv, WA.window_attention_qkv_bwd,
               WA.window_attention_qkv_bias, WA.window_attention_qkv_bias_bwd)


def launch_counts():
    return [f.launches for f in QKV_KERNELS]


def qkv_operands(dev, layout, b=B, h=H, w=W, c=C, heads=HEADS, window=WINDOW, seed=21):
    """Seeded bf16 operands of K8 ("grid": qn, kn normalized per head, v a
    channel slice of a [b, h, w, 3c] tensor, read in place) or K9
    ("windowed": q, k, v [b * nW, heads, L, c / heads]), an fp32 scale, raw
    bias [heads, L, L] and a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    l = window[0] * window[1]
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal((heads, l, l)).astype(np.float32)).to(dev)
    if layout == "grid":
        qkv = torch.from_numpy(rng.standard_normal((b, h, w, 3 * c)).astype(np.float32))
        qkv = qkv.to(dev).bfloat16()
        qn, _ = WA.normalize_heads(qkv[..., :c], heads)
        kn, _ = WA.normalize_heads(qkv[..., c:2 * c], heads)
        ops = (qn, kn, qkv[..., 2 * c:])
        gshape = (b, h, w, c)
    else:
        bw = b * (h // window[0]) * (w // window[1])
        gshape = (bw, heads, l, c // heads)
        ops = tuple(torch.from_numpy(rng.standard_normal(gshape).astype(np.float32)).to(
            dev).bfloat16() for _ in range(3))
    g = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32)).to(dev).bfloat16()
    return (*ops, scale, bias, g)


def check_qkv_kernels(dev, layout, use_bias, use_mask, **shape):
    """K8 or K9 (bias-free or BIAS) forward and backward against their plain
    versions on the card; exactly their own wrappers launch; two backward
    calls give the same bits."""
    q, k, v, scale, bias, g = qkv_operands(dev, layout, **shape)
    window = shape.get("window", WINDOW)
    h, w = shape.get("h", H), shape.get("w", W)
    mask = None
    if use_mask:
        shift = (window[0] // 2, window[1] // 2)
        mask = torch.from_numpy(make_shift_mask((h, w), window, shift)[-1].copy()).to(dev)
    kind = ("grid" if layout == "grid" else "v1") + ("_bias" if use_bias else "")
    fwd, bwd = getattr(WA, f"window_attention_{kind}"), getattr(WA, f"window_attention_{kind}_bwd")
    ref_fwd = getattr(WA, f"window_attention_{kind}_reference")
    ref_bwd = getattr(WA, f"window_attention_{kind}_backward_reference")
    extra = (bias,) if use_bias else ()
    tail = ((window, mask, 1.0) if layout == "grid"
            else ((h // window[0], w // window[1]), mask))
    before = launch_counts()
    out = fwd(q, k, v, scale, *extra, *tail)
    grads = bwd(q, k, v, scale, *extra, g, *tail)
    torch.cuda.synchronize()
    want = list(before)
    want[QKV_KERNELS.index(fwd)] += 1
    want[QKV_KERNELS.index(bwd)] += 1
    assert launch_counts() == want
    assert out.dtype == torch.bfloat16 and out.shape == g.shape
    ref = ref_fwd(q, k, v, scale, *extra, *tail[:-1] if layout == "grid" else tail)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = ref_bwd(q, k, v, scale, *extra, g, *tail[:-1] if layout == "grid" else tail)
    assert len(grads) == len(ref_grads) == 4 + len(extra)
    assert [t.dtype for t in grads[:3]] == [torch.bfloat16] * 3
    assert all(t.dtype == torch.float32 for t in grads[3:])
    for name, a, r in zip(("dq", "dk", "dv", "dscale", "dbias"), grads, ref_grads):
        assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    again = bwd(q, k, v, scale, *extra, g, *tail)
    for a, r in zip(grads, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_qkv_attention_kernels_match_plain(cuda_device, layout, use_bias, use_mask):
    """K8 and K9, bias-free and BIAS, at the small shape (L = 162, head dim
    32, 2 x 2 windows)."""
    check_qkv_kernels(cuda_device, layout, use_bias, use_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
def test_qkv_attention_kernels_at_the_flagship_shape(cuda_device, layout):
    """K8 and K9 BIAS instances, shifted, at the flagship shape: [1, 180, 360,
    768] (or [400, 8, 162, 96] windowed), 8 heads of 96, window 9 x 18."""
    check_qkv_kernels(cuda_device, layout, True, True, b=1, h=180, w=360, c=768, heads=8)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
def test_qkv_attention_kernels_head_dim_64(cuda_device, layout):
    """Batch 2 and head dim 64 (another template instance), shifted, bias-free."""
    check_qkv_kernels(cuda_device, layout, False, True, b=2, c=128, heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("route, rel_pos", [("pallas", False), ("pallas", True),
                                            ("pallas_v1", False), ("pallas_v1", True),
                                            ("xla", False)])
def test_route_micro_model_kernel_path_matches_cpu_plain_path(cuda_device, route, rel_pos):
    """The micro config on the grid (K8), windowed (K9) and plain 'xla' routes,
    with and without the CPB bias, on the GPU against the same model on the
    CPU (plain versions): the eval forward (8 ulps max, 0.5 mean) and the
    parameter gradients of an eval-mode backward (``assert_micro_grads_close``,
    logit_scale among the noisy leaves, as in
    tests/test_torch_grid_attention.py). Each block launches its route's
    forward and backward kernel once and no other attention kernel; 'xla'
    launches none."""
    over = dict(attn_impl=route)
    if rel_pos:
        over.update(rel_pos=True, full_pos_embed=False)
    fns = QKV_KERNELS + (mlp_kernels.fc1_gelu,)
    ref, ref_grads, out, grads, depth, launches = micro_model_cpu_and_gpu(cuda_device, over, fns)
    want = [0] * len(QKV_KERNELS) + [depth]
    if route != "xla":
        kind = ("grid" if route == "pallas" else "v1") + ("_bias" if rel_pos else "")
        for suffix in ("", "_bwd"):
            want[QKV_KERNELS.index(getattr(WA, f"window_attention_{kind}{suffix}"))] = depth
    assert launches == want
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)
    assert_micro_grads_close(ref_grads, grads, noisy=("logit_scale",))


# --------------------------------------------------------------------------
# the e2048 widths (large-head K1/K2/K7, wide K5, K6), K10 and the xla
# backward on the GPU
# --------------------------------------------------------------------------


def large_head_operands(dev, hd, heads=2, seed=31):
    """Seeded operands at L = 162 (window 9 x 18 on the 18 x 36 grid) and head
    dim ``hd``: x, w (fp32 and bf16), b, scale, g, a shifted mask and a folded
    CPB term."""
    rng = np.random.default_rng(seed)
    c = heads * hd
    x = torch.from_numpy(rng.standard_normal((B, H, W, c)).astype(np.float32)).to(dev).bfloat16()
    w = torch.from_numpy((rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32)).to(dev)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, H, W, c)).astype(np.float32)).to(dev).bfloat16()
    l = WINDOW[0] * WINDOW[1]
    raw = torch.from_numpy((2.0 * rng.standard_normal((heads, l, l))).astype(np.float32)).to(dev)
    mask = torch.from_numpy(mask_pattern()).to(dev)
    return x, w, w.bfloat16(), b, scale, g, mask, window_attention.fold_cpb_bias(raw, scale)


def assert_dscale_close(out, ref):
    """dscale: a sum of <qn16, dqn> over every query row with heavy
    cancellation; held to 1 % of the largest |ref| entry plus 1e-2 relative."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2 * np.abs(ref).max() + 4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("use_bias", [False, True])
def test_large_head_kernels_match_plain(cuda_device, hd, use_bias):
    """K1/K2 (and K7 with the bias) at head dim 128 and 256 with L = 162, where
    the backward takes the streamed variant at both (at 128 the one-block
    kernel would fit, but the streamed kernels are faster) and the forward is the
    projection on the GEMM core plus the streamed pass at every head dim:
    forward and backward against the plain versions, the launch counted on
    the usual wrapper, two backward calls bit-equal."""
    x, w, w16, b, scale, g, mask, badd = large_head_operands(cuda_device, hd)
    assert WA.qkv_variant("t", hd, 162, True) == "streamed"
    assert WA.qkv_variant("t", hd, 162, False) == "streamed"
    extra = (badd,) if use_bias else ()
    kind = "window_attention_qkv" + ("_bias" if use_bias else "")
    fwd, bwd = getattr(WA, kind), getattr(WA, kind + "_bwd")
    before = launch_counts()
    out = fwd(x, w16, b, scale, *extra, WINDOW, mask, 1.0)
    grads = bwd(x, w16, b, scale, *extra, g, WINDOW, mask, 1.0)
    torch.cuda.synchronize()
    want = list(before)
    want[QKV_KERNELS.index(fwd)] += 1
    want[QKV_KERNELS.index(bwd)] += 1
    assert launch_counts() == want
    ref = getattr(WA, kind + "_reference")(x, w, b, scale, *extra, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = getattr(WA, kind + "_backward_reference")(x, w16, b, scale, *extra, g, WINDOW, mask)
    assert grads[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads[1:])
    for name, a, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        elif name == "dx":
            # each dx entry sums 3C = 1536 (head dim 256) products of bf16
            # dqkv entries, so a flip of one of them reaches dx more often
            # than at C = 64 (measured 0.015 ulp mean at head dim 256): the
            # bound chip_smoke.py holds K2 to at the flagship shape
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(), 2, 0.05)
        else:
            assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    again = bwd(x, w16, b, scale, *extra, g, WINDOW, mask, 1.0)
    for a, r in zip(grads, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_qkv_kernels_refuse_shapes_no_instance_takes(cuda_device):
    """Only what the forward refuses raises a ValueError before any launch,
    both ways: head dim 192. Head dim 96 at L = 256 runs both ways (the
    forward's pass takes any L; the backward's one-block kernel fits since
    its scores left shared memory, and past that the streamed one runs): zero
    inputs give a zero output and zero gradients."""
    before = launch_counts()
    for hd, window, grid in ((96, (16, 16), (16, 16)), (192, WINDOW, (H, W))):
        c = 2 * hd
        x = torch.zeros((1, *grid, c), device=cuda_device, dtype=torch.bfloat16)
        w = torch.zeros((c, 3 * c), device=cuda_device, dtype=torch.bfloat16)
        b = torch.zeros(3 * c, device=cuda_device)
        scale = torch.ones(2, device=cuda_device)
        if hd == 96:
            out = WA.window_attention_qkv(x, w, b, scale, window)
            dx = WA.window_attention_qkv_bwd(x, w, b, scale, x[..., :c], window)[0]
            torch.cuda.synchronize()
            assert torch.count_nonzero(out).item() == 0  # v = 0
            assert torch.count_nonzero(dx).item() == 0  # zero cotangent, zero gradient
            before[QKV_KERNELS.index(WA.window_attention_qkv)] += 1
            before[QKV_KERNELS.index(WA.window_attention_qkv_bwd)] += 1
        else:
            with pytest.raises(ValueError):
                WA.window_attention_qkv(x, w, b, scale, window)
            with pytest.raises(ValueError):
                WA.window_attention_qkv_bwd(x, w, b, scale, x[..., :c], window)
    assert launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("c_in, hidden, c_out", [(2048, 4096, 2048), (256, 512, 1024)])
def test_wide_mlp_kernels_match_plain(cuda_device, c_in, hidden, c_out):
    """K5 (two products on the GEMM core) and K6 at the e2048 widths and at
    C_out = 1024 (not a multiple of 768, K5's former column tile), at a
    ragged T = 100, against their plain versions (the bounds of the
    flagship-width test)."""
    assert mlp_kernels.mlp_fwd_plan(100, c_in, hidden, c_out)["launches"] == 2
    rng = np.random.default_rng(41)
    t = 100
    x2 = torch.from_numpy(rng.standard_normal((t, c_in)).astype(np.float32)).to(cuda_device)
    w1 = torch.from_numpy((rng.standard_normal((c_in, hidden)) / np.sqrt(c_in)).astype(
        np.float32)).to(cuda_device)
    b1 = torch.from_numpy((0.1 * rng.standard_normal(hidden)).astype(np.float32)).to(cuda_device)
    w2 = torch.from_numpy((rng.standard_normal((hidden, c_out)) / np.sqrt(hidden)).astype(
        np.float32)).to(cuda_device)
    b2 = torch.from_numpy((0.1 * rng.standard_normal(c_out)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((t, c_out)).astype(np.float32)).to(cuda_device)
    x2, g = x2.bfloat16(), g.bfloat16()
    launches = (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches)
    out = mlp_kernels.mlp_fwd(x2, w1.bfloat16(), b1, w2.bfloat16(), b2)
    a, dpre = mlp_kernels.mlp_bwd(x2, w1.bfloat16(), b1, w2.bfloat16(), g)
    torch.cuda.synchronize()
    assert (mlp_kernels.mlp_fwd.launches, mlp_kernels.mlp_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = mlp_kernels.mlp_fwd_reference(x2, w1, b1, w2, b2)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.02)
    a_ref, dpre_ref = mlp_kernels.mlp_bwd_reference(x2, w1, b1, w2, g)
    assert_close_ulps(a.float().cpu().numpy(), a_ref.float().cpu().numpy(), 1, 0.01)
    assert_close_ulps(dpre.float().cpu().numpy(), dpre_ref.float().cpu().numpy(), 2, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(), dict(h=180, w=360, c=768, heads=8)])
def test_padded_kernels_match_plain(cuda_device, shape):
    """K10 forward and backward at a small shape (head dim 32, L = 162) and
    the flagship shape (8 heads of 96), shifted, against their plain versions:
    out's pad lanes and dWp's / dbp's pad columns exactly zero, g's pad lanes
    random (never read), two backward calls bit-equal, K1/K2 not launched."""
    rng = np.random.default_rng(51)
    h, w, c, heads = shape.get("h", H), shape.get("w", W), shape.get("c", C), shape.get("heads",
                                                                                       HEADS)
    hd = c // heads
    dev = cuda_device
    x = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32)).to(dev).bfloat16()
    wq = torch.from_numpy((rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32))
    bq = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32))
    wp = WA.pad_heads_w(wq, heads).to(dev).bfloat16()
    bp = WA.pad_heads_vec(bq, heads).to(dev)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((1, h, w, heads * 128)).astype(np.float32)).to(
        dev).bfloat16()
    mask = torch.from_numpy(make_shift_mask((h, w), WINDOW, (4, 9))[-1].copy()).to(dev)
    fns = (WA.window_attention_qkv_padded, WA.window_attention_qkv_padded_bwd,
           WA.window_attention_qkv, WA.window_attention_qkv_bwd)
    before = [f.launches for f in fns]
    out = WA.window_attention_qkv_padded(x, wp, bp, scale, hd, WINDOW, mask, 1.0)
    grads = WA.window_attention_qkv_padded_bwd(x, wp, bp, scale, hd, g, WINDOW, mask, 1.0)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0, 0]
    pad = out.reshape(1, h, w, heads, 128)[..., hd:]
    assert torch.count_nonzero(pad).item() == 0
    ref = WA.window_attention_qkv_padded_reference(x, wp, bp, scale, hd, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = WA.window_attention_qkv_padded_backward_reference(x, wp, bp, scale, hd, g, WINDOW,
                                                                  mask)
    dwp, dbp = grads[1].reshape(c, 3, heads, 128), grads[2].reshape(3, heads, 128)
    assert torch.count_nonzero(dwp[..., hd:]).item() == 0
    assert torch.count_nonzero(dbp[..., hd:]).item() == 0
    for name, a, r in zip(("dx", "dW", "db", "dscale"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    again = WA.window_attention_qkv_padded_bwd(x, wp, bp, scale, hd, g, WINDOW, mask, 1.0)
    for a, r in zip(grads, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("switch, value", [("QKV_IMPL", "v6"), ("QKV_BWD_IMPL", "xla")])
def test_qkv_variant_micro_model_launch_counts(cuda_device, monkeypatch, switch, value):
    """The micro config on ``pallas_qkv`` with v6 (K10 forward and backward
    once a block, K1/K2 never) or with the xla backward (K1 and K8's backward
    once a block, K2 never), on the GPU against the same model on the CPU
    (plain versions): the eval forward (8 ulps max, 0.5 mean) and the
    parameter gradients (``assert_micro_grads_close``)."""
    monkeypatch.setattr(WA, switch, value)
    fns = (WA.window_attention_qkv_padded, WA.window_attention_qkv_padded_bwd,
           WA.window_attention_qkv, WA.window_attention_qkv_bwd, WA.window_attention_grid_bwd)
    ref, ref_grads, out, grads, depth, launches = micro_model_cpu_and_gpu(
        cuda_device, dict(attn_impl="pallas_qkv"), fns)
    assert launches == ([depth, depth, 0, 0, 0] if value == "v6" else [0, 0, depth, 0, depth])
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)
    assert_micro_grads_close(ref_grads, grads, noisy=("logit_scale",))


@pytest.mark.cuda
def test_wide_micro_model_kernel_path_matches_cpu_plain_path(cuda_device):
    """The micro config at embed 1024 with 4 heads of 256 and mlp_ratio 2 on
    ``fused2`` (K1 at head dim 256, the large-head K2, K5 and K6 at C_out 1024) on the GPU against
    the same model on the CPU: the eval forward and the parameter gradients,
    each kernel once a block."""
    over = dict(attn_impl="pallas_qkv", embed_dim=1024, num_heads=4, mlp_ratio=2,
                mlp_impl="fused2")
    fns = (WA.window_attention_qkv, WA.window_attention_qkv_bwd, mlp_kernels.mlp_fwd,
           mlp_kernels.mlp_bwd)
    ref, ref_grads, out, grads, depth, launches = micro_model_cpu_and_gpu(cuda_device, over, fns)
    assert launches == [depth] * 4
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)
    assert_micro_grads_close(ref_grads, grads, noisy=("logit_scale",))


# --------------------------------------------------------------------------
# K8/K9 at head dims 128 and 256 (the streamed backward), the streamed
# forward at every head dim and beyond L = 256, K12 (v5, v4, the padded v4)
# and K13 (consume) on the GPU
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("use_bias", [False, True])
def test_qkv_attention_large_head_kernels_match_plain(cuda_device, layout, hd, use_bias):
    """K8 and K9 at head dims 128 and 256 with L = 162 (2 heads, shifted),
    where both backwards take their streamed kernels (the forward is the
    streamed kernel at every head dim): against their plain versions,
    counted on the usual wrappers, two backward calls bit-equal."""
    lay = "grid" if layout == "grid" else "v1"
    assert WA.attn_variant("t", hd, 162, True, lay) == "streamed"
    assert WA.attn_variant("t", hd, 162, False, lay) == "streamed"
    check_qkv_kernels(cuda_device, layout, use_bias, True, c=2 * hd, heads=2)


def check_qkv_forward(dev, layout, use_bias, use_mask, **shape):
    """K8 or K9's forward (bias-free or BIAS) against its plain version on the
    card (2 ulps max, 0.01 mean), launched once on its own wrapper."""
    q, k, v, scale, bias, _ = qkv_operands(dev, layout, **shape)
    window = shape.get("window", WINDOW)
    h, w = shape.get("h", H), shape.get("w", W)
    mask = None
    if use_mask:
        shift = (window[0] // 2, window[1] // 2)
        mask = torch.from_numpy(make_shift_mask((h, w), window, shift)[-1].copy()).to(dev)
    kind = ("grid" if layout == "grid" else "v1") + ("_bias" if use_bias else "")
    fwd = getattr(WA, f"window_attention_{kind}")
    extra = (bias,) if use_bias else ()
    tail = ((window, mask, 1.0) if layout == "grid"
            else ((h // window[0], w // window[1]), mask))
    before = launch_counts()
    out = fwd(q, k, v, scale, *extra, *tail)
    torch.cuda.synchronize()
    want = list(before)
    want[QKV_KERNELS.index(fwd)] += 1
    assert launch_counts() == want
    ref = getattr(WA, f"window_attention_{kind}_reference")(
        q, k, v, scale, *extra, *tail[:-1] if layout == "grid" else tail)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    return q, k, v, scale, extra, tail


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_qkv_attention_forward_at_every_head_dim(cuda_device, layout, hd, use_bias, use_mask):
    """The streamed K8/K9 forward, one template at head dims 32-256: L = 162
    (window 9 x 18, 2 x 2 windows, 2 heads), unshifted and shifted."""
    assert WA.attn_variant("t", hd, 162, False) == "streamed"
    check_qkv_forward(cuda_device, layout, use_bias, use_mask, c=2 * hd, heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_qkv_attention_forward_padded_small_window(cuda_device, layout, use_bias):
    """L = 12 (window 3 x 4 on a 6 x 8 grid): one query tile, padded keys and
    rows, shifted."""
    check_qkv_forward(cuda_device, layout, use_bias, True, h=6, w=8, window=(3, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grid", "windowed"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_qkv_attention_forward_beyond_256_keys(cuda_device, layout, use_bias):
    """L = 288 (window 12 x 24 on a 24 x 48 grid, head dim 64), which the
    forward streams like any L; the backward's streamed kernels take it past
    KEEP_L = 192, held to its plain version with the forward
    (``check_qkv_kernels``)."""
    assert WA.attn_variant("t", 64, 288, False) == "streamed"
    assert WA.attn_variant("t", 64, 288, True) == "streamed"
    check_qkv_forward(cuda_device, layout, use_bias, True, h=24, w=48, c=128, heads=2,
                      window=(12, 24))
    check_qkv_kernels(cuda_device, layout, use_bias, True, h=24, w=48, c=128, heads=2,
                      window=(12, 24))


def k12_operands(dev, h, w, c, heads, seed=61):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32)).to(dev).bfloat16()
    wq = torch.from_numpy((rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)).to(
        dev)
    bq = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32)).to(dev)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32)).to(dev).bfloat16()
    mask = torch.from_numpy(make_shift_mask((h, w), WINDOW, (4, 9))[-1].copy()).to(dev)
    return x, wq, bq, scale, g, mask


K12_SHAPES = [dict(h=H, w=W, c=C, heads=HEADS), dict(h=180, w=360, c=768, heads=8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K12_SHAPES)
def test_v5_kernels_match_plain_and_k1_k2(cuda_device, shape):
    """K12 v5 (K1/K2's templates reading the reordered weight) at a small
    shape and the flagship shape, shifted: bit-equal to K1 forward and K2
    backward (the same C_in loop order), within the v3 bounds of its plain
    versions, two backward calls bit-equal, counted apart from K1/K2."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    x, wq, bq, scale, g, mask = k12_operands(cuda_device, **shape)
    w16 = wq.bfloat16()
    w5 = v45.w5_reorder(w16, shape["heads"]).contiguous()
    fns = (v45.window_attention_qkv5, v45.window_attention_qkv5_bwd, WA.window_attention_qkv,
           WA.window_attention_qkv_bwd)
    before = [f.launches for f in fns]
    out = v45.window_attention_qkv5(x, w5, bq, scale, WINDOW, mask, 1.0)
    grads = v45.window_attention_qkv5_bwd(x, w5, w16, bq, scale, g, WINDOW, mask, 1.0)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0, 0]
    assert torch.equal(out, WA.window_attention_qkv(x, w16, bq, scale, WINDOW, mask, 1.0))
    k2 = WA.window_attention_qkv_bwd(x, w16, bq, scale, g, WINDOW, mask, 1.0)
    assert all(torch.equal(a, r) for a, r in zip(grads, k2))
    ref = v45.window_attention_qkv5_reference(x, w5, bq, scale, WINDOW, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = v45.window_attention_qkv5_backward_reference(x, w5, w16, bq, scale, g, WINDOW,
                                                             mask)
    for name, a, r in zip(("dx", "dW", "db", "dscale"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(),
                              *((2, 0.05) if name == "dx" else BWD_ULPS[name]))
    again = v45.window_attention_qkv5_bwd(x, w5, w16, bq, scale, g, WINDOW, mask, 1.0)
    assert all(torch.equal(a, r) for a, r in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K12_SHAPES)
@pytest.mark.parametrize("padded", [False, True])
def test_v4_kernels_match_plain(cuda_device, shape, padded):
    """K12 v4 (and its padded-head instance) on the window-major rows at a
    small shape and the flagship shape, shifted, against its plain versions:
    every row of the output (pad rows included), dxw with exactly zero pad
    rows (gw's pad rows are zero, as window_major gives them), the padded
    instance's pad lanes and pad columns exactly zero (gw's pad lanes random,
    never read), two backward calls bit-equal, counted apart from K1/K2."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    x, wq, bq, scale, g, mask = k12_operands(cuda_device, **shape)
    heads, c = shape["heads"], shape["c"]
    hd = c // heads
    grid = (shape["h"] // WINDOW[0], shape["w"] // WINDOW[1])
    xw = v45.window_major(x, WINDOW)
    gw = v45.window_major(g, WINDOW)
    w16 = wq.bfloat16()
    if padded:  # gw's pad lanes random (never read), its pad rows zero as window_major gives
        w16, bq = WA.pad_heads_w(w16, heads), WA.pad_heads_vec(bq, heads)
        gw = torch.randn((*gw.shape[:-1], heads * 128), device=cuda_device).bfloat16()
        gw[:, :, WINDOW[0] * WINDOW[1]:] = 0
        fwd, bwd = v45.window_attention_qkv4_padded, v45.window_attention_qkv4_padded_bwd
        ref_fwd = v45.window_attention_qkv4_padded_reference
        ref_bwd = v45.window_attention_qkv4_padded_backward_reference
        lead = (w16, bq, scale, hd)
    else:
        fwd, bwd = v45.window_attention_qkv4, v45.window_attention_qkv4_bwd
        ref_fwd = v45.window_attention_qkv4_reference
        ref_bwd = v45.window_attention_qkv4_backward_reference
        lead = (w16, bq, scale)
    fns = (fwd, bwd, WA.window_attention_qkv, WA.window_attention_qkv_bwd)
    before = [f.launches for f in fns]
    out = fwd(xw, *lead, WINDOW, grid, mask, 1.0)
    grads = bwd(xw, *lead, gw, WINDOW, grid, mask, 1.0)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 0, 0]
    ref = ref_fwd(xw, *lead, WINDOW, grid, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    assert torch.count_nonzero(grads[0][:, :, WINDOW[0] * WINDOW[1]:]).item() == 0
    if padded:
        assert torch.count_nonzero(out.reshape(*out.shape[:-1], heads, 128)[..., hd:]).item() == 0
        assert torch.count_nonzero(grads[1].reshape(c, 3, heads, 128)[..., hd:]).item() == 0
        assert torch.count_nonzero(grads[2].reshape(3, heads, 128)[..., hd:]).item() == 0
    ref_grads = ref_bwd(xw, *lead, gw, WINDOW, grid, mask)
    for name, a, r in zip(("dx", "dW", "db", "dscale"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(),
                              *((2, 0.05) if name == "dx" else BWD_ULPS[name]))
    again = bwd(xw, *lead, gw, WINDOW, grid, mask, 1.0)
    assert all(torch.equal(a, r) for a, r in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128])
def test_v4_kernels_read_the_pad_rows_as_the_tpu_kernel(cuda_device, hd):
    """v4's kernels take the window-major pad rows as JAX's do: x's pad rows
    are projected (pad query rows attend to the real keys), g's pad rows
    reach dk, dv and dscale. With random pad rows in xw and gw (head dims 32
    and 128) the kernels still follow the plain versions."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    x, wq, bq, scale, g, mask = k12_operands(cuda_device, H, W, 2 * hd, 2, seed=71)
    l = WINDOW[0] * WINDOW[1]
    xw, gw = v45.window_major(x, WINDOW), v45.window_major(g, WINDOW)
    xw[:, :, l:] = torch.randn_like(xw[:, :, l:], dtype=torch.float32).bfloat16()
    gw[:, :, l:] = torch.randn_like(gw[:, :, l:], dtype=torch.float32).bfloat16()
    w16, grid = wq.bfloat16(), (H // WINDOW[0], W // WINDOW[1])
    out = v45.window_attention_qkv4(xw, w16, bq, scale, WINDOW, grid, mask, 1.0)
    grads = v45.window_attention_qkv4_bwd(xw, w16, bq, scale, gw, WINDOW, grid, mask, 1.0)
    torch.cuda.synchronize()
    ref = v45.window_attention_qkv4_reference(xw, w16, bq, scale, WINDOW, grid, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    ref_grads = v45.window_attention_qkv4_backward_reference(xw, w16, bq, scale, gw, WINDOW, grid,
                                                             mask)
    assert torch.count_nonzero(ref_grads[0][:, :, l:]).item() > 0
    for name, a, r in zip(("dx", "dW", "db", "dscale"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(),
                              *((2, 0.05) if name == "dx" else BWD_ULPS[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
def test_v4_large_head_kernels_match_plain(cuda_device, hd):
    """K12 v4 at head dims 128 and 256 with L = 162 (2 heads, shifted), where
    the backward takes v4's instance of the streamed variant and the forward
    its pass (layout QKV4) at both:
    against the plain versions on every window-major row, dxw's pad rows
    exactly zero, two backward calls bit-equal."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    assert WA.qkv_variant("t", hd, 162, True) == "streamed"
    x, wq, bq, scale, g, mask = k12_operands(cuda_device, H, W, 2 * hd, 2)
    xw, gw = v45.window_major(x, WINDOW), v45.window_major(g, WINDOW)
    w16, grid = wq.bfloat16(), (H // WINDOW[0], W // WINDOW[1])
    out = v45.window_attention_qkv4(xw, w16, bq, scale, WINDOW, grid, mask, 1.0)
    grads = v45.window_attention_qkv4_bwd(xw, w16, bq, scale, gw, WINDOW, grid, mask, 1.0)
    torch.cuda.synchronize()
    ref = v45.window_attention_qkv4_reference(xw, w16, bq, scale, WINDOW, grid, mask)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    assert torch.count_nonzero(grads[0][:, :, WINDOW[0] * WINDOW[1]:]).item() == 0
    ref_grads = v45.window_attention_qkv4_backward_reference(xw, w16, bq, scale, gw, WINDOW, grid,
                                                             mask)
    for name, a, r in zip(("dx", "dW", "db", "dscale"), grads, ref_grads):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        else:
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(),
                              *((2, 0.05) if name == "dx" else BWD_ULPS[name]))
    again = v45.window_attention_qkv4_bwd(xw, w16, bq, scale, gw, WINDOW, grid, mask, 1.0)
    assert all(torch.equal(a, r) for a, r in zip(grads, again))


@pytest.mark.cuda
def test_v4_kernels_refuse_shapes_no_instance_takes(cuda_device):
    """A head dim the forward does not take (192) raises a ValueError before
    any launch, both ways (every L of a head dim the forward takes has a
    backward: the streamed one past L = 256)."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    dev, c = cuda_device, 2 * 192
    xw = torch.zeros((1, 4, 168, c), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((c, 3 * c), device=dev, dtype=torch.bfloat16)
    b, scale = torch.zeros(3 * c, device=dev), torch.ones(2, device=dev)
    before = (v45.window_attention_qkv4.launches, v45.window_attention_qkv4_bwd.launches)
    with pytest.raises(ValueError):
        v45.window_attention_qkv4(xw, w, b, scale, WINDOW, (2, 2))
    with pytest.raises(ValueError):
        v45.window_attention_qkv4_bwd(xw, w, b, scale, xw, WINDOW, (2, 2))
    assert (v45.window_attention_qkv4.launches,
            v45.window_attention_qkv4_bwd.launches) == before


@pytest.mark.cuda
def test_consume_kernel_matches_plain(cuda_device):
    """K13 bit-exact to its plain version (two roundings, as JAX's interpret
    mode), one launch counted; a permuted view raises before any launch."""
    from swin_v2_weather_torch.ops import prestage

    s = torch.randn((3, 1, 4, 8, 168, 96), device=cuda_device).bfloat16()
    before = prestage.consume.launches
    out = prestage.consume(s)
    torch.cuda.synchronize()
    assert prestage.consume.launches == before + 1
    assert torch.equal(out, prestage.consume_reference(s))
    with pytest.raises(ValueError, match="contiguous"):
        prestage.consume(s.transpose(2, 3))
    assert prestage.consume.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("impl, pad_heads", [("v5", False), ("v4", False), ("v4", True)])
def test_qkv45_micro_model_launch_counts(cuda_device, monkeypatch, impl, pad_heads):
    """The micro config on ``pallas_qkv`` with QKV_IMPL v5, v4 or the padded
    v4: the selected K12 kernels forward and backward once a block, K1/K2
    never; on the GPU against the same model on the CPU (plain versions):
    the eval forward (8 ulps max, 0.5 mean) and the parameter gradients."""
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    monkeypatch.setattr(WA, "QKV_IMPL", impl)
    monkeypatch.setattr(v45, "QKV_PAD_HEADS", pad_heads)
    kind = "qkv5" if impl == "v5" else ("qkv4_padded" if pad_heads else "qkv4")
    fns = (getattr(v45, f"window_attention_{kind}"), getattr(v45, f"window_attention_{kind}_bwd"),
           WA.window_attention_qkv, WA.window_attention_qkv_bwd)
    ref, ref_grads, out, grads, depth, launches = micro_model_cpu_and_gpu(
        cuda_device, dict(attn_impl="pallas_qkv"), fns)
    assert launches == [depth, depth, 0, 0]
    assert_close_ulps(out.numpy(), ref.numpy(), 8, 0.5)
    assert_micro_grads_close(ref_grads, grads, noisy=("logit_scale",))


# --------------------------------------------------------------------------
# the qkv-fused forward (K1, K7: the projection on the GEMM core, then the
# streamed pass) at every head dim and window, and K6 on the GEMM core
# --------------------------------------------------------------------------

QKV_FWD_WINDOWS = {12: ((6, 8), (3, 4)), 162: ((H, W), WINDOW), 288: ((24, 48), (12, 24))}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("l", [12, 162, 288])
@pytest.mark.parametrize("use_bias", [False, True])
def test_qkv_forward_at_every_head_dim_and_window(cuda_device, hd, l, use_bias):
    """K1 (K7 with the folded CPB bias) at head dims 32-256 and L = 12, 162
    and 288 (2 heads, shifted): against the plain version (2 ulps max, 0.01
    mean) and against the plain version of the pass's order of sums
    (``window_attention_qkv_pass_order``, the same bounds), one launch on its
    wrapper and one projection on the GEMM core. At L = 288 the backward
    takes the streamed instance and runs (its checks against the plain
    version: ``test_chunked_qkv_backward_matches_plain``)."""
    from swin_v2_weather_torch.ops import gemm_core

    (h, w), window = QKV_FWD_WINDOWS[l]
    rng = np.random.default_rng(81)
    c, heads = 2 * hd, 2
    dev = cuda_device
    x = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32)).to(dev).bfloat16()
    wq = torch.from_numpy((rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)).to(
        dev).bfloat16()
    bq = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32)).to(dev)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy(make_shift_mask((h, w), window, (window[0] // 2, window[1] // 2))[-1]
                            .copy()).to(dev)
    raw = torch.from_numpy((2.0 * rng.standard_normal((heads, l, l))).astype(np.float32)).to(dev)
    extra = (WA.fold_cpb_bias(raw, scale).contiguous(),) if use_bias else ()
    fwd = WA.window_attention_qkv_bias if use_bias else WA.window_attention_qkv
    before, core = launch_counts(), gemm_core.gemm.launches
    out = fwd(x, wq, bq, scale, *extra, window, mask, 1.0)
    torch.cuda.synchronize()
    want = list(before)
    want[QKV_KERNELS.index(fwd)] += 1
    assert launch_counts() == want and gemm_core.gemm.launches == core + 1
    ref = (WA.window_attention_qkv_bias_reference(x, wq, bq, scale, *extra, window, mask)
           if use_bias else WA.window_attention_qkv_reference(x, wq, bq, scale, window, mask))
    order = WA.window_attention_qkv_pass_order(x, wq, bq, scale, window, mask, 1.0, *extra)
    assert out.shape == ref.shape == (1, h, w, c) and torch.isfinite(out.float()).all()
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 2, 0.01)
    assert_close_ulps(out.float().cpu().numpy(), order.float().cpu().numpy(), 2, 0.01)
    if l > 256:
        bwd = WA.window_attention_qkv_bias_bwd if use_bias else WA.window_attention_qkv_bwd
        assert WA.qkv_variant("t", hd, l, True) == "streamed"
        grads = bwd(x, wq, bq, scale, *extra, out, window, mask, 1.0)
        torch.cuda.synchronize()
        want[QKV_KERNELS.index(bwd)] += 1
        assert launch_counts() == want
        assert all(torch.isfinite(t.float()).all() for t in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("t, c_in, hidden, c_out", [(100, 32, 136, 40), (1000, 768, 3072, 768),
                                                    (777, 2048, 4096, 2048)])
def test_k6_on_the_core_matches_plain(cuda_device, t, c_in, hidden, c_out):
    """K6 (one launch of the GEMM core's pair kernel) at ragged T, at the
    flagship and e2048 widths and at widths that leave partial K slices and
    a partial column tile: a within 1 ulp max / 0.01 mean and dpre within 2
    / 0.01 of the plain version (the bounds of the other whole-MLP tests),
    two calls bit-equal, one launch on the wrapper and on the core."""
    from swin_v2_weather_torch.ops import gemm_core

    assert mlp_kernels.mlp_bwd_plan(t, c_in, hidden, c_out)["launches"] == 1
    rng = np.random.default_rng(91)
    dev = cuda_device
    x2 = torch.from_numpy(rng.standard_normal((t, c_in)).astype(np.float32)).to(dev).bfloat16()
    w1 = torch.from_numpy((rng.standard_normal((c_in, hidden)) / np.sqrt(c_in)).astype(
        np.float32)).to(dev)
    b1 = torch.from_numpy((0.1 * rng.standard_normal(hidden)).astype(np.float32)).to(dev)
    w2 = torch.from_numpy((rng.standard_normal((hidden, c_out)) / np.sqrt(hidden)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((t, c_out)).astype(np.float32)).to(dev).bfloat16()
    before, core = mlp_kernels.mlp_bwd.launches, gemm_core.gemm.launches
    a, dpre = mlp_kernels.mlp_bwd(x2, w1.bfloat16(), b1, w2.bfloat16(), g)
    torch.cuda.synchronize()
    assert (mlp_kernels.mlp_bwd.launches, gemm_core.gemm.launches) == (before + 1, core + 1)
    a_ref, dpre_ref = mlp_kernels.mlp_bwd_reference(x2, w1, b1, w2, g)
    assert_close_ulps(a.float().cpu().numpy(), a_ref.float().cpu().numpy(), 1, 0.01)
    assert_close_ulps(dpre.float().cpu().numpy(), dpre_ref.float().cpu().numpy(), 2, 0.01)
    again = mlp_kernels.mlp_bwd(x2, w1.bfloat16(), b1, w2.bfloat16(), g)
    assert torch.equal(a, again[0]) and torch.equal(dpre, again[1])


# --------------------------------------------------------------------------
# the qkv-fused backwards past L = 256, and K3/K4 on the GEMM core
# --------------------------------------------------------------------------

# L -> (grid, window): two rows of windows at L = 288, one at 576
CHUNK_WINDOWS = {288: ((24, 48), (12, 24)), 576: ((24, 48), (24, 24))}
# (variant, use_bias): v3 is K2 (K7 with the bias), v6 K10, v4p the padded v4
CHUNK_QKV_CASES = [("v3", False), ("v3", True), ("v6", False), ("v5", False), ("v4", False),
                   ("v4p", False)]


def check_qkv_fused_backward(dev, variant, use_bias, hd, hw, window, shifted=True):
    """A qkv-fused backward (``variant`` as CHUNK_QKV_CASES) at head dim
    ``hd`` on the grid ``hw`` with ``window``, two heads, shifted or not: dx,
    dW, db, dscale (and dbias) against the plain version within the bounds of
    the flagship backward, one launch on the wrapper and three (v5: 3 heads +
    2) on the GEMM core, two calls bit-equal; the padded variants' pad
    columns and v4's pad rows of dxw exactly zero."""
    from swin_v2_weather_torch.ops import gemm_core
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    heads, (h, w), l = 2, hw, window[0] * window[1]
    c = heads * hd
    rng = np.random.default_rng(91)
    x = torch.from_numpy(rng.standard_normal((1, h, w, 64)).astype(np.float32)).to(dev).bfloat16()
    w16 = torch.from_numpy((rng.standard_normal((64, 3 * c)) / 8.0).astype(np.float32)).to(
        dev).bfloat16()
    bq = torch.from_numpy((0.1 * rng.standard_normal(3 * c)).astype(np.float32)).to(dev)
    scale = torch.from_numpy(np.exp(np.log(10.0) + 0.3 * rng.standard_normal(heads)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((1, h, w, c)).astype(np.float32)).to(dev).bfloat16()
    mask = torch.from_numpy(make_shift_mask((h, w), window, (window[0] // 2, window[1] // 2))[-1]
                            .copy()).to(dev) if shifted else None
    grid = (h // window[0], w // window[1])
    wp, bp = WA.pad_heads_w(w16, heads), WA.pad_heads_vec(bq, heads)
    if variant == "v3":
        extra = ()
        if use_bias:
            raw = torch.from_numpy((2.0 * rng.standard_normal((heads, l, l))).astype(np.float32))
            extra = (WA.fold_cpb_bias(raw.to(dev), scale).contiguous(),)
        fn = WA.window_attention_qkv_bias_bwd if use_bias else WA.window_attention_qkv_bwd
        args = (x, w16, bq, scale, *extra, g, window, mask)
    elif variant == "v6":
        fn = WA.window_attention_qkv_padded_bwd
        args = (x, wp, bp, scale, hd, WA.pad_heads_x(g, heads, hd), window, mask)
    elif variant == "v5":
        fn = v45.window_attention_qkv5_bwd
        args = (x, v45.w5_reorder(w16, heads).contiguous(), w16, bq, scale, g, window, mask)
    else:
        xw, gw = v45.window_major(x, window), v45.window_major(g, window)
        if variant == "v4":
            fn, args = v45.window_attention_qkv4_bwd, (xw, w16, bq, scale, gw, window, grid, mask)
        else:
            fn = v45.window_attention_qkv4_padded_bwd
            args = (xw, wp, bp, scale, hd, WA.pad_heads_x(gw, heads, hd), window, grid, mask)
    ref_fn = getattr(sys.modules[fn.__module__], fn.__name__[:-4] + "_backward_reference")
    before, core = fn.launches, gemm_core.gemm.launches
    grads = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert gemm_core.gemm.launches == core + (3 * heads + 2 if variant == "v5" else 3)
    ref = ref_fn(*args)
    assert len(grads) == len(ref) and grads[0].dtype == torch.bfloat16
    for name, a, r in zip(("dx", "dW", "db", "dscale", "dbias"), grads, ref):
        if name == "dscale":
            assert_dscale_close(a.cpu().numpy(), r.cpu().numpy())
        elif name == "dx":
            assert_close_ulps(a.float().cpu().numpy(), r.float().cpu().numpy(), 2, 0.05)
        else:
            assert_close_backward(name, a.float().cpu().numpy(), r.float().cpu().numpy())
    if variant in ("v6", "v4p"):
        assert torch.count_nonzero(grads[1].reshape(64, 3, heads, 128)[..., hd:]).item() == 0
        assert torch.count_nonzero(grads[2].reshape(3, heads, 128)[..., hd:]).item() == 0
    if variant in ("v4", "v4p"):
        assert torch.count_nonzero(grads[0][:, :, l:]).item() == 0
    again = fn(*args)
    for a, r in zip(grads, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant, use_bias", CHUNK_QKV_CASES)
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("l", [288, 576])
def test_chunked_qkv_backward_matches_plain(cuda_device, variant, use_bias, hd, l):
    """Every qkv-fused backward past L = 256, where the chunked instances
    ran before and the streamed ones run now (every FORM_QKV instance of
    ``csrc/streamed_bwd.cuh`` at head dims 32-256; K10 and the padded v4 up
    to their pitch 128, head pitch 128 above head dims 32-96, pad columns
    exactly zero), shifted, two windows of two heads or four
    (``check_qkv_fused_backward``: against the plain version, two calls
    bit-equal)."""
    if variant in ("v6", "v4p") and hd > 128:
        pytest.skip("K10 and the padded v4 take head dims up to their pitch 128")
    assert WA.qkv_variant("t", hd, l, True) == "streamed"
    check_qkv_fused_backward(cuda_device, variant, use_bias, hd, *CHUNK_WINDOWS[l])


# (head dim, L) -> (grid, window) of the streamed qkv-fused backward's cases:
# the e2048 window at head dim 256, and L near 256 at both head dims
STREAMED_WINDOWS = {(256, 162): ((18, 36), (9, 18)), (128, 224): ((28, 32), (14, 16)),
                    (256, 256): ((32, 32), (16, 16))}


@pytest.mark.cuda
@pytest.mark.parametrize("variant, use_bias", [("v3", False), ("v3", True), ("v5", False),
                                               ("v4", False)])
@pytest.mark.parametrize("hd, l", list(STREAMED_WINDOWS))
@pytest.mark.parametrize("shifted", [False, True])
def test_streamed_qkv_backward_matches_plain(cuda_device, variant, use_bias, hd, l, shifted):
    """The streamed qkv-fused backward (the recompute with q/k normalized in
    its epilogue, then the streamed kernels of ``csrc/streamed_bwd.cuh``) up
    to L = 256: K2, K7, v5 and v4 at head dim 256 with L = 162 and 256 and
    at head dim 128 with L = 224, unshifted and shifted
    (``check_qkv_fused_backward``)."""
    assert WA.qkv_variant("t", hd, l, True) == "streamed"
    check_qkv_fused_backward(cuda_device, variant, use_bias, hd, *STREAMED_WINDOWS[hd, l],
                             shifted=shifted)


# (head dim, grid, window) of the streamed K8/K9 backwards' cases past
# L = 256 (L = 288 and 576 on a [24, 48] grid)
BEYOND_256 = [(96, (24, 48), (12, 24)), (256, (24, 48), (12, 24)), (96, (24, 48), (24, 24)),
              (256, (24, 48), (24, 24))]


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hd, hw, window", [(256, (18, 36), (9, 18)), (128, (26, 32), (13, 16)),
                                            (128, (32, 32), (16, 16)),
                                            (256, (28, 32), (14, 16)), (32, (18, 36), (9, 18)),
                                            (64, (18, 36), (9, 18)), (96, (18, 36), (9, 18))]
                         + BEYOND_256)
@pytest.mark.parametrize("shifted", [False, True])
def test_streamed_grid_backward_matches_plain(cuda_device, use_bias, hd, hw, window, shifted):
    """K8's backward (the streamed kernels, K8's softmax) at head dim 256
    with L = 162 and 224, at head dim 128 with L = 208 and 256, at head dims
    32, 64 and 96 with L = 162 (two blocks an SM) and at head dims 96 and 256
    with L = 288 and 576 (past KEEP_L), bias-free and BIAS, unshifted and
    shifted: forward and backward against their plain versions, exactly
    their own wrappers' launches, two backward calls bit-equal
    (``check_qkv_kernels``)."""
    assert WA.attn_variant("t", hd, window[0] * window[1], True) == "streamed"
    check_qkv_kernels(cuda_device, "grid", use_bias, shifted, h=hw[0], w=hw[1], c=2 * hd,
                      heads=2, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hd, hw, window", [(256, (18, 36), (9, 18)), (256, (28, 32), (14, 16)),
                                            (256, (32, 32), (16, 16)), (128, (26, 32), (13, 16)),
                                            (128, (32, 32), (16, 16)), (96, (18, 36), (9, 18))]
                         + BEYOND_256)
@pytest.mark.parametrize("shifted", [False, True])
def test_streamed_v1_backward_matches_plain(cuda_device, use_bias, hd, hw, window, shifted):
    """K9's backward on the streamed kernels (form FORM_V1 of
    ``csrc/streamed_bwd.cuh``, after the q/k normalization prepass) at head
    dim 256 with L = 162, 224 and 256, at head dim 128 with L = 208 and 256,
    at head dim 96 with L = 162 and at head dims 96 and 256 with L = 288 and
    576 (past KEEP_L), bias-free and BIAS, unshifted and shifted: forward
    and backward against their plain versions, exactly their own wrappers'
    launches, two backward calls bit-equal (``check_qkv_kernels``)."""
    assert WA.attn_variant("t", hd, window[0] * window[1], True, "v1") == "streamed"
    check_qkv_kernels(cuda_device, "windowed", use_bias, shifted, h=hw[0], w=hw[1], c=2 * hd,
                      heads=2, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [777, 64801])
def test_fc1_kernels_on_the_core_at_ragged_t(cuda_device, t):
    """K3 and K4 at the flagship widths (768 -> 3072) on a token count that
    leaves a ragged last row tile: against their plain versions (K3 1 ulp
    max, K4 2 ulps: a flipped pre-activation moves g gelu' by up to 1.13
    ulp; 0.01 mean), one launch on each wrapper and on the GEMM core, the
    ragged rows written, two K4 calls bit-equal."""
    from swin_v2_weather_torch.ops import gemm_core

    rng = np.random.default_rng(17)
    dev = cuda_device
    x2 = torch.from_numpy(rng.standard_normal((t, 768)).astype(np.float32)).to(dev).bfloat16()
    w = torch.from_numpy((rng.standard_normal((768, 3072)) / np.sqrt(768)).astype(np.float32)).to(
        dev)
    b = torch.from_numpy((0.1 * rng.standard_normal(3072)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((t, 3072)).astype(np.float32)).to(dev).bfloat16()
    before = (mlp_kernels.fc1_gelu.launches, mlp_kernels.fc1_dpre.launches,
              gemm_core.gemm.launches)
    out = mlp_kernels.fc1_gelu(x2, w.bfloat16(), b)
    dpre = mlp_kernels.fc1_dpre(x2, w.bfloat16(), b, g)
    torch.cuda.synchronize()
    assert (mlp_kernels.fc1_gelu.launches, mlp_kernels.fc1_dpre.launches,
            gemm_core.gemm.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)
    ref = mlp_kernels.fc1_gelu_reference(x2, w, b)
    ref_dpre = mlp_kernels.fc1_dpre_reference(x2, w, b, g)
    assert_close_ulps(out.float().cpu().numpy(), ref.float().cpu().numpy(), 1, 0.01)
    assert_close_ulps(dpre.float().cpu().numpy(), ref_dpre.float().cpu().numpy(), 2, 0.01)
    assert torch.equal(mlp_kernels.fc1_dpre(x2, w.bfloat16(), b, g), dpre)
