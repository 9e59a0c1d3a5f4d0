"""PyTorch port, the selectable variants of the qkv-fused route: v6, the
padded-head route (K10, ``SWIN_QKV_IMPL=v6``), and the xla backward
(``SWIN_QKV_BWD_IMPL=xla``), each against the JAX package under the same
switch (its Pallas kernels in interpret mode on the CPU, backward kernels
through ``jax.vjp`` of the custom_vjps).

Both packages read their switches at call time (JAX when it traces), so the
tests set the module attributes of both (``switch``), as
tests/test_window_attention.py sets JAX's. Shapes: those of
tests/test_window_attention.py's qkv-kernel tests (B 2, a 9 x 24 grid, window
3 x 4, C_in 24, 2 heads of 16).

Tolerances are in bf16 ulps of each output's scale (``assert_close_ulps``,
``assert_close_backward`` of tests/test_torch_kernels.py): both sides keep the
TPU kernels' rounding sites, so they differ only where an fp32 sum taken in
another order flips one bf16 rounding (of qkv, q16/k16, e16, p16, ds or an
output). The pad lanes are compared exactly. The micro-model tests take the
bounds of the routes they vary (tests/test_torch_grid_attention.py and
tests/test_torch_training.py).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_grid_attention import check_route_converts, check_route_forward, route_forward
from test_torch_kernels import assert_close_backward, assert_close_ulps
from test_torch_training import (PARAM_TOL, STEP_RTOL, check_step_metrics, check_step_params,
                                 train_trajectories)

torch.set_num_threads(1)

B, H, W, C_IN, HEADS, HD = 2, 9, 24, 24, 2, 16
C = HEADS * HD
WINDOW = (3, 4)
L = WINDOW[0] * WINDOW[1]


@contextlib.contextmanager
def switch(name, value):
    """Set ``QKV_IMPL`` or ``QKV_BWD_IMPL`` in both packages."""
    with mock.patch.object(jax_wa, name, value), mock.patch.object(wa, name, value):
        yield


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C_IN)).astype(np.float32)
    w = (rng.standard_normal((C_IN, 3 * C)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    scale = np.exp(rng.standard_normal(HEADS) * 0.1 + 1.0).astype(np.float32)
    return x, w, b, scale


def pattern(use_mask):
    return make_shift_mask((H, W), WINDOW, (1, 2))[-1] if use_mask else None


def leaves(arrays, dtype):
    tdt = getattr(torch, dtype)
    x, w, b, scale = (torch.from_numpy(a) for a in arrays)
    return [x.to(tdt).requires_grad_(), w.to(tdt).requires_grad_(), b.requires_grad_(),
            scale.requires_grad_()]


# --------------------------------------------------------------------------
# v6: the padded-head route (K10)
# --------------------------------------------------------------------------


def test_padding_helpers_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((C_IN, 3 * C)).astype(np.float32)
    b = rng.standard_normal(3 * C).astype(np.float32)
    p = rng.standard_normal((C, 5)).astype(np.float32)
    xp = rng.standard_normal((4, HEADS * wa.HD_PAD)).astype(np.float32)
    pairs = [
        (wa.pad_heads_w(torch.from_numpy(w), HEADS), jax_wa._pad_heads_w(jnp.asarray(w), HEADS)),
        (wa.pad_heads_vec(torch.from_numpy(b), HEADS),
         jax_wa._pad_heads_vec(jnp.asarray(b), HEADS)),
        (wa.pad_proj_rows(torch.from_numpy(p), HEADS), jax_wa.pad_proj_rows(jnp.asarray(p), HEADS)),
        (wa.unpad_heads(torch.from_numpy(xp), HEADS, HD),
         jax_wa._unpad_heads(jnp.asarray(xp), HEADS, HD)),
        (wa.pad_heads_x(torch.from_numpy(xp[:, :C]), HEADS, HD),
         jax_wa._pad_heads_x(jnp.asarray(xp[:, :C]), HEADS, HD)),
    ]
    assert wa.HD_PAD == jax_wa._HD_PAD
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_v6_padded_forward_matches_jax(dtype, use_mask):
    """[B, H, W, heads * 128]: the pad lanes exactly zero on both sides, the
    live lanes within 2 ulps max / 0.01 mean (the bound of the v3 plain
    version against JAX)."""
    x, w, b, scale = inputs()
    patt = pattern(use_mask)
    ref = jax_wa.fused_window_attention_qkv_padded(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b), jnp.asarray(scale), WINDOW,
        patt)
    with torch.no_grad():
        out = wa.fused_window_attention_qkv_padded(*leaves((x, w, b, scale), dtype), WINDOW, patt)
    ref = np.asarray(ref, np.float32)
    assert tuple(out.shape) == ref.shape == (B, H, W, HEADS * wa.HD_PAD)
    got = out.float().numpy().reshape(B, H, W, HEADS, wa.HD_PAD)
    assert np.all(got[..., HD:] == 0.0)
    assert np.all(ref.reshape(got.shape)[..., HD:] == 0.0)
    assert_close_ulps(got, ref.reshape(got.shape), 2, 0.01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_v6_padded_backward_matches_jax(dtype, use_mask):
    """The unpadded dx, dW, db and dscale through v6 against jax.vjp of the
    JAX entry point with the same cotangent, whose pad lanes are random: the
    unpadded gradients never depend on them (the bounds of the v3 backward
    test)."""
    x, w, b, scale = inputs()
    patt = pattern(use_mask)
    ct = np.random.default_rng(5).standard_normal((B, H, W, HEADS * wa.HD_PAD)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv_padded(*a, WINDOW, patt),
                     jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b),
                     jnp.asarray(scale))
    ref = vjp(jnp.asarray(ct, dtype))
    ls = leaves((x, w, b, scale), dtype)
    wa.fused_window_attention_qkv_padded(*ls, WINDOW, patt).backward(
        torch.from_numpy(ct).to(getattr(torch, dtype)))
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), ls, ref):
        assert leaf.grad.dtype == leaf.dtype and tuple(leaf.grad.shape) == tuple(leaf.shape)
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def test_v6_plain_versions_are_v3s_on_the_live_lanes():
    """K10's plain versions are v3's on the live lanes, padded with exact
    zeros: forward, and dWp / dbp with zero pad columns; g's pad lanes are
    never read."""
    x, w, b, scale = (torch.from_numpy(a) for a in inputs())
    wp, bp = wa.pad_heads_w(w, HEADS), wa.pad_heads_vec(b, HEADS)
    patt = pattern(True)
    out = wa.window_attention_qkv_padded_reference(x, wp, bp, scale, HD, WINDOW, patt)
    v3 = wa.window_attention_qkv_reference(x, w, b, scale, WINDOW, patt)
    assert torch.equal(wa.unpad_heads(out, HEADS, HD), v3)
    assert torch.count_nonzero(out.reshape(B, H, W, HEADS, -1)[..., HD:]) == 0
    g = torch.randn((B, H, W, HEADS * wa.HD_PAD), generator=torch.Generator().manual_seed(0))
    dx, dwp, dbp, dscale = wa.window_attention_qkv_padded_backward_reference(
        x, wp, bp, scale, HD, g, WINDOW, patt)
    ref = wa.window_attention_qkv_backward_reference(x, w, b, scale, wa.unpad_heads(g, HEADS, HD),
                                                     WINDOW, patt)
    assert torch.count_nonzero(dwp.reshape(C_IN, 3, HEADS, -1)[..., HD:]) == 0
    assert torch.count_nonzero(dbp.reshape(3, HEADS, -1)[..., HD:]) == 0
    for got, r in zip((dx, wa.unpad_heads(dwp, 3 * HEADS, HD), wa.unpad_heads(dbp, 3 * HEADS, HD),
                       dscale), ref):
        assert torch.equal(got, r)


def test_v6_entry_point_checks():
    """Head dims above 128 raise, as in JAX; the v3 entry point refuses 'v6'
    (another output contract) and unknown values of either switch, and takes
    'v4'/'v5' (the K12 schedules, tests/test_torch_qkv_v45.py)."""
    x, w, b, scale = (torch.from_numpy(a) for a in inputs())
    with pytest.raises(ValueError, match="head_dim"):  # one head of 132
        wa.fused_window_attention_qkv_padded(x, torch.zeros(C_IN, 3 * 132), torch.zeros(3 * 132),
                                             scale[:1], WINDOW)
    for impl in ("v6", "v7"):
        with switch("QKV_IMPL", impl), pytest.raises(ValueError):
            wa.fused_window_attention_qkv(x, w, b, scale, WINDOW)
    for impl in ("v4", "v5"):
        with switch("QKV_IMPL", impl):
            out = wa.fused_window_attention_qkv(x, w, b, scale, WINDOW)
        assert tuple(out.shape) == (B, H, W, C) and bool(torch.isfinite(out).all())
    # with the CPB bias the v3 schedule runs whatever QKV_IMPL says, as in JAX
    bias = torch.zeros((HEADS, L, L))
    with switch("QKV_IMPL", "v6"):
        out = wa.fused_window_attention_qkv(x, w, b, scale, WINDOW, bias=bias)
    assert tuple(out.shape) == (B, H, W, C)
    with switch("QKV_BWD_IMPL", "XLA"), pytest.raises(ValueError):
        wa.qkv_bwd_impl()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v6_route_model_forward_matches_jax(dtype):
    """The micro model on ``pallas_qkv`` with v6 (no CPB bias: every block
    takes K10's route and the padded proj) against the JAX model with v6,
    eval mode (the bounds of the route tests)."""
    with switch("QKV_IMPL", "v6"), mock.patch.object(
            swin, "fused_window_attention_qkv", side_effect=AssertionError("v3 route")):
        check_route_forward("pallas_qkv", dtype)


def test_v6_route_forward_equals_v3_route():
    """In fp32 the padded proj adds only exact zeros: v6 and v3 give the
    same model output to fp32 rounding."""
    with switch("QKV_IMPL", "v6"):
        _, out6 = route_forward("pallas_qkv", "float32")
    _, out3 = route_forward("pallas_qkv", "float32")
    np.testing.assert_allclose(out6, out3, rtol=0, atol=1e-5 * np.abs(out3).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v6_route_train_trajectory_matches_jax(dtype):
    """3 train steps on both sides with v6: per-step metrics and the
    parameters after the last step (the proj weight's gradient reaches the
    unpadded parameter through the padding)."""
    with switch("QKV_IMPL", "v6"):
        jax_seq, jax_params, port_seq, tm, tree, lr = train_trajectories(dtype, 0)
    check_step_metrics(jax_seq, port_seq, *STEP_RTOL[dtype])
    check_step_params(jax_params, tm, tree, lr, *PARAM_TOL[dtype])


def test_v6_route_weights_convert_unchanged():
    """v6 is a switch, not a configuration: the parameter tree and its
    conversion are the v3 route's."""
    with switch("QKV_IMPL", "v6"):
        check_route_converts("pallas_qkv")


# --------------------------------------------------------------------------
# the xla backward
# --------------------------------------------------------------------------


def cpb_term(seed=9):
    raw = 2.0 * np.random.default_rng(seed).standard_normal((HEADS, L, L)).astype(np.float32)
    scale = inputs()[3]
    return np.array(jax_wa.fold_cpb_bias(jnp.asarray(raw), jnp.asarray(scale)), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_xla_backward_matches_jax(dtype, use_bias, use_mask):
    """dx, dW, db, dscale (and d(badd) with the pre-folded CPB term) of the
    port's Functions with ``QKV_BWD_IMPL = 'xla'`` (the qkv recompute, the
    per-head normalization and its VJP, K8's plain backward, the projection
    chain) against jax.vjp of the JAX entry point under the same switch (the
    grid backward kernel in interpret mode). Bounds of the v3 backward test;
    d(bias) those of K7's."""
    x, w, b, scale = inputs()
    patt = pattern(use_mask)
    ct = np.random.default_rng(5).standard_normal((B, H, W, C)).astype(np.float32)
    badd = cpb_term() if use_bias else None
    with switch("QKV_BWD_IMPL", "xla"):
        if use_bias:
            _, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv(
                *a[:4], WINDOW, patt, bias=a[4], bias_prefolded=True),
                jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b), jnp.asarray(scale),
                jnp.asarray(badd))
        else:
            _, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv(*a, WINDOW, patt),
                             jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b),
                             jnp.asarray(scale))
        ref = vjp(jnp.asarray(ct, dtype))
        ls = leaves((x, w, b, scale), dtype)
        extra = {}
        if use_bias:
            ls.append(torch.from_numpy(badd).requires_grad_())
            extra = dict(bias=ls[4], bias_prefolded=True)
        with mock.patch.object(wa, "window_attention_qkv_backward_reference",
                               side_effect=AssertionError("K2's route")), \
                mock.patch.object(wa, "window_attention_qkv_bias_backward_reference",
                                  side_effect=AssertionError("K7's route")):
            wa.fused_window_attention_qkv(*ls[:4], WINDOW, patt, **extra).backward(
                torch.from_numpy(ct).to(getattr(torch, dtype)))
    for name, leaf, r in zip(("dx", "dW", "db", "dscale", "dbias"), ls, ref):
        assert leaf.grad.dtype == leaf.dtype
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def test_xla_backward_runs_the_grid_backward():
    """The xla backward reaches K8's backward (its plain version here) once,
    on the qkv rounded K1's way, and leaves the forward unchanged."""
    ls = leaves(inputs(), "float32")
    out_ref = wa.fused_window_attention_qkv(*ls, WINDOW, pattern(True)).detach()
    calls = []
    real = wa.window_attention_grid_bias_backward_reference

    def spy(*a, **k):
        calls.append(a[4])  # the bias handed to K8's backward: None without the CPB
        return real(*a, **k)

    with switch("QKV_BWD_IMPL", "xla"), mock.patch.object(
            wa, "window_attention_grid_bias_backward_reference", side_effect=spy):
        out = wa.fused_window_attention_qkv(*ls, WINDOW, pattern(True))
        out.backward(torch.ones_like(out))
    assert calls == [None] and torch.equal(out.detach(), out_ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_backward_route_train_trajectory_matches_jax(dtype):
    """3 train steps of the micro model with the xla backward on both sides:
    per-step metrics and the parameters after the last step."""
    with switch("QKV_BWD_IMPL", "xla"):
        jax_seq, jax_params, port_seq, tm, tree, lr = train_trajectories(dtype, 0)
    check_step_metrics(jax_seq, port_seq, *STEP_RTOL[dtype])
    check_step_params(jax_params, tm, tree, lr, *PARAM_TOL[dtype])


def test_xla_backward_route_model_forward_matches_jax():
    """The switch changes only the backward: the micro model's eval forward
    under it is the v3 route's, against JAX under the same switch (bf16)."""
    with switch("QKV_BWD_IMPL", "xla"):
        check_route_forward("pallas_qkv", "bfloat16")
