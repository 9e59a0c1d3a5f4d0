"""PyTorch port, K12: the v4 and v5 schedules of the qkv-fused window
attention (``impl='v4'``/``'v5'``, ``QKV_IMPL``; v4's padded heads with
``QKV_PAD_HEADS``), against the JAX package's attic kernels
(``ops/attic/window_attention_v45.py``) in interpret mode on the CPU, their
backward kernels through ``jax.vjp`` of the custom_vjps; the layout helpers;
and the micro model on ``pallas_qkv`` under each switch against the JAX model
under the same switch.

Shapes: those of tests/test_window_attention.py's qkv-kernel tests (B 2, a
9 x 24 grid, window 3 x 4, C_in 24, 2 heads of 16; Lp = 16 with 4 pad rows).
JAX caches its ``_build_qkv*`` constructors, so each switch is set on both
packages before the first JAX call (and ``_build_qkv4``'s cache cleared),
never in the JAX files.

Tolerances, in bf16 ulps of each output's scale as in
tests/test_torch_qkv_variants.py: both sides keep the same bf16 rounding
sites (v5: v3's; v4: p16 = bf16(e * (1 / sum e)) and the fp32 qn in the
backward), so they differ only where an fp32 sum in another order flips one
bf16 rounding: the forward within 2 ulps max / 0.01 mean, the gradients within
``assert_close_backward``'s bounds. The micro-model tests take the bounds of
the routes they vary (tests/test_torch_grid_attention.py,
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
from swin_v2_weather_tpu.ops.attic import window_attention_v45 as jax_v45
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.ops import window_attention as wa
from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

from test_torch_grid_attention import check_route_converts, check_route_forward
from test_torch_kernels import assert_close_backward, assert_close_ulps
from test_torch_training import (PARAM_TOL, STEP_RTOL, check_step_metrics, check_step_params,
                                 train_trajectories)

torch.set_num_threads(1)

B, H, W, C_IN, HEADS, HD = 2, 9, 24, 24, 2, 16
C = HEADS * HD
WINDOW = (3, 4)
GRID = (H // WINDOW[0], W // WINDOW[1])
L = WINDOW[0] * WINDOW[1]
LP = 16  # L rounded up to 8


@contextlib.contextmanager
def switch(impl, pad_heads=False):
    """``QKV_IMPL`` in both packages and ``QKV_PAD_HEADS`` in both attic
    modules (the `_build_qkv4` cache cleared, so the switch reaches its trace)."""
    jax_v45._build_qkv4.cache_clear()
    with mock.patch.object(jax_wa, "QKV_IMPL", impl), mock.patch.object(wa, "QKV_IMPL", impl), \
            mock.patch.object(jax_v45, "QKV_PAD_HEADS", pad_heads), \
            mock.patch.object(v45, "QKV_PAD_HEADS", pad_heads):
        yield
    jax_v45._build_qkv4.cache_clear()


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C_IN)).astype(np.float32)
    w = (rng.standard_normal((C_IN, 3 * C)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    scale = np.exp(rng.standard_normal(HEADS) * 0.1 + 1.0).astype(np.float32)
    return x, w, b, scale


def pattern(use_mask):
    return make_shift_mask((H, W), WINDOW, (1, 2))[-1] if use_mask else None


def cotangent(channels=C, seed=5):
    return np.random.default_rng(seed).standard_normal((B, H, W, channels)).astype(np.float32)


# --------------------------------------------------------------------------
# the layouts
# --------------------------------------------------------------------------


def test_layout_helpers_match_jax():
    """w5_reorder, b5_reorder, window_major (with its zero pad rows), its
    inverse and the Lp-padded mask, exactly as JAX's; w5_inverse undoes
    w5_reorder."""
    x, w, b, _ = inputs()
    patt = pattern(True)
    tw, tb, tx = (torch.from_numpy(a) for a in (w, b, x))
    xw = v45.window_major(tx, WINDOW)
    assert tuple(xw.shape) == (B, GRID[0] * GRID[1], LP, C_IN)
    assert torch.count_nonzero(xw[:, :, L:]) == 0
    pairs = [
        (v45.w5_reorder(tw, HEADS), jax_v45._w5_reorder(jnp.asarray(w), HEADS)),
        (v45.b5_reorder(tb, HEADS), jax_v45._b5_reorder(jnp.asarray(b), HEADS)),
        (xw, jax_v45.window_major(jnp.asarray(x), WINDOW)),
        (v45.window_major_inverse(xw, WINDOW, (H, W)),
         jax_v45.window_major_inverse(jax_v45.window_major(jnp.asarray(x), WINDOW), WINDOW,
                                      (H, W))),
        (v45.pad_mask_lp(patt, L, LP), jax_v45._pad_mask_lp(patt, L, LP)),
    ]
    for got, ref in pairs:
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    assert torch.equal(v45.window_major_inverse(xw, WINDOW, (H, W)), tx)
    assert torch.equal(v45.w5_inverse(v45.w5_reorder(tw, HEADS)), tw.bfloat16())


def test_v5_plain_versions_are_v3s_bit_for_bit():
    """v5 computes v3's function: its plain forward and backward on the
    reordered weight equal v3's on the packed one, bit for bit (JAX's v5
    kernels equal its v3 kernels bit for bit too)."""
    x, w, b, scale = (torch.from_numpy(a) for a in inputs())
    patt = pattern(True)
    w5 = v45.w5_reorder(w, HEADS)
    assert torch.equal(v45.window_attention_qkv5_reference(x, w5, b, scale, WINDOW, patt),
                       wa.window_attention_qkv_reference(x, w, b, scale, WINDOW, patt))
    g = torch.from_numpy(cotangent())
    got = v45.window_attention_qkv5_backward_reference(x, w5, w, b, scale, g, WINDOW, patt)
    ref = wa.window_attention_qkv_backward_reference(x, w, b, scale, g, WINDOW, patt)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize("use_mask", [False, True])
def test_v4_plain_versions_match_jax_on_window_major_rows(use_mask):
    """v4's plain forward and backward on the window-major rows, pad rows
    included, against ``_qkv4_forward`` / ``_qkv4_backward`` interpreted: the
    pad query rows' outputs (q = bf16(b_q)) agree, and their dx rows are
    exactly zero on both sides (bf16 operands)."""
    x, w, b, scale = inputs()
    patt = pattern(use_mask)
    xw = np.asarray(jax_v45.window_major(jnp.asarray(x, jnp.bfloat16), WINDOW), np.float32)
    gw = np.asarray(jax_v45.window_major(jnp.asarray(cotangent(), jnp.bfloat16), WINDOW),
                    np.float32)
    jargs = (jnp.asarray(xw, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
             jnp.asarray(scale))
    ref = jax_v45._qkv4_forward(*jargs, patt, GRID, L, True)
    ref_g = jax_v45._qkv4_backward(*jargs, jnp.asarray(gw, jnp.bfloat16), patt, GRID, L, True)
    targs = (torch.from_numpy(xw).bfloat16(), torch.from_numpy(w).bfloat16(),
             torch.from_numpy(b), torch.from_numpy(scale))
    out = v45.window_attention_qkv4_reference(*targs, WINDOW, GRID, patt)
    assert tuple(out.shape) == (B, GRID[0] * GRID[1], LP, C)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 2, 0.01)
    got = v45.window_attention_qkv4_backward_reference(
        *targs, torch.from_numpy(gw).bfloat16(), WINDOW, GRID, patt)
    assert torch.count_nonzero(got[0][:, :, L:]) == 0
    assert np.count_nonzero(np.asarray(ref_g[0], np.float32)[:, :, L:]) == 0
    for name, a, r in zip(("dx", "dW", "db", "dscale"), got, ref_g):
        assert_close_backward(name, a.float().numpy(), np.asarray(r, np.float32))


def test_v4_is_not_v3():
    """At the bf16 level v4 is another function (p16 rounded before p @ v,
    the fp32 qn in the backward): its output differs from v3's somewhere."""
    x, w, b, scale = (torch.from_numpy(a).bfloat16() if i < 2 else torch.from_numpy(a)
                      for i, a in enumerate(inputs()))
    out4 = wa.fused_window_attention_qkv(x, w, b, scale, WINDOW, impl="v4")
    out3 = wa.fused_window_attention_qkv(x, w, b, scale, WINDOW, impl="v3")
    assert not torch.equal(out4, out3)
    assert_close_ulps(out4.float().numpy(), out3.float().numpy(), 4, 0.5)


# --------------------------------------------------------------------------
# the entry point against JAX's, forward and gradients
# --------------------------------------------------------------------------


# (impl, padded heads, dtype, shift mask): bf16 masked and not, fp32 masked
CASES = [(impl, pad, dtype, mask) for impl, pad in (("v5", False), ("v4", False), ("v4", True))
         for dtype, mask in (("bfloat16", False), ("bfloat16", True), ("float32", True))]


@pytest.mark.parametrize("impl, pad_heads, dtype, use_mask", CASES)
def test_qkv45_matches_jax(impl, pad_heads, dtype, use_mask):
    """``fused_window_attention_qkv(impl=...)``: the output, and dx, dW, db,
    dscale through the port's Function against jax.vjp of the JAX entry
    point under the same switch, in the input dtypes; the padded-head v4
    gives the unpadded gradients."""
    x, w, b, scale = inputs()
    patt = pattern(use_mask)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ct = cotangent()
    with switch("v3", pad_heads):
        out_ref, vjp = jax.vjp(
            lambda *a: jax_wa.fused_window_attention_qkv(*a, WINDOW, patt, impl=impl),
            jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b), jnp.asarray(scale))
        ref = vjp(jnp.asarray(ct, jdt))
        leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
                  torch.from_numpy(w).to(tdt).requires_grad_(),
                  torch.from_numpy(b).requires_grad_(), torch.from_numpy(scale).requires_grad_()]
        out = wa.fused_window_attention_qkv(*leaves, WINDOW, patt, impl=impl)
        out.backward(torch.from_numpy(ct).to(tdt))
    assert out.dtype == tdt and tuple(out.shape) == (B, H, W, C)
    assert_close_ulps(out.detach().float().numpy(), np.asarray(out_ref, np.float32), 2, 0.01)
    for name, leaf, r in zip(("dx", "dW", "db", "dscale"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype and tuple(leaf.grad.shape) == tuple(leaf.shape)
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def test_padded_v4_plain_versions_are_v4s_on_the_live_lanes():
    """The padded-head v4's plain versions are v4's on the live lanes with
    exact zeros in the pad lanes (forward) and pad columns (dWp, dbp); gw's
    pad lanes are never read."""
    x, w, b, scale = (torch.from_numpy(a) for a in inputs())
    xw = v45.window_major(x, WINDOW)
    wp, bp = wa.pad_heads_w(w, HEADS), wa.pad_heads_vec(b, HEADS)
    patt = pattern(True)
    out = v45.window_attention_qkv4_padded_reference(xw, wp, bp, scale, HD, WINDOW, GRID, patt)
    assert torch.count_nonzero(out.reshape(*out.shape[:-1], HEADS, -1)[..., HD:]) == 0
    assert torch.equal(wa.unpad_heads(out, HEADS, HD),
                       v45.window_attention_qkv4_reference(xw, w, b, scale, WINDOW, GRID, patt))
    gw = torch.randn((*xw.shape[:-1], HEADS * wa.HD_PAD), generator=torch.Generator().manual_seed(0))
    dxw, dwp, dbp, dscale = v45.window_attention_qkv4_padded_backward_reference(
        xw, wp, bp, scale, HD, gw, WINDOW, GRID, patt)
    assert torch.count_nonzero(dwp.reshape(C_IN, 3, HEADS, -1)[..., HD:]) == 0
    assert torch.count_nonzero(dbp.reshape(3, HEADS, -1)[..., HD:]) == 0
    ref = v45.window_attention_qkv4_backward_reference(xw, w, b, scale,
                                                       wa.unpad_heads(gw, HEADS, HD), WINDOW,
                                                       GRID, patt)
    for got, r in zip((dxw, wa.unpad_heads(dwp, 3 * HEADS, HD),
                       wa.unpad_heads(dbp, 3 * HEADS, HD), dscale), ref):
        assert torch.equal(got, r)


def test_selection_and_its_limits():
    """``impl=None`` reads QKV_IMPL; QKV_BWD_IMPL = 'xla' does not reach v4 or
    v5 (their own backwards, as JAX's ``_build_qkv4``/``_build_qkv5``); with
    the CPB bias K7's route runs whatever QKV_IMPL says; the kernel wrappers
    refuse CPU tensors and shapes no v4 instance takes."""
    ls = [torch.from_numpy(a).requires_grad_() for a in inputs()]
    patt = pattern(True)
    grads = {}
    for impl in ("v4", "v5"):
        for bwd in ("pallas", "xla"):
            with mock.patch.object(wa, "QKV_IMPL", impl), \
                    mock.patch.object(wa, "QKV_BWD_IMPL", bwd), \
                    mock.patch.object(wa, "qkv_xla_backward", side_effect=AssertionError("xla")), \
                    mock.patch.object(wa.WindowAttentionQKV, "apply",
                                      side_effect=AssertionError("v3 route")):
                out = wa.fused_window_attention_qkv(*ls, WINDOW, patt)
                out.backward(torch.from_numpy(cotangent()))
            grads[impl, bwd] = [t.grad.clone() for t in ls]
            for t in ls:
                t.grad = None
        assert all(torch.equal(a, r) for a, r in zip(grads[impl, "xla"], grads[impl, "pallas"]))
    bias = torch.zeros((HEADS, L, L))
    with mock.patch.object(wa, "QKV_IMPL", "v4"), \
            mock.patch.object(v45.WindowAttentionQKV4, "apply", side_effect=AssertionError("v4")):
        out = wa.fused_window_attention_qkv(*ls, WINDOW, bias=bias)
    assert tuple(out.shape) == (B, H, W, C)
    x16 = ls[0].detach().bfloat16()
    xw = v45.window_major(x16, WINDOW)
    w16 = ls[1].detach().bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        v45.window_attention_qkv4(xw, w16, ls[2].detach(), ls[3].detach(), WINDOW, GRID)
    with pytest.raises(ValueError, match="CUDA"):
        v45.window_attention_qkv5(x16, v45.w5_reorder(w16, HEADS), ls[2].detach(),
                                  ls[3].detach(), WINDOW)


# --------------------------------------------------------------------------
# the micro model on pallas_qkv under each switch, against the JAX model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl, pad_heads", [("v5", False), ("v4", False), ("v4", True)])
def test_qkv45_route_model_forward_matches_jax(impl, pad_heads):
    """The micro model on ``pallas_qkv`` with QKV_IMPL v5, v4 or the padded
    v4 (no CPB bias: every block takes K12's route) against the JAX model
    under the same switch, eval mode, bf16 compute."""
    with switch(impl, pad_heads), mock.patch.object(
            wa.WindowAttentionQKV, "apply", side_effect=AssertionError("v3 route")):
        check_route_forward("pallas_qkv", "bfloat16")


@pytest.mark.parametrize("impl", ["v5", "v4"])
def test_qkv45_route_train_trajectory_matches_jax(impl):
    """3 train steps of the micro model on both sides with QKV_IMPL v5 or
    v4: per-step metrics and the parameters after the last step (bf16)."""
    with switch(impl):
        jax_seq, jax_params, port_seq, tm, tree, lr = train_trajectories("bfloat16", 0)
    check_step_metrics(jax_seq, port_seq, *STEP_RTOL["bfloat16"])
    check_step_params(jax_params, tm, tree, lr, *PARAM_TOL["bfloat16"])


def test_qkv45_route_weights_convert_unchanged():
    """v4 and v5 are switches, not configurations: the parameter tree and its
    conversion are the v3 route's, so a checkpoint serves every QKV_IMPL."""
    with switch("v4"):
        check_route_converts("pallas_qkv")
    assert swin.fused_window_attention_qkv is wa.fused_window_attention_qkv
