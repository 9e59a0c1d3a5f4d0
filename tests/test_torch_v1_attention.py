"""PyTorch port, the windowed attention route (``attn_impl: pallas_v1``, K9):
K9's plain forward and backward against the JAX package's
``fused_window_attention`` (its Pallas kernels in interpret mode on the CPU,
the backward through ``jax.vjp`` of the custom_vjp), the fp32 oracle
``reference_attention``, and the micro model on the ``pallas_v1`` and ``xla``
routes against the JAX model of the same route.

Tolerances are in bf16 ulps of the output scale, as in
tests/test_torch_grid_attention.py: both sides keep the TPU kernel's rounding
sites (bf16(qn), bf16(kn), bf16(p) with p = e / sum e, dsb = bf16(ds *
scale)), so they differ only where an fp32 sum in another order flips one of
those roundings.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask as jax_make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_grid_attention import (check_route_converts, check_route_cpb,
                                       check_route_forward, check_route_trajectory)
from test_torch_kernels import assert_close_ulps
from test_torch_model import micro_configs, micro_models

torch.set_num_threads(1)

# the shapes of tests/test_window_attention.py: 2 images of 3 x 4 windows of
# 3 x 4 tokens (L = 12, padded to 16 by the TPU kernel), 2 heads of 16
B, NWH, NWW, HEADS, L, D = 2, 3, 4, 2, 12, 16
BW = B * NWH * NWW
GRID = (NWH, NWW)
GRAD_ULPS = {"dq": (2.0, 0.02), "dk": (2.0, 0.02), "dv": (2.0, 0.02), "dscale": (1.0, 0.5),
             "dbias": (1.0, 0.05)}


def v1_inputs(dtype, seed=0):
    """q, k, v [Bw, heads, L, D], scale [heads], bias [heads, L, L], cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((BW, HEADS, L, D)).astype(np.float32) for _ in range(4))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, L, L)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v, g = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32) for t in (q, k, v, g))
    return q, k, v, scale, bias, g


def pattern():
    # feat (9, 16), window (3, 4), shift (1, 2): the boundary-row pattern
    return jax_make_shift_mask((9, 16), (3, 4), (1, 2))[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_v1_forward_matches_jax(dtype, use_bias, use_mask):
    q, k, v, scale, bias, _ = v1_inputs(dtype)
    bias = bias if use_bias else None
    patt = pattern() if use_mask else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_wa.fused_window_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias), mask_pattern=patt, window_grid=GRID)
    out = wa.fused_window_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), torch.from_numpy(scale),
        bias=None if bias is None else torch.from_numpy(bias), mask_pattern=patt,
        window_grid=GRID)
    assert out.dtype == tdt and tuple(out.shape) == (BW, HEADS, L, D)
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 1, 0.01)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_reference_attention_matches_jax(use_bias, use_mask):
    """The port's fp32 oracle equals JAX's up to fp32 sum order; K9's plain
    forward is within bf16 rounding of it."""
    q, k, v, scale, bias, _ = v1_inputs("float32", seed=1)
    bias = bias if use_bias else None
    patt = pattern() if use_mask else None
    ref = jax_wa.reference_attention(*(jnp.asarray(t) for t in (q, k, v, scale)),
                                     None if bias is None else jnp.asarray(bias), patt, GRID)
    targs = [torch.from_numpy(t) for t in (q, k, v, scale)]
    tbias = None if bias is None else torch.from_numpy(bias)
    out = wa.reference_attention(*targs, tbias, patt, GRID)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    fused = wa.window_attention_v1_bias_reference(*targs, tbias, GRID, patt)
    assert_close_ulps(fused.numpy(), out.numpy(), 8, 0.5)


def test_v1_mask_applies_to_the_last_window_row():
    q, k, v, scale, _, _ = v1_inputs("float32")
    args = [torch.from_numpy(t) for t in (q, k, v, scale)]
    plain = wa.fused_window_attention(*args, window_grid=GRID)
    masked = wa.fused_window_attention(*args, mask_pattern=pattern(), window_grid=GRID)
    rows = torch.arange(BW) // NWW % NWH
    last = rows == NWH - 1
    torch.testing.assert_close(masked[~last], plain[~last], rtol=0, atol=0)
    assert (masked[last] - plain[last]).abs().max() > 1e-2


def v1_grads(dtype, use_bias, use_mask):
    q, k, v, scale, bias, g = v1_inputs(dtype)
    patt = pattern() if use_mask else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(t, jdt) for t in (q, k, v)] + [jnp.asarray(scale)]
    if use_bias:
        jargs.append(jnp.asarray(bias))
    _, vjp = jax.vjp(lambda q_, k_, v_, s_, *b_: jax_wa.fused_window_attention(
        q_, k_, v_, s_, bias=b_[0] if b_ else None, mask_pattern=patt, window_grid=GRID),
        *jargs)
    ref = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v)]
    leaves.append(torch.from_numpy(scale).requires_grad_())
    if use_bias:
        leaves.append(torch.from_numpy(bias).requires_grad_())
    out = wa.fused_window_attention(*leaves[:4], bias=leaves[4] if use_bias else None,
                                    mask_pattern=patt, window_grid=GRID)
    out.backward(torch.from_numpy(g).to(tdt))
    return ref, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_v1_backward_matches_jax(dtype, use_bias, use_mask):
    """dq, dk, dv, dscale (and dbias) of the port's Function (K9's plain
    backward, normalization VJP inside) against jax.vjp of the JAX entry point
    (``_v1_backward`` interpreted), in the input dtypes."""
    ref, got = v1_grads(dtype, use_bias, use_mask)
    for name, a, r in zip(("dq", "dk", "dv", "dscale", "dbias"), got, ref):
        assert a.dtype == getattr(torch, str(r.dtype)), name
        assert_close_ulps(a.float().numpy(), np.asarray(r, np.float32), *GRAD_ULPS[name])


def test_v1_entry_point_checks():
    q, k, v, scale, _, _ = v1_inputs("float32")
    args = [torch.from_numpy(t) for t in (q, k, v, scale)]
    with pytest.raises(ValueError, match="window_grid"):
        wa.fused_window_attention(*args)
    with pytest.raises(ValueError, match="multiple"):
        wa.fused_window_attention(*args, window_grid=(5, 5))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_v1(*(t.bfloat16() for t in args[:3]), args[3], GRID)


# --------------------------------------------------------------------------
# the micro model on the windowed routes (helpers and bounds shared with
# tests/test_torch_grid_attention.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["pallas_v1", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_route_model_forward_matches_jax(route, dtype):
    check_route_forward(route, dtype)


@pytest.mark.parametrize("route", ["pallas_v1", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_route_train_trajectory_matches_jax(route, dtype):
    check_route_trajectory(route, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v1_route_cpb_matches_jax(dtype):
    check_route_cpb("pallas_v1", dtype)


@pytest.mark.parametrize("route", ["pallas_v1", "xla"])
def test_windowed_route_weights_convert_unchanged(route):
    check_route_converts(route)


def test_xla_route_takes_the_full_mask_and_no_kernel():
    """The 'xla' route's shifted blocks hold the full [nW, L, L] mask, and its
    forward calls neither K9 nor its plain versions (plain fp32 attention)."""
    _, _, tm = micro_models(attn_impl="xla")
    blocks = tm.model.blocks
    assert blocks[0].attn_mask is None and blocks[1].attn_mask is not None
    nwh, nww = blocks[1].attn.window_grid
    assert tuple(blocks[1].attn_mask.shape) == (nwh * nww, 8, 8)
    x = torch.zeros((1, int(micro_configs()[1]["n_in_channels"]), 24, 48))
    with mock.patch.object(wa, "WindowAttentionV1", side_effect=AssertionError("K9")):
        with torch.no_grad():
            assert torch.isfinite(tm(x)).all()
