"""PyTorch port, the grid attention route (``attn_impl: pallas``, K8): the
per-head normalization and its VJP, K8's plain forward and backward against
the JAX package's ``fused_window_attention_grid`` (its Pallas kernels in
interpret mode on the CPU, the backward through ``jax.vjp`` of the
custom_vjp), and the micro model on this route against the JAX model of the
same route, forward, gradients and the 3-step train trajectory, with and
without the CPB bias.

Tolerances are in bf16 ulps of the output scale (``assert_close_ulps``), as
in tests/test_torch_kernels.py: both sides keep the TPU kernel's rounding
sites (qn16, kn16, v16, p16 = bf16(e / sum e), dsb = bf16(ds * scale)), so
they differ only where an fp32 sum taken in another order (a row sum, an
exp, the rsqrt of the normalization) flips one of those bf16 roundings.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models.swin import make_shift_mask as jax_make_shift_mask
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
from swin_v2_weather_torch.ops import window_attention as wa

from test_torch_cpb import cpb_grad_errors
from test_torch_kernels import assert_close_ulps
from test_torch_model import assert_rel_close, micro_configs, micro_models
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs
from test_torch_training import (PARAM_TOL, STEP_RTOL, check_step_metrics, check_step_params,
                                 train_trajectories)

torch.set_num_threads(1)

# the shapes of tests/test_window_attention.py's grid-kernel tests
B, H, W, HEADS, D = 2, 9, 24, 2, 16
C = HEADS * D
WINDOW = (3, 4)
L = WINDOW[0] * WINDOW[1]
SHIFT = (1, 2)

# backward, in bf16 ulps of each output's scale: dq, dk, dv are bf16 in the
# bf16 case (a flipped dsb or p16 rounding moves one entry by about an ulp);
# dscale and dbias sum over all windows (relative 2e-3 of the scale)
GRAD_ULPS = {"dq": (2.0, 0.02), "dk": (2.0, 0.02), "dv": (2.0, 0.02), "dscale": (1.0, 0.5),
             "dbias": (1.0, 0.05)}


def grid_inputs(dtype, seed=0):
    """q, k, v [B, H, W, C], scale [heads], bias [heads, L, L], cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(4))
    scale = np.exp(rng.standard_normal(HEADS) * 0.3 + np.log(10.0)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, L, L)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, k, v, g = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32) for t in (q, k, v, g))
    return q, k, v, scale, bias, g


def pattern():
    return jax_make_shift_mask((H, W), WINDOW, SHIFT)[-1]


def test_normalize_heads_and_vjp_match_jax(rng):
    x = rng.standard_normal((2, 3, 5, C)).astype(np.float32)
    dxn = rng.standard_normal((2, 3, 5, C)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jx = jnp.asarray(x, dtype)
        ref_xn, ref_inv = jax_wa._normalize_heads(jx, HEADS)
        xn, inv = wa.normalize_heads(torch.from_numpy(x).to(getattr(torch, dtype)), HEADS)
        assert xn.dtype == getattr(torch, dtype) and inv.dtype == torch.float32
        # fp32 sums of 16 squares in another order: 1 fp32 ulp in inv, which
        # flips at most one bf16 rounding of xn
        np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv), rtol=1e-6)
        assert_close_ulps(xn.float().numpy(), np.asarray(ref_xn, np.float32), 1, 0.01)
        ref_dx = jax_wa._normalize_vjp(ref_xn, ref_inv, jnp.asarray(dxn, dtype), HEADS, jx.dtype)
        dx = wa.normalize_vjp(xn, inv, torch.from_numpy(dxn).to(xn.dtype), HEADS, xn.dtype)
        assert dx.dtype == xn.dtype
        assert_close_ulps(dx.float().numpy(), np.asarray(ref_dx, np.float32), 1, 0.01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_grid_forward_matches_jax(dtype, use_bias, use_mask):
    q, k, v, scale, bias, _ = grid_inputs(dtype)
    bias = bias if use_bias else None
    patt = pattern() if use_mask else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_wa.fused_window_attention_grid(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(scale), WINDOW,
        bias=None if bias is None else jnp.asarray(bias), mask_pattern=patt)
    out = wa.fused_window_attention_grid(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), torch.from_numpy(scale), WINDOW,
        bias=None if bias is None else torch.from_numpy(bias), mask_pattern=patt)
    assert out.dtype == tdt and tuple(out.shape) == (B, H, W, C)
    # one flipped bf16 rounding of qn16/kn16 or p16 moves an output by < 1 ulp
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 1, 0.01)
    # and the kernel computes the fp32 oracle's function up to its bf16 sites
    oracle = jax_wa.reference_attention_grid(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), patt, WINDOW)
    assert_close_ulps(out.float().numpy(), np.asarray(oracle), 8, 0.5)


def test_grid_mask_and_flag_take_effect():
    q, k, v, scale, _, _ = grid_inputs("float32")
    args = [torch.from_numpy(t) for t in (q, k, v, scale)]
    plain = wa.fused_window_attention_grid(*args, WINDOW)
    masked = wa.fused_window_attention_grid(*args, WINDOW, mask_pattern=pattern())
    gated = wa.fused_window_attention_grid(*args, WINDOW, mask_pattern=pattern(),
                                           boundary_flag=0.0)
    wh = WINDOW[0]
    torch.testing.assert_close(masked[:, : H - wh], plain[:, : H - wh], rtol=0, atol=0)
    assert (masked[:, H - wh:] - plain[:, H - wh:]).abs().max() > 1e-2
    torch.testing.assert_close(gated, plain, rtol=0, atol=0)


def grid_grads(dtype, use_bias, use_mask):
    """(JAX grads, port grads) of the entry point for the cotangent g, in the
    order (dq, dk, dv, dscale[, dbias])."""
    q, k, v, scale, bias, g = grid_inputs(dtype)
    patt = pattern() if use_mask else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(t, jdt) for t in (q, k, v)] + [jnp.asarray(scale)]
    if use_bias:
        jargs.append(jnp.asarray(bias))
    _, vjp = jax.vjp(lambda q_, k_, v_, s_, *b_: jax_wa.fused_window_attention_grid(
        q_, k_, v_, s_, WINDOW, bias=b_[0] if b_ else None, mask_pattern=patt), *jargs)
    ref = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v)]
    leaves.append(torch.from_numpy(scale).requires_grad_())
    if use_bias:
        leaves.append(torch.from_numpy(bias).requires_grad_())
    out = wa.fused_window_attention_grid(*leaves[:4], WINDOW,
                                         bias=leaves[4] if use_bias else None, mask_pattern=patt)
    out.backward(torch.from_numpy(g).to(tdt))
    return ref, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_grid_backward_matches_jax(dtype, use_bias, use_mask):
    """dq, dk, dv, dscale (and dbias) of the port's Function -- K8's plain
    backward, then the normalization VJP -- against jax.vjp of the JAX entry
    point (``_grid_backward`` interpreted, then ``_normalize_vjp``), in the
    input dtypes."""
    ref, got = grid_grads(dtype, use_bias, use_mask)
    names = ("dq", "dk", "dv", "dscale", "dbias")
    for name, a, r in zip(names, got, ref):
        assert a.dtype == getattr(torch, str(r.dtype)), name
        assert_close_ulps(a.float().numpy(), np.asarray(r, np.float32), *GRAD_ULPS[name])


def test_grid_entry_point_checks():
    q, k, v, scale, bias, _ = grid_inputs("float32")
    args = [torch.from_numpy(t) for t in (q, k, v, scale)]
    with pytest.raises(ValueError, match="divisible"):
        wa.fused_window_attention_grid(*args, (4, 5))
    with pytest.raises(ValueError, match="CPB bias"):
        wa.fused_window_attention_grid(*args, WINDOW, bias=torch.zeros(HEADS, L, L - 1))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_grid(*(t.bfloat16() for t in args[:3]), args[3], WINDOW)


# --------------------------------------------------------------------------
# the micro model on a route, against the JAX model of the same route
# (shared with tests/test_torch_v1_attention.py)
# --------------------------------------------------------------------------
#
# Bounds as in tests/test_torch_model.py, relative to the output (or gradient
# leaf) scale: fp32 compute forward max 5e-3 / mean 1e-4, gradients per leaf
# 2e-2 / 1e-2; bf16 compute forward 3e-2 / 4e-3 with the port no farther
# from the fp32 JAX output than JAX's own bf16 output is (x 1.5), gradients
# 0.15 / 0.08. The 3-step train trajectory takes the bounds of
# tests/test_torch_training.py (STEP_RTOL, PARAM_TOL).


def route_forward(route, dtype, seed=1):
    """(JAX output, port output) of the micro model on ``route`` (eval mode,
    the same noise weights)."""
    jm, tree, tm = micro_models(dtype, seed=seed, attn_impl=route)
    assert {blk.attn.attn_impl for blk in tm.model.blocks} == {route}
    jp, _ = micro_configs(dtype, attn_impl=route)
    x = np.random.default_rng(2).standard_normal(
        (2, int(jp["n_in_channels"]), *jp.img_size)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert np.abs(ref - x[:, : ref.shape[1]]).max() > 1.0  # the blocks contribute
    return ref, out.numpy()


def check_route_forward(route, dtype):
    if dtype == "float32":
        ref, out = route_forward(route, "float32")
        assert_rel_close(out, ref, 5e-3, 1e-4)
        return
    ref32, _ = route_forward(route, "float32")
    ref, out = route_forward(route, "bfloat16")
    assert_rel_close(out, ref, 3e-2, 4e-3)
    assert np.abs(out - ref32).mean() <= 1.5 * np.abs(ref - ref32).mean()


def check_route_trajectory(route, dtype):
    """3 train steps (drop-path 0) on both sides: per-step metrics and the
    parameters after the last step."""
    jax_seq, jax_params, port_seq, tm, tree, lr = train_trajectories(dtype, 0, attn_impl=route)
    assert {blk.attn.attn_impl for blk in tm.model.blocks} == {route}
    check_step_metrics(jax_seq, port_seq, *STEP_RTOL[dtype])
    check_step_params(jax_params, tm, tree, lr, *PARAM_TOL[dtype])


def route_cpb_forward_and_grads(route, dtype):
    over = dict(drop_path_rate=0.0, scan_blocks=False, attn_impl=route, rel_pos=True,
                full_pos_embed=False)
    jm, tree, tm = micro_models(dtype, seed=1, **over)
    assert all(blk.attn.meta_mlp is not None for blk in tm.model.blocks)
    jp, _ = micro_configs(dtype, **over)
    x, _, ct = rollout_inputs(jp, 0)
    with mock.patch.object(swin, "fold_cpb_bias", side_effect=AssertionError("folded")):
        out, grads = port_forward_and_grads(tm, x, None, ct)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    return (ref, jax.tree.map(np.asarray, ref_grads)), (out, grads)


def check_route_cpb(route, dtype):
    """``rel_pos: True, full_pos_embed: False`` on ``route``: the forward and
    every parameter gradient (meta_mlp included; its fc2 bias, exactly 0, as
    in tests/test_torch_cpb.py) against JAX. The route takes the raw bias: no
    block folds it.

    In bf16 a logit_scale leaf (2 entries, each a sum over every window with
    heavy cancellation) is rounding noise at the 10 % level on either side:
    on pallas_v1 JAX's bf16 gradient is 10 % (mean) off its fp32 one, the
    port's 1.9 %, and the two bf16 sides 12.5 % apart. Those leaves are held to
    the max bound (0.15) in the mean too; every leaf, and over all leaves the
    port's distance to the fp32 JAX gradients must not exceed 1.5 x JAX's
    own (measured 0.20 against 0.30 on pallas_v1, 0.20 against 0.24 on
    pallas)."""
    (ref, ref_grads), (out, grads) = route_cpb_forward_and_grads(route, dtype)
    if dtype == "float32":
        assert_rel_close(out, ref, 5e-3, 1e-4)
        errs = cpb_grad_errors(grads, ref_grads, zero_tol=1e-5)
        bounds = (2e-2, 1e-2)
    else:
        assert_rel_close(out, ref, 3e-2, 4e-3)
        errs = cpb_grad_errors(grads, ref_grads, zero_tol=2e-2)
        bounds = (0.15, 0.08)
        (_, ref32_grads), _ = route_cpb_forward_and_grads(route, "float32")
        err_port = sum(e[1] for e in cpb_grad_errors(grads, ref32_grads, 2e-2).values())
        err_jax = sum(e[1] for e in cpb_grad_errors(ref_grads, ref32_grads, 2e-2).values())
        assert err_port <= 1.5 * err_jax, (err_port, err_jax)
    assert any("meta_mlp" in k for k in errs) and any("logit_scale" in k for k in errs)
    assert max(e[0] for e in errs.values()) <= bounds[0], errs
    for key, (_, mean) in errs.items():
        assert mean <= (bounds[0] if "logit_scale" in key else bounds[1]), (key, mean)


def check_route_converts(route):
    """JAX keeps the qkv Dense at attn/qkv/{kernel,bias} on every route: the
    route's tree has the pallas_qkv tree's paths and shapes, and converts
    through params_from_jax (strict load) and back unchanged."""
    _, tree, tm = micro_models(attn_impl=route, scan_blocks=False)
    _, ref_tree, _ = micro_models(attn_impl="pallas_qkv", scan_blocks=False)
    shapes = {jax.tree_util.keystr(p): np.shape(v)
              for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes == {jax.tree_util.keystr(p): np.shape(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(ref_tree)}
    state = params_from_jax(tree)
    assert set(state) == set(tm.state_dict())
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(state)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(back[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_route_model_forward_matches_jax(dtype):
    check_route_forward("pallas", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_route_train_trajectory_matches_jax(dtype):
    check_route_trajectory("pallas", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_route_cpb_matches_jax(dtype):
    check_route_cpb("pallas", dtype)


def test_grid_route_weights_convert_unchanged():
    check_route_converts("pallas")
