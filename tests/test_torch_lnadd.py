"""PyTorch port, the fused LayerNorm + drop-path + residual-add route
(``lnadd_impl: fused``, K11): the plain versions against the JAX Pallas
kernels (interpret mode), the autograd Function against the JAX custom_vjp
and an fp64 oracle, and the micro model on the fused route against JAX.

Kernel tolerances are in bf16 ulps of the output scale
(tests/test_torch_kernels.py), model tolerances relative to the output or
gradient-leaf scale (tests/test_torch_model.py). Every parameter, LayerNorm
scales included, is drawn from numpy noise.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.ops import ln_kernels as jax_ln
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import ln_kernels

from test_torch_kernels import assert_close_ulps, ln_inputs
from test_torch_model import assert_rel_close, leaf_rel_errors, micro_configs, micro_models
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs

torch.set_num_threads(1)

LNADD = dict(lnadd_impl="fused", embed_dim=128)  # C % 128 == 0: the fused route applies


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_plain_matches_jax(dtype):
    """K11's plain forward and backward against ln_dp_add_fwd_pallas and
    ln_dp_add_bwd_pallas at [96, 128] with m mixed between 0, 1 and 1/keep.
    Both round at the same sites (m rounded to the compute dtype before the
    forward's product, unrounded in the backward). Measured: bit-equal in
    bf16; in fp32 the row means sum in another order (3e-5 bf16 ulps);
    dgamma/dbeta 1.4e-7 of their scale (bound 1e-5)."""
    tdt = getattr(torch, dtype)
    z, x, gamma, beta, m, g = ln_inputs(t=96, c=128)
    ref = jax_ln.ln_dp_add_fwd_pallas(jnp.asarray(z, dtype), jnp.asarray(x, dtype),
                                      jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(m))
    out = ln_kernels.ln_dp_add_fwd_reference(
        torch.from_numpy(z).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(m))
    assert out.dtype == tdt and str(ref.dtype) == dtype
    assert_close_ulps(out.float().numpy(), np.asarray(ref, np.float32), 1, 0.01)
    rdz, rdg, rdb = jax_ln.ln_dp_add_bwd_pallas(jnp.asarray(z, dtype), jnp.asarray(g, dtype),
                                                jnp.asarray(gamma), jnp.asarray(m))
    dz, dg, db = ln_kernels.ln_dp_add_bwd_reference(
        torch.from_numpy(z).to(tdt), torch.from_numpy(g).to(tdt), torch.from_numpy(gamma),
        torch.from_numpy(m))
    assert dz.dtype == tdt and dg.dtype == db.dtype == torch.float32
    assert_close_ulps(dz.float().numpy(), np.asarray(rdz, np.float32), 1, 0.01)
    for a, r in ((dg, rdg), (db, rdb)):
        r = np.asarray(r, np.float32)[0]
        assert np.abs(a.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_deterministic_matches_the_unfused_branch_bit_for_bit(dtype):
    """With m = 1 the fused forward is bit for bit the unfused
    ``x + Fp32LayerNorm(z).to(dtype)`` (the claim of the JAX kernel's
    docstring, tests/test_ln_kernels.py:55), here against the port's own
    LayerNorm module."""
    tdt = getattr(torch, dtype)
    z, x, gamma, beta, _, _ = ln_inputs(t=96, c=128)
    z, x = torch.from_numpy(z).to(tdt), torch.from_numpy(x).to(tdt)
    norm = swin.Fp32LayerNorm(128)
    norm.load_state_dict({"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)})
    with torch.no_grad():
        want = x + norm(z).to(tdt)
    out = ln_kernels.ln_dp_add_fwd_reference(z, x, norm.weight, norm.bias, torch.ones((96, 1)))
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def fma32(a, b, c):
    """a * b + c rounded once to fp32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def lane_sum(a, b=None):
    """The register form's per-lane sum over the channels of a [T, C] (or,
    with b, of a * b, each step one fma; fp32): lane l takes channels 128 ch
    + 4 l + j in (ch, j) order, then the warp's butterfly (xor 16 .. 1) ->
    [T, 1]."""
    t, c = a.shape
    av = a.reshape(t, c // 128, 32, 4)
    bv = None if b is None else b.reshape(t, c // 128, 32, 4)
    acc = np.zeros((t, 32), np.float32)
    for ch in range(c // 128):
        for j in range(4):
            x = av[:, ch, :, j]
            acc = (acc + x).astype(np.float32) if b is None else fma32(x, bv[:, ch, :, j], acc)
    for o in (16, 8, 4, 2, 1):
        acc = (acc + acc[:, [i ^ o for i in range(32)]]).astype(np.float32)
    return acc[:, :1]


def wide_backward_order(z, g, gamma, m):
    """K11's backward above 2048 channels in its order of fp32 sums: the row
    statistics, mean(dh) and mean(dh hhat) per lane (``lane_sum``, products
    contracted to fma), dz elementwise from them; dgamma and dbeta summed
    over each block's contiguous rows in row order (one fma or add a row),
    then the blocks' partials in block order (n_blocks as the wrapper picks
    it). bf16-valued z, g [T, C] and m [T, 1] -> (dz fp32, dgamma, dbeta)."""
    t, c = z.shape
    cf = np.float32(c)
    mean = (lane_sum(z) / cf).astype(np.float32)
    d = (z - mean).astype(np.float32)
    rstd = (np.float32(1.0) / np.sqrt(lane_sum(d, d) / cf + np.float32(1e-5))).astype(np.float32)
    hh = (d * rstd).astype(np.float32)
    dy = (g * m).astype(np.float32)
    dh = (dy * gamma).astype(np.float32)
    t1 = (lane_sum(dh, hh) / cf).astype(np.float32)  # mean(dh hhat)
    t2 = (lane_sum(dh) / cf).astype(np.float32)  # mean(dh)
    dz = (rstd * ((dh - t2).astype(np.float32) - (hh * t1).astype(np.float32))).astype(np.float32)
    n_blocks = max(1, min(264, -(-t // 64)))
    rows = -(-t // n_blocks)
    dgamma, dbeta = np.zeros(c, np.float32), np.zeros(c, np.float32)
    for blk in range(n_blocks):
        pg, pb = np.zeros(c, np.float32), np.zeros(c, np.float32)
        for r in range(blk * rows, min(t, (blk + 1) * rows)):
            pg = fma32(dy[r], hh[r], pg)
            pb = (pb + dy[r]).astype(np.float32)
        dgamma, dbeta = (dgamma + pg).astype(np.float32), (dbeta + pb).astype(np.float32)
    return dz, dgamma, dbeta


def test_ln_wide_backward_order_matches_jax():
    """Rows wider than 2048 channels ([192, 2176]: three blocks of 64 rows):
    the wide backward's order of fp32 sums (``wide_backward_order``: the
    statistics in the register form's per-lane order, dgamma / dbeta over
    each block's rows in row order, then the blocks in order) against JAX's
    ``ln_dp_add_bwd_pallas`` (interpret mode) and the port's plain version
    in bf16: dz within 1 bf16 ulp max and 0.01 mean of its scale,
    dgamma / dbeta within 1e-5 of their scale. The launch plan stages 8 rows
    a stage at this width and at 3072, fewer above 3200, and refuses a width
    whose one row does not fit a block's shared memory."""
    z, _, gamma, _, m, g = ln_inputs(t=192, c=2176)
    zb, gb = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (z, g))
    got = wide_backward_order(zb, gb, gamma, m)
    rdz, rdg, rdb = jax_ln.ln_dp_add_bwd_pallas(jnp.asarray(z, jnp.bfloat16),
                                                jnp.asarray(g, jnp.bfloat16), jnp.asarray(gamma),
                                                jnp.asarray(m))
    plain = ln_kernels.ln_dp_add_bwd_reference(torch.from_numpy(zb).bfloat16(),
                                               torch.from_numpy(gb).bfloat16(),
                                               torch.from_numpy(gamma), torch.from_numpy(m))
    dz16 = torch.from_numpy(got[0]).bfloat16().float().numpy()
    for ref in (np.asarray(rdz, np.float32), plain[0].float().numpy()):
        assert_close_ulps(dz16, ref, 1, 0.01)
    for a, r, p in ((got[1], rdg, plain[1]), (got[2], rdb, plain[2])):
        for ref in (np.asarray(r, np.float32).reshape(-1), p.numpy()):
            assert np.abs(a - ref).max() <= 1e-5 * np.abs(ref).max()
    plans = {c: ln_kernels.wide_bwd_plan(c) for c in (2176, 3072, 3200, 3328, 4096, 14464, 14592)}
    assert [plans[c]["rows"] for c in plans] == [8, 8, 8, 7, 6, 1, 0]
    assert all(p["smem"] <= 232448 for p in plans.values())


def ln_leaves(dtype, batch=3):
    """z, x [batch, 4, 8, 128] in dtype, gamma, beta [128], m [batch] (0, 1/keep
    and 1), and the output cotangent."""
    tdt = getattr(torch, dtype)
    z, x, gamma, beta, _, g = ln_inputs(t=batch * 32, c=128)
    shape = (batch, 4, 8, 128)
    m = np.array([0.0, np.float32(1.0) / np.float32(0.9), 1.0], np.float32)[:batch]
    leaves = [torch.from_numpy(z).reshape(shape).to(tdt), torch.from_numpy(x).reshape(shape).to(tdt),
              torch.from_numpy(gamma), torch.from_numpy(beta)]
    return [t.requires_grad_() for t in leaves], torch.from_numpy(m), \
        torch.from_numpy(g).reshape(shape).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_function_matches_the_jax_vjp(dtype):
    """fused_ln_droppath_add and its autograd Function against the JAX entry
    point and jax.vjp of its custom_vjp (interpret mode), per-sample m:
    output, dz, dx (the cotangent itself), dgamma and dbeta, with the JAX
    gradient dtypes. Measured: bit-equal in bf16 but for dgamma/dbeta (fp32
    sums in another order, 1e-7 of their scale; bound 1e-5)."""
    leaves, m, g = ln_leaves(dtype)
    args = [jnp.asarray(t.detach().float().numpy(), dtype if i < 2 else "float32")
            for i, t in enumerate(leaves)]
    ref, vjp = jax.vjp(lambda *a: jax_ln.fused_ln_droppath_add(*a, jnp.asarray(m.numpy())), *args)
    ref_grads = vjp(jnp.asarray(g.float().numpy(), dtype))
    out = ln_kernels.fused_ln_droppath_add(*leaves, m)
    out.backward(g)
    assert out.dtype == leaves[0].dtype
    assert_close_ulps(out.detach().float().numpy(), np.asarray(ref, np.float32), 1, 0.01)
    torch.testing.assert_close(leaves[1].grad, g, rtol=0, atol=0)  # dx is the cotangent
    for name, leaf, r in zip(("dz", "dx", "dgamma", "dbeta"), leaves, ref_grads):
        r = np.asarray(r, np.float32)
        assert leaf.grad.dtype == leaf.dtype, name
        if name in ("dz", "dx"):
            assert_close_ulps(leaf.grad.float().numpy(), r, 1, 0.01)
        else:
            assert np.abs(leaf.grad.numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


def test_ln_function_matches_an_fp64_oracle():
    """The Function in fp32 against autograd through the unrounded fp64 math
    x + m (LN(z) gamma + beta): with no bf16 site in fp32 the agreement is that
    of fp32 sums (measured at most 4e-7 of a gradient's scale, bound 1e-5)."""
    leaves, m, g = ln_leaves("float32")
    ln_kernels.fused_ln_droppath_add(*leaves, m).backward(g)
    z, x, gamma, beta = oracle = [t.detach().double().requires_grad_() for t in leaves]
    y = torch.nn.functional.layer_norm(z, (128,), gamma, beta, eps=1e-5)
    (x + m.double().reshape(-1, 1, 1, 1) * y).backward(g.double())
    for name, leaf, r in zip(("dz", "dx", "dgamma", "dbeta"), leaves, oracle):
        ref = r.grad.numpy()
        assert np.abs(leaf.grad.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), name


def test_ln_cpu_dispatch_and_kernel_wrappers():
    """On CPU tensors the Function returns exactly the plain versions; the
    kernel wrappers refuse CPU tensors; supported() is JAX's condition."""
    leaves, m, g = ln_leaves("bfloat16")
    out = ln_kernels.fused_ln_droppath_add(*leaves, m)
    z2, x2 = (t.detach().reshape(96, 128) for t in leaves[:2])
    m2 = m.repeat_interleave(32).reshape(96, 1)
    torch.testing.assert_close(out.reshape(96, 128), ln_kernels.ln_dp_add_fwd_reference(
        z2, x2, leaves[2].detach(), leaves[3].detach(), m2), rtol=0, atol=0)
    out.backward(g)
    dz, dgamma, dbeta = ln_kernels.ln_dp_add_bwd_reference(z2, g.reshape(96, 128),
                                                           leaves[2].detach(), m2)
    for leaf, want in zip((leaves[0], leaves[2], leaves[3]), (dz.reshape(leaves[0].shape),
                                                              dgamma, dbeta)):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ln_kernels.ln_dp_add_fwd(z2, x2, leaves[2].detach(), leaves[3].detach(), m2)
    with pytest.raises(ValueError, match="CUDA"):
        ln_kernels.ln_dp_add_bwd(z2, x2, leaves[2].detach(), m2)
    with pytest.raises(ValueError, match="m must be"):
        ln_kernels.fused_ln_droppath_add(*leaves, m[:2])
    for tokens, channels in ((64800, 768), (288, 128), (288, 64), (100, 128), (96, 192)):
        assert ln_kernels.supported(tokens, channels) == jax_ln.supported(tokens, channels)


def lnadd_forward_and_grads(dtype, seed=1):
    jm, tree, tm = micro_models(dtype, seed=seed, drop_path_rate=0.0, scan_blocks=False, **LNADD)
    assert all(blk.lnadd_impl == "fused" for blk in tm.model.blocks)
    jp, _ = micro_configs(dtype, **LNADD)
    x, _, ct = rollout_inputs(jp, 0)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    calls = []
    real = ln_kernels.LnDropPathAdd.apply
    with mock.patch.object(ln_kernels.LnDropPathAdd, "apply",
                           side_effect=lambda *a: calls.append(1) or real(*a)):
        out, grads = port_forward_and_grads(tm, x, None, ct)
    assert len(calls) == 2 * len(tm.model.blocks)  # both branches of every block
    return (ref, ref_grads), (out, grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lnadd_model_matches_jax(dtype):
    """The micro model with ``lnadd_impl: fused`` (embed 128, so the route's
    shape condition holds) against JAX with the same key: the forward and
    every parameter gradient (the norm scales and biases through the fused
    backward), deterministic mode, with the bounds of tests/test_torch_model.py
    (fp32: forward 5e-3 / 1e-4, gradients 2e-2 / 1e-2 per leaf; bf16: 3e-2 /
    4e-3 and 0.15 / 0.08). In bf16, logit_scale (two entries, each a sum over
    every score with heavy cancellation) has its own bound, 0.3 / 0.2, as in
    tests/test_torch_multistep.py: measured 0.16 / 0.11 between the two, while
    each side is 0.24 (port) and 0.07 (JAX) from the fp32 gradient; every
    other leaf measures at most 0.039."""
    (ref, ref_grads), (out, grads) = lnadd_forward_and_grads(dtype)
    fwd_tol, grad_tol, scale_tol = {
        "float32": ((5e-3, 1e-4), (2e-2, 1e-2), (2e-2, 1e-2)),
        "bfloat16": ((3e-2, 4e-3), (0.15, 0.08), (0.3, 0.2))}[dtype]
    assert_rel_close(out, ref, *fwd_tol)
    errs = leaf_rel_errors(grads, ref_grads)
    assert any("norm1" in k for k in errs)
    for name, (max_err, mean_err) in errs.items():
        tol = scale_tol if "logit_scale" in name else grad_tol
        assert max_err <= tol[0] and mean_err <= tol[1], (name, max_err, mean_err)


def test_lnadd_falls_back_where_jax_does():
    """At embed 64 (C % 128 != 0) the fused route's shape condition fails and
    the model takes the unfused branch, as JAX's _ln_branch does: the output
    is bit for bit the ``xla`` route's, and the fused op never runs. Invalid
    values are refused."""
    _, _, fused = micro_models("bfloat16", seed=1, lnadd_impl="fused")
    _, tp = micro_configs("bfloat16")
    plain = get_model(tp, device="cpu")
    plain.load_state_dict(fused.state_dict())
    x, _, _ = rollout_inputs(tp, 0)
    with mock.patch.object(ln_kernels, "fused_ln_droppath_add") as op, torch.no_grad():
        out = fused(torch.from_numpy(x))
    assert not op.called
    with torch.no_grad():
        torch.testing.assert_close(out, plain(torch.from_numpy(x)), rtol=0, atol=0)
    tp["lnadd_impl"] = "pallas"
    with pytest.raises(ValueError, match="lnadd_impl"):
        get_model(tp, device="cpu")


def test_lnadd_train_mode_uses_the_same_drop_path_draws():
    """In train mode the fused route takes the same uniforms as the unfused
    one: the multiplier is (u < keep) / keep per sample, 1 at rate 0, and in
    fp32 compute the two routes agree to fp32 rounding (y m against y mask /
    keep; measured 1.2e-7 of the scale, bound 1e-6); a dropped sample's
    branch adds exactly nothing."""
    u = torch.tensor([0.05, 0.95, 0.5, 0.3])
    m = swin.drop_path_multiplier(4, 0.4, u, "cpu")
    keep = float(np.float32(1.0) - np.float32(0.4))
    torch.testing.assert_close(m, torch.tensor([1.0, 0.0, 1.0, 1.0]) / keep, rtol=0, atol=0)
    torch.testing.assert_close(swin.drop_path_multiplier(4, 0.0, u, "cpu"), torch.ones(4))
    torch.testing.assert_close(swin.drop_path_multiplier(4, 0.4, None, "cpu"), torch.ones(4))

    _, _, fused = micro_models("float32", seed=1, drop_path_rate=0.5, **LNADD)
    _, tp = micro_configs("float32", drop_path_rate=0.5, embed_dim=128)
    plain = get_model(tp, device="cpu")
    plain.load_state_dict(fused.state_dict())
    x, _, _ = rollout_inputs(tp, 0, batch=4)
    with torch.no_grad():
        a = fused(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(5))
        b = plain(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(5))
        ev = fused(torch.from_numpy(x))
    assert not torch.equal(a, ev)
    assert_rel_close(a.numpy(), b.numpy(), 1e-6, 1e-7)
    blk = fused.model.blocks[1]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 12, 24, 128)).astype(
        np.float32))
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 24, 128)).astype(
        np.float32))
    out = blk._ln_branch(blk.norm1, y, z, 0.5, torch.tensor([0.9, 0.1]))
    assert torch.equal(out[0], z[0]) and not torch.equal(out[1], z[1])
