"""PyTorch port, the CPB family (``rel_pos: True``): the relative-coordinate
tables, the meta-MLP and the bias assembly, K7's plain versions (the
qkv-fused window attention with the pre-folded CPB term) and the micro model,
each against the JAX package on the same numpy inputs (its Pallas kernels in
interpret mode), plus the CPB dropout under the per-step checkpoint.

Every parameter, LayerNorm scales included, is drawn from numpy noise
(``noise_params``), so no block is the identity map. Kernel tolerances are in
bf16 ulps of the output scale (tests/test_torch_kernels.py), model
tolerances relative to the output or gradient-leaf scale
(tests/test_torch_model.py).
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.models import swin as jax_swin
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_torch.models import swin
from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import mlp_kernels, window_attention

from test_torch_kernels import (HEADS, WINDOW, assert_close_backward, assert_close_ulps,
                                attention_inputs, cotangent, cpb_badd, mask_pattern)
from test_torch_model import assert_rel_close, leaf_rel_errors, micro_configs, micro_models, \
    noise_params
from test_torch_multistep import jax_forward_and_grads, port_forward_and_grads, rollout_inputs

torch.set_num_threads(1)

CPB = dict(rel_pos=True, full_pos_embed=False)


def cpb_grad_errors(got, ref, zero_tol):
    """leaf_rel_errors over every leaf but ``meta_mlp/fc2/bias``. That one's
    exact gradient is 0: it adds one constant to every logit of a head, and
    the softmax VJP's rows sum to zero. Both sides' values are rounding noise
    and are held instead to |g| <= zero_tol * max |d meta_mlp/fc2/kernel|."""
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(got)}
    errs = leaf_rel_errors(got, ref)
    zero = [k for k in errs if k.endswith("['meta_mlp']['fc2']['bias']")]
    assert zero
    for key in zero:
        del errs[key]
        scale = np.abs(flat[key.replace("['bias']", "['kernel']")]).max()
        ref_leaf = np.asarray(dict((jax.tree_util.keystr(k), v) for k, v in
                                   jax.tree_util.tree_leaves_with_path(ref))[key])
        assert max(np.abs(flat[key]).max(), np.abs(ref_leaf).max()) <= zero_tol * scale, key
    return errs


# --------------------------------------------------------------------------
# coordinate tables, meta-MLP, bias assembly
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [(2, 4), (3, 6), (4, 4), (9, 18)])
def test_coordinate_tables_match_jax_bit_for_bit(window):
    """The pairwise [L*L, 2] table, the distinct-delta table [D, 2] and its
    index are bit-equal to JAX's (fp32 cast before log1p), and the distinct
    table expands to the pairwise one exactly."""
    full = swin.make_log_relative_coords(window)
    coords, idx = swin.make_log_relative_coords_unique(window)
    ref_coords, ref_idx = jax_swin.make_log_relative_coords_unique(window)
    assert full.dtype == coords.dtype == np.float32 and idx.dtype == np.int32
    np.testing.assert_array_equal(full, jax_swin.make_log_relative_coords(window))
    np.testing.assert_array_equal(coords, ref_coords)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(coords[idx], full)
    wh, ww = window
    assert coords.shape == ((2 * wh - 1) * (2 * ww - 1), 2)


def jax_attention_bias(dtype, cpb_unique, seed=0):
    """(noise parameter tree, the folded bias JAX's WindowAttention hands its
    kernel) at the micro model's window (2x4, embed 64, 2 heads)."""
    dim, heads, window, feat = 64, 2, (2, 4), (4, 8)
    jdt = getattr(jnp, dtype)
    attn = jax_swin.WindowAttention(dim=dim, num_heads=heads, window_size=window, rel_pos=True,
                                    dtype=jdt, attn_impl="pallas_qkv", cpb_unique=cpb_unique)
    x = jnp.zeros((1, *feat, dim), jdt)
    shapes = jax.eval_shape(lambda: attn.init(jax.random.key(0), x, grid_input=True))["params"]
    tree = noise_params(shapes, np.random.default_rng(seed))
    captured = {}

    def capture(x, *args, bias=None, **kwargs):
        captured["bias"] = np.asarray(bias)
        return jnp.zeros(x.shape, x.dtype)

    with mock.patch.object(jax_wa, "fused_window_attention_qkv", side_effect=capture):
        attn.apply({"params": tree}, x, grid_input=True)
    return tree, captured["bias"]


@pytest.mark.parametrize("cpb_unique", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpb_bias_matches_jax(dtype, cpb_unique):
    """CpbMlp + expansion + fold against the folded [heads, L, L] bias JAX's
    WindowAttention passes to its kernel, on the same weights. fp32: the
    meta-MLP's fc2 sums 384 products in another order (measured max 1.9e-7 of
    the scale, bound 1e-5). bf16: every Dense output rounds to bf16 and a
    rounding flips now and then (bound one bf16 ulp, mean 0.05 ulp)."""
    tree, ref = jax_attention_bias(dtype, cpb_unique)
    attn = swin.WindowAttention(64, 2, (2, 4), getattr(torch, dtype), rel_pos=True,
                                cpb_unique=cpb_unique)
    attn.load_state_dict(params_from_jax(tree))
    assert attn.cpb_rows == (21 if cpb_unique else 64)
    scale = torch.exp(torch.clamp(attn.logit_scale, max=np.log(100.0)))
    with torch.no_grad():
        got = attn.cpb_bias(scale).numpy()
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (2, 8, 8)
    # folded: every row's largest entry is -scale (the row-max shift)
    np.testing.assert_array_equal(got.max(-1), np.broadcast_to(-scale.detach().numpy()[:, None],
                                                               (2, 8)))
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert_close_ulps(got, ref, 1, 0.05)


def test_cpb_unique_and_per_pair_give_bit_equal_outputs():
    """The micro CPB model on the distinct deltas (gather) and per pair gives
    bit-equal eval outputs (each pair's meta-MLP row is its delta's row), and
    gradients equal to fp32 resolution (scatter-add against direct sums, as
    JAX's test_model_output_and_grads_match_full_pairs bounds them: 2e-5),
    but for meta_mlp/fc2/bias, whose exact gradient is 0 (cpb_grad_errors)."""
    _, _, unique = micro_models("float32", seed=1, drop_path_rate=0.0, **CPB)
    _, tp = micro_configs("float32", cpb_unique=False, **CPB)
    pair = get_model(tp, device="cpu")
    pair.load_state_dict(unique.state_dict())
    assert unique.model.blocks[0].attn.cpb_rows == 21 and pair.model.blocks[0].attn.cpb_rows == 64
    x, _, ct = rollout_inputs(tp, 0)
    out_u, grads_u = port_forward_and_grads(unique, x, None, ct)
    out_p, grads_p = port_forward_and_grads(pair, x, None, ct)
    np.testing.assert_array_equal(out_u, out_p)
    errs = cpb_grad_errors(grads_u, grads_p, zero_tol=1e-5)
    assert max(e[0] for e in errs.values()) <= 2e-5, errs


# --------------------------------------------------------------------------
# K7's plain versions
# --------------------------------------------------------------------------


def k7_leaves(dtype, prefolded):
    tdt = getattr(torch, dtype)
    x, w, b, scale = attention_inputs()
    bias = cpb_badd() if prefolded else torch.from_numpy(
        (2.0 * np.random.default_rng(9).standard_normal(cpb_badd().shape)).astype(np.float32))
    leaves = [torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b),
              torch.from_numpy(scale), bias]
    return [t.requires_grad_() for t in leaves]


@pytest.mark.parametrize("prefolded", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_bias_plain_matches_jax(dtype, use_mask, prefolded):
    """The entry point with a CPB bias (K7's plain versions on the CPU) against
    JAX's fused_window_attention_qkv(..., bias, bias_prefolded) and its VJP,
    which run _build_qkv_bias's Pallas kernels in interpret mode: the output
    and dx, dW, db, dscale, dbias. With ``prefolded`` the bias is the folded
    term badd; without, the raw bias, which both fold inside the Function with
    no gradient through the fold. Measured: out max 1 ulp (one flipped bf16
    intermediate), dx 0.25, dW 0.5, db 0.06, dbias 0.08 ulps, dscale 6.4e-4
    absolute."""
    patt = mask_pattern() if use_mask else None
    leaves = k7_leaves(dtype, prefolded)
    args = [jnp.asarray(t.detach().float().numpy(), dtype if i < 2 else "float32")
            for i, t in enumerate(leaves)]
    ref, vjp = jax.vjp(lambda *a: jax_wa.fused_window_attention_qkv(
        *a[:4], WINDOW, patt, bias=a[4], bias_prefolded=prefolded), *args)
    ct = cotangent()
    ref_grads = vjp(jnp.asarray(ct, dtype))
    out = window_attention.fused_window_attention_qkv(*leaves[:4], WINDOW, patt, bias=leaves[4],
                                                      bias_prefolded=prefolded)
    out.backward(torch.from_numpy(ct).to(out.dtype))
    assert out.dtype == leaves[0].dtype
    assert_close_ulps(out.detach().float().numpy(), np.asarray(ref, np.float32), 2, 0.01)
    for name, leaf, r in zip(("dx", "dW", "db", "dscale", "dbias"), leaves, ref_grads):
        assert leaf.grad.dtype == leaf.dtype
        assert_close_backward(name, leaf.grad.float().numpy(), np.asarray(r, np.float32))


def unrounded_attention_with_bias(x, w, b, scale, badd, patt):
    """The attention with the CPB term in fp64 without any bf16 rounding:
    z = (qn . kn) scale + badd (+ mask), for autograd."""
    from test_torch_kernels import B, C, H, W

    from swin_v2_weather_torch.models.swin import window_partition, window_reverse

    l, hd = WINDOW[0] * WINDOW[1], C // HEADS
    qkv = window_partition(x @ w + b, WINDOW).reshape(-1, l, 3, HEADS, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    z = (q @ k.transpose(-1, -2)) * scale.reshape(1, HEADS, 1, 1) + badd
    if patt is not None:
        nwh, nww = H // WINDOW[0], W // WINDOW[1]
        gate = torch.zeros(nwh, dtype=z.dtype)
        gate[-1] = 1.0
        z = z.reshape(B, nwh, nww, HEADS, l, l) + gate.reshape(1, nwh, 1, 1, 1, 1) * \
            torch.from_numpy(patt).double()
        z = z.reshape(-1, HEADS, l, l)
    out = (torch.softmax(z, -1) @ v).permute(0, 2, 1, 3).reshape(-1, *WINDOW, C)
    return window_reverse(out, WINDOW, (H, W))


@pytest.mark.parametrize("use_mask", [False, True])
def test_qkv_bias_backward_matches_unrounded_oracle(use_mask):
    """K7's plain backward (fp32 compute) against autograd through the
    unrounded fp64 math, dbias included. The kernels' bf16 sites (qkv, qn/kn,
    p, ds, dqkv) bound the agreement: measured max 0.8 % of the gradient's
    scale for dx, dW and db, 1.3 % for dbias and 4 % for dscale, a sum with
    cancellation; bounds 3 % and 10 %."""
    patt = mask_pattern() if use_mask else None
    ct = torch.from_numpy(cotangent())
    leaves = k7_leaves("float32", prefolded=True)
    window_attention.fused_window_attention_qkv(*leaves[:4], WINDOW, patt, bias=leaves[4],
                                                bias_prefolded=True).backward(ct)
    oracle = [t.detach().double().requires_grad_() for t in leaves]
    unrounded_attention_with_bias(*oracle, patt).backward(ct.double())
    for name, leaf, r in zip(("dx", "dW", "db", "dscale", "dbias"), leaves, oracle):
        ref = r.grad.numpy()
        bound = (0.1 if name == "dscale" else 0.03) * np.abs(ref).max()
        assert np.abs(leaf.grad.double().numpy() - ref).max() <= bound, name


def test_bias_function_saves_badd_and_dispatches_plain_on_cpu():
    """On CPU tensors the bias Function returns exactly what the plain
    versions compute, and the kernel wrappers refuse CPU tensors."""
    leaves = k7_leaves("bfloat16", prefolded=True)
    ct = torch.from_numpy(cotangent()).bfloat16()
    out = window_attention.fused_window_attention_qkv(*leaves[:4], WINDOW, mask_pattern(),
                                                      bias=leaves[4], bias_prefolded=True)
    args = [t.detach() for t in leaves]
    torch.testing.assert_close(out, window_attention.window_attention_qkv_bias_reference(
        *args, WINDOW, mask_pattern()), rtol=0, atol=0)
    out.backward(ct)
    ref = window_attention.window_attention_qkv_bias_backward_reference(*args, ct, WINDOW,
                                                                        mask_pattern())
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.to(leaf.dtype), rtol=0, atol=0)
    x, w16, b, scale, badd = args
    with pytest.raises(ValueError, match="CUDA"):
        window_attention.window_attention_qkv_bias(x, w16, b, scale, badd, WINDOW)
    with pytest.raises(ValueError, match="CUDA"):
        window_attention.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, x, WINDOW)


def test_fold_adds_the_scale_term_to_dscale():
    """The model folds with fold_cpb_bias outside the Function, so d(scale)
    is the kernel's dscale plus the fold's -sum(d_badd) over [L, L], and
    d(raw bias) is d(badd) (the row max is detached), as JAX's model gets it
    through its fold."""
    x, w, b, scale = (torch.from_numpy(a) for a in attention_inputs())
    raw = torch.from_numpy((2.0 * np.random.default_rng(9).standard_normal(
        (HEADS, 162, 162))).astype(np.float32)).requires_grad_()
    scale = scale.clone().requires_grad_()
    badd = window_attention.fold_cpb_bias(raw, scale)
    badd.retain_grad()
    ct = torch.from_numpy(cotangent())
    window_attention.fused_window_attention_qkv(x, w, b, scale, WINDOW, bias=badd,
                                                bias_prefolded=True).backward(ct)
    kernel = window_attention.window_attention_qkv_bias_backward_reference(
        x, w, b, scale.detach(), badd.detach(), ct, WINDOW)
    torch.testing.assert_close(raw.grad, badd.grad, rtol=0, atol=0)
    torch.testing.assert_close(badd.grad, kernel[4], rtol=0, atol=0)
    want = kernel[3] - kernel[4].sum(dim=(1, 2))
    torch.testing.assert_close(scale.grad, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the micro CPB model
# --------------------------------------------------------------------------


def cpb_forward_and_grads(dtype, seed=1):
    jm, tree, tm = micro_models(dtype, seed=seed, drop_path_rate=0.0, scan_blocks=False, **CPB)
    assert all(blk.attn.meta_mlp is not None for blk in tm.model.blocks)
    assert tm.model.pos_embed is None
    jp, _ = micro_configs(dtype, **CPB)
    x, _, ct = rollout_inputs(jp, 0)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    out, grads = port_forward_and_grads(tm, x, None, ct)
    return (ref, ref_grads), (out, grads)


def test_cpb_model_matches_jax_float32():
    """The micro model with ``rel_pos: True, full_pos_embed: False`` against
    JAX in fp32 compute (deterministic mode): the forward, with the bounds of
    tests/test_torch_model.py (max 5e-3, mean 1e-4 of the output scale;
    measured 1.6e-3 and 7.8e-6), and every parameter gradient, meta_mlp and
    logit_scale included (per leaf max 2e-2, mean 1e-2; measured 3.0e-3 and
    1.6e-3). meta_mlp/fc2/bias, exactly 0, measures 2.4e-7 of the fc2 kernel
    gradient's scale on either side (bound 1e-5)."""
    (ref, ref_grads), (out, grads) = cpb_forward_and_grads("float32")
    assert_rel_close(out, ref, 5e-3, 1e-4)
    errs = cpb_grad_errors(grads, ref_grads, zero_tol=1e-5)
    assert any("meta_mlp" in k for k in errs) and any("logit_scale" in k for k in errs)
    assert max(e[0] for e in errs.values()) <= 2e-2, errs
    assert max(e[1] for e in errs.values()) <= 1e-2, errs


def test_cpb_model_matches_jax_bfloat16():
    """The same in bf16 compute, with the bounds of tests/test_torch_model.py:
    forward max 3e-2 / mean 4e-3 (measured 1.7e-2 / 2.0e-3), gradients per
    leaf 0.15 / 0.08 (measured 0.11 / 0.066, logit_scale), and the port's
    distance to the fp32 JAX results no more than 1.5 x JAX's own.
    meta_mlp/fc2/bias, exactly 0, is bf16 rounding noise on both sides
    (measured 4.2e-3 of the fc2 kernel gradient's scale, bound 2e-2)."""
    (ref32, ref32_grads), _ = cpb_forward_and_grads("float32")
    (ref, ref_grads), (out, grads) = cpb_forward_and_grads("bfloat16")
    assert_rel_close(out, ref, 3e-2, 4e-3)
    assert np.abs(out - ref32).mean() <= 1.5 * np.abs(ref - ref32).mean()
    errs = cpb_grad_errors(grads, ref_grads, zero_tol=2e-2)
    assert max(e[0] for e in errs.values()) <= 0.15, errs
    assert max(e[1] for e in errs.values()) <= 0.08, errs
    err_port = sum(e[1] for e in cpb_grad_errors(grads, ref32_grads, 2e-2).values())
    err_jax = sum(e[1] for e in cpb_grad_errors(jax.tree.map(np.asarray, ref_grads),
                                                ref32_grads, 2e-2).values())
    assert err_port <= 1.5 * err_jax, (err_port, err_jax)


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_meta_mlp_weights_round_trip(scan_blocks):
    """JAX tree -> state_dict -> JAX tree exactly, ``meta_mlp/fc1`` and
    ``fc2`` of every block included, in both block layouts; the generic
    conversion maps them to ``attn.meta_mlp.fc{1,2}`` with no special case."""
    _, tree, tm = micro_models(scan_blocks=scan_blocks, **CPB)
    state = params_from_jax(tree)
    assert set(state) == set(tm.state_dict())
    assert "model.blocks.1.attn.meta_mlp.fc2.weight" in state
    blk = tree["model"]["pairs"]["block1"] if scan_blocks else tree["model"]["block1"]
    kernel = blk["attn"]["meta_mlp"]["fc2"]["kernel"]
    np.testing.assert_array_equal(state["model.blocks.1.attn.meta_mlp.fc2.weight"].numpy(),
                                  (kernel[0] if scan_blocks else kernel).T)
    back = params_to_jax(state, scan_blocks=scan_blocks)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# the CPB dropout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpb_dropout_statistics(dtype):
    """The hidden-layer dropout of the meta-MLP in train mode: a unit is kept
    with probability 0.875 (within 4 sigma over 595 x 384 draws), a kept unit
    is the eval value times 1/0.875 in the compute dtype, a dropped one is 0,
    and the same uniforms give the same mask."""
    tdt = getattr(torch, dtype)
    mlp = swin.CpbMlp(8)
    coords = torch.from_numpy(swin.make_log_relative_coords_unique((9, 18))[0].copy())
    u = torch.rand((coords.shape[0], 384), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h_eval = mlp.hidden_units(coords, tdt)
        h = mlp.hidden_units(coords, tdt, u)
    live = h_eval != 0
    kept = (h != 0) & live
    share = float(kept.sum()) / float(live.sum())
    n = float(live.sum())
    assert abs(share - 0.875) < 4 * np.sqrt(0.875 * 0.125 / n), share
    torch.testing.assert_close(h[kept], (h_eval / 0.875)[kept], rtol=0, atol=0)
    assert torch.equal(kept, (u < 0.875) & live)
    assert h.dtype == tdt and not torch.any(h[~kept])


def test_cpb_dropout_draws_one_mask_per_distinct_delta():
    """With ``cpb_unique`` the model draws the dropout uniforms per distinct
    delta ([depth, D, 384]), so all pairs with the same delta share one mask:
    the train-mode bias equals the per-pair model's when that one is handed
    the same uniforms gathered to every pair; without ``cpb_unique`` it draws
    [depth, L*L, 384]. Train mode changes the bias, eval mode does not draw."""
    _, _, unique = micro_models("float32", seed=1, drop_path_rate=0.0, **CPB)
    _, tp = micro_configs("float32", cpb_unique=False, **CPB)
    pair = get_model(tp, device="cpu")
    pair.load_state_dict(unique.state_dict())
    noise = unique.model.drop_noise(2, torch.Generator().manual_seed(3), "cpu")
    assert set(noise) == {"cpb"} and tuple(noise["cpb"].shape) == (2, 21, 384)
    assert tuple(pair.model.drop_noise(2, torch.Generator(), "cpu")["cpb"].shape) == (2, 64, 384)
    attn_u, attn_p = unique.model.blocks[0].attn, pair.model.blocks[0].attn
    scale = torch.exp(torch.clamp(attn_u.logit_scale, max=np.log(100.0)))
    with torch.no_grad():
        u = noise["cpb"][0]
        b_unique = attn_u.cpb_bias(scale, u)
        b_pair = attn_p.cpb_bias(scale, u[attn_u.cpb_idx])
        b_eval = attn_u.cpb_bias(scale)
    torch.testing.assert_close(b_unique, b_pair, rtol=0, atol=0)
    assert not torch.equal(b_unique, b_eval)
    with pytest.raises(ValueError, match="Generator"):
        unique.model.drop_noise(2, None, "cpu")


def test_remat_keeps_cpb_dropout_and_drop_path_masks_bit_identical():
    """The 4-step CPB model (``n_future: 3``) with the CPB dropout and
    drop-path live: the looped form with the per-step checkpoint, the looped
    form without it and the unrolled form give bit-identical outputs and
    gradients for one generator seed (every step's uniforms are drawn before
    the first step, so the recompute sees the masks of its forward). The
    checkpoint really recomputes, and the masks are live."""
    _, _, model = micro_models("bfloat16", seed=3, n_future=3, drop_path_rate=0.5, **CPB)
    _, tp = micro_configs("bfloat16", n_future=3, **CPB)
    x, zen, ct = (torch.from_numpy(a) for a in rollout_inputs(tp, 3, batch=4, seed=5))
    real_fwd = mlp_kernels.mlp_fwd_reference

    def run(looped, remat, seed=7):
        m = copy.deepcopy(model)
        m.looped, m.remat = looped, remat
        calls = []
        with mock.patch.object(mlp_kernels, "mlp_fwd_reference",
                               side_effect=lambda *a: calls.append(1) or real_fwd(*a)):
            out = m(x, zen, train=True, generator=torch.Generator().manual_seed(seed))
            torch.sum(out * ct).backward()
        return out.detach(), {n: p.grad for n, p in m.named_parameters()}, len(calls)

    out, grads, n_remat = run(True, True)
    n_calls = len(model.model.blocks) * 4
    assert n_remat == 2 * n_calls
    assert any("meta_mlp" in n for n in grads)
    for looped, remat in ((True, False), (False, False)):
        other, other_grads, n = run(looped, remat)
        assert n == n_calls
        assert torch.equal(out, other), (looped, remat)
        for name, g in grads.items():
            assert torch.equal(g, other_grads[name]), (looped, remat, name)
    assert not torch.equal(out, run(True, True, seed=8)[0])
    with torch.no_grad():
        assert not torch.equal(out, model(x, zen))


@pytest.mark.parametrize("cpb_unique", [True, False])
def test_get_model_builds_the_cpb_routes(cpb_unique):
    """The flagship config with bench.py's CPB overrides at micro geometry
    builds (either ``cpb_unique``), with a meta-MLP in every block and no
    position embedding, on the K7 route; a train-mode forward runs."""
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts

    p = YParams(default_config_path(), "swin_73var_geo_depth12_chweight_invar")
    micro = YParams(default_config_path(), "swin_micro_test")
    for key in ("img_size", "embed_dim", "num_heads", "patch_size", "window_ratio",
                "in_channels", "out_channels", "channel_names"):
        p[key] = micro[key]
    for key, val in dict(CPB, cpb_unique=cpb_unique, depth=2).items():
        p[key] = val
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    model = get_model(p, device="cpu")
    assert model.model.pos_embed is None
    assert all(blk.attn.cpb_rows == (21 if cpb_unique else 64) for blk in model.model.blocks)
    x = torch.zeros((1, int(p.n_in_channels), *p.img_size))
    calls = []
    real = window_attention.WindowAttentionQKVBias.apply
    with mock.patch.object(window_attention.WindowAttentionQKVBias, "apply",
                           side_effect=lambda *a: calls.append(1) or real(*a)):
        out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2 and bool(torch.isfinite(out).all())
