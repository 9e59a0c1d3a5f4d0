"""PyTorch port, multi-step fine-tune slice: the whole-MLP route (``mlp_impl:
fused2``) in the model, the multi-step wrapper in both its forms, drop-path
under the per-step checkpoint, the factory on the fine-tune and depth-24
configs, and the n_future-aware data pieces, each against the JAX package on
the same numpy inputs (its Pallas kernels in interpret mode).

Every parameter, LayerNorm scales included, is drawn from numpy noise
(``noise_params``), so no block is the identity map. Tolerances are relative
to the output (or gradient leaf) scale, as in tests/test_torch_model.py.
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.config.yparams import YParams as JaxYParams
from swin_v2_weather_tpu.data import preprocess as jax_preprocess
from swin_v2_weather_tpu.data import synthetic as jax_synthetic
from swin_v2_weather_tpu.ops import losses as jax_losses
from swin_v2_weather_tpu.models.wrappers import get_model as jax_get_model
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data import preprocess, synthetic
from swin_v2_weather_torch.data.preprocess import derived_channel_counts
from swin_v2_weather_torch.models.convert import params_from_jax, params_to_jax
from swin_v2_weather_torch.models.wrappers import MultiStepWrapper, SingleStepWrapper, get_model
from swin_v2_weather_torch.ops import losses, mlp_kernels

from test_torch_model import assert_rel_close, leaf_rel_errors, micro_configs, micro_models
from test_torch_training import loss_params, micro_params

torch.set_num_threads(1)


def rollout_inputs(p, n_future, batch=2, seed=2):
    """(x, future zenith or None, output cotangent) as numpy arrays."""
    rng = np.random.default_rng(seed)
    h, w = p.img_size
    x = rng.standard_normal((batch, int(p["n_in_channels"]), h, w)).astype(np.float32)
    zen = None
    if p.add_zenith:
        zen = rng.uniform(-1.0, 1.0, (batch, n_future + 1, h, w)).astype(np.float32)
    ct = rng.standard_normal((batch, (n_future + 1) * int(p["n_out_channels"]), h, w))
    return x, zen, ct.astype(np.float32)


def jax_forward_and_grads(jm, tree, x, zen, ct):
    """(output, parameter gradients of sum(output * ct)) of the JAX model."""

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x),
                       coszen=None if zen is None else jnp.asarray(zen))
        return jnp.sum(out * ct), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    return np.asarray(out), grads


def port_forward_and_grads(tm, x, zen, ct):
    out = tm(torch.from_numpy(x), None if zen is None else torch.from_numpy(zen))
    torch.sum(out * torch.from_numpy(ct)).backward()
    return out.detach().numpy(), params_to_jax({n: p.grad for n, p in tm.named_parameters()})


# --------------------------------------------------------------------------
# the whole-MLP route in the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused2_model_matches_jax_and_the_fused_route(dtype):
    """The micro model with ``mlp_impl: fused2`` against the JAX model with
    fused2 (forward and every parameter gradient), and against the port's own
    ``fused`` route on the same weights. Bounds as in
    tests/test_torch_model.py (fp32: forward max 5e-3 / mean 1e-4 of the
    output scale, gradients 2e-2 / 1e-2 per leaf; bf16: 3e-2 / 4e-3 and
    0.15 / 0.08). Measured against JAX: fp32 forward max 1.8e-3, gradients
    2.3e-3; bf16 forward 1.3e-2, gradients 5.9e-2. The two port routes round
    at the same sites: in fp32 they agree bit for bit; in bf16 the fused
    route's fc2 is a bf16 GEMM whose rounding now and then flips against the
    fp32 product of fused2 (forward max 9.4e-5, gradients 1.1e-2)."""
    over = dict(mlp_impl="fused2", drop_path_rate=0.0, scan_blocks=False)
    jm, tree, tm = micro_models(dtype, seed=1, **over)
    assert all(blk.mlp.impl == "fused2" for blk in tm.model.blocks)
    jp, tp = micro_configs(dtype, **over)
    x, _, ct = rollout_inputs(jp, 0)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, None, ct)
    out, grads = port_forward_and_grads(tm, x, None, ct)
    fwd_tol, grad_tol = {"float32": ((5e-3, 1e-4), (2e-2, 1e-2)),
                         "bfloat16": ((3e-2, 4e-3), (0.15, 0.08))}[dtype]
    assert_rel_close(out, ref, *fwd_tol)
    errs = leaf_rel_errors(grads, ref_grads)
    assert max(e[0] for e in errs.values()) <= grad_tol[0], errs
    assert max(e[1] for e in errs.values()) <= grad_tol[1], errs

    tp["mlp_impl"] = "fused"
    fused = get_model(tp, device="cpu")
    fused.load_state_dict(tm.state_dict())
    assert all(blk.mlp.impl == "fused" for blk in fused.model.blocks)
    out_fused, grads_fused = port_forward_and_grads(fused, x, None, ct)
    assert_rel_close(out, out_fused, *fwd_tol)
    errs = leaf_rel_errors(grads, jax.tree.map(np.asarray, grads_fused))
    assert max(e[0] for e in errs.values()) <= grad_tol[0], errs


# --------------------------------------------------------------------------
# the multi-step wrapper
# --------------------------------------------------------------------------


# fp32 compute; each step's output feeds the next step, so the per-step
# differences of the single-step model (max 1.3e-3 of the scale, from flipped
# bf16 roundings inside the attention kernel) carry through the rollout and
# its backward. Measured over the four cases at three seeds: forward max
# 4.4e-3 / mean 1.4e-4 of the output scale; gradients, worst leaf, max
# 2.4e-2 / mean 3.4e-3 of the leaf's scale, except logit_scale (the two
# per-head entries of dscale, a sum over every score of every step with heavy
# cancellation, the worst leaf in the single-step test too): max 8.5e-2 /
# mean 6.9e-2, and 3.3e-2 at the seed used here.
ROLLOUT_TOL = {"forward": (1e-2, 5e-4), "grads": (5e-2, 1e-2), "logit_scale": (0.15, 0.15)}


@pytest.mark.parametrize("n_future", [1, 3])
@pytest.mark.parametrize("zenith", [True, False])
def test_multistep_matches_jax(n_future, zenith):
    """The 2-step (unrolled) and 4-step (looped, per-step checkpoint) wrapper
    against the JAX MultiStepWrapper (unrolled / nn.scan with remat), with
    and without the future-zenith channel: the output, all steps' predictions
    concatenated, and every parameter gradient."""
    over = dict(n_future=n_future, add_zenith=zenith, drop_path_rate=0.0, scan_blocks=False)
    jm, tree, tm = micro_models("float32", seed=1, **over)
    assert isinstance(tm, MultiStepWrapper) and tm.looped == jm._use_scan() == (n_future >= 2)
    assert tm.remat and all(blk.mlp.impl == "fused2" for blk in tm.model.blocks)
    jp, _ = micro_configs("float32", **over)
    x, zen, ct = rollout_inputs(jp, n_future)
    ref, ref_grads = jax_forward_and_grads(jm, tree, x, zen, ct)
    out, grads = port_forward_and_grads(tm, x, zen, ct)
    assert out.shape == ref.shape == ct.shape
    assert_rel_close(out, ref, *ROLLOUT_TOL["forward"])
    for name, (max_err, mean_err) in leaf_rel_errors(grads, ref_grads).items():
        tol = ROLLOUT_TOL["logit_scale" if "logit_scale" in name else "grads"]
        assert max_err <= tol[0] and mean_err <= tol[1], (name, max_err, mean_err)


def test_bf16_rollout_stack_matches_jax():
    """``rollout_stack_dtype: bfloat16`` on the looped form: the carries and
    predictions are kept in bf16 and the output is returned in fp32, as JAX's
    stack_dtype does. fp32 compute, so the stack is the only bf16 rounding
    outside the attention kernel; a prediction differing in its last fp32
    bits now and then rounds to the neighbouring bf16 value on one side,
    which the next step carries on. Measured over three seeds: max 5.0e-3 /
    mean 1.9e-4 of the output scale, bounds 1e-2 / 4e-4; the fp32 stack is
    farther from JAX's bf16 result (mean 6.3e-4 to 8.8e-4 from the bf16
    stack), so the mean bound tells the two apart."""
    over = dict(n_future=3, rollout_stack_dtype="bfloat16", drop_path_rate=0.0)
    jm, tree, tm = micro_models("float32", seed=1, **over)
    assert tm.looped and tm.stack_dtype == torch.bfloat16
    jp, _ = micro_configs("float32", **over)
    x, zen, _ = rollout_inputs(jp, 3)
    ref = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(x), coszen=jnp.asarray(zen)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(zen))
        tm.stack_dtype = None
        out32 = tm(torch.from_numpy(x), torch.from_numpy(zen))
    assert out.dtype == torch.float32
    # every value of the output went through bf16
    torch.testing.assert_close(out, out.bfloat16().float(), rtol=0, atol=0)
    assert_rel_close(out.numpy(), ref, 1e-2, 4e-4)
    err, err32 = (np.abs(o.numpy() - ref).mean() for o in (out, out32))
    assert err32 > 2 * err, (err32, err)


def test_stack_dtype_on_the_unrolled_form_raises():
    """JAX ignores rollout_stack_dtype on the unrolled rollout without a word;
    the port refuses it."""
    _, tp = micro_configs(n_future=1, rollout_stack_dtype="bfloat16")
    with pytest.raises(ValueError, match="rollout_stack_dtype"):
        get_model(tp, device="cpu")
    tp["scan_rollout"] = True  # the looped form takes it
    assert get_model(tp, device="cpu").stack_dtype == torch.bfloat16


def test_remat_and_form_keep_drop_path_masks_bit_identical():
    """With drop-path live, the looped form with the per-step checkpoint, the
    looped form without it and the unrolled form give bit-identical outputs
    and gradients for one generator seed: each step's masks come from
    uniforms drawn before the first step, so the recompute in the backward
    sees the masks of the forward. The checkpoint really recomputes (twice
    the MLP forwards), and the masks are live (another seed, another output)."""
    _, _, model = micro_models("bfloat16", seed=3, n_future=3, drop_path_rate=0.5)
    _, tp = micro_configs("bfloat16", n_future=3)
    x, zen, ct = (None if a is None else torch.from_numpy(a)
                  for a in rollout_inputs(tp, 3, batch=4, seed=5))
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
    for looped, remat in ((True, False), (False, False)):
        other, other_grads, n = run(looped, remat)
        assert n == n_calls
        assert torch.equal(out, other), (looped, remat)
        for name, g in grads.items():
            assert torch.equal(g, other_grads[name]), (looped, remat, name)
    assert not torch.equal(out, run(True, True, seed=8)[0])
    with torch.no_grad():
        assert not torch.equal(out, model(x, zen))


@pytest.mark.parametrize("config, n_future, looped, depth", [
    ("swin_73var_geo_depth12_chweight_invar_2step", 1, False, 12),
    ("swin_73var_geo_depth12_chweight_invar_4step", 3, True, 12),
    ("swin_73var_geo_depth12_chweight_invar_8step", 7, True, 12),
    ("swin_73var_geo_depth24_chweight_invar", 0, None, 24),
])
def test_get_model_builds_the_finetune_and_depth24_routes(config, n_future, looped, depth):
    """The fine-tune and depth-24 configs at micro geometry (the micro
    config's grid, widths and channels; the config's own depth, rollout and
    MLP gating) build the wrapper JAX builds, on the whole-MLP route, and run
    a forward of the right shape on the CPU."""
    ps = []
    for cls in (JaxYParams, YParams):
        p = cls(default_config_path(), config)
        micro = cls(default_config_path(), "swin_micro_test")
        for key in ("img_size", "embed_dim", "num_heads", "patch_size", "window_ratio",
                    "in_channels", "out_channels", "channel_names"):
            p[key] = micro[key]
        p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
        ps.append(p)
    jm, model = jax_get_model(ps[0]), get_model(ps[1], device="cpu")
    assert type(model).__name__ == type(jm).__name__
    assert len(model.model.blocks) == depth
    assert all(blk.mlp.impl == "fused2" for blk in model.model.blocks)
    assert all(p.device.type == "cpu" for p in model.parameters())
    if n_future:
        assert isinstance(model, MultiStepWrapper) and model.n_future == n_future
        assert model.looped == jm._use_scan() == looped and model.remat
        assert model.n_invar == jm.n_invar == 3 and model.stack_dtype is None
    else:
        assert isinstance(model, SingleStepWrapper)
    x, zen, _ = rollout_inputs(ps[1], n_future, batch=1)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(zen))
    assert tuple(out.shape) == (1, (n_future + 1) * 4, 24, 48)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("scan_blocks", [True, False])
def test_weights_round_trip_through_the_wrapper(scan_blocks):
    """JAX tree -> state_dict -> the multi-step wrapper on the whole-MLP route
    -> state_dict -> JAX tree, exactly: the wrapper keeps the JAX tree's
    ``model`` prefix and the MLP keeps the ``fc1``/``fc2`` names."""
    jm, tree, tm = micro_models(n_future=3, scan_blocks=scan_blocks)
    assert isinstance(tm, MultiStepWrapper)
    assert set(tree) == {"model"} and "fc2" in str(jax.tree_util.tree_structure(tree))
    state = tm.state_dict()
    assert set(state) == set(params_from_jax(tree))
    back = params_to_jax(state, scan_blocks=scan_blocks)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# the n_future-aware data pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_future", [1, 3])
def test_synthetic_and_preprocessor_match_jax(tmp_path, n_future):
    """SyntheticDataset (targets and future zenith for every step) and the
    Preprocessor with device normalization (the target stats tiled over the
    steps) against JAX."""
    jp, tp = micro_params(n_future=n_future)
    rng = np.random.default_rng(11)
    np.save(tmp_path / "means.npy", rng.standard_normal((1, 4, 1, 1)))
    np.save(tmp_path / "stds.npy", np.abs(rng.standard_normal((1, 4, 1, 1))) + 0.5)
    for p in (jp, tp):
        p["host_normalize"] = False
        p["global_means_path"] = str(tmp_path / "means.npy")
        p["global_stds_path"] = str(tmp_path / "stds.npy")
    ours, ref = synthetic.SyntheticDataset(tp), jax_synthetic.SyntheticDataset(jp)
    for a, b in zip(ours[3], ref[3]):
        np.testing.assert_array_equal(a, b)
    batch = synthetic.collate([ours[0], ours[3]], device="cpu")
    assert batch["tar"].shape[1] == 4 * (n_future + 1)
    assert batch["zen_tar"].shape[1] == n_future + 1
    got = preprocess.Preprocessor(tp)(batch)
    want = jax_preprocess.Preprocessor(jp)({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_loss_handler_matches_jax_at_four_steps(tmp_path):
    """The multistep weight over four steps' channels (fp32 reductions in
    another order: rtol 1e-5)."""
    p = loss_params(tmp_path, "weighted absolute temp-std squared geometric l2", n_future=3)
    ours, ref = losses.LossHandler(p), jax_losses.LossHandler(p)
    rng = np.random.default_rng(7)
    prd, tar = (rng.standard_normal((2, 16, 24, 48)).astype(np.float32) for _ in range(2))
    got = ours(torch.from_numpy(prd), torch.from_numpy(tar))
    np.testing.assert_allclose(float(got), float(ref(jnp.asarray(prd), jnp.asarray(tar))),
                               rtol=1e-5)


def test_collate_defaults_to_the_gpu():
    """``collate`` puts the batch on the GPU unless the caller asks for
    another device (here there is none, so the default raises)."""
    _, tp = micro_params()
    sample = synthetic.SyntheticDataset(tp)[0]
    assert synthetic.collate([sample], device="cpu")["inp"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            synthetic.collate([sample])
