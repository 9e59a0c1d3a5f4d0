"""PyTorch port, training slice: quadrature, losses, metrics, the
preprocessor, the synthetic dataset, the schedules, Adam, and the train and
eval steps, each against its JAX counterpart on the same numpy inputs.

The 3-step trajectory runs the micro config on the qkv-fused route with
drop-path 0 (the two frameworks' dropout streams cannot match) and unrolled
blocks on the JAX side, so the per-block gradient-norm names line up; the JAX
step runs on a 1-device CPU mesh, with its Pallas kernels interpreted. It
runs single-step (fc1+GELU MLP kernels) and as the 2-step fine-tune
(``n_future: 1``: the unrolled multi-step wrapper on the whole-MLP kernels,
the multistep loss weight, the eval step on the final rollout step).
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from swin_v2_weather_tpu.config.yparams import default_config_path
from swin_v2_weather_tpu.data import preprocess as jax_preprocess
from swin_v2_weather_tpu.data import synthetic as jax_synthetic
from swin_v2_weather_tpu.ops import losses as jax_losses
from swin_v2_weather_tpu.ops import metrics as jax_metrics
from swin_v2_weather_tpu.ops import quadrature as jax_quadrature
from swin_v2_weather_tpu.parallel.mesh import make_mesh
from swin_v2_weather_tpu.training import optim as jax_optim
from swin_v2_weather_tpu.training import step as jax_step
from swin_v2_weather_torch.data import preprocess, synthetic
from swin_v2_weather_torch.models.convert import params_to_jax
from swin_v2_weather_torch.ops import losses, metrics, quadrature
from swin_v2_weather_torch.training import optim, step

from test_torch_model import micro_configs, micro_models

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# quadrature, losses, metrics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 7, 24])
def test_node_generators_match_jax(n):
    for ours, ref in ((quadrature.legendre_gauss_weights, jax_quadrature.legendre_gauss_weights),
                      (quadrature.clenshaw_curtiss_weights, jax_quadrature.clenshaw_curtiss_weights)):
        for a, b in zip(ours(n, -0.5, 2.0), ref(n, -0.5, 2.0)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rule", ["naive", "clenshaw-curtiss", "legendre-gauss"])
@pytest.mark.parametrize("normalize, pole_mask, crop", [
    (False, None, None), (True, 1, None), (True, 2, ((10, 40), (3, 5))),
])
def test_quadrature_weights_match_jax(rule, normalize, pole_mask, crop):
    shape, crop_shape, crop_offset = (24, 48), None, (0, 0)
    if crop is not None:
        crop_shape, crop_offset = crop
    args = (rule, shape, crop_shape, crop_offset, normalize, pole_mask)
    ref = jax_quadrature.quadrature_weights(*args)
    np.testing.assert_array_equal(quadrature.quadrature_weights(*args), ref)
    field = np.random.default_rng(0).standard_normal((2, 3, *ref.shape)).astype(np.float32)
    got = quadrature.GridQuadrature(rule, shape, crop_shape, crop_offset, normalize, pole_mask)(
        torch.from_numpy(field))
    want = jax_quadrature.GridQuadrature(rule, shape, crop_shape, crop_offset, normalize,
                                         pole_mask)(jnp.asarray(field))
    # fp32 sums over 1152 pixels in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _yaml_loss_specs():
    with open(default_config_path()) as f:
        doc = yaml.safe_load(f)
    return sorted({str(sec["loss"]) for sec in doc.values() if "loss" in sec})


CHANNELS = ["u10m", "t2m", "z500", "q700"]
LOSS_SPECS = sorted(set(_yaml_loss_specs()) | {
    "l1", "weighted l1", "geometric l2 pole-masked", "weighted relative squared geometric l1",
})


def loss_params(tmp_path, loss, n_future=0, stats=True):
    stds = np.abs(np.random.default_rng(0).normal(size=(1, 4, 1, 1))) + 0.5
    tstds = np.abs(np.random.default_rng(1).normal(size=(1, 4, 1, 1))) + 0.25
    np.save(tmp_path / "global_stds.npy", stds)
    np.save(tmp_path / "time_diff_stds.npy", tstds)
    missing = str(tmp_path / "missing.npy")
    return types.SimpleNamespace(
        loss=loss, n_future=n_future, img_shape_x=24, img_shape_y=48, n_out_channels=4,
        channel_names=CHANNELS, channel_weights="auto", out_channels=list(range(4)), dt=2,
        global_stds_path=str(tmp_path / "global_stds.npy") if stats else missing,
        time_diff_stds_path=str(tmp_path / "time_diff_stds.npy") if stats else missing,
        model_grid_type="equiangular", data_loader_config="synthetic",
    )


@pytest.mark.parametrize("spec", LOSS_SPECS)
@pytest.mark.parametrize("n_future, stats", [(0, True), (1, False)])
def test_loss_handler_matches_jax(tmp_path, spec, n_future, stats):
    """Every loss spec of swin.yaml (and the l1 / pole-masked words), with stats
    files and with the synthetic unit stats, single-step (in training and
    validation mode) and two-step (training mode: the multistep weight spans
    both steps' channels). fp32 reductions in another order: rtol 1e-5."""
    p = loss_params(tmp_path, spec, n_future, stats)
    ours, ref = losses.LossHandler(p), jax_losses.LossHandler(p)
    np.testing.assert_array_equal(ours.channel_weights.numpy(), np.asarray(ref.channel_weights))
    rng = np.random.default_rng(7)
    shape = (2, 4 * (n_future + 1), 24, 48)
    prd, tar = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for training in (True, False) if n_future == 0 else (True,):
        got = ours(torch.from_numpy(prd), torch.from_numpy(tar), training=training)
        want = ref(jnp.asarray(prd), jnp.asarray(tar), training=training)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_auto_weights_and_unported_losses(tmp_path):
    names = ["u10m", "v10m", "t2m", "sp", "z500", "t850", "q700", "r925", "xyz"]
    np.testing.assert_array_equal(losses.auto_channel_weights(names),
                                  jax_losses.auto_channel_weights(names))
    # the h1 word is ported (tests/test_torch_sht.py holds it to JAX); a spec
    # with no norm word still raises
    assert isinstance(losses.LossHandler(loss_params(tmp_path, "geometric h1")).loss_obj,
                      losses.GeometricH1Loss)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.LossHandler(loss_params(tmp_path, "geometric"))
    with pytest.raises(FileNotFoundError):
        p = loss_params(tmp_path, "temp-std l2", stats=False)
        p.data_loader_config = "era5"
        losses.LossHandler(p)


@pytest.mark.parametrize("num_lat", [24, 721])
def test_metrics_match_jax(num_lat):
    np.testing.assert_array_equal(metrics.latitude_weights(num_lat).numpy(),
                                  np.asarray(jax_metrics.latitude_weights(num_lat)))
    rng = np.random.default_rng(3)
    pred, tar = (rng.standard_normal((2, 3, num_lat, 16)).astype(np.float32) for _ in range(2))
    for name in ("weighted_rmse_channels", "weighted_rmse", "weighted_acc_channels",
                 "weighted_acc"):
        got = getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(tar))
        want = getattr(jax_metrics, name)(jnp.asarray(pred), jnp.asarray(tar))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


# --------------------------------------------------------------------------
# data: synthetic samples, preprocessor
# --------------------------------------------------------------------------


def micro_params(**over):
    jp, tp = micro_configs(**over)
    for p in (jp, tp):
        p["img_shape_x"], p["img_shape_y"] = p.img_size
        p["data_loader_config"] = "synthetic"
    return jp, tp


def test_synthetic_dataset_matches_jax():
    jp, tp = micro_params(n_future=1)
    ours, ref = synthetic.SyntheticDataset(tp), jax_synthetic.SyntheticDataset(jp)
    assert len(ours) == len(ref)
    for idx in (0, 5):
        for a, b in zip(ours[idx], ref[idx]):
            np.testing.assert_array_equal(a, b)
    batch = synthetic.collate([ours[0], ours[5]], device="cpu")
    assert set(batch) == {"inp", "tar", "zen_inp", "zen_tar"}
    assert batch["tar"].shape == (2, 8, *tp.img_size) and batch["zen_tar"].shape[1] == 2
    np.testing.assert_array_equal(batch["zen_inp"][1].numpy(), ref[5][2])


@pytest.mark.parametrize("device_normalize", [False, True])
def test_preprocessor_matches_jax(tmp_path, device_normalize):
    jp, tp = micro_params()
    if device_normalize:
        rng = np.random.default_rng(11)
        np.save(tmp_path / "means.npy", rng.standard_normal((1, 4, 1, 1)))
        np.save(tmp_path / "stds.npy", np.abs(rng.standard_normal((1, 4, 1, 1))) + 0.5)
        for p in (jp, tp):
            p["host_normalize"] = False
            p["global_means_path"] = str(tmp_path / "means.npy")
            p["global_stds_path"] = str(tmp_path / "stds.npy")
    ds = synthetic.SyntheticDataset(tp)
    batch = synthetic.collate([ds[0], ds[1]], device="cpu")
    got = preprocess.Preprocessor(tp)(batch)
    want = jax_preprocess.Preprocessor(jp)({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert got[0].shape[1] == int(tp["n_in_channels"])  # data | zenith | landmask x2 | orography
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# optimizer and schedules
# --------------------------------------------------------------------------


def test_schedulers_match_jax():
    p = types.SimpleNamespace(lr=1e-3, max_epochs=10, scheduler="CosineAnnealingLR")
    metrics_seq = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.95, 0.8, 0.8]
    for name in ("CosineAnnealingLR", "ReduceLROnPlateau", None):
        p.scheduler = name
        ours, ref = optim.build_scheduler(p), jax_optim.build_scheduler(p)
        assert type(ours).__name__ == type(ref).__name__
        lrs = [(ours.step(m), ref.step(m)) for m in metrics_seq]
        assert [a for a, _ in lrs] == [b for _, b in lrs]
        assert ours.state_dict() == ref.state_dict()
    resumed, fresh = optim.CosineAnnealingLR(1e-3, 10, last_epoch=3), jax_optim.CosineAnnealingLR(
        1e-3, 10, last_epoch=3)
    assert resumed.lr == fresh.lr


def test_adam_matches_optax():
    """Two Adam(0.9, 0.95) steps with a host-set learning rate equal optax's
    (same formula, fp32 rounding in another order)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3)]
    p = types.SimpleNamespace(optimizer_type="adam", lr=1e-3)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optim.build_optimizer(p, [w])
    optim.set_learning_rate(opt, 5e-4)
    assert optim.get_learning_rate(opt) == 5e-4
    ref_opt = optax.adam(5e-4, b1=0.9, b2=0.95)
    ref_w, state = jnp.asarray(w0), ref_opt.init(jnp.asarray(w0))
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        upd, state = ref_opt.update(jnp.asarray(g), state, ref_w)
        ref_w = optax.apply_updates(ref_w, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref_w), rtol=1e-6, atol=1e-8)
    # LAMB is ported (tests/test_torch_lamb.py holds it to optax); an unknown
    # optimizer type still raises
    lamb = optim.build_optimizer(types.SimpleNamespace(optimizer_type="FusedLAMB", lr=1e-3), [w])
    assert isinstance(lamb, optim.Lamb) and lamb.max_grad_norm == 5.0
    with pytest.raises(ValueError, match="not implemented"):
        optim.build_optimizer(types.SimpleNamespace(optimizer_type="sgd", lr=1e-3), [w])


# --------------------------------------------------------------------------
# the train and eval steps against JAX
# --------------------------------------------------------------------------

N_STEPS = 3
# fixture ids: the compute dtype, and "-2step" for the 2-step fine-tune;
# each maps to (compute dtype, n_future)
TRAJECTORIES = {"float32": ("float32", 0), "bfloat16": ("bfloat16", 0),
                "float32-2step": ("float32", 1), "bfloat16-2step": ("bfloat16", 1)}
# (loss, grad norms) relative bounds; measured over the 3 steps: fp32 1.3e-4 /
# 2.4e-4, bf16 5.3e-4 / 4.4e-3; 2-step fp32 2.8e-4 / 1.3e-3, bf16 3.4e-4 /
# 3.4e-3 (the rollout's backward goes through both steps' kernels)
STEP_RTOL = {"float32": (1e-3, 2e-3), "bfloat16": (3e-3, 2e-2),
             "float32-2step": (1e-3, 4e-3), "bfloat16-2step": (3e-3, 2e-2)}


@pytest.fixture(scope="module", params=list(TRAJECTORIES))
def trajectories(request):
    """(fixture id, JAX metrics per step, JAX params after the last step, port
    metrics per step, port model after the last step, JAX params at the start,
    lr), computed once per compute dtype and rollout length."""
    dtype, n_future = TRAJECTORIES[request.param]
    return (request.param, *train_trajectories(dtype, n_future))


def train_trajectories(dtype, n_future, **extra):
    """(JAX metrics per step, JAX params after the last step, port metrics per
    step, port model after the last step, JAX params at the start, lr) of
    N_STEPS train steps of the micro config on both sides (drop-path 0,
    unrolled blocks), with the config overrides ``extra`` (e.g. another
    ``attn_impl``) on both."""
    over = dict(drop_path_rate=0.0, scan_blocks=False, compute_dtype=dtype, n_future=n_future,
                **extra)
    jm, tree, tm = micro_models(dtype, seed=0, **{k: v for k, v in over.items()
                                                  if k != "compute_dtype"})
    jp, tp = micro_params(**over)
    samples = [jax_synthetic.SyntheticDataset(jp)[i] for i in range(2)]
    batch = {k: np.stack([s[i] for s in samples]) for i, k in enumerate(
        ("inp", "tar", "zen_inp", "zen_tar"))}

    mesh = make_mesh(None, devices=jax.devices()[:1])
    opt = jax_optim.build_optimizer(jp)
    state = jax_step.TrainState.create(jax.tree.map(jnp.asarray, tree), opt)
    jstep = jax_step.build_train_step(jm, jax_losses.LossHandler(jp),
                                      jax_preprocess.Preprocessor(jp), opt, mesh)
    jax_metrics_seq = []
    for _ in range(N_STEPS):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.key(0))
        jax_metrics_seq.append({k: float(v) for k, v in m.items()})
    jax_params = jax.tree.map(np.asarray, state.params)

    tstep = step.build_train_step(tm, losses.LossHandler(tp), preprocess.Preprocessor(tp),
                                  optim.build_optimizer(tp, tm.parameters()))
    tbatch = synthetic.collate([synthetic.SyntheticDataset(tp)[i] for i in range(2)],
                               device="cpu")
    port_metrics_seq = []
    for _ in range(N_STEPS):
        m = tstep(tbatch)
        assert all(v.dtype == torch.float32 and v.dim() == 0 for v in m.values())
        port_metrics_seq.append({k: float(v) for k, v in m.items()})
    return jax_metrics_seq, jax_params, port_metrics_seq, tm, tree, float(jp.lr)


def test_train_step_metrics_match_jax(trajectories):
    """Per-step loss, global grad norm and the per-module grad norms, under
    the JAX names (patch_embed, pos_embed, block{i}, head)."""
    traj, jax_seq, _, port_seq, _, _, _ = trajectories
    check_step_metrics(jax_seq, port_seq, *STEP_RTOL[traj])


def check_step_metrics(jax_seq, port_seq, loss_rtol, norm_rtol):
    """Every step's metrics within the relative bounds, and the loss falls."""
    for ours, ref in zip(port_seq, jax_seq):
        assert set(ours) == set(ref)
        assert {"grad_norm/block0", "grad_norm/block1", "grad_norm/head"} <= set(ref)
        for key in ref:
            rtol = loss_rtol if key == "loss" else norm_rtol
            assert ours[key] == pytest.approx(ref[key], rel=rtol), key
    assert port_seq[-1]["loss"] < port_seq[0]["loss"]


# Parameters after the 3 steps, in units of lr: (max per leaf, mean per leaf,
# share of all entries off by more than lr / 2). A gradient entry near zero
# may take the other sign on the two sides, which moves that entry's Adam
# update by up to 2 lr per step; all other entries agree far below lr.
# Measured (mean: the largest per-leaf mean): fp32 max 2.04, mean 0.010,
# share 1.6e-4 (19 of 121668 entries); bf16 max 4.22, mean 0.027, share
# 2.6e-3; 2-step fp32 max 2.03, mean 0.035 (a few flips in the 64-entry
# patch-embed LayerNorm scale), share 4.3e-4; 2-step bf16 max 3.69, mean
# 0.042, share 3.4e-3.
PARAM_TOL = {"float32": (3.0, 0.02, 1e-3), "bfloat16": (5.0, 0.1, 1e-2),
             "float32-2step": (3.0, 0.07, 1e-3), "bfloat16-2step": (5.0, 0.1, 1e-2)}


def test_train_step_params_match_jax(trajectories):
    """Every parameter after 3 Adam steps: each moved, none differs from JAX
    by more than the max bound, and sign flips stay rare (the share bound
    counts them over the whole model, the mean bound per leaf)."""
    traj, _, jax_params, _, tm, tree, lr = trajectories
    check_step_params(jax_params, tm, tree, lr, *PARAM_TOL[traj])


def check_step_params(jax_params, tm, tree, lr, max_tol, mean_tol, share_tol):
    """Every parameter moved and sits within the bounds (in units of lr) of
    JAX's after the steps; sign flips of near-zero gradients stay rare."""
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax({n: p.detach() for n, p in tm.named_parameters()})))
    start = dict(jax.tree_util.tree_leaves_with_path(tree))
    n_flipped = n_total = 0
    for path, ref in jax.tree_util.tree_leaves_with_path(jax_params):
        name = jax.tree_util.keystr(path)
        assert np.abs(ref - start[path]).max() > 0, name  # the step moved it
        diff = np.abs(got[path] - ref) / lr
        assert diff.max() <= max_tol, name
        assert diff.mean() <= mean_tol, name
        n_flipped += int(np.count_nonzero(diff > 0.5))
        n_total += diff.size
    assert n_flipped <= share_tol * n_total, (n_flipped, n_total)


def test_train_step_loss_scale():
    """``loss_scale`` (1 / n_data_shards under data parallelism) multiplies
    the loss and, through the backward, every gradient. A power of two
    commutes with every rounding on the way, so with 0.5 the loss and the
    gradient norms halve bit for bit, drop-path live on both sides from
    generators of one seed."""
    _, _, model = micro_models("bfloat16", seed=2, drop_path_rate=0.2)
    _, tp = micro_params(drop_path_rate=0.2)
    batch = synthetic.collate([synthetic.SyntheticDataset(tp)[3]], device="cpu")
    runs = {}
    for scale in (1.0, 0.5):
        tm = copy.deepcopy(model)
        train_step = step.build_train_step(
            tm, losses.LossHandler(tp), preprocess.Preprocessor(tp),
            optim.build_optimizer(tp, tm.parameters()), loss_scale=scale,
            # a seed whose masks keep a branch of block 1: no norm is zero
            generator=torch.Generator().manual_seed(6))
        runs[scale] = {k: float(v) for k, v in train_step(batch).items()}
    assert set(runs[0.5]) == set(runs[1.0])
    for key, val in runs[1.0].items():
        assert val > 0 and runs[0.5][key] == 0.5 * val, key


@pytest.mark.parametrize("trajectories", ["float32", "float32-2step"], indirect=True)
def test_eval_step_matches_jax(trajectories):
    """The eval step's loss (with the multistep weight) and the RMSE and ACC
    of the final rollout step, after the 3 train steps."""
    traj, _, jax_params, _, tm, _, _ = trajectories
    dtype, n_future = TRAJECTORIES[traj]
    over = dict(drop_path_rate=0.0, scan_blocks=False, n_future=n_future)
    jm = micro_models(dtype, seed=0, **over)[0]
    jp, tp = micro_params(compute_dtype=dtype, **over)
    ds = synthetic.SyntheticDataset(tp, train=False)
    tbatch = synthetic.collate([ds[0], ds[1]], device="cpu")
    n_out = int(tp["n_out_channels"])
    got = step.build_eval_step(tm, losses.LossHandler(tp), preprocess.Preprocessor(tp), n_out)(
        tbatch)
    mesh = make_mesh(None, devices=jax.devices()[:1])
    want = jax_step.build_eval_step(jm, jax_losses.LossHandler(jp),
                                    jax_preprocess.Preprocessor(jp), mesh, n_out)(
        jax_params, {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()})
    assert set(got) == set(want) and got["rmse"].shape == (n_out,)
    # the models differ slightly after 3 steps (see the params test)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-3, atol=1e-4)
