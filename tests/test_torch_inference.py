"""PyTorch port, inference: the chunked rollout (``zenith_stack``,
``rollout_chunk``, ``rollout_scanned``), the forecast writer, scoring, the
registry export and the statistics loader against the JAX package's on the
same weights (micro config, qkv-fused route, zenith and static channels
live; JAX's Pallas kernels in interpret mode).

Bounds, per step and relative to that step's output scale m, are those of
tests/test_torch_rollout.py (the same rounding flips of the attention
kernel, carried on): float32 compute max 1e-2 m, mean 1e-3 m; bfloat16 max
5e-2 m, mean 6e-3 m. The port's chunked rollout is bit-equal to its own
host-stepped one (the same step, enqueued another way). Scores (fp32
compute, physical units) are sums over the whole field, so the prediction
differences average out: measured at most 2.4e-5 relative on the RMSE and
2.8e-5 absolute on the ACC (|ACC| up to 0.33); bound rtol 1e-3 and atol
1e-3.
"""

import datetime
import json
import os

import numpy as np
import pytest
import torch
import yaml

from swin_v2_weather_tpu.inference import registry as jax_registry
from swin_v2_weather_tpu.inference.rollout import RolloutEngine as JaxRolloutEngine
from swin_v2_weather_tpu.inference.scoring import (
    acc_against_climatology as jax_acc_against_climatology,
    score_rollout as jax_score_rollout,
)
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.inference.registry import export_model, load_model, load_stats
from swin_v2_weather_torch.inference.rollout import RolloutEngine
from swin_v2_weather_torch.inference.scoring import acc_against_climatology, score_rollout
from swin_v2_weather_torch.training.trainer import Trainer
from test_torch_model import micro_configs, micro_models
from test_torch_rollout import step_errors

torch.set_num_threads(1)

START = datetime.datetime(2018, 1, 1, 0, 0)
N_STEPS = 3
KEEP = [3, 0]
NAMES = ["u10m", "v10m", "t2m", "z500"]
BOUNDS = {"float32": (1e-2, 1e-3), "bfloat16": (5e-2, 6e-3)}


def engines(compute_dtype, seed=3, **over):
    """(JAX engine, port engine on the CPU) on the same weights (config
    overrides ``over``)."""
    jm, tree, tm = micro_models(compute_dtype, seed=seed, **over)
    jp, tp = micro_configs(compute_dtype, **over)
    return JaxRolloutEngine(jp, jm, {"params": tree}), RolloutEngine(tp, tm, "cpu")


@pytest.fixture(scope="module")
def fp32():
    jax_engine, engine = engines("float32")
    ic = np.random.default_rng(3).standard_normal((1, 4, 24, 48)).astype(np.float32)
    return jax_engine, engine, ic


def stats(seed=6):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((4, 1, 1)).astype(np.float32)
    stds = (1.0 + rng.random((4, 1, 1))).astype(np.float32)
    return means, stds


def test_zenith_stack_matches_jax(fp32):
    jax_engine, engine, _ = fp32
    when = datetime.datetime(2020, 6, 21, 13, 30)
    got = engine.zenith_stack(when, 5)
    assert got.shape == (5, 1, 1, 24, 48) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_engine.zenith_stack(when, 5))


def test_chunked_rollout_bit_equal_to_stepped(fp32):
    _, engine, ic = fp32
    stepped = engine.rollout(ic, START, N_STEPS)
    scanned = engine.rollout_scanned(ic, START, N_STEPS)
    np.testing.assert_array_equal(scanned.numpy(), stepped)
    # two chunks (2 + 1 steps) carry the state across
    state, first = engine.rollout_chunk(ic, engine.zenith_stack(START, 2))
    state, last = engine.rollout_chunk(state, engine.zenith_stack(
        START + datetime.timedelta(hours=12), 1))
    np.testing.assert_array_equal(torch.cat([first, last]).numpy(), stepped)
    np.testing.assert_array_equal(state.numpy(), stepped[-1])
    kept = engine.rollout_scanned(ic, START, N_STEPS, keep_channels=KEEP)
    np.testing.assert_array_equal(kept.numpy(), stepped[:, :, KEEP])
    with pytest.raises(ValueError, match="start_time"):
        engine.rollout_scanned(ic, None, 1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rollout_scanned_matches_jax(compute_dtype, fp32):
    ic = fp32[2]
    jax_engine, engine = fp32[:2] if compute_dtype == "float32" else engines(compute_dtype)
    ref = np.asarray(jax_engine.rollout_scanned(ic, START, N_STEPS, keep_channels=KEEP))
    out = engine.rollout_scanned(ic, START, N_STEPS, keep_channels=KEEP).numpy()
    assert out.shape == ref.shape == (N_STEPS, 1, 2, 24, 48)
    mx_bound, mean_bound = BOUNDS[compute_dtype]
    for s, (mx, mean) in enumerate(step_errors(out, ref)):
        assert mx <= mx_bound and mean <= mean_bound, (s, mx, mean)


def test_write_forecast_matches_jax(fp32, tmp_path):
    jax_engine, engine, ic = fp32
    means, stds = stats()
    kw = dict(channel_names=NAMES, keep_names=["z500", "u10m"], ic_index=7, chunk=2)
    path = engine.write_forecast(str(tmp_path / "port"), ic, START, N_STEPS, means, stds, **kw)
    ref_path = jax_engine.write_forecast(str(tmp_path / "jax"), ic, START, N_STEPS, means, stds,
                                         **kw)
    assert os.path.basename(path) == os.path.basename(ref_path) == "ic000007.npy"
    out, ref = np.load(path), np.load(ref_path)
    assert out.shape == ref.shape == (N_STEPS, 2, 24, 48) and out.dtype == np.float32
    # the bounds hold on the normalized fields; denormalization scales each
    # channel by its std, so compare per channel in normalized units
    std_kept = stds[[3, 0]].reshape(1, 2, 1, 1)
    mean_kept = means[[3, 0]].reshape(1, 2, 1, 1)
    for s, (mx, mean) in enumerate(step_errors((out - mean_kept) / std_kept,
                                               (ref - mean_kept) / std_kept)):
        assert mx <= 1e-2 and mean <= 1e-3, (s, mx, mean)
    with open(path[:-4] + ".json") as f, open(ref_path[:-4] + ".json") as g:
        assert json.load(f) == json.load(g)
    with pytest.raises(ValueError, match="unknown channels"):
        engine.write_forecast(str(tmp_path / "bad"), ic, START, 1, means, stds, NAMES,
                              keep_names=["nope"])


@pytest.mark.parametrize("scanned", [False, True])
def test_score_rollout_matches_jax(fp32, scanned):
    jax_engine, engine, ic = fp32
    rng = np.random.default_rng(5)
    targets = [rng.standard_normal((1, 4, 24, 48)).astype(np.float32) for _ in range(N_STEPS)]
    means, stds = stats()
    clim = (means + stds * rng.standard_normal((4, 24, 48))).astype(np.float32)
    kw = dict(means=means, stds=stds, climatology=clim, channel_names=NAMES, scanned=scanned,
              chunk=2)
    out = score_rollout(engine, ic, targets, START, **kw)
    ref = jax_score_rollout(jax_engine, ic, targets, START, **kw)
    assert set(out) == set(ref) == {"rmse", "acc", "lead_hours", "channels"}
    assert out["rmse"].shape == out["acc"].shape == (N_STEPS, 4)
    np.testing.assert_array_equal(out["lead_hours"], ref["lead_hours"])
    np.testing.assert_array_equal(out["channels"], ref["channels"])
    np.testing.assert_allclose(out["rmse"], ref["rmse"], rtol=1e-3)
    np.testing.assert_allclose(out["acc"], ref["acc"], atol=1e-3)
    if scanned:  # the chunked path scores the same predictions as the stepped one
        stepped = score_rollout(engine, ic, targets, START, **dict(kw, scanned=False))
        for key in ("rmse", "acc"):
            np.testing.assert_array_equal(out[key], stepped[key])


def test_acc_against_climatology_matches_jax():
    rng = np.random.default_rng(8)
    clim = rng.standard_normal((3, 16, 32)).astype(np.float32)
    pred = rng.standard_normal((2, 3, 16, 32)).astype(np.float32) + clim
    tar = rng.standard_normal((2, 3, 16, 32)).astype(np.float32) + clim
    got = acc_against_climatology(pred, tar, clim[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_acc_against_climatology(
        pred, tar, clim[None])), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc_against_climatology(pred, pred, clim[None]).numpy(), 1.0,
                               atol=1e-6)
    # on the device of a tensor prediction
    assert acc_against_climatology(torch.from_numpy(pred), tar, clim[None]).device.type == "cpu"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port Trainer run of the micro config on the CPU (1 epoch), with
    statistics files, and its registry."""
    root = tmp_path_factory.mktemp("exp")
    rng = np.random.default_rng(0)
    paths = {}
    for key, arr in (("global_means", rng.standard_normal((1, 4, 1, 1))),
                     ("global_stds", 1.0 + rng.random((1, 4, 1, 1))),
                     ("time_means", rng.standard_normal((1, 4, 25, 48)))):
        paths[f"{key}_path"] = str(root / f"{key}.npy")
        np.save(paths[f"{key}_path"], arr.astype(np.float32))
    p = YParams(default_config_path(), "swin_micro_test")
    for key, val in dict(exp_dir=str(root / "runs"), max_epochs=1, n_synthetic_samples=4,
                         batch_size=4, num_data_workers=2, **paths).items():
        p[key] = val
    t = Trainer(p, "swin_micro_test", run_num="r", device="cpu")
    t.build_and_launch()
    reg = export_model(p["experiment_dir"], str(root / "registry"))
    return t, reg


def test_export_model_load_model_identical_forward(trained):
    t, reg = trained
    for name in ("weights.pt", "hyperparams.yaml", "metadata.json", "global_means.npy",
                 "global_stds.npy", "time_means.npy"):
        assert os.path.exists(os.path.join(reg, name)), name
    meta = json.load(open(os.path.join(reg, "metadata.json")))
    assert meta["grid"] == [24, 48] and meta["dt_hours"] == 6 and meta["add_zenith"]
    assert meta["channel_names"] == NAMES
    model, params = load_model(reg, "cpu")
    best = torch.load(os.path.join(t.params["best_checkpoint_path"], "checkpoint.pt"),
                      weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 8, 24, 48)).astype(
        np.float32))
    t.model.load_state_dict(best)
    t.model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), t.model(x), rtol=0, atol=0)
    assert params["time_means_path"] == os.path.join(reg, "time_means.npy")


def test_load_stats_matches_jax(trained):
    _, reg = trained
    with open(os.path.join(reg, "hyperparams.yaml")) as f:
        hp = yaml.safe_load(f)
    for key in ("global_means_path", "global_stds_path", "time_means_path"):
        hp[key] = os.path.join(reg, os.path.basename(hp[key]))
    got, ref = load_stats(hp), jax_registry.load_stats(hp)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (4,) and got[2].shape == (4, 25, 48)
    hp["time_means_path"] = None
    assert load_stats(hp)[2] is None and jax_registry.load_stats(hp)[2] is None
