"""PyTorch port, the inference CLI (``swin_v2_weather_torch/inference/cli.py``)
against the JAX package's on the JAX CLI test's archive and registry
(tests/test_inference_cli.py: a micro model trained one epoch on generated
HDF5 data), with a port registry holding the same weights through
``params_from_jax``; everything on the CPU (``device="cpu"``).

The micro config computes in bf16 on the ``xla`` route, so the forecasts
differ from JAX's by the bf16 rounding flips of both sides (the dense
layers' outputs); RMSE and ACC average them over the field: measured at
most 1.5e-4 relative (RMSE; the ensemble's control member 2.1e-4) and
1.1e-4 absolute (ACC) over 6 steps; bound rtol 1e-3, atol 1e-3. The saved
fields: measured max 3.6e-3, mean 4.4e-4 of their scale; bound max 2e-2
(bf16's relative spacing is 7.8e-3). The ensemble's perturbations come
from different generators (torch's and jax.random's), so only its control
member's RMSE is compared with JAX's.
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.inference import cli as jax_cli
from swin_v2_weather_tpu.inference import registry as jax_registry
from swin_v2_weather_torch.inference import cli
from swin_v2_weather_torch.models.convert import params_from_jax
from test_inference_cli import registry_and_data  # noqa: F401  (the JAX CLI test's fixture)

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def registries(registry_and_data):  # noqa: F811
    """(JAX registry, port registry with the same weights, data dir, root)."""
    reg, data, root = registry_and_data
    _, variables, _ = jax_registry.load_model(reg)
    port = str(root / "registry_torch")
    shutil.copytree(reg, port, ignore=shutil.ignore_patterns("weights"))
    torch.save(params_from_jax(variables["params"]), os.path.join(port, "weights.pt"))
    return reg, port, data, root


def args(reg, data, out, **kw):
    return argparse.Namespace(registry=reg, data=data, output=str(out), **kw)


def both(registries, tmp_path, **kw):
    jreg, port, data, _ = registries
    ref = jax_cli.run(args(jreg, data, tmp_path / "jax.json", **kw))
    out = cli.run(args(port, data, tmp_path / "port.json", device="cpu", **kw))
    return out, ref


@pytest.mark.parametrize("scanned", [False, True])
def test_scores_match_jax_with_trim(registries, tmp_path, scanned):
    out, ref = both(registries, tmp_path, ics=[2, 15], steps=6, scanned=scanned, chunk_steps=4)
    # ic 15 hits the year's end: both trim the curves to the shortest rollout
    assert len(out["lead_hours"]) < 6
    for key in ("lead_hours", "channels", "ics", "n_ics"):
        assert out[key] == ref[key], key
    assert set(out) == set(ref)
    rmse = np.asarray(out["rmse"])
    assert rmse.shape == (len(out["lead_hours"]), 4) and np.isfinite(rmse).all()
    np.testing.assert_allclose(rmse, ref["rmse"], **TOL)
    np.testing.assert_allclose(out["acc"], ref["acc"], **TOL)


def test_dt2_start_time_is_frame_cadence(registries, tmp_path):
    import yaml

    jreg, port, data, _ = registries
    for reg in (jreg, port):
        shutil.copytree(reg, tmp_path / os.path.basename(reg))
        hp = tmp_path / os.path.basename(reg) / "hyperparams.yaml"
        params = yaml.safe_load(hp.read_text())
        params["dt"] = 2
        hp.write_text(yaml.safe_dump(params))
    ref = jax_cli.run(args(str(tmp_path / os.path.basename(jreg)), data, tmp_path / "j.json",
                           ics=[3], steps=2))
    out = cli.run(args(str(tmp_path / os.path.basename(port)), data, tmp_path / "p.json",
                       ics=[3], steps=2, device="cpu"))
    assert out["ics"] == ref["ics"] == [{"index": 3, "start_time": "2017-01-01T18:00:00"}]
    assert out["lead_hours"] == ref["lead_hours"] == [12, 24]
    np.testing.assert_allclose(out["rmse"], ref["rmse"], **TOL)


@pytest.mark.parametrize("perturb", ["gaussian", "bred"])
def test_ensemble_keys_and_control(registries, tmp_path, perturb):
    kw = dict(ics=[2], steps=3, ensemble=5, perturb=perturb, amplitude=0.05, breed_cycles=2,
              zonal_truncation=8, seed=0, chunk_steps=2)
    out, ref = both(registries, tmp_path, **kw)
    assert set(out) == set(ref)
    assert out["n_members"] == ref["n_members"] == 5
    for key in ("rmse", "acc", "crps", "spread", "rmse_control"):
        arr = np.asarray(out[key])
        assert arr.shape == (3, 4) and np.isfinite(arr).all(), key
    assert (np.asarray(out["spread"]) > 0).all()
    # member 0 is the unperturbed control on both sides
    np.testing.assert_allclose(out["rmse_control"], ref["rmse_control"], **TOL)


def test_save_forecast_channel_subset_and_unknown(registries, tmp_path):
    jreg, port, data, _ = registries
    kw = dict(ics=[2], steps=3, scanned=True, chunk_steps=2, save_channels=["t2m", "u10m"])
    jax_cli.run(args(jreg, data, tmp_path / "j.json", save_forecast=str(tmp_path / "j"), **kw))
    cli.run(args(port, data, tmp_path / "p.json", save_forecast=str(tmp_path / "p"),
                 device="cpu", **kw))
    out = np.load(tmp_path / "p" / "ic000002.npy")
    ref = np.load(tmp_path / "j" / "ic000002.npy")
    assert out.shape == ref.shape == (3, 2, 24, 48)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    with open(tmp_path / "p" / "ic000002.json") as f, open(tmp_path / "j" / "ic000002.json") as g:
        assert json.load(f) == json.load(g)
    with pytest.raises(ValueError, match="unknown channels"):
        cli.run(args(port, data, tmp_path / "x.json", ics=[2], steps=1, device="cpu",
                     save_forecast=str(tmp_path / "x"), save_channels=["nope"]))


def test_export_stepper_flag(registries, tmp_path):
    _, port, _, _ = registries
    art = str(tmp_path / "served")
    cli.main(["--registry", port, "--export-stepper", art, "--batch", "1", "--device", "cpu"])
    manifest = json.load(open(os.path.join(art, "manifest.json")))
    assert manifest["output"]["shape"] == [1, 4, 24, 48] and manifest["device"] == "cpu"
    from swin_v2_weather_torch.inference.export import load_stepper

    out = load_stepper(art, device="cpu")(np.zeros((1, 4, 24, 48), np.float32),
                                          np.zeros((1, 1, 24, 48), np.float32))
    assert out.shape == (1, 4, 24, 48) and torch.isfinite(out).all()


def test_device_defaults_to_cuda(registries, tmp_path):
    _, port, data, _ = registries
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--registry", port, "--export-stepper", str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(args(port, data, tmp_path / "s.json", ics=[2], steps=1))
