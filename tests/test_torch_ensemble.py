"""PyTorch port, ensembles: ``swin_v2_weather_torch/inference/ensemble.py``
against the JAX package's on the same weights and members (micro config,
qkv-fused route, fp32 compute; JAX's Pallas kernels in interpret mode).

The port draws its noise from a ``torch.Generator``, JAX from a
``jax.random`` key, so the draws themselves are checked by their statistics;
breeding is held to JAX by injecting the same numpy noise into both sides
(each module's ``gaussian_perturbations`` patched for the test).

Tolerances: the noise shaping (FFT truncation, latitude-weighted
rescaling) reduces the same fp32 values in another order: rtol 1e-5, atol
1e-6 (measured at most 3.9e-7 relative untruncated, 7.5e-8 absolute on
fields of scale 0.22 truncated). Through the model the members carry the
port's per-step differences from JAX (tests/test_torch_rollout.py: max
1e-2, mean 1e-3 of the output scale in fp32); the scores are sums over the
whole field: measured at most 9.2e-5 relative (spread; CRPS 4.7e-5, RMSE
3.8e-5) and 2.9e-5 absolute (ACC); bound rtol 1e-3, atol 1e-3. The bred
vectors (``xla`` route, see the test) pass through the model three times:
measured max 1.5e-5 of their scale, mean 2.3e-6; bound max 1e-2, mean 1e-3,
as a step. Member i of a batch-5 step against a batch-1 step on the plain
path: measured bit-equal; bound 2e-6 absolute (two fp32 ulps at the output
scale 9.4).
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.inference import ensemble as jax_ensemble
from swin_v2_weather_tpu.inference.scoring import score_rollout as jax_score_rollout
from swin_v2_weather_torch.inference import ensemble
from swin_v2_weather_torch.inference.scoring import score_rollout
from test_torch_inference import NAMES, engines, stats
from test_torch_rollout import step_errors

torch.set_num_threads(1)

START = datetime.datetime(2018, 1, 1, 0, 0)
RTOL, ATOL = 1e-5, 1e-6
SHAPE = (4, 24, 48)


@pytest.fixture(scope="module")
def fp32():
    jax_engine, engine = engines("float32")
    ic = np.random.default_rng(3).standard_normal((1,) + SHAPE).astype(np.float32)
    return jax_engine, engine, ic


def noise(seed, n_pairs=2, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal((n_pairs,) + shape).astype(np.float32)


def jax_shaped(x, amplitude, zonal_truncation):
    """The body of JAX's gaussian_perturbations after its draw."""
    x = jnp.asarray(x)
    if zonal_truncation is not None:
        spec = jnp.fft.rfft(x, axis=-1)
        mask = (jnp.arange(spec.shape[-1]) <= int(zonal_truncation)).astype(spec.dtype)
        x = jnp.fft.irfft(spec * mask, n=x.shape[-1], axis=-1)
    return jax_ensemble._rescale(x, amplitude)


def test_lat_rms_and_rescale_match_jax():
    x = 3.0 * noise(0)
    np.testing.assert_allclose(ensemble._lat_rms(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ensemble._lat_rms(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ensemble._rescale(torch.from_numpy(x), 0.05).numpy(),
                               np.asarray(jax_ensemble._rescale(jnp.asarray(x), 0.05)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("zonal_truncation", [None, 8])
def test_shape_noise_matches_jax(zonal_truncation):
    x = noise(1)
    got = ensemble.shape_noise(torch.from_numpy(x), 0.05, zonal_truncation).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_shaped(x, 0.05, zonal_truncation)),
                               rtol=RTOL, atol=ATOL)


def test_gaussian_perturbations_statistics():
    gen = torch.Generator().manual_seed(7)
    pert = ensemble.gaussian_perturbations(gen, 3, SHAPE, 0.05)
    assert pert.shape == (3,) + SHAPE and pert.dtype == torch.float32
    torch.testing.assert_close(ensemble._lat_rms(pert), torch.full((3, 4), 0.05),
                               rtol=1e-5, atol=0)
    assert abs(float(pert.mean())) < 0.01  # zero-mean noise
    again = ensemble.gaussian_perturbations(torch.Generator().manual_seed(7), 3, SHAPE, 0.05)
    assert torch.equal(pert, again)  # the same seed, the same draws
    other = ensemble.gaussian_perturbations(torch.Generator().manual_seed(8), 3, SHAPE, 0.05)
    assert not torch.equal(pert, other)


def test_zonal_truncation_zeroes_high_wavenumbers():
    pert = ensemble.gaussian_perturbations(torch.Generator().manual_seed(2), 2, SHAPE, 0.05,
                                           zonal_truncation=5)
    spec = torch.fft.rfft(pert, dim=-1).abs()
    assert float(spec[..., 6:].max()) < 1e-6 * float(spec[..., :6].max())
    torch.testing.assert_close(ensemble._lat_rms(pert), torch.full((2, 4), 0.05),
                               rtol=1e-5, atol=0)


def test_make_members_matches_jax_and_raises():
    ic = noise(3, 1)
    pert = noise(4, 2)
    for n in (1, 4, 5):
        got = ensemble.make_members(ic, torch.from_numpy(pert), n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_ensemble.make_members(ic, jnp.asarray(pert), n)))
    torch.testing.assert_close(got[1] + got[2], 2 * got[0])  # centered pairs
    for make, p in ((ensemble.make_members, torch.from_numpy(pert)),
                    (jax_ensemble.make_members, jnp.asarray(pert))):
        with pytest.raises(ValueError, match="need 3 perturbation pairs for 7 members, got 2"):
            make(ic, p, 7)


def test_breeding_with_injected_noise_matches_jax(monkeypatch):
    """On the ``xla`` route: a bred vector is the difference of two forecasts
    a small amplitude apart, scaled back up, so the bf16 rounding flips of
    the qkv-fused kernel's plain version (about 1e-3 of a forecast, the
    same size as the difference) would dominate it; the plain fp32
    attention has none."""
    jax_engine, engine = engines("float32", attn_impl="xla")
    ic = np.random.default_rng(3).standard_normal((1,) + SHAPE).astype(np.float32)
    x = noise(5)
    monkeypatch.setattr(ensemble, "gaussian_perturbations",
                        lambda gen, n, shape, amp, zt=None: ensemble.shape_noise(
                            torch.from_numpy(x).to(gen.device), amp, zt))
    monkeypatch.setattr(jax_ensemble, "gaussian_perturbations",
                        lambda key, n, shape, amp, zt=None: jax_shaped(x, amp, zt))
    kw = dict(cycles=3, seed=0, zonal_truncation=8)
    got = ensemble.breed_perturbations(engine, ic, START, 2, 0.05, **kw)
    ref = np.asarray(jax_ensemble.breed_perturbations(jax_engine, ic, START, 2, 0.05, **kw))
    assert got.shape == ref.shape == (2,) + SHAPE
    torch.testing.assert_close(ensemble._lat_rms(got), torch.full((2, 4), 0.05),
                               rtol=1e-5, atol=0)
    mx, mean = step_errors([got.numpy()], [ref])[0]
    assert mx <= 1e-2 and mean <= 1e-3, (mx, mean)


def score_both(jax_engine, engine, members, n_steps=3, chunk=2, seed=9):
    rng = np.random.default_rng(seed)
    targets = [rng.standard_normal((1,) + SHAPE).astype(np.float32) for _ in range(n_steps)]
    means, stds = stats()
    clim = (means + stds * rng.standard_normal(SHAPE)).astype(np.float32)
    kw = dict(means=means, stds=stds, climatology=clim, channel_names=NAMES, chunk=chunk)
    out = ensemble.score_ensemble(engine, members, targets, START, **kw)
    ref = jax_ensemble.score_ensemble(jax_engine, jnp.asarray(members), targets, START, **kw)
    return out, ref, (targets, kw)


def test_score_ensemble_matches_jax(fp32):
    jax_engine, engine, ic = fp32
    members = ensemble.make_members(ic, ensemble.shape_noise(
        torch.from_numpy(noise(6)), 0.3, 8), 5).numpy()
    out, ref, _ = score_both(jax_engine, engine, members)
    assert set(out) == set(ref) == {"crps", "spread", "rmse_mean", "rmse_control", "acc_mean",
                                    "lead_hours", "n_members", "channels"}
    assert out["n_members"] == ref["n_members"] == 5
    np.testing.assert_array_equal(out["lead_hours"], ref["lead_hours"])
    np.testing.assert_array_equal(out["channels"], ref["channels"])
    for key in ("crps", "spread", "rmse_mean", "rmse_control"):
        assert out[key].shape == (3, 4) and np.isfinite(out[key]).all(), key
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-3, err_msg=key)
    np.testing.assert_allclose(out["acc_mean"], ref["acc_mean"], atol=1e-3)
    assert (out["spread"] > 0).all()


def test_zero_perturbations_collapse_to_deterministic(fp32):
    jax_engine, engine, ic = fp32
    members = np.repeat(ic, 3, axis=0)
    out, ref, (targets, kw) = score_both(jax_engine, engine, members)
    np.testing.assert_array_equal(out["spread"], 0.0)
    kw.pop("chunk")
    det = score_rollout(engine, ic, targets, START, scanned=True, chunk=2, **kw)
    np.testing.assert_array_equal(out["rmse_control"], det["rmse"])
    np.testing.assert_array_equal(out["rmse_mean"], det["rmse"])
    np.testing.assert_allclose(out["acc_mean"], det["acc"], rtol=0, atol=1e-7)
    jax_det = jax_score_rollout(jax_engine, ic, targets, START, scanned=True, chunk=2, **kw)
    np.testing.assert_allclose(out["rmse_control"], jax_det["rmse"], rtol=1e-3)


def test_batched_members_match_batch_one_steps(fp32):
    """Member i of a batch-M step against a batch-1 step of the same state on
    the plain path (the card's check is in chip_smoke.py phase 41)."""
    _, engine, ic = fp32
    members = ensemble.make_members(ic, ensemble.shape_noise(
        torch.from_numpy(noise(10)), 0.3, None), 5)
    zen = torch.from_numpy(engine.zenith_at(START))
    batched = engine._step(members, zen.expand(5, 1, 24, 48))
    for i in range(5):
        one = engine._step(members[i:i + 1], zen)
        torch.testing.assert_close(batched[i:i + 1], one, rtol=0, atol=2e-6)
