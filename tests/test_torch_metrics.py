"""PyTorch port, verification metrics: the unweighted ACC, the top-quantile
error, the CRPS and the ensemble spread of ``swin_v2_weather_torch/ops/
metrics.py`` against the JAX package's (fp32, same numpy inputs), against the
fp64 pairwise CRPS oracle and closed forms, and the numpy oracles against
JAX's.

Tolerances: both sides reduce the same fp32 values in another order, so
they agree to a few fp32 ulps of the result (measured: at most 2.4e-6
relative, the unweighted ACC; 7.3e-7 the CRPS, 3.6e-7 the spread, 2.4e-7
the top-quantile error); bound rtol 1e-5, atol 1e-6. The fp64 oracle
differs from the fp32 sorted-member CRPS by fp32 rounding only (measured at
most 1.3e-7 relative; bound as JAX's own test: rtol 1e-5, atol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.ops import metrics as J
from swin_v2_weather_torch.ops import metrics as M

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def fields(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_np(fn, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def torch_np(fn, *args, **kw):
    return fn(*(torch.from_numpy(a) for a in args), **kw).numpy()


@pytest.mark.parametrize("num_lat", [8, 25, 721])
def test_latitude_weights_np_matches_jax(num_lat):
    np.testing.assert_array_equal(M.latitude_weights_np(num_lat), J.latitude_weights_np(num_lat))


def test_unweighted_acc_matches_jax():
    p, t = fields(0, 2, 3, 25, 48), fields(1, 2, 3, 25, 48)
    np.testing.assert_allclose(torch_np(M.unweighted_acc_channels, p, t),
                               jax_np(J.unweighted_acc_channels, p, t), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 3, 25, 48), (1, 2, 8, 10)])
def test_top_quantiles_error_matches_jax_and_numpy(shape):
    p, t = fields(2, *shape), 1.5 * fields(3, *shape) + 0.2
    got = torch_np(M.top_quantiles_error, p, t)
    np.testing.assert_allclose(got, jax_np(J.top_quantiles_error, p, t), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, M.top_quantiles_error_np(p, t), rtol=RTOL, atol=ATOL)


def test_quantiles_match_torch_quantile():
    x = torch.from_numpy(fields(4, 3, 2, 1000))
    q = 1.0 - torch.logspace(-3, -0.1, steps=100)
    torch.testing.assert_close(M._quantiles(x, q), torch.quantile(x, q, dim=-1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fair", [True, False])
def test_crps_and_spread_match_jax(fair):
    ens, tar = fields(5, 5, 2, 3, 25, 48), fields(6, 2, 3, 25, 48)
    np.testing.assert_allclose(torch_np(M.weighted_crps_channels, ens, tar, fair=fair),
                               jax_np(J.weighted_crps_channels, ens, tar, fair=fair),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch_np(M.weighted_crps, ens, tar, fair=fair),
                               jax_np(J.weighted_crps, ens, tar, fair=fair), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch_np(M.ensemble_spread_channels, ens),
                               jax_np(J.ensemble_spread_channels, ens), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch_np(M.ensemble_spread, ens), jax_np(J.ensemble_spread, ens),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("fair", [True, False])
def test_crps_matches_fp64_pairwise_oracle(m, fair):
    ens, tar = fields(7, m, 2, 3, 8, 10), fields(8, 2, 3, 8, 10)
    np.testing.assert_allclose(torch_np(M.weighted_crps, ens, tar, fair=fair),
                               M.weighted_crps_np(ens, tar, fair=fair), rtol=RTOL, atol=ATOL)


def test_spread_two_member_closed_form_and_single_member():
    ens = fields(9, 2, 2, 3, 8, 10)
    # ddof = 1 with two members: var = (a - b)^2 / 2
    w = M.latitude_weights(8).numpy().reshape(1, 1, 8, 1)
    want = np.sqrt(np.mean(w * (ens[0] - ens[1]) ** 2 / 2, axis=(-1, -2)))
    np.testing.assert_allclose(torch_np(M.ensemble_spread_channels, ens), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(torch_np(M.ensemble_spread_channels, ens[:1]), 0.0)


def test_numpy_oracles_equal_jax():
    p, t = fields(10, 25, 48), fields(11, 25, 48)
    assert M.weighted_rmse_np(p, t) == J.weighted_rmse_np(p, t)
    for weighted in (True, False):
        assert M.weighted_acc_np(p, t, weighted) == J.weighted_acc_np(p, t, weighted)
    ens, tar = fields(12, 3, 1, 2, 8, 10), fields(13, 1, 2, 8, 10)
    np.testing.assert_array_equal(M.weighted_crps_np(ens, tar), J.weighted_crps_np(ens, tar))
    p4, t4 = fields(14, 1, 2, 8, 10), fields(15, 1, 2, 8, 10)
    np.testing.assert_array_equal(M.top_quantiles_error_np(p4, t4),
                                  J.top_quantiles_error_np(p4, t4))
