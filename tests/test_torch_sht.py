"""PyTorch port, the spherical harmonic transform (``ops/sht.py``) and the H1
loss (``ops/losses.GeometricH1Loss``, the ``h1`` loss word) against the JAX
package on the same numpy inputs.

Tolerances: the Legendre matrices come from the same float64 numpy code and
agree bit for bit; the transforms are fp32 products of length nlat after an
fp32 FFT on both sides, in another order of sums, so they agree to a few
fp32 ulps of the largest coefficient (bound 2e-6 of it); the losses and
their gradients sum those coefficients' squares (bound 1e-5 relative, 2e-6
of the largest gradient entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.config.yparams import YParams as JaxYParams
from swin_v2_weather_tpu.ops import losses as jax_losses
from swin_v2_weather_tpu.ops import sht as jax_sht
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.preprocess import derived_channel_counts
from swin_v2_weather_torch.ops import losses, sht

torch.set_num_threads(1)

GRIDS = [(24, 48, "equiangular"), (17, 32, "legendre-gauss")]


def max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("nlat, nlon, grid", GRIDS)
def test_legendre_matrix_is_jax_s(nlat, nlon, grid):
    for lmax, mmax in ((nlat, nlon // 2 + 1), (10, 8)):
        got = sht.legendre_matrix(nlat, lmax, mmax, grid)
        want = jax_sht.legendre_matrix(nlat, lmax, mmax, grid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mmax", [None, 10])
@pytest.mark.parametrize("nlat, nlon, grid", GRIDS)
def test_sht_matches_jax(nlat, nlon, grid, mmax):
    """RealSHT on [2, 3, nlat, nlon] fields, and InverseRealSHT of JAX's
    coefficients (all orders, and truncated at mmax = 10), against JAX."""
    x = np.random.default_rng(0).standard_normal((2, 3, nlat, nlon)).astype(np.float32)
    ref = np.asarray(jax_sht.RealSHT(nlat, nlon, mmax=mmax, grid=grid)(jnp.asarray(x)))
    fwd = sht.RealSHT(nlat, nlon, mmax=mmax, grid=grid)
    assert fwd.weighted_pct.shape == (ref.shape[-1], nlat, nlat)
    assert "weighted_pct" not in fwd.state_dict()  # a non-persistent buffer
    got = fwd(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    assert max_rel(got.real.numpy(), ref.real) <= 2e-6
    assert max_rel(got.imag.numpy(), ref.imag) <= 2e-6
    back_ref = np.asarray(jax_sht.InverseRealSHT(nlat, nlon, mmax=mmax, grid=grid)(
        jnp.asarray(ref)))
    back = sht.InverseRealSHT(nlat, nlon, mmax=mmax, grid=grid)(torch.from_numpy(ref.copy()))
    assert back.shape == x.shape and max_rel(back.numpy(), back_ref) <= 2e-6


def test_sht_round_trip_and_fp64():
    """A band-limited field survives SHT -> inverse on the Gauss grid; the
    fp64 transform agrees with the fp32 one to fp32 rounding."""
    nlat, nlon = 17, 32
    rng = np.random.default_rng(1)
    coeffs = np.zeros((nlat, nlon // 2 + 1), np.complex128)
    for l, m in ((0, 0), (3, 1), (6, 4), (9, 2)):
        coeffs[l, m] = rng.standard_normal() + (1j * rng.standard_normal() if m else 0)
    inv = sht.InverseRealSHT(nlat, nlon, grid="legendre-gauss", dtype=torch.float64)
    field = inv(torch.from_numpy(coeffs))
    fwd64 = sht.RealSHT(nlat, nlon, grid="legendre-gauss", dtype=torch.float64)
    np.testing.assert_allclose(fwd64(field).numpy(), coeffs, atol=1e-12)
    fwd32 = sht.RealSHT(nlat, nlon, grid="legendre-gauss")
    assert max_rel(fwd32(field.float()).numpy(), coeffs) <= 2e-6


def h1_params(loss_word):
    out = []
    for cls in (JaxYParams, YParams):
        p = cls(default_config_path(), "swin_micro_test")
        p["loss"] = loss_word
        p["img_shape_x"], p["img_shape_y"] = 24, 48
        p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
        out.append(p)
    return out


@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("absolute", [True, False])
def test_h1_loss_matches_jax(absolute, squared):
    """The ``h1`` word through both LossHandlers (absolute or relative, squared
    or not): the value and its gradient in the prediction against JAX's."""
    word = " ".join(w for w, on in (("absolute", absolute), ("squared", squared)) if on) + " h1"
    jp, tp = h1_params(word)
    jh, th = jax_losses.LossHandler(jp), losses.LossHandler(tp)
    assert isinstance(th.loss_obj, losses.GeometricH1Loss)
    n_out = int(tp["n_out_channels"])
    rng = np.random.default_rng(2)
    prd = rng.standard_normal((2, n_out, 24, 48)).astype(np.float32)
    tar = rng.standard_normal((2, n_out, 24, 48)).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(lambda p: jh(p, jnp.asarray(tar)))(jnp.asarray(prd))
    p = torch.from_numpy(prd).requires_grad_()
    got = th(p, torch.from_numpy(tar))
    got.backward()
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    assert max_rel(p.grad.numpy(), ref_grad) <= 2e-6
