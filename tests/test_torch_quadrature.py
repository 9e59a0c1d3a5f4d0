"""PyTorch port, ``ops/quadrature.GridConverter`` (equiangular ->
Legendre-Gauss latitude interpolation, used by scoring) against the JAX
package's class on the grids of tests/test_quadrature.py: the coordinates
and interpolation tables equal, the converted fields bit-equal in fp32 (the
same two elementwise operations; JAX computes fp64 inputs in fp32, so fp64
is held to numpy on JAX's tables), the identity on one grid, and the other
direction refused by both."""

import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.ops import quadrature as jax_quadrature
from swin_v2_weather_torch.ops import quadrature

torch.set_num_threads(1)

GRIDS = {
    "19x36": (np.linspace(90, -90, 19), np.arange(0, 360, 10.0)),
    "91x36": (np.linspace(90, -90, 91), np.arange(0, 360, 10.0)),
    "era5-like 33x64": (np.linspace(90, -90, 33), np.arange(0, 360, 360 / 64)),
}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dst", ["legendre-gauss", "equiangular"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_converter_matches_jax(grid, dst, dtype):
    lat, lon = (np.deg2rad(a) for a in GRIDS[grid])
    ours = quadrature.GridConverter("equiangular", dst, lat, lon)
    ref = jax_quadrature.GridConverter("equiangular", dst, lat, lon)
    for a, b in zip(ours.get_dst_coords() + ours.get_src_coords(),
                    ref.get_dst_coords() + ref.get_src_coords()):
        np.testing.assert_array_equal(a, b)
    if dst == "legendre-gauss":
        np.testing.assert_array_equal(ours.indices, ref.indices)
        np.testing.assert_array_equal(ours.interp_weights, ref.interp_weights)
    x = np.random.default_rng(len(lat)).normal(size=(2, 3, len(lat), len(lon))).astype(dtype)
    got = ours(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    if dtype == np.float32 or dst != "legendre-gauss":
        want = np.asarray(ref(x)).astype(dtype)
    else:
        lo, hi = x[..., ref.indices, :], x[..., ref.indices + 1, :]
        want = lo + (hi - lo) * ref.interp_weights
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_field_interpolates_exactly():
    """A field linear in latitude lands on the Legendre-Gauss latitudes."""
    lat, lon = (np.deg2rad(a) for a in GRIDS["91x36"])
    conv = quadrature.GridConverter("equiangular", "legendre-gauss", lat, lon)
    field = torch.from_numpy(np.tile(lat[:, None], (1, 36))[None])
    dst_lat, _ = conv.get_dst_coords()
    np.testing.assert_allclose(conv(field)[0, :, 0].numpy(), dst_lat, atol=1e-6)


def test_other_destination_raises_on_both_sides():
    lat, lon = (np.deg2rad(a) for a in GRIDS["19x36"])
    for cls in (quadrature.GridConverter, jax_quadrature.GridConverter):
        with pytest.raises(NotImplementedError):
            cls("legendre-gauss", "equiangular", lat, lon)
