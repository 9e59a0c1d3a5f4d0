"""The frozen counts against the kernel table's bound column (PERF.md §6:
the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s, in ms)."""

import json
import os

import pytest

from benchmark import counts

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
FLAGSHIP = "swin_73var_geo_depth12_chweight_invar"
E2048 = "swin_73var_geo_depth24_e2048_mlp2_chweight_invar"


def cfg(name):
    with open(os.path.join(CONF, name + ".json")) as f:
        return json.load(f)[name]


H100 = counts.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("kernel,config,ms", [
    ("K1", FLAGSHIP, 0.265), ("K2", FLAGSHIP, 0.777), ("K3", FLAGSHIP, 0.309),
    ("K4", FLAGSHIP, 0.309), ("K1", E2048, 1.736), ("K2", E2048, 5.164),
    ("K5", E2048, 2.199), ("K6", E2048, 2.199)])
def test_bound_matches_the_kernel_table(kernel, config, ms):
    c = cfg(config)
    tokens = counts.Shapes(c).tokens
    # the table gives 3 decimals (K1's 0.2645 ms it rounds up)
    assert 1e3 * counts.bound_s(kernel, c, tokens, H100) == pytest.approx(ms, abs=6e-4)


@pytest.mark.parametrize("config,tflop", [(FLAGSHIP, 11.63), (E2048, 107.07)])
def test_model_flops_of_a_forward(config, tflop):
    assert round(counts.model_flops(cfg(config)) / 1e12, 2) == tflop


def test_bounds_are_compute_bound_and_scale_with_tokens():
    c = cfg(FLAGSHIP)
    t = counts.Shapes(c).tokens
    for k in ("K1", "K2", "K3", "K4"):
        ops, nbytes = counts.kernel_cost(k, c, t)
        assert ops / H100["bf16_flops_s"] > nbytes / H100["hbm_bytes_s"]
        assert counts.bound_s(k, c, 9 * t, H100) == pytest.approx(9 * counts.bound_s(k, c, t, H100))


def test_unknown_device_has_no_peaks():
    with pytest.raises(KeyError):
        counts.peaks("NVIDIA A100-SXM4-80GB")
