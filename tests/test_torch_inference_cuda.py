"""PyTorch port, inference on the GPU (``cuda`` marker; each test skips
without a CUDA device): K1's and K3's custom ops (``swin::window_attention_qkv``,
``swin::fc1_gelu``) bit-equal to their direct launches, and the micro model's
serving artifact on the card: traced to calls of those ops (no plain
attention or GELU), launching K1 and K3 once a block a call, bit-equal to the
engine's step; the chunked rollout bit-equal to the stepped one; batch-M
members against batch-1 steps; every route's artifact (K5, K7-K12 through
their custom ops) bit-equal to the engine's step, and a CUDA + CPU artifact.
Imports no JAX, so it runs on the H100 with ``python -m pytest --noconftest
-m cuda tests/test_torch_inference_cuda.py``.
"""

import contextlib
import datetime
import math
from unittest import mock

import numpy as np
import pytest
import torch

from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.preprocess import derived_channel_counts
from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
from swin_v2_weather_torch.inference.rollout import RolloutEngine
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops import mlp_kernels as mk
from swin_v2_weather_torch.ops import window_attention as wa
from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

START = datetime.datetime(2018, 1, 1, 0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the custom ops launch the hand-written kernels")
    return torch.device("cuda")


def micro_engine(dev, **over):
    """The micro config on the qkv-fused route, seeded noise weights (LayerNorm
    scales 1 + 0.1 N, so no block is the identity), as an engine on ``dev``."""
    p = YParams(default_config_path(), "swin_micro_test")
    p["attn_impl"] = "pallas_qkv"
    for k, v in over.items():
        p[k] = v
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    model = get_model(p, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            noise = torch.randn(prm.shape, generator=gen)
            if name.endswith("norm1.weight") or name.endswith("norm2.weight"):
                prm.copy_(1.0 + 0.1 * noise)
            elif prm.dim() == 2:
                prm.copy_(noise / math.sqrt(prm.shape[1]))
            else:
                prm.copy_(0.1 * noise)
    return RolloutEngine(p, model, dev), int(p.depth)


def ic(seed=1, b=1):
    return np.random.default_rng(seed).standard_normal((b, 4, 24, 48)).astype(np.float32)


@pytest.mark.cuda
def test_custom_ops_bit_equal_to_direct_launches(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    kw = dict(generator=gen, device=cuda_device)
    x = torch.randn((1, 18, 36, 64), **kw).bfloat16()
    w = (torch.randn((64, 192), **kw) / 8).bfloat16()
    b, scale = 0.1 * torch.randn((192,), **kw), torch.full((2,), 10.0, device=cuda_device)
    mask = torch.where(torch.rand((162, 162), **kw) < 0.3, -100.0, 0.0)
    before = wa.window_attention_qkv.launches
    direct = wa.window_attention_qkv(x, w, b, scale, (9, 18), mask, 1.0)
    op = torch.ops.swin.window_attention_qkv(x, w, b, scale, [9, 18], mask, 1.0)
    assert torch.equal(op, direct) and wa.window_attention_qkv.launches == before + 2
    x2 = torch.randn((648, 64), **kw).bfloat16()
    w1, b1 = (torch.randn((64, 256), **kw) / 8).bfloat16(), 0.1 * torch.randn((256,), **kw)
    before = mk.fc1_gelu.launches
    assert torch.equal(torch.ops.swin.fc1_gelu(x2, w1, b1), mk.fc1_gelu(x2, w1, b1))
    assert mk.fc1_gelu.launches == before + 2


@pytest.mark.cuda
def test_exported_artifact_launches_k1_k3(cuda_device, tmp_path):
    engine, depth = micro_engine(cuda_device)
    manifest = export_stepper(engine, str(tmp_path), batch=2)
    assert manifest["device"] == "cuda"
    served = load_stepper(str(tmp_path), device="cuda")
    calls = [str(n.target) for n in served.program.graph.nodes if n.op == "call_function"]
    assert calls.count("swin.window_attention_qkv.default") == depth
    assert calls.count("swin.fc1_gelu.default") == depth
    assert not [c for c in calls if "softmax" in c or "erf" in c]
    state = torch.from_numpy(ic(b=2)).to(cuda_device)
    zen = torch.from_numpy(engine.zenith_at(START)).to(cuda_device).expand(2, 1, 24, 48)
    before = (wa.window_attention_qkv.launches, mk.fc1_gelu.launches)
    out = served(state, zen)
    torch.cuda.synchronize()
    assert (wa.window_attention_qkv.launches - before[0],
            mk.fc1_gelu.launches - before[1]) == (depth, depth)
    assert torch.equal(out, engine._step(state, zen.contiguous()))


@pytest.mark.cuda
def test_chunked_rollout_and_batched_members_on_the_card(cuda_device):
    engine, _ = micro_engine(cuda_device)
    stepped = engine.rollout(ic(), START, 3)
    assert np.array_equal(engine.rollout_scanned(ic(), START, 3).cpu().numpy(), stepped)
    members = torch.from_numpy(ic(seed=2, b=5)).to(cuda_device)
    zen = torch.from_numpy(engine.zenith_at(START)).to(cuda_device)
    batched = engine._step(members, zen.expand(5, 1, 24, 48))
    for i in range(5):
        one = engine._step(members[i:i + 1], zen)
        diff = float((batched[i:i + 1] - one).abs().max())
        # the same kernels at another batch; cuBLAS may block the dense
        # layers' sums differently by batch, flipping a bf16 rounding
        assert diff <= 8 * 2.0 ** (math.floor(math.log2(float(one.abs().max()))) - 7), (i, diff)


CPB = {"rel_pos": True, "full_pos_embed": False}
# route -> (config overrides, (QKV_IMPL, QKV_PAD_HEADS) or None, the custom
# ops a call of the micro model (depth 2) makes)
ROUTES = {
    "cpb": (CPB, None, {"window_attention_qkv_bias": 2, "fc1_gelu": 2}),
    "grid": ({"attn_impl": "pallas"}, None, {"window_attention_grid": 2, "fc1_gelu": 2}),
    "grid_cpb": ({"attn_impl": "pallas", **CPB}, None,
                 {"window_attention_grid_bias": 2, "fc1_gelu": 2}),
    "v1": ({"attn_impl": "pallas_v1"}, None, {"window_attention_v1": 2, "fc1_gelu": 2}),
    "v1_cpb": ({"attn_impl": "pallas_v1", **CPB}, None,
               {"window_attention_v1_bias": 2, "fc1_gelu": 2}),
    "v6": ({}, ("v6", False), {"window_attention_qkv_padded": 2, "fc1_gelu": 2}),
    "v5": ({}, ("v5", False), {"window_attention_qkv5": 2, "fc1_gelu": 2}),
    "v4": ({}, ("v4", False), {"window_attention_qkv4": 2, "fc1_gelu": 2}),
    "v4_padded": ({}, ("v4", True), {"window_attention_qkv4_padded": 2, "fc1_gelu": 2}),
    "lnadd": ({"lnadd_impl": "fused", "embed_dim": 128}, None,
              {"ln_dp_add_fwd": 4, "window_attention_qkv": 2, "fc1_gelu": 2}),
    "fused2": ({"mlp_impl": "fused2"}, None, {"window_attention_qkv": 2, "mlp_fwd": 2}),
}


@contextlib.contextmanager
def switched(qkv):
    if qkv is None:
        yield
        return
    with mock.patch.object(wa, "QKV_IMPL", qkv[0]), \
            mock.patch.object(v45, "QKV_PAD_HEADS", qkv[1]):
        yield


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_exports_on_the_card(cuda_device, tmp_path, route):
    """The route's artifact calls its forward kernels' custom ops (no plain
    attention or GELU) and is bit-equal to the engine's step."""
    over, qkv, want = ROUTES[route]
    with switched(qkv):
        engine, _ = micro_engine(cuda_device, **over)
        export_stepper(engine, str(tmp_path))
        served = load_stepper(str(tmp_path), device="cuda")
        calls = [str(n.target) for n in served.program.graph.nodes if n.op == "call_function"]
        ops = {c.split(".")[1]: calls.count(c) for c in set(calls) if c.startswith("swin.")}
        assert ops == want and not [c for c in calls if "softmax" in c or "erf" in c]
        state = torch.from_numpy(ic()).to(cuda_device)
        zen = torch.from_numpy(engine.zenith_at(START)).to(cuda_device)
        assert torch.equal(served(state, zen), engine._step(state, zen))


@pytest.mark.cuda
def test_cuda_and_cpu_programs(cuda_device, tmp_path):
    """``platforms=("cuda", "cpu")``: the CUDA program bit-equal to the
    engine's step; the CPU program (no custom op) within 8 bf16 ulps of the
    output scale (the plain versions on the host; chip_smoke.py's
    MODEL_TOL)."""
    engine, _ = micro_engine(cuda_device)
    manifest = export_stepper(engine, str(tmp_path), platforms=("cuda", "cpu"))
    assert manifest["platforms"] == ["cuda", "cpu"] and manifest["device"] == "cuda"
    state = torch.from_numpy(ic()).to(cuda_device)
    zen = torch.from_numpy(engine.zenith_at(START)).to(cuda_device)
    got = load_stepper(str(tmp_path), "cuda")(state, zen)
    assert torch.equal(got, engine._step(state, zen))
    on_cpu = load_stepper(str(tmp_path), "cpu")
    assert not [n for n in on_cpu.program.graph.nodes if str(n.target).startswith("swin.")]
    diff = float((on_cpu(state.cpu(), zen.cpu()) - got.cpu()).abs().max())
    assert diff <= 8 * 2.0 ** (math.floor(math.log2(float(got.abs().max()))) - 7), diff
