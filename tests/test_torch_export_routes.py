"""PyTorch port, the serving artifact of every route the model factory builds
(``inference/export.py``; each forward kernel a ``swin::`` custom op).

On the CPU, for each route at ``swin_micro_test`` widths (bf16 compute): the
``torch.export`` program is bit-equal to the engine's step (the program
holds the plain versions' operations, as the engine runs them on the CPU;
measured: max difference 0.0; bound 0), and its manifest's keys shared with
the JAX package's ``export_stepper`` equal JAX's for the same config and
switches. Each custom op's fake (``register_fake``), on fake CUDA tensors,
gives the shape and dtype of its plain version on the CPU at a micro size.
``platforms``: a CPU program alone, the platforms the port refuses, a load
on a device the artifact has no program for; the CLI's ``--platforms``
reaches ``export_stepper`` as JAX's CLI passes it on.
"""

import contextlib
import datetime
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from swin_v2_weather_tpu.inference import cli as jax_cli
from swin_v2_weather_tpu.inference import export as jax_export
from swin_v2_weather_tpu.inference import registry as jax_registry
from swin_v2_weather_tpu.inference import rollout as jax_rollout
from swin_v2_weather_tpu.ops import window_attention as jax_wa
from swin_v2_weather_tpu.ops.attic import window_attention_v45 as jax_v45
from swin_v2_weather_torch.inference import cli
from swin_v2_weather_torch.inference import export
from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
from swin_v2_weather_torch.ops import ln_kernels as lk
from swin_v2_weather_torch.ops import mlp_kernels as mk
from swin_v2_weather_torch.ops import window_attention as wa
from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45
from test_torch_inference import engines

torch.set_num_threads(1)

START = datetime.datetime(2018, 1, 1, 0, 0)
CPB = {"rel_pos": True, "full_pos_embed": False}

# route -> (config overrides, (QKV_IMPL, QKV_PAD_HEADS) in both packages or None)
ROUTES = {
    "cpb": (CPB, None),  # K7
    "grid": ({"attn_impl": "pallas"}, None),  # K8
    "grid_cpb": ({"attn_impl": "pallas", **CPB}, None),
    "v1": ({"attn_impl": "pallas_v1"}, None),  # K9
    "v1_cpb": ({"attn_impl": "pallas_v1", **CPB}, None),
    "v6": ({}, ("v6", False)),  # K10
    "v5": ({}, ("v5", False)),  # K12
    "v4": ({}, ("v4", False)),
    "v4_padded": ({}, ("v4", True)),
    "lnadd": ({"lnadd_impl": "fused", "embed_dim": 128}, None),  # K11 (C % 128 == 0)
    "fused2": ({"mlp_impl": "fused2"}, None),  # K5
}


@contextlib.contextmanager
def switched(qkv):
    """``QKV_IMPL`` and ``QKV_PAD_HEADS`` in both packages (JAX's v4 builder
    cache cleared so the switch reaches its trace), or nothing."""
    if qkv is None:
        yield
        return
    impl, pad = qkv
    jax_v45._build_qkv4.cache_clear()
    with mock.patch.object(jax_wa, "QKV_IMPL", impl), mock.patch.object(wa, "QKV_IMPL", impl), \
            mock.patch.object(jax_v45, "QKV_PAD_HEADS", pad), \
            mock.patch.object(v45, "QKV_PAD_HEADS", pad):
        yield
    jax_v45._build_qkv4.cache_clear()


@pytest.fixture(scope="module", params=list(ROUTES))
def route_artifact(request, tmp_path_factory):
    """(route, JAX engine, port engine, artifact dir, manifest) at batch 1."""
    over, qkv = ROUTES[request.param]
    with switched(qkv):
        jax_engine, engine = engines("bfloat16", **over)
        art = str(tmp_path_factory.mktemp(f"served_{request.param}"))
        return request.param, jax_engine, engine, art, export_stepper(engine, art)


def inputs(engine, seed=0):
    state = np.random.default_rng(seed).standard_normal((1, 4, 24, 48)).astype(np.float32)
    return torch.from_numpy(state), torch.from_numpy(engine.zenith_at(START))


def test_route_artifact_bit_equal_to_engine_step(route_artifact):
    """The route's CPU program against the engine's step (bound 0)."""
    route, _, engine, art, manifest = route_artifact
    assert manifest["platforms"] == ["cpu"] and manifest["device"] == "cpu"
    served = load_stepper(art, device="cpu")
    state, zen = inputs(engine)
    with switched(ROUTES[route][1]):
        ref = engine._step(state, zen)
    out = served(state, zen)
    assert out.shape == (1, 4, 24, 48) and torch.equal(out, ref)


def test_route_manifest_matches_jax(route_artifact, tmp_path):
    route, jax_engine, _, _, manifest = route_artifact
    with switched(ROUTES[route][1]):
        ref = jax_export.export_stepper(jax_engine, str(tmp_path / "jax"))
    for key in ("inputs", "output", "grid", "hours_per_step", "add_zenith", "out_channels",
                "platforms"):
        assert manifest[key] == ref[key], key


# --------------------------------------------------------------------------
# each custom op's fake against its plain version
# --------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32
W9 = (9, 18)  # L = 162 on [1, 18, 36, C]: 2 x 2 windows


def op_args(name):
    """(module, the launcher's arguments at a micro size, real CPU tensors)
    for each forward launcher with a custom op but K1's and K3's."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=F32):
        return torch.randn(shape, generator=g).to(dtype)

    x, s, m = t(1, 18, 36, 64, dtype=BF), t(2).abs() + 1.0, t(162, 162)
    w, b, wp, bp = t(64, 192, dtype=BF), t(192), t(64, 768, dtype=BF), t(768)
    xw, q, bias = t(1, 4, 168, 64, dtype=BF), t(4, 2, 162, 32, dtype=BF), t(2, 162, 162)
    return {
        "mlp_fwd": (mk, (t(648, 64, dtype=BF), t(64, 256, dtype=BF), t(256),
                         t(256, 64, dtype=BF), t(64))),
        "window_attention_qkv_bias": (wa, (x, w, b, s, bias, W9, m, 1.0)),
        "window_attention_grid": (wa, (x, x, x, s, W9, m, 1.0)),
        "window_attention_grid_bias": (wa, (x, x, x, s, bias, W9, m, 1.0)),
        "window_attention_v1": (wa, (q, q, q, s, (2, 2), m)),
        "window_attention_v1_bias": (wa, (q, q, q, s, bias, (2, 2), m)),
        "window_attention_qkv_padded": (wa, (x, wp, bp, s, 32, W9, m, 1.0)),
        "ln_dp_add_fwd": (lk, (t(648, 128, dtype=BF), t(648, 128, dtype=BF), t(128), t(128),
                               t(648, 1))),
        "window_attention_qkv5": (v45, (x, t(6, 64, 32, dtype=BF), b, s, W9, m, 1.0)),
        "window_attention_qkv4": (v45, (xw, w, b, s, W9, (2, 2), m, 1.0)),
        "window_attention_qkv4_padded": (v45, (xw, wp, bp, s, 32, W9, (2, 2), m, 1.0)),
    }[name]


# the forward launchers with a custom op besides K1's and K3's
NEW_OPS = ["ln_dp_add_fwd", "mlp_fwd", "window_attention_grid", "window_attention_grid_bias",
           "window_attention_qkv4", "window_attention_qkv4_padded", "window_attention_qkv5",
           "window_attention_qkv_bias", "window_attention_qkv_padded", "window_attention_v1",
           "window_attention_v1_bias"]


def faked(mode, args, as_op=False):
    """The arguments with each tensor a fake CUDA tensor of its shape and dtype
    (and, for the op, each tuple a list)."""
    def one(a):
        if torch.is_tensor(a):
            return FakeTensor(mode, torch.empty(a.shape, dtype=a.dtype, device="meta"),
                              torch.device("cuda", 0))
        return list(a) if as_op and isinstance(a, tuple) else a
    return [one(a) for a in args]


@pytest.mark.parametrize("name", NEW_OPS)
def test_op_fake_matches_plain_version(name):
    """``swin::<name>``'s fake on fake CUDA tensors: the shape and dtype of
    the plain version's output on the same operands on the CPU, on CUDA."""
    module, args = op_args(name)
    ref = getattr(module, name + "_reference")(*args)
    op = getattr(module, name + "_op")
    assert str(op._opoverload) == f"swin.{name}.default"
    mode = FakeTensorMode()
    with mode:
        out = op(*faked(mode, args, as_op=True))
    assert (out.shape, out.dtype, out.device.type) == (ref.shape, ref.dtype, "cuda")


# --------------------------------------------------------------------------
# platforms
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_engine():
    return engines("float32")[1]


def test_cpu_platform_artifact(cpu_engine, tmp_path):
    """``platforms=("cpu",)`` (named twice) writes one CPU program, bit-equal
    to the engine's step; a CUDA load of it raises naming both."""
    manifest = export_stepper(cpu_engine, str(tmp_path), platforms=("cpu", "cpu"))
    assert manifest["platforms"] == ["cpu"] and list(manifest["artifacts"]) == ["cpu"]
    assert manifest["artifact_bytes"] == (tmp_path / "stepper.cpu.pt2").stat().st_size
    state, zen = inputs(cpu_engine)
    assert torch.equal(load_stepper(str(tmp_path), "cpu")(state, zen),
                       cpu_engine._step(state, zen))
    with pytest.raises(ValueError, match="exported on cpu; it has no program for cuda"):
        load_stepper(str(tmp_path), device="cuda")


@pytest.mark.parametrize("platforms", [("tpu",), ("cpu", "tpu"), ()])
def test_platforms_the_port_refuses(cpu_engine, tmp_path, platforms):
    with pytest.raises(ValueError, match=r"the port traces \['cuda', 'cpu'\]"):
        export_stepper(cpu_engine, str(tmp_path), platforms=platforms)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("flags, want", [([], None), (["--platforms", "cpu"], ["cpu"]),
                                         (["--platforms", "cuda", "cpu"], ["cuda", "cpu"])])
def test_cli_platforms_parsed_as_jax(monkeypatch, tmp_path, flags, want):
    """``--export-stepper D [--platforms ...]``: both CLIs hand export_stepper
    the same ``platforms`` (the engine and the export stubbed)."""
    seen = {}

    def fake_export(engine, out_dir, batch=1, platforms=None):
        seen.setdefault("platforms", []).append(platforms)
        return {"artifact_bytes": 0, "platforms": platforms or ["cpu"]}

    argv = ["--registry", str(tmp_path), "--export-stepper", str(tmp_path / "a"), *flags]
    monkeypatch.setattr(jax_export, "export_stepper", fake_export)
    monkeypatch.setattr(jax_registry, "load_model", lambda reg: (None, None, None))
    monkeypatch.setattr(jax_rollout, "RolloutEngine", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["cli", *argv])
    jax_cli.main()
    monkeypatch.setattr(export, "export_stepper", fake_export)
    monkeypatch.setattr(cli, "_engine", lambda args: (None, None))
    cli.main([*argv, "--device", "cpu"])
    assert seen["platforms"] == [want, want]
