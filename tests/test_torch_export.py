"""PyTorch port, the serving artifact (``inference/export.py``): a
``torch.export`` program of the engine's step, saved and loaded (in this
process and in a fresh one that imports no model code), bit-equal to the
engine on the CPU; its manifest against the JAX package's ``export_stepper``
manifest; and, on fake CUDA tensors, K1's and K3's custom ops and the error
each forward launcher raises when a traced call reaches it outside its
custom op (tests/test_torch_export_routes.py: every route's artifact).

On the CPU the program holds the plain versions' operations (the wrappers
take them for CPU tensors), so the artifact is bit-equal to the engine's
step (measured: max difference 0.0; bound 0).
"""

import datetime
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from swin_v2_weather_tpu.inference.export import export_stepper as jax_export_stepper
from swin_v2_weather_torch.inference.export import export_stepper, load_stepper
from swin_v2_weather_torch.ops import mlp_kernels as mk
from swin_v2_weather_torch.ops import window_attention as wa
from test_torch_export_routes import NEW_OPS, faked, op_args
from test_torch_inference import engines

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = datetime.datetime(2018, 1, 1, 0, 0)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX engine, port engine, artifact dir, manifest) at batch 2."""
    jax_engine, engine = engines("float32")
    art = str(tmp_path_factory.mktemp("served"))
    return jax_engine, engine, art, export_stepper(engine, art, batch=2)


def inputs(engine, seed=0):
    state = np.random.default_rng(seed).standard_normal((2, 4, 24, 48)).astype(np.float32)
    zen = np.broadcast_to(engine.zenith_at(START), (2, 1, 24, 48)).copy()
    return state, zen


def test_artifact_bit_equal_to_engine_step(exported):
    _, engine, art, manifest = exported
    path = os.path.join(art, "stepper.cpu.pt2")
    assert os.path.getsize(path) == manifest["artifact_bytes"] > 0
    with zipfile.ZipFile(path) as z:  # no example inputs saved
        assert sum(i.file_size for i in z.infolist() if "sample_inputs" in i.filename) == 0
    served = load_stepper(art, device="cpu")
    state, zen = inputs(engine)
    out = served(state, zen)
    ref = engine._step(torch.from_numpy(state), torch.from_numpy(zen))
    assert out.shape == (2, 4, 24, 48) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="requires a zenith input"):
        served(state)
    with pytest.raises(ValueError, match="exported on cpu"):
        load_stepper(art, device="cuda")


def test_load_in_a_process_without_model_code(exported, tmp_path):
    _, engine, art, _ = exported
    state, zen = inputs(engine, seed=1)
    np.save(tmp_path / "state.npy", state)
    np.save(tmp_path / "zen.npy", zen)
    np.save(tmp_path / "ref.npy", engine._step(torch.from_numpy(state),
                                               torch.from_numpy(zen)).numpy())
    code = (
        "import sys, numpy as np\n"
        "from swin_v2_weather_torch.inference.export import load_stepper\n"
        f"d = {str(tmp_path)!r}\n"
        f"out = load_stepper({art!r}, device='cpu')(np.load(d + '/state.npy'), "
        "np.load(d + '/zen.npy')).numpy()\n"
        "assert (out == np.load(d + '/ref.npy')).all()\n"
        "print(sorted(m for m in sys.modules if m.startswith('swin_v2_weather_torch.models')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_manifest_matches_jax(exported, tmp_path):
    jax_engine, _, art, manifest = exported
    ref = jax_export_stepper(jax_engine, str(tmp_path / "jax"), batch=2)
    shared = {"inputs", "output", "grid", "hours_per_step", "add_zenith", "out_channels",
              "artifact_bytes", "format", "platforms"}
    assert shared <= set(manifest) and shared <= set(ref)
    for key in shared - {"artifact_bytes", "format"}:
        assert manifest[key] == ref[key], key
    assert manifest["format"] == "torch.export" and manifest["device"] == "cpu"
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f) == manifest


def fake_cuda(mode, *shape, dtype=torch.float32):
    return FakeTensor(mode, torch.empty(shape, dtype=dtype, device="meta"),
                      torch.device("cuda", 0))


def test_custom_ops_shapes_on_fake_cuda_tensors():
    mode = FakeTensorMode()
    with mode:
        x = fake_cuda(mode, 1, 18, 36, 64, dtype=torch.bfloat16)
        out = wa.window_attention_qkv_op(
            x, fake_cuda(mode, 64, 192, dtype=torch.bfloat16), fake_cuda(mode, 192),
            fake_cuda(mode, 2), [9, 18], fake_cuda(mode, 162, 162), 1.0)
        y = mk.fc1_gelu_op(fake_cuda(mode, 648, 64, dtype=torch.bfloat16),
                           fake_cuda(mode, 64, 256, dtype=torch.bfloat16), fake_cuda(mode, 256))
    assert (out.shape, out.dtype, out.device.type) == ((1, 18, 36, 64), torch.bfloat16, "cuda")
    assert (y.shape, y.dtype, y.device.type) == ((648, 256), torch.bfloat16, "cuda")
    assert str(wa.window_attention_qkv_op._opoverload) == "swin.window_attention_qkv.default"
    assert str(mk.fc1_gelu_op._opoverload) == "swin.fc1_gelu.default"


@pytest.mark.parametrize("kernel", NEW_OPS)
def test_unregistered_kernel_raises_while_traced(kernel):
    """Each forward launcher with a custom op, called directly on fake CUDA
    tensors (a traced call that bypassed ``swin::<kernel>``), raises naming
    itself and its op, before any launch."""
    module, args = op_args(kernel)
    fn = getattr(module, kernel)
    before = fn.launches
    mode = FakeTensorMode()
    with mode, pytest.raises(RuntimeError, match=f"{kernel} was reached with a fake tensor") \
            as err:
        fn(*faked(mode, args))
    assert f"custom op swin::{kernel}" in str(err.value) and fn.launches == before


def test_cpb_kernel_raises_naming_k7_while_traced():
    """K7's wrapper reached outside ``swin::window_attention_qkv_bias`` (the
    CPB model's attention traced past its op); a backward launcher names
    itself as one without an op."""
    mode = FakeTensorMode()
    x = fake_cuda(mode, 1, 18, 36, 64, dtype=torch.bfloat16)
    args = (x, fake_cuda(mode, 64, 192, dtype=torch.bfloat16), fake_cuda(mode, 192),
            fake_cuda(mode, 2), fake_cuda(mode, 2, 162, 162))
    with mode, pytest.raises(RuntimeError,
                             match=r"custom op swin::window_attention_qkv_bias$"):
        wa.window_attention_qkv_bias(*args, (9, 18))
    with mode, pytest.raises(RuntimeError, match="a backward kernel has no custom op"):
        wa.window_attention_qkv_bias_bwd(*args, x, (9, 18))
    assert wa.window_attention_qkv_bias.launches == 0
