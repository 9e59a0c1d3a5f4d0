"""PyTorch port, package hygiene: the port never imports JAX or the JAX
package, importing it builds nothing, and its config reader agrees with the
JAX one on every section of the shared swin.yaml."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import yaml

from swin_v2_weather_tpu.config import yparams as jax_yparams
from swin_v2_weather_torch.config import yparams

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "swin_v2_weather_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "swin_v2_weather_tpu"}


def port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_profile.py"]
    assert len(files) > 10
    bad = {
        str(f.relative_to(REPO)): sorted(set(imported_roots(f)) & FORBIDDEN) for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    """Import every module of the port in a fresh interpreter: no nvcc run, no
    new file under the build directory, and no JAX module loaded."""
    build_dir = PORT / "_build"
    before = sorted(os.listdir(build_dir)) if build_dir.exists() else None
    # modules an interpreter hook may have loaded before ours do not count
    code = (
        "import importlib, json, sys\n"
        "pre = set(sys.modules)\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "new = {k.split('.')[0] for k in set(sys.modules) - pre}\n"
        f"print(json.dumps(sorted(new & set({sorted(FORBIDDEN)!r}))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    after = sorted(os.listdir(build_dir)) if build_dir.exists() else None
    assert after == before


def test_every_bound_entry_point_is_defined_once_with_its_arity():
    """Each C entry point the ctypes binding types (``_build._SIGNATURES``) is
    defined exactly once in ``ops/csrc`` with as many parameters as the
    binding passes: a mismatch would shift every later argument."""
    import re

    from swin_v2_weather_torch.ops import _build

    text = "".join(pathlib.Path(p).read_text() for p in _build.sources())
    for name, argtypes in _build._SIGNATURES.items():
        found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert len(found) == 1, name
        assert found[0].count(",") + 1 == len(argtypes), name


def test_config_file_is_shared():
    assert os.path.samefile(yparams.default_config_path(), jax_yparams.default_config_path())


with open(jax_yparams.default_config_path()) as _f:
    SECTIONS = sorted(yaml.safe_load(_f))


@pytest.mark.parametrize("section", SECTIONS)
def test_yparams_match_jax(section):
    path = jax_yparams.default_config_path()
    ours = yparams.YParams(path, section)
    ref = jax_yparams.YParams(path, section)
    assert ours.params == ref.params
    assert ours.to_dict() == ref.to_dict()
    for key in ref.params:
        assert getattr(ours, key) == getattr(ref, key)


def test_kernel_sources_are_bound_and_noted():
    """Every C entry point that ops/_build.py binds is defined in one .cu
    source of ops/csrc, every .cu source defines one at least, and each
    starts with a note naming the TPU kernel it replaces (K8 and K9 in
    window_attention_grid.cu and window_attention_v1.cu included, and K13's
    consumer of the JAX probe script in prestage_consume.cu)."""
    from swin_v2_weather_torch.ops import _build

    csrc = PORT / "ops" / "csrc"
    sources = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu"))}
    assert {"window_attention_grid.cu", "window_attention_v1.cu"} <= set(sources)
    defined = {}
    for name in _build._SIGNATURES:
        hits = [f for f, text in sources.items() if f'extern "C" int {name}(' in text]
        assert len(hits) == 1, (name, hits)
        defined.setdefault(hits[0], []).append(name)
    assert set(defined) == set(sources)
    for f, text in sources.items():
        head = text.split("#include")[0]
        # the JAX package's kernels, or (K13) the JAX probe script's
        assert ("swin_v2_weather_tpu/ops/" in head or "scripts/prestage_probe.py" in head) and (
            "Replaces" in head), f


def test_qkv_attention_entry_points_are_importable_without_jax():
    """The K8/K9 entry points and their plain versions live in the port's
    window-attention module, which imports neither JAX nor the JAX package
    (checked for every module by the two tests above)."""
    from swin_v2_weather_torch.ops import window_attention as wa

    names = ["fused_window_attention_grid", "fused_window_attention", "normalize_heads",
             "normalize_vjp", "reference_attention"]
    for kind in ("grid", "grid_bias", "v1", "v1_bias"):
        names += [f"window_attention_{kind}", f"window_attention_{kind}_bwd",
                  f"window_attention_{kind}_reference",
                  f"window_attention_{kind}_backward_reference"]
    missing = [n for n in names if not callable(getattr(wa, n, None))]
    assert not missing
    assert "swin_v2_weather_torch.ops.window_attention" in port_modules()


def test_k12_k13_entry_points_are_importable_without_jax():
    """The K12 module (``ops/attic/window_attention_v45.py``), K13's wrapper
    (``ops/prestage.py``) and the GPU probe script import neither JAX nor the
    JAX package (checked for every module above) and expose their wrappers,
    plain versions and launch counters."""
    from swin_v2_weather_torch.ops import prestage
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45
    from swin_v2_weather_torch.scripts import prestage_probe

    for kind in ("qkv5", "qkv4", "qkv4_padded"):
        for name in (f"window_attention_{kind}", f"window_attention_{kind}_bwd"):
            assert getattr(v45, name).launches >= 0
            ref = name.replace("_bwd", "_backward") + "_reference"
            assert callable(getattr(v45, ref))
    assert prestage.consume.launches >= 0 and callable(prestage.consume_reference)
    for name in ("prestage", "unstage", "chain", "probe", "main"):
        assert callable(getattr(prestage_probe, name))
    mods = port_modules()
    for m in ("swin_v2_weather_torch.ops.attic.window_attention_v45",
              "swin_v2_weather_torch.ops.prestage",
              "swin_v2_weather_torch.scripts.prestage_probe"):
        assert m in mods
