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
