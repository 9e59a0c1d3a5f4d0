"""No module under benchmark/ imports JAX, its libraries or the JAX package,
and the plain reference imports nothing of the port either (top-level module
names compared whole: the port's name begins with the JAX package's)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "orbax", "swin_v2_weather_tpu"}
PORT = "swin_v2_weather_torch"


def modules(path):
    for dirpath, _, files in os.walk(path):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of every import statement in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(modules(BENCH))


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, BENCH) for p in FILES])
def test_no_jax_import(path):
    names = set(imported(path))
    assert not names & JAX_SIDE, (path, names & JAX_SIDE)
    if os.path.relpath(path, BENCH).startswith("reference" + os.sep):
        assert PORT not in names, path


def test_guard_sees_the_names_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import swin_v2_weather_torch.models\nfrom jax import numpy\nimport jaxtyping\n")
    assert set(imported(str(f))) == {"swin_v2_weather_torch", "jax", "jaxtyping"}
    assert set(imported(str(f))) & JAX_SIDE == {"jax"}


def test_no_file_reads_the_jax_package():
    for path in FILES:
        with open(path) as f:
            assert "swin_v2_weather_tpu" not in f.read().replace(
                '"swin_v2_weather_tpu"', ""), path
