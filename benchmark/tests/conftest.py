"""Tests of the benchmark: CPU tests at a micro size, and ``cuda``-marked tests
that run on the card (``python -m pytest --noconftest`` is not needed: this
file imports neither JAX nor the JAX package)."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CONFIGS = {"swin_73var_geo_depth12_chweight_invar": 64,
           "swin_73var_geo_depth24_e2048_mlp2_chweight_invar": 128}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return "cuda"


def make_micro_root(path: str) -> str:
    """A checkout-like root whose benchmark data are the repository's with every
    configuration cut to 24 x 48 at depth 2 and every forecast to 8 steps in
    chunks of 2 (the harness's code is the repository's)."""
    data = os.path.join(path, "benchmark")
    shutil.copytree(os.path.join(REPO, "benchmark"), data,
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "*.py"))
    for sub in ("metrics",):
        shutil.copytree(os.path.join(REPO, "benchmark", sub), os.path.join(data, sub),
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    for name, dim in CONFIGS.items():
        fname = os.path.join(data, "configs", name + ".json")
        with open(fname) as f:
            doc = json.load(f)
        doc[name].update(img_size=[24, 48], embed_dim=dim, depth=2, num_heads=2,
                         patch_size=2, window_ratio=12)
        with open(fname, "w") as f:
            json.dump(doc, f)
    for t in os.listdir(os.path.join(data, "traffic")):
        fname = os.path.join(data, "traffic", t)
        with open(fname) as f:
            doc = json.load(f)
        if doc["kind"] == "forecast":
            doc.update(steps=8, chunk=2, check_last_step=3)
        with open(fname, "w") as f:
            json.dump(doc, f)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), path)
    return path


@pytest.fixture
def micro_root(tmp_path):
    return make_micro_root(str(tmp_path / "root"))
