"""PyTorch port, the JAX checkpoint interchange with LAMB (``optimizer_type:
lamb``: optax's ``chain(clip_by_global_norm, lamb)`` against the port's
``training.optim.Lamb``): JAX Trainer checkpoints of ``swin_micro_test`` in
the scanned and the unrolled layout resume in the port like JAX's own
resume, import followed by export gives every leaf back bit for bit, and a
port checkpoint resumes in JAX. The helpers, settings and bounds are those
of tests/test_torch_interchange.py.
"""

import pytest
import torch

from test_torch_interchange import (  # noqa: F401  (one_device_mesh: an autouse fixture)
    check_export_resume,
    check_import_resume,
    check_round_trip,
    interchange_run,
    one_device_mesh,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[True, False], ids=["scanned", "unrolled"])
def lamb(request, tmp_path_factory):
    layout = "scanned" if request.param else "unrolled"
    return interchange_run(tmp_path_factory.mktemp(f"lamb_{layout}"), "lamb", request.param)


def test_import_resumes_like_jax(lamb):
    check_import_resume(lamb)


def test_import_export_round_trip_bit_exact(lamb):
    check_round_trip(lamb)


@pytest.mark.parametrize("lamb", [False], ids=["unrolled"], indirect=True)
def test_export_resumes_in_jax(lamb):
    check_export_resume(lamb)
