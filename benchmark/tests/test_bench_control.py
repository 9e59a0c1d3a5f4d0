"""The control comes out not correct: the reference at the precision below
the configuration's (fp8 products, bf16 losses and scores) put in the
program's place, judged by the cell's own limits. On the card at each
cell's own size (``python -m pytest -m cuda benchmark/tests``)."""

import json
import os
import shutil
import tempfile

import pytest

from benchmark.harness import cells
from benchmark.harness.main import cell_spec, judge, load_spec

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in load_spec(REPO)["workloads"]]


def control_readings(root, cell, seed, device):
    cs = cell_spec(load_spec(root), root, cell)
    with open(cs["config_file"]) as f:
        cfg = json.load(f)[cs["config"]["name"]]
    scratch = tempfile.mkdtemp(prefix="swin-control-")
    try:
        c = cells.KINDS[cs["traffic"]["kind"]](cells.Run(
            cell=cell, config_name=cs["config"]["name"], config_file=cs["config_file"],
            cfg=cfg, traffic=cs["traffic"], seed=seed, device=device, scratch=scratch))
        c.setup()
        c.window(0.0)
        c.free()
        cells.collect()
        return c.check(control=True), cs["limits"]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cuda_device, cell):
    readings, limits = control_readings(REPO, cell, 2**31 + 77, cuda_device)
    correct, _ = judge(readings, limits)
    assert not correct, readings
