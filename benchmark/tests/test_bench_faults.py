"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have (``benchmark/faults.py``), planted in the port at a
micro size on the CPU (the harness's look for a chip skipped, the rest of
the run as on the card)."""

import json

import pytest

from benchmark import faults
from benchmark.harness.main import run


def result(root, cell, capsys):
    argv = ["--workload", cell, "--seed", "2147483801", "--seconds", "0.5", "--trace", "0"]
    assert run(argv, root=root, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["flagship-train", "e2048-train"])
@pytest.mark.parametrize("fault,number", [("unchanged", "update_gap"), ("altered", "loss_gap")])
def test_train_fault_is_not_correct(micro_root, capsys, monkeypatch, cell, fault, number):
    faults.plant(fault, "train", monkeypatch.setattr)
    res = result(micro_root, cell, capsys)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("cell,fault,number", [
    ("e2048-forecast", "unchanged", "step_gap"), ("e2048-forecast", "channel", "step_gap"),
    ("flagship-ensemble", "unchanged", "step_gap"), ("flagship-ensemble", "half", "member_gap"),
    ("flagship-ensemble", "channel", "step_gap"), ("flagship-ensemble", "noise", "seed_gap")])
def test_forecast_fault_is_not_correct(micro_root, capsys, monkeypatch, cell, fault, number):
    faults.plant(fault, "forecast", monkeypatch.setattr)
    res = result(micro_root, cell, capsys)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > (res["checks"][number]["limit"] or 0.0)


@pytest.mark.parametrize("cell", ["e2048-forecast", "flagship-ensemble"])
def test_altered_score_is_not_correct(micro_root, capsys, monkeypatch, cell):
    faults.plant("score", "forecast", monkeypatch.setattr)
    res = result(micro_root, cell, capsys)
    assert res["correct"] is False
    assert res["checks"]["score_gap"]["value"] > res["checks"]["score_gap"]["limit"]
