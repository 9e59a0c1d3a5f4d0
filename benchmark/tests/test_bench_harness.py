"""The harness takes cells and metrics as data, and refuses to run without
the card: CPU runs at a micro size (``run(..., device="cpu")`` skips the
look for a chip, nothing else)."""

import json
import os

import pytest

from benchmark.harness.main import run


def add_files(root):
    """A new traffic mix, a new cell on it and a new per-layer metric, from
    files and entries alone."""
    data = os.path.join(root, "benchmark")
    with open(os.path.join(data, "traffic", "train.json")) as f:
        mix = json.load(f)
    mix.update(pool=2, check_steps=2, trace_steps=1)
    with open(os.path.join(data, "traffic", "short_pool.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(data, "metrics", "dummy_ms.train.py"), "w") as f:
        f.write("def read(ctx):\n    return 1e3 * ctx['window_s'] / ctx['train_samples']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "flagship-short-pool", "chips": 1,
                              "config": "swin_73var_geo_depth12_chweight_invar",
                              "traffic": "short_pool", "why": "a test cell"})
    spec["per_layer"].append({"name": "dummy_ms.train", "unit": "ms/step", "better": "lower",
                              "source": "host_clock", "layer": "train step",
                              "moves": "train_samples_s", "workloads": ["flagship-short-pool"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "flagship-train" in m["workloads"]:
            m["workloads"].append("flagship-short-pool")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


def last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_and_a_metric_from_files_alone(micro_root, capsys, trace):
    add_files(micro_root)
    argv = ["--workload", "flagship-short-pool", "--seed", "2147483700", "--seconds", "0.5",
            "--trace", str(trace)]
    assert run(argv, root=micro_root, device="cpu") == 0
    res = last_line(capsys)
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "update_gap"}
    if trace:
        assert res["metrics"]["dummy_ms.train"]["value"] > 0
        assert "train_samples_s" not in res["metrics"]
    else:
        assert res["metrics"]["train_samples_s"]["value"] > 0
        assert set(res["metrics"]) == {"train_samples_s", "setup_s"}  # no memory on the CPU


def test_no_card_no_result(micro_root, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--workload", "flagship-train", "--seed", "1", "--seconds", "1", "--trace", "0"]
    assert run(argv, root=micro_root) != 0
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs():
    import torch

    from benchmark.harness import inputs

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "swin_73var_geo_depth12_chweight_invar.json")) as f:
        cfg = dict(json.load(f)["swin_73var_geo_depth12_chweight_invar"], img_size=[24, 48])
    a, b = (inputs.train_pool(cfg, 2, 2**31 + 11, "cpu") for _ in range(2))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert inputs.seeds(2**31 + 11, 3) == inputs.seeds(2**31 + 11, 3)
    assert inputs.start_dates(5, 4) == inputs.start_dates(5, 4)


def test_trace_attribution_by_launcher():
    """Kernels linked to a hand kernel's op count as one launch of it; the
    copies the profiler lists under a runtime stall are skipped; the rest is
    cuBLAS's or PyTorch's."""
    from types import SimpleNamespace as NS

    import torch

    from benchmark.harness import trace

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def k(name, us):
        return NS(name=name, duration=us)

    def ev(name, kernels, dev=cpu, span=(0.0, 1.0), shapes=None):
        return NS(name=name, kernels=kernels, device_type=dev, input_shapes=shapes or [],
                  time_range=NS(start=span[0], end=span[1], elapsed_us=lambda: span[1] - span[0]))

    events = [
        ev("swin::mlp_fwd", [k("gemm_kernel<swin_mlp::Fc1Epilogue>", 300.0)],
           shapes=[[64800, 2048], [2048, 4096]]),
        ev("Command Buffer Full", [k("gemm_kernel<swin_mlp::Fc1Epilogue>", 300.0)]),
        ev("aten::mm", [k("nvjet_tst_128x256", 100.0)]),
        ev("aten::add", [k("vectorized_elementwise_kernel<add>", 40.0)]),
        ev("kernel", [], dev=cuda, span=(0.0, 500.0)),
        ev("kernel", [], dev=cuda, span=(600.0, 690.0)),
    ]
    data = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tr = trace.summarize(events, 1e-3, data)
    assert [(x.kernel, x.family, x.tokens) for x in tr.launches] == [("K5", "mlp", 64800)]
    assert tr.launches[0].seconds == pytest.approx(300e-6)
    assert tr.cublas_s == pytest.approx(100e-6)
    assert tr.torch_ops_s == pytest.approx(40e-6)
    assert tr.busy_s == pytest.approx(590e-6)
