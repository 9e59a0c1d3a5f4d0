"""``benchmark/spans.py``'s table of the program's spans, from synthetic
profiler events: nested spans, a runtime copy skipped, idle given to the
innermost span open and to ``(no span)``, the device-side copy of an
annotation left out."""

from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, kernels=(), dev=CPU, annotation=False):
    return NS(name=name, device_type=dev, is_user_annotation=annotation,
              kernels=[NS(name=k, duration=us) for k, us in kernels],
              time_range=NS(start=start, end=end, elapsed_us=lambda: end - start))


def test_span_table_from_nested_spans():
    events = [
        ev("swin/forecast/breed", 0, 100),
        ev("swin/forecast/zenith", 10, 40),
        ev("swin/forecast/steps", 40, 90),
        ev("aten::mm", 45, 50, [("gemm", 20.0)]),
        ev("cudaLaunchKernel", 46, 47, [("gemm", 20.0)]),  # the runtime's copy: skipped
        ev("aten::copy_", 110, 120, [("Memcpy HtoD", 5.0)]),  # in no span
        ev("swin/forecast/flush", 130, 160),
        # the device: busy 0-10, 50-70, 115-120, 150-155; the annotation's copy is no work
        ev("k0", 0, 10, dev=CUDA), ev("gemm", 50, 70, dev=CUDA),
        ev("Memcpy HtoD", 115, 120, dev=CUDA), ev("k1", 150, 155, dev=CUDA),
        ev("swin/forecast/steps", 50, 90, dev=CUDA, annotation=True),
    ]
    table = spans.span_table(events)
    assert table["swin/forecast/breed"][:3] == [1, pytest.approx(100e-6), pytest.approx(20e-6)]
    assert table["swin/forecast/steps"][:3] == [1, pytest.approx(50e-6), pytest.approx(20e-6)]
    assert table["swin/forecast/zenith"][2] == 0.0
    # gaps 10-50 (zenith 10-40, steps 40-50), 70-115 (steps 70-90, breed 90-100,
    # none 100-115), 120-150 (none 120-130, flush 130-150)
    idle = {k: v[3] * 1e6 for k, v in table.items()}
    assert idle == pytest.approx({"swin/forecast/breed": 10, "swin/forecast/zenith": 30,
                                  "swin/forecast/steps": 30, "swin/forecast/flush": 20,
                                  spans.NO_SPAN: 25})
    assert table[spans.NO_SPAN][2] == pytest.approx(5e-6)
    assert sum(v[3] for v in table.values()) == pytest.approx(115e-6)


def test_span_table_without_spans():
    table = spans.span_table([ev("aten::add", 0, 5, [("add", 3.0)]), ev("add", 1, 4, dev=CUDA),
                              ev("add", 9, 12, dev=CUDA)])
    assert table == {spans.NO_SPAN: [0, 0.0, pytest.approx(3e-6), pytest.approx(5e-6)]}
    assert spans.line(table).startswith("trace: program spans {")


def test_summarize_unchanged_by_host_spans():
    """The spans are host ops that launch nothing themselves (the ops inside
    them do): every reading of ``harness/trace.summarize`` but the naming of
    idle gaps is the same with them in the trace as without."""
    import os

    from benchmark.harness import trace

    def launch(name, start, end, kernels):
        e = ev(name, start, end, kernels)
        e.input_shapes = []
        return e

    base = [
        launch("swin::mlp_fwd", 10, 20, [("gemm_kernel<swin_mlp::Fc1Epilogue>", 300.0)]),
        launch("aten::mm", 30, 40, [("nvjet_tst_128x256", 100.0)]),
        launch("aten::copy_", 50, 60, [("Memcpy HtoD", 40.0)]),
        ev("gemm_kernel<swin_mlp::Fc1Epilogue>", 20, 320, dev=CUDA),
        ev("nvjet_tst_128x256", 330, 430, dev=CUDA), ev("Memcpy HtoD", 600, 640, dev=CUDA),
    ]
    spans_ = [ev("swin/forecast/steps", 5, 45), ev("swin/forecast/upload", 48, 62),
              ev("swin/forecast/zenith", 440, 590)]
    data = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a, b = (trace.summarize(events, 1e-3, data) for events in (base, base + spans_))
    for key in ("wall_s", "busy_s", "launches", "cublas_s", "torch_ops_s", "unlinked_s",
                "device_ops", "by_op"):
        assert getattr(a, key) == getattr(b, key), key
    assert [g[1] for g in a.idle_gaps] == [g[1] for g in b.idle_gaps]
