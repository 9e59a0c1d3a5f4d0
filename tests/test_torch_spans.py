"""PyTorch port, profiler spans of the host loops (``utils/profiling.span``):
the train step's six phases, the scored forecast's zenith / upload / steps /
score / flush, breeding's span around its cycles, the off path that never
opens a profiler range, and ``StepTimer`` (its CUDA path under the
``cuda`` marker: ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py`` on the card). Imports no JAX."""

import datetime

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.data.preprocess import Preprocessor, derived_channel_counts
from swin_v2_weather_torch.inference import ensemble
from swin_v2_weather_torch.inference.rollout import RolloutEngine
from swin_v2_weather_torch.inference.scoring import score_rollout
from swin_v2_weather_torch.models.wrappers import get_model
from swin_v2_weather_torch.ops.losses import LossHandler
from swin_v2_weather_torch.training.optim import build_optimizer
from swin_v2_weather_torch.training.step import build_train_step
from swin_v2_weather_torch.utils import profiling

START = datetime.datetime(2018, 1, 1, 0, 0)
TRAIN = ["preprocess", "forward", "loss", "backward", "grad_norms", "optimizer"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the timer records CUDA events")
    return torch.device("cuda")


def micro():
    """The micro config (24 x 48, zenith and static channels) and its model."""
    torch.manual_seed(0)
    p = YParams(default_config_path(), "swin_micro_test")
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    p["img_shape_x"], p["img_shape_y"] = p.img_size
    return p, get_model(p, device="cpu")


def spans(fn):
    """The program's spans that ``fn()`` opens under a CPU profiler, in order of
    their start: [(name without the prefix, start, end)]. They are host ops,
    not user annotations (which the profiler mirrors on the device)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    n = len(profiling.SPAN_PREFIX)
    got = [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    assert got and not any(e.is_user_annotation for e in got)
    return sorted(((e.name[n:], e.time_range.start, e.time_range.end) for e in got),
                  key=lambda s: s[1])


def train_step():
    p, model = micro()
    step = build_train_step(model, LossHandler(p), Preprocessor(p),
                            build_optimizer(p, model.parameters()),
                            generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    shape = (1, len(p.out_channels), *p.img_size)
    batch = {"inp": torch.randn(shape, generator=g), "tar": torch.randn(shape, generator=g),
             "zen_inp": torch.rand((1, 1, *p.img_size), generator=g),
             "zen_tar": torch.rand((1, 1, *p.img_size), generator=g)}
    return lambda: step(batch)


def forecast_inputs(n_steps, members=1):
    p, model = micro()
    rng = np.random.default_rng(0)
    c, (h, w) = len(p.out_channels), p.img_size
    ic = rng.standard_normal((members, c, h, w)).astype(np.float32)
    tars = [rng.standard_normal((1, c, h, w)).astype(np.float32) for _ in range(n_steps)]
    kw = dict(means=np.zeros((c, 1, 1), np.float32), stds=np.ones((c, 1, 1), np.float32),
              climatology=rng.standard_normal((c, h, w)).astype(np.float32))
    return RolloutEngine(p, model, "cpu"), ic, tars, kw


def test_train_step_spans_each_phase_once_in_order():
    got = spans(train_step())
    assert [s[0] for s in got] == ["train/" + name for name in TRAIN]
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert end <= start  # one after another, none nested


def test_scored_forecast_spans_per_chunk_and_per_step():
    engine, ic, tars, kw = forecast_inputs(5)
    got = spans(lambda: score_rollout(engine, ic, tars, START, scanned=True, chunk=2, **kw))
    want = []
    for k in (2, 2, 1):  # a chunk: its zenith stack up, its steps, each step scored, one flush
        want += ["zenith", "upload", "steps"] + ["upload", "score"] * k + ["flush"]
    assert [s[0] for s in got] == ["forecast/" + name for name in want]


def test_breeding_nests_a_zenith_span_per_cycle():
    engine, ic, tars, kw = forecast_inputs(3)

    def run():
        pert = ensemble.breed_perturbations(engine, ic, START, 1, 0.05, cycles=2, seed=3,
                                            zonal_truncation=4)
        ensemble.score_ensemble(engine, ensemble.make_members(ic, pert, 3), tars, START,
                                chunk=2, **kw)

    got = spans(run)
    (breed,) = [s for s in got if s[0] == "forecast/breed"]
    inside = [s[0] for s in got if breed[1] <= s[1] and s[2] <= breed[2] and s is not breed]
    assert inside == ["forecast/zenith", "forecast/upload", "forecast/steps"] * 2
    after = [s[0][len("forecast/"):] for s in got if s[1] >= breed[2]]
    want = []
    for k in (2, 1):  # score_ensemble: a chunk's uploads, then each step and its scores
        want += ["zenith", "upload"] + ["steps", "score"] * k + ["flush"]
    assert after == want


def test_spans_off_never_reach_the_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no profiler recording")

    step = train_step()
    engine, ic, tars, kw = forecast_inputs(3)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("train/forward") is profiling.span("forecast/zenith")
    step()
    out = score_rollout(engine, ic, tars, START, scanned=True, chunk=2, **kw)
    assert out["rmse"].shape == (3, len(tars[0][0]))


@pytest.mark.cuda
def test_step_timer_cuda_events_without_a_host_sync(cuda_device, monkeypatch):
    x = torch.randn(2048, 2048, device=cuda_device)
    timer = profiling.StepTimer(cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("a host sync in tick()")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(torch.cuda.Event, "synchronize", refuse)
        for n in (4, 16, 0):  # two steps, of 4 and of 16 products
            timer.tick()
            for _ in range(n):
                x = torch.tanh(x @ x)
    out = timer.reset()
    assert set(out) == {"step_time_mean", "step_time_p50", "step_time_max"}
    assert 0 < out["step_time_mean"] < out["step_time_max"]
    assert timer.reset() == {}
