"""PyTorch port, training runtime: the Trainer (epoch loop, validation,
checkpoints, resume, fine-tune, graceful preemption), the torch checkpoint
format, the native sweep agent, the training CLI and the utilities it logs
through, on ``swin_micro_test`` on the CPU, mirroring tests/test_training.py.

``test_trainer_matches_jax`` runs the JAX Trainer and the port's on the same
micro config (qkv-fused route, fp32, unrolled blocks, drop-path 0) from the
same weights, the JAX one on a 1-device mesh (under tests/conftest.py's 8
virtual devices its loss would be scaled by 1/8), and holds every epoch's
logged metrics and the final parameters to the bounds of the fp32 train-step
trajectory of tests/test_torch_training.py.
"""

import json
import logging
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from swin_v2_weather_tpu.config.yparams import YParams as JaxYParams
from swin_v2_weather_tpu.parallel import mesh as jax_mesh
from swin_v2_weather_tpu.training import trainer as jax_trainer
from swin_v2_weather_tpu.utils import img_utils as jax_img_utils
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.models.convert import params_from_jax
from swin_v2_weather_torch.training import checkpoint as ckpt
from swin_v2_weather_torch.training import preempt, sweeps
from swin_v2_weather_torch.training.optim import ReduceLROnPlateau
from swin_v2_weather_torch.training.trainer import Trainer, init_parameters, step_seed
from swin_v2_weather_torch.utils import img_utils, metrics_sink, profiling

from test_torch_model import noise_params
from test_torch_training import PARAM_TOL, STEP_RTOL, check_step_params

torch.set_num_threads(1)

MICRO = "swin_micro_test"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def micro_yparams(root, cls=YParams, **over):
    p = cls(default_config_path(), MICRO)
    p["exp_dir"] = str(root)
    p["max_epochs"] = 2
    p["n_synthetic_samples"] = 8
    p["batch_size"] = 2
    p["num_data_workers"] = 2
    for k, v in over.items():
        p[k] = v
    return p


def logs(root, run="t", config=MICRO):
    with open(os.path.join(str(root), config, run, "logs.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_trainer(root, run="t", **over):
    t = Trainer(micro_yparams(root, **over), MICRO, run_num=run, device="cpu")
    t.build_and_launch()
    return t


def state_equal(a, b) -> None:
    """Two nested states (state_dicts, optimizer state) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            state_equal(x, y)
    else:
        assert a == b


# --------------------------------------------------------------------------
# the Trainer end to end
# --------------------------------------------------------------------------


def test_loss_decreases_and_artifacts(tmp_path):
    t = run_trainer(tmp_path)
    lines = logs(tmp_path)
    assert len(lines) == 2 and [line["epoch"] for line in lines] == [1, 2]
    assert lines[1]["loss"] < lines[0]["loss"]
    for key in ("valid_loss", "valid_rmse_u10m", "valid_acc_v10m", "grad_norm/block1", "lr",
                "step_time_mean"):
        assert np.isfinite(lines[0][key]), key
    exp = tmp_path / MICRO / "t"
    for name in ("ckpt", "best_ckpt"):
        assert (exp / "training_checkpoints" / name / ckpt.CHECKPOINT_FILE).is_file()
    assert not [n for n in os.listdir(exp / "training_checkpoints") if n.startswith(".")]
    assert (exp / "hyperparams.yaml").is_file() and (exp / "out.log").is_file()
    assert t.host_step == 8 and t.epoch == 2


def test_trainer_matches_jax(tmp_path, monkeypatch):
    """Both Trainers, 2 epochs of 2 steps and 2 validation batches each, from
    the same (noise) weights: every logs.jsonl line (loss, grad norms, valid
    loss, RMSE, ACC, lr) and the final parameters agree; hyperparams.yaml
    loads to the same dict less the path keys."""
    over = dict(max_epochs=2, n_synthetic_samples=4, attn_impl="pallas_qkv",
                scan_blocks=False, compute_dtype="float32", drop_path_rate=0.0)
    make_mesh = jax_mesh.make_mesh
    monkeypatch.setattr(jax_trainer, "make_mesh",
                        lambda params: make_mesh(params, devices=jax.devices()[:1]))
    ta = jax_trainer.Trainer(micro_yparams(tmp_path / "jax", JaxYParams, **over), MICRO, "t")
    ta.build()
    # every weight from seeded noise: no block is the identity at the start
    noise = noise_params(ta.state.params, np.random.default_rng(0))
    ta.state = ta.state.replace(params=jax.tree.map(
        lambda n, a: jax.device_put(jnp.asarray(n), a.sharding), noise, ta.state.params))
    start = jax.tree.map(np.asarray, ta.state.params)
    tb = Trainer(micro_yparams(tmp_path / "torch", **over), MICRO, "t", device="cpu")
    tb.build()
    tb.model.load_state_dict(params_from_jax(start))
    ta.train()
    tb.train()

    loss_rtol, norm_rtol = STEP_RTOL["float32"]
    jax_lines, port_lines = logs(tmp_path / "jax"), logs(tmp_path / "torch")
    assert len(jax_lines) == len(port_lines) == 2
    for ref, got in zip(jax_lines, port_lines):
        assert set(got) == set(ref)
        assert got["epoch"] == ref["epoch"] and got["lr"] == ref["lr"]
        for key, want in ref.items():
            if key.endswith("_time") or key.startswith("step_time"):
                continue  # wall clocks
            if key.startswith("valid_"):
                # the eval step's bounds (tests/test_torch_training.py)
                np.testing.assert_allclose(got[key], want, rtol=2e-3, atol=1e-4, err_msg=key)
            elif key == "loss" or key.startswith("grad_norm"):
                rtol = loss_rtol if key == "loss" else norm_rtol
                assert got[key] == pytest.approx(want, rel=rtol), key
    check_step_params(jax.tree.map(np.asarray, ta.state.params), tb.model, start,
                      float(tb.params.lr), *PARAM_TOL["float32"])

    paths = {"exp_dir", "experiment_dir", "checkpoint_path", "best_checkpoint_path"}
    with open(tmp_path / "jax" / MICRO / "t" / "hyperparams.yaml") as f:
        ref_hp = yaml.safe_load(f)
    with open(tmp_path / "torch" / MICRO / "t" / "hyperparams.yaml") as f:
        port_hp = yaml.safe_load(f)
    assert set(port_hp) == set(ref_hp)
    assert {k: v for k, v in port_hp.items() if k not in paths} == {
        k: v for k, v in ref_hp.items() if k not in paths}


def test_resume_continues(tmp_path, caplog):
    run_trainer(tmp_path)
    caplog.set_level(logging.INFO)
    t2 = Trainer(micro_yparams(tmp_path, max_epochs=3), MICRO, run_num="t", device="cpu")
    t2.build()
    assert t2.params["resuming"] and t2.start_epoch == 2 and t2.host_step == 8
    assert t2.resume_step_in_epoch == 0
    assert all(len(s) == 3 for s in t2.optimizer.state.values())  # Adam moments and step
    t2.train()
    lines = logs(tmp_path)
    assert [line["epoch"] for line in lines] == [1, 2, 3]
    want = f"Loading checkpoint {t2.params['checkpoint_path']}"
    assert want in caplog.text
    with open(tmp_path / MICRO / "t" / "out.log") as f:
        assert want in f.read()


def test_finetune_loads_weights_only(tmp_path):
    t1 = run_trainer(tmp_path, run="pre")
    p2 = micro_yparams(tmp_path, n_future=1, max_epochs=1, finetune=True, lr=1e-4,
                       pretrained_checkpoint_path=t1.params["checkpoint_path"])
    t2 = Trainer(p2, MICRO, run_num="ft2step", device="cpu")
    t2.build()
    assert not t2.params["resuming"] and t2.start_epoch == 0 and t2.host_step == 0
    assert t2.optimizer.state_dict()["state"] == {}  # fresh optimizer
    assert t2.optimizer.param_groups[0]["lr"] == 1e-4
    state_equal(t1.model.state_dict(), t2.model.state_dict())  # the weights came over
    t2.train()
    (line,) = logs(tmp_path, run="ft2step")
    assert np.isfinite(line["loss"]) and "valid_rmse_u10m" in line


def test_checkpoint_round_trip_bit_exact(tmp_path):
    """Weights, Adam's moments and step counts, the counters and the plateau
    scheduler's state come back bit for bit; the fine-tune path loads the
    weights alone."""
    t = run_trainer(tmp_path, max_epochs=1)
    sched = ReduceLROnPlateau(1e-3, factor=0.2, patience=1)
    for metric in (3.0, 4.0, 5.0, 6.0):  # an LR cut and one bad epoch pending
        sched.step(metric)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, t.model, t.optimizer, iters=17, epoch=5,
                         scheduler_state=sched.state_dict(), step_in_epoch=3)

    fresh = Trainer(micro_yparams(tmp_path / "fresh"), MICRO, device="cpu").build()
    assert not torch.equal(fresh.model.model.head.weight, t.model.model.head.weight)
    template = ReduceLROnPlateau(1e-3, factor=0.2, patience=1)
    out = ckpt.restore_checkpoint(path, fresh.model, fresh.optimizer, resuming=True,
                                  scheduler_template=template.state_dict())
    assert (out["iters"], out["epoch"], out["step_in_epoch"]) == (17, 5, 3)
    state_equal(fresh.model.state_dict(), t.model.state_dict())
    state_equal(fresh.optimizer.state_dict(), t.optimizer.state_dict())
    step = next(iter(fresh.optimizer.state.values()))["step"]
    assert step.dtype == torch.float32 and step.device.type == "cpu" and float(step) == 4
    template.load_state_dict(out["scheduler"])
    assert template.state_dict() == sched.state_dict()

    other = Trainer(micro_yparams(tmp_path / "ft"), MICRO, device="cpu").build()
    out = ckpt.restore_checkpoint(path, other.model, resuming=False)
    assert out == {"epoch": 0, "step_in_epoch": 0, "iters": 0}
    state_equal(other.model.state_dict(), t.model.state_dict())
    assert other.optimizer.state_dict()["state"] == {}

    # a checkpoint that predates step_in_epoch and the scheduler state
    payload = torch.load(os.path.join(path, ckpt.CHECKPOINT_FILE), weights_only=True)
    del payload["step_in_epoch"], payload["scheduler"]
    old = tmp_path / "old"
    os.makedirs(old)
    torch.save(payload, old / ckpt.CHECKPOINT_FILE)
    out = ckpt.restore_checkpoint(str(old), fresh.model, fresh.optimizer, resuming=True,
                                  scheduler_template=template.state_dict())
    assert out == {"epoch": 5, "step_in_epoch": 0, "iters": 17}


def test_restore_refuses_a_partial_restore(tmp_path):
    """A depth mismatch, a missing key or a missing optimizer state raises
    instead of loading fresh weights silently."""
    t = run_trainer(tmp_path, max_epochs=1)
    path = t.params["checkpoint_path"]
    deeper = Trainer(micro_yparams(tmp_path / "d4", depth=4), MICRO, device="cpu").build()
    with pytest.raises(ValueError, match="missing requested keys.*blocks.2"):
        ckpt.restore_checkpoint(path, deeper.model, resuming=False)
    wider = Trainer(micro_yparams(tmp_path / "w", embed_dim=32), MICRO, device="cpu").build()
    with pytest.raises(ValueError, match="another shape"):
        ckpt.restore_checkpoint(path, wider.model, resuming=False)

    payload = torch.load(os.path.join(path, ckpt.CHECKPOINT_FILE), weights_only=True)
    del payload["model"]["model.head.weight"]
    del payload["optimizer"]["state"][0]
    for name, drop in (("nohead", "model"), ("noadam", "optimizer")):
        broken = dict(payload)
        if drop == "optimizer":  # the weights whole, one parameter's Adam state gone
            broken["model"] = torch.load(os.path.join(path, ckpt.CHECKPOINT_FILE),
                                         weights_only=True)["model"]
        os.makedirs(tmp_path / name)
        torch.save(broken, tmp_path / name / ckpt.CHECKPOINT_FILE)
    fresh = Trainer(micro_yparams(tmp_path / "f"), MICRO, device="cpu").build()
    with pytest.raises(ValueError, match="missing requested keys.*head.weight"):
        ckpt.restore_checkpoint(str(tmp_path / "nohead"), fresh.model, resuming=False)
    ckpt.restore_checkpoint(str(tmp_path / "noadam"), fresh.model, resuming=False)
    with pytest.raises(ValueError, match="missing requested keys.*optimizer/state/0"):
        ckpt.restore_checkpoint(str(tmp_path / "noadam"), fresh.model, fresh.optimizer,
                                resuming=True)


class TriggerAfter:
    """An injected preemption trigger that fires at the n-th poll."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    @property
    def triggered(self):
        self.polls += 1
        return self.polls >= self.n

    def install(self):
        return self

    def uninstall(self):
        pass


def test_preemption_handler_latches():
    h = preempt.PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not h.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.triggered
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is not h._handle
    assert not preempt.PreemptionHandler(signals=(signal.SIGUSR1,)).triggered


def test_preempted_run_resumes_bit_exact(tmp_path):
    """Preempted at step 2 of epoch 0, resumed and finished: every parameter
    and Adam's state bit-equal to an uninterrupted run's, drop-path 0.3 live
    (each step's masks seeded from (seed, epoch, global step))."""
    over = dict(max_epochs=2, n_synthetic_samples=6, drop_path_rate=0.3)
    ta = run_trainer(tmp_path / "a", run="full", **over)

    tb = Trainer(micro_yparams(tmp_path / "b", **over), MICRO, run_num="full", device="cpu")
    tb.preempt = TriggerAfter(2)
    tb.build_and_launch()
    assert tb._preempted_at == 2
    assert logs(tmp_path / "b", run="full")[-1]["preempted_at_step"] == 2

    tc = Trainer(micro_yparams(tmp_path / "b", **over), MICRO, run_num="full", device="cpu")
    tc.build()
    assert tc.start_epoch == 0 and tc.resume_step_in_epoch == 2 and tc.host_step == 2
    tc.train()
    assert tc.host_step == ta.host_step == 6
    state_equal(tc.model.state_dict(), ta.model.state_dict())
    state_equal(tc.optimizer.state_dict(), ta.optimizer.state_dict())
    assert logs(tmp_path / "b", run="full")[-1]["epoch"] == 2

    # the masks matter: another seed ends elsewhere
    td = run_trainer(tmp_path / "d", run="full", seed=334, **over)
    assert not torch.equal(td.model.model.head.weight, ta.model.model.head.weight)


# --------------------------------------------------------------------------
# seeding, devices, parallel options
# --------------------------------------------------------------------------


def test_init_and_step_seeds_are_deterministic():
    p = micro_yparams("/nonexistent")
    t = Trainer(p, MICRO, device="cpu")
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts
    from swin_v2_weather_torch.models.wrappers import get_model

    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    models = [get_model(p, device="cpu") for _ in range(3)]
    for m, seed in zip(models, (333, 333, 7)):
        init_parameters(m, torch.Generator().manual_seed(seed))
    a, b, c = (dict(m.named_parameters()) for m in models)
    for name, w in a.items():
        assert torch.equal(w, b[name]), name
        if name.endswith(("weight", "bias", "pos_embed")) and "norm" not in name:
            assert not torch.equal(w, c[name]), name
            fan_in = w.shape[-1] if w.dim() == 2 else a[name.replace("bias", "weight")].shape[1]
            if "pos_embed" not in name:
                assert w.abs().max() <= 1.0 / np.sqrt(fan_in), name
    assert a["model.blocks.0.norm1.weight"].abs().max() == 0  # init_values = 0
    assert t.device.type == "cpu"
    seeds = {step_seed(333, e, s) for e in range(3) for s in range(50)}
    assert len(seeds) == 150 and all(0 <= s < 2**63 for s in seeds)


def test_build_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback: the default device is the GPU, and without one build()
    raises unless the CPU was asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Trainer(micro_yparams(tmp_path), MICRO, run_num="t")
    assert t.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.build()
    assert not (tmp_path / MICRO).exists()


@pytest.mark.parametrize("over, env", [({"shard_params": True}, {"WORLD_SIZE": "2"}),
                                       ({"shard_opt_state": True}, {"WORLD_SIZE": "2"}),
                                       ({"spatial_shards": 2}, {}),
                                       ({}, {"WORLD_SIZE": "2"})])
def test_parallel_options_raise(tmp_path, monkeypatch, over, env):
    """Without a process group: an environment that names more processes but
    no rendezvous raises (the sharding keys with it), and spatial sharding
    raises (its bands need a model group). With one, both train
    (tests/test_torch_parallel.py)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="MASTER_ADDR" if env else "needs a mesh"):
        Trainer(micro_yparams(tmp_path, **over), MICRO, run_num="t", device="cpu").build()


def test_sharding_keys_are_no_ops_at_one_process(tmp_path):
    """shard_params and shard_opt_state at one process train as without them
    (JAX's one-device mesh shards nothing): the same parameters bit for bit."""
    over = dict(max_epochs=1, n_synthetic_samples=4)
    ta = run_trainer(tmp_path / "a", **over)
    tb = run_trainer(tmp_path / "b", shard_params=True, shard_opt_state=True, **over)
    state_equal(tb.model.state_dict(), ta.model.state_dict())


# --------------------------------------------------------------------------
# sweeps and the CLI
# --------------------------------------------------------------------------


def test_native_sweep_agent_two_grid_trials(tmp_path):
    sweep_cfg = {
        "name": "lrgrid", "method": "grid",
        "metric": {"name": "valid_loss", "goal": "minimize"},
        "parameters": {"lr": {"values": [1e-3, 3e-4]}, "max_epochs": {"value": 1}},
    }
    cfg_path = tmp_path / "sweep.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(sweep_cfg, f)
    p = micro_yparams(tmp_path)
    sweep_id = sweeps.sweep(str(cfg_path), root=p["exp_dir"])
    assert sweeps.is_local_sweep(sweep_id, p["exp_dir"])
    t = Trainer(p, MICRO, run_num="s", sweep_id=sweep_id, device="cpu")
    records = sweeps.agent(sweep_id, function=t.build_and_launch, root=p["exp_dir"])
    assert len(records) == 2
    assert sorted(r["params"]["lr"] for r in records) == [3e-4, 1e-3]
    assert all(r["metric"] == "valid_loss" and np.isfinite(r["best"]) for r in records)
    assert all(r["n_reports"] == 1 for r in records)
    for i, rec in enumerate(records):
        exp = tmp_path / "sweeps" / sweep_id / MICRO / f"s-trial{i:03d}"
        with open(exp / "hyperparams.yaml") as f:
            assert float(yaml.safe_load(f)["lr"]) == pytest.approx(rec["params"]["lr"])
        assert len(logs(tmp_path / "sweeps" / sweep_id, run=f"s-trial{i:03d}")) == 1
    with open(tmp_path / "sweeps" / sweep_id / "trials.jsonl") as f:
        assert [json.loads(line) for line in f] == records
    assert sweeps.best_trial(records)["best"] == min(r["best"] for r in records)
    cfg = {"method": "random", "parameters": {"lr": {"min": 1e-5, "max": 1e-2}}}
    assert list(sweeps._trial_param_sets(cfg, 4, seed=7)) == list(
        sweeps._trial_param_sets(cfg, 4, seed=7))


def cli(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "swin_v2_weather_torch.train", "--config", MICRO,
         "--set", f"exp_dir={tmp_path}", "--set", "n_synthetic_samples=4",
         "--set", "max_epochs=1", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    proc = cli(tmp_path, "--device", "cpu", "--run_num", "c")
    assert proc.returncode == 0, proc.stderr
    (line,) = logs(tmp_path, run="c")
    assert np.isfinite(line["loss"]) and line["epoch"] == 1


def test_cli_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    proc = cli(tmp_path, "--run_num", "g")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / MICRO / "g" / "logs.jsonl").exists()


# --------------------------------------------------------------------------
# the utilities the Trainer logs through
# --------------------------------------------------------------------------


def test_metrics_sink_and_step_timer(tmp_path):
    sink = metrics_sink.MetricsSink(str(tmp_path), use_wandb=True)  # wandb absent: file only
    sink.log({"loss": torch.tensor(1.5), "name": "x"}, step=3)
    sink.close()
    with open(tmp_path / "logs.jsonl") as f:
        assert json.loads(f.read()) == {"loss": 1.5, "name": "x", "epoch": 3}
    metrics_sink.MetricsSink(str(tmp_path / "off"), enabled=False).log({"a": 1})
    assert not (tmp_path / "off").exists()
    timer = profiling.StepTimer()
    for _ in range(4):
        timer.tick()
    out = timer.reset()
    assert set(out) == {"step_time_mean", "step_time_p50", "step_time_max"}
    assert timer.reset() == {}


def test_step_profiler_writes_a_trace_for_its_window(tmp_path):
    p = micro_yparams(tmp_path, profile_num_steps=2, profile_start_step=1)
    prof = profiling.StepProfiler(p, str(tmp_path))
    for step in range(5):
        prof.step(step)
        torch.ones(8).sum()
    prof.close()
    traces = os.listdir(tmp_path / "traces")
    assert traces == ["trace_steps1.json"]
    with open(tmp_path / "traces" / traces[0]) as f:
        assert "traceEvents" in json.load(f)
    assert not profiling.StepProfiler(micro_yparams(tmp_path), str(tmp_path)).enabled


def test_img_utils_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 16))
    for scale in (0.5, 2.0):
        np.testing.assert_array_equal(img_utils.interpolate(x, scale),
                                      jax_img_utils.interpolate(x, scale))
    fig = img_utils.vis((x[0], x[1]))
    assert len(fig.axes) == 2
    import matplotlib.pyplot as plt

    plt.close(fig)
