"""PyTorch port, the parallel layer (``parallel/mesh.py``, ``shard_state`` and
the train steps on a mesh, the Trainer past one process), held to the JAX
package on the CPU.

The mesh helpers are pure functions of the ranks' list and compare with
JAX's ``make_mesh`` / ``hybrid_device_order`` / ``batch_sharding`` on its 8
virtual devices (tests/test_parallel.py's cases). Everything that needs a
process group runs on gloo ranks spawned by ``tests/torch_dist_worker.py``
(torch and the port only).

The train steps on a mesh (DDP, ZeRO-1, FSDP2, latitude bands, each with
Adam, some with LAMB) are held to the single-process step on the global
batch with the same weights and drop-path draws (the masks are drawn for
the global batch on every rank), at ``loss_scale = 1 / n_data_shards`` on
both sides (the logged loss is the global-batch sum / n_data_shards, so runs
compare only at equal shard counts), in fp32 compute: the ranks sum the same
terms in another order, so the loss and the gradient norms agree to 1e-6 /
1e-5 relative and each gradient to 1e-5 of its largest entry (measured: 1.3e-7,
4.6e-6 and 7.4e-7); after two Adam steps the parameters agree to 2e-5
(Adam divides near-zero gradients by their own size, so an ulp of one moves
its parameter by up to a fraction of the 1e-3 learning rate; measured 1.2e-5
on the qkv-fused route, 6e-8 on the others). The DP 2 x SP 2 step is also
held to JAX's step on its [2, 2] mesh on JAX's weights (drop-path 0: the two
frameworks' masks differ), and ZeRO-1 and FSDP2, with Adam and LAMB, on 2
and 4 data shards to JAX's step with the same ``state_shardings`` switches
on its [dp, 1] mesh for 2 steps, at the single-process trajectory tests'
fp32 bounds (measured: loss 3.1e-7 and gradient norms 4.6e-7 relative,
parameters at most 0.088 lr apart, none by lr / 2). The checkpoints
restore across rank counts bit for bit.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.data import synthetic as jax_synthetic
from swin_v2_weather_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from swin_v2_weather_tpu.models.wrappers import get_model as jax_get_model
from swin_v2_weather_tpu.ops.losses import LossHandler as JaxLossHandler
from swin_v2_weather_tpu.parallel import mesh as jax_mesh
from swin_v2_weather_tpu.training import optim as jax_optim
from swin_v2_weather_tpu.training import step as jax_step
from swin_v2_weather_torch.config.yparams import YParams, default_config_path
from swin_v2_weather_torch.models.convert import params_from_jax
from swin_v2_weather_torch.parallel import mesh
from swin_v2_weather_torch.training import checkpoint as ckpt
from swin_v2_weather_torch.training.trainer import Trainer
from test_torch_model import micro_configs, noise_params
from torch_dist_worker import MICRO, launch

torch.set_num_threads(1)


class P(dict):
    __getattr__ = dict.get


class FakeDev:
    """tests/test_parallel.py's stub of a multi-slice TPU device."""

    def __init__(self, i, slice_index=None):
        self.id = i
        if slice_index is not None:
            self.slice_index = slice_index


def ranks_of(fake):
    """The port's ranks for JAX's fake devices: the slice is the host."""
    return [mesh.RankInfo(d.id, getattr(d, "slice_index", None)) for d in fake]


# --------------------------------------------------------------------------
# the mesh, its order and the batch layout, against JAX (no process group)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape, n", [("auto", 8), ([4, 2], 8), ("auto", 4), ([2, 2], 4),
                                      ([1, 8], 8)])
def test_mesh_layout_matches_jax(shape, n):
    """make_mesh's layout: 'auto' puts every rank on data, [dp, mp] a 2-D
    layout, over all or a subset of the ranks, as JAX's mesh orders devices."""
    want = jax_mesh.make_mesh(P(mesh_shape=shape), devices=jax.devices()[:n])
    got = mesh.mesh_layout(P(mesh_shape=shape), [mesh.RankInfo(r) for r in range(n)])
    assert got.shape == (want.shape["data"], want.shape["model"])
    np.testing.assert_array_equal([[d.rank for d in row] for row in got],
                                  [[d.id for d in row] for row in want.devices])


def test_bad_mesh_shape_raises_as_jax():
    with pytest.raises(ValueError, match="does not cover"):
        jax_mesh.make_mesh(P(mesh_shape=[3, 2]), devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="does not cover"):
        mesh.mesh_layout(P(mesh_shape=[3, 2]), [mesh.RankInfo(r) for r in range(8)])


@pytest.mark.parametrize("hosts", [None, "interleaved", "blocked"])
def test_hybrid_order_matches_jax(hosts):
    """Host-major order (the TPU's slice-major): the identity on one host,
    the hosts grouped with the order inside each kept."""
    slices = {None: [None] * 8, "interleaved": [i % 2 for i in range(8)],
              "blocked": [i // 4 for i in range(8)]}[hosts]
    fake = [FakeDev(i, s) for i, s in enumerate(slices)]
    want = [d.id for d in jax_mesh.hybrid_device_order(fake)]
    assert [d.rank for d in mesh.hybrid_device_order(ranks_of(fake))] == want
    if hosts == "interleaved":
        assert want == [0, 2, 4, 6, 1, 3, 5, 7]


def test_ragged_hosts_and_straddling_model_axis_raise_as_jax():
    ragged = [FakeDev(i, 0 if i < 5 else 1) for i in range(8)]
    with pytest.raises(ValueError, match="ragged"):
        jax_mesh.hybrid_device_order(ragged)
    with pytest.raises(ValueError, match="ragged"):
        mesh.hybrid_device_order(ranks_of(ragged))
    two = [FakeDev(i, i // 4) for i in range(8)]
    with pytest.raises(ValueError, match="straddle"):
        jax_mesh.make_mesh(P(mesh_shape=[1, 8]), devices=two)
    with pytest.raises(ValueError, match="straddle"):
        mesh.mesh_layout(P(mesh_shape=[1, 8]), ranks_of(two))


@pytest.mark.parametrize("shape, spatial", [("auto", False), ([4, 2], False), ([4, 2], True),
                                            ([2, 4], True)])
def test_batch_shard_matches_jax_batch_sharding(shape, spatial):
    """Each rank's batch_shard of a global NCHW batch is the shard JAX's
    batch_sharding puts on the device at the same mesh position."""
    jm = jax_mesh.make_mesh(P(mesh_shape=shape), devices=jax.devices()[:8])
    x = np.arange(8 * 2 * 16 * 3, dtype=np.float32).reshape(8, 2, 16, 3)
    placed = jax.device_put(jnp.asarray(x), jax_mesh.batch_sharding(jm, spatial=spatial))
    pos = {d.id: (i, j) for (i, j), d in np.ndenumerate(jm.devices)}
    dp, mp = jm.shape["data"], jm.shape["model"]
    for shard in placed.addressable_shards:
        i, j = pos[shard.device.id]
        got = mesh.batch_shard(torch.from_numpy(x), mesh.MeshCoords(dp, mp, i, j), spatial)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_init_distributed_single_process_noop(monkeypatch):
    """Without a multi-process environment nothing starts: (0, 1), as JAX's."""
    for k in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "NPROCS", "RANK", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert jax_mesh.init_distributed() == (0, 1)
    assert mesh.init_distributed(device="cpu") == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert mesh.broadcast_config({"a": 1}) == {"a": 1}


@pytest.mark.parametrize("env, device, want", [
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1"}, "cpu", ("gloo", "env://", 2, 4, None)),
    ({"NPROCS": "2", "PROCESS_ID": "1", "COORDINATOR_ADDRESS": "h0:1234"}, "cpu",
     ("gloo", "tcp://h0:1234", 1, 2, None)),
    ({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1"}, "cuda", ("nccl", "env://", 5, 8, "cuda:1")),
])
def test_init_distributed_reads_the_launchers_environment(monkeypatch, env, device, want):
    """torchrun's names and JAX's: the rank, the world, the rendezvous, NCCL
    on a CUDA rank (which selects cuda:LOCAL_RANK first), gloo on the CPU."""
    for k in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "NPROCS", "RANK", "PROCESS_ID",
              "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls, devices = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: devices.append(str(d)))
    assert mesh.init_distributed(device=device) == (want[2], want[3])
    (backend, kw), = calls
    assert (backend, kw["init_method"], kw["rank"], kw["world_size"]) == want[:4]
    assert devices == ([] if want[4] is None else [want[4]])
    assert str(mesh.rank_device(device)) == (want[4] or device)


# --------------------------------------------------------------------------
# on a process group
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    return launch("mesh", 4, tmp_path_factory.mktemp("mesh"), timeout=90,
                  shapes=["auto", [2, 2], [1, 4]])


def test_make_mesh_on_a_group(meshes):
    """make_mesh over 4 gloo ranks: a DeviceMesh ('data', 'model') of the
    layout JAX's make_mesh gives 4 devices; each rank's coordinates; the
    chief's config on every rank."""
    for i, shape in enumerate(["auto", [2, 2], [1, 4]]):
        want = mesh.mesh_layout(P(mesh_shape=shape), [mesh.RankInfo(r) for r in range(4)])
        for r, res in enumerate(meshes):
            np.testing.assert_array_equal(res[f"mesh{i}"], [[d.rank for d in row]
                                                            for row in want])
            assert list(res[f"names{i}"]) == ["data", "model"]
            dp, mp = want.shape
            np.testing.assert_array_equal(res[f"coords{i}"], [dp, mp, r // mp, r % mp])
    assert {str(res["config"]) for res in meshes} == {'{"lr": 0.5, "name": "trial-3"}'}


FP32 = {"batch_size": 4, "compute_dtype": "float32"}
TWO_RANKS = {
    "dp2_adam": {},
    "dp2_lamb": {"optimizer_type": "lamb"},
    "zero1_adam": {"shard_opt_state": True},
    "zero1_lamb": {"shard_opt_state": True, "optimizer_type": "lamb"},
    "fsdp2_adam": {"shard_params": True},
    "fsdp2_lamb": {"shard_params": True, "optimizer_type": "lamb"},
    "sp2": {"spatial_shards": 2, "mesh_shape": [1, 2]},
    "sp2_fsdp2": {"spatial_shards": 2, "mesh_shape": [1, 2], "shard_params": True},
}
FOUR_RANKS = {
    "dp2xsp2": {"spatial_shards": 2, "mesh_shape": [2, 2]},
    "dp2xsp2_zero1_lamb": {"spatial_shards": 2, "mesh_shape": [2, 2], "shard_opt_state": True,
                           "optimizer_type": "lamb"},
    "dp2xsp2_fsdp2": {"spatial_shards": 2, "mesh_shape": [2, 2], "shard_params": True},
    "dp2xsp2_remat_mlp3": {"spatial_shards": 2, "mesh_shape": [2, 2],
                           "activation_ckpt": True, "remat_policy": "mlp3"},
    "dp2xsp2_pallas_qkv": {"spatial_shards": 2, "mesh_shape": [2, 2],
                           "attn_impl": "pallas_qkv"},
    "dp2_on_2x2_mesh": {"mesh_shape": [2, 2]},
    "dp4_fsdp2_lamb": {"shard_params": True, "optimizer_type": "lamb"},
}


# JAX's side of the comparisons with JAX: drop-path 0 (the two frameworks'
# masks differ), fp32, the xla route, unrolled blocks, noise weights
JAX_OVER = dict(drop_path_rate=0.0, compute_dtype="float32", batch_size=4, attn_impl="xla",
                scan_blocks=False)
# the data-parallel layouts held to JAX's step with the same switches of
# state_shardings on its [dp, 1] mesh: {variant: (dp, switches)}
JAX_SHARDED = {
    "zero1_adam_jax": (2, {"shard_opt_state": True}),
    "zero1_lamb_jax": (2, {"shard_opt_state": True, "optimizer_type": "lamb"}),
    "fsdp2_adam_jax": (2, {"shard_params": True}),
    "fsdp2_lamb_jax": (2, {"shard_params": True, "optimizer_type": "lamb"}),
    "dp4_zero1_adam_jax": (4, {"shard_opt_state": True}),
    "dp4_fsdp2_lamb_jax": (4, {"shard_params": True, "optimizer_type": "lamb"}),
}


def jax_noise_weights(tmp):
    """JAX's micro model's noise weights (JAX_OVER) and the .npz of them, under
    the port's names, that the ranks load."""
    jp, _ = micro_configs("float32", **{k: v for k, v in JAX_OVER.items()
                                        if k != "compute_dtype"})
    init_model = jax_get_model(jp)
    x = jnp.zeros((1, int(jp["n_in_channels"]), *jp.img_size), jnp.float32)
    tree = noise_params(jax.eval_shape(init_model.init, jax.random.key(0), x)["params"],
                        np.random.default_rng(3))
    path = tmp / "jax_weights.npz"
    np.savez(path, **{k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, tree)).items()})
    return tree, str(path)


def jax_steps_on_mesh(tree, dp, mp, steps, **over):
    """``steps`` of JAX's train step on its [dp, mp] mesh (spatial_shards mp)
    from ``tree``, the state laid out by ``state_shardings`` with the
    config's ``shard_opt_state`` / ``shard_params``: the metrics of each step,
    the parameters after the last and before the first (under the port's
    names), and the learning rate."""
    jp, _ = micro_configs("float32", **{k: v for k, v in dict(JAX_OVER, **over).items()
                                        if k != "compute_dtype"})
    jp["img_shape_x"], jp["img_shape_y"] = jp.img_size
    jp["data_loader_config"] = "synthetic"
    jp["spatial_shards"] = mp
    model = jax_get_model(jp)
    m = jax_mesh.make_mesh(devices=jax.devices()[:dp * mp], data_parallel=dp,
                           model_parallel=mp)
    samples = [jax_synthetic.SyntheticDataset(jp)[i] for i in range(int(jp.batch_size))]
    batch = {k: jax.device_put(np.stack([s[i] for s in samples]),
                               jax_mesh.batch_sharding(m, spatial=mp > 1))
             for i, k in enumerate(("inp", "tar", "zen_inp", "zen_tar"))}
    opt = jax_optim.build_optimizer(jp)
    create = lambda p: jax_step.TrainState.create(p, opt)  # noqa: E731
    ssh = jax_step.state_shardings(
        jax.eval_shape(create, tree), m, shard_opt_state=bool(over.get("shard_opt_state")),
        shard_params=bool(over.get("shard_params")))
    state = jax.jit(create, out_shardings=ssh)(jax.tree.map(jnp.asarray, tree))
    step = jax_step.build_train_step(model, JaxLossHandler(jp), JaxPreprocessor(jp), opt, m,
                                     state_shardings=ssh)
    metrics = []
    for _ in range(steps):
        state, mt = step(state, batch, jax.random.key(0))
        metrics.append({k: float(v) for k, v in mt.items()})
    final, start = ({k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, t)).items()} for t in (state.params, tree))
    return metrics, final, start, float(jp.lr)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Every variant's per-rank results: 2 steps on the mesh and on one
    process, and the checkpoints both ways; JAX's steps on its meshes from
    the weights the ``*_jax`` variants load."""
    tmp = tmp_path_factory.mktemp("train")
    tree, weights = jax_noise_weights(tmp)
    jax_runs = {"dp2xsp2_jax_weights": jax_steps_on_mesh(tree, 2, 2, 1)}
    for name, (dp, switches) in JAX_SHARDED.items():
        jax_runs[name] = jax_steps_on_mesh(tree, dp, 1, 2, **switches)
    two = [dict(name=k, over=v) for k, v in TWO_RANKS.items()]
    four = [dict(name=k, over=v) for k, v in FOUR_RANKS.items()]
    four.append(dict(name="dp2xsp2_jax_weights", weights=weights,
                     over={"spatial_shards": 2, "mesh_shape": [2, 2], **JAX_OVER}))
    for name, (dp, switches) in JAX_SHARDED.items():
        (two if dp == 2 else four).append(dict(name=name, weights=weights,
                                               over=dict(JAX_OVER, **switches)))
    out = {}
    for name, world, variants in (("two", 2, two), ("four", 4, four)):
        ranks = launch("train", world, tmp, timeout=240, name=name, steps=2, common=FP32,
                       variants=variants)
        out.update(ranks[0])  # rank 0's results, and every rank's metrics
        for r, res in enumerate(ranks):
            out.update({f"{k}@rank{r}": v for k, v in res.items() if k.endswith("/metrics")})
    return out, jax_runs


def rank_metrics(res, variant):
    """Every rank's metrics of ``variant`` (a row a step), for failure messages."""
    names = list(res[f"{variant}/metric_names"])
    return {k.split("@")[1]: [dict(zip(names, row)) for row in v] for k, v in res.items()
            if k.startswith(f"{variant}/metrics@")}


@pytest.mark.parametrize("variant", list(TWO_RANKS) + list(FOUR_RANKS))
def test_parallel_step_matches_single_process(trained, variant):
    """Two steps of the variant's layout on its rank's shard against the
    single-process step on the global batch (module docstring's bounds)."""
    res, _ = trained
    names = list(res[f"{variant}/metric_names"])
    got, want = res[f"{variant}/metrics"], res[f"{variant}/ref_metrics"]
    rel = np.abs(got - want) / np.abs(want)
    assert rel[:, names.index("loss")].max() <= 1e-6, rel
    assert rel.max() <= 1e-5, dict(zip(names, rel.max(0)))
    grads = [k.split("/grad/")[1] for k in res if k.startswith(f"{variant}/grad/")]
    assert grads
    for n in grads:
        g, r = res[f"{variant}/grad/{n}"], res[f"{variant}/ref_grad/{n}"]
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), n
        np.testing.assert_allclose(res[f"{variant}/param/{n}"], res[f"{variant}/ref_param/{n}"],
                                   atol=2e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("variant", list(TWO_RANKS) + list(FOUR_RANKS))
def test_parallel_eval_step_reports_the_global_batch(trained, variant):
    """The eval step on the mesh returns the global batch's loss (times 1 /
    n_data_shards), per-channel RMSE and ACC (means over the global batch's
    samples), as the single-process eval step on the whole batch does, after
    the two steps (parameters within 2e-5: the module docstring's bound, so
    the loss and RMSE within 1e-4 relative, the ACC, a correlation near 0
    here, within 1e-5 absolute)."""
    res, _ = trained
    for k, tol in (("loss", dict(rtol=1e-4)), ("rmse", dict(rtol=1e-4)),
                   ("acc", dict(rtol=0, atol=1e-5))):
        np.testing.assert_allclose(res[f"{variant}/eval/{k}"], res[f"{variant}/ref_eval/{k}"],
                                   err_msg=k, **tol)


@pytest.mark.parametrize("variant", list(TWO_RANKS) + list(FOUR_RANKS))
def test_checkpoint_restores_across_rank_counts(trained, variant):
    """The mesh's state saved (FSDP2 gathered, ZeRO-1 consolidated; the chief
    writes the port's one format) restores into one process bit for bit,
    moments too; the single-process state restores into the mesh's layout
    bit for bit."""
    res, _ = trained
    assert int(res[f"{variant}/n_to_1_equal"]) == 1, (
        "first tensor not restored bit for bit: " + str(res[f"{variant}/n_to_1_first_diff"]))
    assert int(res[f"{variant}/n_to_1_moments"]) == len(
        [k for k in res if k.startswith(f"{variant}/param/")])
    assert int(res[f"{variant}/1_to_n_equal"]) == 1, (
        "first tensor not restored bit for bit: " + str(res[f"{variant}/1_to_n_first_diff"]))


def test_dp2xsp2_step_matches_jax(trained):
    """The DP 2 x SP 2 step on JAX's weights: the loss and every gradient norm
    against JAX's step on its [2, 2] mesh (fp32; the same bounds as the
    single-process trajectory tests, tests/test_torch_training.py)."""
    res, jax_runs = trained
    jax_metrics = jax_runs["dp2xsp2_jax_weights"][0][0]
    names = list(res["dp2xsp2_jax_weights/metric_names"])
    got = dict(zip(names, res["dp2xsp2_jax_weights/metrics"][0]))
    assert set(got) == set(jax_metrics)
    for k, v in jax_metrics.items():
        assert abs(got[k] - v) <= (1e-3 if k == "loss" else 2e-3) * abs(v), (
            k, got[k], v, jax_metrics, rank_metrics(res, "dp2xsp2_jax_weights"))


# the single-process trajectory tests' fp32 bounds (tests/test_torch_training.py
# STEP_RTOL and PARAM_TOL): the metrics of each step relative, the parameters
# after the steps in units of lr (max per leaf, mean per leaf, share of all
# entries off by more than lr / 2)
JAX_STEP_RTOL = (1e-3, 2e-3)
JAX_PARAM_TOL = (3.0, 0.02, 1e-3)


@pytest.mark.parametrize("variant", list(JAX_SHARDED))
def test_sharded_step_matches_jax(trained, variant):
    """ZeRO-1 and FSDP2, with Adam and with LAMB, on 2 and 4 data shards, from
    JAX's weights: the loss and every gradient norm of both steps against
    JAX's step with the same ``state_shardings`` switches on its [dp, 1]
    mesh, and every parameter after the 2 steps (JAX_STEP_RTOL,
    JAX_PARAM_TOL)."""
    res, jax_runs = trained
    jax_metrics, jax_params, start, lr = jax_runs[variant]
    names = list(res[f"{variant}/metric_names"])
    for i, want in enumerate(jax_metrics):
        got = dict(zip(names, res[f"{variant}/metrics"][i]))
        assert set(got) == set(want)
        for k, v in want.items():
            rtol = JAX_STEP_RTOL[0] if k == "loss" else JAX_STEP_RTOL[1]
            assert abs(got[k] - v) <= rtol * abs(v), (i, k, got[k], v, jax_metrics,
                                                      rank_metrics(res, variant))
    max_tol, mean_tol, share_tol = JAX_PARAM_TOL
    n_flipped = n_total = 0
    for n, want in jax_params.items():
        assert np.abs(want - start[n]).max() > 0, n  # the steps moved it
        diff = np.abs(res[f"{variant}/param/{n}"] - want) / lr
        assert diff.max() <= max_tol and diff.mean() <= mean_tol, (n, diff.max(), diff.mean())
        n_flipped += int(np.count_nonzero(diff > 0.5))
        n_total += diff.size
    assert n_flipped <= share_tol * n_total, (n_flipped, n_total)


# --------------------------------------------------------------------------
# the Trainer past one process
# --------------------------------------------------------------------------


TRAINER = {"max_epochs": 2, "n_synthetic_samples": 8, "batch_size": 2, "num_data_workers": 2,
           "log_to_screen": True}
TRAINER_RUNS = {"zero1_dp2": {"mesh_shape": [2, 1], "shard_opt_state": True},
                "sp2": {"mesh_shape": [1, 2], "spatial_shards": 2}}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    ranks = launch("trainer", 2, tmp, timeout=240, preempt_at=2,
                   runs={k: dict(TRAINER, **v) for k, v in TRAINER_RUNS.items()})
    return tmp, ranks


@pytest.mark.parametrize("run", list(TRAINER_RUNS))
def test_two_rank_preempted_run_resumes_bit_equal(trainer_runs, run):
    """Two ranks, one of them signalled at step 2 of epoch 0: both stop there
    (the MAX agreement), the resumed run starts at that step, and its final
    parameters equal the uninterrupted run's bit for bit, on both ranks."""
    _, ranks = trainer_runs
    for r in ranks:
        assert int(r[f"{run}/a_stopped_at"]) == -1 and int(r[f"{run}/b_stopped_at"]) == 2
        np.testing.assert_array_equal(r[f"{run}/b2_start"], [0, 2])
        names = [k.split("/a/")[1] for k in r if k.startswith(f"{run}/a/")]
        assert names
        for n in names:
            np.testing.assert_array_equal(r[f"{run}/b/{n}"], r[f"{run}/a/{n}"], err_msg=n)
            np.testing.assert_array_equal(r[f"{run}/a/{n}"], ranks[0][f"{run}/a/{n}"])
    dp = 2 if run == "zero1_dp2" else 1
    assert [tuple(r[f"{run}/local_batch"]) for r in ranks] == [
        (2 // dp, dp, i if dp == 2 else 0) for i in range(2)]


def test_two_rank_checkpoint_restores_at_one_rank(trainer_runs, tmp_path):
    """The ZeRO-1 run's checkpoint (written by the chief from the
    consolidated state) resumes in one process: the weights are the 2-rank
    run's final ones, and training goes on (a third epoch)."""
    tmp, ranks = trainer_runs
    src = os.path.join(str(tmp), "trainer", "zero1_dp2", "a")
    shutil.copytree(src, tmp_path / "a")
    p = YParams(default_config_path(), MICRO)
    for k, v in dict(TRAINER, exp_dir=str(tmp_path / "a"), shard_opt_state=True,
                     max_epochs=3).items():
        p[k] = v
    t = Trainer(p, MICRO, run_num="t", device="cpu")
    t.build()
    assert t.start_epoch == 2 and t.mesh is None
    for n, q in t.model.named_parameters():
        np.testing.assert_array_equal(q.detach().numpy(), ranks[0][f"zero1_dp2/a/{n}"])
    t.train()
    assert ckpt.latest_checkpoint_exists(p["checkpoint_path"])


def test_dryrun_multichip_twin(capsys):
    """The port's twin of JAX's dryrun_multichip on 4 gloo processes: the DP
    step on the [2, 2] mesh, the spatially sharded ZeRO-1 step, the FSDP2
    step, each loss finite, the FSDP parameters sharded."""
    from swin_v2_weather_torch.scripts.dryrun_multichip import dryrun_multichip

    dryrun_multichip(4, timeout=180)
    out = capsys.readouterr().out
    for what in ("one train step OK on the [2, 2] mesh", "spatial-sharded train step OK",
                 "FSDP train step OK"):
        assert what in out, out


def test_parallel_check_rehearses_on_the_cpu(tmp_path):
    """The card's phase 43 rank program (scripts/parallel_check.py) on two
    gloo ranks on the CPU at the micro config: the DDP and spatial
    variants' step 1 against the single-process step on the global batch
    (the micro config computes in bf16: chip_smoke.py's SPATIAL_TOL), K1/K2's
    flags untouched (the micro config takes the xla route), the halo bytes
    a step and their timed exchanges, and the Trainer variant's epoch."""
    import json
    import sys

    from swin_v2_weather_torch.parallel.launch import run_ranks

    run_ranks([sys.executable, "-m", "swin_v2_weather_torch.scripts.parallel_check",
               "--backend", "gloo", "--device", "cpu", "--config", MICRO, "--variants",
               "ddp,spatial,trainer", "--steps", "2", "--timeout", "120", "--rendezvous",
               str(tmp_path / "rdv"), "--out", str(tmp_path / "out")],
              2, str(tmp_path), 150, env={"OMP_NUM_THREADS": "1"}, what="parallel_check")
    for r in range(2):
        with open(tmp_path / "out" / f"rank{r}.json") as f:
            res = json.load(f)["variants"]
        ddp, sp, tr = res["ddp"], res["spatial"], res["trainer"]
        assert ddp["mesh"] == [2, 1] and sp["mesh"] == [1, 2] and tr["mesh"] == [2, 1]
        for v in (ddp, sp):  # the reference: the global batch at loss_scale 1 / data shards
            assert abs(v["loss"] - v["loss_ref"]) <= 1e-4 * abs(v["loss_ref"])
            assert v["worst_grad_rel"] <= 2e-2
        assert sp["flags"] == {}
        # 2 shifted-block rolls in the micro model (1 row of [2, ., 24, 64] bf16), each
        # exchanged in the forward and in the backward: 4 a step
        assert sp["halo_bytes_per_step"] == 4 * 1 * 24 * 64 * 2
        assert sp["halo_exchange_ms_per_step"] > 0 and ddp["halo_exchange_ms_per_step"] == 0
        assert tr["checkpoint"] and len(tr["logs"]) == 1 and np.isfinite(tr["logs"][0]["loss"])
