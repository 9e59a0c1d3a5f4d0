"""Spawned gloo ranks for the PyTorch port's multi-process CPU tests.

Each rank is a fresh interpreter that imports torch and the port only (never
JAX): the test process writes the inputs (and JAX's weights, converted) to
``.npz`` files, :func:`launch` starts ``world`` ranks of this script, and each
rank starts its process group through the port's ``init_distributed`` (the
torchrun variables ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and a
``file://`` rendezvous in the test's temporary directory, no port), runs one
job of :data:`JOBS` and writes its results to ``rank<r>.npz``. Every group has
a timeout: a hung rank fails its test, not the suite.

    python tests/torch_dist_worker.py SPEC.json    (one rank; launch() sets the env)
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch

from swin_v2_weather_torch.parallel.launch import run_ranks
from swin_v2_weather_torch.training.checkpoint import full_state

MICRO = "swin_micro_test"


def launch(job: str, world: int, workdir, timeout: float = 120.0, name: str = None,
           **spec) -> list:
    """Run ``job`` on ``world`` gloo ranks (in ``workdir/name``, ``name``
    defaulting to the job's); return each rank's results (a dict of numpy
    arrays). Raises with the ranks' output if one fails or the group
    outlives ``timeout`` seconds (then every rank is killed)."""
    workdir = os.path.join(str(workdir), name or job)
    os.makedirs(workdir, exist_ok=True)
    spec = dict(spec, job=job, workdir=workdir, timeout=timeout,
                init=os.path.join(workdir, "rendezvous"))
    if os.path.exists(spec["init"]):  # a FileStore left by an earlier group
        os.remove(spec["init"])
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    run_ranks([sys.executable, os.path.abspath(__file__), spec_path], world, workdir, timeout,
              env={"OMP_NUM_THREADS": "1"}, what=job)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"), allow_pickle=False))
            for r in range(world)]


# --------------------------------------------------------------------------
# jobs (run on every rank; return {name: array})
# --------------------------------------------------------------------------


def _world():
    import torch.distributed as dist

    return dist.group.WORLD


def _gather_h(x: torch.Tensor, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=dim)


def job_roll(spec, rank):
    """roll_h_sharded on bands of x [2, 12, 6, 4]: the gathered output and the
    gathered input gradient of sum(out * w) for each shift; the oversized
    halo's error."""
    import torch.distributed as dist

    from swin_v2_weather_torch.parallel.spatial import roll_h_sharded

    n = dist.get_world_size()
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 12, 6, 4), generator=gen)
    w = torch.randn((2, 12, 6, 4), generator=gen)
    rows = slice(rank * 12 // n, (rank + 1) * 12 // n)
    out = {"x": x.numpy(), "w": w.numpy()}
    for shift in spec["shifts"]:
        band = x[:, rows].clone().requires_grad_(True)
        y = roll_h_sharded(band, shift, _world())
        (y * w[:, rows]).sum().backward()
        out[f"out{shift}"] = _gather_h(y.detach(), 1).numpy()
        out[f"grad{shift}"] = _gather_h(band.grad, 1).numpy()
    try:
        roll_h_sharded(torch.zeros((1, 4 // n, 4, 2)), 3, _world())
        out["oversized_raised"] = np.asarray(0)
    except ValueError:
        out["oversized_raised"] = np.asarray(1)
    return out


def job_spatial_forward(spec, rank):
    """The spatially sharded model (the JAX test's CFG, fp32) on each route,
    for each inputs file (x and the weights): the gathered output
    (``spatial_forward``) and, with ``grads``, the parameter gradients of
    sum(y^2) summed over the ranks."""
    import torch.distributed as dist

    from swin_v2_weather_torch.models.swin import SwinTransformerV2
    from swin_v2_weather_torch.parallel.spatial import spatial_forward

    n = dist.get_world_size()
    out = {}
    for tag, path in spec["inputs"].items():
        data = np.load(path)
        x = torch.from_numpy(data["x"])
        state = {k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("w/")}
        for impl in spec["attn_impls"]:
            model = SwinTransformerV2(**spec["cfg"], dtype=torch.float32, attn_impl=impl,
                                      spatial_shards=n)
            model.load_state_dict(state)
            model.spatial_group = _world()
            y = spatial_forward(model, x, _world())
            out[f"{tag}/y/{impl}"] = y.detach().numpy()
            if spec.get("grads"):
                (y ** 2).sum().backward()
                for name, p in model.named_parameters():
                    dist.all_reduce(p.grad)
                    out[f"{tag}/g/{impl}/{name}"] = p.grad.numpy()
    return out


def _micro_params(**over):
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import derived_channel_counts

    p = YParams(default_config_path(), MICRO)
    for k, v in over.items():
        p[k] = v
    p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
    p["img_shape_x"], p["img_shape_y"] = p.img_size
    p["data_loader_config"] = "synthetic"
    return p


def _seeded(model, seed: int) -> None:
    """Every parameter from seeded noise (LayerNorm scales 1 + 0.1 N), so no
    block is the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1 and not name.endswith(("bias", "logit_scale")):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))


def _run_steps(model, params, batch, n_steps: int, layout=None, optimizer=None,
               loss_scale=None):
    """n_steps train steps (drop-path generator seeded 11): per-step metrics,
    the full gradients after step 1, the full parameters after the last."""
    from swin_v2_weather_torch.data.preprocess import Preprocessor
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_train_step

    optimizer = optimizer or build_optimizer(params, model.parameters())
    step = build_train_step(model, LossHandler(params), Preprocessor(params), optimizer,
                            loss_scale=loss_scale, generator=torch.Generator().manual_seed(11),
                            layout=layout)
    metrics, grads = [], None
    for i in range(n_steps):
        m = step(batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: full_state(p.grad).clone() for n, p in model.named_parameters()}
    params_out = {n: full_state(p.detach()).clone() for n, p in model.named_parameters()}
    return metrics, grads, params_out, optimizer


def _first_diff(got: dict, want: dict) -> str:
    """The name of the first tensor of ``want`` that ``got`` does not hold bit
    for bit ("" where all are equal): the failure message's pointer."""
    return next((n for n in want if n not in got or not torch.equal(got[n], want[n])), "")


def _moments(state: dict) -> dict:
    """{"optimizer/<param index>/<name>": tensor} of ``_optimizer_full``'s dict."""
    return {f"optimizer/{i}/{k}": v for i in state for k, v in state[i].items()}


def _optimizer_full(optimizer) -> dict:
    """{param index: {name: whole tensor}} of the optimizer's state (gathered)."""
    sd = full_state(optimizer.state_dict())
    return {i: {k: v for k, v in st.items() if k != "step"} for i, st in sd["state"].items()}


def job_train(spec, rank):
    """For each variant: n steps of the parallel layout (shard_state) on this
    rank's shard of a global batch against the single-process step on the
    whole batch, from the same weights and drop-path seed; then the
    checkpoint both ways: the parallel state saved and restored into one
    process, and the single-process state restored into the parallel one."""
    import torch.distributed as dist

    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.parallel.mesh import batch_shard, make_mesh
    from swin_v2_weather_torch.training import checkpoint as ckpt
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import shard_state

    out = {}
    for var in spec["variants"]:
        tag, over = var["name"], dict(spec.get("common", {}), **var["over"])
        single = _micro_params(**{k: v for k, v in over.items()
                                  if k not in ("spatial_shards", "mesh_shape", "shard_params",
                                               "shard_opt_state")})
        par = _micro_params(**over)
        n_batch = int(par.batch_size)
        batch = collate([SyntheticDataset(par)[i] for i in range(n_batch)], device="cpu")

        mesh = make_mesh(par)
        ref_model = get_model(single, device="cpu")
        if var.get("weights"):  # JAX's weights, converted by the test
            data = np.load(var["weights"])
            ref_model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
        else:
            _seeded(ref_model, 5)
        init = {k: v.clone() for k, v in ref_model.state_dict().items()}
        # JAX's loss on the global batch, times 1 / n_data_shards
        ref_metrics, ref_grads, ref_params, ref_opt = _run_steps(
            ref_model, single, batch, spec["steps"], loss_scale=1.0 / mesh.size(0))

        model = get_model(par, device="cpu")
        model.load_state_dict(init)
        layout, opt = shard_state(model, par, mesh)
        local = {k: batch_shard(v, layout.coords) for k, v in batch.items()}
        metrics, grads, params_out, opt = _run_steps(model, par, local, spec["steps"],
                                                     layout, opt)
        # the eval step: the global batch's loss, RMSE and ACC on every rank
        from swin_v2_weather_torch.data.preprocess import Preprocessor
        from swin_v2_weather_torch.ops.losses import LossHandler
        from swin_v2_weather_torch.training.step import build_eval_step

        n_out = int(par["n_out_channels"])
        ref_ev = build_eval_step(ref_model, LossHandler(single), Preprocessor(single), n_out,
                                 loss_scale=1.0 / mesh.size(0))(batch)
        ev = build_eval_step(model, LossHandler(par), Preprocessor(par), n_out,
                             layout=layout)(local)
        for k in ("loss", "rmse", "acc"):
            out[f"{tag}/eval/{k}"] = ev[k].numpy()
            out[f"{tag}/ref_eval/{k}"] = ref_ev[k].numpy()
        keys = sorted(ref_metrics[0])
        out[f"{tag}/metric_names"] = np.asarray(keys)
        out[f"{tag}/ref_metrics"] = np.asarray([[m[k] for k in keys] for m in ref_metrics])
        out[f"{tag}/metrics"] = np.asarray([[m[k] for k in keys] for m in metrics])
        for n in ref_grads:
            out[f"{tag}/ref_grad/{n}"] = ref_grads[n].numpy()
            out[f"{tag}/grad/{n}"] = grads[n].numpy()
            out[f"{tag}/ref_param/{n}"] = ref_params[n].numpy()
            out[f"{tag}/param/{n}"] = params_out[n].numpy()

        # N ranks -> 1: the parallel state saved (gathered; the chief writes)
        # and restored into one process, bit for bit
        path = os.path.join(spec["workdir"], f"{tag}_ckpt")
        ckpt.save_checkpoint(path, model, opt, iters=spec["steps"], epoch=0)
        full_opt = _optimizer_full(opt) if not var["over"].get("shard_opt_state") else None
        dist.barrier()
        if rank == 0:
            one = get_model(single, device="cpu")
            one_opt = build_optimizer(single, one.parameters())
            ckpt.restore_checkpoint(path, one, one_opt, resuming=True)
            restored = _optimizer_full(one_opt)
            got = {n: p.detach() for n, p in one.named_parameters()}
            want = dict(params_out)
            if full_opt is not None:
                got.update(_moments(restored))
                want.update(_moments(full_opt))
            diff = _first_diff(got, want)
            out[f"{tag}/n_to_1_equal"] = np.asarray(int(diff == ""))
            out[f"{tag}/n_to_1_first_diff"] = np.asarray(diff)
            out[f"{tag}/n_to_1_moments"] = np.asarray(len(restored))

        # 1 -> N: the single-process state restored into a fresh parallel one
        path1 = os.path.join(spec["workdir"], f"{tag}_ckpt1")
        if rank == 0:
            ckpt.save_checkpoint(path1, ref_model, ref_opt, iters=spec["steps"], epoch=0)
        dist.barrier()
        model2 = get_model(par, device="cpu")
        _, opt2 = shard_state(model2, par, mesh)
        ckpt.restore_checkpoint(path1, model2, opt2, resuming=True)
        got = {n: full_state(p.detach()) for n, p in model2.named_parameters()}
        want = dict(ref_params)
        if not var["over"].get("shard_opt_state"):
            got.update(_moments(_optimizer_full(opt2)))
            want.update(_moments(_optimizer_full(ref_opt)))
        diff = _first_diff(got, want)
        out[f"{tag}/1_to_n_equal"] = np.asarray(int(diff == ""))
        out[f"{tag}/1_to_n_first_diff"] = np.asarray(diff)
        dist.barrier()
    return out


def job_mesh(spec, rank):
    """make_mesh over the group: this rank's coordinates and the mesh's rank
    array for each shape; broadcast_config of the chief's dict."""
    from swin_v2_weather_torch.parallel.mesh import broadcast_config, make_mesh, mesh_coords

    class P(dict):
        __getattr__ = dict.get

    out = {}
    for i, shape in enumerate(spec["shapes"]):
        mesh = make_mesh(P(mesh_shape=shape))
        c = mesh_coords(mesh)
        out[f"mesh{i}"] = mesh.mesh.numpy()
        out[f"coords{i}"] = np.asarray([c.dp, c.mp, c.data_index, c.model_index])
        out[f"names{i}"] = np.asarray(mesh.mesh_dim_names)
    cfg = broadcast_config({"lr": 0.5, "name": "trial-3"} if rank == 0 else None)
    out["config"] = np.asarray(json.dumps(cfg, sort_keys=True))
    return out


class _TriggerAt:
    """An injected preemption trigger that fires at its n-th poll."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    @property
    def triggered(self) -> bool:
        self.polls += 1
        return self.polls >= self.n

    def install(self):
        return self

    def uninstall(self) -> None:
        pass


class _Never(_TriggerAt):
    def __init__(self):
        super().__init__(1 << 30)


def job_trainer(spec, rank):
    """The Trainer on the group, for each config of ``runs``: an uninterrupted
    run; a run preempted at step ``preempt_at`` of epoch 0 on rank 0 only
    (the ranks must agree), then resumed; each run's final parameters."""
    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.training.trainer import Trainer

    def run(root, over, preempt=None):
        p = YParams(default_config_path(), MICRO)
        for k, v in dict(exp_dir=root, **over).items():
            p[k] = v
        t = Trainer(p, MICRO, run_num="t", device="cpu")
        t.build()
        t.preempt = preempt
        t.train()
        return t

    out = {}
    for tag, over in spec["runs"].items():
        root = os.path.join(spec["workdir"], tag)
        a = run(os.path.join(root, "a"), over)
        out[f"{tag}/a_stopped_at"] = np.asarray(-1 if a._preempted_at is None
                                                else a._preempted_at)
        b_root = os.path.join(root, "b")
        b = run(b_root, over, _TriggerAt(spec["preempt_at"]) if rank == 0 else _Never())
        out[f"{tag}/b_stopped_at"] = np.asarray(-1 if b._preempted_at is None
                                                else b._preempted_at)
        b2 = run(b_root, over)
        out[f"{tag}/b2_start"] = np.asarray([b2.start_epoch, b2.resume_step_in_epoch])
        out[f"{tag}/local_batch"] = np.asarray([b2.params["local_batch_size"],
                                                b2.params["data_num_shards"],
                                                b2.params["data_shard_id"]])
        for n, p in a.model.named_parameters():
            out[f"{tag}/a/{n}"] = full_state(p.detach()).numpy()
        for n, p in b2.model.named_parameters():
            out[f"{tag}/b/{n}"] = full_state(p.detach()).numpy()
    return out


JOBS = {"roll": job_roll, "spatial_forward": job_spatial_forward, "train": job_train,
        "mesh": job_mesh, "trainer": job_trainer}


def main(spec_path: str) -> int:
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    from swin_v2_weather_torch.parallel.mesh import init_distributed

    rank, world = init_distributed(device="cpu", init_method="file://" + spec["init"],
                                   timeout=datetime.timedelta(seconds=spec["timeout"]))
    if world != int(os.environ["WORLD_SIZE"]) or not dist.is_initialized():
        raise RuntimeError("the group did not start from the environment")
    try:
        out = JOBS[spec["job"]](spec, rank)
        np.savez(os.path.join(spec["workdir"], f"rank{rank}.npz"), **out)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
