"""One rank of the parallel train step on the card, held to the plain
single-process step (``chip_smoke.py`` phase 43 starts its ranks).

Each rank builds the flagship (``swin_73var_geo_depth12_chweight_invar`` at full
width, the config's 'mlp3' remat, drop-path 0.1, Adam, one synthetic sample
a data shard, every parameter from seeded noise) and takes one train step
of the model as it is, on one process, on the whole global batch at
``loss_scale`` 1 / data shards: the reference (its loss and every
gradient, kept on the host). For each variant the same weights go through
``training/step.shard_state`` on a mesh of the ranks and take ``--steps``
steps on the rank's part of the batch, the drop-path generator seeded as
the reference's:

  * ``ddp``, ``zero1``, ``fsdp2``: replicated (DDP), ``shard_opt_state``
    (ZeRO-1), ``shard_params`` (FSDP2) over the ``data`` axis;
  * ``spatial``: ``spatial_shards`` = the ranks, mesh ``[1, ranks]``: each
    rank runs its latitude band (the halo rolls, K1/K2 with the boundary
    flag 1.0 on the last band and 0.0 on the others) and the bands' outputs
    are gathered before the loss;
  * ``trainer``: the Trainer on the process group (its mesh, DDP with
    ``shard_opt_state``, the loader sharded by the data index, validation
    over the global batch, the checkpoint gathered and written by the
    chief) for one epoch of 2 batches of one sample a rank, in a temporary
    directory: its logged metrics and whether its checkpoint was written.

For each variant it reports step 1's loss and the largest difference of
every gradient from the reference (and whether all are bit-equal), the
launches a step of the counted kernels (the counts reset just before the
variant's steps) and of the GEMM core, the boundary flags K1/K2 took on the
masked (shifted) blocks, ms/step over the steps after the first (the
host's clock around steps that end in a device synchronize), the peak
device memory of the steps, and with spatial sharding the halo bytes a
step and the ms the exchanges themselves take. Those are timed on one more
step, after the timed ones: before each exchange the rank synchronizes its
device and waits for the other ranks of its group at a barrier, so that the
clock holds the copies and the transfer, not the compute still queued nor
a peer that is behind; that step's time is not in ms/step. Each rank writes
its results to ``--out``/rank<r>.json. A rank needs a CUDA device; the
kernel library must be built before the ranks start
(``ops/_build.build_library``), so that no two ranks build it at once.

    RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 python -m swin_v2_weather_torch.scripts.parallel_check \\
        --backend nccl --rendezvous /tmp/rdv --variants ddp,zero1,fsdp2 --out results/
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import inspect
import json
import os
import time
from unittest import mock

import torch
import torch.distributed as dist

CONFIG = "swin_73var_geo_depth12_chweight_invar"
SEED = 2018


@contextlib.contextmanager
def recorded_flags(wa, flags: dict):
    """Record the boundary flag of every masked K1/K2 launch (at the
    launchers, so that the wrappers and their launch counts stay as they
    are)."""
    def recorder(name, launcher):
        sig = inspect.signature(launcher)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            if (bound.arguments["fn"].__name__ in ("window_attention_qkv",
                                                   "window_attention_qkv_bwd")
                    and bound.arguments["mask_pattern"] is not None):
                flags.setdefault(name, set()).add(float(bound.arguments["boundary_flag"]))
            return launcher(*args, **kwargs)
        return call

    with mock.patch.multiple(wa, _launch_forward=recorder("fwd", wa._launch_forward),
                             _launch_backward=recorder("bwd", wa._launch_backward)):
        yield


@contextlib.contextmanager
def timed_halos(stats: dict):
    """Count the halo exchanges' bytes (sent) and seconds, each exchange timed
    from a synchronized device and a barrier of its group to its received
    tensor on the device."""
    from swin_v2_weather_torch.parallel import spatial

    orig = spatial._exchange

    def exchange(halo, group, *args):
        if halo.is_cuda:
            torch.cuda.synchronize(halo.device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        out = orig(halo, group, *args)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        stats["s"] = stats.get("s", 0.0) + time.perf_counter() - t0
        stats["bytes"] = stats.get("bytes", 0) + halo.numel() * halo.element_size()
        return out

    with mock.patch.object(spatial, "_exchange", exchange):
        yield


def run_trainer(flagship, config: str, dev) -> dict:
    """One epoch of the Trainer on the process group (``trainer`` variant)."""
    import shutil
    import tempfile

    from swin_v2_weather_torch.training import checkpoint as ckpt
    from swin_v2_weather_torch.training.trainer import Trainer

    root = tempfile.mkdtemp(prefix="parallel_check_trainer_") if dist.get_rank() == 0 else None
    box = [root]
    dist.broadcast_object_list(box, src=0)
    try:
        world = dist.get_world_size()
        params = flagship(exp_dir=box[0], max_epochs=1, n_synthetic_samples=2 * world,
                          batch_size=world, shard_opt_state=True, log_to_screen=False,
                          save_checkpoint=True)
        t = Trainer(params, config, run_num="t", device=dev)
        t0 = time.perf_counter()
        t.build_and_launch()
        wall = time.perf_counter() - t0
        with open(os.path.join(params["experiment_dir"], "logs.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        return {"mesh": [t.layout.coords.dp, t.layout.coords.mp], "wall_s": wall,
                "logs": lines, "checkpoint": ckpt.latest_checkpoint_exists(
                    params["checkpoint_path"]),
                "forward": type(t.layout.forward).__name__,
                "optimizer": type(t.optimizer).__name__}
    finally:
        dist.barrier()
        if box[0] is not None and dist.get_rank() == 0:
            shutil.rmtree(box[0], ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", default="nccl")
    parser.add_argument("--rendezvous", required=True, help="file for the FileStore rendezvous")
    parser.add_argument("--variants", default="ddp,zero1,fsdp2")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="default cuda:LOCAL_RANK; cpu rehearses the run on the host")
    parser.add_argument("--config", default=CONFIG)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--out", required=True, help="directory for rank<r>.json")
    args = parser.parse_args(argv)

    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import Preprocessor, derived_channel_counts
    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.ops import _build
    from swin_v2_weather_torch.ops import gemm_core as gc
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.parallel.mesh import batch_shard, make_mesh
    from swin_v2_weather_torch.training.checkpoint import full_state
    from swin_v2_weather_torch.training.optim import build_optimizer
    from swin_v2_weather_torch.training.step import build_train_step, shard_state
    from swin_v2_weather_torch.training.trainer import seeded_parameters

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("parallel_check: no CUDA device")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if not os.path.exists(_build.library_path()):
            raise SystemExit("parallel_check: build the kernel library before starting the ranks")
        _build.load_library()
    dist.init_process_group(args.backend, init_method=f"file://{args.rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=args.timeout))
    counted = (wa.window_attention_qkv, wa.window_attention_qkv_bwd, mk.fc1_gelu, mk.fc1_dpre,
               mk.mlp_fwd, mk.mlp_bwd)
    results = {"rank": rank, "world": world, "backend": args.backend, "config": args.config,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "variants": {}}

    def flagship(**over):
        p = YParams(default_config_path(), args.config, print_params=False)
        for k, v in over.items():
            p[k] = v
        p["n_in_channels"], p["n_out_channels"] = derived_channel_counts(p)
        p["img_shape_x"], p["img_shape_y"] = (int(s) for s in p.img_size)
        p["data_loader_config"] = "synthetic"
        return p

    try:
        params = flagship()
        loss_handler, preprocessor = LossHandler(params), Preprocessor(params)
        samples = SyntheticDataset(params)

        def step_fn(model, optimizer, layout=None, loss_scale=None):
            return build_train_step(model, loss_handler, preprocessor, optimizer,
                                    loss_scale=loss_scale, layout=layout,
                                    generator=torch.Generator(device=dev).manual_seed(SEED))

        model = get_model(params, device=dev)
        seeded_parameters(model, torch.Generator(device=dev).manual_seed(SEED + 1))
        init = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        del model
        refs = {}

        def reference(n: int, dp: int):
            """The model as it is, one process, on the global batch of n
            samples at loss_scale 1 / dp: (metrics, gradients on the host)."""
            if (n, dp) not in refs:
                model = get_model(params, device=dev)
                model.load_state_dict(init)
                batch = collate([samples[i] for i in range(n)], device=dev)
                step = step_fn(model, build_optimizer(params, model.parameters()),
                               loss_scale=1.0 / dp)
                refs[(n, dp)] = ({k: float(v) for k, v in step(batch).items()},
                                 {k: p.grad.detach().to("cpu", copy=True)
                                  for k, p in model.named_parameters()})
                del model, step, batch
                if cuda:
                    torch.cuda.empty_cache()
            return refs[(n, dp)]

        for variant in args.variants.split(","):
            if variant == "trainer":
                results["variants"]["trainer"] = run_trainer(flagship, args.config, dev)
                dist.barrier()
                continue
            if variant == "spatial":
                p = flagship(spatial_shards=world, mesh_shape=[1, world])
            else:
                p = flagship(mesh_shape=[world, 1], shard_opt_state=variant == "zero1",
                             shard_params=variant == "fsdp2")
            # one sample a data shard; the whole global batch for the reference
            dp = 1 if variant == "spatial" else world
            ref, ref_grads = reference(dp, dp)
            batch = collate([samples[i] for i in range(dp)], device=dev)
            model = get_model(p, device=dev)
            model.load_state_dict(init)
            layout, optimizer = shard_state(model, p, make_mesh(p))
            step = step_fn(model, optimizer, layout)
            local = {k: batch_shard(v, layout.coords) for k, v in batch.items()}
            flags, halos = {}, {}
            for fn in counted:
                fn.launches = 0
            gc.gemm.launches = 0
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            with recorded_flags(wa, flags):
                metrics = [{k: float(v) for k, v in step(local).items()}]
                grads = {n: full_state(q.grad).detach() for n, q in model.named_parameters()}
                worst, equal = 0.0, True
                for n, g in grads.items():
                    r = ref_grads[n].to(dev)
                    equal = equal and torch.equal(g, r)
                    worst = max(worst, float((g - r).abs().max() / r.abs().max().clamp_min(1e-30)))
                del grads
                sync()
                t0 = time.perf_counter()
                for _ in range(args.steps - 1):
                    metrics.append({k: float(v) for k, v in step(local).items()})
                sync()
                elapsed = time.perf_counter() - t0
            n_timed = args.steps - 1
            launches = {fn.__name__: fn.launches / args.steps for fn in counted}
            gemm_per_step = gc.gemm.launches / args.steps
            peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
            if layout.spatial:  # one more step, its exchanges timed alone
                with timed_halos(halos):
                    step(local)
                sync()
            results["variants"][variant] = {
                "mesh": [layout.coords.dp, layout.coords.mp],
                "loss_ref": ref["loss"], "loss": metrics[0]["loss"],
                "grad_norm_ref": ref["grad_norm"], "grad_norm": metrics[0]["grad_norm"],
                "grads_bit_equal": equal, "worst_grad_rel": worst,
                "metrics": metrics,
                "launches_per_step": launches,
                "gemm_per_step": gemm_per_step,
                "flags": {k: sorted(v) for k, v in flags.items()},
                "ms_per_step": elapsed * 1e3 / n_timed,
                "peak_gib": peak,
                "halo_bytes_per_step": halos.get("bytes", 0),
                "halo_exchange_ms_per_step": halos.get("s", 0.0) * 1e3,
            }
            del model, optimizer, step, layout, batch, local
            if cuda:
                torch.cuda.empty_cache()
            dist.barrier()
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
