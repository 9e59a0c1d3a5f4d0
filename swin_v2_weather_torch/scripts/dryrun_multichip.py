"""One full train step on N processes at tiny shapes, on the CPU (gloo): the
port's twin of JAX's ``dryrun_multichip`` (``__graft_entry__.py``).

It starts N processes (each a rank: ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
and a ``file://`` rendezvous in a temporary directory), and each runs, on
``swin_micro_test`` with a global batch of N and the 2-step rollout
(``n_future: 1``, ``scan_rollout: true``):

  1. a data-parallel train step on the (data, model) mesh ``[N / 2, 2]``
     (``[N, 1]`` for N <= 2 or odd N; DDP over ``data``, the model axis's
     ranks holding the same batch rows);
  2. with a model axis of 2 or more, the spatially sharded step
     (``spatial_shards`` = the model axis: latitude bands with halo rolls)
     with the optimizer's moments sharded over ``data`` (ZeRO-1), from the
     first step's weights;
  3. the FSDP2 step (``shard_params``): parameters and moments sharded over
     ``data``; the largest parameter whose first dim the data axis divides
     must hold 1 / (data axis) of its entries on each rank.

Each loss must be finite. Every group has a timeout and every process is
stopped at the end. Run it from the repo root:

    python -m swin_v2_weather_torch.scripts.dryrun_multichip [N]   (default 8)
"""

from __future__ import annotations

import datetime
import math
import os
import sys
import tempfile


def dryrun_multichip(n_devices: int = 8, timeout: float = 300.0) -> None:
    """Run the three steps on ``n_devices`` gloo processes; print rank 0's
    lines and raise if a rank fails or the group outlives ``timeout``
    seconds."""
    from swin_v2_weather_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        outs = run_ranks(
            [sys.executable, "-m", "swin_v2_weather_torch.scripts.dryrun_multichip", "--rank",
             os.path.join(tmp, "rendezvous"), str(timeout)],
            n_devices, tmp, timeout, env={"OMP_NUM_THREADS": "1"},
            what=f"dryrun_multichip({n_devices})")
        sys.stdout.write(outs[0])


def _rank_main(rendezvous: str, timeout: float) -> None:
    import torch
    import torch.distributed as dist

    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.data.preprocess import Preprocessor, derived_channel_counts
    from swin_v2_weather_torch.data.synthetic import SyntheticDataset, collate
    from swin_v2_weather_torch.models.wrappers import get_model
    from swin_v2_weather_torch.ops.losses import LossHandler
    from swin_v2_weather_torch.parallel.mesh import batch_shard, init_distributed, make_mesh
    from swin_v2_weather_torch.training.step import build_train_step, shard_state
    from swin_v2_weather_torch.training.trainer import init_parameters

    torch.set_num_threads(1)
    rank, n = init_distributed(device="cpu", init_method="file://" + rendezvous,
                               timeout=datetime.timedelta(seconds=timeout))
    try:
        params = YParams(default_config_path(), "swin_micro_test", print_params=False)
        params["batch_size"] = n
        params["n_future"] = 1  # the in-graph autoregressive rollout too
        params["scan_rollout"] = True
        params["n_in_channels"], params["n_out_channels"] = derived_channel_counts(params)
        params["img_shape_x"], params["img_shape_y"] = params.img_size
        params["data_loader_config"] = "synthetic"
        if n % 2 == 0 and n > 2:
            params["mesh_shape"] = [n // 2, 2]
        batch = collate([SyntheticDataset(params)[i] for i in range(n)], device="cpu")
        loss_handler, preprocessor = LossHandler(params), Preprocessor(params)

        def one_step(tag, seed, weights=None):
            model = get_model(params, device="cpu")
            if weights is None:
                init_parameters(model, torch.Generator().manual_seed(0))
            else:
                model.load_state_dict(weights)
            layout, optimizer = shard_state(model, params, make_mesh(params))
            step = build_train_step(model, loss_handler, preprocessor, optimizer,
                                    generator=torch.Generator().manual_seed(seed), layout=layout)
            loss = float(step({k: batch_shard(v, layout.coords) for k, v in batch.items()})["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(f"dryrun_multichip({n}): non-finite {tag} loss {loss}")
            return model, layout, loss

        model, layout, loss = one_step("DP", 1)
        c = layout.coords
        if rank == 0:
            print(f"dryrun_multichip({n}): one train step OK on the [{c.dp}, {c.mp}] mesh, "
                  f"loss={loss:.4f}", flush=True)
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if c.mp >= 2:
            params["spatial_shards"] = c.mp
            params["shard_opt_state"] = True
            _, _, sp_loss = one_step("spatial", 2, weights)
            if rank == 0:
                print(f"dryrun_multichip({n}): spatial-sharded train step OK (H/{c.mp} over "
                      f"'model', ZeRO-1 moments), loss={sp_loss:.4f}", flush=True)
            params["spatial_shards"] = 1
            params["shard_opt_state"] = False
        params["shard_params"] = True
        f_model, _, f_loss = one_step("FSDP", 3, weights)
        # FSDP2 shards dim 0: the largest parameter whose dim 0 the data axis divides
        big = max((p for p in f_model.parameters() if p.shape[0] % c.dp == 0),
                  key=lambda p: p.numel())
        if big.to_local().numel() * c.dp != big.numel():
            raise RuntimeError(f"dryrun_multichip({n}): params not actually sharded")
        if rank == 0:
            print(f"dryrun_multichip({n}): FSDP train step OK (params+moments sharded "
                  f"/{c.dp} over 'data'), loss={f_loss:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank_main(sys.argv[2], float(sys.argv[3]))
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
