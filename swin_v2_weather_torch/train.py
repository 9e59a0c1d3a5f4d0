"""Training CLI of the PyTorch port (counterpart of the repo-root ``train.py``,
which stays the JAX package's CLI).

Usage:
    python -m swin_v2_weather_torch.train --config=swin_73var_geo_depth12_chweight_invar \\
        [--yaml_config PATH] [--run_num NN] [--sweep_id ID] [--device cuda|cpu]

It takes the JAX CLI's arguments plus ``--device`` (default ``cuda``): without
a CUDA device the Trainer raises unless ``--device cpu`` is given.

On several GPUs, one process per GPU under torchrun (rank r drives
``cuda:LOCAL_RANK``; NCCL; ``mesh_shape``, ``shard_opt_state``,
``shard_params`` and ``spatial_shards`` from the config or ``--set``):

    torchrun --nproc_per_node N -m swin_v2_weather_torch.train --config=...

With ``--device cpu`` the ranks take gloo.
``--enable_amp`` sets ``compute_dtype: bfloat16`` (the configs' default
already; bf16 compute with fp32 parameters needs no GradScaler).
"""

import argparse
import logging
import os


def main(argv=None):
    import yaml

    from swin_v2_weather_torch.config.yparams import YParams, default_config_path
    from swin_v2_weather_torch.training.trainer import Trainer
    from swin_v2_weather_torch.utils.logging_utils import config_logger

    config_logger()
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_num", default="00", type=str)
    parser.add_argument("--yaml_config", default=default_config_path(), type=str)
    parser.add_argument("--config", default="swin_73var_geo_depth12_chweight_invar", type=str)
    parser.add_argument(
        "--sweep_id", default=None, type=str,
        help="run as a sweep-agent trial worker: a local sweep id (created "
        "with --sweep_config) runs the native in-repo agent "
        "(training/sweeps.py); anything else is handed to wandb.agent",
    )
    parser.add_argument(
        "--sweep_config", default=None, type=str,
        help="path to a wandb-schema sweep YAML: registers a native local "
        "sweep under <exp_dir>/sweeps/ and runs the agent immediately "
        "(no wandb/network needed)",
    )
    parser.add_argument(
        "--sweep_trials", default=None, type=int,
        help="max trials for this agent (required for random sweeps)",
    )
    parser.add_argument(
        "--enable_amp", action="store_true",
        help="reference-CLI compat: mixed precision means bf16 compute, the "
        "configs' default; this flag forces it if a config overrode compute_dtype",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override a config value (yaml-parsed; repeatable), e.g. "
        "--set batch_size=8 --set attn_impl=pallas_qkv",
    )
    parser.add_argument(
        "--device", default="cuda", type=str,
        help="device to train on (default cuda; cpu only when asked for)",
    )
    args = parser.parse_args(argv)

    params = YParams(os.path.abspath(args.yaml_config), args.config, print_params=False)
    for item in args.set:
        key, sep, value = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        params[key] = yaml.safe_load(value)
    if args.enable_amp:
        params["compute_dtype"] = "bfloat16"
    sweep_id = args.sweep_id
    if args.sweep_config:
        # register a native local sweep and run its agent right away
        from swin_v2_weather_torch.training import sweeps

        sweep_id = sweeps.sweep(args.sweep_config, root=params["exp_dir"])
        logging.info("registered native sweep %s", sweep_id)

    trainer = Trainer(params, args.config, run_num=args.run_num, sweep_id=sweep_id,
                      device=args.device)

    if sweep_id:
        from swin_v2_weather_torch.training import sweeps

        if sweeps.is_local_sweep(sweep_id, params["exp_dir"]):
            records = sweeps.agent(
                sweep_id, function=trainer.build_and_launch, count=args.sweep_trials,
                root=params["exp_dir"],
            )
            best = sweeps.best_trial(records, "minimize")
            if best is not None:
                logging.info(
                    "sweep %s best trial: %s %s=%s params=%s",
                    sweep_id, best["trial"], best["metric"], best["best"], best["params"],
                )
        else:
            try:
                import wandb
            except ImportError as e:
                raise SystemExit(
                    f"--sweep_id {sweep_id!r} is not a local sweep and wandb "
                    "is not installed; create one with --sweep_config"
                ) from e
            wandb.agent(
                sweep_id, function=trainer.build_and_launch, count=1,
                entity=params.get("entity"), project=params.get("project"),
            )
    else:
        trainer.build_and_launch()
    logging.info("DONE")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
