"""Inference CLI: medium-range rollout and scoring from a model registry.

Counterpart of ``swin_v2_weather_tpu/inference/cli.py``: point it at a
registry directory (``inference/registry.py``) and an ERA5 validation
archive, pick initial conditions, and it scores latitude-weighted RMSE (and
ACC where the registry ships a climatology) per lead time, averaged over the
initial conditions.

Usage:
    python -m swin_v2_weather_torch.inference.cli \\
        --registry registry/swin_73var --data /data/era5/out_of_sample \\
        --ics 0 100 200 --steps 56 --scanned --output scores.json

    # probabilistic ensemble scoring (CRPS, spread, ensemble-mean skill;
    # inference/ensemble.py)
    python -m swin_v2_weather_torch.inference.cli \\
        --registry registry/swin_73var --data /data/era5/out_of_sample \\
        --ics 0 100 --steps 56 --ensemble 9 --perturb bred --amplitude 0.05

    # the serving artifact (torch.export, weights inside; inference/export.py),
    # one program per platform
    python -m swin_v2_weather_torch.inference.cli \\
        --registry registry/swin_73var --export-stepper served/ --batch 1 \\
        --platforms cuda cpu

It takes the JAX CLI's arguments (``--platforms`` names the port's platforms,
``cuda`` and ``cpu``: a ``torch.export`` program runs on the platform it was
traced for), plus ``--device`` (default ``cuda``): without a CUDA device it
raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _device(args) -> torch.device:
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the inference CLI runs on the GPU unless asked "
                           "otherwise (--device cpu)")
    return device


def _engine(args):
    from swin_v2_weather_torch.inference.registry import load_model
    from swin_v2_weather_torch.inference.rollout import RolloutEngine

    device = _device(args)
    model, params = load_model(args.registry, device)
    return RolloutEngine(params, model, device), params


def run(args) -> dict:
    """Score ``args.ics`` of the archive ``args.data`` with the registry's
    model; returns the skill curves averaged over the initial conditions."""
    from swin_v2_weather_torch.data.era5 import Era5Dataset
    from swin_v2_weather_torch.inference.registry import load_stats
    from swin_v2_weather_torch.inference.scoring import score_rollout

    engine, params = _engine(args)
    means, stds, time_means = load_stats(params)

    params["n_future"] = 0
    dataset = Era5Dataset(params, args.data, train=False)

    h, w = dataset.img_shape
    if time_means is not None:
        time_means = time_means[..., :h, :w]  # the same 721 -> 720 crop as the data
    chunk = int(getattr(args, "chunk_steps", 8))
    all_scores = []
    for ic_idx in args.ics:
        year_idx, local_idx = dataset.locate(int(ic_idx))
        year = dataset.years[year_idx]
        # local_idx is a frame index into the 6-hourly archive: dt strides
        # which frames become samples, not the archive's cadence
        start = datetime.datetime(year, 1, 1) + datetime.timedelta(hours=6 * local_idx)

        sample = dataset[int(ic_idx)]
        ic = sample[0][None, : len(params["out_channels"])]

        n_avail = dataset.n_samples_year[year_idx]
        steps = min(args.steps, (n_avail - 1 - local_idx) // dataset.dt)
        if steps < args.steps:
            logger.warning(
                "ic %d: only %d of %d requested steps fit inside %d",
                ic_idx, steps, args.steps, dataset.years[year_idx],
            )
        tars = [
            dataset.read_output_frame(year_idx, local_idx + dataset.dt * (s + 1))[None]
            for s in range(steps)
        ]
        if getattr(args, "save_forecast", None):
            engine.write_forecast(
                args.save_forecast, ic, start, steps, means=means, stds=stds,
                channel_names=list(params["channel_names"]),
                keep_names=getattr(args, "save_channels", None),
                ic_index=int(ic_idx), chunk=chunk,
            )
        n_members = int(getattr(args, "ensemble", 0) or 0)
        if n_members > 1:
            from swin_v2_weather_torch.inference.ensemble import (
                breed_perturbations,
                gaussian_perturbations,
                make_members,
                score_ensemble,
            )

            n_pairs = (n_members - 1 + 1) // 2
            amplitude = float(getattr(args, "amplitude", 0.05))
            trunc = getattr(args, "zonal_truncation", 20)
            seed = int(getattr(args, "seed", 0))
            if getattr(args, "perturb", "gaussian") == "bred":
                pert = breed_perturbations(
                    engine, ic, start, n_pairs, amplitude,
                    cycles=int(getattr(args, "breed_cycles", 3)), seed=seed,
                    zonal_truncation=trunc,
                )
            else:
                gen = torch.Generator(device=engine.device).manual_seed(seed)
                pert = gaussian_perturbations(gen, n_pairs, ic.shape[-3:], amplitude,
                                              zonal_truncation=trunc)
            members = make_members(ic, pert, n_members)
            scores = score_ensemble(
                engine, members, tars, start, means=means, stds=stds,
                climatology=time_means, channel_names=list(params["channel_names"]),
                chunk=chunk,
            )
            scores["rmse"] = scores["rmse_mean"]  # the skill-curve aggregation below
            if "acc_mean" in scores:
                scores["acc"] = scores["acc_mean"]
        else:
            scores = score_rollout(
                engine, ic, tars, start, means=means, stds=stds,
                climatology=time_means, channel_names=list(params["channel_names"]),
                scanned=getattr(args, "scanned", False), chunk=chunk,
            )
        scores["ic_index"] = int(ic_idx)
        scores["start_time"] = start.isoformat()
        all_scores.append(scores)
        logger.info(
            "ic %d (%s): rmse[t+6h] mean %.3f", ic_idx, start.isoformat(),
            float(np.mean(scores["rmse"][0])),
        )

    # average over initial conditions (the deterministic skill curve), trimmed
    # to the shortest rollout where a late initial condition ran out of year
    t_min = min(len(s["rmse"]) for s in all_scores)
    out = {
        "lead_hours": all_scores[0]["lead_hours"][:t_min].tolist(),
        "channels": list(params["channel_names"]),
        "rmse": np.mean([s["rmse"][:t_min] for s in all_scores], axis=0).tolist(),
        "n_ics": len(args.ics),
        "ics": [
            {"index": s["ic_index"], "start_time": s["start_time"]} for s in all_scores
        ],
    }
    for key in ("acc", "crps", "spread", "rmse_control"):
        if key in all_scores[0]:
            out[key] = np.mean([s[key][:t_min] for s in all_scores], axis=0).tolist()
    if "n_members" in all_scores[0]:
        out["n_members"] = int(all_scores[0]["n_members"])
    return out


def main(argv=None):
    from swin_v2_weather_torch.utils.logging_utils import config_logger

    config_logger()
    parser = argparse.ArgumentParser(description="rollout + scoring")
    parser.add_argument("--registry", required=True, help="model registry directory")
    parser.add_argument("--data", help="ERA5 HDF5 archive directory")
    parser.add_argument("--ics", type=int, nargs="+", default=[0], help="IC sample indices")
    parser.add_argument("--steps", type=int, default=56, help="rollout steps (6h each)")
    parser.add_argument(
        "--scanned", action="store_true",
        help="chunked rollout: --chunk-steps steps enqueued back to back on the device "
        "with the zenith channels computed up front, one host sync a chunk",
    )
    parser.add_argument("--chunk-steps", type=int, default=8, dest="chunk_steps")
    parser.add_argument(
        "--ensemble", type=int, default=0, metavar="M",
        help="ensemble forecast with M members (control + centered +/- perturbation "
        "pairs); scores CRPS/spread/ensemble-mean skill on the device "
        "(inference/ensemble.py)",
    )
    parser.add_argument(
        "--perturb", choices=("gaussian", "bred"), default="gaussian",
        help="IC perturbation strategy for --ensemble",
    )
    parser.add_argument(
        "--amplitude", type=float, default=0.05,
        help="perturbation lat-weighted RMS amplitude (normalized units)",
    )
    parser.add_argument("--breed-cycles", type=int, default=3, dest="breed_cycles")
    parser.add_argument(
        "--zonal-truncation", type=int, default=20, dest="zonal_truncation",
        help="low-pass perturbations to zonal wavenumbers <= K",
    )
    parser.add_argument("--seed", type=int, default=0, help="perturbation seed")
    parser.add_argument(
        "--save-forecast", metavar="DIR", dest="save_forecast",
        help="also write the denormalized forecast fields per IC "
        "(ic<idx>.npy [T, C', H, W] + .json metadata)",
    )
    parser.add_argument(
        "--save-channels", nargs="+", dest="save_channels",
        help="channel names to save (default: all output channels)",
    )
    parser.add_argument("--output", default="scores.json")
    parser.add_argument(
        "--export-stepper", metavar="DIR",
        help="write the serving artifact (a torch.export stepper.<platform>.pt2 for each "
        "of --platforms + manifest.json) instead of scoring",
    )
    parser.add_argument("--batch", type=int, default=1, help="serving batch size")
    parser.add_argument(
        "--platforms", nargs="+", default=None,
        help="platforms of --export-stepper's programs (cuda, cpu; default --device's)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device to run on (default cuda; cpu only when asked for)",
    )
    args = parser.parse_args(argv)

    if args.export_stepper:
        from swin_v2_weather_torch.inference.export import export_stepper

        engine, _ = _engine(args)
        manifest = export_stepper(engine, args.export_stepper, batch=args.batch,
                                  platforms=args.platforms)
        logging.info("wrote %s (%d bytes, platforms %s)", args.export_stepper,
                     manifest["artifact_bytes"], manifest["platforms"])
        return

    if not args.data:
        parser.error("--data is required for scoring runs")
    out = run(args)
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    logging.info("wrote %s", args.output)


if __name__ == "__main__":
    main()
