"""The readings that the limits of a cell's numbers are set from.

    python3 benchmark/study.py --workload flagship-train --seeds 1 2 3 --control 1 2 3

For each seed, on the card: the cell's set-up, the least window that
produces every checked answer (one step, or one forecast), the check of the
program; for the seeds in ``--control`` also the check of the control (the
reference at the precision below the configuration's, in the program's
place). With ``--fault NAME`` a fault of ``benchmark/faults.py`` is planted
in the program (the readings are then of that fault). One JSON line a seed,
then the largest program reading and the smallest control reading of each
number. The benchmark's own runs never run the control or a fault.

With ``--drift`` (a forecast cell) the first seed's first forecast instead
keeps its first member's state after every step, and the line gives, per
lead time, its latitude-weighted RMS distance from the reference stepped in
fp32 from the same initial state (all channels, and the worst channel), and
how far the reference has moved from that state.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from benchmark import faults  # noqa: E402
from benchmark.harness import cells  # noqa: E402
from benchmark.harness.main import cell_spec, load_spec  # noqa: E402
from benchmark.reference import conditioning, scores  # noqa: E402
from benchmark.reference.model import forward, fp32_mode, make_weights  # noqa: E402


def drift(cell) -> list:
    """Per lead time: the first member's distance from the fp32 reference."""
    kept, rec = [], cell.rec
    inner = rec.stepper

    def keep(state, zen=None):
        out = inner(state, zen)
        if rec.scoring and rec.forecast == 0:
            kept.append(out[0].float().clone())
        return out

    rec.stepper = keep
    cell.window(0.0)
    cell.free()
    cells.collect()
    g, dev = cell.run.g, cell.run.device
    hours = 6 * int(cell.run.cfg["dt"])
    static = cell.fields.static.to(dev)
    w = scores.lat_weight(g.h, dev).float()
    ic = x = cell.initial_state(0)
    rows = []
    with fp32_mode(), torch.no_grad():
        P = make_weights(g, cell.s_weights, dev)
        for s, got in enumerate(kept):
            when = cell.start(0) + datetime.timedelta(hours=hours * s)
            zen = conditioning.cos_zenith(when, g.h, g.w)
            x = forward(conditioning.model_input(x, zen, static), P, g)
            err = torch.mean(w * (got - x[0]) ** 2, dim=(-2, -1))
            rows.append({"step": s + 1, "rms": float(err.mean().sqrt()),
                         "worst_channel": float(err.max().sqrt()),
                         "moved": float(torch.mean(w * (x - ic) ** 2).sqrt())})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--drift", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs = cell_spec(load_spec(ROOT), ROOT, args.workload)
    if args.fault:
        faults.plant(args.fault, cs["traffic"]["kind"])
    with open(cs["config_file"]) as f:
        cfg = json.load(f)[cs["config"]["name"]]
    worst, least = {}, {}
    for seed in args.seeds:
        scratch = tempfile.mkdtemp(prefix="swin-study-")
        try:
            t0 = time.perf_counter()
            cell = cells.KINDS[cs["traffic"]["kind"]](cells.Run(
                cell=args.workload, config_name=cs["config"]["name"],
                config_file=cs["config_file"], cfg=cfg, traffic=cs["traffic"], seed=seed,
                device="cuda", scratch=scratch))
            cell.setup()
            if args.drift:
                print(json.dumps({"seed": seed, "drift": drift(cell)}), flush=True)
                return 0
            t1 = time.perf_counter()
            cell.window(0.0)
            cell.free()
            cells.collect()
            t2 = time.perf_counter()
            line = {"seed": seed, "program": cell.check()}
            t3 = time.perf_counter()
            if seed in args.control:
                line["control"] = cell.check(control=True)
            line["seconds"] = {"setup": t1 - t0, "window": t2 - t1, "check": t3 - t2,
                               "control": time.perf_counter() - t3}
            print(json.dumps(line), flush=True)
            for k, v in line["program"].items():
                worst[k] = max(worst.get(k, 0.0), v)
            for k, v in line.get("control", {}).items():
                least[k] = min(least.get(k, float("inf")), v)
            del cell
            cells.collect()
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"program_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
