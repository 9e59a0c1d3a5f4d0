"""One run of one cell: ``run.py --workload NAME --seed N --seconds S --trace 0|1``.

Everything a cell is made of is found by name from ``BENCHMARK.json``: the
configuration's file, the traffic mix ``<paths[0]>/traffic/<traffic>.json``
(its ``kind`` picks the loop in ``cells.py``), the limits of the numbers
compared ``<paths[0]>/limits/<cell>.json`` and each per-layer metric's
reader ``<paths[0]>/metrics/<metric>.py`` (``read(ctx)`` returns a number
or None).

The last line of standard output is the result (a JSON object); the numbers
compared, each beside its limit, are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from benchmark import counts
from benchmark.harness import cells, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "swin_v2_weather_tpu")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(spec: dict, root: str, name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    data = os.path.join(root, spec["paths"][0])
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(data, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_file = os.path.join(data, "limits", name + ".json")
    limits = {}
    if os.path.exists(limits_file):
        with open(limits_file) as f:
            limits = json.load(f)["limits"]

    def here(metric: dict, e2e_names=None) -> bool:
        if "workloads" in metric:
            return name in metric["workloads"]
        return e2e_names is None or metric["moves"] in e2e_names

    e2e = [m for m in spec["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if here(m, names)]
    return {"cell": cell, "config": conf, "config_file": os.path.join(root, conf["file"]),
            "traffic": traffic, "limits": limits, "end_to_end": e2e, "per_layer": layer,
            "data": data}


def reader(data: str, metric: str):
    path = os.path.join(data, "metrics", metric + ".py")
    mod_name = "benchmark_metric_" + "".join(ch if ch.isalnum() else "_" for ch in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device: str, peak_bytes: Optional[int]) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak_bytes)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, checks): every reading within its limit; a missing limit or
    a reading that is no number fails."""
    checks, ok = {}, bool(readings)
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(argv=None, root: Optional[str] = None, device: Optional[str] = None,
        t_start: Optional[float] = None) -> int:
    """One run; ``device`` None asks for the chips the cell needs (the
    tests pass "cpu"). Returns the exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = load_spec(root)
    cs = cell_spec(spec, root, args.workload)
    chips = int(cs["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    torch.set_num_threads(4)
    with open(cs["config_file"]) as f:
        cfg_doc = json.load(f)
    name = cs["config"]["name"]
    scratch = tempfile.mkdtemp(prefix="swin-bench-")
    try:
        r = cells.Run(cell=args.workload, config_name=name, config_file=cs["config_file"],
                      cfg=cfg_doc[name], traffic=cs["traffic"], seed=args.seed, device=device,
                      scratch=scratch)
        cell = cells.KINDS[cs["traffic"]["kind"]](r)
        cell.setup()
        cells.sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        w = cell.window(args.seconds)
        # the check's capture buffers, allocated at set-up, are left out
        peak = (torch.cuda.max_memory_allocated() - cell.check_bytes
                if device == "cuda" else None)
        tr, seg_steps = None, 0
        if args.trace and device == "cuda":
            box = {}
            tr = trace.profile(lambda: box.setdefault("n", cell.segment()), cs["data"])
            seg_steps = box["n"]
        elif args.trace:
            seg_steps = cell.segment()
        cell.free()
        cells.collect()
        readings = cell.check()
        correct, checks = judge(readings, cs["limits"])
        result = {"correct": correct, "attempted": w["attempted"], "failed": w["failed"],
                  "metrics": {}, "device": device_info(device, peak)}
        ctx = dict(w, kind=cell.kind, cfg=r.cfg, traffic=r.traffic, trace=tr,
                   segment_steps=seg_steps,
                   peak=counts.peaks(result["device"]["kind"]) if device == "cuda" else None)
        if not args.trace:
            values = {"setup_s": setup_s,
                      "train_samples_s": (w["train_samples"] / w["window_s"]
                                          if "train_samples" in w else None),
                      "forecast_14d_s": (int(r.traffic.get("steps", 56)) * w["window_s"]
                                         / w["forecast_steps"] if w.get("forecast_steps")
                                         else None),
                      "peak_mem_gib": None if peak is None else peak / 2**30}
            for m in cs["end_to_end"]:
                if values.get(m["name"]) is not None:
                    result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            for m in cs["per_layer"]:
                value = reader(cs["data"], m["name"])(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            if tr is not None:
                result["device"]["busy_s"] = tr.busy_s
                result["device"]["window_s"] = tr.wall_s
                result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                                       "idle_gaps": [list(x) for x in tr.idle_gaps]}
                print("trace: device seconds by innermost op: " + json.dumps(
                    dict(sorted(tr.by_op.items(), key=lambda kv: -kv[1])[:25])),
                      file=sys.stderr)
                print(f"trace: cublas {tr.cublas_s} torch_ops {tr.torch_ops_s} unlinked "
                      f"{tr.unlinked_s} launches {len(tr.launches)}", file=sys.stderr)
        result["checks"] = checks
        found = forbidden_modules()
        if found:
            print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
            return 3
        for key, c in checks.items():
            print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
