"""Native hyperparameter-sweep agent (the in-repo ``wandb.agent`` role).

A copy of ``swin_v2_weather_tpu/training/sweeps.py`` for the PyTorch port.
The reference delegates HPO to the wandb sweeps service: a server samples
trial params, ``wandb.agent`` runs the train function once per trial, and the
chief merges ``wandb.config`` into its params. That needs a network service;
clusters are often air-gapped. This module provides the same loop locally
with zero dependencies:

* ``sweep(sweep_config, root)`` — register a sweep from the SAME config
  schema wandb uses (``method``: grid | random; ``metric``: {name, goal};
  ``parameters``: {key: {values: [...]} | {min, max [, distribution]}}),
  returns a sweep id.
* ``agent(sweep_id, function, count, root)`` — the agent loop: samples the
  next trial's params, exposes them as the *active trial config* (the
  ``wandb.config`` role — ``Trainer.build`` merges them), calls
  ``function()``, collects the sweep metric reported through ``MetricsSink``
  (the ``wandb.log`` role), and appends a record to
  ``<sweep_dir>/trials.jsonl``.

If wandb IS installed and the sweep id is not a local one, the port's
training CLI falls through to ``wandb.agent`` unchanged (a lazy import).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import yaml

_LOCAL_PREFIX = "local-"


# ---------------------------------------------------------------------------
# active-trial registry (the wandb.run / wandb.config role)
# ---------------------------------------------------------------------------


@dataclass
class _Trial:
    name: str
    config: Dict[str, Any]
    metrics: List[Dict[str, Any]] = field(default_factory=list)


_lock = threading.Lock()
_active: Optional[_Trial] = None


def active_config() -> Optional[Dict[str, Any]]:
    """The running trial's parameter overrides, or None outside a trial."""
    return None if _active is None else dict(_active.config)


def active_trial_name() -> Optional[str]:
    return None if _active is None else _active.name


def report(metrics: Dict[str, Any]) -> None:
    """Record metrics for the running trial (called by MetricsSink.log)."""
    with _lock:
        if _active is not None:
            _active.metrics.append(
                {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
            )


# ---------------------------------------------------------------------------
# sweep registration + trial sampling
# ---------------------------------------------------------------------------


def _sweep_dir(sweep_id: str, root: str) -> str:
    return os.path.join(root, "sweeps", sweep_id)


def sweep(sweep_config: Dict[str, Any] | str, root: str) -> str:
    """Register a sweep; returns its id (``local-<name>-<timestamp>``).

    ``sweep_config`` is a dict in the wandb sweep schema, or a path to a
    YAML file holding one.
    """
    if isinstance(sweep_config, str):
        with open(sweep_config) as f:
            sweep_config = yaml.safe_load(f)
    if "parameters" not in sweep_config:
        raise ValueError("sweep config needs a 'parameters' section")
    method = sweep_config.get("method", "grid")
    if method not in ("grid", "random"):
        raise ValueError(f"sweep method {method!r} not supported (grid | random)")
    name = str(sweep_config.get("name", "sweep")).replace("/", "_")
    sweep_id = f"{_LOCAL_PREFIX}{name}-{int(time.time())}"
    d = _sweep_dir(sweep_id, root)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sweep.yaml"), "w") as f:
        yaml.safe_dump(sweep_config, f)
    return sweep_id


def is_local_sweep(sweep_id: str, root: str) -> bool:
    return str(sweep_id).startswith(_LOCAL_PREFIX) and os.path.exists(
        os.path.join(_sweep_dir(sweep_id, root), "sweep.yaml")
    )


def _sample_values(spec: Dict[str, Any], rng: np.random.Generator) -> Any:
    if "values" in spec:
        return spec["values"][int(rng.integers(len(spec["values"])))]
    if "value" in spec:
        return spec["value"]
    lo, hi = spec["min"], spec["max"]
    dist = spec.get("distribution", "uniform")
    if dist in ("log_uniform_values", "log_uniform"):
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if dist == "int_uniform" or (isinstance(lo, int) and isinstance(hi, int)):
        return int(rng.integers(lo, hi + 1))
    return float(rng.uniform(lo, hi))


def _trial_param_sets(cfg: Dict[str, Any], count: Optional[int], seed: int):
    """Yield trial override dicts per the sweep method."""
    params = cfg["parameters"]
    method = cfg.get("method", "grid")
    if method == "grid":
        keys, choice_lists = [], []
        for k, spec in params.items():
            if "values" in spec:
                keys.append(k)
                choice_lists.append(list(spec["values"]))
            elif "value" in spec:
                keys.append(k)
                choice_lists.append([spec["value"]])
            else:
                raise ValueError(
                    f"grid sweep parameter {k!r} needs 'values' (got {spec})"
                )
        combos = list(itertools.product(*choice_lists))
        if count is not None:
            combos = combos[:count]
        for combo in combos:
            yield dict(zip(keys, combo))
    else:  # random
        if count is None:
            raise ValueError("random sweeps need an explicit trial count")
        rng = np.random.default_rng(seed)
        for _ in range(count):
            yield {k: _sample_values(spec, rng) for k, spec in params.items()}


# ---------------------------------------------------------------------------
# the agent loop
# ---------------------------------------------------------------------------


def agent(
    sweep_id: str,
    function: Callable[[], Any],
    count: Optional[int] = None,
    root: str = ".",
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Run trials of ``sweep_id`` by calling ``function`` once per trial.

    The wandb.agent contract: ``function`` (typically
    ``Trainer.build_and_launch``) picks the trial params up itself — here
    via ``active_config()`` inside ``Trainer.build`` — so the same train
    path runs unmodified. Returns the trial records (also appended to
    ``<sweep_dir>/trials.jsonl``), each ``{trial, params, metric, best,
    last_metrics, seconds}``.
    """
    global _active
    d = _sweep_dir(sweep_id, root)
    with open(os.path.join(d, "sweep.yaml")) as f:
        cfg = yaml.safe_load(f)
    metric_name = (cfg.get("metric") or {}).get("name")
    goal = (cfg.get("metric") or {}).get("goal", "minimize")
    records = []
    trials_path = os.path.join(d, "trials.jsonl")
    for i, overrides in enumerate(_trial_param_sets(cfg, count, seed)):
        trial = _Trial(name=f"trial{i:03d}", config=overrides)
        with _lock:
            _active = trial
        t0 = time.time()
        try:
            function()
        finally:
            with _lock:
                _active = None
        series = [
            m[metric_name] for m in trial.metrics if metric_name and metric_name in m
        ]
        best = None
        if series:
            best = min(series) if goal == "minimize" else max(series)
        rec = {
            "trial": trial.name,
            "params": overrides,
            "metric": metric_name,
            "last": series[-1] if series else None,
            "best": best,
            "n_reports": len(trial.metrics),
            "seconds": round(time.time() - t0, 2),
        }
        records.append(rec)
        with open(trials_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return records


def best_trial(records: List[Dict[str, Any]], goal: str = "minimize"):
    scored = [r for r in records if r.get("best") is not None]
    if not scored:
        return None
    key = (lambda r: r["best"]) if goal == "minimize" else (lambda r: -r["best"])
    return min(scored, key=key)
