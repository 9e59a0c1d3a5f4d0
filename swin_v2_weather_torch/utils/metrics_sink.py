"""Pluggable experiment-metric sink (PyTorch port).

A copy of ``swin_v2_weather_tpu/utils/metrics_sink.py``: metrics always
stream to a JSON-lines file (one object per epoch), mirror to wandb only when
it is installed and enabled in the config, and report to the port's own
native sweep agent (``training/sweeps.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class MetricsSink:
    def __init__(self, exp_dir: str, enabled: bool = True, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict[str, Any]] = None):
        self.enabled = enabled
        self._fh = None
        self._wandb = None
        if not enabled:
            return
        os.makedirs(exp_dir, exist_ok=True)
        self._fh = open(os.path.join(exp_dir, "logs.jsonl"), "a", buffering=1)
        if use_wandb:
            try:
                import wandb

                if getattr(wandb, "run", None) is None:
                    wandb.init(dir=exp_dir, **(wandb_kwargs or {}))
                # else: a sweep agent already opened the trial run -- attach to it
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        record = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if step is not None:
            record["epoch"] = step
        self._fh.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        # native sweep agent (training/sweeps.py): no-op outside a trial
        from swin_v2_weather_torch.training import sweeps as _sweeps

        _sweeps.report(record)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
