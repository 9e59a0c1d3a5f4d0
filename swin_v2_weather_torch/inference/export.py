"""Serving artifact: the forecast step as a ``torch.export`` program.

Counterpart of ``swin_v2_weather_tpu/inference/export.py``, which serializes
the jitted step as StableHLO. Here the unit is the engine's single step
(:class:`~swin_v2_weather_torch.inference.rollout.Stepper`) exported with
``torch.export.export``, the trained weights and the static conditioning
channels (orography, land mask) saved inside it:

    <dir>/stepper.pt2      ``torch.export.save`` of the ExportedProgram
    <dir>/manifest.json    inputs, output, grid, hours per step, add_zenith,
                           channel names, artifact bytes, format and device

The program's signature is ``(state[, zenith]) -> prediction`` over
normalized fields ([B, C_out, H, W] fp32, B fixed at export); the
autoregression stays in the serving loop. A CUDA program holds K1 and K3 as
calls of the custom ops ``swin::window_attention_qkv`` and ``swin::fc1_gelu``
(``ops/window_attention.py``, ``ops/mlp_kernels.py``), so serving needs those
two modules and no model code; a route whose kernels are not registered
(K5, K7-K12) raises at export, naming the route and the kernel. A CPU
program holds the plain versions' operations.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

ARTIFACT = "stepper.pt2"
MANIFEST = "manifest.json"


def export_stepper(engine, out_dir: str, batch: int = 1) -> dict:
    """Export ``engine``'s single forecast step, traced on the engine's device
    at batch ``batch`` (export once per serving batch shape), into
    ``out_dir``. Returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    h, w, n_out = engine.h, engine.w, engine.n_out
    specs = [("state", (batch, n_out, h, w))]
    if engine.add_zenith:
        specs.append(("zenith", (batch, 1, h, w)))
    args = tuple(torch.zeros(shape, dtype=torch.float32, device=engine.device)
                 for _, shape in specs)
    with torch.no_grad():
        program = torch.export.export(engine.stepper, args)
    program.example_inputs = None  # else saved too: a [B, 73, 720, 1440] state of zeros
    path = os.path.join(out_dir, ARTIFACT)
    torch.export.save(program, path)

    params = engine.params
    manifest = {
        "format": "torch.export",
        "device": engine.device.type,
        "inputs": [{"name": n, "shape": list(s), "dtype": "float32"} for n, s in specs],
        "output": {"shape": [batch, n_out, h, w], "dtype": "float32"},
        "grid": {"height": h, "width": w},
        "hours_per_step": engine.hours_per_step,
        "add_zenith": engine.add_zenith,
        "out_channels": [str(c) for c in getattr(params, "channel_names", [])] or None,
        "artifact_bytes": os.path.getsize(path),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServedStepper:
    """Runtime wrapper over a loaded stepper program."""

    def __init__(self, program, manifest: dict, device):
        self.program = program
        self.manifest = manifest
        self.device = torch.device(device)
        self._module = program.module()

    def __call__(self, state, zenith=None) -> torch.Tensor:
        args = (torch.as_tensor(state, dtype=torch.float32, device=self.device),)
        if self.manifest.get("add_zenith"):
            if zenith is None:
                raise ValueError("this artifact requires a zenith input")
            args += (torch.as_tensor(zenith, dtype=torch.float32, device=self.device),)
        with torch.no_grad():
            return self._module(*args)


def load_stepper(artifact_dir: str, device: Optional[str] = "cuda") -> ServedStepper:
    """Load ``export_stepper``'s artifact; no model code is imported, only the
    custom ops' registration. ``device`` must be the device type it was
    exported on (a program's constants and kernels stay where they were
    traced)."""
    # registers swin::window_attention_qkv and swin::fc1_gelu
    from swin_v2_weather_torch.ops import mlp_kernels, window_attention  # noqa: F401

    with open(os.path.join(artifact_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if torch.device(device).type != manifest["device"]:
        raise ValueError(f"the artifact was exported on {manifest['device']}; it cannot run "
                         f"on {device}")
    program = torch.export.load(os.path.join(artifact_dir, ARTIFACT))
    return ServedStepper(program, manifest, device)
