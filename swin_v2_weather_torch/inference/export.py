"""Serving artifact: the forecast step as ``torch.export`` programs.

Counterpart of ``swin_v2_weather_tpu/inference/export.py``, which serializes
the jitted step as StableHLO for one or more lowering platforms. Here the
unit is the engine's single step
(:class:`~swin_v2_weather_torch.inference.rollout.Stepper`) exported with
``torch.export.export``, once per platform, the trained weights and the
static conditioning channels (orography, land mask) saved inside each
program:

    <dir>/stepper.<platform>.pt2   ``torch.export.save`` of the program
                                   traced on that platform ("cuda", "cpu")
    <dir>/manifest.json            inputs, output, grid, hours per step,
                                   add_zenith, channel names, platforms,
                                   artifact bytes, format and device

The program's signature is ``(state[, zenith]) -> prediction`` over
normalized fields ([B, C_out, H, W] fp32, B fixed at export); the
autoregression stays in the serving loop. A CUDA program holds every
forward kernel of the model's route as a call of its custom op (``swin::
<launcher>``, defined beside the launcher: K1, K3, K5, K7-K12), so serving
needs the four op modules and no model code. A CPU program holds the plain
versions' operations: the entry points dispatch on the device.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional, Sequence

import torch

PLATFORMS = ("cuda", "cpu")  # the platforms a program can be traced for
ARTIFACT = "stepper.{}.pt2"
MANIFEST = "manifest.json"


def _platforms(engine, platforms: Optional[Sequence[str]]) -> list:
    """The requested platforms in order, once each (default: the engine's
    device type), or raise naming the ones the port takes."""
    want = [engine.device.type] if platforms is None else list(dict.fromkeys(platforms))
    bad = [p for p in want if p not in PLATFORMS]
    if bad or not want:
        raise ValueError(f"export_stepper: no program for platforms {bad or want}; the port "
                         f"traces {list(PLATFORMS)}")
    return want


def export_stepper(engine, out_dir: str, batch: int = 1,
                   platforms: Optional[Sequence[str]] = None) -> dict:
    """Export ``engine``'s single forecast step at batch ``batch`` (export
    once per serving batch shape) into ``out_dir``: one program per platform
    of ``platforms`` (default: the engine's device type). The engine's own
    stepper is traced on its device; another platform's program is traced
    from a copy of it on that platform. Returns the manifest."""
    want = _platforms(engine, platforms)
    os.makedirs(out_dir, exist_ok=True)
    h, w, n_out = engine.h, engine.w, engine.n_out
    specs = [("state", (batch, n_out, h, w))]
    if engine.add_zenith:
        specs.append(("zenith", (batch, 1, h, w)))
    artifacts = {}
    for platform in want:
        if platform == engine.device.type:
            stepper, device = engine.stepper, engine.device
        else:
            device = torch.device(platform)
            stepper = copy.deepcopy(engine.stepper).to(device).eval()
        args = tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                     for _, shape in specs)
        with torch.no_grad():
            program = torch.export.export(stepper, args)
        program.example_inputs = None  # else saved too: a [B, 73, 720, 1440] state of zeros
        name = ARTIFACT.format(platform)
        torch.export.save(program, os.path.join(out_dir, name))
        artifacts[platform] = {"file": name,
                               "bytes": os.path.getsize(os.path.join(out_dir, name))}
        del program, stepper

    params = engine.params
    manifest = {
        "format": "torch.export",
        "device": engine.device.type,
        "platforms": want,
        "artifacts": artifacts,
        "inputs": [{"name": n, "shape": list(s), "dtype": "float32"} for n, s in specs],
        "output": {"shape": [batch, n_out, h, w], "dtype": "float32"},
        "grid": {"height": h, "width": w},
        "hours_per_step": engine.hours_per_step,
        "add_zenith": engine.add_zenith,
        "out_channels": [str(c) for c in getattr(params, "channel_names", [])] or None,
        "artifact_bytes": sum(a["bytes"] for a in artifacts.values()),
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
    """Load the program of ``device``'s type from ``export_stepper``'s
    artifact; no model code is imported, only the custom ops' registration.
    Raises, naming both, where the artifact has no program for that type (a
    program's constants and kernels stay where they were traced)."""
    # registers the swin:: custom ops of every forward kernel
    from swin_v2_weather_torch.ops import ln_kernels, mlp_kernels, window_attention  # noqa: F401
    from swin_v2_weather_torch.ops.attic import window_attention_v45  # noqa: F401

    with open(os.path.join(artifact_dir, MANIFEST)) as f:
        manifest = json.load(f)
    platform = torch.device(device).type
    if platform not in manifest["platforms"]:
        raise ValueError(f"the artifact was exported on {', '.join(manifest['platforms'])}; it "
                         f"has no program for {device}")
    program = torch.export.load(os.path.join(artifact_dir,
                                             manifest["artifacts"][platform]["file"]))
    return ServedStepper(program, manifest, device)
