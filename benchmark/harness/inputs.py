"""Everything a run feeds the program, made from the seed.

The same seed gives the same inputs: static fields, statistics, train
batches, initial states, start dates, targets and the climatology. Large
fields are drawn on the device in a few calls; the few the program reads
from files (the land mask, the orography, the loss's statistics) are
written as ``.npy`` files into the run's scratch directory.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import conditioning


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds derived from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
            >> np.uint64(1)]


def smooth(gen: torch.Generator, n: int, h: int, w: int, device, coarse: int = 8) -> torch.Tensor:
    """[n, h, w] unit-variance fields, smooth on ``coarse``-cell scales."""
    z = torch.randn((n, 1, -(-h // coarse) + 1, -(-w // coarse) + 1), generator=gen,
                    device=device)
    z = F.interpolate(z, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    return z / z.std(dim=(-2, -1), keepdim=True)


class Fields:
    """The run's static fields and statistics, and the files the program
    reads them from (``files``: config key -> path)."""

    def __init__(self, cfg: dict, seed: int, device, scratch: str):
        h, w = (int(s) for s in cfg["img_size"])
        c = len(cfg["out_channels"])
        gen = torch.Generator(device=device).manual_seed(int(seed))
        f = smooth(gen, 2, h, w, device).cpu().numpy()
        self.landmask = (f[0] > 0.4).astype(np.float32)
        self.orography = np.clip(2000.0 * f[1] + 1000.0, 0.0, None).astype(np.float32)
        u = torch.rand((4, c), generator=gen, device=device, dtype=torch.float64).cpu().numpy()
        self.means = (200.0 * (u[0] - 0.5)).reshape(c, 1, 1)  # physical units
        self.stds = (0.5 + 20.0 * u[1]).reshape(c, 1, 1)
        self.global_stds = 0.5 + 1.5 * u[2]  # the loss's statistics
        self.diff_stds = self.global_stds * (0.2 + 0.4 * u[3])
        os.makedirs(scratch, exist_ok=True)
        self.files = {}
        for key, arr in (("landmask_path", self.landmask), ("orography_path", self.orography),
                         ("global_stds_path", self.global_stds.reshape(1, c, 1, 1)),
                         ("time_diff_stds_path", self.diff_stds.reshape(1, c, 1, 1))):
            path = os.path.join(scratch, key.replace("_path", ".npy"))
            np.save(path, arr)
            self.files[key] = path
        self.static = conditioning.static_block(self.landmask, self.orography)


def start_dates(seed: int, n: int) -> List[datetime.datetime]:
    """``n`` 6-hourly UTC start times in 2016-2020."""
    rng = np.random.default_rng(int(seed))
    base = datetime.datetime(2016, 1, 1)
    return [base + datetime.timedelta(hours=6 * int(k)) for k in rng.integers(0, 4 * 1826, n)]


def train_pool(cfg: dict, n: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``n`` batches of one sample: normalized state, a target near it, and
    the zenith channels of the input's and the target's times."""
    h, w = (int(s) for s in cfg["img_size"])
    c = len(cfg["out_channels"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pool = []
    for when in start_dates(seed, n):
        inp = torch.randn((1, c, h, w), generator=gen, device=device)
        tar = inp + 0.3 * torch.randn((1, c, h, w), generator=gen, device=device)
        zen = [torch.as_tensor(conditioning.cos_zenith(t, h, w), dtype=torch.float32,
                               device=device).reshape(1, 1, h, w)
               for t in (when, when + datetime.timedelta(hours=6 * int(cfg["dt"])))]
        pool.append({"inp": inp, "tar": tar, "zen_inp": zen[0], "zen_tar": zen[1]})
    return pool


def target_pool(cfg: dict, n: int, seed: int, device) -> List[np.ndarray]:
    """``n`` normalized [1, C, H, W] fp32 fields on the host (the archive's
    frames, as the scoring CLI hands them over)."""
    h, w = (int(s) for s in cfg["img_size"])
    c = len(cfg["out_channels"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.randn((1, c, h, w), generator=gen, device=device).cpu().numpy()
            for _ in range(n)]


def climatology(fields: Fields, cfg: dict, seed: int, device) -> np.ndarray:
    """[C, H, W] fp32 time-mean fields in physical units."""
    h, w = (int(s) for s in cfg["img_size"])
    c = len(cfg["out_channels"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    anom = smooth(gen, c, h, w, device, coarse=32).cpu().numpy()
    return (fields.means + 0.5 * fields.stds * anom).astype(np.float32)


def initial_state(cfg: dict, seed: int, device) -> torch.Tensor:
    """A normalized [1, C, H, W] initial state."""
    h, w = (int(s) for s in cfg["img_size"])
    c = len(cfg["out_channels"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((1, c, h, w), generator=gen, device=device)
