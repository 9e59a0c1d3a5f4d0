"""Synthetic ERA5-shaped dataset (host-side numpy).

Counterpart of ``swin_v2_weather_tpu/data/synthetic.py``, copied so that the
port never imports the JAX package: deterministic pseudo-random unit-variance
fields with the shapes of the ERA5 yearly archives, and per-sample zenith
channels computed from real timestamps (sample i starts at
2018-01-01T00:00 + 6 h * i), so the preprocessor, the model and the loss run
their true code paths without data files. :func:`collate` stacks samples into
the batch dict the train step takes outside the loader (the Trainer reads
batches through ``data/pipeline.ThreadedLoader``).
"""

from __future__ import annotations

import datetime
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from swin_v2_weather_torch.ops.zenith import cos_zenith_angle


class SyntheticDataset:
    """Deterministic random fields shaped like the ERA5 yearly archives."""

    def __init__(self, params, location: str = "", train: bool = True, n_samples: int = 64):
        self.train = train
        self.dt = int(params.dt)
        self.n_future = int(params.n_future)
        self.n_in = len(params.in_channels)
        self.n_out = len(params.out_channels)
        self.img_shape = (int(params.img_size[0]), int(params.img_size[1]))
        self.img_shape_x, self.img_shape_y = self.img_shape
        self.add_zenith = bool(params.add_zenith)
        self.n_samples_total = int(getattr(params, "n_synthetic_samples", n_samples))
        self._base_seed = int(getattr(params, "seed", 333) or 333) + (0 if train else 7919)

        if self.add_zenith:
            h, w = self.img_shape
            longitude = np.arange(0, 360, 360.0 / w)
            latitude = np.linspace(90, -90, h)
            self.lon_grid, self.lat_grid = np.meshgrid(longitude, latitude)

    def __len__(self) -> int:
        return self.n_samples_total

    def _field(self, seed: int, channels: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.standard_normal((channels,) + self.img_shape, dtype=np.float32)

    def _zenith(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        t0 = datetime.datetime(2018, 1, 1) + datetime.timedelta(hours=6 * idx)
        zen_inp = cos_zenith_angle(t0, self.lon_grid, self.lat_grid).astype(np.float32)[None]
        zen_tar = np.stack([
            cos_zenith_angle(
                t0 + datetime.timedelta(hours=6 * self.dt * (s + 1)), self.lon_grid, self.lat_grid
            ).astype(np.float32)
            for s in range(self.n_future + 1)
        ])
        return zen_inp, zen_tar

    def __getitem__(self, idx: int):
        idx = int(idx)
        inp = self._field(self._base_seed + idx * 31, self.n_in)
        tar = np.concatenate([
            self._field(self._base_seed + (idx + self.dt * (s + 1)) * 31, self.n_out)
            for s in range(self.n_future + 1)
        ], axis=0)
        if self.add_zenith:
            zen_inp, zen_tar = self._zenith(idx)
            return inp, tar, zen_inp, zen_tar
        return inp, tar


_KEYS = ("inp", "tar", "zen_inp", "zen_tar")


def collate(samples: Sequence[tuple], device="cuda") -> Dict[str, torch.Tensor]:
    """Stack dataset samples into a batch dict of fp32 tensors on ``device``
    (the GPU unless the caller asks for another)."""
    return {
        key: torch.as_tensor(np.stack([s[i] for s in samples]), device=device)
        for i, key in enumerate(_KEYS[: len(samples[0])])
    }
