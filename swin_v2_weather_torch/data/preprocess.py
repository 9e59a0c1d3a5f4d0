"""Per-batch input assembly: zenith + static conditioning channels.

Counterpart of ``swin_v2_weather_tpu/data/preprocess.py``: concatenate the
solar-zenith channel to the input, then the static features (one-hot land
mask, z-scored orography), and pass the future zenith frames through for the
multi-step wrapper. With ``host_normalize: false`` the raw fields are z-scored
here, on the batch's device, from the global means and stds files.

Input channel layout after assembly:

    [era5 data (C) | zenith (1) | landmask one-hot (2) | orography (1)]
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swin_v2_weather_torch.data.conditioning import static_features


class Preprocessor:
    """Callable batch -> (inp, tar, tzen), all fp32 on the batch's device.

    The batch is a dict of tensors with keys ``inp`` [B, C, H, W], ``tar``
    [B, C', H, W] and, when ``params.add_zenith``, ``zen_inp`` [B, 1, H, W]
    and ``zen_tar`` [B, n_future+1, H, W]. The static block and the
    normalization stats are built once on the host and moved to the batch's
    device on first use there.
    """

    def __init__(self, params):
        self.add_zenith = bool(params.add_zenith)
        static = static_features(params)
        self._consts: Dict[str, torch.Tensor] = {}
        if static is not None:
            self._consts["static"] = torch.as_tensor(static[None], dtype=torch.float32)

        self.device_normalize = not bool(getattr(params, "host_normalize", True))
        if self.device_normalize:
            if not os.path.exists(str(params.global_means_path)):
                raise FileNotFoundError("host_normalize=false requires global_means/stds files")
            in_ch = np.asarray(params.in_channels)
            out_ch = np.asarray(params.out_channels)
            n_fut = int(getattr(params, "n_future", 0) or 0)
            means = np.load(params.global_means_path)[0]
            stds = np.load(params.global_stds_path)[0]
            f32 = dict(dtype=torch.float32)
            self._consts["in_means"] = torch.as_tensor(means[in_ch][None], **f32)
            self._consts["in_stds"] = torch.as_tensor(stds[in_ch][None], **f32)
            # targets have (n_future+1) steps flattened into channels
            self._consts["out_means"] = torch.as_tensor(
                np.tile(means[out_ch], (n_fut + 1, 1, 1))[None], **f32
            )
            self._consts["out_stds"] = torch.as_tensor(
                np.tile(stds[out_ch], (n_fut + 1, 1, 1))[None], **f32
            )

    def _const(self, name: str, device: torch.device) -> torch.Tensor:
        t = self._consts[name]
        if t.device != device:
            t = self._consts[name] = t.to(device)
        return t

    def __call__(
        self, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        inp = batch["inp"].float()
        tar = batch["tar"].float()
        dev = inp.device
        if self.device_normalize:
            inp = (inp - self._const("in_means", dev)) / self._const("in_stds", dev)
            tar = (tar - self._const("out_means", dev)) / self._const("out_stds", dev)
        tzen = None
        if self.add_zenith:
            inp = torch.cat([inp, batch["zen_inp"].float()], dim=1)
            tzen = batch["zen_tar"].float()
        if "static" in self._consts:
            static = self._const("static", dev)
            inp = torch.cat([inp, static.expand(inp.shape[0], -1, -1, -1)], dim=1)
        return inp, tar, tzen


def derived_channel_counts(params) -> Tuple[int, int]:
    """(n_in_channels, n_out_channels) after conditioning channels."""
    n_in = len(params.in_channels)
    if params.add_zenith:
        n_in += 1
    if params.add_landmask:
        n_in += 2
    if params.add_orography:
        n_in += 1
    return n_in, len(params.out_channels)
