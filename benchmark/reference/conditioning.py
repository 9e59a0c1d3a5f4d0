"""The model input's conditioning channels, written from their definitions.

  * cos of the solar zenith angle on the 0.25 degree grid at a UTC time, from
    the low-precision solar ephemeris (mean anomaly and ecliptic longitude
    series around J2000, Greenwich mean sidereal time, hour angle);
    longitudes 0, 360 / W, ...; latitudes from 90 down in steps of 180 / H
    (H even: the south pole row is left out);
  * the static block [landmask == 0, landmask == 1, orography]: the land
    mask one-hot, and the orography min-max scaled to [0, 1], then
    standardized (eps 1e-6), in float64.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

_J2000 = datetime.datetime(2000, 1, 1, 12, 0, 0)


def lat_lon(h: int, w: int):
    """(lon [H, W], lat [H, W]) in degrees."""
    lon = np.arange(0, 360, 360.0 / w)
    lat = np.linspace(90, -90, h) if h % 2 else np.linspace(90, -90, h + 1)[:h]
    return np.meshgrid(lon, lat)


def cos_zenith(when: datetime.datetime, h: int, w: int) -> np.ndarray:
    """[H, W] float64 cosine of the solar zenith angle at ``when`` (UTC)."""
    lon, lat = lat_lon(h, w)
    t = (when - _J2000).total_seconds() / 86400.0 / 36525.0  # Julian centuries
    anomaly = 6.240040768 + 628.301955 * t
    eclon = (4.894968 + 628.331951 * t + (0.033417 - 0.000084 * t) * np.sin(anomaly)
             + 0.000351 * np.sin(2.0 * anomaly))
    obliquity = 0.409093 - 0.000227 * t
    x, y = np.cos(eclon), np.cos(obliquity) * np.sin(eclon)
    z = np.sin(obliquity) * np.sin(eclon)
    r = np.sqrt(1.0 - z * z)
    dec = np.arctan2(z, r)
    ra = 2.0 * np.arctan2(y, x + r)
    gmst_deg = (67310.54841 + t * (876600 * 3600 + 8640184.812866
                                   + t * (0.093104 - t * 6.2e-6))) / 240.0
    hour_angle = np.deg2rad(gmst_deg) % (2.0 * np.pi) + np.deg2rad(lon) - ra
    lat_r = np.deg2rad(lat)
    return np.sin(dec) * np.sin(lat_r) + np.cos(dec) * np.cos(lat_r) * np.cos(hour_angle)


def static_block(landmask: np.ndarray, orography: np.ndarray) -> torch.Tensor:
    """[3, H, W] fp32: landmask one-hot (2), standardized orography (1)."""
    lsm = np.asarray(landmask).astype(np.int64)
    oro = np.asarray(orography, np.float64)
    oro = (oro - oro.min()) / (oro.max() - oro.min())
    oro = (oro - oro.mean()) / (oro.std() + 1.0e-6)
    return torch.from_numpy(np.stack([lsm == 0, lsm == 1, oro]).astype(np.float32))


def model_input(state: torch.Tensor, zenith: np.ndarray, static: torch.Tensor) -> torch.Tensor:
    """[B, C + 4, H, W]: the state, its zenith channel, the static block."""
    b = state.shape[0]
    zen = torch.as_tensor(zenith, dtype=torch.float32, device=state.device)
    zen = zen.reshape(1, 1, *zen.shape[-2:]).expand(b, -1, -1, -1)
    return torch.cat([state, zen, static.to(state.device)[None].expand(b, -1, -1, -1)], dim=1)
