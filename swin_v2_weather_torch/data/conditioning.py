"""Static conditioning inputs: orography and land-sea mask (host-side numpy).

Counterpart of ``swin_v2_weather_tpu/data/conditioning.py``, copied so that
the port never imports the JAX package:

  * ``get_orography(path)`` reads variable ``"Z"`` (surface geopotential,
    first time slice) and min-max normalizes it to [0, 1];
  * ``get_land_mask(path)`` reads variable ``"LSM"`` in [0, 1];
  * ``static_features(params)`` assembles [landmask one-hot (2), orography
    (1)], with deterministic synthetic fields where no file exists.

``.npy`` files are accepted as well as HDF5-backed NetCDF-4 files, read by
the pure-numpy HDF5 reader (``data/hdf5``), or by h5py where that reader
refuses the variable (chunked, compressed) and h5py is installed.
"""

from __future__ import annotations

import os

import numpy as np

from swin_v2_weather_torch.data import hdf5


def _read_var(path: str, varname: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    with hdf5.open_dataset(path, varname) as ds:
        return np.array(ds)


def get_orography(orography_path: str) -> np.ndarray:
    """Surface geopotential [H, W], min-max normalized to [0, 1]."""
    z = _read_var(orography_path, "Z")
    if z.ndim == 3:
        z = z[0]
    z = np.asarray(z, dtype=np.float64)
    return ((z - z.min()) / (z.max() - z.min())).astype(np.float32)


def get_land_mask(land_mask_path: str) -> np.ndarray:
    """Land-sea mask [H, W] with values in [0, 1]."""
    lsm = _read_var(land_mask_path, "LSM")
    if lsm.ndim == 3:
        lsm = lsm[0]
    return np.asarray(lsm, dtype=np.float32)


def static_features(params) -> np.ndarray | None:
    """Assemble the static conditioning block [n_static, H, W] (or None).

    One-hot land mask (2 channels) first, then z-scored orography (1
    channel): the land mask is cast to integer before one-hot encoding and
    the min-max normalized orography is re-standardized to zero mean / unit
    variance with eps 1e-6.
    """
    imgx, imgy = int(params.img_size[0]), int(params.img_size[1])
    feats = []
    if params.add_landmask:
        if os.path.exists(str(params.landmask_path)):
            lsm = get_land_mask(params.landmask_path).astype(np.int64)
        else:
            lsm = _synthetic_landmask(imgx, imgy)
        onehot = np.stack([(lsm == 0), (lsm == 1)]).astype(np.float32)
        feats.append(onehot[:, :imgx, :imgy])
    if params.add_orography:
        if os.path.exists(str(params.orography_path)):
            oro = get_orography(params.orography_path)[:imgx, :imgy].astype(np.float64)
        else:
            oro = _synthetic_orography(imgx, imgy)
        oro = (oro - oro.mean()) / (oro.std() + 1.0e-6)
        feats.append(oro[None].astype(np.float32))
    if not feats:
        return None
    return np.concatenate(feats, axis=0)


def _synthetic_landmask(h: int, w: int) -> np.ndarray:
    """Deterministic fake land mask for synthetic-data runs (no file needed)."""
    rng = np.random.default_rng(13)
    lows = rng.standard_normal((h // 8 + 1, w // 8 + 1))
    mask = np.kron(lows, np.ones((8, 8)))[:h, :w]
    return (mask > 0.4).astype(np.int64)


def _synthetic_orography(h: int, w: int) -> np.ndarray:
    """Deterministic fake orography in [0, 1] for synthetic-data runs."""
    y = np.linspace(0, 4 * np.pi, h)[:, None]
    x = np.linspace(0, 8 * np.pi, w)[None, :]
    z = np.sin(y) * np.cos(x) + 0.5 * np.sin(3 * y + 1.0) * np.sin(2 * x + 0.5)
    return ((z - z.min()) / (z.max() - z.min())).astype(np.float64)
