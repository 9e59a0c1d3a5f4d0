"""Compute the normalization/climatology statistics the framework consumes.

A copy of ``swin_v2_weather_tpu/data/stats.py`` for the PyTorch port (host
numpy; the files are read by the pure-numpy HDF5 reader, ``data/hdf5``, or by
h5py where that reader refuses a file and h5py is installed).

The reference never computes its stats in-repo — it points users at
precomputed ``global_means.npy`` / ``global_stds.npy`` / ``time_means.npy``
/ ``time_diff_stds.npy`` artifacts on the NERSC portal (reference
``README.md:19-25``), leaving anyone with their own ERA5 archive stuck.
This module closes that gap: one streaming pass over a yearly-HDF5 archive
(``[T, C, H, W]`` under key ``fields``, the layout of
``utils/data_loader_era5.py``) produces all four files with
reference-compatible shapes:

  * ``global_means.npy``    [1, C, 1, 1] — per-channel mean over (t, h, w)
  * ``global_stds.npy``     [1, C, 1, 1] — per-channel std over (t, h, w)
  * ``time_means.npy``      [1, C, H, W] — per-pixel time-mean climatology
                            (the ACC anomaly reference in scoring)
  * ``time_diff_stds.npy``  [1, C, 1, 1] — per-channel std of one-frame
                            temporal differences x[t+1]-x[t] (the temp-std
                            loss weighting, ``utils/losses.py:89-97``;
                            differences are taken within each year only, so
                            no cross-file frame pairing is implied)

Accumulation is fp64 (sum / sum-of-squares + per-pixel sums), streamed in
time-chunks so memory stays at a few frames regardless of archive size.

CLI:  python -m swin_v2_weather_torch.data.stats /data/era5/train out/stats \\
          [--chunk 8] [--key fields]
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from swin_v2_weather_torch.data import hdf5

logger = logging.getLogger(__name__)


def compute_archive_stats(
    data_dir: str,
    chunk: int = 8,
    key: str = "fields",
    files: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    """Stream an ERA5 yearly-HDF5 archive and return the four stat arrays.

    Args:
      data_dir: directory of ``*.h5``/``*.hdf5`` files (sorted by name, the
        same ordering the loaders use).
      chunk: frames per read (memory = 2*chunk frames).
      key: HDF5 dataset name.
      files: explicit file list (overrides the directory glob).

    Returns dict with keys ``global_means``, ``global_stds``,
    ``time_means``, ``time_diff_stds`` in reference shapes.
    """
    if files is None:
        files = sorted(
            glob.glob(os.path.join(data_dir, "*.h5"))
            + glob.glob(os.path.join(data_dir, "*.hdf5"))
        )
    if not files:
        raise FileNotFoundError(f"no HDF5 files under {data_dir}")

    n = 0  # frames
    s = ss = None  # [C] fp64 sum / sum of squares over (t, h, w)
    pix_sum = None  # [C, H, W] fp64 per-pixel sum over t
    nd = 0  # difference pairs
    ds = dss = None  # [C] fp64 sums for x[t+1]-x[t]
    npix = None

    for path in files:
        with hdf5.open_dataset(path, key) as dset:
            t, c, h, w = dset.shape
            if pix_sum is None:
                s = np.zeros(c, np.float64)
                ss = np.zeros(c, np.float64)
                ds = np.zeros(c, np.float64)
                dss = np.zeros(c, np.float64)
                pix_sum = np.zeros((c, h, w), np.float64)
                npix = float(h * w)
            prev_tail = None  # last frame of the previous chunk (same file)
            for t0 in range(0, t, int(chunk)):
                block = np.asarray(dset[t0 : t0 + int(chunk)], np.float64)
                s += block.sum(axis=(0, 2, 3))
                ss += (block**2).sum(axis=(0, 2, 3))
                pix_sum += block.sum(axis=0)
                n += block.shape[0]
                if prev_tail is not None:
                    block_d = np.concatenate([prev_tail, block], axis=0)
                else:
                    block_d = block
                if block_d.shape[0] > 1:
                    d = np.diff(block_d, axis=0)
                    ds += d.sum(axis=(0, 2, 3))
                    dss += (d**2).sum(axis=(0, 2, 3))
                    nd += d.shape[0]
                prev_tail = block[-1:]
        logger.info("stats: consumed %s (%d frames total)", os.path.basename(path), n)

    cnt = n * npix
    mean = s / cnt
    var = np.maximum(ss / cnt - mean**2, 0.0)
    dcnt = max(nd, 1) * npix
    dmean = ds / dcnt
    dvar = np.maximum(dss / dcnt - dmean**2, 0.0)
    return {
        "global_means": mean.reshape(1, -1, 1, 1).astype(np.float32),
        "global_stds": np.sqrt(var).reshape(1, -1, 1, 1).astype(np.float32),
        "time_means": (pix_sum / n)[None].astype(np.float32),
        "time_diff_stds": np.sqrt(dvar).reshape(1, -1, 1, 1).astype(np.float32),
    }


def write_stats(stats: Dict[str, np.ndarray], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in stats.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)


def main():
    from swin_v2_weather_torch.utils.logging_utils import config_logger

    config_logger()
    p = argparse.ArgumentParser(description="compute ERA5 archive statistics")
    p.add_argument("data_dir", help="directory of yearly HDF5 files")
    p.add_argument("out_dir", help="output directory for the four .npy files")
    p.add_argument("--chunk", type=int, default=8, help="frames per read")
    p.add_argument("--key", default="fields", help="HDF5 dataset name")
    args = p.parse_args()
    stats = compute_archive_stats(args.data_dir, chunk=args.chunk, key=args.key)
    write_stats(stats, args.out_dir)
    c = stats["global_means"].shape[1]
    logger.info(
        "wrote %s (%d channels, time_means %s)", args.out_dir, c,
        stats["time_means"].shape,
    )


if __name__ == "__main__":
    main()
