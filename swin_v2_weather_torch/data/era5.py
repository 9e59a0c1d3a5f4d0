"""ERA5 HDF5 dataset: yearly files of shape [T, C, H, W] under key 'fields'.

A copy of ``swin_v2_weather_tpu/data/era5.py`` for the PyTorch port (the port
imports nothing of the JAX package), on the port's own
``ops/zenith.cos_zenith_angle``. Behavioral equivalent of the reference's
map-style loader (``utils/data_loader_era5.py``) merged with the per-year
bookkeeping of the DALI external source (``utils/dali_era5_es_helper.py``):

  * files discovered as sorted ``*.h5``, year parsed from the trailing four
    filename characters;
  * per-year sample counts and cumulative offsets with bisect lookup (leap
    years handled exactly);
  * year-boundary clamping: indices whose (n_future+1)-step target window
    would cross into the next year are clamped inside the year, and indices
    below ``dt`` are bumped up (``utils/data_loader_era5.py:157-161``);
  * per-channel-index selection and crop to ``img_size``;
  * normalization with ``global_means/stds.npy`` sliced by channel index,
    either on the host here or deferred to the device (the port's
    ``Preprocessor`` z-scores on the batch's device) via
    ``host_normalize: false``;
  * per-sample cosine zenith angle for the input time and every future
    target time.

The files' shapes are read by the pure-numpy HDF5 reader (``data/hdf5``),
so the native path needs no h5py. With ``use_native_loader`` 'auto' (the
default) the native pread reader (``data/native``) is used where it builds
and the files are contiguous fp32, else h5py, with a log line; where h5py is
not installed that fallback raises, naming the file and the reason.
``true`` raises instead of falling back. h5py is imported only by the
fallback's file handles, opened lazily per thread (h5py handles are not
thread-safe to share), so the threaded loader scales reads across a pool.
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import threading
from bisect import bisect_right
from typing import Tuple

import numpy as np

from swin_v2_weather_torch.data import hdf5
from swin_v2_weather_torch.ops.zenith import cos_zenith_angle

logger = logging.getLogger(__name__)


def is_leap_year(yr: int) -> bool:
    return yr % 4 == 0


def _require_h5py(reason: str) -> None:
    """Raise, naming ``reason``, where the h5py path is needed and h5py is
    not installed."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        raise RuntimeError(f"{reason}, and h5py, which the fallback path reads with, is not "
                           "installed") from None


def _fields_shape(path: str) -> Tuple[int, ...]:
    """The shape of ``fields``: the pure-numpy reader's, else (a file it
    refuses, e.g. chunked) h5py's where h5py is installed."""
    try:
        return hdf5.dataset_info(path, "fields")[1]
    except hdf5.Unsupported as e:
        _require_h5py(str(e))
    import h5py

    with h5py.File(path, "r") as f:
        return f["fields"].shape


class Era5Dataset:
    """Map-style dataset over yearly ERA5 HDF5 files.

    ``__getitem__`` returns numpy float32 arrays:
      (inp [C_in, H, W], tar [(n_future+1)*C_out, H, W])
      or with zenith: (inp, tar, zen_inp [1, H, W], zen_tar [n_future+1, H, W])
    """

    def __init__(self, params, location: str, train: bool):
        self.location = location
        self.train = train
        self.dt = int(params.dt)
        self.n_future = int(params.n_future)
        self.in_channels = np.asarray(params.in_channels)
        self.out_channels = np.asarray(params.out_channels)
        self.n_in = len(self.in_channels)
        self.n_out = len(self.out_channels)
        self.img_shape = (int(params.img_size[0]), int(params.img_size[1]))
        self.add_zenith = bool(params.add_zenith)
        self.normalize = bool(getattr(params, "host_normalize", True))

        self.means = np.load(params.global_means_path)[0, self.in_channels].astype(np.float32)
        self.stds = np.load(params.global_stds_path)[0, self.in_channels].astype(np.float32)
        self.out_means = np.load(params.global_means_path)[0, self.out_channels].astype(np.float32)
        self.out_stds = np.load(params.global_stds_path)[0, self.out_channels].astype(np.float32)

        self._scan_files()

        # native pread fast path (DALI replacement; data/native/): fuses
        # channel gather + crop + normalization, no h5py/GIL in the hot loop
        self._native = None
        want_native = getattr(params, "use_native_loader", "auto")
        if want_native in ("auto", True, "true", 1):
            try:
                from swin_v2_weather_torch.data.native.reader import NativeEra5Reader

                self._native = NativeEra5Reader(
                    self.files_paths,
                    n_threads=int(getattr(params, "native_io_threads", 4) or 4),
                )
                logger.info("using native pread reader for %s", self.location)
            except Exception as e:  # chunked files, no compiler, ...
                if want_native not in ("auto",):
                    raise
                _require_h5py(f"the native reader is unavailable for {self.location} ({e})")
                logger.info("native reader unavailable (%s); using h5py", e)
        else:
            _require_h5py(f"use_native_loader is {want_native!r} for {self.location}")

        if self.add_zenith:
            # ERA5 grid: lon 0..359.75, lat +90..-90 (north first)
            longitude = np.arange(0, 360, 360.0 / self.data_shape[1])
            latitude = np.linspace(90, -90, self.data_shape[0])
            self.lon_grid, self.lat_grid = np.meshgrid(longitude, latitude)

        # per-thread lazy file handles
        self._tls = threading.local()

    # -- file bookkeeping --------------------------------------------------
    def _scan_files(self) -> None:
        self.files_paths = sorted(glob.glob(os.path.join(self.location, "*.h5")))
        if not self.files_paths:
            raise FileNotFoundError(f"no *.h5 files under {self.location}")
        self.years = [
            int(os.path.splitext(os.path.basename(p))[0][-4:]) for p in self.files_paths
        ]
        self.n_years = len(self.files_paths)
        self.n_samples_year = []
        for p in self.files_paths:
            shape = _fields_shape(p)
            self.n_samples_year.append(shape[0])
        self.data_shape = (shape[2], shape[3])
        assert self.img_shape[0] <= shape[2] and self.img_shape[1] <= shape[3], (
            "image shapes are greater than dataset image shapes"
        )
        self.year_offsets = np.concatenate([[0], np.cumsum(self.n_samples_year)[:-1]]).tolist()
        self.n_samples_total = int(sum(self.n_samples_year))
        self.img_shape_x, self.img_shape_y = self.img_shape
        logger.info(
            "Found data at %s: %d samples over %d years, grid %dx%d, %d channels in",
            self.location, self.n_samples_total, self.n_years,
            self.img_shape[0], self.img_shape[1], self.n_in,
        )

    def __len__(self) -> int:
        return self.n_samples_total

    def _handle(self, year_idx: int):
        import h5py

        files = getattr(self._tls, "files", None)
        if files is None:
            files = [None] * self.n_years
            self._tls.files = files
        if files[year_idx] is None:
            files[year_idx] = h5py.File(self.files_paths[year_idx], "r")["fields"]
        return files[year_idx]

    # -- index math ---------------------------------------------------------
    def locate(self, global_idx: int) -> Tuple[int, int]:
        """global index -> (year_idx, clamped local index)."""
        year_idx = bisect_right(self.year_offsets, global_idx) - 1
        local_idx = global_idx - self.year_offsets[year_idx]
        step = self.dt
        n_year = self.n_samples_year[year_idx]
        # boundary conditions (reference utils/data_loader_era5.py:157-161)
        local_idx = local_idx % (n_year - step * (self.n_future + 1))
        if local_idx < step:
            local_idx += step
        return year_idx, local_idx

    # -- zenith -------------------------------------------------------------
    def _zenith(self, local_idx: int, year_idx: int, time_step_hours: int = 6):
        year = self.years[year_idx]
        jan01 = datetime.datetime(year, 1, 1, 0, 0, 0)

        def calc(start: int, end: int) -> np.ndarray:
            out = []
            for idx in range(start, end, self.dt):
                t = jan01 + datetime.timedelta(hours=idx * time_step_hours)
                out.append(cos_zenith_angle(t, self.lon_grid, self.lat_grid).astype(np.float32))
            return np.stack(out, axis=0)

        zen_inp = calc(local_idx, local_idx + 1)
        zen_tar = calc(local_idx + self.dt, local_idx + self.dt * (self.n_future + 1) + 1)
        return zen_inp, zen_tar

    # -- sample assembly ----------------------------------------------------
    def _read(self, ds, frames, channels: np.ndarray) -> np.ndarray:
        """``ds[frames, channels, :sx, :sy]`` through h5py: a slice when the
        channels are contiguous (faster), else their sorted distinct indices
        (h5py reads only increasing ones), then taken into the asked order.
        The JAX package's h5py path raises on a decreasing channel list, e.g.
        ``out_channels: [4, 0]``; its native path and this one read it."""
        sx, sy = self.img_shape
        c = channels
        if len(c) > 0 and np.array_equal(c, np.arange(c[0], c[0] + len(c))):
            return ds[frames, slice(int(c[0]), int(c[0] + len(c))), 0:sx, 0:sy]
        uniq, inverse = np.unique(c, return_inverse=True)
        block = ds[frames, [int(i) for i in uniq], 0:sx, 0:sy]
        return block if np.array_equal(uniq, c) else np.take(block, inverse, axis=-3)

    def read_output_frame(self, year_idx: int, local_idx: int) -> np.ndarray:
        """One [C_out, H, W] frame (normalized if host_normalize) — used by
        the rollout scorer to stream verification targets."""
        sx, sy = self.img_shape
        if self._native is not None:
            stats = (
                (self.out_means[:, 0, 0], self.out_stds[:, 0, 0])
                if self.normalize
                else (None, None)
            )
            return self._native.read(year_idx, local_idx, self.out_channels, (sx, sy), *stats)
        ds = self._handle(year_idx)
        tar = self._read(ds, local_idx, self.out_channels).astype(np.float32)
        if self.normalize:
            tar = (tar - self.out_means[:, :1, :1]) / self.out_stds[:, :1, :1]
        return tar

    @property
    def sample_shapes(self):
        """Per-sample output shapes, keyed like the loader batches. Lets the
        loader preallocate a fixed ring of batch buffers (``read_into``) —
        per-sample fresh 300 MB allocations pay a first-touch page-fault tax
        (~100 us/fault on some kernels = tens of seconds per sample; see
        ROADMAP 'input pipeline')."""
        sx, sy = self.img_shape
        shapes = {
            "inp": (self.n_in, sx, sy),
            "tar": (self.n_out * (self.n_future + 1), sx, sy),
        }
        if self.add_zenith:
            shapes["zen_inp"] = (1, sx, sy)
            shapes["zen_tar"] = (self.n_future + 1, sx, sy)
        return shapes

    def read_into(self, global_idx: int, out) -> None:
        """Fill ``out`` (dict of preallocated fp32 arrays shaped per
        ``sample_shapes``) with sample ``global_idx`` — the zero-allocation
        hot path used by the pooled loader. The native reader writes
        directly into the destination rows; the h5py fallback assigns."""
        year_idx, local_idx = self.locate(int(global_idx))
        step = self.dt
        sx, sy = self.img_shape
        inp, tar = out["inp"], out["tar"]
        tar4 = tar.reshape(self.n_future + 1, self.n_out, sx, sy)

        if self._native is not None:
            in_stats = (self.means[:, 0, 0], self.stds[:, 0, 0]) if self.normalize else (None, None)
            out_stats = (
                (self.out_means[:, 0, 0], self.out_stds[:, 0, 0])
                if self.normalize
                else (None, None)
            )
            self._native.read(
                year_idx, local_idx, self.in_channels, (sx, sy), *in_stats, out=inp
            )
            self._native.read_frames(
                year_idx, local_idx + step, step, self.n_future + 1,
                self.out_channels, (sx, sy), *out_stats, out=tar4,
            )
        else:
            ds = self._handle(year_idx)
            inp[...] = self._read(ds, local_idx, self.in_channels)
            tar4[...] = self._read(
                ds, slice(local_idx + step, local_idx + step * (self.n_future + 1) + 1, step),
                self.out_channels,
            )
            if self.normalize:
                inp -= self.means[:, :1, :1]
                inp /= self.stds[:, :1, :1]
                tar4 -= self.out_means[None, :, :1, :1]
                tar4 /= self.out_stds[None, :, :1, :1]

        if self.add_zenith:
            zen_inp, zen_tar = self._zenith(local_idx, year_idx)
            out["zen_inp"][...] = zen_inp[:, :sx, :sy]
            out["zen_tar"][...] = zen_tar[:, :sx, :sy]

    def __getitem__(self, global_idx: int):
        out = {k: np.empty(s, np.float32) for k, s in self.sample_shapes.items()}
        self.read_into(global_idx, out)
        if self.add_zenith:
            return out["inp"], out["tar"], out["zen_inp"], out["zen_tar"]
        return out["inp"], out["tar"]
