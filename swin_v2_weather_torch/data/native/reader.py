"""ctypes bindings for the native ERA5 reader (era5_native.cpp).

A copy of ``swin_v2_weather_tpu/data/native/reader.py`` for the PyTorch port,
over the port's own copy of the C++ source. The pure-numpy HDF5 reader
(``data/hdf5``; no h5py) resolves each file's contiguous dataset, its byte
offset and shape, once at open time; every subsequent sample read is served
by the C++ pread thread pool with normalization fused into the copy. Files
that are chunked, compressed, unwritten or not fp32 (no stable byte offset
of fp32 frames) are reported ineligible and the caller falls back to the
h5py path.

The shared library is compiled from source with g++ at first use (never at
import) into ``swin_v2_weather_torch/_build/`` (``BUILD_DIR``), not beside
the source; the artifact name carries a content hash of the source, so a
stale or foreign binary can never be loaded. This is host I/O, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from swin_v2_weather_torch.data import hdf5

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "era5_native.cpp")
# the port's build directory (the nvcc kernels' too), which .gitignore lists
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_build_lock = threading.Lock()
_lib = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"era5_native-{digest}.so")


def _build(so_path: str) -> bool:
    tmp = so_path + f".tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        logger.warning("native reader build failed: %s", getattr(e, "stderr", e))
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            if not _build(so):
                return None
        lib = ctypes.CDLL(so)
        lib.era5_create.restype = ctypes.c_void_p
        lib.era5_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.era5_destroy.argtypes = [ctypes.c_void_p]
        lib.era5_read_sample.restype = ctypes.c_int
        lib.era5_read_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.era5_read_frames.restype = ctypes.c_int
        lib.era5_read_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _probe(paths: Sequence[str], dataset: str):
    """((offsets, dims), None) for contiguous uncompressed fp32 datasets, or
    (None, the reason naming the first file that is not)."""
    offsets, dims = [], []
    for p in paths:
        try:
            off, shape, dtype = hdf5.dataset_info(p, dataset)
        except hdf5.Unsupported as e:
            return None, str(e)
        if dtype != np.float32:
            return None, f"{p}: {dataset!r} is {dtype}, not float32"
        offsets.append(int(off))
        dims.append([int(s) for s in shape])
    return (np.asarray(offsets, np.int64), np.asarray(dims, np.int64)), None


def probe_files(paths: Sequence[str], dataset: str = "fields"):
    """(offsets, dims) for contiguous uncompressed fp32 datasets, or None."""
    return _probe(paths, dataset)[0]


class NativeEra5Reader:
    """pread-based multi-file sample reader.

    ``read(file_idx, t, channels, crop, means, stds)`` -> [C', h, w] fp32,
    normalized when stats are given. ``read_frames`` gathers a strided run
    of frames for multi-step targets in one call.
    """

    def __init__(self, paths: Sequence[str], n_threads: int = 4, dataset: str = "fields"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native reader unavailable (build failed)")
        probed, reason = _probe(paths, dataset)
        if probed is None:
            raise RuntimeError(f"files are not contiguous fp32 ({reason}) — use the h5py path")
        offsets, dims = probed
        self._lib = lib
        self.dims = dims
        c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.era5_create(
            c_paths,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            np.ascontiguousarray(dims).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(paths),
            int(n_threads),
        )
        if not self._handle:
            raise RuntimeError("era5_create failed (open error)")

    def _stats_ptrs(self, means, stds):
        if means is None or stds is None:
            null = ctypes.POINTER(ctypes.c_float)()
            return null, null, None, None
        m = np.ascontiguousarray(means, np.float32).reshape(-1)
        s = np.ascontiguousarray(stds, np.float32).reshape(-1)
        return (
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m, s,  # keep alive
        )

    def read(
        self,
        file_idx: int,
        t: int,
        channels: Sequence[int],
        crop: Tuple[int, int],
        means: Optional[np.ndarray] = None,
        stds: Optional[np.ndarray] = None,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        ch = np.ascontiguousarray(channels, np.int32)
        h, w = crop
        if out is None:
            out = np.empty((len(ch), h, w), np.float32)
        mp, sp, _m, _s = self._stats_ptrs(means, stds)
        rc = self._lib.era5_read_sample(
            self._handle, int(file_idx), int(t),
            ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ch),
            h, w, mp, sp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc:
            raise IOError(f"era5_read_sample failed rc={rc}")
        return out

    def read_frames(
        self,
        file_idx: int,
        t: int,
        dt: int,
        n_frames: int,
        channels: Sequence[int],
        crop: Tuple[int, int],
        means: Optional[np.ndarray] = None,
        stds: Optional[np.ndarray] = None,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        ch = np.ascontiguousarray(channels, np.int32)
        h, w = crop
        if out is None:
            out = np.empty((n_frames, len(ch), h, w), np.float32)
        mp, sp, _m, _s = self._stats_ptrs(means, stds)
        rc = self._lib.era5_read_frames(
            self._handle, int(file_idx), int(t), int(dt), int(n_frames),
            ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ch),
            h, w, mp, sp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc:
            raise IOError(f"era5_read_frames failed rc={rc}")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.era5_destroy(self._handle)
            self._handle = None
