"""Build and bind the port's hand-written CUDA kernels.

The ``.cu`` sources under ``ops/csrc/`` expose plain C entry points. At first
use each is compiled with ``nvcc`` for ``sm_90a`` (one process per source, all
started together), the objects are linked into one shared library under
``swin_v2_weather_torch/_build/`` and it is loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is always rebuilt and a stale library is never loaded. Nothing is
built while a module is imported: :func:`load_library` runs inside the first
kernel launch (or explicitly, to time the build).

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch
from torch._subclasses.fake_tensor import is_fake

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_OPS_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS_DIR), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_vp, _int, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (x, w, b, out, T, K, N, stream)
    "swin_fc1_gelu_fwd": [_vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # (x, w, b, g, out, T, K, N, stream)
    "swin_fc1_dpre_bwd": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # (x, w1, b1, w2, b2, act, out, T, C_in, hidden, C_out, stream)
    "swin_mlp_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # the GEMM core: (a, b, part, c, M, N, K, lda, ldb, a_mn, b_mn, splits,
    #  out_bf16, stream)
    "swin_gemm_core": [_vp] * 4 + [_int] * 9 + [_vp],
    # (x, w1, b1, w2, g, a, dpre, T, C_in, hidden, C_out, stream)
    "swin_mlp_bwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # (x, w, b, scale, mask, boundary_flag, qkv, out, B, H, W, C_in, C, heads, wh,
    #  ww, stream)
    "swin_window_attention_qkv_fwd": [_vp] * 5 + [_f32] + [_vp] * 2 + [_int] * 8 + [_vp],
    # (x, w, b, scale, mask, boundary_flag, g, qkv, dqkv, dw_part, db_part,
    #  dscale_part, dx, dw, db, dscale, B, H, W, C_in, C, heads, wh, ww,
    #  dw_splits, db_splits, stream)
    "swin_window_attention_qkv_bwd": [_vp] * 5 + [_f32] + [_vp] * 10 + [_int] * 10 + [_vp],
    # (x, w, b, scale, bias, mask, boundary_flag, qkv, out, B, H, W, C_in, C,
    #  heads, wh, ww, stream)
    "swin_window_attention_qkv_bias_fwd": [_vp] * 6 + [_f32] + [_vp] * 2 + [_int] * 8 + [_vp],
    # (x, w, b, scale, bias, mask, boundary_flag, g, qkv, dqkv, dw_part,
    #  db_part, dscale_part, dbias_part, dx, dw, db, dscale, dbias, B, H, W,
    #  C_in, C, heads, wh, ww, dw_splits, db_splits, stream)
    "swin_window_attention_qkv_bias_bwd": [_vp] * 6 + [_f32] + [_vp] * 12 + [_int] * 10 + [_vp],
    # the forward pass's launch shape: (hd, bias, pad, v4, L, lm, info[7])
    "swin_window_attention_qkv_fwd_info": [_int] * 6 + [_vp],
    # K10: (x, wp, bp, scale, mask, boundary_flag, qkv, out, B, H, W, C_in,
    #  heads, hd, wh, ww, stream)
    "swin_window_attention_qkv_padded_fwd": [_vp] * 5 + [_f32] + [_vp] * 2 + [_int] * 8 + [_vp],
    # (x, wp, bp, scale, mask, boundary_flag, g, qkv, dqkv, dw_part, db_part,
    #  dscale_part, dx, dwp, dbp, dscale, B, H, W, C_in, heads, hd, wh, ww,
    #  dw_splits, db_splits, stream)
    "swin_window_attention_qkv_padded_bwd": [_vp] * 5 + [_f32] + [_vp] * 10 + [_int] * 10 + [_vp],
    # K8: (q, k, v, scale, bias, mask, boundary_flag, out, B, H, W, C, heads,
    #  wh, ww, ldq, ldk, ldv, stream); bias null for the bias-free instance
    "swin_window_attention_grid_fwd": [_vp] * 6 + [_f32, _vp] + [_int] * 10 + [_vp],
    # K9: (q, k, v, scale, bias, mask, out, B, nwh, nww, heads, hd, L, stream)
    "swin_window_attention_v1_fwd": [_vp] * 7 + [_int] * 6 + [_vp],
    # K8/K9 forward launch shape: (hd, bias, L, info[7])
    "swin_window_attention_grid_fwd_info": [_int, _int, _int, _vp],
    "swin_window_attention_v1_fwd_info": [_int, _int, _int, _vp],
    # K8's backward (the streamed kernels): (q, k, v, scale, bias, mask,
    #  boundary_flag, g, dq, dk, dv, rstat, dscale_part, dbias_part, dscale,
    #  dbias, B, H, W, C, heads, wh, ww, ldq, ldk, ldv, stream)
    "swin_window_attention_grid_streamed_bwd": [_vp] * 6 + [_f32] + [_vp] * 9 + [_int] * 10
    + [_vp],
    # K9's streamed backward: (q, k, v, scale, bias, mask, g, dq, dk, dv, qn,
    #  kn, inv, rstat, dscale_part, dbias_part, dscale, dbias, B, nwh, nww,
    #  heads, hd, L, stream)
    "swin_window_attention_v1_streamed_bwd": [_vp] * 18 + [_int] * 6 + [_vp],
    # their launch: (hd, bias, L, info[10])
    "swin_window_attention_grid_streamed_bwd_info": [_int, _int, _int, _vp],
    "swin_window_attention_v1_streamed_bwd_info": [_int, _int, _int, _vp],
    # the streamed backward of every qkv-fused variant: (x, wr, w, b, scale,
    #  bias, mask, boundary_flag, g, qkv, inv, rstat, dqkv, dw_part, db_part,
    #  dscale_part, dbias_part, dx, dw, db, dscale, dbias, B, nwh, nww, lm,
    #  C_in, C, heads, hd, wh, ww, var, dw_splits, db_splits, stream)
    "swin_window_attention_qkv_streamed_bwd": [_vp] * 7 + [_f32] + [_vp] * 14 + [_int] * 13
    + [_vp],
    # K12 v5: the operands of swin_window_attention_qkv_fwd with w5 for w;
    #  (x, w5, w, b, scale, mask, boundary_flag, g, qkv, dqkv, dw_part, db_part,
    #  dscale_part, dx, dw, db, dscale, B, H, W, C_in, C, heads, wh, ww,
    #  dw_splits, db_splits, stream)
    "swin_window_attention_qkv5_fwd": [_vp] * 5 + [_f32] + [_vp] * 2 + [_int] * 8 + [_vp],
    "swin_window_attention_qkv5_bwd": [_vp] * 6 + [_f32] + [_vp] * 10 + [_int] * 10 + [_vp],
    # K12 v4: (xw, w, b, scale, mask, boundary_flag, qkv, out, B, nwh, nww, lm,
    #  C_in, C, heads, hd, wh, ww, stream); (xw, w, b, scale, mask,
    #  boundary_flag, gw, qkv, dqkv, dw_part, db_part, dscale_part, dxw, dw, db,
    #  dscale, B, nwh, nww, lm, C_in, C, heads, hd, wh, ww, dw_splits,
    #  db_splits, stream)
    "swin_window_attention_qkv4_fwd": [_vp] * 5 + [_f32] + [_vp] * 2 + [_int] * 10 + [_vp],
    "swin_window_attention_qkv4_bwd": [_vp] * 5 + [_f32] + [_vp] * 10 + [_int] * 12 + [_vp],
    # K13: (s, out, n, stream)
    "swin_prestage_consume": [_vp, _vp, ctypes.c_longlong, _vp],
    # (z, x, gamma, beta, m, out, T, C, stream)
    "swin_ln_dp_add_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _vp],
    # (z, g, gamma, m, dz, part, dgamma, dbeta, T, C, n_blocks, stream)
    "swin_ln_dp_add_bwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # K11 above 2048 channels: the forward as swin_ln_dp_add_fwd, the backward
    # as swin_ln_dp_add_bwd
    "swin_ln_dp_add_wide_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _vp],
    "swin_ln_dp_add_wide_bwd": [_vp] * 8 + [_int, _int, _int, _vp],
}


def sources() -> list:
    """The CUDA sources that make up the library, in a stable order."""
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of swin_v2_weather_torch need the CUDA toolkit"
        )
    return found


def library_path() -> str:
    """Path of the library for the current sources and flags (may not exist yet)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libswin_kernels_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the sources with nvcc unless the library for them exists.

    Every ``.cu`` file compiles in its own nvcc process, all at once; the
    objects are then linked into the library. The compilers' output
    (``-Xptxas=-v``: registers, shared memory and spills of every kernel) is
    kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out[: -len('.so')]}.tmp{os.getpid()}"
    nvcc = _nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(p)}.o" for p in cu]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.so", *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(link.stdout)
    log = "".join(logs)
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if link is None or link.returncode != 0:
        codes = [p.returncode for p in procs] + ([link.returncode] if link else [])
        raise RuntimeError(f"nvcc failed (exit codes {codes}):\n{log}")
    os.replace(f"{tag}.so", out)  # atomic: a concurrent process never loads a partial file
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib = ctypes.CDLL(build_library())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.swin_cuda_error_string.argtypes = [ctypes.c_int]
    lib.swin_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_library().swin_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


def check_traced(kernel: str, t: torch.Tensor) -> None:
    """Raise where a launcher meets a fake tensor: a traced call that reached
    the ctypes launch instead of the custom op (a ctypes launch cannot be
    traced, and no kernel falls back to its plain version)."""
    if not is_fake(t):
        return
    # a forward launcher's op is swin::<launcher>, defined beside it (so
    # registered once its module is imported); a backward launcher has none
    where = (f"a traced call must go through its custom op swin::{kernel}"
             if hasattr(torch.ops.swin, kernel) else
             "a backward kernel has no custom op: torch.export traces the served step "
             "under torch.no_grad")
    raise RuntimeError(f"{kernel} was reached with a fake tensor (torch.export tracing the "
                       f"model): {where}")


def check_operand(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Device, dtype, shape and contiguity of one kernel operand, or raise
    (a fake tensor too: :func:`check_traced`)."""
    check_traced(kernel, t)
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
