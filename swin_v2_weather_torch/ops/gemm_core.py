"""The Hopper GEMM core (``csrc/wgmma_gemm.cuh``): its Python side.

The core computes C[M, N] = A[M, K] @ B[K, N] with bf16 operands and fp32
accumulation (TMA ring, wgmma on 128 x BN block tiles, an epilogue per
caller). It carries fc1 + GELU and its backward (K3/K4,
``mlp_kernels.fc1_gelu`` / ``fc1_dpre``), the whole-MLP forward (K5,
``mlp_kernels.mlp_fwd``) and,
as a pair of products on one tile, the whole-MLP backward's recompute (K6,
``mlp_kernels.mlp_bwd``); the qkv projection of the qkv-fused forwards (K1,
K7, K10, K12; q and k normalized in its epilogue) and backwards, and the
backwards' dx and dW. It has no TPU kernel of its own: the TPU package
leaves its large products to XLA.

Here, runnable without a card:

  * :func:`block_n`, :func:`smem_bytes` and :func:`plan` -- the block tile,
    ring and grid of one launch, as the CUDA source computes them, and the
    shape checks that raise before a launch;
  * :func:`split_k` -- how many K ranges a split-K product (dW) takes;
  * :func:`gemm_reference` -- the plain version.

And :func:`gemm`, the core's own entry point (an fp32 or bf16 product), which
launches the kernel on CUDA tensors and counts its launches; the tests and
``chip_smoke.py`` hold the core against :func:`gemm_reference` with it, and
time it alone.
"""

from __future__ import annotations

import torch

from swin_v2_weather_torch.ops import _build

BM = 128  # rows of a block tile (two consumer warpgroups of 64)
BK = 64  # K depth of a ring stage
THREADS = 384  # a producer warpgroup and two consumer warpgroups
SMS = 132  # streaming multiprocessors of an H100 SXM: one block each
_MAX_GRID_Y = 65535


def block_n(n: int) -> int:
    """Output columns of a block tile: 256, or 128 where N <= 128 (the qkv
    forwards' projection takes 192 at head dim 96, a whole number of
    heads)."""
    return 256 if n > 128 else 128


def stages(bn: int) -> int:
    """Depth of the TMA ring: 6 stages at BN = 128, else 4."""
    return 6 if bn == 128 else 4


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of a block: the ring, its barriers and the
    alignment slack (``Shape<BN>::SMEM``)."""
    s = stages(bn)
    return s * (BM * BK * 2 + bn * BK * 2) + 16 * s + 1024


def plan(m: int, n: int, k: int, *, a_mn: bool = False, b_mn: bool = False,
         lda: int = None, ldb: int = None, splits: int = 1) -> dict:
    """The launch of C[m, n] = A[m, k] @ B[k, n] over ``splits`` K ranges.

    ``a_mn``: A is stored as A^T [k, m] (leading dimension ``lda``, default
    m), else as A [m, k] (default k). ``b_mn``: B is stored as B [k, n]
    (default n), else as B^T [n, k] (default k). Raises a ValueError for a
    shape the kernel refuses: the contiguous dimension of either operand, or
    a leading dimension, not a multiple of 8; n odd; more than 65535 row
    tiles or splits; a split with no K to sum.
    """
    lda = (m if a_mn else k) if lda is None else lda
    ldb = (n if b_mn else k) if ldb is None else ldb
    a_vec, b_vec = (m if a_mn else k), (n if b_mn else k)
    if min(m, n, k) < 1 or splits < 1:
        raise ValueError(f"gemm core: needs M, N, K, splits >= 1, got {m}, {n}, {k}, {splits}")
    if a_vec % 8 or b_vec % 8 or lda % 8 or ldb % 8 or n % 2:
        raise ValueError(
            f"gemm core: the contiguous dimensions ({a_vec}, {b_vec}) and leading dimensions "
            f"({lda}, {ldb}) must be multiples of 8 and N even (16-byte TMA rows)")
    bn = block_n(n)
    m_tiles, n_tiles = -(-m // BM), -(-n // bn)
    k_chunk = -(-(-(-k // splits)) // BK) * BK
    if m_tiles > _MAX_GRID_Y or splits > _MAX_GRID_Y or (splits - 1) * k_chunk >= k:
        raise ValueError(f"gemm core: {m_tiles} row tiles and {splits} splits of K = {k} "
                         f"(chunks of {k_chunk}); at most {_MAX_GRID_Y} each, none empty")
    return {"bn": bn, "stages": stages(bn), "smem": smem_bytes(bn), "threads": THREADS,
            "grid": (n_tiles, m_tiles, splits), "blocks": n_tiles * m_tiles * splits,
            "k_chunk": k_chunk}


def split_k(m: int, n: int, k: int, max_splits: int = 32) -> int:
    """How many K ranges the split-K product C[m, n] = A @ B over a long K
    (dW over the token rows) takes: the count that minimizes the blocks'
    waves on the card times each block's K slices, plus the fp32 partials'
    round trip through device memory (written once, summed once). Each split
    keeps at least 8 slices of 64."""
    bn = block_n(n)
    tiles = -(-m // BM) * -(-n // bn)
    # a 128 x 256 x 64 slice at the card's peak, and bytes at its memory rate (us)
    slice_us = 2 * BM * bn * BK / (989e12 / SMS) * 1e6
    best, best_cost = 1, None
    for s in range(1, max_splits + 1):
        k_chunk = -(-(-(-k // s)) // BK) * BK
        if s > 1 and (k_chunk < 8 * BK or (s - 1) * k_chunk >= k):
            break
        waves = -(-tiles * s // SMS)
        cost = waves * (k_chunk // BK) * slice_us + (2 * s * m * n * 4 / 3.35e12 * 1e6 if s > 1
                                                     else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def gemm_reference(a: torch.Tensor, b: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a [M, K] @ b [K, N] in plain ops: an fp32 product of the (bf16) values,
    rounded once to ``out_dtype``."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _major(name: str, t: torch.Tensor, rows_contiguous_is_mn: bool):
    """(mn_major, leading dimension) of a 2-D operand view, or raise."""
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return rows_contiguous_is_mn, t.stride(0)
    if t.stride(0) == 1 and t.stride(1) >= t.shape[0]:
        return not rows_contiguous_is_mn, t.stride(1)
    raise ValueError(f"gemm: {name} must be row-contiguous or a transpose of a row-contiguous "
                     f"matrix, got strides {t.stride()}")


def gemm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.float32,
         splits: int = 1) -> torch.Tensor:
    """The core's entry point: a [M, K] @ b [K, N] -> [M, N] in ``out_dtype``
    (fp32, summed over ``splits`` K ranges in split order; or bf16, one
    range). a is row-contiguous (K-major) or the transpose of a
    row-contiguous [K, M] (MN-major); b row-contiguous (MN-major) or the
    transpose of a row-contiguous [N, K] (K-major). CPU tensors take
    :func:`gemm_reference`. Launches on the current stream and does not
    synchronize."""
    if a.device.type == "cpu":
        return gemm_reference(a, b, out_dtype)
    name = "gemm"
    if a.device.type != "cuda" or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: needs CUDA matrices a [M, K], b [K, N], got "
                         f"{tuple(a.shape)} on {a.device}, {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.device != a.device:
        raise TypeError(f"{name}: needs bf16 operands on one device, got {a.dtype}, {b.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16) or (
            out_dtype == torch.bfloat16 and splits != 1):
        raise ValueError(f"{name}: out_dtype fp32 (any splits) or bf16 (one split)")
    m, k = a.shape
    n = b.shape[1]
    a_mn, lda = _major("a", a, False)
    b_mn, ldb = _major("b", b, True)
    plan(m, n, k, a_mn=a_mn, b_mn=b_mn, lda=lda, ldb=ldb, splits=splits)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.swin_gemm_core(a.data_ptr(), b.data_ptr(),
                                  None if part is None else part.data_ptr(), out.data_ptr(),
                                  m, n, k, lda, ldb, int(a_mn), int(b_mn), splits,
                                  int(out_dtype == torch.bfloat16), stream)
    _build.check(code, name)
    gemm.launches += 1
    return out


gemm.launches = 0


def count_launches(n: int) -> None:
    """Add n to the core's launch count (``gemm.launches``): called by the
    entry points that launch the core with their own epilogues (K3-K6, the
    K1- and K2-family projections), once per call, with the
    number of core launches the call made."""
    gemm.launches += n


def projection_launches(heads: int, slabs: bool) -> int:
    """Core launches of one qkv projection: one, or (v5's reordered weight)
    one per (role, head) slab."""
    return 3 * heads if slabs else 1
