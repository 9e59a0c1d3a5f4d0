"""Scaled-cosine window attention: plain PyTorch versions and CUDA kernels.

Three kernel families of ``swin_v2_weather_tpu/ops/window_attention.py``:

  * K1/K2 (and K7, their CPB-bias instances): the qkv-fused v3 kernels, the
    ``attn_impl: 'pallas_qkv'`` route (this docstring, below);
  * K8: the grid-layout kernels on pre-projected q, k, v, the ``'pallas'``
    route (:func:`fused_window_attention_grid`, ``csrc/window_attention_grid.cu``);
  * K9: the windowed-layout kernels, the ``'pallas_v1'`` route
    (:func:`fused_window_attention`, ``csrc/window_attention_v1.cu``).

K8 and K9 (both instances in ``csrc/qkv_attention.cuh``) take the raw CPB
bias and subtract the row max; their rounding sites are listed in the
section comment above :func:`normalize_heads`.

The v3 pair: counterpart of ``swin_v2_weather_tpu/ops/window_attention.py``
(forward ``_make_qkv_kernel`` / ``_qkv_forward``, backward
``_make_qkv_bwd_kernel`` / ``_qkv_backward``, custom_vjps ``_build_qkv`` and,
with the CPB relative-position bias, ``_build_qkv_bias``; entry point
``fused_window_attention_qkv``). The input is the model's NHWC grid
``[B, H, W, C_in]``, already rolled for shifted blocks; the qkv projection,
the windowing, per-head q/k L2 normalization, the max-free softmax and the
e @ v product happen in one call, and the output comes back in grid layout
``[B, H, W, C]``. On the card the call runs the projection on the GEMM core
(q and k normalized in its epilogue) into a transient [B, H, W, 3C] scratch,
then the streamed attention pass of ``csrc/qkv_attention.cuh``.

  * :func:`window_attention_qkv_reference` /
    :func:`window_attention_qkv_backward_reference` -- the plain versions (CPU
    path and test oracles), with the kernels' rounding sites;
    :func:`window_attention_qkv_bias_reference` /
    :func:`window_attention_qkv_bias_backward_reference` the same with the
    pre-folded CPB term ``badd`` (:func:`fold_cpb_bias`);
    :func:`window_attention_qkv_pass_order` the forward with the CUDA
    kernels' order of fp32 sums (:func:`quad_unit`, :func:`lane_sums`,
    :func:`chunked_pv`).
  * :func:`window_attention_qkv` / :func:`window_attention_qkv_bwd` -- launch
    ``csrc/window_attention_qkv.cu`` (K1) and
    ``csrc/window_attention_qkv_bwd.cu`` (K2) on CUDA tensors;
    :func:`window_attention_qkv_bias` / :func:`window_attention_qkv_bias_bwd`
    launch the bias instances of the same sources (K7). Each counts its
    launches.
  * :class:`WindowAttentionQKV` -- the autograd Function: it saves only
    (x, w_qkv, b_qkv, scale), as ``_build_qkv``'s ``f_fwd`` does, and its
    backward recomputes everything else. :class:`WindowAttentionQKVBias`
    saves (x, w_qkv, b_qkv, scale, badd) and also returns d(bias), as
    ``_build_qkv_bias`` does.
  * :func:`fused_window_attention_qkv` -- the entry point the model calls; a
    CPU tensor takes the plain versions, a CUDA tensor the kernels (or an
    error).

The shifted-window mask is latitude-only: every masked window lies in the
last window row and all of them share one [L, L] pattern
(``make_shift_mask(...)[-1]``), added there times ``boundary_flag``.

Rounding sites (the TPU kernel's contract, kept by both versions): qkv is
accumulated in fp32 from bf16-cast x and W whatever the input dtype, plus the
fp32 bias, then rounded to bf16; q16 = bf16(q * rsqrt(max(sum q^2, 1e-24))),
likewise k16; s = q16 @ k16^T in fp32; z = (s - 1) * scale (+ mask), or with
the CPB bias z = s * scale + badd[h] (+ mask); e = exp(z) with no max pass
(|s| <= 1, and badd is row-max-shifted, so z <= 0 with one z = 0 a row);
out = (bf16(e) @ v16 in fp32) / sum(e), cast to x's dtype. The backward's
sites are listed in :func:`window_attention_qkv_backward_reference`.

Gradient dtypes follow ``_build_qkv``'s ``f_bwd``: dx in x's dtype, dW in the
dtype of the w_qkv handed in (bf16 in the model, which casts the fp32
parameter first, so the cast's backward lifts it to fp32), db, dscale and
dbias in fp32.

Head dims and windows: the forward (K1, K7, K10, K12) takes head dims 32-256
and any L (:func:`qkv_fwd_plan`). The one-block-per-(window, head) backward
(K2, K7, K10, K12) holds q, k, v and g [LP, HD] in shared memory and takes
head dims 32-96 at L <= 256; at head dims 128 and 256 (at 256 it does not
fit, and at 128, where it fits up to L = 208, the streamed kernels took
4.42 against its 4.55 ms at L = 162 on the H100, PERF.md) and at every
head dim past L = 256, the streamed backward (``csrc/window_attention_qkv_large.cu``,
:func:`qkv_streamed_bwd`: the recompute with q/k normalized in its
epilogue, then the streamed kernels of ``csrc/streamed_bwd.cuh``,
:func:`streamed_bwd_plan`, whose shared memory grows with L only by two
small tables; every variant, K10's and the padded v4's head pitch 128 too)
runs instead, with the same rounding sites. :func:`qkv_variant` says which
runs for a shape, or raises before any launch for a head dim the forward
does not take.

Selectable variants, as in the JAX package, read at call time from the
module globals (set from the environment at import):

  * ``QKV_IMPL`` (``SWIN_QKV_IMPL``): ``'v3'`` (K1/K2, the default),
    ``'v6'``: the padded-head route (K10, :func:`fused_window_attention_qkv_padded`,
    which the model takes when there is no CPB bias), or ``'v5'`` / ``'v4'``:
    the K12 schedules of ``ops/attic/window_attention_v45.py`` (v4's padded
    heads with ``QKV_PAD_HEADS`` there, from ``SWIN_QKV_PAD_HEADS``);
    :func:`fused_window_attention_qkv` also takes ``impl=`` per call.
  * ``QKV_BWD_IMPL`` (``SWIN_QKV_BWD_IMPL``): ``'pallas'`` (K2/K7's
    backward, the default) or ``'xla'``: the qkv recompute and the
    projection chain in plain ops around K8's backward
    (:func:`qkv_xla_backward`). v4 and v5 have their own backwards and do
    not read it (JAX reads it in ``_build_qkv`` only).

K8/K9's forward is one streamed kernel at head dims 32-256 and any L (keys
and values through a ring, ``csrc/qkv_attention.cuh``), and so is each
one's backward: the streamed kernels of ``csrc/streamed_bwd.cuh`` (K8 form
FORM_GRID; K9 form FORM_V1, after a prepass that normalizes q and k) at
head dims 32-256 and any L. :func:`attn_variant` says which runs in each
direction for each layout, or raises.
"""

from __future__ import annotations

import ctypes
import os as _os
from typing import List, Optional, Tuple

import torch

from swin_v2_weather_torch.ops import _build, gemm_core
from swin_v2_weather_torch.ops.mlp_kernels import matmul_f32

_QKV_IMPLS = ("v3", "v4", "v5", "v6")
_QKV_BWD_IMPLS = ("pallas", "xla")
QKV_IMPL = _os.environ.get("SWIN_QKV_IMPL", "v3")
QKV_BWD_IMPL = _os.environ.get("SWIN_QKV_BWD_IMPL", "pallas")


def qkv_impl() -> str:
    """The qkv-fused route selected now: ``QKV_IMPL``, validated as the JAX
    package validates ``SWIN_QKV_IMPL`` (a typo must not silently pick a
    route)."""
    if QKV_IMPL not in _QKV_IMPLS:
        raise ValueError(f"SWIN_QKV_IMPL={QKV_IMPL!r} invalid; expected 'v3', 'v4', 'v5' or 'v6'")
    return QKV_IMPL


def qkv_bwd_impl() -> str:
    """The qkv-fused backward selected now: ``QKV_BWD_IMPL``, validated as
    ``SWIN_QKV_BWD_IMPL`` is in the JAX package."""
    if QKV_BWD_IMPL not in _QKV_BWD_IMPLS:
        raise ValueError(f"SWIN_QKV_BWD_IMPL={QKV_BWD_IMPL!r} invalid; expected 'pallas' or 'xla'")
    return QKV_BWD_IMPL


qkv_impl()  # fail fast on a bad environment value, as the JAX package does at import
qkv_bwd_impl()

_MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90
# the streamed backward (csrc/streamed_bwd.cuh): 16-row tiles a
# block (two warps each), streamed rows a step, ring stages
_STREAMED_RT, _STREAMED_STEP, _STREAMED_NS = 4, 32, 3


def streamed_bwd_plan(hd: int, l: int, ls: Optional[int] = None, grid: bool = False,
                      v1: bool = False) -> dict:
    """The launch of the streamed backward (``csrc/streamed_bwd.cuh``,
    ``plan_of``, ``rows_smem``, ``cols_smem``) at head dim ``hd``, window
    length ``l`` and ``ls`` rows a window (v4's lm; default ``l``), for K8
    (``grid``: three row statistics), K9 (``v1``: three, the [L, hd] slab of
    each (window, head) addressed without a table) or the qkv-fused family
    (two): ``rt`` 16-row tiles a block (two warps each), ``nchunk`` blocks per
    (window, head), ``threads`` and the bytes of shared memory of the rows and
    columns kernels: the block's own rows and a ring of 32-row steps, the
    pairs' fragment and statistics exchanges, the warps' d(scale) sums
    (rows; K9's columns), (columns) the window's row statistics and, but for
    K9, a table of ``ls`` token rows. Nothing in it grows with L but the
    tables."""
    lp = -(-l // 16) * 16
    ls = l if ls is None else ls
    ntiles = lp // 16
    nchunk = -(-ntiles // _STREAMED_RT)
    rt = -(-ntiles // nchunk)
    tiles = (2 * rt * 16 + _STREAMED_NS * 2 * _STREAMED_STEP) * (hd + 8) * 2

    def words16(n: int) -> int:  # bytes of n 4-byte words, in whole 16-byte units
        return (n + 3) // 4 * 16

    nst = 3 if grid or v1 else 2
    table = 0 if v1 else words16(ls)
    return {"rt": rt, "nchunk": nchunk, "threads": rt * 64,
            "rows_smem": tiles + rt * 64 * 16 + rt * 128 * 4 + 32 + table,
            "cols_smem": tiles + rt * 128 * 16 + rt * 128 * 4 + words16(lp * nst)
            + (32 if v1 else table)}


def qkv_smem_bytes(hd: int, l: int) -> dict:
    """Shared memory (bytes) of each qkv-fused kernel at head dim ``hd`` and
    window length ``l``, as the CUDA sources compute it: ``fwd`` of the
    forward's attention pass (K1, K7, K10 and v5 alike: :func:`qkv_fwd_plan`),
    ``bwd`` of the one-block-per-(window, head) backward (K2; K7 and K10
    alike) and ``streamed_rows``/``streamed_cols`` of the streamed
    backward's rows and columns kernels (:func:`streamed_bwd_plan`)."""
    lp = -(-l // 16) * 16
    plan = streamed_bwd_plan(hd, l)
    return {
        "fwd": qkv_fwd_plan(hd, l)["smem"],
        "bwd": 4 * lp * (hd + 8) * 2 + (4 * lp + 16) * 4,
        "streamed_rows": plan["rows_smem"],
        "streamed_cols": plan["cols_smem"],
    }


def qkv_variant(name: str, hd: int, l: int, backward: bool) -> str:
    """Which qkv-fused kernel runs at head dim ``hd`` and window length ``l``.
    Forward: ``'streamed'`` (the projection on the GEMM core, then the
    streamed attention pass) at head dims 32/64/96/128/256 and any L.
    Backward, at the same head dims: ``'base'`` (K2, head dim 32/64/96,
    L <= 256) where its shared memory fits, else ``'streamed'`` (the
    recompute, then the streamed kernels, whose shared memory grows with L
    only by two small tables) where that fits. Any other shape raises a
    ValueError before a launch."""
    if hd not in ATTN_FWD_HEAD_DIMS or l < 1:
        raise ValueError(f"{name}: no {'backward' if backward else 'forward'} kernel takes head "
                         f"dim {hd} (it takes {ATTN_FWD_HEAD_DIMS})")
    if not backward:
        return "streamed"
    sm = qkv_smem_bytes(hd, l)
    if l <= 256 and hd <= 96 and sm["bwd"] <= _MAX_SMEM:
        return "base"
    if max(sm["streamed_rows"], sm["streamed_cols"]) <= _MAX_SMEM:
        return "streamed"
    raise ValueError(f"{name}: no backward kernel takes L = {l} at head dim {hd}: the streamed "
                     f"kernels' tables outgrow shared memory")


def qkv_fwd_plan(hd: int, l: int, lq: Optional[int] = None) -> dict:
    """The qkv-fused forward's attention pass (``csrc/qkv_attention.cuh``,
    layouts QKV and QKV4) at head dim ``hd``, window length ``l`` and ``lq``
    query rows a window (v4's lm; default ``l``): the launch of
    :func:`attn_fwd_plan` (e of the warp's keys kept in registers up to
    L = 192, one streamed sweep of k and v tiles beyond) with a table of
    ``lq`` token rows."""
    return attn_fwd_plan(hd, l, ltab=lq)


def qkv_fwd_info(hd: int, l: int, bias: bool = False, pad: bool = False, v4: bool = False,
                 lm: Optional[int] = None) -> dict:
    """The forward pass's launch at head dim ``hd`` and window length ``l``
    (``pad``: head pitch 128, K10 and padded v4; ``v4``: layout QKV4 with
    ``lm`` query rows), from the CUDA runtime, as :func:`attn_fwd_info`.
    Needs the GPU."""
    lib = _build.load_library()
    info = (ctypes.c_int * 7)()
    _build.check(lib.swin_window_attention_qkv_fwd_info(hd, int(bias), int(pad), int(v4), l,
                                                        l if lm is None else lm, info),
                 "swin_window_attention_qkv_fwd_info")
    keys = ("threads", "smem", "registers", "local_bytes", "blocks_per_sm", "blocks_per_window",
            "z_path")
    return dict(zip(keys, info))


def quad_unit(t: torch.Tensor):
    """The forward projection epilogue's head normalization of the
    bf16-valued t [..., hd] (fp32): sum t^2 per lane of a quad over its
    columns 8 j + 2 c + {0, 1} in column order, each step a fused
    multiply-add (emulated in fp64, then rounded), then across the quad (xor
    1, then 2); inv = 1 / sqrt(max(sum, 1e-24)) -> (bf16-valued t * inv,
    inv)."""
    hd = t.shape[-1]
    tv = t.double().reshape(*t.shape[:-1], hd // 8, 4, 2)  # [..., j, c, x]
    ss = torch.zeros((*t.shape[:-1], 4), dtype=torch.float32, device=t.device)
    for j in range(hd // 8):
        for x in range(2):
            v = tv[..., j, :, x]
            ss = (v * v + ss.double()).float()
    for x in (1, 2):
        ss = ss + ss[..., [c ^ x for c in range(4)]]
    inv = (1.0 / torch.sqrt(torch.clamp_min(ss[..., :1], 1e-24)))
    return (t * inv).to(torch.bfloat16).float(), inv


def lane_sums(e: torch.Tensor, nt: int = 2) -> torch.Tensor:
    """The pass's sum of e over the keys of e [..., L, Lk] (fp32) in its
    order: each lane's in key order (a step of 16 nt keys, each warp of a
    pair 8 nt of them in nt 8-key tiles, each lane of a quad two adjacent
    keys of a tile), then across the quad (xor 1, then 2), then warp 0's
    plus warp 1's. K8's z path sums e = exp(z - max) the same way."""
    lk = e.shape[-1]
    nstep = -(-lk // (16 * nt))
    ep = torch.zeros((*e.shape[:-1], nstep * 16 * nt), dtype=e.dtype, device=e.device)
    ep[..., :lk] = e
    # key = 16 nt step + 8 nt d + 8 n + 2 c + x -> [..., step, d, n, c, x]
    ep = ep.reshape(*e.shape[:-1], nstep, 2, nt, 4, 2)
    lsum = torch.zeros((*e.shape[:-1], 2, 4), dtype=e.dtype, device=e.device)
    for st in range(nstep):
        for n in range(nt):
            for x in range(2):
                lsum = lsum + ep[..., st, :, n, :, x]
    for x in (1, 2):
        lsum = lsum + lsum[..., [c ^ x for c in range(4)]]
    return lsum[..., 0, 0] + lsum[..., 1, 0]


def chunked_pv(p16: torch.Tensor, v16: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """p16 [..., L, Lk] @ v16 [..., Lk, hd] in fp32 accumulated as the pass
    accumulates it: one product of ``chunk`` keys at a time, in key order."""
    out = torch.zeros((*p16.shape[:-1], v16.shape[-1]), dtype=torch.float32, device=p16.device)
    for k0 in range(0, p16.shape[-1], chunk):
        out = out + torch.matmul(p16[..., k0:k0 + chunk].float(), v16[..., k0:k0 + chunk, :].float())
    return out


def one_sweep_pass(e: torch.Tensor, v16: torch.Tensor) -> torch.Tensor:
    """K1's attention pass (layout QKV) in plain fp32 ops, from e = exp(z)
    [..., L, L] and the bf16-valued v16 [..., L, hd]: out = (bf16(e) @ v16,
    accumulated by key chunk) * (1 / sum e), sum e in :func:`lane_sums`'
    order; fp32 (the caller rounds to bf16)."""
    return chunked_pv(e.to(torch.bfloat16), v16) * (1.0 / lane_sums(e))[..., None]


def window_attention_qkv_pass_order(x, w_qkv, b_qkv, scale, window, mask_pattern=None,
                                    boundary_flag=None, badd=None) -> torch.Tensor:
    """The plain version of K1's (``badd``: K7's) forward with the CUDA
    kernels' order of fp32 sums: the projection epilogue's head
    normalization (:func:`quad_unit`) and the pass's (:func:`one_sweep_pass`);
    its rounding sites are :func:`window_attention_qkv_reference`'s."""
    from swin_v2_weather_torch.models.swin import window_reverse

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    c = w_qkv.shape[-1] // 3
    v, _, _, _, _, e, _ = _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern,
                                     boundary_flag, badd, unit=quad_unit)
    out = one_sweep_pass(e, v).to(x.dtype).permute(0, 2, 1, 3).reshape(-1, wh, ww, c)
    return window_reverse(out, (wh, ww), (h, w))


def _window_grid(x: torch.Tensor, window: Tuple[int, int]) -> Tuple[int, int]:
    wh, ww = int(window[0]), int(window[1])
    if x.shape[1] % wh or x.shape[2] % ww:
        raise ValueError(f"grid {tuple(x.shape[1:3])} not divisible by window {window}")
    return x.shape[1] // wh, x.shape[2] // ww


def fold_cpb_bias(bias: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel-ready CPB term ``badd = (bias - rowmax(bias)) - scale``, fp32
    [heads, L, L] (``fold_cpb_bias`` of the JAX package).

    The row max is detached, so d(badd)/d(bias) is the identity; the
    ``- scale`` contributes ``-sum(d_badd)`` over [L, L] to d(scale) through
    autograd, beside the kernel's own dscale. The shift keeps the kernels'
    max-free softmax rigorous: every row keeps one entry with z = 0.
    """
    b32 = bias.float()
    shifted = b32 - torch.amax(b32, dim=-1, keepdim=True).detach()
    return shifted - scale.float()[:, None, None]


def _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd=None,
               unit=None):
    """The forward's recompute in plain ops: (v16, qn16, kn16, inv_q, inv_k, e,
    r), each [Bw, heads, L, *] fp32 (v16, qn16 and kn16 hold bf16 values).
    ``unit``: the head normalization t -> (bf16-valued t * inv, inv), a plain
    row sum of squares unless given."""
    from swin_v2_weather_torch.models.swin import window_partition

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    nwh, nww = _window_grid(x, window)
    l = wh * ww
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads

    bf = torch.bfloat16
    qkv = torch.matmul(x.to(bf).float(), w_qkv.to(bf).float()) + b_qkv.float()
    qkv = window_partition(qkv.to(bf), (wh, ww)).reshape(-1, l, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).float()  # each [Bw, heads, L, hd]

    def plain_unit(t):
        inv = torch.rsqrt(torch.clamp_min(torch.sum(t * t, -1, keepdim=True), 1e-24))
        return (t * inv).to(bf).float(), inv

    unit = unit or plain_unit
    qn, inv_q = unit(q)
    kn, inv_k = unit(k)
    s = torch.matmul(qn, kn.transpose(-1, -2))  # [Bw, heads, L, L]
    sc = scale.float().reshape(1, heads, 1, 1)
    if badd is None:
        z = (s - 1.0) * sc
    else:
        z = s * sc + badd.float().reshape(1, heads, l, l)
    if mask_pattern is not None:
        flag = 1.0 if boundary_flag is None else float(boundary_flag)
        mask = torch.as_tensor(mask_pattern, dtype=torch.float32, device=x.device)
        row_gate = torch.zeros(nwh, dtype=torch.float32, device=x.device)
        row_gate[-1] = flag
        z = z.reshape(b, nwh, nww, heads, l, l) + row_gate.reshape(1, nwh, 1, 1, 1, 1) * mask
        z = z.reshape(-1, heads, l, l)
    e = torch.exp(z)
    r = 1.0 / torch.sum(e, -1, keepdim=True)
    return v, qn, kn, inv_q, inv_k, e, r


def _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd):
    from swin_v2_weather_torch.models.swin import window_reverse

    b, h, w, _ = x.shape
    wh, ww = int(window[0]), int(window[1])
    c = w_qkv.shape[-1] // 3
    v, _, _, _, _, e, r = _recompute(x, w_qkv, b_qkv, scale, window, mask_pattern,
                                     boundary_flag, badd)
    out = torch.matmul(e.to(torch.bfloat16).float(), v) * r  # [Bw, heads, L, hd]
    out = out.to(x.dtype).permute(0, 2, 1, 3).reshape(-1, wh, ww, c)
    return window_reverse(out, (wh, ww), (h, w))


def window_attention_qkv_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask; None means 1
) -> torch.Tensor:
    """Plain version of the fused kernel: [B, H, W, C_in] -> [B, H, W, C]."""
    return _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, None)


def window_attention_qkv_bias_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    badd: torch.Tensor,  # [heads, L, L] fp32, fold_cpb_bias(bias, scale)
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
) -> torch.Tensor:
    """Plain version of K7's forward: the fused kernel with the pre-folded CPB
    term, z = s * scale + badd[h] (+ mask) in fp32 with no max pass."""
    return _plain_forward(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd)


def _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag, badd):
    from swin_v2_weather_torch.models.swin import window_partition, window_reverse

    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    l = wh * ww
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    hd = c // heads
    bf = torch.bfloat16
    sc = scale.float().reshape(1, heads, 1, 1)

    v, qn, kn, inv_q, inv_k, e, r = _recompute(
        x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd
    )
    g16 = window_partition(g.to(bf), (wh, ww)).reshape(-1, l, heads, hd)
    g16 = g16.permute(0, 2, 1, 3).float()  # [Bw, heads, L, hd]

    p16 = (e * r).to(bf).float()
    dv = torch.matmul(p16.transpose(-1, -2), g16)
    dp = torch.matmul(g16, v.transpose(-1, -2))
    u = torch.sum(dp * e, -1, keepdim=True)
    ds = (dp - u * r) * e * (r * sc)
    # d(badd) = ds / scale as the reciprocal product, summed over windows
    dbias = None if badd is None else torch.sum(ds * (1.0 / sc), dim=0)
    dsb = ds.to(bf).float()
    dqn = torch.matmul(dsb, kn)
    dkn = torch.matmul(dsb.transpose(-1, -2), qn)
    qd = torch.sum(qn * dqn, -1, keepdim=True)
    kd = torch.sum(kn * dkn, -1, keepdim=True)
    dscale = torch.sum(qd, dim=(0, 2, 3)) / scale.float()
    dq = (dqn - qn * qd) * inv_q
    dk = (dkn - kn * kd) * inv_k

    # [Bw, heads, L, hd] x 3 -> [Bw, L, 3, heads, hd] -> grid [B, H, W, 3C]
    dqkv = torch.stack([dq, dk, dv], dim=2).to(bf).permute(0, 3, 2, 1, 4)
    dqkv = window_reverse(dqkv.reshape(-1, wh, ww, 3 * c), (wh, ww), (h, w))
    d2 = dqkv.reshape(-1, 3 * c).float()
    x2 = x.reshape(-1, c_in).to(bf).float()
    dx = torch.matmul(d2, w_qkv.to(bf).float().t()).to(x.dtype).reshape(x.shape)
    dw = torch.matmul(x2.t(), d2)
    db = torch.sum(d2, 0)
    return dx, dw, db, dscale, dbias


def window_attention_qkv_backward_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    g: torch.Tensor,  # [B, H, W, C]: cotangent of the output
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
):
    """Plain version of the backward kernel: (dx, dW, db, dscale).

    Follows ``_make_qkv_bwd_kernel``'s rounding sites, not autograd through
    the forward: qkv, qn16, kn16, e and r recomputed as the forward computes
    them; g16 = bf16(g); p16 = bf16(e r); dv = p16^T g16 and dp = g16 v^T in
    fp32; u = sum(dp e); ds = (dp - u r) e (r scale); dsb = bf16(ds);
    dqn = dsb kn16 and dkn = dsb^T qn16; dscale_h = sum(qn16 dqn) / scale_h;
    dq = (dqn - qn16 <qn16, dqn>) inv_q, likewise dk; dqkv = bf16([dq|dk|dv]);
    dx = dqkv bf16(W)^T in x's dtype; dW = bf16(x)^T dqkv, db = sum dqkv and
    dscale in fp32 (the cast to the inputs' dtypes is the caller's, as in
    ``f_bwd``).
    """
    return _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag,
                           None)[:4]


def window_attention_qkv_bias_backward_reference(
    x: torch.Tensor,  # [B, H, W, C_in]
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    badd: torch.Tensor,  # [heads, L, L] fp32
    g: torch.Tensor,  # [B, H, W, C]
    window: Tuple[int, int],
    mask_pattern=None,
    boundary_flag=None,
):
    """Plain version of K7's backward: (dx, dW, db, dscale, dbias).

    The sites of :func:`window_attention_qkv_backward_reference` with the
    forward's z = s * scale + badd; dbias[h] = sum over windows of
    ds * (1 / scale_h) in fp32, ds unrounded (``_make_qkv_bwd_kernel``'s
    ``dsf * (1.0 / scl)``). The dscale identity sum(ds s) = sum(qn16 dqn) /
    scale holds with the bias, since the softmax VJP's rows sum to zero.
    """
    return _plain_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag,
                           badd)


def _check_operands(name, x, w_qkv, b_qkv, scale, window, mask_pattern, g=None, badd=None,
                    w5=None):
    """Device, dtypes, shapes and shape limits of a kernel call, or raise;
    returns (b, h, w, c_in, c, heads, wh, ww, l, variant), the variant that
    launches (:func:`qkv_variant`). ``w5``: K12 v5's reordered weight [3 *
    heads, C_in, hd] (``w_qkv`` may then be None: v5's forward takes only
    w5)."""
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D CUDA tensor, got {x.dim()}-D on {x.device}")
    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    _window_grid(x, window)
    heads = int(scale.shape[0])
    c = heads * w5.shape[-1] if w5 is not None else w_qkv.shape[-1] // 3
    l = wh * ww
    dev = x.device
    _build.check_operand(name, "x", x, torch.bfloat16, (b, h, w, c_in), dev)
    if w5 is not None:
        _build.check_operand(name, "w5", w5, torch.bfloat16, (3 * heads, c_in, c // heads), dev)
    if w_qkv is not None:
        _build.check_operand(name, "w_qkv", w_qkv, torch.bfloat16, (c_in, 3 * c), dev)
    _build.check_operand(name, "b_qkv", b_qkv, torch.float32, (3 * c,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (b, h, w, c), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if badd is not None:
        _build.check_operand(name, "badd", badd, torch.float32, (heads, l, l), dev)
    if c % heads or c_in % 32:
        raise ValueError(f"{name}: needs C % heads == 0 and C_in % 32 == 0; got C={c}, "
                         f"heads={heads}, C_in={c_in}")
    variant = qkv_variant(name, c // heads, l, g is not None)
    return b, h, w, c_in, c, heads, wh, ww, l, variant


def _launch_forward(fn, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag, badd,
                    w5=None):
    """Launch K1 (K7 with ``badd``, K12 v5 with ``w5`` in place of ``w_qkv``):
    the projection on the GEMM core into a [B, H, W, 3C] bf16 scratch dropped
    on return, then the attention pass."""
    name = fn.__name__
    b, h, w, c_in, c, heads, wh, ww, _, _ = _check_operands(
        name, x, w_qkv, b_qkv, scale, window, mask_pattern, badd=badd, w5=w5)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=x.device)
    qkv = torch.empty((b, h, w, 3 * c), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    mask_ptr = None if mask_pattern is None else mask_pattern.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (x.data_ptr(), (w_qkv if w5 is None else w5).data_ptr(), b_qkv.data_ptr(),
                scale.data_ptr())
        tail = (mask_ptr, float(boundary_flag), qkv.data_ptr(), out.data_ptr(),
                b, h, w, c_in, c, heads, wh, ww, stream)
        if w5 is not None:
            code = lib.swin_window_attention_qkv5_fwd(*head, *tail)
        elif badd is None:
            code = lib.swin_window_attention_qkv_fwd(*head, *tail)
        else:
            code = lib.swin_window_attention_qkv_bias_fwd(*head, badd.data_ptr(), *tail)
    _build.check(code, name)
    fn.launches += 1
    # the projection ran on the GEMM core
    gemm_core.count_launches(gemm_core.projection_launches(heads, w5 is not None))
    return out


def window_attention_qkv(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
) -> torch.Tensor:
    """The CUDA kernel: x [B, H, W, C_in] bf16, w_qkv [C_in, 3C] bf16,
    b_qkv [3C] fp32, scale [heads] fp32, mask_pattern [L, L] fp32 or None
    -> [B, H, W, C] bf16.

    C_in must be a multiple of 32 and the head dim one of 32/64/96/128/256
    (:func:`qkv_variant`); any L = wh * ww. The projection runs on the GEMM
    core into a [B, H, W, 3C] bf16 scratch that is dropped on return, then
    the attention pass. Launches on the current stream and does not
    synchronize.
    """
    return _launch_forward(window_attention_qkv, x, w_qkv, b_qkv, scale, window, mask_pattern,
                           boundary_flag, None)


window_attention_qkv.launches = 0


@torch.library.custom_op("swin::window_attention_qkv", mutates_args=())
def window_attention_qkv_op(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                            scale: torch.Tensor, window: List[int],
                            mask_pattern: Optional[torch.Tensor],
                            boundary_flag: float) -> torch.Tensor:
    """K1's launch (:func:`window_attention_qkv`, same operands, ``window`` a
    list) as the custom op ``swin::window_attention_qkv``: the serving forward
    calls it, so ``torch.export`` records one call of it where a ctypes launch
    cannot be traced, and a loaded artifact launches K1 through it (the
    launch counter moves as for a direct call)."""
    return window_attention_qkv(x, w_qkv, b_qkv, scale, tuple(window), mask_pattern,
                                boundary_flag)


@window_attention_qkv_op.register_fake
def _window_attention_qkv_fake(x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
    return x.new_empty((*x.shape[:-1], w_qkv.shape[-1] // 3), dtype=torch.bfloat16)


def window_attention_qkv_bias(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    badd: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
) -> torch.Tensor:
    """K7's forward kernel: :func:`window_attention_qkv` plus the pre-folded CPB
    term badd [heads, L, L] fp32 (row-max-shifted, so the max-free softmax
    holds). Same limits; launches on the current stream."""
    return _launch_forward(window_attention_qkv_bias, x, w_qkv, b_qkv, scale, window,
                           mask_pattern, boundary_flag, badd)


window_attention_qkv_bias.launches = 0


@torch.library.custom_op("swin::window_attention_qkv_bias", mutates_args=())
def window_attention_qkv_bias_op(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                                 scale: torch.Tensor, badd: torch.Tensor, window: List[int],
                                 mask_pattern: Optional[torch.Tensor],
                                 boundary_flag: float) -> torch.Tensor:
    """K7's forward launch (:func:`window_attention_qkv_bias`, ``window`` a
    list) as the custom op ``swin::window_attention_qkv_bias``: the serving
    forward calls it, as K1's (:func:`window_attention_qkv_op`)."""
    return window_attention_qkv_bias(x, w_qkv, b_qkv, scale, badd, tuple(window), mask_pattern,
                                     boundary_flag)


@window_attention_qkv_bias_op.register_fake
def _window_attention_qkv_bias_fake(x, w_qkv, b_qkv, scale, badd, window, mask_pattern,
                                    boundary_flag):
    return x.new_empty((*x.shape[:-1], w_qkv.shape[-1] // 3), dtype=torch.bfloat16)


def _launch_backward(fn, x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag, badd,
                     w5=None):
    """Launch K2 (K7's backward with ``badd``; K12 v5's with ``w5``, the
    recompute reading w5 and dx, dW the packed ``w_qkv``)."""
    name = fn.__name__
    b, h, w, c_in, c, heads, wh, ww, l, variant = _check_operands(
        name, x, w_qkv, b_qkv, scale, window, mask_pattern, g=g, badd=badd, w5=w5)
    nwh, nww = h // wh, w // ww
    dev = x.device
    t = b * h * w
    lp = -(-l // 16) * 16
    if variant == "streamed":
        out = qkv_streamed_bwd(x, w_qkv if w5 is None else w5, w_qkv, b_qkv, scale, badd, g,
                               window, mask_pattern, boundary_flag, hd=c // heads, nwh=nwh,
                               nww=nww, lm=l, var="v3" if w5 is None else "v5")
        fn.launches += 1
        gemm_core.count_launches(gemm_core.projection_launches(heads, w5 is not None) + 2)
        return out
    # token ranges of the split-K dW product (on the GEMM core) and of the db
    # column sums
    dw_splits = gemm_core.split_k(c_in, 3 * c, t)
    db_splits = max(1, min(64, -(-t // 512)))
    n_part = b * nwh * nww  # d(scale) partials: one per window
    f32 = dict(dtype=torch.float32, device=dev)
    # the recomputed projection (the GEMM core's) and its cotangent
    qkv = torch.empty((b, h, w, 3 * c), dtype=torch.bfloat16, device=dev)
    dqkv = torch.empty((b, h, w, 3 * c), dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((dw_splits, c_in, 3 * c), **f32)
    db_part = torch.empty((db_splits, 3 * c), **f32)
    dscale_part = torch.empty((n_part, heads), **f32)
    dx = torch.empty_like(x)
    dw = torch.empty((c_in, 3 * c), **f32)
    db = torch.empty((3 * c,), **f32)
    dscale = torch.empty((heads,), **f32)
    # one fp32 [LP, LP] d(bias) partial per (window, head), summed in window order
    dbias_part = None if badd is None else torch.empty((b * nwh * nww, heads, lp, lp), **f32)
    dbias = None if badd is None else torch.empty((heads, l, l), **f32)
    lib = _build.load_library()
    mask_ptr = None if mask_pattern is None else mask_pattern.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr())
        mid = (mask_ptr, float(boundary_flag), g.data_ptr(), qkv.data_ptr(), dqkv.data_ptr(),
               dw_part.data_ptr(), db_part.data_ptr(), dscale_part.data_ptr())
        outs = (dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dscale.data_ptr())
        dims = (b, h, w, c_in, c, heads, wh, ww, dw_splits, db_splits, stream)
        if w5 is not None:
            code = lib.swin_window_attention_qkv5_bwd(x.data_ptr(), w5.data_ptr(), *head[1:],
                                                      *mid, *outs, *dims)
        elif badd is None:
            code = lib.swin_window_attention_qkv_bwd(*head, *mid, *outs, *dims)
        else:
            code = lib.swin_window_attention_qkv_bias_bwd(
                *head, badd.data_ptr(), *mid, dbias_part.data_ptr(), *outs, dbias.data_ptr(),
                *dims)
    _build.check(code, name)
    fn.launches += 1
    # the GEMM core ran the projection, dx and dW
    gemm_core.count_launches(gemm_core.projection_launches(heads, w5 is not None) + 2)
    return (dx, dw, db, dscale) if badd is None else (dx, dw, db, dscale, dbias)


def window_attention_qkv_bwd(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    g: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
):
    """The CUDA backward kernels: x [B, H, W, C_in] bf16, w_qkv [C_in, 3C] bf16,
    b_qkv [3C] fp32, scale [heads] fp32, g [B, H, W, C] bf16, mask_pattern
    [L, L] fp32 or None -> (dx [B, H, W, C_in] bf16, dW [C_in, 3C] fp32,
    db [3C] fp32, dscale [heads] fp32).

    Same shape limits as the forward kernel; head dims 128 and 256 and
    every head dim past L = 256 take the streamed variant
    (:func:`qkv_variant`, :func:`qkv_streamed_bwd`), the others the
    one-block kernel. Launches on the current stream and does not
    synchronize; dW, db and dscale are summed in a fixed order, so two calls
    give the same bits.
    """
    return _launch_backward(window_attention_qkv_bwd, x, w_qkv, b_qkv, scale, g, window,
                            mask_pattern, boundary_flag, None)


window_attention_qkv_bwd.launches = 0


def window_attention_qkv_bias_bwd(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    scale: torch.Tensor,
    badd: torch.Tensor,
    g: torch.Tensor,
    window: Tuple[int, int],
    mask_pattern: Optional[torch.Tensor] = None,
    boundary_flag: float = 1.0,
):
    """K7's backward kernels: :func:`window_attention_qkv_bwd` with the
    pre-folded CPB term badd [heads, L, L] fp32, returning also dbias
    [heads, L, L] fp32. Every (window, head) writes its d(bias) partial to a
    [B * nW, heads, LP, LP] fp32 workspace (336 MB at the flagship shape) that
    one kernel sums in window order: no atomics, two calls give the same
    bits."""
    return _launch_backward(window_attention_qkv_bias_bwd, x, w_qkv, b_qkv, scale, g, window,
                            mask_pattern, boundary_flag, badd)


window_attention_qkv_bias_bwd.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def qkv_streamed_bwd(x, wr, w, b, scale, badd, g, window, mask_pattern, boundary_flag, *, hd,
                     nwh, nww, lm, var):
    """Launch the streamed backward of the qkv-fused attention
    (``csrc/window_attention_qkv_large.cu``: the recompute with q and k
    normalized in its epilogue, the streamed kernels of
    ``csrc/streamed_bwd.cuh``, the projection backward) on operands the
    caller has checked, and return (dx, dW, db, dscale), plus dbias with the
    folded CPB term ``badd``. ``var`` 'v3' (K2, K7 with ``badd``, K10 where
    w's head pitch ``w.shape[-1] // 3 // heads`` is 128 above ``hd``), 'v5'
    (``wr`` the reordered [3 * heads, C_in, hd] weight of the recompute; dx
    and dW from the packed ``w``) or 'v4' (x and g window-major [B, nW, lm,
    *], ``lm`` rows a window; padded v4 with the head pitch 128). ``wr`` is
    ``w`` but for v5. The caller counts the launch."""
    dev = x.device
    heads, c_in, n = int(scale.shape[0]), x.shape[-1], w.shape[-1]
    wh, ww = int(window[0]), int(window[1])
    t, n_win, lp = x.numel() // c_in, x.shape[0] * nwh * nww, -(-(wh * ww) // 16) * 16
    dw_splits = gemm_core.split_k(c_in, n, t)
    db_splits = max(1, min(64, -(-t // 512)))
    f32 = dict(dtype=torch.float32, device=dev)
    # the recomputed projection (q and k normalized), its cotangent (v4: the
    # raw q and k rows parked there first), the norms and the per-row softmax
    # statistics the two attention kernels share
    qkv = torch.empty((t, n), dtype=torch.bfloat16, device=dev)
    dqkv = torch.empty((t, n), dtype=torch.bfloat16, device=dev)
    inv = torch.empty((t, 2, heads), **f32)
    rstat = torch.empty((n_win, heads, lp, 2), **f32)
    dw_part = torch.empty((dw_splits, c_in, n), **f32)
    db_part = torch.empty((db_splits, n), **f32)
    # d(scale) partials: one per window and block of 64 query rows
    dscale_part = torch.empty((n_win * _row_chunks("streamed", lp), heads), **f32)
    dx, dw, db, dscale = (torch.empty_like(x), torch.empty((c_in, n), **f32),
                          torch.empty((n,), **f32), torch.empty((heads,), **f32))
    # one fp32 [LP, LP] d(bias) partial per (window, head), summed in window order
    dbias_part = None if badd is None else torch.empty((n_win, heads, lp, lp), **f32)
    dbias = None if badd is None else torch.empty((heads, wh * ww, wh * ww), **f32)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swin_window_attention_qkv_streamed_bwd(
            x.data_ptr(), wr.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            _ptr(badd), _ptr(mask_pattern), float(boundary_flag), g.data_ptr(), qkv.data_ptr(),
            inv.data_ptr(), rstat.data_ptr(), dqkv.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dscale_part.data_ptr(), _ptr(dbias_part), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dscale.data_ptr(), _ptr(dbias), x.shape[0], nwh, nww,
            lm, c_in, n // 3, heads, hd, wh, ww, ("v3", "v5", "v4").index(var), dw_splits,
            db_splits, stream)
    _build.check(code, "swin_window_attention_qkv_streamed_bwd")
    return (dx, dw, db, dscale) if badd is None else (dx, dw, db, dscale, dbias)


def _flag(boundary_flag) -> float:
    return 1.0 if boundary_flag is None else float(boundary_flag)


def qkv_xla_backward(x, w_qkv, b_qkv, scale, g, window, mask_pattern, boundary_flag, badd=None):
    """The ``SWIN_QKV_BWD_IMPL='xla'`` backward of the qkv-fused route (the
    JAX package's ``f_bwd`` fallback in ``_build_qkv`` and, with the CPB term,
    ``_build_qkv_bias``): (dx, dW, db, dscale, dbias or None) in fp32 (dx in
    x's dtype).

    In JAX's order: qkv = bf16(x) @ bf16(W) in fp32 + b, cast to x's dtype
    (K1's rounding of the projection, not ``dense()``'s); q and k normalized
    per head (:func:`normalize_heads`); K8's backward on (qn, kn, v) -- with
    the pre-folded CPB term ``badd`` as its bias (softmax-equivalent to the
    raw bias: K8 subtracts the row max; d(badd) = sum over windows of ds);
    :func:`normalize_vjp` into bf16; then dx, dW and db from the
    concatenated bf16 dqkv in plain products (XLA's in JAX). On CUDA tensors
    K8's backward kernel runs (K2 and K7's backward never launch); on the CPU
    its plain version.
    """
    heads = int(scale.shape[0])
    c = w_qkv.shape[-1] // 3
    bf = torch.bfloat16
    x16 = x.reshape(-1, x.shape[-1]).to(bf)
    w16 = w_qkv.to(bf)
    qkv = (matmul_f32(x16, w16) + b_qkv.float()).to(x.dtype).reshape(*x.shape[:-1], 3 * c)
    qn, inv_q = normalize_heads(qkv[..., :c], heads)
    kn, inv_k = normalize_heads(qkv[..., c:2 * c], heads)
    v = qkv[..., 2 * c:]
    flag = _flag(boundary_flag)
    if x.device.type == "cpu":
        grads = window_attention_grid_bias_backward_reference(
            qn, kn, v, scale, badd, g, window, mask_pattern, boundary_flag)
    else:
        args = (qn, kn, v, scale.float().contiguous())
        g16 = g.to(bf).contiguous()
        if badd is None:
            grads = window_attention_grid_bwd(*args, g16, window, mask_pattern, flag)
        else:
            grads = window_attention_grid_bias_bwd(*args, badd.float().contiguous(), g16, window,
                                                   mask_pattern, flag)
    dqn, dkn, dv, dscale = grads[:4]
    dqkv = torch.cat([normalize_vjp(qn, inv_q, dqn, heads, bf),
                      normalize_vjp(kn, inv_k, dkn, heads, bf), dv.to(bf)], dim=-1)
    d2 = dqkv.reshape(-1, 3 * c)
    dx = matmul_f32(d2, w16.t()).to(x.dtype).reshape(x.shape)
    dw = matmul_f32(x16.t(), d2)
    db = torch.sum(d2.float(), 0)
    return dx, dw, db, dscale, (None if badd is None else grads[4])


class WindowAttentionQKV(torch.autograd.Function):
    """Forward K1, backward K2 (or their plain versions for CPU tensors); with
    ``QKV_BWD_IMPL == 'xla'`` the backward is :func:`qkv_xla_backward`.

    Saves (x, w_qkv, b_qkv, scale) and nothing larger, like ``_build_qkv``'s
    ``f_fwd``: the backward recomputes the projection and the softmax. The
    mask pattern and the flag are constants (no gradient, as in JAX, where
    d(flag) is zero).
    """

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
        ctx.save_for_backward(x, w_qkv, b_qkv, scale)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        if x.device.type == "cpu":
            return window_attention_qkv_reference(
                x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag
            )
        return window_attention_qkv(
            x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(), b_qkv.float().contiguous(),
            scale.float().contiguous(), window, mask_pattern, _flag(boundary_flag),
        )

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale = ctx.saved_tensors
        if qkv_bwd_impl() == "xla":
            dx, dw, db, dscale, _ = qkv_xla_backward(
                x, w_qkv, b_qkv, scale, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag)
        elif x.device.type == "cpu":
            dx, dw, db, dscale = window_attention_qkv_backward_reference(
                x, w_qkv, b_qkv, scale, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag
            )
        else:
            dx, dw, db, dscale = window_attention_qkv_bwd(
                x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(),
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                _flag(ctx.boundary_flag),
            )
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype),
                None, None, None)


class WindowAttentionQKVBias(torch.autograd.Function):
    """Forward and backward of K7 (or their plain versions for CPU tensors);
    with ``QKV_BWD_IMPL == 'xla'`` the backward is :func:`qkv_xla_backward`
    on the saved badd.

    ``bias`` is the pre-folded term badd when ``prefolded`` (the model folds
    it with :func:`fold_cpb_bias`, so the fold's ``- scale`` reaches d(scale)
    through autograd there); otherwise the raw [heads, L, L] bias, which is
    row-max-shifted and folded here with no gradient through the fold, as
    ``_build_qkv_bias(prefolded=False)`` does. Saves (x, w_qkv, b_qkv, scale,
    badd), as ``f_fwd`` does; the returned d(bias) is d(badd), in fp32 cast to
    the bias's dtype.
    """

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, bias, prefolded, window, mask_pattern,
                boundary_flag):
        badd = bias.float() if prefolded else fold_cpb_bias(bias, scale)
        ctx.save_for_backward(x, w_qkv, b_qkv, scale, badd)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        ctx.bias_dtype = bias.dtype
        if x.device.type == "cpu":
            return window_attention_qkv_bias_reference(
                x, w_qkv, b_qkv, scale, badd, window, mask_pattern, boundary_flag
            )
        return window_attention_qkv_bias(
            x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(), b_qkv.float().contiguous(),
            scale.float().contiguous(), badd.contiguous(), window, mask_pattern,
            _flag(boundary_flag),
        )

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale, badd = ctx.saved_tensors
        if qkv_bwd_impl() == "xla":
            dx, dw, db, dscale, dbias = qkv_xla_backward(
                x, w_qkv, b_qkv, scale, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag,
                badd)
        elif x.device.type == "cpu":
            dx, dw, db, dscale, dbias = window_attention_qkv_bias_backward_reference(
                x, w_qkv, b_qkv, scale, badd, g, ctx.window, ctx.mask_pattern,
                ctx.boundary_flag
            )
        else:
            dx, dw, db, dscale, dbias = window_attention_qkv_bias_bwd(
                x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(), badd.contiguous(),
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                _flag(ctx.boundary_flag),
            )
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None, None)


def fused_window_attention_qkv(
    x: torch.Tensor,  # [B, H, W, C_in] (already rolled for shifted blocks)
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask (spatial sharding)
    impl: Optional[str] = None,  # None = the module default (QKV_IMPL)
    bias: Optional[torch.Tensor] = None,  # CPB [heads, L, L]
    bias_prefolded: bool = False,  # bias is already fold_cpb_bias(raw, scale)
) -> torch.Tensor:
    """qkv projection + window attention fused: [B,H,W,Cin] -> [B,H,W,C],
    differentiable in x, w_qkv, b_qkv, scale and the CPB bias. With a bias,
    K7's route whatever the selected variant, as in JAX; otherwise ``impl``
    (or ``QKV_IMPL``): ``'v3'`` K1/K2, ``'v5'`` and ``'v4'`` the K12 schedules
    (``ops/attic/window_attention_v45.py``; v4 with padded heads when
    ``QKV_PAD_HEADS`` is on and the head dim is not a multiple of 128).
    ``'v6'`` has another output contract
    (:func:`fused_window_attention_qkv_padded`) and raises here, as in JAX."""
    _window_grid(x, window)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention_qkv: no implementation for device {x.device}")
    mask_pattern = _mask_on(x, mask_pattern)
    # serving: the forward kernel through its custom op (torch.export traces
    # it); the autograd Function makes the same launch
    served = x.device.type == "cuda" and not torch.is_grad_enabled()
    if bias is None:
        sel = impl or qkv_impl()
        if sel in ("v4", "v5"):
            # the A/B schedules live in ops/attic/, imported on first use as in JAX
            from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

            if sel == "v5":
                if served:
                    return v45.served_qkv5(x, w_qkv, b_qkv, scale, window, mask_pattern,
                                           boundary_flag)
                return v45.WindowAttentionQKV5.apply(x, w_qkv, b_qkv, scale, tuple(window),
                                                     mask_pattern, boundary_flag)
            hd = int(w_qkv.shape[-1]) // 3 // int(scale.shape[0])
            pad = v45.QKV_PAD_HEADS and hd % HD_PAD != 0
            if served:
                return v45.qkv4_forward(x, w_qkv, b_qkv, scale, tuple(window), mask_pattern,
                                        boundary_flag, pad, served=True)
            return v45.WindowAttentionQKV4.apply(x, w_qkv, b_qkv, scale, tuple(window),
                                                 mask_pattern, boundary_flag, pad)
        if sel == "v6":
            raise ValueError(
                "impl 'v6' returns a padded [B,H,W,heads*128] output; call "
                "fused_window_attention_qkv_padded (the caller must absorb the padding into "
                "the following matmul)")
        if served:
            return window_attention_qkv_op(
                x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(),
                b_qkv.float().contiguous(), scale.float().contiguous(), list(window),
                mask_pattern, _flag(boundary_flag))
        return WindowAttentionQKV.apply(
            x, w_qkv, b_qkv, scale, tuple(window), mask_pattern, boundary_flag
        )
    _check_bias("fused_window_attention_qkv", bias, int(scale.shape[0]),
                int(window[0]) * int(window[1]))
    if served:  # K7, with WindowAttentionQKVBias's fold
        badd = bias.float() if bias_prefolded else fold_cpb_bias(bias, scale)
        return window_attention_qkv_bias_op(
            x.contiguous(), w_qkv.to(torch.bfloat16).contiguous(), b_qkv.float().contiguous(),
            scale.float().contiguous(), badd.contiguous(), list(window), mask_pattern,
            _flag(boundary_flag))
    return WindowAttentionQKVBias.apply(
        x, w_qkv, b_qkv, scale, bias, bool(bias_prefolded), tuple(window), mask_pattern,
        boundary_flag,
    )


# ---------------------------------------------------------------------------
# v6: the padded-head route (K10)
# ---------------------------------------------------------------------------
#
# Counterpart of ``fused_window_attention_qkv_padded`` (``_qkv6_forward`` /
# ``_qkv6_backward``, custom_vjp ``_build_qkv6``) of the JAX package: v3's math
# on weights whose per-head columns are zero-padded to 128 lanes, returning
# [B, H, W, heads * 128] with the pad lanes exactly zero; the caller absorbs
# the padding into the output projection (:func:`pad_proj_rows`). K10
# (``csrc/window_attention_qkv.cu``, ``window_attention_qkv_bwd.cu``) computes
# on the live head-dim lanes only and writes zeros in the pad lanes.

HD_PAD = 128  # the padded head width of the v6 route


def pad_heads_w(w_qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """[C_in, 3C] -> [C_in, 3 * heads * 128]: each head's columns zero-padded."""
    c_in, c3 = w_qkv.shape
    hd = c3 // 3 // heads
    w4 = torch.nn.functional.pad(w_qkv.reshape(c_in, 3, heads, hd), (0, HD_PAD - hd))
    return w4.reshape(c_in, 3 * heads * HD_PAD)


def pad_heads_vec(b_qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """[3C] -> [3 * heads * 128], each head's entries zero-padded."""
    hd = b_qkv.shape[-1] // 3 // heads
    return torch.nn.functional.pad(b_qkv.reshape(3, heads, hd), (0, HD_PAD - hd)).reshape(-1)


def unpad_heads(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """[..., heads * 128] -> [..., heads * hd]: the live lanes of each head."""
    shp = x.shape[:-1]
    return x.reshape(*shp, heads, HD_PAD)[..., :hd].reshape(*shp, heads * hd)


def pad_heads_x(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """[..., heads * hd] -> [..., heads * 128], zero-padded per head."""
    shp = x.shape[:-1]
    return torch.nn.functional.pad(x.reshape(*shp, heads, hd), (0, HD_PAD - hd)).reshape(
        *shp, heads * HD_PAD)


def pad_proj_rows(w_proj: torch.Tensor, heads: int) -> torch.Tensor:
    """[heads * hd, F] -> [heads * 128, F]: zero rows for the pad lanes, so
    ``padded_out @ pad_proj_rows(W) == out @ W`` exactly."""
    chd, f = w_proj.shape
    hd = chd // heads
    w = torch.nn.functional.pad(w_proj.reshape(heads, hd, f), (0, 0, 0, HD_PAD - hd))
    return w.reshape(heads * HD_PAD, f)


def window_attention_qkv_padded_reference(x, wp, bp, scale, hd, window, mask_pattern=None,
                                          boundary_flag=None):
    """Plain version of K10's forward: x [B, H, W, C_in], wp [C_in, 3 * heads
    * 128], bp [3 * heads * 128] (head-padded), scale [heads], the live head
    dim ``hd`` -> [B, H, W, heads * 128] with the pad lanes exactly zero. v3's
    sites (:func:`window_attention_qkv_reference`) on the live lanes."""
    heads = int(scale.shape[0])
    out = window_attention_qkv_reference(x, unpad_heads(wp, 3 * heads, hd),
                                         unpad_heads(bp, 3 * heads, hd), scale, window,
                                         mask_pattern, boundary_flag)
    return pad_heads_x(out, heads, hd)


def window_attention_qkv_padded_backward_reference(x, wp, bp, scale, hd, g, window,
                                                   mask_pattern=None, boundary_flag=None):
    """Plain version of K10's backward: (dx, dWp [C_in, 3 * heads * 128], dbp
    [3 * heads * 128], dscale), g [B, H, W, heads * 128] (its pad lanes are
    not read); the pad columns of dWp and dbp exactly zero. v3's sites
    (:func:`window_attention_qkv_backward_reference`) on the live lanes."""
    heads = int(scale.shape[0])
    dx, dw, db, dscale = window_attention_qkv_backward_reference(
        x, unpad_heads(wp, 3 * heads, hd), unpad_heads(bp, 3 * heads, hd), scale,
        unpad_heads(g, heads, hd), window, mask_pattern, boundary_flag)
    return dx, pad_heads_w(dw, heads), pad_heads_vec(db, heads), dscale


def _check_padded_operands(name, x, wp, bp, scale, hd, window, mask_pattern, g=None):
    """-> (b, h, w, c_in, heads, wh, ww, l, variant); raises on a shape K10
    does not take. The backward's variant as :func:`qkv_variant` picks it
    (``'base'``, the one-block pass, where it fits, else ``'streamed'``)."""
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D CUDA tensor, got {x.dim()}-D on {x.device}")
    b, h, w, c_in = x.shape
    wh, ww = int(window[0]), int(window[1])
    _window_grid(x, window)
    heads, l, dev = int(scale.shape[0]), wh * ww, x.device
    cp = heads * HD_PAD
    _build.check_operand(name, "x", x, torch.bfloat16, (b, h, w, c_in), dev)
    _build.check_operand(name, "wp", wp, torch.bfloat16, (c_in, 3 * cp), dev)
    _build.check_operand(name, "bp", bp, torch.float32, (3 * cp,), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (b, h, w, cp), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if hd not in (32, 64, 96, 128) or c_in % 32:
        raise ValueError(f"{name}: needs head dim in (32, 64, 96, 128) and C_in % 32 == 0; got "
                         f"head dim {hd}, C_in={c_in}")
    # the backward's one-block pass where it fits, else the streamed one
    variant = None if g is None else qkv_variant(name, hd, l, True)
    return b, h, w, c_in, heads, wh, ww, l, variant


def window_attention_qkv_padded(x, wp, bp, scale, hd, window, mask_pattern=None,
                                boundary_flag=1.0):
    """K10's forward kernel: x [B, H, W, C_in] bf16, wp [C_in, 3 * heads * 128]
    bf16, bp [3 * heads * 128] fp32, scale [heads] fp32, the live head dim
    ``hd`` (32/64/96/128), mask_pattern [L, L] fp32 or None -> [B, H, W,
    heads * 128] bf16, pad lanes zero. Launches on the current stream."""
    name = "window_attention_qkv_padded"
    b, h, w, c_in, heads, wh, ww, _, _ = _check_padded_operands(name, x, wp, bp, scale, hd,
                                                                window, mask_pattern)
    out = torch.empty((b, h, w, heads * HD_PAD), dtype=torch.bfloat16, device=x.device)
    qkv = torch.empty((b, h, w, 3 * heads * HD_PAD), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.swin_window_attention_qkv_padded_fwd(
            x.data_ptr(), wp.data_ptr(), bp.data_ptr(), scale.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
            qkv.data_ptr(), out.data_ptr(), b, h, w, c_in, heads, hd, wh, ww, stream)
    _build.check(code, name)
    window_attention_qkv_padded.launches += 1
    gemm_core.count_launches(1)  # the padded projection on the GEMM core
    return out


window_attention_qkv_padded.launches = 0


@torch.library.custom_op("swin::window_attention_qkv_padded", mutates_args=())
def window_attention_qkv_padded_op(x: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                                   scale: torch.Tensor, hd: int, window: List[int],
                                   mask_pattern: Optional[torch.Tensor],
                                   boundary_flag: float) -> torch.Tensor:
    """K10's forward launch (:func:`window_attention_qkv_padded`) as the
    custom op ``swin::window_attention_qkv_padded``."""
    return window_attention_qkv_padded(x, wp, bp, scale, hd, tuple(window), mask_pattern,
                                       boundary_flag)


@window_attention_qkv_padded_op.register_fake
def _window_attention_qkv_padded_fake(x, wp, bp, scale, hd, window, mask_pattern,
                                      boundary_flag):
    return x.new_empty((*x.shape[:-1], scale.shape[0] * HD_PAD), dtype=torch.bfloat16)


def window_attention_qkv_padded_bwd(x, wp, bp, scale, hd, g, window, mask_pattern=None,
                                    boundary_flag=1.0):
    """K10's backward kernels: the operands of :func:`window_attention_qkv_padded`
    and g [B, H, W, heads * 128] bf16 -> (dx [B, H, W, C_in] bf16, dWp [C_in,
    3 * heads * 128], dbp [3 * heads * 128] with exact-zero pad columns, dscale
    [heads], all fp32 but dx). Summed in a fixed order: two calls give the
    same bits."""
    name = "window_attention_qkv_padded_bwd"
    b, h, w, c_in, heads, wh, ww, l, variant = _check_padded_operands(
        name, x, wp, bp, scale, hd, window, mask_pattern, g)
    if variant == "streamed":
        out = qkv_streamed_bwd(x, wp, wp, bp, scale, None, g, window, mask_pattern,
                               boundary_flag, hd=hd, nwh=h // wh, nww=w // ww, lm=l, var="v3")
        window_attention_qkv_padded_bwd.launches += 1
        gemm_core.count_launches(3)  # the projection, dx and dW on the GEMM core
        return out
    dev, t, n = x.device, b * h * w, 3 * heads * HD_PAD
    dw_splits = gemm_core.split_k(c_in, n, t)
    db_splits = max(1, min(64, -(-t // 512)))
    f32 = dict(dtype=torch.float32, device=dev)
    qkv = torch.empty((b, h, w, n), dtype=torch.bfloat16, device=dev)
    dqkv = torch.empty((b, h, w, n), dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((dw_splits, c_in, n), **f32)
    db_part = torch.empty((db_splits, n), **f32)
    dscale_part = torch.empty((b * (h // wh) * (w // ww), heads), **f32)
    dx = torch.empty_like(x)
    dwp, dbp, dscale = torch.empty((c_in, n), **f32), torch.empty((n,), **f32), torch.empty(
        (heads,), **f32)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swin_window_attention_qkv_padded_bwd(
            x.data_ptr(), wp.data_ptr(), bp.data_ptr(), scale.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
            g.data_ptr(), qkv.data_ptr(), dqkv.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dscale_part.data_ptr(), dx.data_ptr(), dwp.data_ptr(),
            dbp.data_ptr(),
            dscale.data_ptr(), b, h, w, c_in, heads, hd, wh, ww, dw_splits, db_splits, stream)
    _build.check(code, name)
    window_attention_qkv_padded_bwd.launches += 1
    gemm_core.count_launches(3)  # the projection, dx and dW on the GEMM core
    return dx, dwp, dbp, dscale


window_attention_qkv_padded_bwd.launches = 0


class WindowAttentionQKVPadded(torch.autograd.Function):
    """K10 forward and backward (or their plain versions for CPU tensors).
    Saves (x, w_qkv, b_qkv, scale), as ``_build_qkv6``'s ``f_fwd`` does; the
    weights are padded in both passes and the padded weight gradients
    unpadded before they leave (dW, db in the dtypes of w_qkv, b_qkv)."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, scale, window, mask_pattern, boundary_flag):
        ctx.save_for_backward(x, w_qkv, b_qkv, scale)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        heads = int(scale.shape[0])
        hd = w_qkv.shape[-1] // 3 // heads
        wp = pad_heads_w(w_qkv.to(torch.bfloat16), heads)
        bp = pad_heads_vec(b_qkv.float(), heads)
        if x.device.type == "cpu":
            return window_attention_qkv_padded_reference(x, wp, bp, scale, hd, window,
                                                         mask_pattern, boundary_flag)
        return window_attention_qkv_padded(x.contiguous(), wp.contiguous(), bp.contiguous(),
                                           scale.float().contiguous(), hd, window, mask_pattern,
                                           _flag(boundary_flag))

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, scale = ctx.saved_tensors
        heads = int(scale.shape[0])
        hd = w_qkv.shape[-1] // 3 // heads
        wp = pad_heads_w(w_qkv.to(torch.bfloat16), heads)
        bp = pad_heads_vec(b_qkv.float(), heads)
        if x.device.type == "cpu":
            dx, dwp, dbp, dscale = window_attention_qkv_padded_backward_reference(
                x, wp, bp, scale, hd, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag)
        else:
            dx, dwp, dbp, dscale = window_attention_qkv_padded_bwd(
                x.contiguous(), wp.contiguous(), bp.contiguous(), scale.float().contiguous(), hd,
                g.to(torch.bfloat16).contiguous(), ctx.window, ctx.mask_pattern,
                _flag(ctx.boundary_flag))
        dw = unpad_heads(dwp, 3 * heads, hd).reshape(w_qkv.shape)
        db = unpad_heads(dbp, 3 * heads, hd).reshape(b_qkv.shape)
        return (dx, dw.to(w_qkv.dtype), db.to(b_qkv.dtype), dscale.to(scale.dtype), None, None,
                None)


def fused_window_attention_qkv_padded(
    x: torch.Tensor,  # [B, H, W, C_in] (already rolled for shifted blocks)
    w_qkv: torch.Tensor,  # [C_in, 3C]
    b_qkv: torch.Tensor,  # [3C]
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask (spatial sharding)
) -> torch.Tensor:
    """v6 qkv-fused window attention: [B, H, W, C_in] -> [B, H, W, heads * 128],
    each head at a 128-lane offset with the pad lanes exactly zero; absorb
    the padding into the next matmul with :func:`pad_proj_rows`.
    Differentiable in x, w_qkv, b_qkv and scale (K10 on CUDA tensors, its
    plain versions on CPU tensors)."""
    _window_grid(x, window)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention_qkv_padded: no implementation for device "
                         f"{x.device}")
    heads = int(scale.shape[0])
    hd = int(w_qkv.shape[-1]) // 3 // heads
    if hd > HD_PAD:
        raise ValueError(f"head_dim {hd} > {HD_PAD} unsupported by the v6 kernel")
    mask_pattern = _mask_on(x, mask_pattern)
    if x.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K10 through its custom op, on WindowAttentionQKVPadded's padding
        wp = pad_heads_w(w_qkv.to(torch.bfloat16), heads)
        bp = pad_heads_vec(b_qkv.float(), heads)
        return window_attention_qkv_padded_op(x.contiguous(), wp.contiguous(), bp.contiguous(),
                                              scale.float().contiguous(), hd, list(window),
                                              mask_pattern, _flag(boundary_flag))
    return WindowAttentionQKVPadded.apply(x, w_qkv, b_qkv, scale, tuple(window), mask_pattern,
                                          boundary_flag)


# ---------------------------------------------------------------------------
# attention on pre-projected q, k, v: the grid route (K8, attn_impl 'pallas')
# and the windowed route (K9, attn_impl 'pallas_v1')
# ---------------------------------------------------------------------------
#
# Counterparts of ``fused_window_attention_grid`` (``_grid_forward`` /
# ``_grid_backward``, custom_vjp ``_build_grid``) and ``fused_window_attention``
# (``_pallas_forward`` / ``_v1_backward``, custom_vjp ``_build``) of the JAX
# package. Both take the raw CPB bias [heads, L, L] (no row-max shift, no
# fold): unlike K1/K7 their softmax subtracts the row max. Their rounding
# sites differ:
#
#   * K8 (grid layout [B, H, W, C]): q and k arrive L2-normalized per head
#     (:func:`normalize_heads`, outside the kernel, whose VJP
#     :func:`normalize_vjp` also runs outside); qn16, kn16, v16 = bf16 of the
#     inputs; s = qn16 kn16^T in fp32; z = s * scale_h (+ bias_h) (+ gate *
#     mask on the last window row); e = exp(z - max z); p16 = bf16(e * (1 /
#     sum e)); out = p16 v16 in fp32, cast to v's dtype.
#   * K9 (windowed layout [Bw, heads, L, D]): q and k are normalized inside,
#     in fp32 (qn = q * rsqrt(max(sum q^2, 1e-24))); s = bf16(qn) bf16(kn)^T;
#     z as above with the gate 1 on window row (i // nww) % nwh == nwh - 1;
#     p = e / sum e (a division); out = bf16(p) bf16(v), cast to v's dtype.


def normalize_heads(x: torch.Tensor, heads: int):
    """Per-head L2 normalization in fp32 (``_normalize_heads``): (x / |x| per
    head in x's dtype, inv fp32 [..., heads]), inv = rsqrt(max(sum x^2, 1e-24))."""
    c = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], heads, c // heads)
    inv = torch.rsqrt(torch.clamp_min(torch.sum(xf * xf, -1), 1e-24))
    return (xf * inv[..., None]).reshape(x.shape).to(x.dtype), inv


def normalize_vjp(xn: torch.Tensor, inv: torch.Tensor, dxn: torch.Tensor, heads: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Chain rule through x / |x| per head (``_normalize_vjp``), in fp32:
    dx = (dxn - xn <xn, dxn>_head) * inv, cast to ``out_dtype``."""
    c = xn.shape[-1]
    shape = (*xn.shape[:-1], heads, c // heads)
    xnf, dxnf = xn.float().reshape(shape), dxn.float().reshape(shape)
    ip = torch.sum(xnf * dxnf, -1, keepdim=True)
    return ((dxnf - xnf * ip) * inv[..., None]).reshape(xn.shape).to(out_dtype)


def _grid_to_windows(t: torch.Tensor, window, heads: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, heads, L, C / heads] (h-major window order)."""
    from swin_v2_weather_torch.models.swin import window_partition

    wh, ww = int(window[0]), int(window[1])
    c = t.shape[-1]
    return window_partition(t, (wh, ww)).reshape(-1, wh * ww, heads, c // heads).permute(
        0, 2, 1, 3)


def _windows_to_grid(t: torch.Tensor, window, img_size) -> torch.Tensor:
    """[B * nW, heads, L, hd] -> [B, H, W, heads * hd]."""
    from swin_v2_weather_torch.models.swin import window_reverse

    wh, ww = int(window[0]), int(window[1])
    bw, heads, _, hd = t.shape
    return window_reverse(t.permute(0, 2, 1, 3).reshape(bw, wh, ww, heads * hd), (wh, ww),
                          img_size)


def _logits(s, scale, bias, mask_pattern, gate, window_grid):
    """z = s * scale_h (+ bias_h) (+ gate * mask on the last window row), fp32
    [Bw, heads, L, L]; windows in h-major order of ``window_grid``."""
    heads, l = s.shape[1], s.shape[-1]
    z = s * scale.float().reshape(1, heads, 1, 1)
    if bias is not None:
        z = z + bias.float().reshape(1, heads, l, l)
    if mask_pattern is not None:
        nwh, nww = window_grid
        mask = torch.as_tensor(mask_pattern, dtype=torch.float32, device=s.device)
        row_gate = torch.zeros(nwh, dtype=torch.float32, device=s.device)
        row_gate[-1] = gate
        z = z.reshape(-1, nwh, nww, heads, l, l) + row_gate.reshape(1, nwh, 1, 1, 1, 1) * mask
        z = z.reshape(s.shape)
    return z


def reference_attention(q, k, v, scale, bias, mask_pattern, window_grid):
    """The fp32 oracle of the JAX tests (``reference_attention``) on
    [Bw, heads, L, D]: q, k normalized in fp32, s = bf16(qn) bf16(kn)^T,
    * scale (+ bias) (+ mask on the last window row), fp32 softmax, then p
    in v's dtype times v, accumulated in fp32 and cast to v's dtype."""
    def unit(t):
        tf = t.float()
        return tf * torch.rsqrt(torch.clamp_min(torch.sum(tf * tf, -1, keepdim=True), 1e-24))

    bf = torch.bfloat16
    s = torch.matmul(unit(q).to(bf).float(), unit(k).to(bf).float().transpose(-1, -2))
    p = torch.softmax(_logits(s, scale, bias, mask_pattern, 1.0, window_grid), -1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def _grid_recompute(qn, kn, v, scale, window, bias, mask_pattern, boundary_flag):
    """K8's forward in plain ops: (qn16, kn16, v16, e, r), each windowed
    [Bw, heads, L, *] fp32 (the first three holding bf16 values)."""
    heads = int(scale.shape[0])
    grid = _window_grid(qn, window)
    bf = torch.bfloat16
    qw, kw, vw = (_grid_to_windows(t.to(bf), window, heads).float() for t in (qn, kn, v))
    z = _logits(torch.matmul(qw, kw.transpose(-1, -2)), scale, bias, mask_pattern,
                _flag(boundary_flag), grid)
    e = torch.exp(z - torch.amax(z, -1, keepdim=True))
    r = 1.0 / torch.sum(e, -1, keepdim=True)
    return qw, kw, vw, e, r


def window_attention_grid_reference(qn, kn, v, scale, window, mask_pattern=None,
                                    boundary_flag=None):
    """Plain version of K8's forward: qn, kn, v [B, H, W, C] (q and k already
    normalized per head), scale [heads] -> [B, H, W, C] in v's dtype."""
    return window_attention_grid_bias_reference(qn, kn, v, scale, None, window, mask_pattern,
                                                boundary_flag)


def window_attention_grid_bias_reference(qn, kn, v, scale, bias, window, mask_pattern=None,
                                         boundary_flag=None):
    """Plain version of K8's BIAS forward: the raw bias [heads, L, L] (or None)
    joins the logits before the max pass."""
    _, _, vw, e, r = _grid_recompute(qn, kn, v, scale, window, bias, mask_pattern,
                                     boundary_flag)
    out = torch.matmul((e * r).to(torch.bfloat16).float(), vw)
    return _windows_to_grid(out.to(v.dtype), window, tuple(v.shape[1:3]))


def _grid_backward_plain(qn, kn, v, scale, bias, g, window, mask_pattern, boundary_flag):
    heads = int(scale.shape[0])
    qw, kw, vw, e, r = _grid_recompute(qn, kn, v, scale, window, bias, mask_pattern,
                                       boundary_flag)
    bf = torch.bfloat16
    g16 = _grid_to_windows(g.to(bf), window, heads).float()
    dv = torch.matmul((e * r).to(bf).float().transpose(-1, -2), g16)
    dp = torch.matmul(g16, vw.transpose(-1, -2))
    u = torch.sum(dp * e, -1, keepdim=True)
    ds = (dp - u * r) * e * r  # unscaled: feeds d(bias) as it is
    dbias = None if bias is None else torch.sum(ds, 0)
    dsb = (ds * scale.float().reshape(1, heads, 1, 1)).to(bf).float()
    dqn = torch.matmul(dsb, kw)
    dkn = torch.matmul(dsb.transpose(-1, -2), qw)
    dscale = torch.sum(qw * dqn, dim=(0, 2, 3)) / scale.float()
    hw = tuple(qn.shape[1:3])
    grads = (_windows_to_grid(dqn.to(qn.dtype), window, hw),
             _windows_to_grid(dkn.to(kn.dtype), window, hw),
             _windows_to_grid(dv.to(v.dtype), window, hw), dscale)
    return grads if bias is None else (*grads, dbias)


def window_attention_grid_backward_reference(qn, kn, v, scale, g, window, mask_pattern=None,
                                             boundary_flag=None):
    """Plain version of K8's backward: (dqn, dkn, dv, dscale), following
    ``_make_grid_bwd_kernel``'s sites: the forward's e and r = 1 / sum e
    recomputed; g16 = bf16(g); dv = bf16(e r)^T g16 and dp = g16 v16^T in
    fp32; ds = (dp - sum(dp e) r) e r; dsb = bf16(ds * scale_h); dqn = dsb
    kn16 and dkn = dsb^T qn16, cast to q's and k's dtypes (the normalization
    VJP is the caller's); dscale_h = sum(qn16 dqn) / scale_h in fp32."""
    return _grid_backward_plain(qn, kn, v, scale, None, g, window, mask_pattern, boundary_flag)


def window_attention_grid_bias_backward_reference(qn, kn, v, scale, bias, g, window,
                                                  mask_pattern=None, boundary_flag=None):
    """Plain version of K8's BIAS backward: the bias-free sites plus d(bias) =
    the sum over windows of ds, unscaled, fp32 [heads, L, L]."""
    return _grid_backward_plain(qn, kn, v, scale, bias, g, window, mask_pattern, boundary_flag)


def _v1_recompute(q, k, scale, window_grid, bias, mask_pattern):
    """K9's forward in plain ops: (qn, kn, inv_q, inv_k, s, p) in fp32; qn and
    kn unrounded, s = bf16(qn) bf16(kn)^T, p = e / sum e."""
    def unit(t):
        tf = t.float()
        inv = torch.rsqrt(torch.clamp_min(torch.sum(tf * tf, -1, keepdim=True), 1e-24))
        return tf * inv, inv

    bf = torch.bfloat16
    qn, inv_q = unit(q)
    kn, inv_k = unit(k)
    s = torch.matmul(qn.to(bf).float(), kn.to(bf).float().transpose(-1, -2))
    z = _logits(s, scale, bias, mask_pattern, 1.0, window_grid)
    e = torch.exp(z - torch.amax(z, -1, keepdim=True))
    return qn, kn, inv_q, inv_k, s, e / torch.sum(e, -1, keepdim=True)


def _check_window_grid(q, window_grid):
    if window_grid is None:
        raise ValueError("window_grid=(n_window_rows, n_windows_per_row) is required")
    nwh, nww = int(window_grid[0]), int(window_grid[1])
    if q.shape[0] % (nwh * nww):
        raise ValueError(f"Bw={q.shape[0]} not a multiple of window grid {nwh}x{nww}")
    return nwh, nww


def window_attention_v1_reference(q, k, v, scale, window_grid, mask_pattern=None):
    """Plain version of K9's forward: q, k, v [Bw, heads, L, D], scale [heads]
    -> [Bw, heads, L, D] in v's dtype."""
    return window_attention_v1_bias_reference(q, k, v, scale, None, window_grid, mask_pattern)


def window_attention_v1_bias_reference(q, k, v, scale, bias, window_grid, mask_pattern=None):
    """Plain version of K9's BIAS forward (raw bias [heads, L, L] or None)."""
    grid = _check_window_grid(q, window_grid)
    *_, p = _v1_recompute(q, k, scale, grid, bias, mask_pattern)
    bf = torch.bfloat16
    return torch.matmul(p.to(bf).float(), v.to(bf).float()).to(v.dtype)


def _v1_backward_plain(q, k, v, scale, bias, g, window_grid, mask_pattern):
    grid = _check_window_grid(q, window_grid)
    heads = int(scale.shape[0])
    qn, kn, inv_q, inv_k, s, p = _v1_recompute(q, k, scale, grid, bias, mask_pattern)
    bf = torch.bfloat16
    g16 = g.to(bf).float()
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), g16)
    dp = torch.matmul(g16, v.to(bf).float().transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, -1, keepdim=True))
    dscale = torch.sum(ds * s, dim=(0, 2, 3))
    dbias = None if bias is None else torch.sum(ds, 0)
    dsb = (ds * scale.float().reshape(1, heads, 1, 1)).to(bf).float()
    dqn = torch.matmul(dsb, kn.to(bf).float())
    dkn = torch.matmul(dsb.transpose(-1, -2), qn.to(bf).float())
    dq = (dqn - qn * torch.sum(qn * dqn, -1, keepdim=True)) * inv_q
    dk = (dkn - kn * torch.sum(kn * dkn, -1, keepdim=True)) * inv_k
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dscale)
    return grads if bias is None else (*grads, dbias)


def window_attention_v1_backward_reference(q, k, v, scale, g, window_grid, mask_pattern=None):
    """Plain version of K9's backward: (dq, dk, dv, dscale), following
    ``_make_v1_bwd_kernel``'s sites: p recomputed; g16 = bf16(g); dv =
    bf16(p)^T g16, dp = g16 bf16(v)^T; ds = p (dp - sum(dp p)); dscale_h =
    sum(ds * s) taken directly; dsb = bf16(ds * scale_h); dqn = dsb bf16(kn),
    dkn = dsb^T bf16(qn); the normalization VJP on the fp32 qn and kn:
    dq = (dqn - qn <qn, dqn>) inv_q, cast to q's dtype (likewise dk)."""
    return _v1_backward_plain(q, k, v, scale, None, g, window_grid, mask_pattern)


def window_attention_v1_bias_backward_reference(q, k, v, scale, bias, g, window_grid,
                                                mask_pattern=None):
    """Plain version of K9's BIAS backward: plus d(bias) = sum over windows of
    ds, fp32 [heads, L, L]."""
    return _v1_backward_plain(q, k, v, scale, bias, g, window_grid, mask_pattern)


# --- the CUDA kernels (csrc/qkv_attention.cuh, window_attention_{grid,v1}.cu) ---


ATTN_FWD_HEAD_DIMS = (32, 64, 96, 128, 256)
ATTN_FWD_ZL = 192  # the longest window whose z the forward keeps in registers


def attn_fwd_plan(hd: int, l: int, ltab: Optional[int] = None) -> dict:
    """The K8/K9 forward's launch at head dim ``hd`` and window length ``l``,
    as ``FwdShape``/``fwd_plan`` in ``csrc/qkv_attention.cuh`` compute it:
    ``z`` (L <= 192: each warp keeps the z of its keys in registers and
    sweep 2 streams only v), ``rt`` 16-row query tiles a block (two warps
    each, each warp taking ``nt`` 8-key score tiles of a step), ``nchunk``
    blocks per (window, head), ``threads`` a block and ``smem`` bytes: the q
    rows, a ring of ``ns`` stages of ``ks`` keys (k and v tiles, or one of
    them on the z path), the warp pairs' p exchange (``nt`` KB) and row
    statistics (256 B) per tile, and a table of L 4-byte words (K8's token
    pixels, K9's key norms; ``ltab`` words where given: the qkv-fused
    forwards' token rows, :func:`qkv_fwd_plan`)."""
    z = l <= ATTN_FWD_ZL
    nt, rt_max = 2, (3 if hd > 128 else 4)
    ks = 32 if hd > 128 or not z else 64
    ns = 3 if hd > 128 and not z else 4
    tiles = 1 if z else 2
    ntiles = -(-l // 16)
    nchunk = -(-ntiles // rt_max)
    rt = -(-ntiles // nchunk)
    smem = ((rt * 16 + tiles * ns * ks) * (hd + 8) * 2 + rt * (nt * 1024 + 256)
            + ((l if ltab is None else ltab) + 3) // 4 * 16)
    return {"z": z, "rt": rt, "nchunk": nchunk, "threads": rt * 64, "nt": nt, "ks": ks,
            "ns": ns, "smem": smem}


ATTN_LAYOUTS = ("grid", "v1")  # K8's NHWC grid, K9's windowed [Bw, heads, L, hd]


def attn_smem_bytes(hd: int, l: int, layout: str = "grid") -> dict:
    """Shared memory (bytes) of each K8 (``layout`` 'grid') or K9 ('v1')
    kernel at head dim ``hd`` and window length ``l``, as the CUDA sources
    compute it: ``fwd`` of the streamed forward (:func:`attn_fwd_plan`) and
    ``streamed_rows``/``streamed_cols`` of the layout's streamed backward
    (:func:`streamed_bwd_plan`: K8's form or K9's, at every head dim and
    L)."""
    if layout not in ATTN_LAYOUTS:
        raise ValueError(f"attn_smem_bytes: layout {layout!r} is not one of {ATTN_LAYOUTS}")
    plan = streamed_bwd_plan(hd, l, grid=layout == "grid", v1=layout == "v1")
    return {"fwd": attn_fwd_plan(hd, l)["smem"], "streamed_rows": plan["rows_smem"],
            "streamed_cols": plan["cols_smem"]}


def attn_variant(name: str, hd: int, l: int, backward: bool, layout: str = "grid") -> str:
    """Which K8 (``layout`` 'grid') or K9 ('v1') kernel runs in one direction
    at head dim ``hd`` and window length ``l``, a static rule: ``'streamed'``
    at head dims 32/64/96/128/256, in both directions, at every L whose
    kernels fit shared memory: the backward's grows with L only by its token
    table and its row statistics, so it takes L up to 3,328 at head dim 256
    on the grid (4,432 windowed) and past 8,000 at the smaller head dims.
    Any other head dim or L raises a ValueError before a launch."""
    if hd not in ATTN_FWD_HEAD_DIMS or l < 1:
        raise ValueError(f"{name}: no {'backward' if backward else 'forward'} kernel takes head "
                         f"dim {hd} (both directions take {ATTN_FWD_HEAD_DIMS})")
    sm = attn_smem_bytes(hd, l, layout)
    need = max(sm["streamed_rows"], sm["streamed_cols"]) if backward else sm["fwd"]
    if need > _MAX_SMEM:
        raise ValueError(f"{name}: L = {l} needs {need} B of shared memory at head dim {hd} "
                         f"(at most {_MAX_SMEM})")
    return "streamed"


def attn_fwd_info(layout: str, hd: int, l: int, bias: bool) -> dict:
    """The K8 (``layout`` 'grid') or K9 ('v1') forward instance's launch at
    head dim ``hd`` and window length ``l``, from the CUDA runtime: threads a
    block, dynamic shared memory, registers a thread, local (spill) bytes a
    thread, resident blocks per SM, blocks per (window, head) and whether it
    is the z-in-registers path (1). Builds the library at first use; needs
    the GPU."""
    lib = _build.load_library()
    info = (ctypes.c_int * 7)()
    entry = getattr(lib, f"swin_window_attention_{layout}_fwd_info")
    _build.check(entry(hd, int(bias), l, info), entry.__name__)
    keys = ("threads", "smem", "registers", "local_bytes", "blocks_per_sm", "blocks_per_window",
            "z_path")
    return dict(zip(keys, info))


def _streamed_info(layout: str, hd: int, l: int, bias: bool) -> dict:
    lib = _build.load_library()
    info = (ctypes.c_int * 10)()
    entry = getattr(lib, f"swin_window_attention_{layout}_streamed_bwd_info")
    _build.check(entry(hd, int(bias), l, info), entry.__name__)
    out = {"threads": info[0], "blocks_per_window": info[1]}
    for k, kernel in enumerate(("rows", "cols")):
        for j, key in enumerate(("smem", "registers", "local_bytes", "blocks_per_sm")):
            out[f"{kernel}_{key}"] = info[2 + 4 * k + j]
    return out


def streamed_bwd_info(hd: int, l: int, bias: bool) -> dict:
    """K9's streamed backward at head dim ``hd`` and window length ``l``,
    from the CUDA runtime: threads a block, blocks per (window, head), and
    for the rows and the columns kernel their dynamic shared memory,
    registers a thread, local (spill) bytes a thread and resident blocks per
    SM. Builds the library at first use; needs the GPU."""
    return _streamed_info("v1", hd, l, bias)


def grid_streamed_bwd_info(hd: int, l: int, bias: bool) -> dict:
    """K8's streamed backward (form FORM_GRID) at head dim ``hd`` and window
    length ``l``, from the CUDA runtime, as :func:`streamed_bwd_info`."""
    return _streamed_info("grid", hd, l, bias)


def _row_chunks(variant: str, lp: int) -> int:
    """Row blocks per (window, head) of the backward: 1 (the qkv-fused
    family's one-block kernel), or for the streamed kernels (its streamed
    variant, K8's and K9's) one per 64 rows, as ``plan_of`` in
    ``csrc/streamed_bwd.cuh`` splits them (each writes its own d(scale)
    partial)."""
    return streamed_bwd_plan(16, lp)["nchunk"] if variant == "streamed" else 1


def _v1_norm_scratch(q: torch.Tensor):
    """K9's streamed backward scratch: qn16, kn16 in q's layout and the fp32
    norms [2, Bw, heads, L] (q's, then k's)."""
    return (torch.empty_like(q), torch.empty_like(q),
            torch.empty((2, *q.shape[:-1]), dtype=torch.float32, device=q.device))


def _pixel_stride(name, label, t, shape, dev) -> int:
    """Pixel stride (elements) of a bf16 [B, H, W, C] operand whose channels are
    contiguous (a channel slice of a wider tensor is taken as it is), or raise."""
    _build.check_traced(name, t)
    if t.device != dev:
        raise ValueError(f"{name}: {label} is on {t.device}, expected {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected torch.bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    b, h, w, c = shape
    ld = t.stride(2)
    if (t.stride(3) != 1 or t.stride(1) != w * ld or t.stride(0) != h * w * ld or ld < c
            or ld % 8 or t.data_ptr() % 16):
        raise ValueError(f"{name}: {label} must have contiguous channels and rows of a 16-byte "
                         f"aligned [B, H, W, ld] tensor, ld % 8 == 0; strides {t.stride()}")
    return ld


def _check_grid_operands(name, qn, kn, v, scale, window, mask_pattern, bias, g=None):
    """-> (b, h, w, c, heads, wh, ww, l, (ldq, ldk, ldv), variant)."""
    if qn.device.type != "cuda" or qn.dim() != 4:
        raise ValueError(f"{name}: qn must be a 4-D CUDA tensor, got {qn.dim()}-D on {qn.device}")
    b, h, w, c = qn.shape
    wh, ww = int(window[0]), int(window[1])
    _window_grid(qn, window)
    heads, l, dev = int(scale.shape[0]), wh * ww, qn.device
    lds = tuple(_pixel_stride(name, lbl, t, (b, h, w, c), dev)
                for lbl, t in (("qn", qn), ("kn", kn), ("v", v)))
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (b, h, w, c), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if bias is not None:
        _build.check_operand(name, "bias", bias, torch.float32, (heads, l, l), dev)
    if c % heads:
        raise ValueError(f"{name}: C={c} is not a multiple of heads={heads}")
    variant = attn_variant(name, c // heads, l, g is not None)
    return b, h, w, c, heads, wh, ww, l, lds, variant


def _launch_grid_forward(fn, qn, kn, v, scale, bias, window, mask_pattern, boundary_flag):
    name = fn.__name__
    b, h, w, c, heads, wh, ww, _, lds, _ = _check_grid_operands(
        name, qn, kn, v, scale, window, mask_pattern, bias)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=qn.device)
    lib = _build.load_library()
    with torch.cuda.device(qn.device):
        stream = torch.cuda.current_stream(qn.device).cuda_stream
        code = lib.swin_window_attention_grid_fwd(
            qn.data_ptr(), kn.data_ptr(), v.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
            out.data_ptr(), b, h, w, c, heads, wh, ww, *lds, stream)
    _build.check(code, name)
    fn.launches += 1
    return out


def window_attention_grid(qn, kn, v, scale, window, mask_pattern=None, boundary_flag=1.0):
    """K8's forward kernel: qn, kn, v [B, H, W, C] bf16 with contiguous
    channels (a channel slice of the [B, H, W, 3C] qkv tensor is read in
    place), scale [heads] fp32, mask_pattern [L, L] fp32 or None ->
    [B, H, W, C] bf16. Launches on the current stream."""
    return _launch_grid_forward(window_attention_grid, qn, kn, v, scale, None, window,
                                mask_pattern, boundary_flag)


window_attention_grid.launches = 0


def window_attention_grid_bias(qn, kn, v, scale, bias, window, mask_pattern=None,
                               boundary_flag=1.0):
    """K8's BIAS forward kernel: :func:`window_attention_grid` plus the raw CPB
    bias [heads, L, L] fp32."""
    return _launch_grid_forward(window_attention_grid_bias, qn, kn, v, scale, bias, window,
                                mask_pattern, boundary_flag)


window_attention_grid_bias.launches = 0


@torch.library.custom_op("swin::window_attention_grid", mutates_args=())
def window_attention_grid_op(qn: torch.Tensor, kn: torch.Tensor, v: torch.Tensor,
                             scale: torch.Tensor, window: List[int],
                             mask_pattern: Optional[torch.Tensor],
                             boundary_flag: float) -> torch.Tensor:
    """K8's forward launch (:func:`window_attention_grid`; v may be a channel
    slice of the qkv tensor, read in place) as the custom op
    ``swin::window_attention_grid``."""
    return window_attention_grid(qn, kn, v, scale, tuple(window), mask_pattern, boundary_flag)


@window_attention_grid_op.register_fake
def _window_attention_grid_fake(qn, kn, v, scale, window, mask_pattern, boundary_flag):
    return qn.new_empty(qn.shape, dtype=torch.bfloat16)


@torch.library.custom_op("swin::window_attention_grid_bias", mutates_args=())
def window_attention_grid_bias_op(qn: torch.Tensor, kn: torch.Tensor, v: torch.Tensor,
                                  scale: torch.Tensor, bias: torch.Tensor, window: List[int],
                                  mask_pattern: Optional[torch.Tensor],
                                  boundary_flag: float) -> torch.Tensor:
    """K8's BIAS forward launch (:func:`window_attention_grid_bias`) as the
    custom op ``swin::window_attention_grid_bias``."""
    return window_attention_grid_bias(qn, kn, v, scale, bias, tuple(window), mask_pattern,
                                      boundary_flag)


@window_attention_grid_bias_op.register_fake
def _window_attention_grid_bias_fake(qn, kn, v, scale, bias, window, mask_pattern,
                                     boundary_flag):
    return qn.new_empty(qn.shape, dtype=torch.bfloat16)


def _launch_grid_backward(fn, qn, kn, v, scale, bias, g, window, mask_pattern, boundary_flag):
    name = fn.__name__
    b, h, w, c, heads, wh, ww, l, lds, variant = _check_grid_operands(
        name, qn, kn, v, scale, window, mask_pattern, bias, g)
    dev = qn.device
    n_win = b * (h // wh) * (w // ww)
    lp = -(-l // 16) * 16
    f32 = dict(dtype=torch.float32, device=dev)
    dqn, dkn, dv = (torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
                    for _ in range(3))
    # d(scale) partials: one per window and 64 query rows
    dscale_part = torch.empty((n_win * _row_chunks(variant, lp), heads), **f32)
    dscale = torch.empty((heads,), **f32)
    # one fp32 [LP, LP] d(bias) partial per (window, head), summed in window order
    dbias_part = None if bias is None else torch.empty((n_win, heads, lp, lp), **f32)
    dbias = None if bias is None else torch.empty((heads, l, l), **f32)
    # the per-row softmax statistics the rows and columns kernels share
    rstat = torch.empty((n_win, heads, lp, 3), **f32)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swin_window_attention_grid_streamed_bwd(
            qn.data_ptr(), kn.data_ptr(), v.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), float(boundary_flag),
            g.data_ptr(), dqn.data_ptr(), dkn.data_ptr(), dv.data_ptr(), rstat.data_ptr(),
            dscale_part.data_ptr(), None if bias is None else dbias_part.data_ptr(),
            dscale.data_ptr(), None if bias is None else dbias.data_ptr(),
            b, h, w, c, heads, wh, ww, *lds, stream)
    _build.check(code, name)
    fn.launches += 1
    return (dqn, dkn, dv, dscale) if bias is None else (dqn, dkn, dv, dscale, dbias)


def window_attention_grid_bwd(qn, kn, v, scale, g, window, mask_pattern=None, boundary_flag=1.0):
    """K8's backward kernels: the operands of :func:`window_attention_grid` and
    g [B, H, W, C] bf16 contiguous -> (dqn, dkn, dv [B, H, W, C] bf16, dscale
    [heads] fp32). dscale is summed in window order: two calls give the same
    bits."""
    return _launch_grid_backward(window_attention_grid_bwd, qn, kn, v, scale, None, g, window,
                                 mask_pattern, boundary_flag)


window_attention_grid_bwd.launches = 0


def window_attention_grid_bias_bwd(qn, kn, v, scale, bias, g, window, mask_pattern=None,
                                   boundary_flag=1.0):
    """K8's BIAS backward kernels: also dbias [heads, L, L] fp32, from a
    [B * nW, heads, LP, LP] fp32 partial per (window, head) (396 MB at the
    flagship shape) summed in window order: no atomics."""
    return _launch_grid_backward(window_attention_grid_bias_bwd, qn, kn, v, scale, bias, g,
                                 window, mask_pattern, boundary_flag)


window_attention_grid_bias_bwd.launches = 0


def _check_v1_operands(name, q, k, v, scale, window_grid, mask_pattern, bias, g=None):
    """-> (b, nwh, nww, heads, hd, l, variant) of [Bw, heads, L, D] operands."""
    if q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(f"{name}: q must be a 4-D CUDA tensor, got {q.dim()}-D on {q.device}")
    nwh, nww = _check_window_grid(q, window_grid)
    bw, heads, l, hd = q.shape
    dev = q.device
    for lbl, t in (("q", q), ("k", k), ("v", v)) + ((("g", g),) if g is not None else ()):
        _build.check_operand(name, lbl, t, torch.bfloat16, (bw, heads, l, hd), dev)
    _build.check_operand(name, "scale", scale, torch.float32, (heads,), dev)
    if mask_pattern is not None:
        _build.check_operand(name, "mask_pattern", mask_pattern, torch.float32, (l, l), dev)
    if bias is not None:
        _build.check_operand(name, "bias", bias, torch.float32, (heads, l, l), dev)
    variant = attn_variant(name, hd, l, g is not None, "v1")
    return bw // (nwh * nww), nwh, nww, heads, hd, l, variant


def _launch_v1_forward(fn, q, k, v, scale, bias, window_grid, mask_pattern):
    name = fn.__name__
    b, nwh, nww, heads, hd, l, _ = _check_v1_operands(name, q, k, v, scale, window_grid,
                                                      mask_pattern, bias)
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.swin_window_attention_v1_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if mask_pattern is None else mask_pattern.data_ptr(), out.data_ptr(), b, nwh,
            nww, heads, hd, l, stream)
    _build.check(code, name)
    fn.launches += 1
    return out


def window_attention_v1(q, k, v, scale, window_grid, mask_pattern=None):
    """K9's forward kernel: q, k, v [Bw, heads, L, D] bf16 contiguous (windows
    in h-major order of ``window_grid`` = (window rows, windows per row)),
    scale [heads] fp32, mask_pattern [L, L] fp32 or None -> [Bw, heads, L, D]
    bf16. Normalizes q and k itself. Launches on the current stream."""
    return _launch_v1_forward(window_attention_v1, q, k, v, scale, None, window_grid,
                              mask_pattern)


window_attention_v1.launches = 0


def window_attention_v1_bias(q, k, v, scale, bias, window_grid, mask_pattern=None):
    """K9's BIAS forward kernel: :func:`window_attention_v1` plus the raw CPB
    bias [heads, L, L] fp32."""
    return _launch_v1_forward(window_attention_v1_bias, q, k, v, scale, bias, window_grid,
                              mask_pattern)


window_attention_v1_bias.launches = 0


@torch.library.custom_op("swin::window_attention_v1", mutates_args=())
def window_attention_v1_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: torch.Tensor, window_grid: List[int],
                           mask_pattern: Optional[torch.Tensor]) -> torch.Tensor:
    """K9's forward launch (:func:`window_attention_v1`) as the custom op
    ``swin::window_attention_v1``."""
    return window_attention_v1(q, k, v, scale, tuple(window_grid), mask_pattern)


@window_attention_v1_op.register_fake
def _window_attention_v1_fake(q, k, v, scale, window_grid, mask_pattern):
    return q.new_empty(q.shape, dtype=torch.bfloat16)


@torch.library.custom_op("swin::window_attention_v1_bias", mutates_args=())
def window_attention_v1_bias_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor, window_grid: List[int],
                                mask_pattern: Optional[torch.Tensor]) -> torch.Tensor:
    """K9's BIAS forward launch (:func:`window_attention_v1_bias`) as the
    custom op ``swin::window_attention_v1_bias``."""
    return window_attention_v1_bias(q, k, v, scale, bias, tuple(window_grid), mask_pattern)


@window_attention_v1_bias_op.register_fake
def _window_attention_v1_bias_fake(q, k, v, scale, bias, window_grid, mask_pattern):
    return q.new_empty(q.shape, dtype=torch.bfloat16)


def _launch_v1_backward(fn, q, k, v, scale, bias, g, window_grid, mask_pattern):
    name = fn.__name__
    b, nwh, nww, heads, hd, l, variant = _check_v1_operands(name, q, k, v, scale, window_grid,
                                                            mask_pattern, bias, g)
    dev = q.device
    n_win = b * nwh * nww
    lp = -(-l // 16) * 16
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dscale_part = torch.empty((n_win * _row_chunks(variant, lp), heads), **f32)
    dscale = torch.empty((heads,), **f32)
    dbias_part = None if bias is None else torch.empty((n_win, heads, lp, lp), **f32)
    dbias = None if bias is None else torch.empty((heads, l, l), **f32)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if mask_pattern is None else mask_pattern.data_ptr(),
                g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        tail = (dscale_part.data_ptr(), None if bias is None else dbias_part.data_ptr(),
                dscale.data_ptr(), None if bias is None else dbias.data_ptr(),
                b, nwh, nww, heads, hd, l, stream)
        # scratch: normalized q and k, their norms, the per-row statistics (m, sum e, u)
        qn, kn, inv = _v1_norm_scratch(q)
        rstat = torch.empty((n_win, heads, lp, 3), **f32)
        code = lib.swin_window_attention_v1_streamed_bwd(
            *head, qn.data_ptr(), kn.data_ptr(), inv.data_ptr(), rstat.data_ptr(), *tail)
    _build.check(code, name)
    fn.launches += 1
    return (dq, dk, dv, dscale) if bias is None else (dq, dk, dv, dscale, dbias)


def window_attention_v1_bwd(q, k, v, scale, g, window_grid, mask_pattern=None):
    """K9's backward kernels: the operands of :func:`window_attention_v1` and g
    [Bw, heads, L, D] bf16 -> (dq, dk, dv [Bw, heads, L, D] bf16, dscale
    [heads] fp32), the normalization VJP included; dscale is summed in window
    order."""
    return _launch_v1_backward(window_attention_v1_bwd, q, k, v, scale, None, g, window_grid,
                               mask_pattern)


window_attention_v1_bwd.launches = 0


def window_attention_v1_bias_bwd(q, k, v, scale, bias, g, window_grid, mask_pattern=None):
    """K9's BIAS backward kernels: also dbias [heads, L, L] fp32, summed over
    per-(window, head) partials in window order."""
    return _launch_v1_backward(window_attention_v1_bias_bwd, q, k, v, scale, bias, g,
                               window_grid, mask_pattern)


window_attention_v1_bias_bwd.launches = 0


class WindowAttentionGrid(torch.autograd.Function):
    """K8 forward and backward (or their plain versions for CPU tensors), with
    the per-head normalization and its VJP around them in plain ops.

    Saves (qn, kn, v, scale, bias, inv_q, inv_k), as ``fg_fwd`` / ``fg4_fwd``
    do; the backward is K8's kernel followed by :func:`normalize_vjp` on the
    stored qn and kn. dqn and dkn leave the kernel in q's dtype, as in JAX.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale, bias, window, mask_pattern, boundary_flag):
        heads = int(scale.shape[0])
        qn, inv_q = normalize_heads(q, heads)
        kn, inv_k = normalize_heads(k, heads)
        ctx.save_for_backward(qn, kn, v, scale, bias, inv_q, inv_k)
        ctx.window, ctx.mask_pattern, ctx.boundary_flag = window, mask_pattern, boundary_flag
        if q.device.type == "cpu":
            return window_attention_grid_bias_reference(qn, kn, v, scale, bias, window,
                                                        mask_pattern, boundary_flag)
        args = (qn, kn, v, scale.float().contiguous())
        tail = (window, mask_pattern, _flag(boundary_flag))
        if bias is None:
            return window_attention_grid(*args, *tail)
        return window_attention_grid_bias(*args, bias.float().contiguous(), *tail)

    @staticmethod
    def backward(ctx, g):
        qn, kn, v, scale, bias, inv_q, inv_k = ctx.saved_tensors
        heads = int(scale.shape[0])
        if qn.device.type == "cpu":
            grads = window_attention_grid_bias_backward_reference(
                qn, kn, v, scale, bias, g, ctx.window, ctx.mask_pattern, ctx.boundary_flag)
        else:
            args = (qn, kn, v, scale.float().contiguous())
            g16 = g.to(torch.bfloat16).contiguous()
            tail = (ctx.window, ctx.mask_pattern, _flag(ctx.boundary_flag))
            if bias is None:
                grads = window_attention_grid_bwd(*args, g16, *tail)
            else:
                grads = window_attention_grid_bias_bwd(*args, bias.float().contiguous(), g16,
                                                       *tail)
        dqn, dkn, dv, dscale = grads[:4]
        dbias = None if bias is None else grads[4].to(bias.dtype)
        return (normalize_vjp(qn, inv_q, dqn, heads, qn.dtype),
                normalize_vjp(kn, inv_k, dkn, heads, kn.dtype), dv, dscale.to(scale.dtype),
                dbias, None, None, None)


class WindowAttentionV1(torch.autograd.Function):
    """K9 forward and backward (or their plain versions for CPU tensors); saves
    (q, k, v, scale, bias), as ``fused_fwd`` does. The windowed operands are
    made contiguous for the kernels (the head split is materialized, as in
    JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bias, window_grid, mask_pattern):
        ctx.save_for_backward(q, k, v, scale, bias)
        ctx.window_grid, ctx.mask_pattern = window_grid, mask_pattern
        if q.device.type == "cpu":
            return window_attention_v1_bias_reference(q, k, v, scale, bias, window_grid,
                                                      mask_pattern)
        args = (q.contiguous(), k.contiguous(), v.contiguous(), scale.float().contiguous())
        if bias is None:
            return window_attention_v1(*args, window_grid, mask_pattern)
        return window_attention_v1_bias(*args, bias.float().contiguous(), window_grid,
                                        mask_pattern)

    @staticmethod
    def backward(ctx, g):
        q, k, v, scale, bias = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = window_attention_v1_bias_backward_reference(q, k, v, scale, bias, g,
                                                                ctx.window_grid,
                                                                ctx.mask_pattern)
        else:
            args = (q.contiguous(), k.contiguous(), v.contiguous(), scale.float().contiguous())
            g16 = g.to(torch.bfloat16).contiguous()
            if bias is None:
                grads = window_attention_v1_bwd(*args, g16, ctx.window_grid, ctx.mask_pattern)
            else:
                grads = window_attention_v1_bias_bwd(*args, bias.float().contiguous(), g16,
                                                     ctx.window_grid, ctx.mask_pattern)
        dq, dk, dv, dscale = grads[:4]
        dbias = None if bias is None else grads[4].to(bias.dtype)
        return dq, dk, dv, dscale.to(scale.dtype), dbias, None, None


def _mask_on(x, mask_pattern):
    if mask_pattern is not None and x.device.type == "cuda":
        return torch.as_tensor(mask_pattern).to(device=x.device, dtype=torch.float32).contiguous()
    return mask_pattern


def _check_bias(name, bias, heads, l):
    if bias is not None and tuple(bias.shape) != (heads, l, l):
        raise ValueError(f"{name}: the CPB bias must be [heads, L, L] = {(heads, l, l)}, got "
                         f"{tuple(bias.shape)}")


def fused_window_attention_grid(
    q: torch.Tensor,  # [B, H, W, C] (already rolled for shifted blocks)
    k: torch.Tensor,
    v: torch.Tensor,
    scale: torch.Tensor,  # [heads]
    window: Tuple[int, int],
    bias: Optional[torch.Tensor] = None,  # raw CPB [heads, L, L]
    mask_pattern=None,  # [L, L] boundary-row mask (array or tensor) or None
    boundary_flag=None,  # scalar gate on the mask (spatial sharding)
) -> torch.Tensor:
    """Grid-layout window attention: [B, H, W, C] -> [B, H, W, C], q and k
    normalized per head here, differentiable in q, k, v, scale and the bias
    (K8 on CUDA tensors, its plain versions on CPU tensors)."""
    _window_grid(q, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention_grid: no implementation for device {q.device}")
    _check_bias("fused_window_attention_grid", bias, int(scale.shape[0]),
                int(window[0]) * int(window[1]))
    mask_pattern = _mask_on(q, mask_pattern)
    if q.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K8 through its custom op, after WindowAttentionGrid's
        # normalization in plain ops
        heads = int(scale.shape[0])
        args = (normalize_heads(q, heads)[0], normalize_heads(k, heads)[0], v,
                scale.float().contiguous())
        tail = (list(window), mask_pattern, _flag(boundary_flag))
        if bias is None:
            return window_attention_grid_op(*args, *tail)
        return window_attention_grid_bias_op(*args, bias.float().contiguous(), *tail)
    return WindowAttentionGrid.apply(q, k, v, scale, bias, tuple(window), mask_pattern,
                                     boundary_flag)


def fused_window_attention(
    q: torch.Tensor,  # [Bw, heads, L, D]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: torch.Tensor,  # [heads]
    bias: Optional[torch.Tensor] = None,  # raw CPB [heads, L, L]
    mask_pattern=None,  # [L, L] mask of the last window row, or None
    window_grid: Optional[Tuple[int, int]] = None,  # (window rows, windows per row)
) -> torch.Tensor:
    """Windowed attention: [Bw, heads, L, D] -> [Bw, heads, L, D], q and k
    normalized inside (K9 on CUDA tensors, its plain versions on CPU tensors)."""
    grid = _check_window_grid(q, window_grid)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_window_attention: no implementation for device {q.device}")
    _check_bias("fused_window_attention", bias, int(scale.shape[0]), int(q.shape[2]))
    mask_pattern = _mask_on(q, mask_pattern)
    if q.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K9 through its custom op, on WindowAttentionV1's operands
        args = (q.contiguous(), k.contiguous(), v.contiguous(), scale.float().contiguous())
        if bias is None:
            return window_attention_v1_op(*args, list(grid), mask_pattern)
        return window_attention_v1_bias_op(*args, bias.float().contiguous(), list(grid),
                                           mask_pattern)
    return WindowAttentionV1.apply(q, k, v, scale, bias, grid, mask_pattern)
