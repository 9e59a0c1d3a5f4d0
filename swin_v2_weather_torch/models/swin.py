"""SwinV2 for global weather forecasting -- PyTorch port.

Counterpart of ``swin_v2_weather_tpu/models/swin.py`` for the routes the
flagship, fine-tune, depth-24 and CPB configs take:

  * attention, by ``attn_impl``:

      - ``'pallas_qkv'``: the qkv-fused window-attention kernels (K1/K2), or
        with the continuous position bias (``rel_pos: True``) the same kernels
        with the bias folded by :func:`fold_cpb_bias` (K7);
      - ``'pallas'`` (the grid route): the qkv Dense on the NHWC grid, per-head
        L2 normalization in plain ops, then K8 on the grid, windowing by index
        math (q, k and v are channel slices of the qkv tensor, read in place);
      - ``'pallas_v1'`` (the windowed route): ``window_partition``, the qkv
        Dense, the head split, K9 (normalization inside), the head merge and
        ``window_reverse``;
      - ``'xla'``: the windowed route with plain fp32 cosine attention and the
        full [nW, L, L] shift mask (no kernel).

    ``'pallas'``, ``'pallas_v1'`` and ``'xla'`` take the raw CPB bias
    [heads, L, L] fp32, unfolded. The CPB meta-MLP (2 -> 384 -> heads, ReLU,
    dropout 0.125 on the hidden layer in train mode) runs on the distinct
    relative deltas and is expanded by an index gather (``cpb_unique``,
    default true), or per pair;
  * MLP: the fc1+GELU kernel pair (``mlp_impl: 'fused'``, the default for
    single-step runs at depth <= 12), the whole-MLP kernel pair
    (``'fused2'``, the default for multi-step runs and depth > 12, as the JAX
    factory picks) or the plain Dense + exact GELU + Dense (``'plain'``);
  * post-norm branches ``x + drop_path(norm(y))``: plain LayerNorm, drop-path
    and add (``lnadd_impl: 'xla'``, the default) or the fused kernel pair
    (``'fused'``; K11) where its shape condition holds, as in JAX.

JAX's switches, read from the environment at import and validated as JAX
validates them (an invalid value raises a ``ValueError``), are module
globals here too, read when a module runs: ``MLP_IMPL`` (``SWIN_MLP_IMPL``:
'fused', 'fused2' or 'plain'), ``LNADD_IMPL`` (``SWIN_LNADD_IMPL``: 'fused'
or 'xla'), ``LN_IMPL`` (``SWIN_LN_IMPL``: 'twopass' or 'onepass', the
LayerNorm's statistics) and ``CPB_UNIQUE`` (``SWIN_CPB_UNIQUE``; when set it
wins over the ``cpb_unique`` config key). A config key wins over the
``mlp_impl`` / ``lnadd_impl`` switches; where it is absent the factory
passes None for single-step runs at depth <= 12 (the module's switch
decides) and 'fused2' / 'xla' for the others, as JAX's factory does. The
TPU-only switches (``SWIN_CPB_EXPAND``, ``SWIN_CPB_BARRIER``, tile sizes)
have no counterpart: they pick XLA lowerings of the same function.

Still raising ``NotImplementedError``: ``spatial_shards > 1`` on
``'pallas_v1'`` (its kernel has no boundary gate, as in JAX), and train-mode
proj/attn dropout under spatial sharding (JAX refuses it there too).

Spatial sharding (``spatial_shards > 1``, ``parallel/spatial.py``): the model
runs on one latitude band of ``H / spatial_shards`` rows of the input, a
whole number of window rows, on each rank of the ``model`` group it holds
(``spatial_group``); each band adds its rows of ``pos_embed``, the shifted
blocks roll H through the halo exchange (``roll_h_sharded``) and W locally,
and only the band that owns the last window row masks the pole-crossing
rows (K1/K2, K7, K8 and K10 take ``boundary_flag`` 0.0 or 1.0 with the
static pattern; ``'xla'`` drops the mask elsewhere). The window and shift
are clamped to the whole grid, not to the band: JAX clamps them to the
band's rows (its ``calc_window_shift`` of ``(gh_local, gw)``), so a band of
one window row loses the H shift there and its model leaves the unsharded
one; the port does not copy that.

The layout follows the JAX model, so weights convert one to one
(``models/convert.py``):

  * NCHW at the public boundary, NHWC inside;
  * patch embedding as space-to-depth (flatten order p_h, p_w, c) + Linear;
  * parameters in fp32, compute in ``dtype`` (bf16 by default); every Linear
    rounds its product to ``dtype`` and then adds the bias in ``dtype``, as
    ``flax.linen.Dense(dtype=...)`` does; LayerNorm statistics in fp32;
  * blocks unrolled; odd blocks shifted by half a window with the
    latitude-only mask; bias-free head, unpatchify, fp32 output and the
    optional global residual;
  * train mode: per-sample drop-path on both post-norm branches at rate
    ``linspace(0, drop_path_rate, depth)[i]`` in block i, with ``rel_pos``
    the CPB meta-MLP's hidden dropout, and the elementwise dropout of JAX's
    ``nn.Dropout`` sites (:func:`dropout`, flax's semantics) at
    ``proj_drop_rate`` after the output projection and after each MLP layer
    and at ``attn_drop_rate`` on the softmax (the factory sets neither; a
    caller constructs the model with them, as in JAX). Under attention
    dropout in train mode the ``'pallas_qkv'``, ``'pallas'`` and
    ``'pallas_v1'`` routes leave their kernels for the window partition, the
    qkv Dense and the plain attention, as JAX's gates do; eval mode keeps
    every route's kernels. The uniforms behind the drop-path and CPB masks
    ([depth, 2, B] for drop-path, [depth, D, 384] for the CPB, D the number
    of meta-MLP rows) are drawn in one call from the ``torch.Generator`` the
    caller passes (:meth:`SwinTransformerV2.drop_noise`), or handed in by the
    caller (the multi-step wrapper draws every step's at once, so a
    recomputed step sees the same masks). The dropout masks are too large to
    draw that way (at the flagship a block's sites hold ~380 M elements), so
    the same call draws one seed per site and sample ([depth, 4, B], on the
    host) and each site rebuilds its sample's mask from a generator seeded
    with it (:func:`keep_mask`): a recomputed stage draws the same mask, and
    a data shard's masks are its rows of the global batch's. JAX's
    ``dropout`` rng stream cannot be matched, so the masks agree with JAX in
    distribution, not bit for bit (tests hand JAX's masks in as explicit
    keep masks);
  * activation checkpointing (``activation_ckpt``, ``remat_policy``), as
    JAX's named-save policies (``_remat_policy``): :func:`remat_names` gives
    the names a policy keeps (``attn``, ``mlp``, ``mlp_fc1``, ``mlp3``;
    ``full`` and any other name keep none). Each block is cut into stages at
    JAX's named sites (``attn_kernel_out``, ``attn_out``, ``block_mid``,
    ``mlp_fc1``, ``mlp_out``; ``cpb_bias`` is computed before the stages
    where it is kept), and every run of stages between kept names goes
    through ``torch.utils.checkpoint`` (non-reentrant), so the forward keeps
    the block input and the kept tensors and the backward runs each run's
    forward again. A stage that is one kernel call and ends at a kept name
    runs outside any checkpoint: its autograd Function keeps its inputs, as
    JAX's custom_vjp residuals stay under remat (K1/K7/K10/K12 on unshifted
    blocks, K5, K11 on the first branch). The unfused post-norm branch's
    residual add runs outside the checkpoints, so an unkept ``block_mid`` is
    not held for it. Where grad mode is off nothing is checkpointed. The
    backward graph is the unrematted forward's, so the gradients are the
    same bits wherever the recomputed forward is. Blocks are rematted one
    at a time, as JAX's unrolled form (``scan_blocks: false``, every weather
    config) does; its scanned form remats pairs of blocks.

LayerNorm scales of the blocks start at ``init_values`` (0 in every weather
config), so a freshly built block is the identity map; tests and smoke runs
must draw all parameters from noise before a forward means anything.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from swin_v2_weather_torch.ops import ln_kernels
from swin_v2_weather_torch.ops import window_attention as _wa
from swin_v2_weather_torch.ops.mlp_kernels import fused_fc1_gelu, fused_mlp
from swin_v2_weather_torch.ops.window_attention import (
    fold_cpb_bias,
    fused_window_attention,
    fused_window_attention_grid,
    fused_window_attention_qkv,
    fused_window_attention_qkv_padded,
    pad_proj_rows,
)
from swin_v2_weather_torch.parallel import spatial

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ATTN_IMPLS = ("pallas_qkv", "pallas", "pallas_v1", "xla")
WINDOWED_IMPLS = ("pallas_v1", "xla")  # the block partitions into windows first


# JAX's switches (swin_v2_weather_tpu/models/swin.py), validated as there
LN_IMPL = os.environ.get("SWIN_LN_IMPL", "twopass")
if LN_IMPL not in ("twopass", "onepass"):
    raise ValueError(f"SWIN_LN_IMPL={LN_IMPL!r} invalid; expected 'twopass' or 'onepass'")
# an explicitly set SWIN_CPB_UNIQUE wins over the cpb_unique config key
_CPB_UNIQUE_ENV = os.environ.get("SWIN_CPB_UNIQUE")
CPB_UNIQUE = (_CPB_UNIQUE_ENV or "1") != "0"
LNADD_IMPL = os.environ.get("SWIN_LNADD_IMPL", "xla")
if LNADD_IMPL not in ("fused", "xla"):
    raise ValueError(f"SWIN_LNADD_IMPL={LNADD_IMPL!r} invalid; expected 'fused' or 'xla'")
_MLP_IMPLS = ("fused", "fused2", "plain")
MLP_IMPL = os.environ.get("SWIN_MLP_IMPL", "fused")
if MLP_IMPL not in _MLP_IMPLS:
    raise ValueError(
        f"SWIN_MLP_IMPL={MLP_IMPL!r} invalid; expected 'fused', 'fused2' or 'plain'")

# JAX's named-save remat policies (``SwinTransformerV2._remat_policy``): the
# names each one saves, before the drops of :func:`remat_names`; 'full' (the
# factory's default) and any other name save nothing
REMAT_POLICIES = {
    "attn": ("attn_out",),
    "mlp": ("attn_kernel_out", "attn_out", "block_mid", "mlp_out"),
    "mlp_fc1": ("attn_kernel_out", "attn_out", "block_mid", "mlp_out", "mlp_fc1"),
    "mlp3": ("attn_kernel_out", "block_mid", "mlp_out"),
}


def remat_names(policy: str, fused_mlp: bool, fused_ln: bool,
                rel_pos: bool) -> Optional[frozenset]:
    """The named tensors a block keeps for the backward under ``policy``, as
    JAX's ``_remat_policy`` builds its ``save_only_these_names``: the fused
    MLP routes drop ``block_mid`` (the kernel's residual is that tensor), the
    fused LayerNorm branch drops ``attn_out`` and ``mlp_out`` (its
    residuals), and ``rel_pos`` adds ``cpb_bias``. None for 'full' and any
    other name, as JAX's ``return None``: everything is recomputed, the CPB
    bias too."""
    if policy not in REMAT_POLICIES:
        return None
    drop = {"block_mid"} if fused_mlp else set()
    if fused_ln:
        drop |= {"attn_out", "mlp_out"}
    keep = {n for n in REMAT_POLICIES[policy] if n not in drop}
    if rel_pos:
        keep.add("cpb_bias")
    return frozenset(keep)


# ---------------------------------------------------------------------------
# window partition / reverse, static mask
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, window_size: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, wh, ww, C] with h-major window ordering."""
    b, h, w, c = x.shape
    wh, ww = window_size
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh, ww, c)


def window_reverse(
    windows: torch.Tensor, window_size: Tuple[int, int], img_size: Tuple[int, int]
) -> torch.Tensor:
    """[B*nW, wh, ww, C] -> [B, H, W, C]."""
    h, w = img_size
    wh, ww = window_size
    c = windows.shape[-1]
    x = windows.reshape(-1, h // wh, w // ww, wh, ww, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


@lru_cache(maxsize=32)
def make_shift_mask(
    feat_size: Tuple[int, int], window_size: Tuple[int, int], shift_size: Tuple[int, int]
) -> np.ndarray:
    """Latitude-only attention mask for the shifted case (host-side numpy).

    The region counter only slices along H, so longitude is never masked
    (windows wrapping around in W attend freely), while rows rolled across
    the pole boundary are masked with -100. Returns [nW, L, L] float32 (0 or
    -100); cached, so do not mutate the result.
    """
    h, w = feat_size
    wh, ww = window_size
    sh, _ = shift_size
    img_mask = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, h - wh), slice(h - sh, None)):
        img_mask[hs, :] = cnt
        cnt += 1
    mask_windows = (
        img_mask.reshape(h // wh, wh, w // ww, ww)
        .transpose(0, 2, 1, 3)
        .reshape(-1, wh * ww)
    )
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def make_log_relative_coords(window_size: Tuple[int, int]) -> np.ndarray:
    """sign(d) * log(1 + |d|) pairwise relative coordinates, [L*L, 2] (copy of
    the JAX package's function, bit for bit)."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, L, L]
    rel = rel.transpose(1, 2, 0).reshape(-1, 2).astype(np.float32)
    return np.sign(rel) * np.log1p(np.abs(rel))


@lru_cache(maxsize=16)
def make_log_relative_coords_unique(window_size: Tuple[int, int]):
    """Distinct-delta CPB table: ``(coords [D, 2], idx [L*L] int32)`` with
    ``coords[idx] == make_log_relative_coords(window_size)`` exactly; D =
    (2 wh - 1)(2 ww - 1) (595 for the 9x18 window against 26,244 pairs).
    Copy of the JAX package's function; cached, so do not mutate the result."""
    wh, ww = window_size
    dr = np.arange(-(wh - 1), wh)
    dc = np.arange(-(ww - 1), ww)
    # float32 BEFORE log1p: bitwise-identical to make_log_relative_coords
    deltas = (
        np.stack(np.meshgrid(dr, dc, indexing="ij"), axis=-1)
        .reshape(-1, 2)
        .astype(np.float32)
    )
    coords = np.sign(deltas) * np.log1p(np.abs(deltas))

    pos = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (pos[:, :, None] - pos[:, None, :]).transpose(1, 2, 0).reshape(-1, 2)
    idx = (rel[:, 0] + wh - 1) * (2 * ww - 1) + (rel[:, 1] + ww - 1)
    return coords, idx.astype(np.int32)


def calc_window_shift(
    feat_size: Tuple[int, int], target_window: Tuple[int, int], target_shift: Tuple[int, int]
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Clamp window/shift to the feature size."""
    window = tuple(f if f <= w else w for f, w in zip(feat_size, target_window))
    shift = tuple(0 if f <= w else s for f, w, s in zip(feat_size, window, target_shift))
    return window, shift


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.Dense(dtype)`` semantics: product rounded to ``dtype``, then
    the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): keep each sample's branch
    with probability 1 - rate and scale it by 1 / (1 - rate), in x's dtype, as
    the JAX ``DropPath`` does. Rate 0 is the identity and draws nothing.

    The per-sample uniforms ``u`` [B] come from the caller, or else are drawn
    from ``generator``."""
    if rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if u is None:
        if generator is None:
            raise ValueError("drop-path in train mode needs an explicit torch.Generator")
        u = torch.rand(shape, generator=generator, device=x.device)
    keep = np.float32(1.0) - np.float32(rate)
    # the divisor is keep rounded to x's dtype, as jnp.asarray(keep, x.dtype);
    # rounded on the host, so no scalar is copied to the device
    keep_x = float(torch.tensor(float(keep)).to(x.dtype))
    mask = (u.reshape(shape) < float(keep)).to(x.dtype)
    return x * mask / keep_x


def drop_path_multiplier(batch: int, rate: float, u: Optional[torch.Tensor],
                         device) -> torch.Tensor:
    """The per-sample drop-path multiplier mask / keep, fp32 [B], of the fused
    LayerNorm route (JAX ``DropPathMask``): ones at rate 0 or without
    uniforms (deterministic), else (u < keep) / keep."""
    if rate == 0.0 or u is None:
        return torch.ones((batch,), dtype=torch.float32, device=device)
    keep = float(np.float32(1.0) - np.float32(rate))
    return (u.reshape(batch) < keep).float() / keep


# the elementwise dropout sites of a block, in the order of a seed row
DROPOUT_SITES = ("attn", "proj", "fc1", "fc2")


def dropout(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``nn.Dropout``: x where ``keep`` is None (eval mode) or at rate 0,
    zeros at rate 1, else where(keep, x / keep_prob, 0), the division in x's
    dtype (flax divides by a Python float, which keeps bf16 bf16)."""
    if rate == 0.0 or keep is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    # keep_prob rounded to x's dtype on the host, as drop_path's divisor
    keep_x = float(torch.tensor(1.0 - rate).to(x.dtype))
    return torch.where(keep, x / keep_x, torch.zeros_like(x))


def keep_mask(shape, rate: float, seeds: torch.Tensor, device) -> torch.Tensor:
    """The bool keep mask of a tensor of ``shape`` whose leading axis holds
    the samples' rows (B or B * windows): sample b's rows are u < 1 - rate
    for uniforms u drawn from a generator on ``device`` seeded ``seeds[b]``
    (as ``jax.random.bernoulli`` compares one fp32 uniform with keep_prob)."""
    keep = float(np.float32(1.0 - rate))
    rows = shape[0] // len(seeds)
    parts = []
    for seed in seeds.tolist():
        gen = torch.Generator(device=device).manual_seed(int(seed))
        parts.append(torch.rand((rows,) + tuple(shape[1:]), generator=gen, device=device) < keep)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def site_dropout(x: torch.Tensor, rate: float, site: str, drop) -> torch.Tensor:
    """:func:`dropout` of x at one of a block's :data:`DROPOUT_SITES`:
    ``drop`` is None (eval mode), the block's seeds [sites, B] (int64, on the
    host; :func:`keep_mask` builds the mask) or a dict of explicit keep masks
    by site."""
    if drop is None or rate == 0.0:
        return x
    if isinstance(drop, dict):
        keep = drop[site].to(x.device)
        if keep.shape != x.shape:
            raise ValueError(f"dropout site {site!r}: keep mask {tuple(keep.shape)} for a "
                             f"tensor {tuple(x.shape)}")
    else:
        keep = keep_mask(x.shape, rate, drop[DROPOUT_SITES.index(site)], x.device)
    return dropout(x, rate, keep)


class Fp32LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics whatever the input dtype; the output has
    the input's dtype. The statistics as ``LN_IMPL`` says when it runs:
    'twopass' (the centered form) or 'onepass' (var = max(E[x^2] - E[x]^2,
    0), both means from one read), as JAX's ``Fp32LayerNorm``."""

    def __init__(self, dim: int, eps: float = 1e-5, init_value: float = 1.0):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((dim,), float(init_value)))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        if LN_IMPL == "onepass":
            var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
            xc = xf - mean
        else:
            xc = xf - mean
            var = (xc * xc).mean(-1, keepdim=True)
        y = xc * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU of x evaluated in fp32, rounded once to x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 on the route ``impl`` (None: ``MLP_IMPL`` when
    the module runs, as JAX's ``Mlp`` reads ``SWIN_MLP_IMPL``): ``'fused'``
    runs fc1 + GELU as one kernel and fc2 as a plain Dense; ``'fused2'`` the
    whole MLP as one kernel pair, which keeps no [tokens, hidden] tensor for
    the backward (with an fc1 dropout rate above 0 the module takes
    ``'fused'``, as JAX's does); ``'plain'`` fc1 as a Dense (:func:`dense`'s
    rounding), :func:`gelu_exact`, then fc2. ``drop`` are the two dropout
    rates: in train mode the fc1 dropout follows the GELU (K3's output on
    ``'fused'``) and the fc2 dropout follows fc2 on every route, as JAX's
    ``Mlp`` applies them; the masks come as ``forward``'s ``drop``
    (:func:`site_dropout`)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dtype: torch.dtype, impl: Optional[str] = None,
                 drop: Tuple[float, float] = (0.0, 0.0)):
        super().__init__()
        if impl not in (None,) + _MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {_MLP_IMPLS} or None, got {impl!r}")
        self.dtype = dtype
        self.impl = impl
        self.drop = tuple(drop)
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def route(self) -> str:
        """The route the module takes now: ``impl`` or ``MLP_IMPL``, 'fused2'
        falling back to 'fused' under an fc1 dropout rate."""
        impl = self.impl or MLP_IMPL
        return "fused" if impl == "fused2" and self.drop[0] != 0.0 else impl

    def fc1_out(self, x: torch.Tensor) -> torch.Tensor:
        """The plain route's fc1 product (JAX's named site ``mlp_fc1``)."""
        return dense(x, self.fc1, self.dtype)

    def after_fc1(self, h: torch.Tensor, drop=None) -> torch.Tensor:
        """The plain route from fc1's output on: GELU, the fc1 dropout, fc2,
        the fc2 dropout."""
        return self.fc2_out(gelu_exact(h), drop)

    def fc2_out(self, a: torch.Tensor, drop=None) -> torch.Tensor:
        """The fc1 dropout of the activation ``a``, fc2, the fc2 dropout."""
        a = site_dropout(a, self.drop[0], "fc1", drop)
        return site_dropout(dense(a, self.fc2, self.dtype), self.drop[1], "fc2", drop)

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        """``drop``: the block's dropout seeds or keep masks in train mode
        (:func:`site_dropout`), else None."""
        route = self.route()
        if route == "fused2":
            x = fused_mlp(x.to(self.dtype), self.fc1.weight.t(), self.fc1.bias,
                          self.fc2.weight.t(), self.fc2.bias)
            return site_dropout(x, self.drop[1], "fc2", drop)
        if route == "fused":
            return self.fc2_out(
                fused_fc1_gelu(x.to(self.dtype), self.fc1.weight.t(), self.fc1.bias), drop)
        return self.after_fc1(self.fc1_out(x), drop)


class CpbMlp(nn.Module):
    """Continuous position bias meta-network: 2 -> 384 -> heads, ReLU, with
    dropout 0.125 on the hidden layer in train mode (JAX ``CpbMlp``). Each
    Dense rounds where flax does (:func:`dense`)."""

    hidden = 384
    dropout = 0.125

    def __init__(self, num_heads: int):
        super().__init__()
        self.fc1 = nn.Linear(2, self.hidden)
        self.fc2 = nn.Linear(self.hidden, num_heads)

    def hidden_units(self, coords: torch.Tensor, dtype: torch.dtype,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """relu(fc1(coords)) [N, 384] in ``dtype``, after the dropout when the
        uniforms ``u`` [N, 384] are given (train mode): a unit is kept where
        u < 0.875 and scaled by 1 / 0.875 in ``dtype``, as flax ``Dropout``
        does."""
        h = torch.relu(dense(coords, self.fc1, dtype))
        if u is not None:
            keep = 1.0 - self.dropout
            h = torch.where(u < keep, h / keep, torch.zeros_like(h))
        return h

    def forward(self, coords: torch.Tensor, dtype: torch.dtype,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """coords [N, 2] -> [N, heads] in ``dtype``."""
        return dense(self.hidden_units(coords, dtype, u), self.fc2, dtype)


class WindowAttention(nn.Module):
    """Scaled cosine window attention, then the output projection.

    ``attn_impl`` picks the route (module docstring): ``'pallas_qkv'`` and
    ``'pallas'`` take the NHWC grid [B, H, W, C] (already rolled for shifted
    blocks), ``'pallas_v1'`` and ``'xla'`` the windows [B * nW, L, C] in the
    h-major order of ``window_grid`` = (window rows, windows per row). With
    ``rel_pos`` the CPB bias [heads, L, L] is assembled from the meta-MLP each
    call; the ``'pallas_qkv'`` route folds it (:func:`fold_cpb_bias`), the
    others take it raw. ``cpb_unique`` (the config key; None: ``CPB_UNIQUE``)
    picks the meta-MLP's rows when the module runs (:meth:`cpb_is_unique`).
    ``attn_drop`` and ``proj_drop`` are JAX's ``drop_attn`` and ``drop_proj``:
    train-mode dropout on the fp32 softmax of the plain attention and after
    the output projection.

    :meth:`core` and :meth:`bias_term` take ``impl``, the route of the call
    (None: ``attn_impl``); the block passes ``'xla'`` where JAX's dropout
    gate sends a kernel route to the plain attention on windows."""

    def __init__(self, dim: int, num_heads: int, window_size: Tuple[int, int],
                 dtype: torch.dtype, rel_pos: bool = False, cpb_unique: Optional[bool] = None,
                 attn_impl: str = "pallas_qkv", window_grid: Tuple[int, int] = (1, 1),
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.window_grid = tuple(window_grid)
        # per-head learnable logit scale, init log(10), clamped at log(100)
        self.logit_scale = nn.Parameter(torch.full((num_heads,), math.log(10.0)))
        self.meta_mlp = CpbMlp(num_heads) if rel_pos else None
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.cpb_unique = cpb_unique
        unique = idx = pairs = None
        if rel_pos:
            # the meta-MLP runs on the D distinct deltas, idx expanding its
            # [D, heads] output to every pair (exact: a pair's row is a
            # function of its delta; the dropout draws one mask per delta),
            # or on every pair
            unique, idx = make_log_relative_coords_unique(self.window_size)
            unique, idx = torch.from_numpy(unique.copy()), torch.from_numpy(idx.astype(np.int64))
            pairs = torch.from_numpy(make_log_relative_coords(self.window_size))
        self.register_buffer("cpb_coords_unique", unique, persistent=False)
        self.register_buffer("cpb_idx", idx, persistent=False)
        self.register_buffer("cpb_coords_pairs", pairs, persistent=False)

    def cpb_is_unique(self) -> bool:
        """Whether the meta-MLP runs on the distinct deltas now: the config
        key, unless ``SWIN_CPB_UNIQUE`` was set, then ``CPB_UNIQUE`` (JAX's
        ``WindowAttention._cpb_unique``)."""
        if self.cpb_unique is not None and _CPB_UNIQUE_ENV is None:
            return bool(self.cpb_unique)
        return CPB_UNIQUE

    @property
    def cpb_coords(self) -> Optional[torch.Tensor]:
        """The meta-MLP's input rows now ([D, 2] or [L*L, 2]; None without the
        CPB)."""
        return self.cpb_coords_unique if self.cpb_is_unique() else self.cpb_coords_pairs

    @property
    def cpb_rows(self) -> int:
        """Rows the meta-MLP runs on (D or L*L; 0 without the CPB)."""
        return 0 if self.meta_mlp is None else int(self.cpb_coords.shape[0])

    def cpb_raw_bias(self, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The raw CPB bias [heads, L, L] fp32: the meta-MLP's output (in the
        compute dtype) expanded to every pair; ``u`` [rows, 384] are its
        dropout uniforms (train mode) or None."""
        l = self.window_size[0] * self.window_size[1]
        unique = self.cpb_is_unique()
        cpb = self.meta_mlp(self.cpb_coords, self.dtype, u).float()  # [rows, heads]
        if unique:
            cpb = cpb[self.cpb_idx]  # [L*L, heads]
        return cpb.t().reshape(self.num_heads, l, l)

    def cpb_bias(self, scale: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The folded CPB term badd [heads, L, L] fp32 of the ``'pallas_qkv'``
        route: :func:`fold_cpb_bias` of :meth:`cpb_raw_bias`."""
        return fold_cpb_bias(self.cpb_raw_bias(u), scale)

    def scale(self) -> torch.Tensor:
        """The per-head logit scale exp(min(logit_scale, log 100)) [heads]."""
        return torch.exp(torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)))

    def bias_term(self, scale: torch.Tensor, cpb_noise: Optional[torch.Tensor] = None,
                  impl: Optional[str] = None) -> Optional[torch.Tensor]:
        """The CPB term the attention takes (JAX's named site ``cpb_bias``):
        folded on ``'pallas_qkv'``, raw on the other routes; None without the
        CPB."""
        if self.meta_mlp is None:
            return None
        if (impl or self.attn_impl) == "pallas_qkv":
            return self.cpb_bias(scale, cpb_noise)
        return self.cpb_raw_bias(cpb_noise)

    def forward(self, x: torch.Tensor, mask_pattern: Optional[torch.Tensor] = None,
                boundary_flag=None, cpb_noise: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, drop=None) -> torch.Tensor:
        """``mask_pattern`` [L, L]: the last window row's shift mask (kernel
        routes); ``mask`` [nW, L, L]: the full shift mask (``'xla'``);
        ``drop``: the block's dropout seeds or keep masks in train mode
        (:func:`site_dropout`)."""
        scale = self.scale()
        out = self.core(x, scale, self.bias_term(scale, cpb_noise), mask_pattern=mask_pattern,
                        boundary_flag=boundary_flag, mask=mask, drop=drop)
        return self.project(out, drop)

    def project(self, out: torch.Tensor, drop=None) -> torch.Tensor:
        """The output projection of :meth:`core`'s output, then the proj
        dropout; the padded-head output of the v6 route (wider than the
        model) goes through the proj weight's zero-padded rows (dense()'s
        rounding on the padded weight, as JAX does)."""
        if out.shape[-1] != self.proj.in_features:
            w_proj = pad_proj_rows(self.proj.weight.t(), self.num_heads).t()
            out = (F.linear(out.to(self.dtype), w_proj.to(self.dtype))
                   + self.proj.bias.to(self.dtype))
        else:
            out = dense(out, self.proj, self.dtype)
        return site_dropout(out, self.proj_drop, "proj", drop)

    def core(self, x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
             mask_pattern: Optional[torch.Tensor] = None, boundary_flag=None,
             mask: Optional[torch.Tensor] = None, drop=None,
             impl: Optional[str] = None) -> torch.Tensor:
        """The attention before the output projection (JAX's named site
        ``attn_kernel_out``), on :meth:`bias_term`'s ``bias``; the attention
        dropout (``drop``) applies on the plain route, the only one JAX runs
        it on."""
        impl = impl or self.attn_impl
        if impl == "pallas_qkv":
            if bias is None and _wa.qkv_impl() == "v6":
                # the padded-head route (K10): [B, H, W, heads * 128] with exact
                # zeros in the pad lanes
                return fused_window_attention_qkv_padded(
                    x, self.qkv.weight.t().to(self.dtype), self.qkv.bias, scale,
                    self.window_size, mask_pattern=mask_pattern, boundary_flag=boundary_flag)
            # the CPB term rides K7's route; without it the call dispatches on
            # QKV_IMPL: K1/K2 ('v3') or the K12 schedules ('v4', 'v5')
            cpb = {} if bias is None else dict(bias=bias, bias_prefolded=True)
            return fused_window_attention_qkv(
                x, self.qkv.weight.t().to(self.dtype), self.qkv.bias, scale,
                self.window_size, mask_pattern=mask_pattern, boundary_flag=boundary_flag, **cpb,
            )
        c = x.shape[-1]
        qkv = dense(x, self.qkv, self.dtype)
        if impl == "pallas":  # K8 on the grid: q, k, v are channel slices
            return fused_window_attention_grid(
                qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], scale, self.window_size,
                bias=bias, mask_pattern=mask_pattern, boundary_flag=boundary_flag)
        bw, l, _ = x.shape
        hd = c // self.num_heads
        q, k, v = qkv.reshape(bw, l, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        if impl == "pallas_v1":
            out = fused_window_attention(q, k, v, scale, bias=bias, mask_pattern=mask_pattern,
                                         window_grid=self.window_grid)
        else:  # 'xla': cosine similarity attention in fp32, the full mask
            qf, kf = q.float(), k.float()
            qf = qf / torch.clamp_min(torch.linalg.vector_norm(qf, dim=-1, keepdim=True), 1e-12)
            kf = kf / torch.clamp_min(torch.linalg.vector_norm(kf, dim=-1, keepdim=True), 1e-12)
            attn = torch.matmul(qf, kf.transpose(-1, -2)) * scale.reshape(1, -1, 1, 1)
            if bias is not None:
                attn = attn + bias[None]
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.reshape(bw // nw, nw, self.num_heads, l, l)
                        + mask[None, :, None]).reshape(bw, self.num_heads, l, l)
            attn = site_dropout(torch.softmax(attn, -1), self.attn_drop, "attn", drop)
            out = torch.matmul(attn.to(v.dtype), v)
        return out.transpose(1, 2).reshape(bw, l, c)


class SwinBlock(nn.Module):
    """One SwinV2-CR block: post-norm attention and MLP residual branches.

    ``proj_drop`` is the dropout rate after the output projection and after
    each MLP layer, ``attn_drop`` the one on the attention's softmax (JAX's
    ``proj_drop`` and ``drop_attn``); both act in train mode only."""

    def __init__(self, dim: int, num_heads: int, feat_size: Tuple[int, int],
                 window_size: Tuple[int, int], shift_size: Tuple[int, int], shifted: bool,
                 mlp_ratio: float = 4.0, init_values: Optional[float] = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 mlp_impl: Optional[str] = None, rel_pos: bool = False,
                 cpb_unique: Optional[bool] = None, lnadd_impl: Optional[str] = None,
                 attn_impl: str = "pallas_qkv", proj_drop: float = 0.0,
                 attn_drop: float = 0.0, remat_policy: Optional[str] = None,
                 spatial_shards: int = 1):
        super().__init__()
        if spatial_shards > 1 and attn_impl not in ("xla", "pallas", "pallas_qkv"):
            raise NotImplementedError(
                f"spatial_shards={spatial_shards}: spatial sharding supports attn_impl 'xla', "
                "'pallas' and 'pallas_qkv' (v1 windowed kernel has no boundary gate)")
        if lnadd_impl not in (None, "xla", "fused"):
            raise ValueError(f"lnadd_impl must be 'xla', 'fused' or None, got {lnadd_impl!r}")
        self.drop_path_rate = float(drop_path_rate)
        self.lnadd_impl = lnadd_impl
        self.dim = dim
        # None: no activation checkpointing; else JAX's remat_policy name
        self.remat_policy = remat_policy
        # under spatial sharding feat_size is the band's (H / spatial_shards
        # rows); the window and shift are clamped to the whole grid's
        self.spatial_shards = int(spatial_shards)
        self.spatial_group = None  # the model group (SwinTransformerV2.spatial_group)
        grid = (feat_size[0] * self.spatial_shards, feat_size[1])
        window, shift = calc_window_shift(grid, window_size, shift_size)
        self.feat_size = tuple(feat_size)
        self.window = tuple(window)
        self.shift = tuple(shift)
        self.do_shift = shifted and any(shift)
        # eval mode's windowing (train mode under attention dropout: route())
        self.windowed = attn_impl in WINDOWED_IMPLS
        self.proj_drop, self.attn_drop = float(proj_drop), float(attn_drop)
        scale_init = 1.0 if init_values is None else float(init_values)
        self.attn = WindowAttention(dim, num_heads, window, dtype, rel_pos=rel_pos,
                                    cpb_unique=cpb_unique, attn_impl=attn_impl,
                                    window_grid=(feat_size[0] // window[0],
                                                 feat_size[1] // window[1]),
                                    attn_drop=attn_drop, proj_drop=proj_drop)
        self.norm1 = Fp32LayerNorm(dim, init_value=scale_init)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, impl=mlp_impl,
                       drop=(proj_drop, proj_drop))
        self.norm2 = Fp32LayerNorm(dim, init_value=scale_init)
        pattern = full_mask = None
        if self.do_shift:
            # every masked window lies in the last window row and all share
            # this one [L, L] pattern; the plain attention ('xla', and any
            # route under attention dropout) adds the full [nW, L, L]
            mask = make_shift_mask(tuple(feat_size), window, shift)
            pattern = torch.from_numpy(mask[-1].copy())
            if attn_impl == "xla" or self.attn_drop > 0.0:
                full_mask = torch.from_numpy(mask.copy())
        self.register_buffer("mask_pattern", pattern, persistent=False)
        self.register_buffer("attn_mask", full_mask, persistent=False)

    def _fused_ln(self, y: torch.Tensor) -> bool:
        """Whether a post-norm branch on ``y`` takes the fused kernel pair:
        ``lnadd_impl`` (or when None ``LNADD_IMPL``) is 'fused' and its shape
        condition holds, as JAX's ``_ln_branch``."""
        return (self.lnadd_impl or LNADD_IMPL) == "fused" and ln_kernels.supported(
            math.prod(y.shape[:-1]), y.shape[-1])

    def _branch(self, norm: Fp32LayerNorm, y: torch.Tensor, dtype: torch.dtype, rate: float,
                u: Optional[torch.Tensor]) -> torch.Tensor:
        """The unfused branch drop_path(norm(y)) in ``dtype``."""
        return drop_path(norm(y).to(dtype), rate, u=u)

    def _ln_branch(self, norm: Fp32LayerNorm, y: torch.Tensor, x: torch.Tensor, rate: float,
                   u: Optional[torch.Tensor]) -> torch.Tensor:
        """x + drop_path(norm(y)): through the fused kernel pair where
        :meth:`_fused_ln` says so, else unfused; the parameters stay
        ``norm{1,2}.weight/bias`` either way."""
        if self._fused_ln(y):
            m = drop_path_multiplier(y.shape[0], rate, u, y.device)
            return ln_kernels.fused_ln_droppath_add(y, x, norm.weight, norm.bias, m)
        return x + self._branch(norm, y, x.dtype, rate, u)

    def remat_keep(self) -> frozenset:
        """The names this block keeps under its policy now (:func:`remat_names`
        with JAX's conditions: the MLP's configured route, not its dropout
        fallback; the fused LayerNorm branch where the width is a multiple of
        128); empty for a name that is no policy."""
        fused_mlp = (self.mlp.impl or MLP_IMPL) in ("fused", "fused2")
        fused_ln = (self.lnadd_impl or LNADD_IMPL) == "fused" and self.dim % 128 == 0
        keep = remat_names(self.remat_policy, fused_mlp, fused_ln, self.attn.meta_mlp is not None)
        return frozenset() if keep is None else keep

    def route(self, train: bool) -> str:
        """The attention route of a forward: ``'xla'`` (the window partition,
        the qkv Dense and the plain attention) where train mode has attention
        dropout on a kernel route, as JAX's gates (its ``use_grid`` and the
        ``pallas``/``pallas_v1`` kernel condition) leave the kernels; else the
        configured ``attn_impl``."""
        return "xla" if train and self.attn_drop > 0.0 else self.attn.attn_impl

    def _stages(self, x: torch.Tensor, rate: float, u1, u2, cpb_noise, pre, impl: str,
                drop) -> list:
        """The block as stages ``(name, fn, kernel_only)``; ``fn(base, cur) ->
        (base, cur)`` carries the residual stream ``base`` (the block input,
        then ``block_mid``) and the current tensor. ``name`` is JAX's named
        site at the stage's output (``out`` for the block's); ``kernel_only``
        marks a stage that is one kernel call. ``x`` is the block input (for
        the shapes); ``pre`` is (scale, CPB term) computed outside the stages,
        or None; ``impl`` the attention route (:meth:`route`); ``drop`` the
        dropout seeds or keep masks (train mode) or None."""
        attn, mlp = self.attn, self.mlp
        route = mlp.route()
        windowed = impl in WINDOWED_IMPLS
        group = self.spatial_group
        mask, flag = self.attn_mask, None
        if self.spatial_shards > 1 and self.do_shift:
            # only the band that owns the last window row masks the rows
            # rolled across the pole; the kernels keep the static pattern
            # and take the gate as a scalar, 'xla' drops the mask elsewhere
            is_last = spatial.group_rank(group) == self.spatial_shards - 1
            if impl == "xla":
                mask = mask if is_last else None
            else:
                flag = 1.0 if is_last else 0.0

        def roll(y, sign):
            if self.spatial_shards > 1:
                y = spatial.roll_h_sharded(y, sign * self.shift[0], group)
                return torch.roll(y, sign * self.shift[1], dims=2)
            return torch.roll(y, shifts=(sign * self.shift[0], sign * self.shift[1]),
                              dims=(1, 2))

        def attn_kernel_out(base, y):
            if self.do_shift:
                y = roll(y, -1)
            if windowed:  # window_partition -> attention -> window_reverse
                l = self.window[0] * self.window[1]
                y = window_partition(y, self.window).reshape(-1, l, y.shape[-1])
            if pre is None:
                scale = attn.scale()
                bias = attn.bias_term(scale, cpb_noise, impl)
            else:
                scale, bias = pre
            return base, attn.core(y, scale, bias, mask_pattern=self.mask_pattern,
                                   boundary_flag=flag, mask=mask, drop=drop, impl=impl)

        def attn_out(base, y):
            y = attn.project(y, drop)
            if windowed:
                y = window_reverse(y.reshape(-1, *self.window, y.shape[-1]), self.window,
                                   self.feat_size)
            if self.do_shift:
                y = roll(y, 1)
            return base, y

        def block_mid(x, y):  # post-norm residual branch: x + drop_path(norm(y))
            x = self._ln_branch(self.norm1, y, x, rate, u1)
            return x, x

        def mlp_fc1(x, y):
            return x, mlp.fc1_out(y)

        def mlp_out(x, y):
            return x, (mlp.after_fc1(y, drop) if route == "plain" else mlp(y, drop))

        def out(x, y):
            x = self._ln_branch(self.norm2, y, x, rate, u2)
            return x, x

        stages = [
            # with rel_pos every policy that keeps attn_kernel_out keeps
            # cpb_bias, so the CPB term comes in as ``pre`` there
            ("attn_kernel_out", attn_kernel_out, impl == "pallas_qkv" and not self.do_shift),
            ("attn_out", attn_out, False),
            ("block_mid", block_mid, self._fused_ln(x)),
        ]
        if route == "plain":
            stages.append(("mlp_fc1", mlp_fc1, False))
        # K5 alone, unless the fc2 dropout follows it in the stage
        k5_only = route == "fused2" and (drop is None or mlp.drop[1] == 0.0)
        stages += [("mlp_out", mlp_out, k5_only), ("out", out, False)]
        return stages

    def _remat(self, stages: list, keep: frozenset, x: torch.Tensor, rate: float,
               u2) -> torch.Tensor:
        """Run the stages with every run between kept names under
        ``torch.utils.checkpoint``; a kernel-only stage that ends at a kept
        name runs outside (its Function keeps its inputs)."""
        names = [name for name, _, _ in stages]
        mid = names.index("block_mid")
        base = cur = x
        i = 0
        while i < len(stages):
            name, fn, kernel_only = stages[i]
            if kernel_only and name in keep:
                base, cur = fn(base, cur)
                i += 1
                continue
            j = i
            while j < len(stages) - 1 and stages[j][0] not in keep and not (
                    stages[j + 1][2] and stages[j + 1][0] in keep):
                j += 1
            seg = [fn for _, fn, _ in stages[i:j + 1]]
            if i > mid and "block_mid" not in keep:
                # the residual stream is no survivor: checkpoint the branch
                # alone and add it outside. Only the unfused LayerNorm route
                # gets here (the fused one drops mlp_out, and mlp_fc1 comes
                # with the plain MLP, which keeps block_mid), and the run
                # ends at the block's output.
                def branch(y, seg=seg[:-1], dtype=base.dtype):
                    for f in seg:
                        _, y = f(None, y)
                    return self._branch(self.norm2, y, dtype, rate, u2)

                base = cur = base + checkpoint(branch, cur, use_reentrant=False,
                                               preserve_rng_state=False)
            else:
                def run(b, c, seg=seg):
                    for f in seg:
                        b, c = f(b, c)
                    return b, c

                base, cur = checkpoint(run, base, cur, use_reentrant=False,
                                       preserve_rng_state=False)
            i = j + 1
        return cur

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Optional[dict] = None) -> torch.Tensor:
        """``noise``: the block's uniforms and seeds, ``{"drop_path": [2, B],
        "cpb": [rows, 384], "dropout": [4, B]}`` (each key present where train
        mode needs it; ``"dropout"`` may instead be a dict of keep masks by
        site, :func:`site_dropout`). With a remat policy and grad mode on,
        the stages run under :meth:`_remat`."""
        rate = self.drop_path_rate if train else 0.0
        noise = noise or {}
        dp = noise.get("drop_path")
        u1, u2 = (None, None) if dp is None else (dp[0], dp[1])
        cpb_noise = noise.get("cpb")
        drop = None
        if train and (self.proj_drop > 0.0 or self.attn_drop > 0.0):
            drop = noise.get("dropout")
            if drop is None:
                raise ValueError("proj/attn dropout in train mode needs its seeds or keep masks "
                                 "(noise['dropout']; SwinTransformerV2.drop_noise draws them)")
        impl = self.route(train)
        remat = self.remat_policy is not None and torch.is_grad_enabled()
        keep = self.remat_keep() if remat else frozenset()
        pre = None
        if "cpb_bias" in keep:  # kept: assembled once, outside the checkpoints
            scale = self.attn.scale()
            pre = (scale, self.attn.bias_term(scale, cpb_noise, impl))
        stages = self._stages(x, rate, u1, u2, cpb_noise, pre, impl, drop)
        if remat:
            return self._remat(stages, keep, x, rate, u2)
        base = cur = x
        for _, fn, _ in stages:
            base, cur = fn(base, cur)
        return cur


class PatchEmbed(nn.Module):
    """Patchify as space-to-depth (flatten order p_h, p_w, c) + Linear + LayerNorm
    (equal to a stride-p convolution)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Linear(patch_size * patch_size * in_chans, embed_dim)
        self.norm = Fp32LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, c = x.shape
        p = self.patch_size
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // p, w // p, p * p * c)
        return self.norm(dense(x, self.proj, self.dtype))


class SwinTransformerV2(nn.Module):
    """The single-stage SwinV2-CR weather model, [B, in_chans, H, W] ->
    [B, out_chans, H, W] fp32; with ``spatial_shards`` n > 1, a band [B,
    in_chans, H / n, W] -> [B, out_chans, H / n, W] on each rank of the
    ``model`` group set as :attr:`spatial_group` (module docstring).

    ``proj_drop_rate`` and ``attn_drop_rate`` are the train-mode dropout
    rates of every block (module docstring); only direct construction sets
    them, as in JAX, whose factory reads neither. JAX's model also takes a
    ``drop_rate`` that it reads nowhere; the port has no counterpart."""

    def __init__(
        self,
        img_size: Tuple[int, int] = (720, 1440),
        patch_size: int = 4,
        in_chans: int = 73,
        out_chans: int = 73,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 8,
        window_size: Optional[Tuple[int, int]] = None,
        img_window_ratio: int = 80,
        mlp_ratio: float = 4.0,
        init_values: Optional[float] = 0.0,
        drop_path_rate: float = 0.0,
        proj_drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        full_pos_embed: bool = False,
        residual: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        mlp_impl: Optional[str] = None,
        rel_pos: bool = False,
        cpb_unique: Optional[bool] = None,
        lnadd_impl: Optional[str] = None,
        attn_impl: str = "pallas_qkv",
        checkpoint_stages: bool = False,
        remat_policy: str = "full",
        spatial_shards: int = 1,
    ):
        super().__init__()
        self.img_size = tuple(img_size)
        # JAX's checkpoint_stages / remat_policy: every block rematted under
        # the policy (SwinBlock.remat_keep)
        self.remat_policy = str(remat_policy) if checkpoint_stages else None
        self.patch_size = patch_size
        self.out_chans = out_chans
        self.residual = residual
        self.dtype = dtype
        self.dropout_rates = (proj_drop_rate, attn_drop_rate)
        h, w = self.img_size
        gh, gw = h // patch_size, w // patch_size
        window = tuple(window_size) if window_size is not None else (
            h // img_window_ratio, w // img_window_ratio
        )
        shift = tuple(ws // 2 for ws in window)
        # JAX's checks (its __call__): whole bands of whole window rows
        n_sp = self.spatial_shards = int(spatial_shards)
        if gh % n_sp:
            raise ValueError(f"patch rows {gh} not divisible by spatial_shards {n_sp}")
        gh_local = gh // n_sp
        if n_sp > 1 and gh_local % window[0]:
            raise ValueError(
                f"local patch rows {gh_local} must be a whole number of window "
                f"rows ({window[0]}) for spatial sharding")
        self._spatial_group = None

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype)
        self.pos_embed = (
            nn.Parameter(0.02 * torch.randn(1, gh, gw, embed_dim)) if full_pos_embed else None
        )
        # stochastic depth rate per block, in fp32 as the JAX model computes it
        dpr = np.linspace(0.0, drop_path_rate, depth, dtype=np.float32)
        self.blocks = nn.ModuleList(
            SwinBlock(embed_dim, num_heads, (gh_local, gw), window, shift,
                      shifted=(i % 2 == 1), mlp_ratio=mlp_ratio, init_values=init_values,
                      drop_path_rate=float(dpr[i]), dtype=dtype, mlp_impl=mlp_impl,
                      rel_pos=rel_pos, cpb_unique=cpb_unique, lnadd_impl=lnadd_impl,
                      attn_impl=attn_impl, proj_drop=proj_drop_rate,
                      attn_drop=attn_drop_rate, remat_policy=self.remat_policy,
                      spatial_shards=n_sp)
            for i in range(depth)
        )
        self.head = nn.Linear(embed_dim, out_chans * patch_size * patch_size, bias=False)
        # (index, count) of this rank's data shard (training/step.py sets it):
        # the drop-path uniforms and the dropout seeds are drawn for the
        # whole global batch and this shard's rows kept, so the masks do not
        # depend on the shard count and every band of a sample reads the
        # same ones
        self.data_shard = (0, 1)

    @property
    def spatial_group(self):
        """The process group of the ``model`` axis the bands are split over
        (None: unsharded); setting it reaches every block."""
        return self._spatial_group

    @spatial_group.setter
    def spatial_group(self, group) -> None:
        if self.spatial_shards > 1 and group is not None and (
                spatial.group_size(group) != self.spatial_shards):
            raise ValueError(f"spatial_shards={self.spatial_shards} != the model group's "
                             f"size {spatial.group_size(group)}")
        self._spatial_group = group
        for blk in self.blocks:
            blk.spatial_group = group

    def drop_noise(self, batch: int, generator: Optional[torch.Generator], device,
                   n_steps: Optional[int] = None) -> Optional[dict]:
        """The uniforms and seeds behind every random mask of one train-mode
        forward, each drawn in one call from ``generator`` (on ``device``):
        ``"drop_path"`` [depth, 2, batch] when a drop-path rate is above 0,
        then ``"cpb"`` [depth, rows, 384] for the CPB meta-MLP's dropout with
        ``rel_pos``, then ``"dropout"`` [depth, 4, batch] int64 on the host,
        one seed per block, :data:`DROPOUT_SITES` entry and sample, when a
        proj or attn dropout rate is above 0. With ``n_steps`` each gets a
        leading [n_steps] axis. None when the model draws nothing. On a data
        shard (:attr:`data_shard` (i, n)) the drop-path uniforms and the
        seeds are drawn for n * batch samples and rows [i * batch, (i + 1) *
        batch) kept."""
        depth = len(self.blocks)
        shard, n_shards = self.data_shard
        shapes = {}
        if any(blk.drop_path_rate > 0 for blk in self.blocks):
            shapes["drop_path"] = (depth, 2, batch * n_shards)
        rows = self.blocks[0].attn.cpb_rows
        if rows:
            shapes["cpb"] = (depth, rows, CpbMlp.hidden)
        seeds = any(r > 0 for r in self.dropout_rates)
        if not shapes and not seeds:
            return None
        if generator is None:
            raise ValueError("drop-path and the CPB, proj and attn dropout in train mode need "
                             "an explicit torch.Generator")
        lead = () if n_steps is None else (n_steps,)
        noise = {k: torch.rand(lead + shape, generator=generator, device=device)
                 for k, shape in shapes.items()}
        if seeds:
            # the only host copy of a draw: a site seeds its generator with a
            # Python integer
            noise["dropout"] = torch.randint(
                0, 2**62, lead + (depth, len(DROPOUT_SITES), batch * n_shards),
                generator=generator, device=device).cpu()
        if n_shards > 1:
            for key in ("drop_path", "dropout"):
                if key in noise:
                    noise[key] = noise[key][..., shard * batch:(shard + 1) * batch]
        return noise

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> torch.Tensor:
        """``train=True`` turns on drop-path, the CPB dropout and the proj and
        attn dropout: their uniforms and seeds are ``noise`` (as
        :meth:`drop_noise` returns them) when given, else drawn from
        ``generator`` (a ``torch.Generator`` on x's device; needed when
        drop_path_rate > 0, with ``rel_pos`` or with a dropout rate)."""
        n_sp = self.spatial_shards
        if n_sp > 1 and train and any(r > 0 for r in self.dropout_rates):
            # JAX's message: its per-shard dropout draws would correlate
            # across the latitude bands
            raise NotImplementedError(
                "elementwise dropout (proj/attn) under spatial sharding would "
                "correlate masks across latitude shards; train with these "
                "rates at 0 or without spatial_shards")
        if n_sp > 1 and self.spatial_group is None:
            raise ValueError(f"spatial_shards={n_sp}: the model needs its model group "
                             "(SwinTransformerV2.spatial_group)")
        b = x.shape[0]
        h, w = self.img_size
        p = self.patch_size
        gh, gw = h // p, w // p
        gh_local = gh // n_sp
        skip = x

        x = x.permute(0, 2, 3, 1).to(self.dtype)  # NCHW -> NHWC
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            pos = self.pos_embed
            if n_sp > 1:  # this band's rows of the global embedding
                row0 = spatial.group_rank(self.spatial_group) * gh_local
                pos = pos[:, row0:row0 + gh_local]
            x = x + pos.to(x.dtype)
        if train and noise is None:
            noise = self.drop_noise(b, generator, x.device)
        for i, blk in enumerate(self.blocks):
            x = blk(x, train=train, noise=None if noise is None else
                    {k: v[i] for k, v in noise.items()})

        x = dense(x, self.head, self.dtype)
        # nhwpqc -> nchpwq: interleave patch pixels back into the full grid
        x = x.reshape(b, gh_local, gw, p, p, self.out_chans).permute(0, 5, 1, 3, 2, 4)
        x = x.reshape(b, self.out_chans, h // n_sp, w).float()
        if self.residual:
            x = x + skip[:, : self.out_chans].float()
        return x


def build_swin_from_params(params, dtype: Optional[torch.dtype] = None) -> SwinTransformerV2:
    """Construct the model from a YParams-style config.

    Every ``attn_impl`` of the JAX package but its A/B variants is accepted
    (``'pallas_qkv'``, ``'pallas'``, ``'pallas_v1'``, ``'xla'``), and every
    ``mlp_impl``; ``spatial_shards`` as the config says (the model runs on a
    band once its ``spatial_group`` is set, ``training/step.py``). As
    JAX's factory: a config key wins; without ``mlp_impl`` / ``lnadd_impl``
    a multi-step or deeper-than-12 config takes 'fused2' / 'xla', the others
    None (the modules read ``MLP_IMPL`` / ``LNADD_IMPL`` when they run);
    without ``cpb_unique``, None (``CPB_UNIQUE``). ``activation_ckpt``
    turns on the blocks' remat under ``remat_policy`` ('full' when absent),
    as JAX's ``checkpoint_stages`` and ``remat_policy``.
    """
    if dtype is None:
        dtype = _DTYPES[str(getattr(params, "compute_dtype", "bfloat16"))]
    depth = int(params.depth)
    n_future = int(getattr(params, "n_future", 0) or 0)
    attn_impl = str(getattr(params, "attn_impl", "xla"))
    if attn_impl not in ATTN_IMPLS:
        raise NotImplementedError(f"attn_impl {attn_impl!r} is not ported; only {ATTN_IMPLS}")
    # the JAX factory's gating: the whole-MLP kernel and the unfused
    # LayerNorm branch for multi-step or deep stacks, else the module's switch
    deep = n_future > 0 or depth > 12
    mlp_impl = str(params["mlp_impl"]) if "mlp_impl" in params else ("fused2" if deep else None)
    lnadd_impl = (str(params["lnadd_impl"]) if "lnadd_impl" in params
                  else ("xla" if deep else None))
    return SwinTransformerV2(
        img_size=tuple(params.img_size),
        patch_size=int(params.patch_size),
        in_chans=int(params.n_in_channels),
        out_chans=int(params.n_out_channels),
        embed_dim=int(params.embed_dim),
        depth=depth,
        num_heads=int(params.num_heads),
        img_window_ratio=int(params.window_ratio),
        mlp_ratio=float(params.mlp_ratio),
        drop_path_rate=float(params.drop_path_rate),
        full_pos_embed=bool(params.full_pos_embed),
        residual=bool(params.residual),
        dtype=dtype,
        mlp_impl=mlp_impl,
        rel_pos=bool(params.rel_pos),
        cpb_unique=bool(params["cpb_unique"]) if "cpb_unique" in params else None,
        lnadd_impl=lnadd_impl,
        attn_impl=attn_impl,
        checkpoint_stages=bool(getattr(params, "activation_ckpt", False)),
        remat_policy=str(getattr(params, "remat_policy", None) or "full"),
        spatial_shards=int(getattr(params, "spatial_shards", 1) or 1),
    )
