"""Fused LayerNorm + drop-path + residual add: plain PyTorch versions and CUDA kernels.

Counterpart of ``swin_v2_weather_tpu/ops/ln_kernels.py`` (forward
``_make_fwd_kernel`` / ``ln_dp_add_fwd_pallas``, backward ``_make_bwd_kernel``
/ ``ln_dp_add_bwd_pallas``, custom_vjp ``_build``, entry point
``fused_ln_droppath_add``): the post-norm residual branch
``x + drop_path(norm(z))`` of every Swin block (``lnadd_impl: fused``) in one
pass each way.

  * :func:`ln_dp_add_fwd_reference` / :func:`ln_dp_add_bwd_reference` -- the
    plain versions (CPU path and test oracles), with the kernels' rounding
    sites.
  * :func:`ln_dp_add_fwd` / :func:`ln_dp_add_bwd` -- launch
    ``csrc/ln_dp_add.cu`` (K11) on CUDA tensors; each counts its launches.
  * :class:`LnDropPathAdd` -- the autograd Function: it saves (z, gamma, m)
    and not x, as ``_build``'s ``f_fwd`` does; the residual's cotangent is the
    output's (dx = g).
  * :func:`fused_ln_droppath_add` -- the entry point the model calls; a CPU
    tensor takes the plain versions, a CUDA tensor the kernels (or an error).
  * :func:`supported` -- the shapes the kernels take (the model uses the
    unfused branch elsewhere, where the JAX model does).

Rounding sites: per-row statistics in fp32, two-pass (mean, then the mean of
the centred squares), rstd = 1 / sqrt(var + 1e-5); y = ((z - mean) rstd) gamma
+ beta in fp32; out = x + bf16(bf16(y) * bf16(m)) in x's dtype (the compute
dtype: m is rounded to it before the product). So with m = 1 the output is bit
for bit the unfused ``x + LN(z).to(x.dtype)``; in train mode it differs from
the port's unfused ``drop_path`` (which divides by keep in x's dtype) exactly
as JAX's fused route differs from its unfused one. The backward recomputes the
statistics: dy = g m in fp32 (m unrounded), dh = dy gamma, dz = rstd (dh -
mean(dh) - hhat mean(dh hhat)) in z's dtype, dgamma = sum dy hhat and dbeta =
sum dy over rows, in fp32.
"""

from __future__ import annotations

import math

import torch

from swin_v2_weather_torch.ops import _build

_EPS = 1e-5
_MAX_C = 2048  # widest row the register kernels keep; wider rows take the WIDE entry points
_MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90
_WARPS = 8  # warps a block of the backward kernels


def wide_bwd_plan(c: int) -> dict:
    """The WIDE backward's launch at width ``c`` (``csrc/ln_dp_add.cu``,
    ``wide_rows`` and ``wide_bwd_smem``): ``rows`` of z and g a stage (two
    stages, at most one row a warp; 0 where not one row fits beside the
    stages' 64 bytes of mbarriers) and the bytes of dynamic shared memory
    (the stages, the block's [2, C] fp32 partial and each staged row's
    statistics)."""
    rows = max(0, min(_WARPS, (_MAX_SMEM - 64 - 8 * c - 32 * _WARPS) // (8 * c)))
    return {"rows": rows, "smem": 8 * rows * c + 8 * c + 32 * _WARPS}


def supported(tokens: int, channels: int) -> bool:
    """Shapes the fused route takes: lane-aligned norm axis, 8-row tiles (the
    JAX kernels' condition, kept so that both models fall back alike)."""
    return channels % 128 == 0 and tokens % 8 == 0


def _row_stats(z2: torch.Tensor):
    zf = z2.float()
    zc = zf - torch.mean(zf, dim=-1, keepdim=True)
    var = torch.mean(zc * zc, dim=-1, keepdim=True)
    return zc, torch.rsqrt(var + _EPS)


def ln_dp_add_fwd_reference(z2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: z2, x2 [T, C], gamma, beta [C], m2 [T, 1]
    -> x2 + m2 * cast(LN(z2) * gamma + beta), [T, C] in x2's dtype."""
    zc, rstd = _row_stats(z2)
    y = zc * rstd * gamma.float() + beta.float()
    yb = y.to(x2.dtype) * m2.to(x2.dtype)
    return (x2 + yb).to(x2.dtype)


def ln_dp_add_bwd_reference(z2: torch.Tensor, g2: torch.Tensor, gamma: torch.Tensor,
                            m2: torch.Tensor):
    """Plain version of the backward: (dz [T, C] in z2's dtype, dgamma [C],
    dbeta [C] fp32) from z2, the output cotangent g2 [T, C], gamma [C] and m2
    [T, 1]."""
    zc, rstd = _row_stats(z2)
    hhat = zc * rstd
    dy = g2.float() * m2.float()
    dgamma = torch.sum(dy * hhat, dim=0)
    dbeta = torch.sum(dy, dim=0)
    dh = dy * gamma.float()
    t1 = torch.mean(dh * hhat, dim=-1, keepdim=True)
    t2 = torch.mean(dh, dim=-1, keepdim=True)
    dz = (rstd * (dh - t2 - hhat * t1)).to(z2.dtype)
    return dz, dgamma, dbeta


def _check_operands(name, z2, other, other_name, gamma, m2):
    """Device, dtypes, shapes and limits of a kernel call, or raise; (T, C)."""
    if z2.device.type != "cuda" or z2.dim() != 2:
        raise ValueError(f"{name}: z must be a 2-D CUDA tensor, got {z2.dim()}-D on {z2.device}")
    t, c = z2.shape
    dev = z2.device
    _build.check_operand(name, "z", z2, torch.bfloat16, (t, c), dev)
    _build.check_operand(name, other_name, other, torch.bfloat16, (t, c), dev)
    _build.check_operand(name, "gamma", gamma, torch.float32, (c,), dev)
    _build.check_operand(name, "m", m2, torch.float32, (t, 1), dev)
    if c % 128:
        raise ValueError(f"{name}: needs C % 128 == 0, got C={c}")
    return t, c


def ln_dp_add_fwd(z2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """K11's forward kernel: z2, x2 [T, C] bf16, gamma, beta [C] fp32, m2 [T, 1]
    fp32 -> [T, C] bf16. Launches on the current stream and does not
    synchronize."""
    name = "ln_dp_add_fwd"
    t, c = _check_operands(name, z2, x2, "x", gamma, m2)
    _build.check_operand(name, "beta", beta, torch.float32, (c,), z2.device)
    out = torch.empty_like(x2)
    lib = _build.load_library()
    with torch.cuda.device(z2.device):
        stream = torch.cuda.current_stream(z2.device).cuda_stream
        # rows wider than _MAX_C are streamed, not held in registers
        fn = lib.swin_ln_dp_add_fwd if c <= _MAX_C else lib.swin_ln_dp_add_wide_fwd
        code = fn(z2.data_ptr(), x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), m2.data_ptr(),
                  out.data_ptr(), t, c, stream)
    _build.check(code, name)
    ln_dp_add_fwd.launches += 1
    return out


ln_dp_add_fwd.launches = 0


@torch.library.custom_op("swin::ln_dp_add_fwd", mutates_args=())
def ln_dp_add_fwd_op(z2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """K11's forward launch (:func:`ln_dp_add_fwd`) as the custom op
    ``swin::ln_dp_add_fwd``: the serving forward of the fused post-norm
    branch calls it (m = 1 in eval mode)."""
    return ln_dp_add_fwd(z2, x2, gamma, beta, m2)


@ln_dp_add_fwd_op.register_fake
def _ln_dp_add_fwd_fake(z2, x2, gamma, beta, m2):
    return x2.new_empty(x2.shape, dtype=torch.bfloat16)


def ln_dp_add_bwd(z2: torch.Tensor, g2: torch.Tensor, gamma: torch.Tensor, m2: torch.Tensor):
    """K11's backward kernels: z2, g2 [T, C] bf16, gamma [C] fp32, m2 [T, 1]
    fp32 -> (dz [T, C] bf16, dgamma [C] fp32, dbeta [C] fp32). Each block of
    8 warps sums dgamma/dbeta over its contiguous rows into one partial, and a
    second kernel sums the partials in block order: no atomics, two calls give
    the same bits. Rows wider than 2048 channels are staged in shared memory
    (:func:`wide_bwd_plan`) and read from device memory once; there each
    column of a block's partial sums the block's rows in row order. Launches
    on the current stream."""
    name = "ln_dp_add_bwd"
    t, c = _check_operands(name, z2, g2, "g", gamma, m2)
    if c > _MAX_C and not wide_bwd_plan(c)["rows"]:
        raise ValueError(f"{name}: C={c}: one row of z and g fits a block's shared memory only "
                         f"up to C = 14464")
    # two blocks of 8 warps per SM of an H100, at least 64 rows a block
    n_blocks = max(1, min(264, -(-t // 64)))
    f32 = dict(dtype=torch.float32, device=z2.device)
    dz = torch.empty_like(z2)
    part = torch.empty((n_blocks, 2, c), **f32)
    dgamma = torch.empty((c,), **f32)
    dbeta = torch.empty((c,), **f32)
    lib = _build.load_library()
    with torch.cuda.device(z2.device):
        stream = torch.cuda.current_stream(z2.device).cuda_stream
        if c <= _MAX_C:
            code = lib.swin_ln_dp_add_bwd(z2.data_ptr(), g2.data_ptr(), gamma.data_ptr(),
                                          m2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                                          dgamma.data_ptr(), dbeta.data_ptr(), t, c, n_blocks,
                                          stream)
        else:
            code = lib.swin_ln_dp_add_wide_bwd(z2.data_ptr(), g2.data_ptr(), gamma.data_ptr(),
                                               m2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                                               dgamma.data_ptr(), dbeta.data_ptr(), t, c,
                                               n_blocks, stream)
    _build.check(code, name)
    ln_dp_add_bwd.launches += 1
    return dz, dgamma, dbeta


ln_dp_add_bwd.launches = 0


def _rows(z: torch.Tensor, m: torch.Tensor):
    """(z as [T, C], m per sample [B] -> per row [T, 1] fp32)."""
    t = math.prod(z.shape[:-1])
    m2 = m.float().repeat_interleave(t // m.shape[0]).reshape(t, 1)
    return z.reshape(t, z.shape[-1]), m2


class LnDropPathAdd(torch.autograd.Function):
    """Forward and backward of K11 (or their plain versions for CPU tensors).

    Saves (z, gamma, m) and not x, as ``_build``'s ``f_fwd`` does. m is the
    per-sample drop-path multiplier (mask / keep), a function of the random
    draw and not a parameter: it gets no gradient.
    """

    @staticmethod
    def forward(ctx, z, x, gamma, beta, m):
        ctx.save_for_backward(z, gamma, m)
        z2, m2 = _rows(z, m)
        x2 = x.reshape(z2.shape)
        if z.device.type == "cpu":
            out = ln_dp_add_fwd_reference(z2, x2, gamma, beta, m2)
        else:
            out = ln_dp_add_fwd(z2.contiguous(), x2.contiguous(), gamma.float().contiguous(),
                                beta.float().contiguous(), m2)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        z, gamma, m = ctx.saved_tensors
        z2, m2 = _rows(z, m)
        g2 = g.reshape(z2.shape)
        if z.device.type == "cpu":
            dz, dgamma, dbeta = ln_dp_add_bwd_reference(z2, g2, gamma, m2)
        else:
            dz, dgamma, dbeta = ln_dp_add_bwd(z2.contiguous(), g2.to(torch.bfloat16).contiguous(),
                                              gamma.float().contiguous(), m2)
        return dz.reshape(z.shape), g, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def fused_ln_droppath_add(z: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x + m * cast(LN(z) * gamma + beta)`` with m [B] per sample; z, x
    [B, ..., C]. The caller checks :func:`supported` for (tokens, C)."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ln_droppath_add: no implementation for device {z.device}")
    if z.shape != x.shape or m.shape != (z.shape[0],):
        raise ValueError(f"fused_ln_droppath_add: z {tuple(z.shape)} and x {tuple(x.shape)} "
                         f"must match and m must be [{z.shape[0]}], got {tuple(m.shape)}")
    if z.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K11 through its custom op, on LnDropPathAdd's operands
        z2, m2 = _rows(z, m)
        return ln_dp_add_fwd_op(z2.contiguous(), x.reshape(z2.shape).contiguous(),
                                gamma.float().contiguous(), beta.float().contiguous(),
                                m2).reshape(x.shape)
    return LnDropPathAdd.apply(z, x, gamma, beta, m)
