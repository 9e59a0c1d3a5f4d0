"""The Swin MLP's kernels: plain PyTorch versions and CUDA kernels.

Counterpart of ``swin_v2_weather_tpu/ops/mlp_kernels.py``. Two kernel pairs,
each with its autograd Function and entry point:

fc1 + GELU (``fc1_gelu_pallas``, ``fc1_dpre_pallas``, the custom_vjp
``_build`` and ``fused_fc1_gelu``; ``mlp_impl: fused``):

  * :func:`fc1_gelu_reference` / :func:`fc1_dpre_reference` -- the plain
    versions: same functions, same rounding sites, in plain tensor ops. The
    CPU path and the test oracles.
  * :func:`fc1_gelu` / :func:`fc1_dpre` -- launch the hand-written kernels in
    ``csrc/fc1_gelu.cu`` (K3 forward, K4 backward; each one launch of the
    GEMM core, ``gemm_core``: :func:`fc1_plan`) on CUDA bf16 tensors; each
    counts its launches and the core's.
  * :class:`Fc1Gelu` -- the autograd Function. It saves (x, w, b) and not the
    [T, hidden] activation, as ``_build``'s ``f_fwd`` does; the backward
    recomputes the pre-activation inside K4.
  * :func:`fused_fc1_gelu` -- the entry point the model calls. It flattens
    ``[..., C_in]`` to tokens; a CPU tensor takes the plain versions, a CUDA
    tensor the kernels (or an error).

The whole MLP, fc1 + GELU + fc2 (``mlp_fwd_pallas``, ``mlp_bwd_pallas``, the
custom_vjp ``_build_mlp`` and ``fused_mlp``; ``mlp_impl: fused2``):

  * :func:`mlp_fwd_reference` / :func:`mlp_bwd_reference` -- the plain
    versions.
  * :func:`mlp_fwd_two_phase` -- the plain version of K5's schedule: fc1
    with its epilogue into a bf16 [T, hidden] scratch, then fc2 with its
    epilogue; bit-equal to :func:`mlp_fwd_reference` (the decomposition moves
    no rounding site). :func:`mlp_fwd_plan` -- the launches of K5.
  * :func:`mlp_bwd_plan` -- K6's launch: one launch of the core's pair
    kernel, x @ W1 then g @ W2^T on each output tile, the pre-activation
    kept in registers between them.
  * :func:`mlp_fwd` / :func:`mlp_bwd` -- launch the kernels in ``csrc/mlp.cu``
    (K5 forward: two products on the GEMM core, ``gemm_core``, through a
    [T, hidden] scratch dropped on return; K6, which recomputes the activation
    and returns (a, dpre), on the core too); each counts its launches and the
    core's.
  * :class:`FusedMlp` -- the autograd Function: it saves (x, w1, b1, w2, b2),
    never a [T, hidden] tensor; its backward is K6 plus five plain products.
  * :func:`fused_mlp` -- the entry point.

Numerics: the matmuls accumulate in fp32 from operands in the compute dtype,
each product is rounded to the compute dtype exactly where
``flax.linen.Dense(dtype)`` rounds (fc1: product + bias, then round; fc2:
round the product, then add the bias in the compute dtype), and the GELU and
its derivative Phi(z) + z phi(z) are evaluated in fp32. The JAX kernels
evaluate erf with Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7); the port uses
the library erf, closer still: the difference is far below bf16 resolution.

Gradient dtypes follow ``f_bwd``: dx in x's dtype; the weight and bias
gradients as fp32 products with no rounding to the compute dtype (JAX hands
the kernels the fp32 Dense parameters, so their gradients leave unrounded).
"""

from __future__ import annotations

import math

import torch

from swin_v2_weather_torch.ops import _build, gemm_core

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gelu(pre: torch.Tensor) -> torch.Tensor:
    return 0.5 * pre * (1.0 + torch.erf(pre * _INV_SQRT2))


def _gelu_grad(pre: torch.Tensor) -> torch.Tensor:
    phi = torch.exp(pre * pre * -0.5) * _INV_SQRT2PI
    return 0.5 * (1.0 + torch.erf(pre * _INV_SQRT2)) + pre * phi


def _pre_activation(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-site pre-activation in fp32: round(x2 @ w + b) to x2's dtype.

    The products are fp32 matmuls of values already rounded to x2's dtype
    (bf16 x bf16 products are exact in fp32), so the only differences from the
    kernels are the order of the fp32 sums and the erf evaluation.
    """
    cdt = x2.dtype
    acc = torch.matmul(x2.float(), w.to(cdt).float())
    return (acc + b.float()).to(cdt).float()


def fc1_gelu_reference(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gelu(x2 @ w + b) in plain ops: [T, C_in] @ [C_in, H] -> [T, H] (dtype of x2)."""
    return _gelu(_pre_activation(x2, w, b)).to(x2.dtype)


def fc1_dpre_reference(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """g * gelu'(x2 @ w + b) in plain ops: the pre-activation cotangent
    [T, H] in x2's dtype, g [T, H] in x2's dtype."""
    return (g.float() * _gelu_grad(_pre_activation(x2, w, b))).to(x2.dtype)


def fc1_plan(t: int, c_in: int, hidden: int) -> dict:
    """K3's or K4's launch at T tokens: one launch of the GEMM core, x [T,
    C_in] (K-major) @ W1 [C_in, hidden] (MN-major, read in place), its
    :func:`gemm_core.plan` under ``fc1``; K4's epilogue also holds
    ``prefetch_words`` 32-bit words of g a consumer thread, loaded before the
    mainloop. Raises a ValueError where the core does not take the shape
    (C_in or hidden not a multiple of 8, more than 65535 row tiles)."""
    fc1 = gemm_core.plan(t, hidden, c_in, b_mn=True)
    return {"launches": 1, "bn": fc1["bn"], "grid": fc1["grid"][:2], "smem": fc1["smem"],
            "prefetch_words": fc1["bn"] // 4, "fc1": fc1}


def _check_fc1_operands(name, x2, w, b, g=None):
    if x2.device.type != "cuda" or x2.dim() != 2:
        raise ValueError(f"{name}: x2 must be a 2-D CUDA tensor, got {x2.dim()}-D on {x2.device}")
    t, k = x2.shape
    n = w.shape[-1]
    dev = x2.device
    _build.check_operand(name, "x2", x2, torch.bfloat16, (t, k), dev)
    _build.check_operand(name, "w", w, torch.bfloat16, (k, n), dev)
    _build.check_operand(name, "b", b, torch.float32, (n,), dev)
    if g is not None:
        _build.check_operand(name, "g", g, torch.bfloat16, (t, n), dev)
    fc1_plan(t, k, n)
    return t, k, n


def fc1_gelu(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel (K3): x2 [T, K] bf16, w [K, N] bf16, b [N] fp32 ->
    [T, N] bf16: one launch of the GEMM core (:func:`fc1_plan`).

    K and N must be multiples of 8. Launches on the current stream and does
    not synchronize.
    """
    name = "fc1_gelu"
    t, k, n = _check_fc1_operands(name, x2, w, b)
    out = torch.empty((t, n), dtype=torch.bfloat16, device=x2.device)
    lib = _build.load_library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.swin_fc1_gelu_fwd(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), t, k, n, stream
        )
    _build.check(code, name)
    fc1_gelu.launches += 1
    gemm_core.count_launches(1)
    return out


fc1_gelu.launches = 0


@torch.library.custom_op("swin::fc1_gelu", mutates_args=())
def fc1_gelu_op(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's launch (:func:`fc1_gelu`) as the custom op ``swin::fc1_gelu``: the
    serving forward calls it, so ``torch.export`` records one call of it and
    a loaded artifact launches K3 through it (the launch counter moves as for
    a direct call)."""
    return fc1_gelu(x2, w, b)


@fc1_gelu_op.register_fake
def _fc1_gelu_fake(x2, w, b):
    return x2.new_empty((x2.shape[0], w.shape[-1]), dtype=torch.bfloat16)


def fc1_dpre(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel (K4): x2 [T, K] bf16, w [K, N] bf16, b [N] fp32,
    g [T, N] bf16 -> dpre = g * gelu'(bf16(x2 @ w + b)) [T, N] bf16: one
    launch of the GEMM core whose epilogue reads g (:func:`fc1_plan`).

    Same shape limits as :func:`fc1_gelu`. Launches on the current stream and
    does not synchronize.
    """
    name = "fc1_dpre"
    t, k, n = _check_fc1_operands(name, x2, w, b, g)
    out = torch.empty((t, n), dtype=torch.bfloat16, device=x2.device)
    lib = _build.load_library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.swin_fc1_dpre_bwd(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), out.data_ptr(),
            t, k, n, stream,
        )
    _build.check(code, name)
    fc1_dpre.launches += 1
    gemm_core.count_launches(1)
    return out


fc1_dpre.launches = 0


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result and no rounding to a's dtype. On CUDA the bf16
    GEMM writes fp32 directly (``out_dtype``); on the CPU the operands are
    lifted to fp32, which is exact for bf16 values."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class Fc1Gelu(torch.autograd.Function):
    """gelu(x2 @ w + b) over tokens: forward K3, backward K4 plus plain
    products, or the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w, b)
        if x2.device.type == "cpu":
            return fc1_gelu_reference(x2, w, b)
        return fc1_gelu(x2.contiguous(), w.to(x2.dtype).contiguous(), b.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        cdt = x2.dtype
        g2 = g.to(cdt)
        # then the projection backward in plain products, as in f_bwd: dx
        # accumulates in fp32 and rounds once to x's dtype; dW and db stay fp32
        if x2.device.type == "cpu":
            dpre = fc1_dpre_reference(x2, w, b, g2)
            dx = torch.matmul(dpre.float(), w.to(cdt).float().t()).to(cdt)
        else:
            dpre = fc1_dpre(x2.contiguous(), w.to(cdt).contiguous(), b.float().contiguous(),
                            g2.contiguous())
            dx = torch.matmul(dpre, w.to(cdt).t())
        dw = matmul_f32(x2.t(), dpre)
        db = torch.sum(dpre.float(), 0)
        return dx.to(x2.dtype), dw.to(w.dtype), db.to(b.dtype)


def fused_fc1_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w + b) for x [..., C_in], w [C_in, H] (any float dtype), b [H];
    differentiable in x, w and b."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_fc1_gelu: no implementation for device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K3 through its custom op (torch.export traces it); the
        # autograd Function makes the same launch
        y = fc1_gelu_op(x2.contiguous(), w.to(x2.dtype).contiguous(), b.float().contiguous())
    else:
        y = Fc1Gelu.apply(x2, w, b)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# the whole MLP: fc1 + GELU + fc2 (K5 forward, K6 backward)
# ---------------------------------------------------------------------------


def mlp_fwd_reference(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """bf16(gelu(x2 @ w1 + b1)) @ w2 + b2 in plain ops: [T, C_in] -> [T, C_out]
    in x2's dtype. The fc2 product is rounded to x2's dtype and the bias is
    added in that dtype."""
    cdt = x2.dtype
    a = _gelu(_pre_activation(x2, w1, b1)).to(cdt)
    out = torch.matmul(a.float(), w2.to(cdt).float()).to(cdt)
    return out + b2.to(cdt)


def mlp_bwd_reference(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      g2: torch.Tensor):
    """(a, dpre) in plain ops, both [T, hidden] in x2's dtype: the recomputed
    activation a = gelu(pre) and dpre = (g2 @ w2^T) * gelu'(pre), with
    pre = x2 @ w1 + b1 rounded to x2's dtype and g2 @ w2^T kept in fp32."""
    cdt = x2.dtype
    pre = _pre_activation(x2, w1, b1)
    a = _gelu(pre).to(cdt)
    da = torch.matmul(g2.float(), w2.to(cdt).float().t())
    return a, (da * _gelu_grad(pre)).to(cdt)


def fc1_epilogue(acc: torch.Tensor, b1: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """K5's first epilogue on the fp32 product x @ w1: a = gelu(round(acc +
    b1)) rounded to ``cdt``."""
    return _gelu((acc + b1.float()).to(cdt).float()).to(cdt)


def fc2_epilogue(acc: torch.Tensor, b2: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """K5's second epilogue on the fp32 product a @ w2: round(acc) + round(b2)
    in ``cdt``."""
    return acc.to(cdt) + b2.to(cdt)


def mlp_fwd_two_phase(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """K5's schedule in plain ops: the fp32 product x2 @ w1 and its epilogue
    into a [T, hidden] scratch in x2's dtype, then the fp32 product
    scratch @ w2 and its epilogue."""
    cdt = x2.dtype
    act = fc1_epilogue(torch.matmul(x2.float(), w1.to(cdt).float()), b1, cdt)
    return fc2_epilogue(torch.matmul(act.float(), w2.to(cdt).float()), b2, cdt)


def mlp_fwd_plan(t: int, c_in: int, hidden: int, c_out: int) -> dict:
    """K5's launches at T tokens: ``fc1`` and ``fc2``, each the GEMM core's
    :func:`gemm_core.plan`, and the bytes of the bf16 [T, hidden] scratch
    between them. Raises a ValueError where either product does not take the
    shape."""
    return {"launches": 2,
            "fc1": gemm_core.plan(t, hidden, c_in, b_mn=True),
            "fc2": gemm_core.plan(t, c_out, hidden, b_mn=True),
            "scratch_bytes": 2 * t * hidden}


def mlp_bwd_plan(t: int, c_in: int, hidden: int, c_out: int) -> dict:
    """K6's launch at T tokens: one launch of the GEMM core's pair kernel
    (``gemm_pair_kernel``): on each 128 x ``bn`` tile of [T, hidden], x @ W1
    (W1 the MN-major B operand) then g @ W2^T (W2 the K-major one) into the
    same accumulators, the bf16 pre-activation kept in registers between
    them (``kept_words`` 32-bit words a consumer thread), so no [T, hidden]
    scratch. ``fc1`` and ``dpre`` are the two products' :func:`gemm_core.plan`.
    Raises a ValueError where either product does not take the shape."""
    fc1 = gemm_core.plan(t, hidden, c_in, b_mn=True)
    dpre = gemm_core.plan(t, hidden, c_out)
    return {"launches": 1, "bn": fc1["bn"], "grid": fc1["grid"][:2], "smem": fc1["smem"],
            "kept_words": fc1["bn"] // 4, "fc1": fc1, "dpre": dpre, "scratch_bytes": 0}


def _check_mlp_operands(name, x2, w1, b1, w2, tail, tail_name):
    if x2.device.type != "cuda" or x2.dim() != 2:
        raise ValueError(f"{name}: x2 must be a 2-D CUDA tensor, got {x2.dim()}-D on {x2.device}")
    t, c_in = x2.shape
    hidden, c_out = w1.shape[-1], w2.shape[-1]
    dev = x2.device
    _build.check_operand(name, "x2", x2, torch.bfloat16, (t, c_in), dev)
    _build.check_operand(name, "w1", w1, torch.bfloat16, (c_in, hidden), dev)
    _build.check_operand(name, "b1", b1, torch.float32, (hidden,), dev)
    _build.check_operand(name, "w2", w2, torch.bfloat16, (hidden, c_out), dev)
    dtype, shape = (torch.float32, (c_out,)) if tail_name == "b2" else (torch.bfloat16, (t, c_out))
    _build.check_operand(name, tail_name, tail, dtype, shape, dev)
    # the GEMM core's limits (K5 and K6 run on it): 16-byte TMA rows, and the
    # 128-token blocks indexed by the grid's y dimension, at most 65535
    if c_in % 8 or hidden % 8 or c_out % 8 or -(-t // 128) > 65535:
        raise ValueError(f"{name}: needs C_in, hidden and C_out multiples of 8 and at most "
                         f"65535 blocks of 128 tokens, got {c_in}, {hidden}, {c_out}, T={t}")
    return t, c_in, hidden, c_out


def mlp_fwd(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor) -> torch.Tensor:
    """The forward kernel (K5): x2 [T, C_in] bf16, w1 [C_in, H] bf16, b1 [H]
    fp32, w2 [H, C_out] bf16, b2 [C_out] fp32 -> [T, C_out] bf16: two
    products on the GEMM core (:func:`mlp_fwd_plan`) through a bf16 [T, H]
    activation scratch that is dropped on return.

    C_in, H and C_out must be multiples of 8. Launches on the current stream
    and does not synchronize.
    """
    name = "mlp_fwd"
    t, c_in, hidden, c_out = _check_mlp_operands(name, x2, w1, b1, w2, b2, "b2")
    act = torch.empty((t, hidden), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty((t, c_out), dtype=torch.bfloat16, device=x2.device)
    lib = _build.load_library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.swin_mlp_fwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            act.data_ptr(), out.data_ptr(), t, c_in, hidden, c_out, stream,
        )
    _build.check(code, name)
    mlp_fwd.launches += 1
    gemm_core.count_launches(2)  # fc1 and fc2 on the GEMM core
    return out


mlp_fwd.launches = 0


@torch.library.custom_op("swin::mlp_fwd", mutates_args=())
def mlp_fwd_op(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    """K5's launch (:func:`mlp_fwd`: both products on the GEMM core, the
    scratch between them inside the call) as the custom op ``swin::mlp_fwd``:
    the serving forward of the whole-MLP route calls it, as K3's
    (:func:`fc1_gelu_op`)."""
    return mlp_fwd(x2, w1, b1, w2, b2)


@mlp_fwd_op.register_fake
def _mlp_fwd_fake(x2, w1, b1, w2, b2):
    return x2.new_empty((x2.shape[0], w2.shape[-1]), dtype=torch.bfloat16)


def mlp_bwd(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            g2: torch.Tensor):
    """The backward kernel (K6): the operands of :func:`mlp_fwd` with the
    output cotangent g2 [T, C_out] bf16 in place of b2 -> (a, dpre), both
    [T, H] bf16: one launch of the GEMM core's pair kernel
    (:func:`mlp_bwd_plan`). Same shape limits; launches on the current stream
    and does not synchronize."""
    name = "mlp_bwd"
    t, c_in, hidden, c_out = _check_mlp_operands(name, x2, w1, b1, w2, g2, "g2")
    a = torch.empty((t, hidden), dtype=torch.bfloat16, device=x2.device)
    dpre = torch.empty_like(a)
    lib = _build.load_library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        code = lib.swin_mlp_bwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g2.data_ptr(),
            a.data_ptr(), dpre.data_ptr(), t, c_in, hidden, c_out, stream,
        )
    _build.check(code, name)
    mlp_bwd.launches += 1
    gemm_core.count_launches(1)  # the pair kernel on the GEMM core
    return a, dpre


mlp_bwd.launches = 0


class FusedMlp(torch.autograd.Function):
    """The whole MLP over tokens: forward K5, backward K6 plus five plain
    products, or the plain versions for CPU tensors. Saves its inputs only,
    never a [T, hidden] tensor."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return mlp_fwd_reference(x2, w1, b1, w2, b2)
        cdt = x2.dtype
        return mlp_fwd(x2.contiguous(), w1.to(cdt).contiguous(), b1.float().contiguous(),
                       w2.to(cdt).contiguous(), b2.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, b2 = ctx.saved_tensors
        cdt = x2.dtype
        g2 = g.to(cdt)
        # then the five products of f_bwd: dx accumulates in fp32 and rounds
        # once to x's dtype; the weight and bias gradients stay fp32
        if x2.device.type == "cpu":
            a, dpre = mlp_bwd_reference(x2, w1, b1, w2, g2)
            dx = torch.matmul(dpre.float(), w1.to(cdt).float().t()).to(cdt)
        else:
            a, dpre = mlp_bwd(x2.contiguous(), w1.to(cdt).contiguous(), b1.float().contiguous(),
                              w2.to(cdt).contiguous(), g2.contiguous())
            dx = torch.matmul(dpre, w1.to(cdt).t())
        dw1 = matmul_f32(x2.t(), dpre)
        db1 = torch.sum(dpre.float(), 0)
        dw2 = matmul_f32(a.t(), g2)
        db2 = torch.sum(g2.float(), 0)
        return (dx.to(x2.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype))


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """bf16(gelu(x @ w1 + b1)) @ w2 + b2 for x [..., C_in], w1 [C_in, H],
    w2 [H, C_out] (any float dtype), b1 [H], b2 [C_out]; differentiable in all
    five. The output has x's dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: no implementation for device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and not torch.is_grad_enabled():
        # serving: K5 through its custom op, on FusedMlp's operands
        cdt = x2.dtype
        y = mlp_fwd_op(x2.contiguous(), w1.to(cdt).contiguous(), b1.float().contiguous(),
                       w2.to(cdt).contiguous(), b2.float().contiguous())
    else:
        y = FusedMlp.apply(x2, w1, b1, w2, b2)
    return y.reshape(*x.shape[:-1], w2.shape[-1])
