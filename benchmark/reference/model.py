"""Plain PyTorch reference of the SwinV2 weather model (fp32, no kernels).

Written from the model's description (SwinV2-CR, arXiv:2404.19630; the
weather configs of the paper's ``config/swin.yaml``), not from the program:

  * input [B, C_in, H, W] (NCHW), taken to NHWC; patch embedding as
    space-to-depth with the flatten order (p_h, p_w, c), a Linear and a
    LayerNorm; plus the full position embedding [1, H/p, W/p, C];
  * ``depth`` post-norm blocks, x + drop_path(norm(branch(x))), on windows
    of (H / ratio, W / ratio) patches; odd blocks shift by half a window,
    with the -100 mask only along latitude (longitude wraps freely);
  * scaled cosine attention: q and k L2-normalized per head, logits times
    exp(min(logit_scale, log 100)), softmax, then the output projection;
  * MLP fc1 -> exact GELU -> fc2;
  * a bias-free head back to C_out * p * p per patch, unpatchified, plus the
    input's first C_out channels (the global residual).

Every product and every activation goes through :class:`Precision`, which
is fp32 for the reference (TF32 must be off, :func:`fp32_mode`) and fp8
e4m3 with a per-tensor scale for the control: the control holds in fp8
every value the configuration holds in its compute dtype. Parameter names and shapes
(:func:`param_shapes`) follow the program's, so the benchmark can hand the
same seeded weights to both.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


class Precision:
    """How the reference computes: ``'fp32'``, or ``'fp8'`` for the control a
    precision below the configuration's bf16: every activation (the model's
    input, each Linear's output, LayerNorm outputs, the residual stream,
    attention probabilities, the GELU) and every product operand rounded to
    float8_e4m3fn after scaling by 448 / amax (per tensor), the products
    accumulated in fp32, constants rounded unscaled. ``round`` is the
    rounding of values the configuration keeps in fp32 (losses, scores):
    identity for the reference, bf16 for the control. Rounding changes
    values only; gradients pass through it unchanged."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: expected 'fp32' or 'fp8'")
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        scale = FP8_MAX / torch.clamp_min(x.detach().abs().amax(), 1e-30)
        q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (q - x.detach())

    def const(self, v: float) -> float:
        if self.name == "fp32":
            return v
        return float(torch.tensor(v).to(torch.float8_e4m3fn).float())

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.act(a), self.act(b))

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else x + (x.detach().to(torch.bfloat16).float()
                                                  - x.detach())


FP32 = Precision("fp32")


@contextlib.contextmanager
def fp32_mode():
    """True fp32 products while open (TF32 off for cuBLAS and cuDNN)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


class Geometry:
    """Sizes of one configuration (a dict of its keys)."""

    def __init__(self, cfg: dict):
        self.h, self.w = (int(s) for s in cfg["img_size"])
        self.p = int(cfg["patch_size"])
        self.gh, self.gw = self.h // self.p, self.w // self.p
        self.c = int(cfg["embed_dim"])
        self.heads = int(cfg["num_heads"])
        self.hd = self.c // self.heads
        self.depth = int(cfg["depth"])
        self.hidden = int(self.c * float(cfg["mlp_ratio"]))
        ratio = int(cfg["window_ratio"])
        win = (self.h // ratio, self.w // ratio)
        # a window no larger than the grid; no shift where it covers it
        self.win = tuple(min(g, v) for g, v in zip((self.gh, self.gw), win))
        self.shift = tuple(0 if g <= v else v // 2 for g, v in zip((self.gh, self.gw), self.win))
        self.L = self.win[0] * self.win[1]
        self.n_out = len(cfg["out_channels"])
        self.n_in = (len(cfg["in_channels"]) + int(bool(cfg["add_zenith"]))
                     + 2 * int(bool(cfg["add_landmask"])) + int(bool(cfg["add_orography"])))
        self.drop_path = float(cfg["drop_path_rate"])
        self.residual = bool(cfg["residual"])
        self.tokens = self.gh * self.gw
        self.windows = self.tokens // self.L


def param_shapes(g: Geometry) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the order the weights are drawn."""
    shapes: Dict[str, Tuple[int, ...]] = {
        "patch_embed.proj.weight": (g.c, g.p * g.p * g.n_in),
        "patch_embed.proj.bias": (g.c,),
        "patch_embed.norm.weight": (g.c,),
        "patch_embed.norm.bias": (g.c,),
        "pos_embed": (1, g.gh, g.gw, g.c),
    }
    for i in range(g.depth):
        b = f"blocks.{i}."
        shapes.update({
            b + "attn.logit_scale": (g.heads,),
            b + "attn.qkv.weight": (3 * g.c, g.c),
            b + "attn.qkv.bias": (3 * g.c,),
            b + "attn.proj.weight": (g.c, g.c),
            b + "attn.proj.bias": (g.c,),
            b + "norm1.weight": (g.c,),
            b + "norm1.bias": (g.c,),
            b + "mlp.fc1.weight": (g.hidden, g.c),
            b + "mlp.fc1.bias": (g.hidden,),
            b + "mlp.fc2.weight": (g.c, g.hidden),
            b + "mlp.fc2.bias": (g.c,),
            b + "norm2.weight": (g.c,),
            b + "norm2.bias": (g.c,),
        })
    shapes["head.weight"] = (g.n_out * g.p * g.p, g.c)
    return shapes


def make_weights(g: Geometry, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded fp32 weights, drawn in one call on ``device``: logit scales
    log(10) + 0.3 z, position embedding and biases 0.02 z, LayerNorm scales
    1 + 0.1 z (every block's branch is live), Linear weights z / sqrt(fan_in)."""
    shapes = param_shapes(g)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if name.endswith("logit_scale"):
            z.mul_(0.3).add_(math.log(10.0))
        elif name == "pos_embed" or name.endswith(".bias"):
            z.mul_(0.02)
        elif len(shape) == 1:  # LayerNorm scale
            z.mul_(0.1).add_(1.0)
        else:
            z.mul_(1.0 / math.sqrt(shape[1]))
        out[name] = z
    return out


def shift_mask(g: Geometry) -> torch.Tensor:
    """[windows, L, L] additive mask of a shifted block: -100 between the
    rows rolled across the pole and the others (latitude only)."""
    (wh, ww), sh = g.win, g.shift[0]
    region = np.zeros((g.gh, g.gw), np.float32)
    region[g.gh - sh:, :] = 1.0  # the rows that wrapped from the top
    r = region.reshape(g.gh // wh, wh, g.gw // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    return torch.from_numpy(np.where(r[:, None, :] != r[:, :, None], -100.0, 0.0)
                            .astype(np.float32))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * w + b


def linear(x, w, b, prec: Precision):
    y = prec.matmul(x, w.t())
    return prec.act(y if b is None else y + b)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def drop_path(x: torch.Tensor, rate: float, u: Optional[torch.Tensor],
              prec: Precision = None) -> torch.Tensor:
    """Per-sample stochastic depth: keep a sample's branch where its uniform
    u < 1 - rate and scale it by 1 / (1 - rate)."""
    if u is None or rate == 0.0:
        return x
    keep = float(np.float32(1.0) - np.float32(rate))
    scale = keep if prec is None else prec.const(keep)
    return x * (u < keep).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1))) / scale


def attention(x, P, pre: str, g: Geometry, prec: Precision, mask):
    """Windowed scaled cosine attention and projection of [B, gh, gw, C]."""
    b = x.shape[0]
    (wh, ww), L = g.win, g.L
    xw = x.reshape(b, g.gh // wh, wh, g.gw // ww, ww, g.c).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(-1, L, g.c)
    qkv = linear(xw, P[pre + "qkv.weight"], P[pre + "qkv.bias"], prec)
    q, k, v = qkv.reshape(-1, L, 3, g.heads, g.hd).permute(2, 0, 3, 1, 4)
    q = q / torch.clamp_min(q.norm(dim=-1, keepdim=True), 1e-12)
    k = k / torch.clamp_min(k.norm(dim=-1, keepdim=True), 1e-12)
    scale = torch.exp(torch.clamp(P[pre + "logit_scale"], max=math.log(100.0)))
    s = prec.matmul(q, k.transpose(-1, -2)) * scale.reshape(1, -1, 1, 1)
    if mask is not None:
        s = (s.reshape(b, g.windows, g.heads, L, L) + mask[None, :, None]).reshape(s.shape)
    o = prec.act(prec.matmul(torch.softmax(s, dim=-1), v))  # [B * nW, heads, L, hd]
    o = linear(o.transpose(1, 2).reshape(-1, L, g.c), P[pre + "proj.weight"],
               P[pre + "proj.bias"], prec)
    o = o.reshape(b, g.gh // wh, g.gw // ww, wh, ww, g.c).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, g.gh, g.gw, g.c)


def block(x, P, i: int, g: Geometry, prec: Precision, mask, u: Optional[torch.Tensor]):
    """Block i; ``u`` [2, B] drop-path uniforms (train) or None."""
    pre = f"blocks.{i}."
    rate = float(np.linspace(0.0, g.drop_path, g.depth, dtype=np.float32)[i])
    shifted = i % 2 == 1 and any(g.shift)
    y = torch.roll(x, (-g.shift[0], -g.shift[1]), (1, 2)) if shifted else x
    y = attention(y, P, pre + "attn.", g, prec, mask if shifted else None)
    if shifted:
        y = torch.roll(y, g.shift, (1, 2))
    u1, u2 = (None, None) if u is None else (u[0], u[1])
    a = prec.act
    x = a(x + drop_path(a(layer_norm(y, P[pre + "norm1.weight"], P[pre + "norm1.bias"])), rate,
                        u1, prec))
    y = linear(a(gelu(linear(x, P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"], prec))),
               P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"], prec)
    return a(x + drop_path(a(layer_norm(y, P[pre + "norm2.weight"], P[pre + "norm2.bias"])), rate,
                           u2, prec))


def forward(inp: torch.Tensor, P: Dict[str, torch.Tensor], g: Geometry,
            prec: Precision = FP32, noise: Optional[torch.Tensor] = None,
            blockwise: bool = False) -> torch.Tensor:
    """[B, C_in, H, W] -> [B, C_out, H, W]. ``noise`` [depth, 2, B]: the
    drop-path uniforms of a train-mode forward; ``blockwise`` keeps only the
    block inputs for the backward and recomputes each block in it."""
    b = inp.shape[0]
    p = g.p
    x = prec.act(inp.permute(0, 2, 3, 1))
    x = x.reshape(b, g.gh, p, g.gw, p, g.n_in).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g.gh, g.gw, p * p * g.n_in)
    x = linear(x, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"], prec)
    x = prec.act(layer_norm(x, P["patch_embed.norm.weight"], P["patch_embed.norm.bias"]))
    x = prec.act(x + P["pos_embed"])
    mask = shift_mask(g).to(inp.device) if any(g.shift) else None
    for i in range(g.depth):
        u = None if noise is None else noise[i]
        if blockwise and torch.is_grad_enabled():
            x = checkpoint(block, x, P, i, g, prec, mask, u, use_reentrant=False)
        else:
            x = block(x, P, i, g, prec, mask, u)
    x = linear(x, P["head.weight"], None, prec)
    x = x.reshape(b, g.gh, g.gw, p, p, g.n_out).permute(0, 5, 1, 3, 2, 4)
    x = x.reshape(b, g.n_out, g.h, g.w)
    return x + inp[:, :g.n_out] if g.residual else x
