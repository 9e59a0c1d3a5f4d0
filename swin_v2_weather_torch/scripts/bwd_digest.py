"""SHA-256 digests of the port's attention and MLP backwards at L = 162 (and
of the backwards past L = 256, at L = 288).

Run on a GPU from the root of a checkout of the repo:

    python3 -m swin_v2_weather_torch.scripts.bwd_digest

or, to digest another checkout's kernels with this script, from that
checkout's root: ``python3 <path>/bwd_digest.py`` (the package is imported
from the working directory). Each line names one backward wrapper at one
shape and gives a digest of the bytes of every output it returns, on inputs
drawn from a fixed seed on the card: the qkv-fused family (K2, K7, K10, v5,
v4, padded v4) at the flagship shape, K8 and K9 at head dims 96, 128 and 256
(the streamed kernels), K2/K7/v5/v4 at head dim 256 (the streamed
variant), K5/K6 at the e2048 train step's shape, and the backwards past
L = 256 (K2, K7, K8, K9: the streamed kernels, each with its BIAS instance
at head dims 96 and 256, L = 288). Two trees whose lines agree compute
those backwards bit for bit alike. Exits non-zero without a GPU.

Against a tree from before the qkv-fused family's streamed backward past
L = 256, exactly the four K2/K7 lines at L = 288 change: the chunked wmma
kernels summed in another order (and normalized q and k in a pass of
their own). Every other line stays equal.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys

import torch


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bwd_digest: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from swin_v2_weather_torch.models.swin import make_shift_mask
    from swin_v2_weather_torch.ops import mlp_kernels as mk
    from swin_v2_weather_torch.ops import window_attention as wa
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2018)
    window, l = (9, 18), 162

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def qkv_case(h, w, heads, hd, c_in):
        c = heads * hd
        x = rand(1, h, w, c_in).bfloat16()
        w16 = ((2 * torch.rand((c_in, 3 * c), generator=gen, device=dev) - 1)
               / math.sqrt(c_in)).bfloat16()
        b = 0.02 * rand(3 * c)
        scale = torch.exp(math.log(10.0) + 0.3 * rand(heads))
        g = rand(1, h, w, c).bfloat16()
        mask = torch.from_numpy(make_shift_mask((h, w), window, (4, 9))[-1].copy()).to(dev)
        return x, w16, b, scale, g, mask

    lines = []
    for tag, (h, w, heads, hd, c_in) in (("flagship", (180, 360, 8, 96, 768)),
                                          ("hd256", (90, 180, 8, 256, 2048))):
        x, w16, b, scale, g, mask = qkv_case(h, w, heads, hd, c_in)
        badd = wa.fold_cpb_bias(2.0 * rand(heads, l, l), scale)
        lines.append((f"window_attention_qkv_bwd {tag}",
                      wa.window_attention_qkv_bwd(x, w16, b, scale, g, window, mask, 1.0)))
        lines.append((f"window_attention_qkv_bias_bwd {tag}",
                      wa.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, g, window, mask,
                                                       1.0)))
        if tag == "flagship":
            wp, bp = wa.pad_heads_w(w16, heads), wa.pad_heads_vec(b, heads)
            lines.append(("window_attention_qkv_padded_bwd flagship",
                          wa.window_attention_qkv_padded_bwd(
                              x, wp, bp, scale, hd, wa.pad_heads_x(g, heads, hd), window, mask,
                              1.0)))
            grid = (h // window[0], w // window[1])
            xw, gw = v45.window_major(x, window), v45.window_major(g, window)
            lines.append(("window_attention_qkv5_bwd flagship", v45.window_attention_qkv5_bwd(
                x, v45.w5_reorder(w16, heads).contiguous(), w16, b, scale, g, window, mask, 1.0)))
            lines.append(("window_attention_qkv4_bwd flagship", v45.window_attention_qkv4_bwd(
                xw, w16, b, scale, gw, window, grid, mask, 1.0)))
            lines.append(("window_attention_qkv4_padded_bwd flagship",
                          v45.window_attention_qkv4_padded_bwd(
                              xw, wp, bp, scale, hd, wa.pad_heads_x(gw, heads, hd), window, grid,
                              mask, 1.0)))
        else:  # the large-head v5 and v4 (no draws: the lines above keep their inputs)
            grid = (h // window[0], w // window[1])
            lines.append(("window_attention_qkv5_bwd hd256", v45.window_attention_qkv5_bwd(
                x, v45.w5_reorder(w16, heads).contiguous(), w16, b, scale, g, window, mask, 1.0)))
            lines.append(("window_attention_qkv4_bwd hd256", v45.window_attention_qkv4_bwd(
                v45.window_major(x, window), w16, b, scale, v45.window_major(g, window), window,
                grid, mask, 1.0)))
        del x, w16, b, g, badd
    for hd in (96, 128, 256):
        heads, c = 8, 8 * hd
        qkv = rand(1, 90, 180, 3 * c).bfloat16()
        qn, _ = wa.normalize_heads(qkv[..., :c], heads)
        kn, _ = wa.normalize_heads(qkv[..., c:2 * c], heads)
        scale = torch.exp(math.log(10.0) + 0.3 * rand(heads))
        raw = 2.0 * rand(heads, l, l)
        g = rand(1, 90, 180, c).bfloat16()
        mask = torch.from_numpy(make_shift_mask((90, 180), window, (4, 9))[-1].copy()).to(dev)
        lines.append((f"window_attention_grid_bwd hd{hd}", wa.window_attention_grid_bwd(
            qn, kn, qkv[..., 2 * c:], scale, g, window, mask, 1.0)))
        lines.append((f"window_attention_grid_bias_bwd hd{hd}", wa.window_attention_grid_bias_bwd(
            qn, kn, qkv[..., 2 * c:], scale, raw, g, window, mask, 1.0)))
        q, k, v, gq = (rand(100, heads, l, hd).bfloat16() for _ in range(4))
        lines.append((f"window_attention_v1_bwd hd{hd}", wa.window_attention_v1_bwd(
            q, k, v, scale, gq, (10, 10), mask)))
        lines.append((f"window_attention_v1_bias_bwd hd{hd}", wa.window_attention_v1_bias_bwd(
            q, k, v, scale, raw, gq, (10, 10), mask)))
        del qkv, qn, kn, g, q, k, v, gq
    t, c, hidden = 16200, 2048, 4096
    x2, g2 = rand(t, c).bfloat16(), rand(t, c).bfloat16()
    w1 = (rand(c, hidden) / math.sqrt(c)).bfloat16()
    w2 = (rand(hidden, c) / math.sqrt(hidden)).bfloat16()
    b1, b2 = 0.02 * rand(hidden), 0.02 * rand(c)
    lines.append(("mlp_fwd e2048 train shape", (mk.mlp_fwd(x2, w1, b1, w2, b2),)))
    lines.append(("mlp_bwd e2048 train shape", mk.mlp_bwd(x2, w1, b1, w2, g2)))
    del x2, g2, w1, w2
    # the backwards past L = 256: window 12 x 24 (L = 288) on a [24, 48]
    # grid, two heads (last, so the lines above keep their inputs)
    win288, l288, heads = (12, 24), 288, 2
    mask = torch.from_numpy(make_shift_mask((24, 48), win288, (6, 12))[-1].copy()).to(dev)
    for hd in (96, 256):
        c = heads * hd
        x, g = rand(1, 24, 48, 64).bfloat16(), rand(1, 24, 48, c).bfloat16()
        w16 = ((2 * torch.rand((64, 3 * c), generator=gen, device=dev) - 1) / 8.0).bfloat16()
        b, scale = 0.02 * rand(3 * c), torch.exp(math.log(10.0) + 0.3 * rand(heads))
        raw = 2.0 * rand(heads, l288, l288)
        badd = wa.fold_cpb_bias(raw, scale)
        lines.append((f"window_attention_qkv_bwd l288 hd{hd}",
                      wa.window_attention_qkv_bwd(x, w16, b, scale, g, win288, mask, 1.0)))
        lines.append((f"window_attention_qkv_bias_bwd l288 hd{hd}",
                      wa.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, g, win288, mask,
                                                       1.0)))
        qkv = rand(1, 24, 48, 3 * c).bfloat16()
        qn, _ = wa.normalize_heads(qkv[..., :c], heads)
        kn, _ = wa.normalize_heads(qkv[..., c:2 * c], heads)
        lines.append((f"window_attention_grid_bwd l288 hd{hd}", wa.window_attention_grid_bwd(
            qn, kn, qkv[..., 2 * c:], scale, g, win288, mask, 1.0)))
        lines.append((f"window_attention_grid_bias_bwd l288 hd{hd}",
                      wa.window_attention_grid_bias_bwd(qn, kn, qkv[..., 2 * c:], scale, raw, g,
                                                        win288, mask, 1.0)))
        q, k, v, gq = (rand(4, heads, l288, hd).bfloat16() for _ in range(4))
        lines.append((f"window_attention_v1_bwd l288 hd{hd}", wa.window_attention_v1_bwd(
            q, k, v, scale, gq, (2, 2), mask)))
        lines.append((f"window_attention_v1_bias_bwd l288 hd{hd}",
                      wa.window_attention_v1_bias_bwd(q, k, v, scale, raw, gq, (2, 2), mask)))
    torch.cuda.synchronize()
    for name, outs in lines:
        print(f"{name}: {digest(outs)}", flush=True)


if __name__ == "__main__":
    main()
