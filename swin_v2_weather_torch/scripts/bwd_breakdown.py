"""Device-time breakdown of the attention backwards, beside the backward of
``scaled_dot_product_attention`` on the same windowed tensors.

Run on a GPU from the root of a checkout of the repo:

    python3 -m swin_v2_weather_torch.scripts.bwd_breakdown [k2] [k8] [k9] [qkv288] [k11]

(the named families only; k2, k8 and k9 by default) or, to measure another
checkout's kernels with this script, from that checkout's root: ``python3
<path>/bwd_breakdown.py`` (the package and ``chip_smoke.py``, whose timing
helpers it uses, are imported from the working directory). Seeded inputs,
8 heads, the shifted block's mask:

  * K2 at head dim 256 (x [1, H, W, 2048], W_qkv [2048, 6144]) on the e2048
    image [180, 360] and on the e2048 train steps' [90, 180], and K7 on the
    first (window 9 x 18, L = 162);
  * K8 at head dim 256 on both images, and at head dims 96 (the flagship's
    qn, kn [1, 180, 360, 768], v a channel slice of qkv), 128 (C = 1024), 32
    and 64 (no path runs these two) on the first, bias-free and with a raw
    bias (window 9 x 18);
  * K9, bias-free and with a raw bias, on windowed [nW, 8, 162, hd] tensors:
    at head dims 96 (the flagship's [400, 8, 162, 96]), 128 and 256 on the
    e2048 image (nW = 400), at head dim 256 on the train steps' image (nW =
    100), and at head dims 32 and 64 (nW = 400), where no path runs it;
  * K8 and K9 past L = 256 at full width: window 12 x 24 (L = 288) on the
    image [180, 360] (15 x 15 windows), head dims 96 (C = 768) and 256
    (C = 2048), K8 on the grid and K9 on the windowed [225, 8, 288, hd];
  * (qkv288) the qkv-fused family there: at head dim 96 K2, K7, v5, v4,
    K10 and the padded v4, at 256 K2 and K7 (x [1, 180, 360, C]);
  * (k11) K11's backward above 2048 channels, [64800, 3072], m mixed
    between 0 and 1 / 0.9.

Each line gives the kernel's ms (CUDA events), its pieces (torch.profiler,
device ms a launch: the projection recompute, the normalization, the rows
and columns kernels (in trees before the streamed backwards, K8's and K9's
one-block kernel and the chunked rows and columns kernels), dx, dW and the
reductions) and SDPA's backward ms on windowed [nW, 8, L, hd] bf16 tensors
with the bias as a float mask (only ``torch.autograd.grad`` timed; null
with the reason where no backend takes the shape). Every line names the
card and its power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import torch

# (substring of the kernel's name, label): first match wins. The large-head
# K2 (the recompute with or without the q/k normalization in its epilogue,
# the normalization kernel, the attention kernels of either design) and
# K8's large-head backward.
K2_LARGE_PIECES = (("StoreBiasBf16", "projection (core)"),
                   ("StoreNormBf16", "projection + q/k normalization (core)"),
                   ("normalize_qk_kernel", "q/k normalization"),
                   ("rows_kernel", "rows kernel"), ("cols_kernel", "columns kernel"),
                   ("StoreBf16>", "dx (core)"), ("StoreSplitF32", "dW (core)"),
                   ("column_sums_kernel", "db column sums"), ("reduce_kernel", "reductions"))
K8_LARGE_PIECES = (("rows_kernel", "rows kernel"), ("cols_kernel", "columns kernel"),
                   ("normalize_kernel", "q/k normalization"),
                   ("attn_dscale_reduce_kernel", "d(scale) reduction"),
                   ("dbias_reduce_kernel", "d(bias) reduction"))
# K8's and K9's backward in any tree: the one-block kernel and the chunked
# kernels (past L = 256) of trees before the streamed ones took them
K9_PIECES = (("qkv_attention_bwd_kernel", "one-block kernel"),
             ("chunk_bwd_rows_kernel", "chunked rows kernel"),
             ("chunk_bwd_cols_kernel", "chunked columns kernel")) + K8_LARGE_PIECES
# K11's backward above 2048 channels in any tree: the one-pass kernel, or the
# row and column kernels of trees before it
K11_PIECES = (("ln_dp_add_bwd_wide", "rows kernel"), ("ln_dp_add_cols_wide", "column kernel"),
              ("ln_dp_add_reduce", "reduction"))
WINDOW = (9, 18)
WINDOW288 = (12, 24)  # L = 288 on the image [180, 360]: 15 x 15 windows


def sdpa_bwd_ms(shape, bias: torch.Tensor, gen: torch.Generator, n: int = 10):
    """(ms, None), or (None, reason) where no backend takes the shape: the
    backward alone of ``scaled_dot_product_attention`` on bf16 q, k, v of
    ``shape`` [nW, heads, L, hd] with ``bias`` [heads, L, L] as a bf16
    additive mask; the graph is recorded once and only
    ``torch.autograd.grad`` is timed (one scalar scale, no q/k
    normalization; the port never calls it)."""
    from chip_smoke import time_ms

    dev = bias.device
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16().requires_grad_()
               for _ in range(3))
    go = torch.randn(shape, generator=gen, device=dev).bfloat16()
    try:
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                               attn_mask=bias.bfloat16())
        ms = time_ms(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True), n)
    except RuntimeError as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:160]}"
    finally:
        del q, k, v, go
    return ms, None


def qkv_case(gen, hw, heads: int, hd: int, window=WINDOW):
    """x, g [1, H, W, heads * hd] bf16, W_qkv bf16, b, scale, the shifted
    block's mask and a folded CPB term, seeded."""
    from swin_v2_weather_torch.ops import window_attention as wa

    dev, c, l = gen.device, heads * hd, window[0] * window[1]
    x = torch.randn((1, *hw, c), generator=gen, device=dev).bfloat16()
    g = torch.randn((1, *hw, c), generator=gen, device=dev).bfloat16()
    w16 = ((2 * torch.rand((c, 3 * c), generator=gen, device=dev) - 1) / math.sqrt(c)).bfloat16()
    b = 0.02 * torch.randn((3 * c,), generator=gen, device=dev)
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    mask = shift_mask(hw, window, dev)
    badd = wa.fold_cpb_bias(torch.randn((heads, l, l), generator=gen, device=dev), scale)
    return x, g, w16, b, scale, mask, badd


def shift_mask(hw, window, dev):
    """The shifted block's mask [L, L] fp32 of ``window`` on the image ``hw``."""
    from swin_v2_weather_torch.models.swin import make_shift_mask

    shift = (window[0] // 2, window[1] // 2)
    return torch.from_numpy(make_shift_mask(hw, window, shift)[-1].copy()).to(dev)


def grid_case(gen, hw, heads: int, hd: int, window=WINDOW):
    """qn, kn (normalized per head) and v a channel slice of one seeded qkv
    [1, H, W, 3C] bf16, g, scale, a raw bias and the shifted block's mask."""
    from swin_v2_weather_torch.ops import window_attention as wa

    dev, c, l = gen.device, heads * hd, window[0] * window[1]
    qkv = torch.randn((1, *hw, 3 * c), generator=gen, device=dev).bfloat16()
    qn, _ = wa.normalize_heads(qkv[..., :c], heads)
    kn, _ = wa.normalize_heads(qkv[..., c:2 * c], heads)
    g = torch.randn((1, *hw, c), generator=gen, device=dev).bfloat16()
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    raw = 2.0 * torch.randn((heads, l, l), generator=gen, device=dev)
    return (qn, kn, qkv[..., 2 * c:]), g, scale, raw, shift_mask(hw, window, dev)


def measure(fn, labels, n: int = 3):
    """(ms by CUDA events, pieces by torch.profiler) of fn()."""
    from chip_smoke import kernel_pieces, time_ms

    return time_ms(fn, n), kernel_pieces(fn, labels, n=n)


def v1_case(gen, nw: int, heads: int, hd: int, l: int = WINDOW[0] * WINDOW[1]):
    """q, k, v, g [nW, heads, L, hd] bf16, scale and a raw bias, seeded."""
    dev = gen.device
    q, k, v, g = (torch.randn((nw, heads, l, hd), generator=gen, device=dev).bfloat16()
                  for _ in range(4))
    scale = torch.exp(math.log(10.0) + 0.3 * torch.randn((heads,), generator=gen, device=dev))
    raw = 2.0 * torch.randn((heads, l, l), generator=gen, device=dev)
    return (q, k, v), g, scale, raw


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bwd_breakdown: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from swin_v2_weather_torch.ops import window_attention as wa

    families = [a.lower() for a in sys.argv[1:]] or ["k2", "k8", "k9"]
    from swin_v2_weather_torch.ops.attic import window_attention_v45 as v45
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2018)
    heads = 8

    def report(name, ms, pieces, lib):
        lib_txt = f"{lib[0]:.4f} ms" if lib[0] is not None else f"null ({lib[1]})"
        print(f"{name}: {ms:.4f} ms; " + ", ".join(f"{k} {v:.4f}" for k, v in pieces.items())
              + f"; SDPA backward {lib_txt} ({card})", flush=True)

    def k8(tag, hw, hd, window):
        nw, l = hw[0] * hw[1] // (window[0] * window[1]), window[0] * window[1]
        ops, g, scale, raw, mask = grid_case(gen, hw, heads, hd, window)
        lib = sdpa_bwd_ms((nw, heads, l, hd), raw, gen)
        for bias in (None, raw):
            kind = "K8" if bias is None else "K8 BIAS"
            fn = ((lambda: wa.window_attention_grid_bwd(*ops, scale, g, window, mask, 1.0))
                  if bias is None else
                  (lambda: wa.window_attention_grid_bias_bwd(*ops, scale, bias, g, window, mask,
                                                             1.0)))
            ms, pieces = measure(fn, K9_PIECES)
            report(f"{kind} hd {hd} {tag} L {l} ({wa.attn_variant('', hd, l, True)})", ms,
                   pieces, lib)
        del ops, g, raw
        torch.cuda.empty_cache()

    def k9(tag, hw, hd, window):
        # K9 on the windows of this image: its pieces name the kernels that ran
        nw, l = hw[0] * hw[1] // (window[0] * window[1]), window[0] * window[1]
        mask = shift_mask(hw, window, dev)
        grid = (hw[0] // window[0], hw[1] // window[1])
        ops, g, scale, raw = v1_case(gen, nw, heads, hd, l)
        lib = sdpa_bwd_ms((nw, heads, l, hd), raw, gen)
        for bias in (None, raw):
            kind = "K9" if bias is None else "K9 BIAS"
            fn = ((lambda: wa.window_attention_v1_bwd(*ops, scale, g, grid, mask))
                  if bias is None else
                  (lambda: wa.window_attention_v1_bias_bwd(*ops, scale, bias, g, grid, mask)))
            ms, pieces = measure(fn, K9_PIECES)
            report(f"{kind} hd {hd} {tag} [{nw}, {heads}, {l}, {hd}] "
                   f"({wa.attn_variant('', hd, l, True, 'v1')})", ms, pieces, lib)
        del ops, g, raw
        torch.cuda.empty_cache()

    def qkv288(hd):
        # the qkv-fused backwards past L = 256: every instance at head dim 96,
        # K2 and K7 at 256; the variant each tree runs there
        hw, l288 = (180, 360), WINDOW288[0] * WINDOW288[1]
        x, g, w16, b, scale, mask, badd = qkv_case(gen, hw, heads, hd, WINDOW288)
        grid = (hw[0] // WINDOW288[0], hw[1] // WINDOW288[1])
        xw, gw = v45.window_major(x, WINDOW288), v45.window_major(g, WINDOW288)
        wp, bp = wa.pad_heads_w(w16, heads), wa.pad_heads_vec(b, heads)
        w5 = v45.w5_reorder(w16, heads).contiguous()
        cases = {
            "K2": lambda: wa.window_attention_qkv_bwd(x, w16, b, scale, g, WINDOW288, mask),
            "K7": lambda: wa.window_attention_qkv_bias_bwd(x, w16, b, scale, badd, g, WINDOW288,
                                                           mask),
            "v5": lambda: v45.window_attention_qkv5_bwd(x, w5, w16, b, scale, g, WINDOW288, mask),
            "v4": lambda: v45.window_attention_qkv4_bwd(xw, w16, b, scale, gw, WINDOW288, grid,
                                                        mask),
            "K10": lambda: wa.window_attention_qkv_padded_bwd(
                x, wp, bp, scale, hd, wa.pad_heads_x(g, heads, hd), WINDOW288, mask),
            "padded v4": lambda: v45.window_attention_qkv4_padded_bwd(
                xw, wp, bp, scale, hd, wa.pad_heads_x(gw, heads, hd), WINDOW288, grid, mask)}
        for name, fn in cases.items():
            if hd == 256 and name not in ("K2", "K7"):
                continue
            ms, pieces = measure(fn, K2_LARGE_PIECES)
            report(f"{name} hd {hd} [180, 360] L {l288} "
                   f"({wa.qkv_variant('', hd, l288, True)})", ms, pieces,
                   (None, "no single call computes the projection with it"))
        del x, g, w16, b, badd, xw, gw, wp, bp, w5, cases
        torch.cuda.empty_cache()

    l = WINDOW[0] * WINDOW[1]
    for tag, hw in (("e2048 [180, 360]", (180, 360)), ("e2048 train [90, 180]", (90, 180))):
        nw = hw[0] * hw[1] // l
        if "k2" in families:
            x, g, w16, b, scale, mask, badd = qkv_case(gen, hw, heads, 256)
            lib = sdpa_bwd_ms((nw, heads, l, 256), badd, gen)
            ms, pieces = measure(lambda: wa.window_attention_qkv_bwd(
                x, w16, b, scale, g, WINDOW, mask, 1.0), K2_LARGE_PIECES)
            report(f"K2 hd 256 {tag} ({wa.qkv_variant('', 256, l, True)})", ms, pieces, lib)
            if hw == (180, 360):
                ms, pieces = measure(lambda: wa.window_attention_qkv_bias_bwd(
                    x, w16, b, scale, badd, g, WINDOW, mask, 1.0), K2_LARGE_PIECES)
                report(f"K7 hd 256 {tag}", ms, pieces, lib)
            del x, g, w16, b, badd
            torch.cuda.empty_cache()
        for hd in ((96, 256, 128, 32, 64) if hw == (180, 360) else (256,)) if "k8" in families \
                else ():
            k8(f"{tag}{' (flagship)' if hd == 96 else ''}", hw, hd, WINDOW)
        for hd in ((96, 128, 256, 32, 64) if hw == (180, 360) else (256,)) if "k9" in families \
                else ():
            k9(tag, hw, hd, WINDOW)
    # past L = 256 at full width: window 12 x 24 on [180, 360], 225 windows
    for hd in (96, 256):
        if "k8" in families:
            k8("[180, 360]", (180, 360), hd, WINDOW288)
        if "k9" in families:
            k9("[180, 360]", (180, 360), hd, WINDOW288)
        if "qkv288" in families:
            qkv288(hd)
    if "k11" in families:
        from swin_v2_weather_torch.ops import ln_kernels as lk

        t, c = 64800, 3072
        z = (2.0 * torch.randn((t, c), generator=gen, device=dev) + 0.5).bfloat16()
        g = torch.randn((t, c), generator=gen, device=dev).bfloat16()
        gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        m = torch.where(torch.rand((t, 1), generator=gen, device=dev) < 0.5, 0.0,
                        1.0 / 0.9).float()
        ms, pieces = measure(lambda: lk.ln_dp_add_bwd(z, g, gamma, m), K11_PIECES)
        print(f"K11 bwd [{t}, {c}]: {ms:.4f} ms; " + ", ".join(
            f"{k} {v:.4f}" for k, v in pieces.items()) + f"; no library call ({card})", flush=True)


if __name__ == "__main__":
    main()
