"""Probe: the cost of the window-major, head-major 'prestage' transpose on
the GPU, with K13 (:func:`~swin_v2_weather_torch.ops.prestage.consume`) as
its consumer.

The PyTorch counterpart of ``scripts/prestage_probe.py``'s ``main()``: the
flagship's qkv [1, 180, 360, 2304] bf16 is staged to [3, B, nW, heads, Lp =
168, hd] (window-major and head-major, L padded from 162 to 168), the three
roles summed by ``consume``, the result unstaged to [B, H, W, C] and tiled
three times along the channels (+ 1e-3 * i, so no two rounds are alike),
chained 50 times; best of 3 trials, timed with CUDA events, with the
checksum of the last result. ``consume`` needs a contiguous staged tensor:
without the materialised prestage (``permute`` is a free view in PyTorch)
the probe would time nothing.

Run on a machine with a CUDA device (it exits non-zero without one):

    python -m swin_v2_weather_torch.scripts.prestage_probe

Beside each time it prints the least time an H100 SXM could take at 3.35
TB/s for the bytes each pass must move (each input read once, each output
written once): ``consume`` alone reads 309.7 MB and writes 103.2 MB (0.123
ms); the prestage leg moves 298.6 MB in and 309.7 MB out.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from swin_v2_weather_torch.ops.prestage import consume

PEAK_BYTES_PER_S = 3.35e12  # HBM3 of one H100 SXM (NVIDIA's data sheet)
# the flagship's attention: [1, 180, 360] tokens, 768 channels, 8 heads, window 9 x 18
B, H, W, C, HEADS, WINDOW = 1, 180, 360, 768, 8, (9, 18)
LP = 168  # L = 162 rounded up to 8 (JAX's sublane multiple)
ITERS, TRIALS = 50, 3


def prestage(t: torch.Tensor, heads: int, window, lp: int) -> torch.Tensor:
    """[B, H, W, 3C] -> [3, B, nW, heads, Lp, hd], materialised, pad rows zero."""
    b, h, w, c3 = t.shape
    wh, ww = window
    nwh, nww = h // wh, w // ww
    hd = c3 // 3 // heads
    s = t.reshape(b, nwh, wh, nww, ww, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    s = s.reshape(3, b, nwh * nww, heads, wh * ww, hd)  # the copy
    return torch.nn.functional.pad(s, (0, 0, 0, lp - wh * ww))


def unstage(o: torch.Tensor, hw, window) -> torch.Tensor:
    """[B, nW, heads, Lp, hd] -> [B, H, W, heads * hd], the pad rows dropped."""
    b, _, heads, _, hd = o.shape
    h, w = hw
    wh, ww = window
    t = o[..., : wh * ww, :].reshape(b, h // wh, w // ww, heads, wh, ww, hd)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, heads * hd)


def chain(t: torch.Tensor, iters: int = ITERS, heads: int = HEADS, window=WINDOW,
          lp: int = LP) -> torch.Tensor:
    """``iters`` rounds of prestage -> consume -> unstage, each feeding the
    next (so the device cannot overlap them): t = concat(u, u, u) + 1e-3 i."""
    step = torch.tensor(1e-3, dtype=t.dtype, device=t.device)
    for i in range(iters):
        u = unstage(consume(prestage(t, heads, window, lp)), t.shape[1:3], window)
        t = torch.cat([u, u, u], dim=-1) + step * i
    return t


def _events_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes: float) -> float:
    """Least ms for ``nbytes`` of device-memory traffic at 3.35 TB/s."""
    return nbytes / PEAK_BYTES_PER_S * 1e3


def probe(device, iters: int = ITERS, trials: int = TRIALS, seed: int = 0) -> dict:
    """Run the probe on ``device``: the round trip's best ms per round of
    ``trials`` chained runs, ``consume`` alone (after one warm-up call) and
    ``torch.sum(s, 0)`` on the same staged tensor, each with its byte bound;
    the checksum of the last chained result."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, H, W, 3 * C), generator=gen, device=device).to(torch.bfloat16)
    t = chain(qkv, iters)  # warm-up (and the first checksum)
    torch.cuda.synchronize(device)
    checksum0 = float(t.float().sum())
    best = float("inf")
    for trial in range(trials):
        x_t = qkv + torch.tensor(1e-3 * (trial + 1), dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = chain(x_t, iters)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    s = prestage(qkv, HEADS, WINDOW, LP)
    nb = s.element_size()
    s_bytes, o_bytes = s.numel() * nb, s[0].numel() * nb
    u_bytes = B * H * W * C * nb  # one role, unpadded
    consume(s)
    torch.cuda.synchronize(device)
    consume_ms = _events_ms(lambda: consume(s), 20)
    sum_ms = _events_ms(lambda: torch.sum(s, 0), 20)
    # one pass per leg: prestage (qkv in, staged out), consume, unstage with the
    # concat and the add fused (u in, the next qkv out)
    legs = {"prestage": 3 * u_bytes + s_bytes, "consume": s_bytes + o_bytes,
            "unstage": u_bytes + 3 * u_bytes}
    return {
        "roundtrip_ms": best, "roundtrip_bound_ms": bound_ms(sum(legs.values())),
        "prestage_bound_ms": bound_ms(legs["prestage"]),
        "consume_ms": consume_ms, "consume_bound_ms": bound_ms(legs["consume"]),
        "sum_ms": sum_ms, "staged_mb": s_bytes / 1e6, "consumed_mb": o_bytes / 1e6,
        "checksum0": checksum0, "checksum": float(t.float().sum()),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prestage_probe: no CUDA device (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    r = probe(torch.device("cuda", 0))
    print("checksum0", r["checksum0"])
    print(f"prestage + consume + unstage round trip {r['roundtrip_ms']:.4f} ms/iter, best of "
          f"{TRIALS} trials of {ITERS} (bound {r['roundtrip_bound_ms']:.4f} ms; the prestage leg "
          f"alone {r['prestage_bound_ms']:.4f} ms) on {card}")
    print(f"consume alone {r['consume_ms']:.4f} ms (bound {r['consume_bound_ms']:.4f} ms: "
          f"{r['staged_mb']:.1f} MB read, {r['consumed_mb']:.1f} MB written); torch.sum(s, 0) "
          f"{r['sum_ms']:.4f} ms (one rounding, the library yardstick)")
    print("checksum", r["checksum"])


if __name__ == "__main__":
    sys.exit(main())
