"""Frozen counts: model FLOPs, and each hand kernel's operations and bytes.

Every count comes from the configuration's shapes, at 2 M N K per product:

  * model FLOPs of one forward of one sample: the patch embedding, per block
    the qkv projection, q.k^T and p.v of every (window, head), the output
    projection, fc1 and fc2, then the head. A train step is 3 forwards;
    recomputation under remat is not counted;
  * a kernel launch's operations and bytes (each input read once, each
    output written once), over T tokens:

      K1  qkv-fused forward: projection T x C x 3C and two score products
          per (window, head);
      K2  its backward: three T x C x 3C products and five score products;
      K3  fc1 + GELU and K4 its backward: T x C x hidden;
      K5  the whole MLP and K6 its backward: T x hidden x (C + C).

The roofline bound of a launch is the larger of its operations over the
bf16 peak and its bytes over the memory bandwidth (``peaks.json``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))


class Shapes:
    def __init__(self, cfg: dict):
        h, w = (int(s) for s in cfg["img_size"])
        self.p = int(cfg["patch_size"])
        self.tokens = (h // self.p) * (w // self.p)
        self.c = int(cfg["embed_dim"])
        self.heads = int(cfg["num_heads"])
        self.hd = self.c // self.heads
        self.depth = int(cfg["depth"])
        self.hidden = int(self.c * float(cfg["mlp_ratio"]))
        ratio = int(cfg["window_ratio"])
        self.L = min(h // self.p, h // ratio) * min(w // self.p, w // ratio)
        self.n_out = len(cfg["out_channels"])
        self.n_in = (len(cfg["in_channels"]) + int(bool(cfg["add_zenith"]))
                     + 2 * int(bool(cfg["add_landmask"])) + int(bool(cfg["add_orography"])))

    def scores(self, t: float) -> float:
        """One L x L x hd score product for every (window, head) over t tokens."""
        return 2.0 * self.L * self.L * self.hd * self.heads * (t / self.L)


def model_flops(cfg: dict, batch: int = 1) -> float:
    """FLOPs of one forward of ``batch`` samples (matrix products only)."""
    s = Shapes(cfg)
    t = s.tokens
    per_block = (2.0 * t * s.c * 3 * s.c + 2 * s.scores(t) + 2.0 * t * s.c * s.c
                 + 2 * 2.0 * t * s.c * s.hidden)
    total = (2.0 * t * s.p * s.p * s.n_in * s.c + s.depth * per_block
             + 2.0 * t * s.c * s.n_out * s.p * s.p)
    return batch * total


def kernel_cost(kernel: str, cfg: dict, tokens: float) -> Tuple[float, float]:
    """(operations, bytes) of one launch of ``kernel`` over ``tokens`` tokens."""
    s = Shapes(cfg)
    t, c, hid = float(tokens), s.c, s.hidden
    act, w_qkv = 2.0 * t * c, 2.0 * 3 * c * c
    if kernel == "K1":
        return 2.0 * t * c * 3 * c + 2 * s.scores(t), act + w_qkv + 4.0 * 3 * c + act
    if kernel == "K2":
        # reads x, W, b, g; writes dx, dW and db in fp32
        return (3 * 2.0 * t * c * 3 * c + 5 * s.scores(t),
                2 * act + w_qkv + 4.0 * 3 * c + act + 4.0 * 3 * c * c + 4.0 * 3 * c)
    if kernel == "K3":
        return 2.0 * t * c * hid, act + 2.0 * c * hid + 4.0 * hid + 2.0 * t * hid
    if kernel == "K4":
        return 2.0 * t * c * hid, act + 2.0 * c * hid + 4.0 * hid + 2 * 2.0 * t * hid
    if kernel == "K5":
        return 2.0 * t * hid * 2 * c, 2 * act + 4.0 * c * hid + 4.0 * (hid + c)
    if kernel == "K6":
        # reads x, W1, b1, W2, g; writes a and dpre
        return 2.0 * t * hid * 2 * c, 2 * act + 4.0 * c * hid + 4.0 * hid + 2 * 2.0 * t * hid
    raise KeyError(f"no count for kernel {kernel!r}")


def peaks(device_name: str) -> Dict[str, float]:
    """The card's published peaks (``peaks.json``, matched by a substring of
    the device name)."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)
    for key, val in table.items():
        if key in device_name:
            return val
    raise KeyError(f"no peaks for device {device_name!r} in peaks.json")


def bound_s(kernel: str, cfg: dict, tokens: float, peak: Dict[str, float]) -> float:
    """The least time one launch can take on the card."""
    ops, nbytes = kernel_cost(kernel, cfg, tokens)
    return max(ops / peak["bf16_flops_s"], nbytes / peak["hbm_bytes_s"])
