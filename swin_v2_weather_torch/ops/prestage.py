"""K13: the prestage probe's consumer, ``consume``, and its plain version.

Counterpart of ``_consume`` in ``scripts/prestage_probe.py`` (the JAX
script's ``pl.pallas_call`` consumer): the three roles of a staged [3, B, nW,
heads, Lp, hd] bf16 tensor summed into [B, nW, heads, Lp, hd]. Its point is to
pin the staged array's layout, so that the probe
(``swin_v2_weather_torch/scripts/prestage_probe.py``) times a materialised
prestage transpose: in PyTorch a ``permute`` is a free view, so :func:`consume`
takes only a contiguous tensor and raises otherwise.

Rounding: the TPU kernel's ``s[0] + s[1] + s[2]`` on bf16 rounds after each
add (interpret mode on the CPU gives bf16(bf16(s0 + s1) + s2)); the plain
version and the kernel (``csrc/prestage_consume.cu``) do the same, so they
agree bit for bit. ``torch.sum(s, 0)`` rounds once and differs.
"""

from __future__ import annotations

import torch

from swin_v2_weather_torch.ops import _build


def consume_reference(s: torch.Tensor) -> torch.Tensor:
    """Plain version: (s[0] + s[1]) + s[2] in s's dtype (two roundings)."""
    return (s[0] + s[1]) + s[2]


def consume(s: torch.Tensor) -> torch.Tensor:
    """s [3, ...] bf16, contiguous -> [...] bf16: the CUDA kernel on a CUDA
    tensor (launched on the current stream), the plain version on a CPU
    tensor; a strided view raises on both."""
    name = "consume"
    if s.dim() < 2 or s.shape[0] != 3 or s.dtype != torch.bfloat16:
        raise ValueError(f"{name}: s must be a [3, ...] bf16 tensor, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if not s.is_contiguous():
        raise ValueError(f"{name}: s must be contiguous (a permuted view would make the probe "
                         "time nothing); call .contiguous() on the staged tensor")
    if s.device.type == "cpu":
        return consume_reference(s)
    if s.device.type != "cuda":
        raise ValueError(f"{name}: no implementation for device {s.device}")
    n = s[0].numel()
    if n % 8 or s.data_ptr() % 16:
        raise ValueError(f"{name}: one role's {n} elements must be a multiple of 8, the base "
                         "16-byte aligned")
    out = torch.empty(s.shape[1:], dtype=torch.bfloat16, device=s.device)
    lib = _build.load_library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        code = lib.swin_prestage_consume(s.data_ptr(), out.data_ptr(), n, stream)
    _build.check(code, name)
    consume.launches += 1
    return out


consume.launches = 0
