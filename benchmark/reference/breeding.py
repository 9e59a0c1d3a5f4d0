"""The seed noise of breeding, written from its definition: one draw of
[P, C, H, W] standard normals (float32) from a ``torch.Generator`` on the
device seeded with the forecast's seed, each field low-passed to zonal
wavenumbers <= k (a real FFT along longitude, in float64) and scaled to a
latitude-weighted RMS of the amplitude.
"""

from __future__ import annotations

import torch

from benchmark.reference.scores import lat_weight


def lat_rms(p: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., C] latitude-weighted RMS."""
    w = lat_weight(p.shape[-2], p.device).to(p.dtype)
    return torch.sqrt(torch.mean(w * p**2, dim=(-2, -1)))


def rescale(p: torch.Tensor, amplitude: float) -> torch.Tensor:
    return p * (amplitude / lat_rms(p))[..., None, None]


def seed_noise(seed: int, n_pairs: int, shape, amplitude: float, truncation: int,
               device) -> torch.Tensor:
    """[P, C, H, W] float32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((int(n_pairs),) + tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    spec = torch.fft.rfft(z.double(), dim=-1)
    spec[..., int(truncation) + 1:] = 0
    z = torch.fft.irfft(spec, n=int(shape[-1]), dim=-1)
    return rescale(z, amplitude).float()

