"""Ensemble forecasting: initial-condition perturbations and probabilistically
scored rollouts.

Counterpart of ``swin_v2_weather_tpu/inference/ensemble.py``:

  * members ride the batch dimension of the engine's step: one forward
    advances all M members at once;
  * scoring runs inside the chunked loop: each step reduces CRPS, spread,
    ensemble-mean RMSE, control RMSE and ensemble-mean ACC on the device, and
    only [C]-sized rows reach the host, once a chunk; the device holds the
    M states and one chunk of targets whatever the trajectory's length;
  * perturbations come in centered pairs (member 0 the control, then
    +/- pairs), so the ensemble mean is unbiased at the initial time.

Profiler spans (``utils/profiling.span``): breeding is one
(``swin/forecast/breed``, the engine's nested in it); the scored loop puts
each chunk's upload of zenith and targets in ``swin/forecast/upload``, each
step's stepper call in ``.../steps`` and its scoring in ``.../score``, and
each chunk's rows to the host in ``.../flush``.

JAX draws its noise from ``jax.random`` keys; the port draws from an
explicit ``torch.Generator`` (:func:`gaussian_perturbations`) or from one
seeded on the engine's device (:func:`breed_perturbations`). The two give
different numbers from the same seed; the shaping of the noise
(:func:`shape_noise`: zonal truncation and amplitude) is the same function.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from swin_v2_weather_torch.ops.metrics import (
    ensemble_spread_channels,
    latitude_weights,
    weighted_acc_channels,
    weighted_crps_channels,
    weighted_rmse_channels,
)
from swin_v2_weather_torch.utils.profiling import span


def _lat_rms(fields: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., C] latitude-weighted RMS amplitude."""
    weight = latitude_weights(fields.shape[-2], fields.dtype, fields.device).reshape(1, -1, 1)
    return torch.sqrt(torch.mean(weight * fields**2, dim=(-1, -2)))


def _rescale(pert: torch.Tensor, amplitude: float) -> torch.Tensor:
    """Scale each [C, H, W] field of [P, C, H, W] to lat-weighted RMS = amplitude."""
    rms = _lat_rms(pert)[..., None, None]
    return pert * (amplitude / torch.clamp_min(rms, 1e-12))


def shape_noise(noise: torch.Tensor, amplitude: float,
                zonal_truncation: Optional[int] = None) -> torch.Tensor:
    """[P, C, H, W] noise low-passed to zonal wavenumbers <= ``zonal_truncation``
    (real FFT along longitude) where given, then each field scaled to the
    latitude-weighted RMS ``amplitude``."""
    if zonal_truncation is not None:
        spec = torch.fft.rfft(noise, dim=-1)
        keep = torch.arange(spec.shape[-1], device=noise.device) <= int(zonal_truncation)
        noise = torch.fft.irfft(spec * keep, n=noise.shape[-1], dim=-1)
    return _rescale(noise, amplitude)


def gaussian_perturbations(
    generator: torch.Generator,
    n_pairs: int,
    shape,  # (C, H, W)
    amplitude: float,
    zonal_truncation: Optional[int] = None,
) -> torch.Tensor:
    """[P, C, H, W] Gaussian perturbation fields on the generator's device,
    each channel's latitude-weighted RMS normalized to ``amplitude``
    (normalized-state units).

    ``zonal_truncation=k`` low-passes the noise to zonal wavenumbers <= k,
    giving spatially coherent large-scale perturbations instead of grid-point
    white noise, the usual choice for initial-condition ensembles at 0.25°.
    """
    noise = torch.randn((int(n_pairs),) + tuple(shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
    return shape_noise(noise, amplitude, zonal_truncation)


def breed_perturbations(
    engine,
    initial_state,  # [1, C_out, H, W] normalized
    start_time,
    n_pairs: int,
    amplitude: float,
    cycles: int = 3,
    seed: int = 0,
    zonal_truncation: Optional[int] = 20,
) -> torch.Tensor:
    """[P, C, H, W] bred vectors: perturbations grown by the model itself.

    Breeding seeded with Gaussian noise (a generator on the engine's device
    seeded with ``seed``): step the control and each perturbed state forward
    one dt together (one batch of P + 1 states), rescale the grown difference
    back to ``amplitude``, repeat ``cycles`` times. The perturbations then lean
    towards the fastest-growing error modes of the flow. With only the
    initial state at hand, the cycles run forward from it and the bred vector
    is applied back at the initial time.
    """
    with span("forecast/breed"):
        state = torch.as_tensor(initial_state, dtype=torch.float32, device=engine.device)
        c, h, w = state.shape[-3:]
        gen = torch.Generator(device=engine.device).manual_seed(int(seed))
        pert = gaussian_perturbations(gen, n_pairs, (c, h, w), amplitude, zonal_truncation)
        for _, zstack in engine.zenith_chunks(start_time, int(cycles), 1):
            batch = torch.cat([state, state + pert], dim=0)  # [1 + P, C, H, W]
            nxt, _ = engine.rollout_chunk(batch, zstack)
            state, grown = nxt[:1], nxt[1:] - nxt[:1]
            pert = _rescale(grown, amplitude)
        return pert


def make_members(initial_state, perturbations: torch.Tensor, n_members: int) -> torch.Tensor:
    """[M, C, H, W] members on the perturbations' device: the control, then
    centered +/- pairs (mean-unbiased)."""
    ic = torch.as_tensor(initial_state, dtype=torch.float32, device=perturbations.device)
    if ic.dim() == 4:
        ic = ic[0]
    members = [ic]
    for p in perturbations:
        if len(members) < n_members:
            members.append(ic + p)
        if len(members) < n_members:
            members.append(ic - p)
    if len(members) != n_members:
        raise ValueError(
            f"need {(n_members - 1 + 1) // 2} perturbation pairs for {n_members} members, "
            f"got {perturbations.shape[0]}"
        )
    return torch.stack(members)


def score_ensemble(
    engine,
    members,  # [M, C_out, H, W] normalized
    targets: Sequence[np.ndarray],  # [1, C_out, H, W] normalized, one a lead time
    start_time,
    means: np.ndarray,
    stds: np.ndarray,
    climatology: Optional[np.ndarray] = None,  # [C_out, H, W] physical units
    channel_names: Optional[Sequence[str]] = None,
    chunk: int = 8,
) -> Dict[str, np.ndarray]:
    """Probabilistically scored ensemble rollout.

    Returns per-lead-time [T, C] arrays: ``crps`` (fair, physical units),
    ``spread`` (sqrt of the latitude-weighted mean member variance),
    ``rmse_mean`` (RMSE of the ensemble-mean forecast), ``rmse_control``
    (member 0), ``acc_mean`` (with a climatology), and ``lead_hours``,
    ``n_members`` (and ``channels``). Each chunk copies its zenith stack and
    its targets to the device, steps the members ``chunk`` times and
    reduces the rows there; the [M, C, H, W] state is the only tensor kept
    across chunks.
    """
    dev = engine.device
    state = torch.as_tensor(members, dtype=torch.float32, device=dev)
    m = int(state.shape[0])
    c, h, w = state.shape[-3:]
    means_d = torch.as_tensor(np.asarray(means, np.float32).reshape(1, -1, 1, 1), device=dev)
    stds_d = torch.as_tensor(np.asarray(stds, np.float32).reshape(1, -1, 1, 1), device=dev)
    clim = None
    if climatology is not None:
        clim = torch.as_tensor(np.asarray(climatology, np.float32).reshape(
            (1,) + np.shape(climatology)[-3:]), device=dev)

    keys = ("crps", "spread", "rmse_mean", "rmse_control") + (("acc_mean",) if clim is not None
                                                                else ())
    out_rows: Dict[str, list] = {k: [] for k in keys}
    n_steps = len(targets)
    with torch.inference_mode():
        for done, zstack in engine.zenith_chunks(start_time, n_steps, chunk):
            k = len(zstack)
            with span("forecast/upload"):
                zs = torch.as_tensor(zstack).to(dev)
                tchunk = torch.empty((k, c, h, w), dtype=torch.float32, device=dev)
                for s in range(k):  # each target straight into the chunk, no host-side stack
                    tchunk[s] = torch.as_tensor(targets[done + s], dtype=torch.float32).reshape(
                        c, h, w)
            rows = {key: [] for key in keys}
            for s in range(k):
                zen = zs[s].expand(m, 1, h, w) if engine.add_zenith else None
                with span("forecast/steps"):
                    state = engine.stepper(state, zen)  # [M, C, H, W]
                with span("forecast/score"):
                    ens_phys = state * stds_d + means_d  # the members in physical units
                    tar_phys = tchunk[s][None] * stds_d + means_d  # [1, C, H, W]
                    mean_phys = torch.mean(ens_phys, dim=0, keepdim=True)
                    rows["crps"].append(weighted_crps_channels(ens_phys[:, None], tar_phys)[0])
                    rows["spread"].append(ensemble_spread_channels(ens_phys[:, None])[0])
                    rows["rmse_mean"].append(weighted_rmse_channels(mean_phys, tar_phys)[0])
                    rows["rmse_control"].append(
                        weighted_rmse_channels(ens_phys[:1], tar_phys)[0])
                    if clim is not None:
                        rows["acc_mean"].append(
                            weighted_acc_channels(mean_phys - clim, tar_phys - clim)[0])
            with span("forecast/flush"):  # one device -> host copy a chunk
                block = torch.stack([torch.stack(rows[key]) for key in keys]).cpu().numpy()
            for key, vals in zip(keys, block):
                out_rows[key].append(vals)

    out: Dict[str, np.ndarray] = {k: np.concatenate(v) for k, v in out_rows.items()}
    out["lead_hours"] = np.arange(1, n_steps + 1) * engine.hours_per_step
    out["n_members"] = m
    if channel_names is not None:
        out["channels"] = np.asarray(list(channel_names))
    return out
