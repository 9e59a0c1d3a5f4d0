"""Autoregressive medium-range rollout engine.

Counterpart of ``swin_v2_weather_tpu/inference/rollout.py``. Each step
re-assembles the model input as ``[state | zenith(t) | landmask one-hot x2 |
orography]`` and runs one forward on the engine's device (:class:`Stepper`,
the module ``inference/export.py`` exports). The zenith channel is computed
on the host from real timestamps with the same astronomy as training; the
static block lives on the device. Nothing moves to another device behind the
caller's back: the model and every input go to the ``device`` given.

Two loops drive the step:

  * host-stepped: :meth:`RolloutEngine.steps` / :meth:`RolloutEngine.rollout`
    compute each step's zenith on the host and copy it over, one step at a
    time;
  * chunked: :meth:`RolloutEngine.rollout_chunk` (the counterpart of JAX's
    ``lax.scan``) takes a [T, 1, 1, H, W] zenith stack
    (:meth:`RolloutEngine.zenith_stack`), copies it to the device once and
    enqueues T steps with no host synchronization in between;
    :meth:`RolloutEngine.rollout_scanned` is one such chunk over a whole
    trajectory with ``keep_channels`` applied per step, and
    :meth:`RolloutEngine.write_forecast` streams chunks to disk in physical
    units.

The host loops carry profiler spans (``utils/profiling.span``):
``swin/forecast/zenith`` (:meth:`RolloutEngine.zenith_stack`),
``swin/forecast/upload`` (a chunk's zenith stack to the device) and
``swin/forecast/steps`` (a chunk's stepper calls); :class:`Stepper`, which
``torch.export`` traces, has none.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from swin_v2_weather_torch.data.conditioning import static_features
from swin_v2_weather_torch.ops.zenith import cos_zenith_angle
from swin_v2_weather_torch.utils.profiling import span


class Stepper(nn.Module):
    """One forecast step over normalized fields: ``(state [B, C_out, H, W],
    zenith [B, 1, H, W] or None) -> prediction [B, C_out, H, W]`` fp32, with
    the static conditioning block ``static`` [1, 3, H, W] (or None) as a
    buffer."""

    def __init__(self, model: nn.Module, static: Optional[torch.Tensor]):
        super().__init__()
        self.model = model
        self.register_buffer("static", static)

    def forward(self, state: torch.Tensor, zen: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = [state]
        if zen is not None:
            parts.append(zen)
        if self.static is not None:
            parts.append(self.static.expand(state.shape[0], -1, -1, -1))
        inp = torch.cat(parts, dim=1) if len(parts) > 1 else state
        return self.model(inp, train=False).float()


class RolloutEngine:
    """Autoregressive forecaster on one device.

    Args:
      params: config (needs img_size/img_shape, add_zenith/orography/
        landmask, dt, in/out channel lists).
      model: the single-step model (SwinTransformerV2 or SingleStepWrapper);
        it is moved to ``device`` and put in eval mode.
      device: where the model runs, e.g. ``"cuda"`` or ``"cpu"``.
    """

    def __init__(self, params, model: nn.Module, device):
        self.params = params
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.h = int(getattr(params, "img_shape_x", params.img_size[0]))
        self.w = int(getattr(params, "img_shape_y", params.img_size[1]))
        self.dt = int(params.dt)
        self.hours_per_step = 6 * self.dt
        self.add_zenith = bool(params.add_zenith)
        self.n_out = len(params.out_channels)

        static = static_features(params)
        if static is not None:
            static = torch.as_tensor(static[None], dtype=torch.float32, device=self.device)
        self.stepper = Stepper(self.model, static).eval()

        if self.add_zenith:
            longitude = np.arange(0, 360, 360.0 / self.w)
            latitude = np.linspace(90, -90, self.h) if self.h % 2 else np.linspace(
                90, -90, self.h + 1
            )[: self.h]
            self.lon_grid, self.lat_grid = np.meshgrid(longitude, latitude)

    def zenith_at(self, when: datetime.datetime) -> np.ndarray:
        """[1, 1, H, W] cos-zenith channel for a timestamp."""
        z = cos_zenith_angle(when, self.lon_grid, self.lat_grid).astype(np.float32)
        return z[None, None, : self.h, : self.w]

    def zenith_stack(self, start_time: datetime.datetime, n_steps: int) -> np.ndarray:
        """[T, 1, 1, H, W] cos-zenith channels for steps 1..T of a rollout."""
        with span("forecast/zenith"):
            when = start_time
            zs = []
            for _ in range(n_steps):
                zs.append(self.zenith_at(when))
                when = when + datetime.timedelta(hours=self.hours_per_step)
            return np.stack(zs).astype(np.float32)

    def _step(self, state: torch.Tensor, zen: Optional[torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return self.stepper(state, zen)

    def _state(self, state) -> torch.Tensor:
        return torch.as_tensor(state, dtype=torch.float32, device=self.device)

    def steps(
        self,
        initial_state,  # [B, C_out, H, W], normalized (array or tensor)
        start_time: Optional[datetime.datetime],
        n_steps: int,
    ) -> Iterator[torch.Tensor]:
        """Yield normalized predictions step by step ([B, C_out, H, W] on the
        engine's device). The prediction at yield i is valid at
        start_time + (i+1)*dt*6h."""
        state = self._state(initial_state)
        b = state.shape[0]
        when = start_time
        for _ in range(n_steps):
            zen = None
            if self.add_zenith:
                if when is None:
                    raise ValueError("start_time is required when add_zenith is set")
                zen = torch.from_numpy(self.zenith_at(when)).to(self.device).expand(
                    b, 1, self.h, self.w
                )
            state = self._step(state, zen)
            yield state
            if when is not None:
                when = when + datetime.timedelta(hours=self.hours_per_step)

    def rollout(
        self,
        initial_state,
        start_time: Optional[datetime.datetime],
        n_steps: int,
        keep_channels: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Full rollout to host: [T, B, C', H, W] (C' = kept channels),
        streamed one step at a time. For throughput use
        :meth:`rollout_scanned` or chunks of :meth:`rollout_chunk`."""
        out: List[np.ndarray] = []
        for pred in self.steps(initial_state, start_time, n_steps):
            if keep_channels is not None:
                pred = pred[:, list(keep_channels)]
            out.append(pred.cpu().numpy())
        return np.stack(out)

    def _run(self, state: torch.Tensor, zstack, keep: Optional[List[int]]):
        """T steps from ``state`` on the device with the [T, 1, 1, H, W] zenith
        stack copied over once: ``(final state, preds [T, B, C', H, W])``,
        each step's kept channels written into one preallocated tensor. No
        host synchronization between the steps."""
        b = state.shape[0]
        n_steps = int(zstack.shape[0])
        with span("forecast/upload"):
            zs = torch.as_tensor(zstack, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            c = self.n_out if keep is None else len(keep)
            preds = torch.empty((n_steps, b, c, self.h, self.w), dtype=torch.float32,
                                device=self.device)
            with span("forecast/steps"):
                for t in range(n_steps):
                    zen = zs[t].expand(b, 1, self.h, self.w) if self.add_zenith else None
                    state = self.stepper(state, zen)
                    preds[t] = state if keep is None else state[:, keep]
        return state, preds

    def _zstack(self, start_time: Optional[datetime.datetime], n_steps: int) -> np.ndarray:
        if not self.add_zenith:
            return np.zeros((n_steps, 1, 1, self.h, self.w), np.float32)
        if start_time is None:
            raise ValueError("start_time is required when add_zenith is set")
        return self.zenith_stack(start_time, n_steps)

    def zenith_chunks(self, start_time: Optional[datetime.datetime], n_steps: int, chunk: int):
        """Yield ``(first step, zstack [k, 1, 1, H, W])`` for consecutive chunks
        of at most ``chunk`` of the ``n_steps`` steps (zeros without zenith)."""
        when, done = start_time, 0
        while done < n_steps:
            k = min(int(chunk), n_steps - done)
            yield done, self._zstack(when, k)
            if self.add_zenith:
                when = when + datetime.timedelta(hours=k * self.hours_per_step)
            done += k

    def rollout_chunk(self, state, zstack) -> tuple:
        """``len(zstack)`` steps enqueued back to back on the device, returning
        ``(final_state, preds [T, B, C_out, H, W])``: the building block of
        chunked scoring (a 56-step 73-channel full-resolution trajectory is
        not kept on the device in one piece; chunks carry the state across).
        ``zstack`` is [T, 1, 1, H, W] (ignored without zenith)."""
        return self._run(self._state(state), zstack, None)

    def rollout_scanned(
        self,
        initial_state,
        start_time: Optional[datetime.datetime],
        n_steps: int,
        keep_channels: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """The whole trajectory as one chunk: [T, B, C', H, W] on the engine's
        device, with the zenith stack computed up front and ``keep_channels``
        applied per step (pass it for long rollouts: 73 channels x 56 steps at
        720 x 1440 are 17 GB)."""
        keep = [int(c) for c in keep_channels] if keep_channels is not None else None
        return self._run(self._state(initial_state), self._zstack(start_time, n_steps), keep)[1]

    def write_forecast(
        self,
        out_dir: str,
        initial_state,  # [1, C_out, H, W] normalized
        start_time: Optional[datetime.datetime],
        n_steps: int,
        means: np.ndarray,  # [C_out, 1, 1] denormalization
        stds: np.ndarray,
        channel_names: Sequence[str],
        keep_names: Optional[Sequence[str]] = None,
        ic_index: Optional[int] = None,
        chunk: int = 8,
    ) -> str:
        """Run a rollout and write the forecast fields to disk, streamed chunk
        by chunk through :meth:`rollout_chunk` and denormalized on the host
        (physical units):

            <out_dir>/ic<idx>.npy    [T, C', H, W] float32
            <out_dir>/ic<idx>.json   start time, lead hours, channel names

        ``keep_names`` selects output channels by name (default: all).
        Returns the .npy path.
        """
        names = [str(c) for c in channel_names]
        if keep_names is None:
            keep = list(range(len(names)))
        else:
            missing = [c for c in keep_names if str(c) not in names]
            if missing:
                raise ValueError(f"unknown channels {missing}; have {names}")
            keep = [names.index(str(c)) for c in keep_names]
        means = np.asarray(means, np.float32).reshape(1, -1, 1, 1)[:, keep]
        stds = np.asarray(stds, np.float32).reshape(1, -1, 1, 1)[:, keep]

        state = self._state(initial_state)
        fields: List[np.ndarray] = []
        for _, zstack in self.zenith_chunks(start_time, n_steps, chunk):
            state, preds = self.rollout_chunk(state, zstack)
            fields.append(preds[:, 0, keep].cpu().numpy() * stds + means)

        os.makedirs(out_dir, exist_ok=True)
        tag = f"ic{int(ic_index):06d}" if ic_index is not None else "ic"
        npy_path = os.path.join(out_dir, f"{tag}.npy")
        np.save(npy_path, np.concatenate(fields, axis=0))
        meta = {
            "ic_index": ic_index,
            "start_time": start_time.isoformat() if start_time else None,
            "lead_hours": [int((s + 1) * self.hours_per_step) for s in range(n_steps)],
            "channels": [names[i] for i in keep],
            "grid": [self.h, self.w],
            "units": "physical (denormalized)",
        }
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return npy_path
