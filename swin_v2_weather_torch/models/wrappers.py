"""Single- and multi-step model wrappers and the model factory.

Counterpart of ``swin_v2_weather_tpu/models/wrappers.py``. The multi-step
wrapper runs the autoregressive rollout of the fine-tunes (``n_future > 0``)
inside one differentiable forward: each step feeds back [pred, the step's
future zenith, the static invariants] (reference ``networks/helpers.py:26-41``).
The JAX wrapper's two forms become two Python loops:

* **unrolled** (``scan_rollout: false``, the default for ``n_future == 1``):
  every step's activations stay alive for the backward.
* **looped** (``scan_rollout: true``, the default for ``n_future >= 2``; the
  JAX form is an ``nn.scan``): with ``remat_rollout`` (on by default) each
  step's model call runs under ``torch.utils.checkpoint``, so the backward
  keeps only the per-step carries and recomputes one step at a time; with
  ``rollout_stack_dtype`` the carries and predictions are kept in that dtype
  and the output is returned in fp32. With ``activation_ckpt`` the model's
  block remat runs inside each step's checkpoint (both non-reentrant), as
  JAX nests the block remat inside ``remat_rollout``'s: a step's backward
  recomputes the step, and each block's backward its unkept stages again.

Random masks under the checkpoint: the uniforms behind every step's
drop-path and CPB-dropout masks, and the seeds of its proj/attn dropout
masks (one per block, site and sample), are drawn from the caller's
generator before the first step and handed to each step, so a recomputed
step draws nothing from it and rebuilds the masks of its forward, and both
forms give the same masks for the same generator state.

JAX silently ignores ``rollout_stack_dtype`` on the unrolled form; the port
raises there instead.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from swin_v2_weather_torch.models.swin import SwinTransformerV2, build_swin_from_params

_STACK_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SingleStepWrapper(nn.Module):
    """Forward one 6h step; ignores the future-zenith argument."""

    def __init__(self, model: SwinTransformerV2):
        super().__init__()
        self.model = model

    def forward(self, inp: torch.Tensor, coszen: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(inp, train=train, generator=generator)


class MultiStepWrapper(nn.Module):
    """Autoregressive (n_future + 1)-step rollout inside one forward pass.

    ``inp`` is [B, C_in, H, W] with the static conditioning channels (``n_invar``
    of them: orography and the two-channel land mask) last; ``coszen`` is the
    future zenith [B, n_future + 1, H, W] or None. The output concatenates the
    step predictions on the channel axis: [B, (n_future + 1) * C_out, H, W].
    """

    def __init__(self, model: SwinTransformerV2, n_future: int, n_invar: int,
                 scan_rollout: Optional[bool] = None, remat_rollout: Optional[bool] = None,
                 stack_dtype: Optional[str] = None):
        super().__init__()
        self.model = model
        self.n_future = int(n_future)
        self.n_invar = int(n_invar)
        self.looped = bool(scan_rollout) if scan_rollout is not None else self.n_future >= 2
        self.remat = bool(remat_rollout) if remat_rollout is not None else True
        self.stack_dtype = _STACK_DTYPES[stack_dtype] if stack_dtype else None
        if self.stack_dtype is not None and not self.looped:
            raise ValueError(
                "rollout_stack_dtype applies to the looped rollout (scan_rollout) only; "
                "the unrolled form keeps the model's fp32 outputs"
            )

    def forward(self, inp: torch.Tensor, coszen: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the drop-path and CPB-dropout masks and the
        proj/attn dropout seeds of every step (train mode, drop_path_rate > 0,
        ``rel_pos`` or a dropout rate above 0)."""
        n_steps = self.n_future + 1
        noise = (self.model.drop_noise(inp.shape[0], generator, inp.device, n_steps)
                 if train else None)
        sdt = self.stack_dtype if self.looped else None
        remat = self.looped and self.remat and torch.is_grad_enabled()
        carry = inp if sdt is None else inp.to(sdt)
        invars = carry[:, -self.n_invar:] if self.n_invar else None
        preds = []
        for step in range(n_steps):
            step_noise = None if noise is None else {k: v[step] for k, v in noise.items()}
            if remat:
                pred = checkpoint(self.model, carry, train, None, step_noise,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                pred = self.model(carry, train=train, noise=step_noise)
            if sdt is not None:
                pred = pred.to(sdt)
            preds.append(pred)
            if step == self.n_future:
                break
            parts = [pred]
            if coszen is not None:
                zen = coszen[:, step:step + 1]
                parts.append(zen if sdt is None else zen.to(sdt))
            if invars is not None:
                parts.append(invars)
            carry = torch.cat(parts, dim=1)
        out = torch.cat(preds, dim=1)
        # losses and metrics take fp32 whatever the stack dtype
        return out if sdt is None else out.float()


def get_model(params, dtype: Optional[torch.dtype] = None, device="cuda") -> nn.Module:
    """Model factory: nettype dispatch + single/multi-step wrapping, on
    ``device`` (the GPU unless the caller asks for another)."""
    if params.nettype != "swin":
        raise NotImplementedError(f"model type {params.nettype} not implemented")
    core = build_swin_from_params(params, dtype=dtype)
    n_future = int(getattr(params, "n_future", 0) or 0)
    if n_future > 0:
        stack_dtype = (
            str(params["rollout_stack_dtype"])
            if "rollout_stack_dtype" in params and params["rollout_stack_dtype"] else None
        )
        model = MultiStepWrapper(
            core,
            n_future=n_future,
            n_invar=1 * bool(params.add_orography) + 2 * bool(params.add_landmask),
            scan_rollout=bool(params["scan_rollout"]) if "scan_rollout" in params else None,
            remat_rollout=bool(params["remat_rollout"]) if "remat_rollout" in params else None,
            stack_dtype=stack_dtype,
        )
    else:
        model = SingleStepWrapper(core)
    return model.to(device)
