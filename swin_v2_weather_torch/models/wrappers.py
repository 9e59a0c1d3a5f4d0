"""Model wrappers and the model factory.

Counterpart of ``swin_v2_weather_tpu/models/wrappers.py``. Only the
single-step wrapper is ported; the multi-step rollout wrapper (training
fine-tunes, ``n_future > 0``) comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from swin_v2_weather_torch.models.swin import SwinTransformerV2, build_swin_from_params


class SingleStepWrapper(nn.Module):
    """Forward one 6h step; ignores the future-zenith argument."""

    def __init__(self, model: SwinTransformerV2):
        super().__init__()
        self.model = model

    def forward(self, inp: torch.Tensor, coszen: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(inp, train=train, generator=generator)


def get_model(params, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Model factory: nettype dispatch + single-step wrapping."""
    if params.nettype != "swin":
        raise NotImplementedError(f"model type {params.nettype} not implemented")
    if int(getattr(params, "n_future", 0) or 0) > 0:
        raise NotImplementedError("n_future > 0 (multi-step wrapper) is not ported yet")
    return SingleStepWrapper(build_swin_from_params(params, dtype=dtype))
