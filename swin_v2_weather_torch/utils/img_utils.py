"""Prediction-vs-target visualization (PyTorch port).

A copy of ``swin_v2_weather_tpu/utils/img_utils.py`` (reference
``utils/img_utils.py``): a side-by-side imshow panel of a generated field and
its target, and a host-side bilinear resize. Matplotlib is imported lazily.
"""

from __future__ import annotations

import numpy as np


def vis(fields) -> "object":
    """fields = (pred [H, W], target [H, W]) -> matplotlib Figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred, tar = fields
    fig, ax = plt.subplots(1, 2, figsize=(24, 6))
    ax[0].imshow(np.asarray(pred), cmap="turbo")
    ax[0].set_title("generated")
    ax[1].imshow(np.asarray(tar), cmap="turbo")
    ax[1].set_title("truth")
    fig.tight_layout()
    return fig


def interpolate(x: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of [.., H, W] by a scale factor (numpy host-side)."""
    h, w = x.shape[-2], x.shape[-1]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    yi = np.clip(np.linspace(0, h - 1, nh), 0, h - 1)
    xi = np.clip(np.linspace(0, w - 1, nw), 0, w - 1)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    a = x[..., y0[:, None], x0[None, :]]
    b = x[..., y0[:, None], x1[None, :]]
    c = x[..., y1[:, None], x0[None, :]]
    d = x[..., y1[:, None], x1[None, :]]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
    )
