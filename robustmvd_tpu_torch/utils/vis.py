"""Turbo-colormapped rendering of 2D arrays, for the inference CLI's PNGs.

The 2D-array path of the JAX package's ``utils/vis.py`` with its default
options (reference: rmvd/utils/vis.py:184-463): non-finite values are
zeroed, the valid range is stretched to [0, 255], mapped through a turbo
lookup table, and the value range is written into the bottom-left corner.
"""

from __future__ import annotations

import numpy as np


def _turbo_table():
    """Polynomial approximation of the turbo colormap (Google AI blog, 2019).

    Returns a (256, 3) uint8 lookup table.
    """
    x = np.linspace(0.0, 1.0, 256)
    r = np.polyval([59.28, -152.94, 128.55, -42.66, 4.61, 0.135], x)
    g = np.polyval([-14.0, 4.8, 25.9, -42.4, 25.0, 0.09], x)
    b = np.polyval([-89.9, 252.5, -254.3, 105.3, -5.0, 0.28], x)
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


_TURBO = _turbo_table()


def vis(arr):
    """Render a 2D array, or a (1, H, W) / (1, 1, H, W) stack, as a PIL image."""
    from PIL import Image, ImageDraw

    arr = np.asarray(arr, dtype=np.float32)
    while arr.ndim > 2 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 2:
        raise ValueError(f"vis renders 2D arrays, got shape {arr.shape}")

    invalid = ~np.isfinite(arr)
    arr = np.where(invalid, 0.0, arr).astype(np.float32)
    valid = arr[~invalid]
    if valid.size == 0:
        scaled, lo, hi, constant = np.zeros_like(arr), 0.0, 0.0, True
    else:
        lo, hi = float(np.min(valid)), float(np.max(valid))
        constant = hi == lo
        if constant:
            scaled = arr * 0 if lo == 0 else (arr / lo) * 255.0
        else:
            scaled = (arr - lo) / (hi - lo) * 255.0

    rgb = _TURBO[np.clip(scaled, 0, 255).astype(np.uint8)]
    img = Image.fromarray(rgb, mode="RGB")

    if constant:
        text = "Image: Constant: %0.3f" % lo
    else:
        text = "Min (blue): %0.3f Max (red): %0.3f" % (lo, hi)
    line_h = 11
    ImageDraw.Draw(img).text((5, img.height - 5 - line_h), text, fill="white")
    return img
