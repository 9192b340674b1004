"""Host-side (numpy) resizes with torch-interpolate semantics.

Bilinear: half-pixel centers, no antialias, the same values as
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``.
The input adapter resizes images to a multiple of 64 with it, the CLI
resizes predictions back to the input size, and the data layer resizes
input images. Nearest (order 0): the data layer's target resize and the
evaluation's prediction-to-ground-truth resize.
"""

from __future__ import annotations

import numpy as np


def _source_coords_halfpixel(out_size: int, in_size: int) -> np.ndarray:
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of (..., H, W) to ``size`` = (out_h, out_w)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    img = np.asarray(img, dtype=np.float32)
    if (in_h, in_w) == (out_h, out_w):
        return img

    ys = np.clip(_source_coords_halfpixel(out_h, in_h), 0, in_h - 1)
    xs = np.clip(_source_coords_halfpixel(out_w, in_w), 0, in_w - 1)

    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)

    rows = img[..., y0, :] * (1 - wy)[:, None] + img[..., y1, :] * wy[:, None]
    return rows[..., :, x0] * (1 - wx) + rows[..., :, x1] * wx


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """Order-0 resize of (..., H, W): each output pixel takes the source pixel
    nearest to its half-pixel center (rounded half to even)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return np.asarray(img)
    ys = np.clip(np.round(_source_coords_halfpixel(out_h, in_h)).astype(np.int64), 0, in_h - 1)
    xs = np.clip(np.round(_source_coords_halfpixel(out_w, in_w)).astype(np.int64), 0, in_w - 1)
    return img[..., ys, :][..., :, xs]
