"""Resizes with torch-interpolate semantics, on the host (numpy) and, for
images the evaluation stages on the device, on any device (torch).

Bilinear: half-pixel centers, no antialias, the same values as
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``.
The input adapter resizes images to a multiple of 64 with it, the CLI
resizes predictions back to the input size, and the data layer resizes
input images. :func:`resize_bilinear_torch` is the same arithmetic on a
tensor where it lies. Nearest (order 0): the data layer's target resize and
the evaluation's prediction-to-ground-truth resize.
"""

from __future__ import annotations

import numpy as np
import torch


def _source_coords_halfpixel(out_size: int, in_size: int) -> np.ndarray:
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


def _bilinear_taps(out_size: int, in_size: int):
    """The two source rows (or columns) of each output one and the float32
    weight of the second, from float64 half-pixel coordinates."""
    coords = np.clip(_source_coords_halfpixel(out_size, in_size), 0, in_size - 1)
    i0 = np.floor(coords).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (coords - i0).astype(np.float32)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of (..., H, W) to ``size`` = (out_h, out_w)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    img = np.asarray(img, dtype=np.float32)
    if (in_h, in_w) == (out_h, out_w):
        return img
    y0, y1, wy = _bilinear_taps(out_h, in_h)
    x0, x1, wx = _bilinear_taps(out_w, in_w)
    rows = img[..., y0, :] * (1 - wy)[:, None] + img[..., y1, :] * wy[:, None]
    return rows[..., :, x0] * (1 - wx) + rows[..., :, x1] * wx


def resize_bilinear_torch(img: torch.Tensor, size) -> torch.Tensor:
    """:func:`resize_bilinear` of a (..., H, W) tensor, on its device.

    The taps and weights are worked out on the host as there and uploaded
    in two small copies; the two float32 lerps run in the same order, rows
    first, each ``a * (1 - w) + b * w`` as separate multiplies and an add.
    On the CPU the result is the numpy function's bit for bit; on the card
    each op is one IEEE float32 kernel (nothing fuses them into a
    multiply-add), so it should be too."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    img = img.to(torch.float32)
    if (in_h, in_w) == (out_h, out_w):
        return img
    y0, y1, wy = _bilinear_taps(out_h, in_h)
    x0, x1, wx = _bilinear_taps(out_w, in_w)
    index = torch.from_numpy(np.concatenate([y0, y1, x0, x1])).to(img.device)
    weight = torch.from_numpy(np.concatenate([1 - wy, wy, 1 - wx, wx])).to(img.device)
    iy0, iy1, ix0, ix1 = torch.split(index, [out_h, out_h, out_w, out_w])
    vy0, vy1, vx0, vx1 = torch.split(weight, [out_h, out_h, out_w, out_w])
    rows = img.index_select(-2, iy0) * vy0[:, None] + img.index_select(-2, iy1) * vy1[:, None]
    return rows.index_select(-1, ix0) * vx0 + rows.index_select(-1, ix1) * vx1


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
