"""Bilinear sampling at index-space coordinates (channel-last maps).

Counterpart of the JAX package's ``ops/sampling.py::bilinear_sample``, the
``grid_sample(align_corners=False)`` equivalent that every MVSNet-family warp
goes through (reference: rmvd/models/blocks/utils.py:222-268). A sample at
``x == j`` hits pixel column ``j``; the four taps are gathered from the
flattened spatial axis and blended in the JAX order (weights ``w00, w01,
w10, w11``, summed in that order).

Coordinates that are not finite, or lie beyond +-2^30, are treated as lying
far outside the image: all four taps read zero (``zeros``) and the sample
is masked out. The JAX function leaves NaN coordinates undefined (NaN out);
its fused TPU kernel (K2) maps them outside the image as here.
"""

from __future__ import annotations

import torch

_FAR = 1e9  # sentinel for non-finite coordinates, as the TPU kernel K2 uses
_LIM = float(2**30)  # clamp before the int cast: no tap moves into range


def _finite_or_far(a):
    """Replace non-finite coordinates by a point far outside any image."""
    return torch.where(torch.isfinite(a), a, torch.full_like(a, _FAR))


def bilinear_sample(img, x, y, padding_mode="zeros"):
    """Sample ``img`` bilinearly at index-space coordinates.

    Args:
        img: (B, H, W, C) feature map.
        x, y: (B, *S) sample coordinates in index space.
        padding_mode: "zeros" (out-of-image taps read 0) or "border"
            (coordinates clamped to the edge).

    Returns:
        (values, in_bounds): (B, *S, C) in the promotion of ``img``'s dtype
        and float32 (as in JAX), and a (B, *S) ``img``-dtype
        mask that is 1 where the in-image taps carry all the weight
        (sampled-ones >= 0.9999, reference: planesweep_corr.py:95-102).
    """
    B, H, W, C = img.shape
    sample_shape = x.shape[1:]
    x = _finite_or_far(x.reshape(B, -1))
    y = _finite_or_far(y.reshape(B, -1))
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"padding_mode must be 'zeros' or 'border', got {padding_mode!r}")

    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0 = x0.clamp(-_LIM, _LIM).long()
    y0 = y0.clamp(-_LIM, _LIM).long()

    flat = img.reshape(B, H * W, C)
    weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    out, ones_w = None, None
    for (dy, dx), w in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = torch.where(valid, yi * W + xi, torch.zeros_like(xi))
        tap = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        tap = tap * valid[..., None]  # zeros padding
        term = tap * w[..., None]  # promoted as in JAX: bf16 maps give f32 values
        out = term if out is None else out + term
        vw = w * valid.to(w.dtype)
        ones_w = vw if ones_w is None else ones_w + vw
    mask = (ones_w >= 0.9999).to(img.dtype)
    return out.reshape(B, *sample_shape, C), mask.reshape(B, *sample_shape)
