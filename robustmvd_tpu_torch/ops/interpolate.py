"""Device-side resizes: bilinear (torch semantics), bicubic x2 (JAX's) and
the losses' nearest resize of ground truth (:func:`resize_nearest_torch`).

``resize_bilinear``: half-pixel centers, no antialias, the semantics of the
reference's ``F.interpolate(mode="bilinear", align_corners=False)``
(rmvd/models/blocks/dispnet_decoder.py:88-121), which the JAX package
reproduces with ``jax.image.resize``. It also halves the CVP-MVSNet pyramid's
images.

``resize_bicubic_x2``: CVP-MVSNet's depth upsampling as the JAX package does
it (``models/cvp_mvsnet.py::_resize_bicubic_x2``, ``jax.image.resize(...,
"bicubic")``): Keys' cubic with a = -0.5, half-pixel centers, and the weights
of taps outside the image dropped and the rest renormalised.
``F.interpolate(mode="bicubic")`` (the reference's choice) uses a = -0.75 and
clamps the edge taps instead, so it is not used.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def resize_bilinear(x, size):
    """Resize (N, C, H, W) to (N, C, size[0], size[1])."""
    return F.interpolate(x, size=(int(size[0]), int(size[1])), mode="bilinear",
                         align_corners=False, antialias=False)


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5, in ``jax.image``'s op order."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


@functools.lru_cache(maxsize=32)
def _bicubic_x2_weights(in_size, device):
    """(in_size, 2 * in_size) float32 weights of ``jax.image``'s
    ``compute_weight_mat`` for a scale of 2 (no translation). Built outside
    inference mode whatever the caller's: the cached tensor serves later
    calls, and an inference tensor cannot take part in a training step."""
    with torch.inference_mode(False):
        out_size = 2 * in_size
        sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * 0.5 - 0.5
        x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None])
        weights = _keys_cubic(x)
        total = torch.sum(weights, dim=0, keepdim=True)
        eps = torch.finfo(torch.float32).eps
        weights = torch.where(torch.abs(total) > 1000.0 * eps,
                              weights / torch.where(total != 0, total, torch.ones_like(total)),
                              torch.zeros_like(weights))
        inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
        weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
        return weights.to(device)


def resize_bicubic_x2(x):
    """(B, H, W) -> (B, 2H, 2W) bicubic, ``jax.image.resize`` semantics."""
    B, H, W = x.shape
    wh = _bicubic_x2_weights(H, x.device)  # (H, 2H)
    ww = _bicubic_x2_weights(W, x.device)  # (W, 2W)
    return torch.matmul(torch.matmul(wh.t(), x), ww)


def resize_nearest_torch(x, size):
    """Nearest resize of (..., H, W) with the legacy floor rule of torch's

    ``F.interpolate(mode="nearest")``, ``src = floor(dst * in / out)``, its
    ratio and product in float32 as the JAX package's
    ``ops/interpolate.py::resize_nearest_torch`` computes them. The losses
    resample their ground truth this way (rmvd/loss/multi_scale_uni_laplace.py:92-99).
    """
    H, W = x.shape[-2:]
    out_h, out_w = int(size[0]), int(size[1])
    ys = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device) * (H / out_h)).long().clamp(0, H - 1)
    xs = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device) * (W / out_w)).long().clamp(0, W - 1)
    return x.index_select(-2, ys).index_select(-1, xs)
