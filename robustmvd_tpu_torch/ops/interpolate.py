"""Device-side bilinear resize (the decoder's prediction upsampling).

Half-pixel centers, no antialias: the semantics of the reference's
``F.interpolate(mode="bilinear", align_corners=False)``
(rmvd/models/blocks/dispnet_decoder.py:88-121), which the JAX package
reproduces with ``jax.image.resize``.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size):
    """Resize (N, C, H, W) to (N, C, size[0], size[1])."""
    return F.interpolate(x, size=(int(size[0]), int(size[1])), mode="bilinear",
                         align_corners=False, antialias=False)
