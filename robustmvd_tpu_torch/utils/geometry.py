"""Host-side (numpy) camera geometry helpers.

Counterpart of the JAX package's ``utils/geometry.py``: only what the
inference slice needs (pose rebasing in the CLI, relative intrinsics in the
robust_mvd input adapter).
"""

from __future__ import annotations

import numpy as np


def invert_transform(T):
    """Invert a 4x4 rigid transform: inv([R|t]) = [R^T | -R^T t].

    Works on (..., 4, 4) stacks.
    """
    T = np.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    out[..., 3, 3] = 1.0
    return out


def to_relative_intrinsics(K, width, height):
    """Convert absolute-pixel intrinsics to relative (unit-image) intrinsics.

    Divides the x-row by image width and the y-row by image height
    (reference: rmvd/models/robust_mvd.py:118-120).
    """
    K = np.asarray(K, dtype=np.float32)
    scale = np.array([[width] * 3, [height] * 3, [1.0] * 3], dtype=np.float32)
    return K / scale
