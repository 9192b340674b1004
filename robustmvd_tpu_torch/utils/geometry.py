"""Host-side (numpy) camera geometry helpers.

Counterpart of the JAX package's ``utils/geometry.py``: pose inversion (the
inference CLI, sample preprocessing), relative intrinsics (the robust_mvd
input adapter), depth ranges and intrinsics scaling (the data layer), and
that module's other public helpers: poses rebased to the key view, the
rotation and translation of a transform, L2 normalisation.
"""

from __future__ import annotations

import numpy as np


def transform_from_rot_trans(R, t):
    """A 4x4 homogeneous transform from a 3x3 rotation and a 3-vector."""
    R = np.asarray(R, dtype=np.float32).reshape(3, 3)
    t = np.asarray(t, dtype=np.float32).reshape(3, 1)
    return np.vstack([np.hstack([R, t]), np.array([[0, 0, 0, 1]], dtype=np.float32)])


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


def compute_depth_range(depth=None, invdepth=None, clipping_quantile=0.05):
    """Robust (min, max) of a depth or inverse-depth map: the 5% and 95%

    quantiles of its valid (finite, > 0) depths; None where there is none
    (reference: rmvd/utils/utils.py:22-41)."""
    if depth is None and invdepth is None:
        return None
    if depth is None:
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = 1.0 / invdepth
    depth = np.asarray(depth)
    valid = np.isfinite(depth) & (depth > 0)
    if not np.any(valid):
        return None
    vals = depth[valid]
    return (float(np.quantile(vals, clipping_quantile)), float(np.quantile(vals, 1.0 - clipping_quantile)))


def scale_intrinsics(K, scale_x, scale_y):
    """Intrinsics of an image resized by (scale_x, scale_y): fx and cx scale

    with x, fy and cy with y (reference: rmvd/data/transforms.py:56-66)."""
    K = np.array(K, dtype=np.float32, copy=True)
    K[..., 0, 0] *= scale_x
    K[..., 0, 2] *= scale_x
    K[..., 1, 1] *= scale_y
    K[..., 1, 2] *= scale_y
    return K


def to_relative_intrinsics(K, width, height):
    """Convert absolute-pixel intrinsics to relative (unit-image) intrinsics.

    Divides the x-row by image width and the y-row by image height
    (reference: rmvd/models/robust_mvd.py:118-120).
    """
    K = np.asarray(K, dtype=np.float32)
    scale = np.array([[width] * 3, [height] * 3, [1.0] * 3], dtype=np.float32)
    return K / scale


def from_relative_intrinsics(K_rel, width, height):
    """Inverse of :func:`to_relative_intrinsics`."""
    K_rel = np.asarray(K_rel, dtype=np.float32)
    scale = np.array([[width] * 3, [height] * 3, [1.0] * 3], dtype=np.float32)
    return K_rel * scale


def rebase_poses_to_key(to_ref_transforms, keyview_idx):
    """Per-view (4, 4) transforms to a common frame -> the sample contract's

    poses: ``to_key[i] = to_ref[i] @ inv(to_ref[key])`` in the reference's
    product order (rmvd/data/dataset.py:362-367, inference.py:40-41), each
    mapping key-camera points into view i's camera; the key view's own is
    the identity. Returns a list of float32 (4, 4) arrays."""
    to_ref_transforms = [np.asarray(T, dtype=np.float32) for T in to_ref_transforms]
    ref_to_key = invert_transform(to_ref_transforms[int(keyview_idx)])
    return [T @ ref_to_key for T in to_ref_transforms]


def trans_from_transform(T):
    """Translation vector(s) of (..., 4, 4) transform(s) (reference:
    rmvd/utils/utils.py:84-85, batched: torchutils.py:64-79)."""
    return np.asarray(T)[..., 0:3, 3]


def rot_from_transform(T):
    """Rotation block(s) of (..., 4, 4) transform(s) (reference:
    rmvd/utils/utils.py:88-89, batched: torchutils.py:82-97)."""
    return np.asarray(T)[..., 0:3, 0:3]


def normalize(x, axis=None, eps=1e-9):
    """``x`` over its L2 norm along ``axis`` (all of it by default) plus

    ``eps`` (reference: rmvd/utils/utils.py:395-397)."""
    return x / (np.linalg.norm(x, axis=axis, keepdims=True) + eps)
