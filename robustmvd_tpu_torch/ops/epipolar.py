"""Closed-form epipolar plane-sweep geometry, in torch.

Projecting a key-view pixel ``(x, y)`` at inverse depth ``d`` into a source
view is a rational-linear function of ``d``:

    [u_h, v_h, k_h]^T = P @ [x, y, 1]^T + d * q,
    u = u_h / k_h,  v = v_h / k_h,

with ``P = K_src @ R @ K_key^{-1}`` and ``q = K_src @ t`` where ``[R|t]`` maps
key-camera points into the source camera frame (reference:
rmvd/models/blocks/planesweep_corr.py:228-349). Intrinsics are relative and
scaled to the feature map here; pixel centers sit at ``i + 0.5``.

All coordinate math is float32 with true division, in the same operation
order as the JAX package's ``ops/epipolar.py``: a reciprocal-multiply or a
reordered sum moves coordinates by an ulp, which is enough to flip
``floor()`` and the in-bounds mask on exact pixel boundaries. The 3x3
products are written out as sums over k so that they round the same way on
every device (a library matmul may sum in another order on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EpipolarCoeffs(NamedTuple):
    """Per-view epipolar coefficients.

    uvk_inf: (B, H, W, 3) homogeneous coords at infinite depth (d=0);
        last axis (u_h, v_h, k_h).
    m: (B, 3) depth slope ``q = K_src @ t``; last axis (m_u, m_v, m_k).
    """

    uvk_inf: torch.Tensor
    m: torch.Tensor


def _mm3(a, b):
    """(B, 3, 3) @ (B, 3, N) as an explicit sum over k = 0, 1, 2."""
    return (a[:, :, 0:1] * b[:, 0:1, :] + a[:, :, 1:2] * b[:, 1:2, :]) + a[:, :, 2:3] * b[:, 2:3, :]


def make_epipolar_coeffs(
    intrinsics_key,
    intrinsics_source,
    key_to_source_transform,
    height,
    width,
    height_source=None,
    width_source=None,
):
    """Epipolar coefficients for one source view.

    Args:
        intrinsics_key, intrinsics_source: (B, 3, 3) relative intrinsics.
        key_to_source_transform: (B, 4, 4) transform taking key-camera points
            into the source camera frame.
        height, width: key feature-map resolution.
        height_source, width_source: source feature-map resolution (default:
            the key resolution).

    Returns:
        EpipolarCoeffs with uvk_inf (B, H, W, 3) and m (B, 3).
    """
    if height_source is None:
        height_source = height
    if width_source is None:
        width_source = width
    dtype, device = intrinsics_key.dtype, intrinsics_key.device

    def absolute(K_rel, w, h):
        scale = torch.tensor([[w, w, w], [h, h, h], [1.0, 1.0, 1.0]], dtype=dtype, device=device)
        return K_rel * scale

    K_key = absolute(intrinsics_key, width, height)
    K_src = absolute(intrinsics_source, width_source, height_source)
    R = key_to_source_transform[:, :3, :3]
    t = key_to_source_transform[:, :3, 3:]

    # closed-form inverse of the upper-triangular pinhole K (no skew)
    fx, fy = K_key[:, 0, 0], K_key[:, 1, 1]
    cx, cy = K_key[:, 0, 2], K_key[:, 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    K_key_inv = torch.stack(
        [
            torch.stack([1.0 / fx, zeros, -cx / fx], dim=-1),
            torch.stack([zeros, 1.0 / fy, -cy / fy], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )

    P = _mm3(_mm3(K_src, R), K_key_inv)  # (B, 3, 3)
    q = _mm3(K_src, t)[:, :, 0]  # (B, 3)

    ys = torch.arange(height, dtype=dtype, device=device) + 0.5
    xs = torch.arange(width, dtype=dtype, device=device) + 0.5
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, height * width)
    pix = pix.expand(P.shape[0], 3, height * width)
    uvk_inf = _mm3(P, pix).transpose(1, 2).reshape(-1, height, width, 3)
    return EpipolarCoeffs(uvk_inf=uvk_inf, m=q)


def sampling_invdepths(min_depth, max_depth, num_samples, sampling_type="linear_invdepth", device=None):
    """Inverse-depth hypotheses, shape (B, S), float32.

    ``linear_invdepth`` spaces hypotheses linearly from 1/max_depth to
    1/min_depth; ``linear_depth`` spaces depths linearly and returns the
    inverse depths in ascending order (reference:
    planesweep_corr.py:524-555 `compute_sampling_invdepths`).
    """
    f32 = torch.float32
    min_depth = torch.atleast_1d(torch.as_tensor(min_depth, dtype=f32, device=device))[..., None]
    max_depth = torch.atleast_1d(torch.as_tensor(max_depth, dtype=f32, device=device))[..., None]
    steps = torch.arange(num_samples, dtype=f32, device=min_depth.device)[None, :]

    if sampling_type == "linear_invdepth":
        min_inv = 1.0 / max_depth
        max_inv = 1.0 / min_depth
        return min_inv + steps * (max_inv - min_inv) / (num_samples - 1)
    if sampling_type == "linear_depth":
        depths = min_depth + steps * (max_depth - min_depth) / (num_samples - 1)
        return torch.flip(1.0 / depths, dims=[-1])
    raise ValueError(f"unknown sampling_type: {sampling_type}")


def _replace_nonfinite(a):
    """+-inf -> +-1e9 and NaN -> 1e9 (reference: planesweep_corr.py:333-349)."""
    a = torch.where(torch.isinf(a), 1e9 * torch.sign(a), a)
    return torch.where(torch.isnan(a), torch.full_like(a, 1e9), a)


def planesweep_points(coeffs: EpipolarCoeffs, invdepths):
    """Per-hypothesis sampling locations and visibility mask.

    Args:
        coeffs: per-view epipolar coefficients.
        invdepths: (B, S) or (B, S, H, W) inverse-depth hypotheses.

    Returns:
        us, vs: (B, S, H, W) source-view sampling coordinates in pixel-center
            convention, non-finite values replaced by +-1e9.
        mask: (B, S, H, W) bool visibility: in front of both cameras
            (reference: planesweep_corr.py:499-506).
    """
    uvk_inf, m = coeffs.uvk_inf, coeffs.m
    ds = invdepths[:, :, None, None] if invdepths.ndim == 2 else invdepths

    u_inf = uvk_inf[..., 0][:, None]  # (B, 1, H, W)
    v_inf = uvk_inf[..., 1][:, None]
    k_inf = uvk_inf[..., 2][:, None]
    m_u = m[:, 0][:, None, None, None]  # (B, 1, 1, 1)
    m_v = m[:, 1][:, None, None, None]
    m_k = m[:, 2][:, None, None, None]

    denom = k_inf + m_k * ds  # (B, S, H, W)
    us = _replace_nonfinite((u_inf + m_u * ds) / denom)
    vs = _replace_nonfinite((v_inf + m_v * ds) / denom)

    # For z = 1/d > 0, sign(k_inf + m_k*d) == sign(k_inf*z + m_k).
    zs = 1.0 / ds
    mask = (zs > 0) & ((k_inf * zs + m_k) > 0)
    return us, vs, torch.broadcast_to(mask, us.shape)
