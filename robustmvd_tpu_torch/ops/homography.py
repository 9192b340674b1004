"""Fronto-parallel plane-sweep warps (MVSNet and CVP-MVSNet).

Counterparts of the JAX package's ``ops/homography.py::homo_warp`` and
``rt_planesweep_warp`` (reference: rmvd/models/blocks/utils.py:222-268 and
rmvd/models/blocks/cvp_mvsnet_components.py:192-246): back-project the
integer reference pixel grid at each depth hypothesis, transform it into the
source camera and sample the source features bilinearly, with zeros
padding. The reference's quirk is kept: coordinates are normalised with the
align_corners=True formula and sampled with align_corners=False, which
amounts to ``index = x * W / (W - 1) - 0.5``.

Op order, shared with the CUDA kernel K2 (``csrc/sweep_warp.cu``):
``p = (R[:, 0] * x + R[:, 1] * y + R[:, 2]) * d + T``, then ``p / p_z``;
3x3 and 4x4 products are written out as sums, so the card and the CPU round
alike. The JAX TPU kernel forms ``M_d = d * R + T e3^T`` first; the two
orders differ by a few ulps in the coordinates. There is no mask for points
behind the camera (as in the reference); non-finite coordinates read zeros
(``ops/sampling.py``).
"""

from __future__ import annotations

import torch

from .sampling import bilinear_sample


def matmul_sums(a, b):
    """``a @ b`` over the last two axes as an explicit sum over k, in order."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def inverse(m):
    """Batched matrix inverse without the error check (which would wait for
    the card)."""
    return torch.linalg.inv_ex(m).inverse


def plane_sweep_transform(src_proj, ref_proj_inv):
    """``src_proj @ ref_proj_inv`` -> (R (..., 3, 3), T (..., 3)).

    src_proj: (B, [V,] 4, 4); ref_proj_inv: (B, 4, 4).
    """
    if src_proj.dim() == 4:
        ref_proj_inv = ref_proj_inv[:, None]
    transform = matmul_sums(src_proj.float(), ref_proj_inv.float())
    return transform[..., :3, :3], transform[..., :3, 3]


def sweep_coordinates(rot, trans, depth, H, W, Hs, Ws):
    """Index-space source coordinates of the reference grid at each depth.

    Args:
        rot: (B, 3, 3); trans: (B, 3) src-from-ref transform.
        depth: (B, D) plane depths or (B, D, H*W) per-pixel depths.
        H, W: reference grid; Hs, Ws: source map (normalisation).

    Returns:
        xi, yi: (B, D, H*W) float32.
    """
    device = rot.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    rot, trans = rot.float(), trans.float()
    d = depth.float()
    d = d[:, :, None] if d.dim() == 2 else d  # (B, D, 1) or (B, D, HW)

    def axis(i):
        r = rot[:, i, 0:1] * xs + rot[:, i, 1:2] * ys + rot[:, i, 2:3]  # (B, HW)
        return r[:, None, :] * d + trans[:, i, None, None]

    px, py, pz = axis(0), axis(1), axis(2)
    xi = px / pz * (Ws / (Ws - 1)) - 0.5
    yi = py / pz * (Hs / (Hs - 1)) - 0.5
    return xi, yi


def rt_planesweep_warp(src_feat, rot, trans, depth_hypos):
    """R,t plane-sweep warp (reference: cvp_mvsnet_components.py:192-246).

    Args:
        src_feat: (B, H, W, C).
        rot: (B, 3, 3); trans: (B, 3).
        depth_hypos: (B, D) or (B, D, H*W).

    Returns:
        (B, D, H, W, C) warped features (zeros padding); bf16 maps are
        sampled with float32 weights and give float32.
    """
    B, H, W, C = src_feat.shape
    D = depth_hypos.shape[1]
    xi, yi = sweep_coordinates(rot, trans, depth_hypos, H, W, H, W)
    warped, _ = bilinear_sample(src_feat, xi.reshape(B, -1), yi.reshape(B, -1))
    return warped.reshape(B, D, H, W, C)


def homo_warp(src_feat, src_proj, ref_proj_inv, depth_values):
    """MVSNet's plane-sweep warp (reference: blocks/utils.py:222-268).

    Args:
        src_feat: (B, Hs, Ws, C); src_proj: (B, 4, 4); ref_proj_inv: (B, 4, 4);
        depth_values: (B, D).

    Returns:
        (B, D, H, W, C) with H = Hs, W = Ws.
    """
    rot, trans = plane_sweep_transform(src_proj, ref_proj_inv)
    return rt_planesweep_warp(src_feat, rot, trans, depth_values)
