"""Fronto-parallel plane-sweep warps (MVSNet, CVP-MVSNet and Vis-MVSNet).

Counterparts of the JAX package's ``ops/homography.py::homo_warp`` and
``rt_planesweep_warp`` (reference: rmvd/models/blocks/utils.py:222-268 and
rmvd/models/blocks/cvp_mvsnet_components.py:192-246): back-project the
integer reference pixel grid at each depth hypothesis, transform it into the
source camera and sample the source features bilinearly, with zeros
padding. The reference's quirk is kept: coordinates are normalised with the
align_corners=True formula and sampled with align_corners=False, which
amounts to ``index = x * W / (W - 1) - 0.5``.

Op order, shared with the CUDA kernels K2 (``csrc/sweep_warp.cu``) and K4
(``csrc/warp_volume.cu``, the materialised ``homo_warp`` volume):
``p = (R[:, 0] * x + R[:, 1] * y + R[:, 2]) * d + T``, then ``p / p_z``;
3x3 and 4x4 products are written out as sums, so the card and the CPU round
alike. The JAX TPU kernel forms ``M_d = d * R + T e3^T`` first; the two
orders differ by a few ulps in the coordinates. There is no mask for points
behind the camera (as in the reference); non-finite coordinates read zeros
(``ops/sampling.py``).

Vis-MVSNet's per-pair homographies (reference: rmvd/models/blocks/
utils.py:95-186, the JAX package's ``get_homographies``,
``get_homography_coeffs`` and ``homography_warping``): ``H(d) = A + B / (d +
1e-9)`` maps pixel centres (x + 0.5, y + 0.5) of the key view into the
source view. ``homography_warping`` clamps the normalised coordinates to
+-1.1 as rmvd's ``interpolate`` does; the fused kernel route
(``ops/kernels/sweep_group_cost.py``) has no clamp, as the JAX TPU kernel.
The two differ only where a clamped coordinate still reaches the map,
which needs a map narrower than about 10 px.

bf16 features: every grid and coordinate here is float32 and the samples
are float32, as in K2 and K4. The JAX XLA routes build their pixel grids in
the features' dtype (``homo_warp``, ``rt_planesweep_warp``,
``homography_warping``), which a bf16 map rounds: integers beyond 256 and
pixel centres beyond 127.5. The port keeps the float32 grid; the two agree
on maps up to those widths.
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
    """MVSNet's plane-sweep warp (reference: blocks/utils.py:222-268); the
    plain version of K4 (``ops/kernels/warp_volume.py``).

    Args:
        src_feat: (B, Hs, Ws, C); src_proj: (B, 4, 4); ref_proj_inv: (B, 4, 4);
        depth_values: (B, D).

    Returns:
        (B, D, H, W, C) with H = Hs, W = Ws.
    """
    rot, trans = plane_sweep_transform(src_proj, ref_proj_inv)
    return rt_planesweep_warp(src_feat, rot, trans, depth_values)


def _cam_parts(cam):
    """(B, 2, 4, 4) cam tensor -> R, t (B, 3, 1), K."""
    return cam[:, 0, :3, :3].float(), cam[:, 0, :3, 3:4].float(), cam[:, 1, :3, :3].float()


def get_homographies(left_cam, right_cam, depth_num, depth_start, depth_interval):
    """Per-depth homographies from the key (left) to a source (right) cam.

    Args:
        left_cam, right_cam: (B, 2, 4, 4) cam tensors: [0] the pose, [1] the
            intrinsics in the top-left 3x3.
        depth_num: D.
        depth_start, depth_interval: (B, 1, 1, 1) or (B, 1, H, W).

    Returns:
        (B, D, H', W', 3, 3), H' = W' = 1 for scalar depth_start.
    """
    R_l, t_l, K_l = _cam_parts(left_cam)
    R_r, t_r, K_r = _cam_parts(right_cam)
    d_idx = torch.arange(depth_num, dtype=torch.float32, device=left_cam.device).reshape(1, depth_num, 1, 1)
    depth = (depth_start + depth_interval * d_idx)[..., None, None]  # (B, D, H', W', 1, 1)
    R_lT, R_rT = R_l.transpose(-2, -1), R_r.transpose(-2, -1)
    fronto = R_l[:, 2:3, :3]  # (B, 1, 3)
    c_rel = -matmul_sums(R_rT, t_r) + matmul_sums(R_lT, t_l)  # c_right - c_left
    temp = matmul_sums(c_rel, fronto)[:, None, None, None]  # (B, 1, 1, 1, 3, 3)
    eye = torch.eye(3, dtype=torch.float32, device=left_cam.device).reshape(1, 1, 1, 1, 3, 3)
    middle = matmul_sums(eye - temp / (depth + 1e-9), matmul_sums(R_lT, torch.linalg.inv(K_l))[:, None, None, None])
    return matmul_sums(matmul_sums(K_r, R_r)[:, None, None, None], middle)


def get_homography_coeffs(left_cam, right_cam):
    """``get_homographies`` as ``H(d) = A + B / (d + 1e-9)``, with
    A = K_r R_r R_l^T K_l^-1 and B = -K_r R_r (c_rel fronto^T) R_l^T K_l^-1.

    Returns (A, B): (B, 3, 3) float32 each.
    """
    R_l, t_l, K_l = _cam_parts(left_cam)
    R_r, t_r, K_r = _cam_parts(right_cam)
    R_lT, R_rT = R_l.transpose(-2, -1), R_r.transpose(-2, -1)
    c_rel = -matmul_sums(R_rT, t_r) + matmul_sums(R_lT, t_l)
    KrRr = matmul_sums(K_r, R_r)
    RlTKli = matmul_sums(R_lT, torch.linalg.inv(K_l))
    A = matmul_sums(KrRr, RlTKli)
    Bm = -matmul_sums(KrRr, matmul_sums(matmul_sums(c_rel, R_l[:, 2:3, :3]), RlTKli))
    return A, Bm


def _homography_indices(Hb, Hh, Ww):
    """Index-space source coordinates of the (Hh, Ww) pixel centres under
    homographies Hb (..., 1 | Hh, 1 | Ww, 3, 3): the float32 pixel-centre
    grid, ``/ (p_z + 1e-9)``, normalised and clamped to +-1.1, then
    align_corners=False. Returns xi, yi (..., Hh, Ww)."""
    ys, xs = torch.meshgrid(torch.arange(Hh, dtype=torch.float32, device=Hb.device) + 0.5,
                            torch.arange(Ww, dtype=torch.float32, device=Hb.device) + 0.5, indexing="ij")
    warped = Hb[..., :, 0] * xs[..., None] + Hb[..., :, 1] * ys[..., None] + Hb[..., :, 2]
    wx = warped[..., 0] / (warped[..., 2] + 1e-9)
    wy = warped[..., 1] / (warped[..., 2] + 1e-9)
    gx = torch.clamp((wx / Ww) * 2 - 1, -1.1, 1.1)
    gy = torch.clamp((wy / Hh) * 2 - 1, -1.1, 1.1)
    return ((gx + 1) * Ww - 1) / 2, ((gy + 1) * Hh - 1) / 2


def homography_warping(feat, H_mat):
    """Warp (B, H, W, C) features by 3x3 homographies of pixel centres.

    H_mat: (B, 3, 3) or (B, H, W, 3, 3). :func:`homography_sweep` of a
    single hypothesis (reference: blocks/utils.py:154-186).
    """
    Hb = H_mat[:, None, None] if H_mat.dim() == 3 else H_mat  # (B, 1|H, 1|W, 3, 3)
    return homography_sweep(feat, Hb[:, None])[:, 0]


def homography_sweep(feat, Hs):
    """Warp one source map under each hypothesis's homography, as the JAX
    Vis-MVSNet route computes it with the map repeated D times
    (``blocks/vis_mvsnet.py:430-447``), without the repeat.

    Warped coordinates are divided by the map size, scaled to [-1, 1],
    clamped to +-1.1, and sampled with align_corners=False semantics and
    zeros padding. The pixel-centre grid is float32 whatever the features'
    dtype: the JAX function builds it in the features' dtype, and a bf16
    grid rounds centres beyond 127.5 (128.5 is 128 in bf16).

    feat: (B, H, W, C); Hs: (B, D, 1 | H, 1 | W, 3, 3) (``get_homographies``).
    Returns (B, D, H, W, C), float32 for float32 or bf16 maps.
    """
    B, Hh, Ww, C = feat.shape
    D = Hs.shape[1]
    xi, yi = _homography_indices(Hs, Hh, Ww)
    out, _ = bilinear_sample(feat, xi.reshape(B, -1), yi.reshape(B, -1))
    return out.reshape(B, D, Hh, Ww, C)
