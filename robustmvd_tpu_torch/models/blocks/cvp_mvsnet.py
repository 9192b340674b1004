"""CVP-MVSNet blocks and geometry, NCHW / NCDHW.

Counterparts of the JAX package's ``models/blocks/cvp_mvsnet.py``
(reference: rmvd/models/blocks/cvp_mvsnet_components.py): the feature
pyramid (:40-83), the 3D CostRegNet (:85-128), per-scale intrinsics
(:144-159), the uniform coarse hypotheses (:162-189), the epipolar
local-refinement hypotheses (:248-373) and the variance cost volume with
per-pixel hypotheses (:375-456, K2's dense mode). Submodule names are the
flax names (``conv0aa``, ``conv5_deconv``, ``conv5_bn``, ``prob0``).

Small matrix products are written out as sums (``matmul_sums``) so that
the card and the CPU round alike; divisions by constants go through tensors,
so that none becomes a reciprocal multiply on the card.

``FeaturePyramid`` and ``CostRegNet`` take a compute ``dtype`` as the JAX
blocks do (``blocks/mvsnet.py``); ``prob0`` is float32.
``proj_cost_volume`` takes the model's ``warp_impl``: "fused" (K2's dense
mode) or "xla" (``rt_planesweep_warp`` per source view and float32 running
sums, JAX's ``impl="xla"``). Under a mesh with a hyp axis it is given the
rank's slab of the hypotheses, and ``CostRegNet`` runs on the rank's slab
of the volume (``blocks/mvsnet.py``, ``ops/sharded3d.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv3d import Conv3d
from ...ops.homography import inverse, matmul_sums, rt_planesweep_warp
from ...ops.interpolate import resize_bilinear
from ...ops.kernels.sweep_warp import warp_variance_dense
from ...ops.reductions import variance_over_views
from ...ops import layers
from ...ops.sharded3d import global_depth
from .mvsnet import ConvBnReLU3D

_PYRAMID = (("conv0aa", 64), ("conv0ba", 64), ("conv0bb", 64), ("conv0bc", 32), ("conv0bd", 32),
            ("conv0be", 32), ("conv0bf", 16), ("conv0bg", 16), ("conv0bh", 16))


class FeaturePyramid(nn.Module):
    """One conv stack (3x3 + LeakyReLU 0.1, 3 -> 16 channels) applied to the

    image at ``scales`` scales, each half the previous (bilinear). Returns
    the features from full resolution to coarsest."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        in_ch = 3
        for name, out_ch in _PYRAMID:
            setattr(self, name, layers.Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype))
            in_ch = out_ch

    def _run(self, x):
        for name, _ in _PYRAMID:
            x = F.leaky_relu(getattr(self, name)(x), 0.1)
        return x

    def forward(self, img, scales=5):
        fp = [self._run(img)]
        for _ in range(scales - 1):
            img = resize_bilinear(img, (img.shape[2] // 2, img.shape[3] // 2))
            fp.append(self._run(img))
        return fp


class CostRegNet(nn.Module):
    """3D U-Net over a (B, 16, D, h, w) volume -> (B, D, h, w) logits;
    ``conv3d_impl`` applies to its seven stride-1 convolutions and ``prob0``
    (JAX :124-157): with "banded" K5 runs 8 times per call (7 at ``dtype``,
    ``prob0`` at float32)."""

    def __init__(self, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        impl, dt = conv3d_impl, dtype
        for name, in_ch, out_ch in (("conv0", 16, 16), ("conv0a", 16, 16)):
            setattr(self, name, ConvBnReLU3D(in_ch, out_ch, conv3d_impl=impl, dtype=dt))
        self.conv1 = ConvBnReLU3D(16, 32, stride=2, dtype=dt)
        for name, in_ch, out_ch in (("conv2", 32, 32), ("conv2a", 32, 32), ("conv3", 32, 64), ("conv4", 64, 64),
                                    ("conv4a", 64, 64)):
            setattr(self, name, ConvBnReLU3D(in_ch, out_ch, conv3d_impl=impl, dtype=dt))
        self.conv5_deconv = layers.ConvTranspose3d(64, 32, 3, stride=1, padding=1, bias=False, dtype=dt)
        self.conv5_bn = layers.BatchNorm3d(32, eps=1e-5)
        self.conv6_deconv = layers.ConvTranspose3d(32, 16, 3, stride=2, padding=1, output_padding=1, bias=False,
                                                   dtype=dt)
        self.conv6_bn = layers.BatchNorm3d(16, eps=1e-5)
        self.prob0 = Conv3d(16, 1, bias=True, impl=impl)  # float32 (JAX :156)

    def forward(self, x, total=None):
        """x (B, 16, D, h, w), or the rank's slab of a volume of ``total``
        planes under a hyp axis: logits (B, D or the slab's, h, w)."""
        d0 = global_depth(x, total)
        d1 = self.conv1.d_out(d0)
        conv0 = self.conv0a(self.conv0(x, d0), d0)
        conv2 = self.conv2a(self.conv2(self.conv1(conv0, d0), d1), d1)
        conv4 = self.conv4a(self.conv4(self.conv3(conv2, d1), d1), d1)
        conv5 = conv2 + F.relu(self.conv5_bn(self.conv5_deconv(conv4, d1)))
        conv6 = conv0 + F.relu(self.conv6_bn(self.conv6_deconv(conv5, d1)))
        return self.prob0(conv6, d0)[:, 0]


def condition_intrinsics(intrinsics, img_hw, fp_shapes_hw):
    """Per-scale intrinsics (reference: :144-159): rows 0 and 1 divided by

    each level's ratio. intrinsics (B, 3, 3) -> (B, S, 3, 3)."""
    outs = []
    for fh, _ in fp_shapes_hw:
        ratio = img_hw[0] / fh
        factor = torch.tensor([[1 / ratio], [1 / ratio], [1.0]], dtype=intrinsics.dtype, device=intrinsics.device)
        outs.append(intrinsics * factor)
    return torch.stack(outs, dim=1)


def cal_sweeping_depth_hypos(depth_min, depth_max, nhypothesis_init=48):
    """Uniform hypotheses over the FIRST sample's range, endpoints included

    (reference: :162-189). Returns (B, n)."""
    B = depth_min.shape[0]
    lo, hi = depth_min.reshape(-1)[0], depth_max.reshape(-1)[0]
    step = (hi - lo) / torch.tensor(nhypothesis_init - 1.0, device=lo.device)
    hypos = lo + step * torch.arange(nhypothesis_init, dtype=torch.float32, device=lo.device)
    return hypos[None].expand(B, -1)


def proj_mat(K, ex):
    """[K @ ex[:3, :]; 0 0 0 1]: (B, 3, 3), (B, 4, 4) -> (B, 4, 4)."""
    top = matmul_sums(K, ex[:, :3, :])
    bottom = torch.zeros_like(top[:, :1, :])
    bottom[:, 0, 3] = 1.0
    return torch.cat([top, bottom], dim=1)


def src_from_ref(K_src, ex_src, ref_proj_inv):
    """(R, t) of ``proj_mat(K_src, ex_src) @ ref_proj_inv``."""
    p = matmul_sums(proj_mat(K_src, ex_src), ref_proj_inv)
    return p[:, :3, :3], p[:, :3, 3]


def cal_depth_hypo_interval(ref_depths, ref_K, src_K, ref_ex, src_ex):
    """Mean one-pixel depth interval along the epipolar line, per batch

    (reference: :248-373, "test" branch), in float32 like the JAX package
    (rmvd computes it in float64), in the JAX order: the pixel list runs x
    first (meshgrid over (W, H), "ij"), depths flattened transposed; the 2x2
    solve is the closed-form Cramer rule. Where the projected points of
    depths d and d+1 coincide, arctan(0/0) makes the interval NaN, as in
    JAX. ref_depths (B, H, W); K (B, 3, 3); ex (B, 4, 4). Returns (B,)."""
    B, H, W = ref_depths.shape
    dev = ref_depths.device
    xx, yy = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                            torch.arange(H, dtype=torch.float32, device=dev), indexing="ij")
    ones = torch.ones(H * W, dtype=torch.float32, device=dev)
    X = torch.stack([xx.reshape(-1), yy.reshape(-1), ones])[None]  # (1, 3, P)
    D1 = ref_depths.transpose(1, 2).reshape(B, 1, -1)
    D2 = D1 + 1

    rK_inv, rE_inv = inverse(ref_K), inverse(ref_ex)
    ones4 = ones[None, None].expand(B, 1, H * W)

    def project(depth):
        ray = matmul_sums(rK_inv, X * depth)
        pts = matmul_sums(rE_inv, torch.cat([ray, ones4], dim=1))
        return matmul_sums(src_K, matmul_sums(src_ex, pts)[:, :3])

    X1 = project(D1)
    X1_d = X1[:, 2]
    X1 = X1 / X1_d[:, None]
    X2 = project(D2)
    X2 = X2 / X2[:, 2:3]

    k = (X2[:, 1] - X1[:, 1]) / (X2[:, 0] - X1[:, 0])
    theta = torch.arctan(k)
    X3 = X1 + torch.stack([torch.cos(theta), torch.sin(theta), torch.zeros_like(theta)], dim=1)

    A = matmul_sums(matmul_sums(ref_K, ref_ex[:, :3, :3]), inverse(matmul_sums(src_K, src_ex[:, :3, :3])))
    tmp1 = X1_d[:, None] * matmul_sums(A, X1)
    tmp2 = matmul_sums(A, X3)

    a, c = X[:, 1], X[:, 2]
    b, d = tmp2[:, 1], tmp2[:, 2]
    e, f = tmp1[:, 1], tmp1[:, 2]
    det = a * d - b * c
    delta_d = (e * d - b * f) / det
    return torch.mean(torch.abs(delta_d), dim=1)


def cal_depth_hypos(ref_depths, ref_K, src_K, ref_ex, src_ex, mode="test", d=4, train_interval=6.8085):
    """2d hypotheses around the upsampled depth (reference: :248-373), spaced
    by the epipolar interval (``mode="test"``) or, in training, by the
    constant ``train_interval``. Returns (B, 2d, H, W)."""
    levels = torch.arange(-d, d, dtype=torch.float32, device=ref_depths.device)
    if mode == "train":
        interval = torch.full((ref_depths.shape[0],), train_interval, dtype=torch.float32, device=ref_depths.device)
    elif mode == "test":
        interval = cal_depth_hypo_interval(ref_depths, ref_K, src_K, ref_ex, src_ex)
    else:
        raise ValueError(f"mode must be 'test' or 'train', got {mode!r}")
    return ref_depths[:, None] + levels[None, :, None, None] * interval[:, None, None, None]


def proj_cost_volume(ref_feature, src_features, ref_K, src_Ks, ref_ex, src_exs, depth_hypos, warp_impl="fused",
                     out_dtype=torch.float32):
    """Variance volume over views with per-pixel hypotheses (reference:

    :375-456). ref_feature (B, H, W, C); src_features (B, V, H, W, C);
    src_Ks (B, V, 3, 3); src_exs (B, V, 4, 4); depth_hypos (B, D, H, W).
    ``warp_impl`` "fused": K2's dense mode, writing ``out_dtype``; "xla":
    ``rt_planesweep_warp`` per view and float32 running sums, float32.
    Returns (B, D, H, W, C)."""
    ref_proj_inv = inverse(proj_mat(ref_K, ref_ex))
    rts = [src_from_ref(src_Ks[:, i], src_exs[:, i], ref_proj_inv) for i in range(src_features.shape[1])]
    if warp_impl == "xla":
        B, D, H, W = depth_hypos.shape
        hypos = depth_hypos.reshape(B, D, H * W)
        warped = (rt_planesweep_warp(src_features[:, i], r, t, hypos) for i, (r, t) in enumerate(rts))
        return variance_over_views(ref_feature, warped, D)
    rot = torch.stack([r for r, _ in rts], dim=1)
    trans = torch.stack([t for _, t in rts], dim=1)
    return warp_variance_dense(ref_feature, src_features, rot, trans, depth_hypos, out_dtype=out_dtype)
