"""Vis-MVSNet blocks as NCHW / NCDHW ``nn.Module``s.

Counterparts of the JAX package's ``models/blocks/vis_mvsnet.py``
(reference: rmvd/models/blocks/vis_mvsnet_unet_modular.py:14-242,
vis_mvsnet_feature_extractor.py:12-29, vis_mvsnet_singlestage.py:21-348):
the residual U-Net (2D for the features, 3D for cost regularisation), the
3-scale feature extractor, the pair and fused regularisers, the uncertainty
net on the entropy map, and ``SingleStage``: per-pair cost volumes (K2's
group mode), pair regularisation and readout (K3), visibility-aware fusion
and the fused readout (K3). Submodule names are the flax names
(``enc_0.block0.bn1``, ``dec_3_deconv``, ``uncert_net.head_0``), so
``models/weights.py`` maps the JAX tree onto ``state_dict()`` one to one.

``conv3d_impl`` picks the lowering of the stride-1 3x3x3 convolutions, as
the JAX blocks take it (``ops/conv3d.py``): "banded" runs K5, "xla"
cuDNN. Each ``Reg`` runs 4 of them, ``RegPair`` 1 and
``RegFuse`` 5: 10 per stage. Every other convolution is ``nn.Conv{2,3}d`` /
``nn.ConvTranspose{2,3}d`` (cuDNN on the card; the strided 3D ones are JAX's
``Conv3dPackedS2``, the same function). BatchNorm is ``ops/layers.py``'s
(eps 1e-5): running statistics in eval, flax's batch statistics in training
(``bn_mode="batch"``). The U-Net's bottom and head layers are
empty in every Vis-MVSNet use and are not ported.

``FeatExt``, ``UNet``, ``Reg``, ``RegFuse`` and ``SingleStage`` take a
compute ``dtype`` as the JAX blocks do (``blocks/mvsnet.py``): at bf16 the
U-Nets run in bf16 (a residual or skip is cast to the branch's dtype, as
JAX casts it), while ``RegPair``, ``RegFuse``'s ``final_conv``, the
uncertainty net, the readouts and the fusion's accumulators stay float32.
``SingleStage`` takes ``warp_impl``: "fused" (K2's group mode; its float32
taps read the bf16 features widened, which is exact) or "xla"
(``get_homographies`` + ``homography_sweep`` + ``groupwise_correlation``, the
JAX route off the TPU, :430-452).

Under a mesh with a hyp axis (JAX :453-456, :543) ``SingleStage`` builds
each pair volume on the rank's slab of the hypotheses, the 3D U-Nets and
score heads run on slabs (their layers fetch their halos,
``ops/sharded3d.py``; ``BatchNorm3d`` sums its statistics over hyp too),
the score volumes are gathered over hyp before each readout (K3 sees the
whole D on every rank, and so do the uncertainty net and the window-2
mass), and the fusion, weighted per pixel, stays on the slab.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv3d import Conv3d
from ...ops.homography import get_homographies, get_homography_coeffs, homography_sweep, matmul_sums
from ...ops.kernels.soft_argmin import fused_soft_argmin
from ...ops.kernels.sweep_group_cost import homography_group_cost
from ...ops.reductions import groupwise_correlation
from ...ops import layers
from ...ops.sharded3d import gather_scores, global_depth, hypothesis_slab

GROUPS = 8  # correlation groups of the pair cost volumes
FUSION_MODES = ("soft", "hard", "average", "uwta", "maxpool")


def scale_camera(cam, scale):
    """Scale fx, cx, fy, cy in the intrinsics plane of a (B, 2, 4, 4) cam

    tensor (reference: blocks/utils.py:189-216)."""
    mult = torch.ones((4, 4), dtype=cam.dtype, device=cam.device)
    mult[0, 0] = mult[0, 2] = mult[1, 1] = mult[1, 2] = scale
    return torch.stack([cam[:, 0], cam[:, 1] * mult], dim=1)


def _conv(in_ch, out_ch, k, stride, dim, conv3d_impl="xla", dtype=torch.float32):
    if dim == 3 and k == 3 and stride == 1:
        return Conv3d(in_ch, out_ch, impl=conv3d_impl, dtype=dtype)
    cls = layers.Conv2d if dim == 2 else layers.Conv3d
    return cls(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False, dtype=dtype)


def _bn(ch, dim):
    return (layers.BatchNorm2d if dim == 2 else layers.BatchNorm3d)(ch, eps=1e-5)


def _run(layer, x, total):
    """A 2D layer on ``x`` (``total`` None), or a 3D one on the rank's slab
    of a volume of ``total`` planes."""
    return layer(x) if total is None else layer(x, total)


def torch_deconv(in_ch, out_ch, dim, dtype=torch.float32):
    """flax ``TorchDeconv``: ConvTranspose(k3, s2, p1, output_padding=1,
    bias=False), twice the input on each spatial axis."""
    cls = layers.ConvTranspose2d if dim == 2 else layers.ConvTranspose3d
    return cls(in_ch, out_ch, 3, stride=2, padding=1, output_padding=1, bias=False, dtype=dtype)


class BasicBlock(nn.Module):
    """Residual basic block (reference: vis_mvsnet_unet_modular.py:14-70),
    with a 1x1 downsampling branch where the stride or the width changes."""

    def __init__(self, in_ch, planes, stride=1, dim=2, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride, dim, conv3d_impl, dtype)
        self.bn1 = _bn(planes, dim)
        self.conv2 = _conv(planes, planes, 3, 1, dim, conv3d_impl, dtype)
        self.bn2 = _bn(planes, dim)
        if stride != 1 or in_ch != planes:
            self.downsample_conv = _conv(in_ch, planes, 1, stride, dim, dtype=dtype)
            self.downsample_bn = _bn(planes, dim)

    def forward(self, x, total=None):
        """``total``: a 3D block's input D (``_run``); None for 2D."""
        mid = self.d_out(total)
        out = self.bn2(_run(self.conv2, F.relu(self.bn1(_run(self.conv1, x, total))), mid))
        residual = (self.downsample_bn(_run(self.downsample_conv, x, total)) if hasattr(self, "downsample_conv")
                    else x)
        return F.relu(out + residual.to(out.dtype))

    def d_out(self, total):
        return None if total is None else self.conv1.d_out(total)


class ResLayer(nn.Sequential):
    """``blocks`` BasicBlocks, the first one strided (reference: _make_layer, :73-113)."""

    def __init__(self, in_ch, planes, blocks, stride=1, dim=2, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        self.add_module("block0", BasicBlock(in_ch, planes, stride, dim, conv3d_impl, dtype))
        for i in range(1, blocks):
            self.add_module(f"block{i}", BasicBlock(planes, planes, 1, dim, conv3d_impl, dtype))

    def forward(self, x, total=None):
        for block in self:
            x, total = block(x, total), block.d_out(total)
        return x

    def d_out(self, total):
        return self.block0.d_out(total)


class UNet(nn.Module):
    """Residual U-Net, 2D or 3D (reference: vis_mvsnet_unet_modular.py:115-242):
    encoder layers ``enc_i`` (the first at stride 1), then per decoder level
    a transposed conv ``dec_i_deconv``, the skip concatenation, ``dec_i_post``
    and, with ``dec`` > 0, ``dec_i_res``."""

    def __init__(self, in_ch, enc, dec, filters, dim=2, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.n_enc = len(filters)
        self.has_res = dec > 0
        ch = in_ch
        for idx, f in enumerate(filters):
            self.add_module(f"enc_{idx}", ResLayer(ch, f, enc, 1 if idx == 0 else 2, dim, conv3d_impl, dtype))
            ch = f
        self.dec_names = []
        for i, f in enumerate(filters[-2::-1]):
            idx = self.n_enc + i
            self.add_module(f"dec_{idx}_deconv", torch_deconv(ch, f, dim, dtype))
            self.add_module(f"dec_{idx}_post", _conv(f + filters[-2 - i], f, 3, 1, dim, conv3d_impl, dtype))
            if self.has_res:
                self.add_module(f"dec_{idx}_res", ResLayer(f, f, dec, 1, dim, conv3d_impl, dtype))
            self.dec_names.append(f"dec_{idx}")
            ch = f

    def forward(self, x, multi_scale=1, total=None):
        """A 3D U-Net takes the rank's slab of a volume of ``total`` planes
        under a hyp axis."""
        total = global_depth(x, total) if self.dim == 3 else None
        enc_out, totals = [], []
        for idx in range(self.n_enc):
            layer = getattr(self, f"enc_{idx}")
            x, total = layer(x, total), layer.d_out(total)
            enc_out.append(x)
            totals.append(total)
        dec_out = [x]
        for i, name in enumerate(self.dec_names):
            x = _run(getattr(self, f"{name}_deconv"), x, total)
            total = totals[-2 - i]
            x = _run(getattr(self, f"{name}_post"), torch.cat([x, enc_out[-2 - i].to(x.dtype)], dim=1), total)
            if self.has_res:
                x = getattr(self, f"{name}_res")(x, total)
            dec_out.append(x)
        return x if multi_scale == 1 else dec_out[-multi_scale:]


class FeatExt(nn.Module):
    """5x5 stride-2 conv + 2D U-Net -> three 32-channel maps at 1/8, 1/4,
    1/2 (reference: vis_mvsnet_feature_extractor.py:12-29)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.init_conv = layers.Conv2d(3, 16, 5, stride=2, padding=2, bias=False, dtype=dtype)
        self.init_bn = layers.BatchNorm2d(16, eps=1e-5)
        self.unet = UNet(16, enc=2, dec=1, filters=(32, 64, 128), dim=2, dtype=dtype)
        for i, in_ch in enumerate((128, 64, 32), 1):
            setattr(self, f"final_conv_{i}", layers.Conv2d(in_ch, 32, 3, padding=1, bias=False, dtype=dtype))

    def forward(self, x):
        out1, out2, out3 = self.unet(F.relu(self.init_bn(self.init_conv(x))), multi_scale=3)
        return self.final_conv_1(out1), self.final_conv_2(out2), self.final_conv_3(out3)


class Reg(nn.Module):
    """The pair regulariser: a 3D U-Net 8/16 over the cost volume
    (reference: vis_mvsnet_singlestage.py:21-29)."""

    def __init__(self, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        self.unet = UNet(GROUPS, enc=1, dec=0, filters=(8, 16), dim=3, conv3d_impl=conv3d_impl, dtype=dtype)

    def forward(self, x, total=None):
        return self.unet(x, total=total)


class RegPair(nn.Module):
    """8 -> 1 score head of a pair, float32 (JAX :273-279)."""

    def __init__(self, conv3d_impl="xla"):
        super().__init__()
        self.final_conv = Conv3d(8, 1, impl=conv3d_impl)

    def forward(self, x, total=None):
        return self.final_conv(x, total)


class RegFuse(nn.Module):
    """The fused regulariser: 3D U-Net 8/16 at ``dtype`` + 8 -> 1 score head
    in float32 (JAX :282-296)."""

    def __init__(self, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        self.unet = UNet(8, enc=1, dec=0, filters=(8, 16), dim=3, conv3d_impl=conv3d_impl, dtype=dtype)
        self.final_conv = Conv3d(8, 1, impl=conv3d_impl)

    def forward(self, x, total=None):
        return self.final_conv(self.unet(x, total=total), global_depth(x, total))


class UncertNet(nn.Module):
    """Uncertainty heads on the entropy map (reference:
    vis_mvsnet_singlestage.py:57-76)."""

    def __init__(self):
        super().__init__()
        self.conv1_conv = nn.Conv2d(1, 8, 3, padding=1, bias=False)
        self.conv1_bn = layers.BatchNorm2d(8, eps=1e-5)
        self.conv2_conv = nn.Conv2d(8, 8, 3, padding=1, bias=False)
        self.conv2_bn = layers.BatchNorm2d(8, eps=1e-5)
        self.head_0 = nn.Conv2d(8, 1, 3, padding=1, bias=False)
        self.head_1 = nn.Conv2d(8, 1, 3, padding=1, bias=False)

    def forward(self, x):
        out = F.relu(self.conv1_bn(self.conv1_conv(x)))
        out = F.relu(self.conv2_bn(self.conv2_conv(out))) + x
        return [self.head_0(out), self.head_1(out)]


PIXEL_CENTRES = ((1.0, 0.0, 0.5), (0.0, 1.0, 0.5), (0.0, 0.0, 1.0))



class SingleStage(nn.Module):
    """One cascade stage (reference: vis_mvsnet_singlestage.py:79-348)."""

    def __init__(self, conv3d_impl="xla", dtype=torch.float32, warp_impl="fused"):
        super().__init__()
        self.warp_impl = warp_impl
        self.reg = Reg(conv3d_impl, dtype)
        self.reg_pair = RegPair(conv3d_impl)
        self.reg_fuse = RegFuse(conv3d_impl, dtype)
        self.uncert_net = UncertNet()

    def _regularise(self, cost, depth_num):
        """A (N, D, h, w, 8) pair volume (under a hyp axis the rank's slab of
        ``depth_num`` planes) -> (regularised (N, 8, D or the slab's, h, w),
        expected index (N, 1, h, w), uncertainty heads [(N, 1, h, w)])."""
        interm = self.reg(cost.permute(0, 4, 1, 2, 3).contiguous(), depth_num)
        _, index, ent, _ = fused_soft_argmin(gather_scores(self.reg_pair(interm, depth_num)[:, 0], depth_num))
        return interm, index, self.uncert_net(ent)

    def forward(self, ref_feat, ref_cam, srcs_feat, srcs_cam, depth_num, mode="soft", depth_start=None,
                depth_interval=None, s_scale=1, src_valid=None, train=False):
        """ref_feat (B, h, w, C) and srcs_feat [(B, h, w, C)] channel-last,
        float32 or bf16; cams (B, 2, 4, 4); depth_start / depth_interval
        (B, 1, 1, 1) or (B, 1, h, w) (default: the key cam's); src_valid
        [(B,)] 0/1 per source view (default: all); ``train``: BatchNorm on
        batch statistics, so the pairs are regularised one at a time. The
        fused route writes the pair volumes in the features' dtype (JAX
        :426-428), the "xla" route in float32.

        Returns (est_depth (B, 1, h, w), prob_map (B, 1, h, w), pair_results
        [[est_depth, [uncertainty heads (B, 1, h, w)]] per source view])."""
        if mode not in FUSION_MODES:
            raise ValueError(f"mode must be one of {FUSION_MODES}, got {mode!r}")
        B, h, w, _ = ref_feat.shape
        P = len(srcs_feat)
        if depth_start is None:
            depth_start = ref_cam[:, 1:2, 3:4, 0:1]
        if depth_interval is None:
            depth_interval = ref_cam[:, 1:2, 3:4, 1:2]
        if src_valid is None:
            src_valid = [torch.ones(B, device=ref_feat.device)] * P

        # phase 1: per-pair cost volumes, on the rank's slab of the hypotheses under a hyp axis
        lo, hi = hypothesis_slab(depth_num)
        ref_cam_s = scale_camera(ref_cam, 1 / s_scale)
        costs = []
        if self.warp_impl == "xla":  # the homographies H(d) per hypothesis, a warp and the group sums
            for src_feat, src_cam in zip(srcs_feat, srcs_cam):
                Hs = get_homographies(ref_cam_s, scale_camera(src_cam, 1 / s_scale), depth_num, depth_start,
                                      depth_interval)[:, lo:hi]
                costs.append(groupwise_correlation(ref_feat[:, None], homography_sweep(src_feat, Hs), GROUPS, -1))
        else:  # K2 group mode, H = A + B / (d + 1e-9)
            d_idx = torch.arange(lo, hi, dtype=torch.float32, device=ref_feat.device).reshape(1, hi - lo, 1, 1)
            w_dense = (1.0 / (depth_start + depth_interval * d_idx + 1e-9)).expand(B, hi - lo, h, w).contiguous()
            centres = torch.tensor(PIXEL_CENTRES, device=ref_feat.device)
            for src_feat, src_cam in zip(srcs_feat, srcs_cam):
                A, Bm = get_homography_coeffs(ref_cam_s, scale_camera(src_cam, 1 / s_scale))
                costs.append(homography_group_cost(ref_feat, src_feat, matmul_sums(A, centres),
                                                   matmul_sums(Bm, centres), w_dense, groups=GROUPS,
                                                   out_dtype=ref_feat.dtype))

        # phase 2: pair regularisation and readout; in training each pair on
        # its own, so that BatchNorm sees each pair's statistics and moves its
        # running statistics once per pair (JAX :483-497); else the P pairs
        # through the shared regularisers in one batch
        if train:
            pairs = [self._regularise(cost, depth_num) for cost in costs]
        else:
            interm, index, heads = self._regularise(torch.cat(costs, dim=0), depth_num)
            pairs = [(interm[p * B:(p + 1) * B], index[p * B:(p + 1) * B], [hd[p * B:(p + 1) * B] for hd in heads])
                     for p in range(P)]

        # phase 3: visibility-aware fusion, float32 accumulators (JAX :389-390), on the slab: per-pixel weights
        fused = torch.zeros(pairs[0][0].shape, device=ref_feat.device)
        weight_sum = torch.zeros((B, 1, 1, h, w), device=ref_feat.device)
        min_weight = None
        pair_results = []
        for p, (interm, index, pair_heads) in enumerate(pairs):
            valid = src_valid[p].float().reshape(B, 1, 1, 1, 1)
            pair_results.append([index * depth_interval + depth_start, pair_heads])
            x, h0 = interm.float(), pair_heads[0][:, :, None]  # (B, 1, 1, h, w)
            if mode == "soft":
                weight = torch.exp(-h0) * valid
                weight_sum = weight_sum + weight
                fused = fused + x * weight
            elif mode == "hard":
                weight = ((h0 < 0).float() + 1e-4) * valid
                weight_sum = weight_sum + weight
                fused = fused + x * weight
            elif mode == "average":
                fused = fused + x * valid
            elif mode == "uwta":
                if min_weight is None:
                    min_weight, mask = h0, torch.ones_like(h0)
                else:
                    mask = (h0 < min_weight).float()
                    min_weight = h0 * mask + min_weight * (1 - mask)
                fused = x * mask + fused * (1 - mask)
            else:  # maxpool
                fused = fused + x if p == 0 else torch.maximum(fused, x)
        if mode in ("soft", "hard"):
            fused = fused / weight_sum
        elif mode == "average":
            fused = fused / sum(v.float().reshape(B, 1, 1, 1, 1) for v in src_valid)

        _, index, _, prob_map = fused_soft_argmin(gather_scores(self.reg_fuse(fused, depth_num)[:, 0], depth_num),
                                                  window=2)
        return index * depth_interval + depth_start, prob_map, pair_results
