"""vis_mvsnet — Vis-MVSNet, 3-stage cascaded MVS with visibility-aware
fusion, in PyTorch.

Reference model: rmvd/models/vis_mvsnet.py:25-242, through the JAX package's
``models/vis_mvsnet.py``. Cam tensors (B, 2, 4, 4) carry the pose, the
intrinsics and the depth start, interval, step count and maximum (:50-62);
one FeatExt over all views gives 32-channel maps at 1/8, 1/4 and 1/2; three
SingleStages with soft fusion (the reference model's; the JAX model fixes
it too) and 64/32/16 hypotheses at interval scales 4/2/1, each
stage's depth start the previous estimate resized x2 (bilinear) minus half
its span (:117-156); uncertainty = 1 - the last stage's windowed probability
mass (:180-182). Each stage runs K2's group mode once per source view, K3
twice and, with the default ``conv3d_impl="banded"``, K5 ten times. The
input adapter resizes to a multiple of 64, truncates to uint8 as the
reference does, normalises with the ImageNet statistics and flips RGB to
BGR (:189-226), on the card; the depth range defaults to 0.2..100.

``warp_impl`` picks the pair cost volumes' route, with JAX's names mapped by
``create_model``: "fused" (K2's group mode, the default) or "xla"
(per-hypothesis homographies, a warp and the group sums: the JAX route off
the TPU and the one JAX trains through). ``dtype="bfloat16"`` is JAX's mixed
precision (:39-43): FeatExt and the stages' U-Nets compute in bf16 (K5's
bf16 form with ``conv3d_impl="banded"``), with float32 parameters and
BatchNorm statistics; the score heads, the readouts (K3), the uncertainty net
and the fusion are float32.

``train=True`` is JAX's training configuration (:173-200): the "xla" warp
route (K2's group mode is forward-only), the model in ``.train()`` mode and,
with ``bn_mode="batch"`` (the default), BatchNorm on flax's batch statistics
(``ops/layers.py``), each source pair regularised on its own so that the
running statistics move once per pair (with two source views K5 runs 15
times and K3 3 times per stage forward, 10 and 2 at inference);
``bn_mode="frozen"`` keeps every BatchNorm on its running
statistics whoever calls ``.train()``. The next stage's depth start takes no
gradient (JAX's ``stop_gradient``). K3's backward is its closed form in torch
ops, K5's cuDNN's.

The JAX input adapter pads the view list to a bucket (that bounds XLA
compiles); the port does not, so every source view counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interpolate import resize_bilinear
from ..ops.layers import freeze_batchnorm
from .blocks.mvsnet import init_weights
from .blocks.vis_mvsnet import FeatExt, SingleStage
from .helpers import ModelBase, compute_dtype_of, resize_to_multiple, to_device
from .mvsnet import IMAGENET_MEAN, IMAGENET_STD, check_warp_impl
from .registry import register_model
from .robust_mvd import split_key_sources
from .weights import load_checkpoint, vis_state_dict_from_rmvd

DEPTH_NUMS = (64, 32, 16)
INTERVAL_SCALES = (4.0, 2.0, 1.0)
FEATURE_STRIDES = (8, 4, 2)
# Random weights: without trained BatchNorm statistics the residual U-Nets
# grow their activations layer by layer, and the score heads' outputs reach
# a std of several hundred, a one-hot softmax whose expectation is an
# argmax that rounding flips. The heads are scaled down so that a random
# network's softmax is moderately peaked (max probability ~0.3-0.7).
SCORE_HEAD_GAIN = 1 / 64
BN_MODES = ("batch", "frozen")


class VisMVSNet(ModelBase):
    """The forward takes images (B, V, 3, H, W) normalised BGR, poses
    (B, V, 4, 4), absolute intrinsics (B, V, 3, 3), keyview_idx (B,) and
    optionally depth_range = (min (B,), max (B,))."""

    def __init__(self, device, num_sampling_steps=192, weights=None, seed=0, conv3d_impl="banded",
                 warp_impl="fused", dtype="float32", train=False, bn_mode="batch"):
        super().__init__()
        if bn_mode not in BN_MODES:
            raise ValueError(f"bn_mode must be one of {BN_MODES}, got {bn_mode!r}")
        self.num_sampling_steps = num_sampling_steps
        self.bn_mode = bn_mode
        # training differentiates through the warp: the "xla" route (JAX :179-182)
        self.warp_impl = "xla" if train else check_warp_impl(warp_impl)
        self.compute_dtype = cdt = compute_dtype_of(dtype, "vis_mvsnet")
        self.feat_ext = FeatExt(cdt)
        for k in (1, 2, 3):
            setattr(self, f"stage{k}", SingleStage(conv3d_impl, cdt, self.warp_impl))
        if weights is None:
            init_weights(self, torch.Generator().manual_seed(seed))
            with torch.no_grad():
                for stage in (self.stage1, self.stage2, self.stage3):
                    stage.reg_pair.final_conv.weight.mul_(SCORE_HEAD_GAIN)
                    stage.reg_fuse.final_conv.weight.mul_(SCORE_HEAD_GAIN)
        else:
            self.load_state_dict(vis_state_dict_from_rmvd(load_checkpoint(weights)))
        self.to(device).train(train)
        if bn_mode == "frozen":
            freeze_batchnorm(self)

    def forward(self, images, poses, intrinsics, keyview_idx, depth_range=None):
        B, V, _, H, W = images.shape
        device = images.device
        if depth_range is None:
            depth_range = (torch.full((B,), 0.2, device=device), torch.full((B,), 100.0, device=device))
        lo, hi = (r.reshape(B).float() for r in depth_range)
        cams = torch.zeros((B, V, 2, 4, 4), device=device)
        cams[:, :, 0] = poses
        cams[:, :, 1, :3, :3] = intrinsics
        cams[:, :, 1, 3, 0] = lo[:, None]
        cams[:, :, 1, 3, 1] = ((hi - lo) / self.num_sampling_steps)[:, None]
        cams[:, :, 1, 3, 2] = float(self.num_sampling_steps)
        cams[:, :, 1, 3, 3] = hi[:, None]
        cam_key, cams_src = split_key_sources(cams, keyview_idx)
        srcs_cam = [cams_src[:, i] for i in range(V - 1)]
        depth_start = cam_key[:, 1:2, 3:4, 0:1]  # (B, 1, 1, 1)
        depth_interval = cam_key[:, 1:2, 3:4, 1:2]

        train_bn = self.training and self.bn_mode == "batch"
        outputs, prob_maps = [], []
        est_depth = None
        for k, feat in enumerate(self.feat_ext(images.reshape(B * V, 3, H, W))):
            feat = feat.reshape(B, V, *feat.shape[1:]).permute(0, 1, 3, 4, 2)  # (B, V, h, w, C)
            ref, srcs = split_key_sources(feat, keyview_idx)
            size = ref.shape[1:3]
            start = None
            if est_depth is not None:
                start = resize_bilinear(est_depth.detach(), size) - DEPTH_NUMS[k] * depth_interval * INTERVAL_SCALES[k] / 2
            stage = getattr(self, f"stage{k + 1}")
            est_depth, prob_map, pairs = stage(ref.contiguous(), cam_key, [srcs[:, i] for i in range(V - 1)],
                                               srcs_cam, DEPTH_NUMS[k], "soft", start,
                                               depth_interval * INTERVAL_SCALES[k], FEATURE_STRIDES[k],
                                               train=train_bn)
            outputs.append([est_depth, pairs])
            up = FEATURE_STRIDES[k] // FEATURE_STRIDES[-1]
            prob_maps.append(resize_bilinear(prob_map, (size[0] * up, size[1] * up)) if up > 1 else prob_map)

        pred = {"depth": est_depth, "depth_uncertainty": 1.0 - prob_map}
        aux = {"outputs": outputs, "prob_maps": prob_maps, "ref_cam": cam_key, "depth": est_depth}
        return pred, aux

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        """Multiple-of-64 resize, then on the card: truncation to uint8 (the
        reference's ``astype(np.uint8)`` after the resize), ImageNet
        normalisation, RGB -> BGR (reference: vis_mvsnet.py:189-226)."""
        if poses is None or intrinsics is None:
            raise ValueError("vis_mvsnet requires poses and intrinsics inputs")
        images, intrinsics, _ = resize_to_multiple(images, intrinsics, 64)
        device = self.device
        images = torch.stack([to_device(img, device) for img in images], dim=1).to(torch.uint8).float()
        mean = to_device(IMAGENET_MEAN.reshape(3, 1, 1), device)
        std = to_device(IMAGENET_STD.reshape(3, 1, 1), device)
        images = torch.flip((images / torch.tensor(255.0, device=device) - mean) / std, [2])
        sample = {
            "images": images,
            "poses": to_device(np.stack(poses, axis=1), device),
            "intrinsics": to_device(np.stack(intrinsics, axis=1), device),
            "keyview_idx": to_device(np.asarray(keyview_idx).reshape(-1), device, np.int64),
        }
        if depth_range is not None:
            sample["depth_range"] = tuple(to_device(np.asarray(r).reshape(-1), device) for r in depth_range)
        return sample


@register_model
def vis_mvsnet(pretrained=True, weights=None, train=False, device="cuda", seed=0, num_sampling_steps=192,
               conv3d_impl="banded", warp_impl="fused", dtype="float32", bn_mode="batch"):
    """Vis-MVSNet (reference: vis_mvsnet.py:232-242) with soft fusion,
    registered without pretrained weights: pass a ``.pt`` as ``weights``,
    in the port's naming or rmvd's (``models/weights.py::RMVD_VIS_KEY``
    tells them apart), or get weights from ``seed``. ``conv3d_impl`` picks the
    lowering of the 3D U-Nets' stride-1 3x3x3 convolutions
    (``ops/conv3d.py``): "banded", the JAX default, runs K5 (30 launches
    per frame; 24 of them in bf16 at ``dtype="bfloat16"``, the 6 score heads in
    float32), "xla" cuDNN. ``warp_impl`` ("fused" or "xla"; training takes
    "xla"), ``dtype``, ``train`` and ``bn_mode`` ("batch" or "frozen") as in
    :class:`VisMVSNet`."""
    return VisMVSNet(device=device, num_sampling_steps=num_sampling_steps, weights=weights, seed=seed,
                     conv3d_impl=conv3d_impl, warp_impl=warp_impl, dtype=dtype, train=train, bn_mode=bn_mode)
