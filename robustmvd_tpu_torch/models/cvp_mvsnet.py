"""cvp_mvsnet — CVP-MVSNet, a coarse-to-fine cost-volume pyramid, in PyTorch.

Reference model: rmvd/models/cvp_mvsnet.py:60-321, through the JAX package's
``models/cvp_mvsnet.py``. A feature pyramid over ``nscale`` image scales
(all views in one pass); at the coarsest level 48 uniform hypotheses and a
variance cost volume (K2, R,t mode), the shared CostRegNet, softmax and
depth regression; then at each finer level the depth upsampled x2
(bicubic, ``jax.image.resize`` semantics), 8 hypotheses around it spaced by
the epipolar one-pixel interval, a variance volume with per-pixel hypotheses
(K2, dense mode), the same CostRegNet and depth regression; confidence = the
probability mass of four consecutive hypotheses at the expected index of
the last level (:219-236). Inputs are /255 at a multiple of 64 (:259-288);
the depth range defaults to 0.2..100.

``warp_impl`` picks the cost-volume route of every level, with JAX's
names mapped by ``create_model``: "fused" (K2, the default) or "xla"
(``rt_planesweep_warp`` per source view and float32 running sums, the JAX
route off the TPU and the one JAX trains through, :158-177, 210).
``dtype="bfloat16"`` is JAX's mixed precision (:44-48): the pyramid and
CostRegNet compute in bf16 with float32 parameters and BatchNorm statistics,
K2 writes the variance in bf16 (the "xla" route's float32 variance is cast
at CostRegNet's first convolution); ``prob0``, the softmax, the depth
regression, the hypotheses and the confidence are float32.

``train=True`` is JAX's training mode (:239-244): the "xla" route (K2 is
forward-only), refinement hypotheses spaced by the constant training
interval 6.8085 (``cal_depth_hypos(mode="train")``) instead of the epipolar
one, and CostRegNet's BatchNorm frozen on its running statistics while the
model trains (JAX applies it with ``train=False``, :184, :214).

Under a mesh with a hyp axis (``parallel.use_mesh``; JAX :179-215) each
level's hypotheses are sharded: each rank builds its slab of the variance
volume (the coarse level's 48, each refinement level's 8, by
``share(D, hyp)``), ``CostRegNet`` runs on slabs (``ops/sharded3d.py``), and
the logits are gathered over hyp before the softmax, so the depth
regression, the next level's hypotheses and the confidence are computed
whole on every rank, as the bicubic upsampling is.

The JAX input adapter pads the view list to a bucket; the port does not, so
every source view counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.homography import inverse, rt_planesweep_warp
from ..ops.interpolate import resize_bicubic_x2
from ..ops.kernels.sweep_warp import warp_variance_rt
from ..ops.layers import freeze_batchnorm
from ..ops.reductions import variance_over_views
from ..ops.sharded3d import gather_scores, hypothesis_slab
from .blocks.cvp_mvsnet import (
    CostRegNet,
    FeaturePyramid,
    cal_depth_hypos,
    cal_sweeping_depth_hypos,
    condition_intrinsics,
    proj_cost_volume,
    proj_mat,
    src_from_ref,
)
from .blocks.mvsnet import init_weights
from .helpers import ModelBase, compute_dtype_of, resize_to_multiple, to_device
from .mvsnet import check_warp_impl, confidence_4tap
from .registry import register_model
from .robust_mvd import split_key_sources
from .weights import load_checkpoint

NUM_COARSE_HYPOTHESES = 48


def _channel_last(feat, B, V):
    """(B*V, C, h, w) -> (B, V, h, w, C), contiguous."""
    return feat.reshape(B, V, *feat.shape[1:]).permute(0, 1, 3, 4, 2).contiguous()


class CVPMVSNet(ModelBase):
    """The forward takes images (B, V, 3, H, W) in [0, 1], poses (B, V, 4, 4),

    absolute intrinsics (B, V, 3, 3), keyview_idx (B,), min_depth and
    max_depth (B,) (default 0.2 and 100). As JAX's ``apply_fn`` it takes and
    ignores other inputs, such as the training engine's ``depth_range``."""

    def __init__(self, device, nscale=5, weights=None, seed=0, conv3d_impl="xla", warp_impl="fused",
                 dtype="float32", train=False):
        super().__init__()
        self.nscale = nscale
        self.mode = "train" if train else "test"
        # training differentiates through the warp: the "xla" route (JAX :242-244)
        self.warp_impl = "xla" if train else check_warp_impl(warp_impl)
        self.compute_dtype = cdt = compute_dtype_of(dtype, "cvp_mvsnet")
        self.featurePyramid = FeaturePyramid(cdt)
        self.cost_reg_refine = CostRegNet(conv3d_impl=conv3d_impl, dtype=cdt)
        if weights is None:
            init_weights(self, torch.Generator().manual_seed(seed))
        else:
            self.load_state_dict(load_checkpoint(weights))
        freeze_batchnorm(self.to(device).train(train))

    def _regress(self, volume, hypos):
        """Variance volume (B, D, h, w, C), or the rank's slab of it under a
        hyp axis, and every hypothesis ``hypos`` -> (depth (B, h, w), prob
        (B, D, h, w))."""
        D = hypos.shape[1]
        logits = gather_scores(self.cost_reg_refine(volume.permute(0, 4, 1, 2, 3).contiguous(), D), D)
        prob = torch.softmax(logits, dim=1)
        if hypos.dim() == 2:
            hypos = hypos[:, :, None, None]
        return torch.sum(prob * hypos, dim=1), prob

    def forward(self, images, poses, intrinsics, keyview_idx, min_depth=None, max_depth=None, **_):
        B, V, _, H, W = images.shape
        if min_depth is None:
            min_depth = torch.full((B,), 0.2, device=images.device)
            max_depth = torch.full((B,), 100.0, device=images.device)
        image_key, images_src = split_key_sources(images, keyview_idx)
        K_key, K_srcs = split_key_sources(intrinsics, keyview_idx)
        pose_key, poses_src = split_key_sources(poses, keyview_idx)

        all_imgs = torch.cat([image_key[:, None], images_src], dim=1)  # key first
        fp = [_channel_last(f, B, V) for f in self.featurePyramid(all_imgs.reshape(B * V, 3, H, W), self.nscale)]
        fp_shapes = [(f.shape[2], f.shape[3]) for f in fp]
        ref_K_ms = condition_intrinsics(K_key, (H, W), fp_shapes)  # (B, S, 3, 3)
        src_K_ms = torch.stack([condition_intrinsics(K_srcs[:, i], (H, W), fp_shapes) for i in range(V - 1)],
                               dim=1)  # (B, V-1, S, 3, 3)

        # coarsest level: uniform sweep (K2, R,t mode)
        cdt = self.compute_dtype
        hypos = cal_sweeping_depth_hypos(min_depth, max_depth, NUM_COARSE_HYPOTHESES)
        lo, hi = hypothesis_slab(NUM_COARSE_HYPOTHESES)
        slab = hypos[:, lo:hi]
        ref_proj_inv = inverse(proj_mat(ref_K_ms[:, -1], pose_key))
        rts = [src_from_ref(src_K_ms[:, i, -1], poses_src[:, i], ref_proj_inv) for i in range(V - 1)]
        if self.warp_impl == "xla":
            warped = (rt_planesweep_warp(fp[-1][:, 1 + i], r, t, slab) for i, (r, t) in enumerate(rts))
            volume = variance_over_views(fp[-1][:, 0], warped, hi - lo)
        else:
            volume = warp_variance_rt(fp[-1][:, 0], fp[-1][:, 1:], torch.stack([r for r, _ in rts], dim=1),
                                      torch.stack([t for _, t in rts], dim=1), slab, out_dtype=cdt)
        depth, prob = self._regress(volume, hypos)
        depths = [depth]

        # refinement levels (K2, dense mode)
        for level in range(self.nscale - 2, -1, -1):
            depth_up = resize_bicubic_x2(depth)
            hypos = cal_depth_hypos(depth_up, ref_K_ms[:, level], src_K_ms[:, 0, level], pose_key,
                                    poses_src[:, 0], mode=self.mode)
            lo, hi = hypothesis_slab(hypos.shape[1])
            volume = proj_cost_volume(fp[level][:, 0], fp[level][:, 1:], ref_K_ms[:, level],
                                      src_K_ms[:, :, level], pose_key, poses_src, hypos[:, lo:hi], self.warp_impl,
                                      cdt)
            depth, prob = self._regress(volume, hypos)
            depths.append(depth)

        pred = {"depth": depth[:, None], "depth_uncertainty": (1.0 - confidence_4tap(prob))[:, None]}
        aux = {"depth": pred["depth"], "depths_all": [d[:, None] for d in depths[::-1]]}
        return pred, aux

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        """Multiple-of-64 resize, /255 on the card (a true division, like the

        numpy path's), depth range default 0.2..100 (reference:
        cvp_mvsnet.py:259-288)."""
        if poses is None or intrinsics is None:
            raise ValueError("cvp_mvsnet requires poses and intrinsics inputs")
        images, intrinsics, _ = resize_to_multiple(images, intrinsics, 64)
        device = self.device
        images = torch.stack([to_device(img, device) for img in images], dim=1)
        if depth_range is None:
            depth_range = (np.array([0.2]), np.array([100.0]))
        lo, hi = (to_device(np.asarray(r).reshape(-1), device) for r in depth_range)
        return {
            "images": images / torch.tensor(255.0, device=device),
            "poses": to_device(np.stack(poses, axis=1), device),
            "intrinsics": to_device(np.stack(intrinsics, axis=1), device),
            "keyview_idx": to_device(np.asarray(keyview_idx).reshape(-1), device, np.int64),
            "min_depth": lo,
            "max_depth": hi,
        }


@register_model(trainable=False)
def cvp_mvsnet(pretrained=True, weights=None, train=False, device="cuda", seed=0, nscale=5, conv3d_impl="xla",
               warp_impl="fused", dtype="float32"):
    """CVP-MVSNet (reference: cvp_mvsnet.py:308-321), registered without
    pretrained weights: pass a port ``.pt`` as ``weights``, or get weights
    from ``seed``. ``conv3d_impl`` picks the lowering of CostRegNet's
    stride-1 3x3x3 convolutions (``ops/conv3d.py``; "banded": K5; "xla",
    the JAX default: cuDNN); ``warp_impl`` (training takes "xla"),
    ``dtype`` and ``train`` as in :class:`CVPMVSNet`. Not in
    ``list_models(trainable_only=True)``, as in JAX."""
    return CVPMVSNet(device=device, nscale=nscale, weights=weights, seed=seed, conv3d_impl=conv3d_impl,
                     warp_impl=warp_impl, dtype=dtype, train=train)
