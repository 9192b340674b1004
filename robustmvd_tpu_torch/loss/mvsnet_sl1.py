"""Smooth-L1 depth loss, the CVP-MVSNet training loss (reference:
rmvd/loss/mvsnet_sl1.py:7-28), the JAX package's ``loss/mvsnet_sl1.py`` in
torch: smooth L1 (beta 1) between the predicted and the ground-truth depth,
masked; the ground truth resized bilinearly (align_corners=False) to the
prediction's size, the validity mask (``sample_inputs["masks"]``, else
depth > 0) resized nearest and thresholded at 0.5. NCHW maps."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.interpolate import resize_bilinear, resize_nearest_torch
from .registry import register_loss
from .utils import masked_ratio


class SL1Loss:
    def __init__(self, model=None, verbose=True):
        self.name = type(self).__name__

    def __call__(self, sample_inputs, sample_gt, pred, aux, iteration):
        p = pred["depth"]
        gt = sample_gt["depth"]
        masks = sample_inputs.get("masks")
        if masks is None:
            masks = (gt > 0).to(gt.dtype)
        else:
            masks = masks.to(gt.dtype)
            if masks.dim() == 3:
                masks = masks[:, None]

        size = p.shape[-2:]
        gt = resize_bilinear(gt, size)
        masks = resize_nearest_torch(masks, size) > 0.5
        diff = F.smooth_l1_loss(p, gt, reduction="none", beta=1.0) * masks
        loss = masked_ratio(diff.sum(), masks.sum(), lambda total, count: total / torch.clamp(count, min=1.0))
        return loss, {}, {}


def _sl1_loss(model=None, **kwargs):
    return SL1Loss(model=model, **kwargs)


# the reference registers the class itself, so the entrypoint is "SL1Loss"
register_loss(_sl1_loss, name="SL1Loss")
