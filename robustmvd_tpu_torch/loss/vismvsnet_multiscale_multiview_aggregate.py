"""Vis-MVSNet's training loss (reference:
rmvd/loss/vismvsnet_multiscale_multiview_aggregate.py:14-220), the JAX
package's ``loss/vismvsnet_multiscale_multiview_aggregate.py`` in torch.

Per stage of ``aux["outputs"]`` ([est_depth, pair_results] from coarse to
fine): the L1 of the stage's depth against the ground truth resized
bilinearly to its size, in units of the depth interval; per source pair
the same L1 of the pair's depth and, in the fusion modes with an
uncertainty ("soft", "hard", "uwta"), ``err exp(-u) + u`` with u the
pair's first uncertainty head, each averaged over the pairs; every mean
over the pixels whose ground truth lies in [depth_start, depth_start +
(max_d - 2) interval] (``aux["ref_cam"]``), with eps 1e-9; the stages
weighted 0.5, 1 and 2. Maps are (B, 1, h, w), the ground truth
(B, 1, H, W) as the training engine gives it (the JAX loss transposes its
channel-last ground truth).
"""

from __future__ import annotations

import torch

from ..ops.interpolate import resize_bilinear
from .registry import register_loss
from .utils import masked_ratio

STAGE_WEIGHTS = (0.5, 1.0, 2.0)


def _masked_mean(x, mask, eps=1e-9):
    """Over the global batch under data-parallel training (``loss/utils.py``)."""
    mask = mask.to(x.dtype)
    return masked_ratio((x * mask).sum(), mask.sum(), lambda total, count: total / (count + eps))


class VismvnsetMultiscaleMultiviewAggregate:
    def __init__(self, model=None, max_d=192, mode="soft", occ_guide=False):
        self.name = type(self).__name__
        self.max_d = max_d
        self.mode = mode
        self.occ_guide = occ_guide

    def __call__(self, sample_inputs, sample_gt, pred, aux, iteration):
        gt = sample_gt["depth"]
        ref_cam = aux["ref_cam"]
        depth_start = ref_cam[:, 1:2, 3:4, 0:1]
        depth_interval = ref_cam[:, 1:2, 3:4, 1:2]
        depth_end = depth_start + (self.max_d - 2) * depth_interval

        sub_losses = {}
        total = 0.0
        for stage, ((est_depth, pair_results), weight) in enumerate(zip(aux["outputs"], STAGE_WEIGHTS), 1):
            size = est_depth.shape[-2:]
            gt_ds = resize_bilinear(gt, size)
            in_range = (gt_ds >= depth_start) & (gt_ds <= depth_end)
            interm_size = pair_results[0][0].shape[-2:]
            if interm_size == size:
                gt_interm, in_range_interm = gt_ds, in_range
            else:
                gt_interm = resize_bilinear(gt, interm_size)
                in_range_interm = (gt_interm >= depth_start) & (gt_interm <= depth_end)

            l1 = _masked_mean(torch.abs(est_depth - gt_ds) / depth_interval, in_range)
            pair_l1, uncert = [], []
            for est, heads in pair_results:
                err = torch.abs(est - gt_interm) / depth_interval
                pair_l1.append(_masked_mean(err, in_range_interm))
                if self.mode in ("soft", "hard", "uwta"):
                    uncert.append(_masked_mean(err * torch.exp(-heads[0]) + heads[0], in_range_interm))
            pair_loss = sum(pair_l1) / len(pair_l1)
            if uncert:
                pair_loss = pair_loss + sum(uncert) / len(uncert)
            total = total + (l1 + pair_loss) * weight
            sub_losses[f"stage{stage}/l1"] = l1
            sub_losses[f"stage{stage}/pair"] = pair_loss
        sub_losses["00_total"] = total
        return total, sub_losses, {}


@register_loss
def vismvsnet_loss(model=None, **kwargs):
    return VismvnsetMultiscaleMultiviewAggregate(model=model, **kwargs)


# the reference's class name is an entrypoint as well
register_loss(lambda model=None, **kwargs: VismvnsetMultiscaleMultiviewAggregate(model=model, **kwargs),
              name="VismvnsetMultiscaleMultiviewAggregate")
