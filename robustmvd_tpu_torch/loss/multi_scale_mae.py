"""Multi-scale masked MAE (reference: rmvd/loss/multi_scale_mae.py), the
JAX package's ``loss/multi_scale_mae.py`` in torch: MAE on inverse depth at
four scales with weights ``100 * 1050 * [1/8, 1/4, 1/2, 1]`` and the L2
weight decay of ``multi_scale_uni_laplace``; NCHW maps."""

from __future__ import annotations

from ..ops.interpolate import resize_nearest_torch
from .multi_scale_uni_laplace import regularization_l2, regularization_parameters
from .registry import register_loss
from .utils import mae, pointwise_ae


class MultiScaleMAE:
    def __init__(self, model=None, weight_decay=1e-4, gt_interpolation="nearest", modality="invdepth",
                 verbose=True):
        self.name = type(self).__name__
        self.weight_decay = weight_decay
        self.gt_interpolation = gt_interpolation
        self.modality = modality
        self.loss_weights = [100 * 1050 * w for w in (1 / 8, 1 / 4, 1 / 2, 1)]
        self.reg_params = regularization_parameters(model) if model is not None else None

    def __call__(self, sample_inputs, sample_gt, pred, aux, iteration):
        sub_losses = {}
        pointwise_losses = {}

        gt = sample_gt[self.modality]
        gt_mask = (gt > 0).to(gt.dtype)
        total_mae = 0.0
        for level, p in enumerate(aux[f"{self.modality}s_all"]):
            size = p.shape[-2:]
            gt_rs = resize_nearest_torch(gt, size)
            mask_rs = resize_nearest_torch(gt_mask, size) == 1.0
            w = self.loss_weights[level]
            loss = mae(gt=gt_rs, pred=p, mask=mask_rs, weight=w)
            sub_losses[f"02_mnll/level_{level}"] = loss
            pointwise_losses[f"00_nll/level_{level}"] = pointwise_ae(gt=gt_rs, pred=p, mask=mask_rs, weight=w)
            total_mae = total_mae + loss

        total_reg = regularization_l2(self.reg_params, self.weight_decay) if self.reg_params is not None else 0.0
        sub_losses["00_total_mnll"] = total_mae
        sub_losses["01_reg"] = total_reg
        return total_mae + total_reg, sub_losses, pointwise_losses


@register_loss
def supervised_monodepth2_loss(model=None, **kwargs):
    return MultiScaleMAE(model=model, weight_decay=1e-4, gt_interpolation="nearest", modality="invdepth", **kwargs)
