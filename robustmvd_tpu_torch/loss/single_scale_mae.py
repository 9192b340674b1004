"""Single-scale masked MAE, the MVSNet training loss (reference:
rmvd/loss/single_scale_mae.py:10-130), the JAX package's
``loss/single_scale_mae.py`` in torch: the MAE of ``aux[modality]`` against
the ground truth resized to its size (nearest or bilinear), masked where
the ground truth is valid, optionally weighted by the inverse of the
hypotheses' depth interval (:78-89, from ``aux["sampling_invdepths"]``,
(N, S) ascending in inverse depth), plus the L2 weight decay of
``multi_scale_uni_laplace`` (none for ``mvsnet_loss``). NCHW maps."""

from __future__ import annotations

from ..ops.interpolate import resize_bilinear, resize_nearest_torch
from .multi_scale_uni_laplace import regularization_l2, regularization_parameters
from .registry import register_loss
from .utils import mae, pointwise_ae


class SingleScaleMAE:
    def __init__(self, model=None, weight_decay=1e-4, gt_interpolation="nearest", modality="invdepth",
                 weight_by_sampling_interval=False, verbose=True):
        self.name = type(self).__name__
        self.weight_decay = weight_decay
        self.gt_interpolation = gt_interpolation
        self.modality = modality
        self.weight_by_sampling_interval = weight_by_sampling_interval
        self.reg_params = regularization_parameters(model) if model is not None and weight_decay else None

    def __call__(self, sample_inputs, sample_gt, pred, aux, iteration):
        gt = sample_gt[self.modality]
        p = aux[self.modality]
        loss_weight = 1.0
        if self.weight_by_sampling_interval:
            sampling_invdepths = aux["sampling_invdepths"]
            steps = sampling_invdepths.shape[1]
            max_depth = 1.0 / sampling_invdepths[:, 0:1]
            min_depth = 1.0 / sampling_invdepths[:, -1:]
            loss_weight = 1.0 / ((max_depth - min_depth) / (steps - 1))
            while loss_weight.dim() < p.dim():
                loss_weight = loss_weight[..., None]

        size = p.shape[-2:]
        gt_rs = resize_bilinear(gt, size) if self.gt_interpolation == "bilinear" else resize_nearest_torch(gt, size)
        mask_rs = resize_nearest_torch((gt > 0).to(gt.dtype), size) == 1.0
        mae_loss = mae(gt=gt_rs, pred=p, mask=mask_rs, weight=loss_weight)
        total_reg = regularization_l2(self.reg_params, self.weight_decay) if self.reg_params is not None else 0.0
        sub_losses = {"00_mae": mae_loss, "01_reg": total_reg}
        pointwise_losses = {"0_ae": pointwise_ae(gt=gt_rs, pred=p, mask=mask_rs, weight=loss_weight)}
        return mae_loss + total_reg, sub_losses, pointwise_losses


@register_loss
def mvsnet_loss(model=None, **kwargs):
    return SingleScaleMAE(model=model, weight_decay=0.0, gt_interpolation="bilinear", modality="depth",
                          weight_by_sampling_interval=True, **kwargs)
