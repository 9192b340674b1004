"""Multi-scale univariate-Laplacian NLL: the robust_mvd training loss.

The JAX package's ``loss/multi_scale_uni_laplace.py`` in torch, after the
reference (rmvd/loss/multi_scale_uni_laplace.py:15-158):
- a masked loss per scale on inverse depth times ``mean_scaling_factor``
  (1050 for ``robust_mvd_loss``);
- plain MAE for the first ``deterministic_loss_iterations`` (2000)
  iterations, then the Laplacian NLL ``|e|/b + log b``;
- scale weights ``100 * [1/16, 1/16, 1/16, 1/8, 1/4, 1/2, 1]`` zipped with
  the decoder's coarse-to-fine predictions;
- L2 weight decay 1e-4 on the parameters that are not in a prediction
  head, not biases and not norm scales (:func:`regularization_parameters`);
- ground truth resized nearest to each scale with torch's floor rule.

Maps are NCHW, the port's layout: the decoder's ``invdepths_all`` and
``invdepth_log_bs_all`` are (N, 1, h, w) and the ground truth (N, 1, H, W).
The JAX package selects the loss branch-free so that its compiled step
stays one program; here the iteration picks the one that is computed.
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.interpolate import resize_nearest_torch
from .registry import register_loss
from .utils import m_univariate_laplace_nll, mae, pointwise_ae, pointwise_univariate_laplace_nll

_NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)


def regularization_parameters(model):
    """(name, parameter) pairs that take L2 weight decay: every trainable

    parameter except those whose name contains "pred", biases and the
    weights of normalisation layers (the reference's filter,
    rmvd/loss/multi_scale_uni_laplace.py:58-77; the JAX package's
    ``regularization_l2`` applies the same rule to flax names)."""
    norm_params = {id(p) for m in model.modules() if isinstance(m, _NORMS) for p in m.parameters(recurse=False)}
    return [(name, p) for name, p in model.named_parameters()
            if p.requires_grad and "pred" not in name.lower() and name.rsplit(".", 1)[-1] != "bias"
            and id(p) not in norm_params]


def regularization_l2(params, weight_decay):
    """``weight_decay`` times the sum of 0.5 * ||w||^2 over ``params``."""
    total = 0.0
    for _, p in params:
        total = total + (p * p).sum() / 2.0
    return total * weight_decay


class MultiScaleUniLaplace:
    def __init__(self, model=None, weight_decay=1e-4, gt_interpolation="nearest", modality="invdepth",
                 deterministic_loss_iterations=2000, mean_scaling_factor=1, verbose=True):
        self.name = type(self).__name__
        self.weight_decay = weight_decay
        self.gt_interpolation = gt_interpolation
        self.modality = modality
        self.deterministic_loss_iterations = deterministic_loss_iterations
        self.mean_scaling_factor = mean_scaling_factor
        self.loss_weights = [100 * w for w in (1 / 16, 1 / 16, 1 / 16, 1 / 8, 1 / 4, 1 / 2, 1)]
        self.reg_params = regularization_parameters(model) if model is not None else None

    def __call__(self, sample_inputs, sample_gt, pred, aux, iteration):
        """Returns (total_loss, sub_losses, pointwise_losses)."""
        sub_losses = {}
        pointwise_losses = {}

        gt = sample_gt[self.modality] * self.mean_scaling_factor
        gt_mask = (gt > 0).to(gt.dtype)
        preds_all = [x * self.mean_scaling_factor for x in aux[f"{self.modality}s_all"]]
        pred_log_bs_all = aux[f"{self.modality}_log_bs_all"]
        deterministic = iteration < self.deterministic_loss_iterations

        total_mnll = 0.0
        for level, (p, log_b) in enumerate(zip(preds_all, pred_log_bs_all)):
            size = p.shape[-2:]
            gt_rs = resize_nearest_torch(gt, size)
            mask_rs = resize_nearest_torch(gt_mask, size) == 1.0
            w = self.loss_weights[level]
            if deterministic:
                loss = mae(gt=gt_rs, pred=p, mask=mask_rs, weight=w)
                pointwise = pointwise_ae(gt=gt_rs, pred=p, mask=mask_rs, weight=w)
            else:
                loss = m_univariate_laplace_nll(gt=gt_rs, pred_a=p, pred_log_b=log_b, mask=mask_rs, weight=w)
                pointwise = pointwise_univariate_laplace_nll(gt=gt_rs, pred_a=p, pred_log_b=log_b, mask=mask_rs,
                                                             weight=w)
            sub_losses[f"02_mnll/level_{level}"] = loss
            pointwise_losses[f"00_nll/level_{level}"] = pointwise
            total_mnll = total_mnll + loss

        total_reg = regularization_l2(self.reg_params, self.weight_decay) if self.reg_params is not None else 0.0
        total = total_mnll + total_reg
        sub_losses["00_total_mnll"] = total_mnll
        sub_losses["01_reg"] = total_reg
        return total, sub_losses, pointwise_losses


@register_loss
def robust_mvd_loss(model=None, **kwargs):
    return MultiScaleUniLaplace(model=model, weight_decay=1e-4, gt_interpolation="nearest", modality="invdepth",
                                deterministic_loss_iterations=2000, mean_scaling_factor=1050, **kwargs)
