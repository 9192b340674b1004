"""Loss primitives (reference: rmvd/loss/utils.py), the JAX package's
``loss/utils.py`` in torch.

They take maps of one shape, e.g. (N, 1, H, W), with an optional boolean
mask; masked means divide by the number of valid pixels and give 0 where
none is valid.
"""

from __future__ import annotations

import torch


def _masked_mean(pointwise, mask, eps=1e-9):
    if mask is None:
        return pointwise.mean()
    mask = mask.to(pointwise.dtype)
    num_valid = mask.sum()
    total = (pointwise * mask).sum() / (num_valid + eps)
    return torch.where(num_valid != 0, total, torch.zeros_like(total))


def mae(gt, pred, mask=None, weight=None, eps=1e-9):
    ae = torch.abs(pred - gt)
    if weight is not None:
        ae = ae * weight
    return _masked_mean(ae, mask, eps)


def pointwise_ae(gt, pred, mask=None, weight=None):
    ae = torch.abs(pred - gt)
    if mask is not None:
        ae = ae * mask.to(ae.dtype)
    if weight is not None:
        ae = ae * weight
    return ae


def m_univariate_laplace_nll(gt, pred_a, pred_log_b, mask=None, weight=None, eps=1e-9):
    """Mean Laplacian negative log-likelihood: |e|/b + log b."""
    nll = torch.abs(pred_a - gt) / torch.exp(pred_log_b) + pred_log_b
    if weight is not None:
        nll = nll * weight
    return _masked_mean(nll, mask, eps)


def pointwise_univariate_laplace_nll(gt, pred_a, pred_log_b, mask=None, weight=None):
    nll = torch.abs(pred_a - gt) / torch.exp(pred_log_b) + pred_log_b
    if mask is not None:
        nll = nll * mask.to(nll.dtype)
    if weight is not None:
        nll = nll * weight
    return nll
