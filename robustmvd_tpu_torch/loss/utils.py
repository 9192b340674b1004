"""Loss primitives (reference: rmvd/loss/utils.py), the JAX package's
``loss/utils.py`` in torch.

They take maps of one shape, e.g. (N, 1, H, W), with an optional boolean
mask; masked means divide by the number of valid pixels and give 0 where
none is valid.

Under data-parallel training (a mesh active, ``parallel.context``) a masked
mean is the global batch's: :func:`masked_ratio` sums the number of valid
pixels over the data group and scales each rank's sum by the group's size,
so that the ranks' losses average to the global masked mean and
``DistributedDataParallel``'s averaged gradient is its gradient (JAX's
sharded step takes the mean over the global batch).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.context import data_group


def masked_ratio(numerator, count, finish):
    """``finish(numerator, count)``: a masked mean's sum over its count of
    valid pixels. With a data group of more than one rank active, the count
    is summed over the group (detached) and the numerator scaled by the
    group's size (see the module docstring)."""
    group = data_group()
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group[0])
        numerator = numerator * group[1]
    return finish(numerator, count)


def _masked_mean(pointwise, mask, eps=1e-9):
    if mask is None:
        return pointwise.mean()
    mask = mask.to(pointwise.dtype)

    def finish(total, num_valid):
        total = total / (num_valid + eps)
        return torch.where(num_valid != 0, total, torch.zeros_like(total))

    return masked_ratio((pointwise * mask).sum(), mask.sum(), finish)


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
