"""Hypothesis-axis reductions: depth regression, soft-argmin, entropy,
groupwise correlation, and the family's variance over views.

Counterparts of the JAX package's ``ops/reductions.py`` (reference:
rmvd/models/blocks/utils.py:51-88 and :271-274), on tensors of any layout:
the hypothesis or channel axis is an argument. bf16 inputs promote as in
JAX: ``groupwise_correlation`` of bf16 key features and float32 warped
features is float32.
"""

from __future__ import annotations

import torch


def soft_argmin(volume, axis, keepdims=False, window=None):
    """Softmax expectation of the hypothesis index along ``axis``.

    Returns (prob, expected_index) and, with ``window``, the probability
    mass within +-window of the expectation (reference: utils.py:51-64).
    """
    axis = axis % volume.dim()
    prob = torch.softmax(volume, dim=axis)
    shape = [volume.shape[axis] if i == axis else 1 for i in range(volume.dim())]
    index = torch.arange(volume.shape[axis], dtype=prob.dtype, device=prob.device).reshape(shape)
    out = torch.sum(index * prob, dim=axis, keepdim=True)
    out_sq = out if keepdims else out.squeeze(axis)
    if window is None:
        return prob, out_sq
    mask = (torch.abs(index - out) <= window).to(volume.dtype)
    return prob, out_sq, torch.sum(prob * mask, dim=axis, keepdim=keepdims)


def entropy(prob_volume, axis, keepdims=False):
    """Shannon entropy along ``axis``, log of p clamped to [1e-9, 1]

    (reference: utils.py:67-68)."""
    p = prob_volume.clamp(1e-9, 1.0)
    return torch.sum(-prob_volume * torch.log(p), dim=axis, keepdim=keepdims)


def groupwise_correlation(v1, v2, groups, axis):
    """Sum of channel products within each of ``groups`` channel groups

    (reference: utils.py:71-88; a sum, not a mean)."""
    axis = axis % v1.dim()
    c = v1.shape[axis]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")

    def regroup(v):
        return v.reshape(*v.shape[:axis], groups, c // groups, *v.shape[axis + 1 :])

    return torch.sum(regroup(v1) * regroup(v2), dim=axis + 1)


def depth_regression(prob, depth_values, axis=-1):
    """Expected depth under ``prob`` along ``axis``; depth_values (B, D) or

    broadcastable to the moved volume (reference: utils.py:271-274)."""
    prob_moved = torch.movedim(prob, axis, -1)
    while depth_values.dim() < prob_moved.dim():
        depth_values = depth_values[:, None]
    return torch.sum(prob_moved * depth_values, dim=-1)


def variance_over_views(ref_feat, warped_views, num_hypotheses):
    """``E[x^2] - E[x]^2`` over the key features, repeated over the
    hypotheses, and each warped source volume, from float32 running sums
    updated in place whatever the features' dtype (bf16 would cancel
    catastrophically): the JAX models' ``warp_impl="xla"`` routes.

    ref_feat: (B, H, W, C); warped_views: an iterable of (B, D, H, W, C)
    volumes, consumed one at a time, so one is live at once. Returns
    (B, D, H, W, C) float32."""
    B, H, W, C = ref_feat.shape
    ref = ref_feat.float()[:, None].expand(B, num_hypotheses, H, W, C)
    volume_sum, volume_sq = ref.clone(), ref * ref
    views = 1
    for warped in warped_views:
        warped = warped.float()
        volume_sum += warped
        volume_sq += warped * warped
        views += 1
    count = torch.tensor(float(views), device=ref_feat.device)  # a true division on the card
    return volume_sq / count - (volume_sum / count) ** 2
