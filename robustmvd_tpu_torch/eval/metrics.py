"""Evaluation metrics (reference: rmvd/eval/metrics.py), the JAX package's.

Numpy host-side metrics with the reference's edge-case semantics:
- ``thresh_inliers``: max(gt/pred, pred/gt) < thresh, pred=0 counted as
  outlier (reference :32-70);
- ``m_rel_ae``: mean |pred-gt|/gt over valid pixels, x100 scaling
  (reference :73-103);
- ``sparsification``: remove pixels in order of decreasing uncertainty and
  track the error ratio of the remainder. The reference walks pixels in a
  Python loop recomputing the masked error per step (:138-220, O(N^2));
  here the identical curve is computed with a suffix-sum over the
  uncertainty ranking (O(N log N)) — same steps, same interpolation onto
  100 points.
"""

from __future__ import annotations

import numpy as np


def valid_mean(arr, mask, axis=None, keepdims=False):
    """Masked mean + validity flag (reference: metrics.py:6-29)."""
    mask = mask.astype(arr.dtype) if mask.dtype == bool else mask
    num_valid = np.sum(mask, axis=axis, keepdims=keepdims)
    masked_sum = np.sum(arr * mask, axis=axis, keepdims=keepdims)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = masked_sum / num_valid
        is_valid = np.isfinite(mean)
        mean = np.nan_to_num(mean, nan=0, posinf=0, neginf=0)
    return mean, is_valid


def thresh_inliers(gt, pred, thresh, mask=None, output_scaling_factor=1.0):
    """Inlier ratio at a relative threshold; NaN when invalid."""
    mask = (gt > 0).astype(np.float32) * mask if mask is not None else (gt > 0).astype(np.float32)

    with np.errstate(divide="ignore", invalid="ignore"):
        rel_1 = np.nan_to_num(gt / pred, nan=thresh + 1, posinf=thresh + 1, neginf=thresh + 1)
        rel_2 = np.nan_to_num(pred / gt, nan=0, posinf=0, neginf=0)

    max_rel = np.maximum(rel_1, rel_2)
    inliers = ((0 < max_rel) & (max_rel < thresh)).astype(np.float32)

    ratio, valid = valid_mean(inliers, mask)
    ratio = ratio * output_scaling_factor
    return ratio if valid else np.nan


def m_rel_ae(gt, pred, mask=None, output_scaling_factor=1.0):
    """Mean relative absolute error; NaN when invalid."""
    mask = (gt > 0).astype(np.float32) * mask if mask is not None else (gt > 0).astype(np.float32)

    ae = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(ae / gt, nan=0, posinf=0, neginf=0)

    mean, valid = valid_mean(rel_ae, mask)
    mean = mean * output_scaling_factor
    return mean if valid else np.nan


def pointwise_rel_ae(gt, pred, mask=None, output_scaling_factor=1.0):
    """Per-pixel relative absolute error, masked to valid gt."""
    mask = (gt > 0).astype(np.float32) * mask if mask is not None else (gt > 0).astype(np.float32)
    ae = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(ae / gt, nan=0, posinf=0, neginf=0)
    return rel_ae * mask * output_scaling_factor


def sparsification(gt, pred, uncertainty, mask=None, error_fct=m_rel_ae, **_):
    """Sparsification curve as (100,) values over removal fractions

    linspace(0, 0.99, 100); NaN curve when undefined. Matches the
    reference's per-pixel loop output exactly for the default
    ``error_fct=m_rel_ae`` (suffix-sum formulation of the same quantity).

    Returns (x, curve): removal fractions and error ratios.
    """
    mask = (gt > 0).astype(np.float32) * mask if mask is not None else (gt > 0).astype(np.float32)
    valid = mask.astype(bool)
    num_valid = int(valid.sum())
    x = np.linspace(0, 0.99, 100)

    if num_valid == 0:
        return x, np.full(100, np.nan)

    ae = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(ae / gt, nan=0, posinf=0, neginf=0)

    # ranking identical to the reference (:171-176): stable argsort of
    # (uncertainty - min + 1) * mask ascending, then reversed.
    key = (uncertainty - uncertainty.min() + 1) * mask
    order = np.argsort(key, axis=None, kind="stable")[::-1][:num_valid]
    errs = rel_ae.ravel()[order]  # most-uncertain first

    # error of the remainder after removing the first k pixels
    suffix_sum = np.concatenate([np.cumsum(errs[::-1])[::-1], [0.0]])
    remaining = num_valid - np.arange(num_valid + 1)

    base_error = suffix_sum[0] / num_valid
    steps = np.unique([int((num_valid / 100) * i) for i in range(100)])
    steps = steps[steps < num_valid]

    with np.errstate(divide="ignore", invalid="ignore"):
        cur_errors = suffix_sum[steps] / remaining[steps]
        fracs = steps / num_valid
        ratios = cur_errors / base_error

    finite = np.isfinite(cur_errors)
    fracs, ratios = fracs[finite], ratios[finite]

    if len(fracs) > 1:
        curve = np.interp(x, fracs, ratios)
    else:
        curve = np.full(100, np.nan)
    return x, curve


def ause(gt, pred, uncertainty, mask=None):
    """Area between the prediction-ranked and oracle-ranked sparsification

    curves (reference: multi_view_depth_evaluation.py:616-655):
    oracle ranking uses the pointwise error itself as "uncertainty";
    AUSE = sum(pred_curve - oracle_curve) / 100.
    """
    _, curve_pred = sparsification(gt, pred, uncertainty, mask)
    ae = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(ae / gt, nan=0, posinf=0, neginf=0)
    _, curve_oracle = sparsification(gt, pred, rel_ae, mask)
    if np.all(np.isnan(curve_pred)) or np.all(np.isnan(curve_oracle)):
        return np.nan, curve_pred, curve_oracle
    return float(np.nansum(curve_pred - curve_oracle) / 100.0), curve_pred, curve_oracle
