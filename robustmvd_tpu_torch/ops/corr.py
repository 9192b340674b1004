"""Plane-sweep correlation: score matmul, then K1 samples the scores.

Semantics (the reference's ``PlanesweepCorrelation`` + ``TorchCorr``,
rmvd/models/blocks/planesweep_corr.py:143-195,371-521): for every key pixel
p and inverse-depth hypothesis s, correlate the key feature vector with the
source feature map bilinearly sampled at the epipolar point; zero out
samples whose four taps are not all inside the source image, or that lie
behind either camera.

The port takes the route of the JAX package's ``corr_impl="pallas"``
(``ops/corr.py::_corr_matmul(use_pallas=True)`` with ``_finish_corr``), in
the same order:

1. the all-pairs scores ``ref (HW, C) @ src^T (C, HsWs) / sqrt(C)`` in fp32,
   a plain large product left to ``torch.matmul``;
2. the tap coordinates ``x0, y0, wx, wy`` from :func:`planesweep_points`;
3. K1 (``ops/kernels/planesweep_sample.py``) samples each pixel's score
   image at its S points; under autograd its backward is K1b, which gives
   the scores their gradient, and ``torch.matmul``'s own backward takes it
   on to both feature maps (the coordinates get none);
4. the all-taps-in-bounds mask (``wsum >= 0.9999``) and the visibility mask.

Source views run one after another, so only one (HW, HsWs) score matrix is
alive at a time (about 1.2 GB at DTU's 896x1216). Under autograd no score
matrix is kept for the backward: the product saves its two inputs and K1
only its taps. So the port keeps what the JAX package's ``jax.checkpoint``
of the per-view correlation buys without recomputing it, and robust_mvd's
``remat`` leaves the correlation out.

Features may be float32 or bfloat16 (robust_mvd's ``dtype="bfloat16"``).
With bf16 features the score product runs on bf16 operands (cuBLAS sums in
float32 and rounds once to bf16) and is then scaled in bf16. The JAX
package instead scales the float32 product and then rounds it; at
robust_mvd's C = 256 the scale is 1/16, a power of two, so both orders give
the same bits outside the subnormal range. K1 v2, the bf16 instantiation,
samples the bf16 scores with bf16 row weights; corrs and masks come out in
the feature dtype, as in JAX's ``_finish_corr``. Of the JAX routes, bf16
matches ``corr_impl="pixelscan"`` (the default) and ``"matmul"``, which
both sample bf16 scores; ``"pallas"`` samples float32 scores even for bf16
features (its v1 kernel), so it is not this route's reference at bf16.

Layouts are the JAX package's: features (B, H, W, C), correlation volumes
and masks (B, V, H, W, S).
"""

from __future__ import annotations

import math

import torch

from .epipolar import make_epipolar_coeffs, planesweep_points, sampling_invdepths
from .kernels.planesweep_sample import planesweep_sample_with_grad

# The port computes one correlation function at each compute dtype, the route
# above; it goes by the name of the JAX route that computes it at both.
CORR_IMPL = "matmul"
# JAX's corr_impl names (robustmvd_tpu/ops/corr.py::planesweep_correlation_single)
# that compute the port's function, by compute dtype: at float32 every route
# that samples float32 scores ("pixelscan" within its epipole tolerance); at
# bf16 the routes that sample bf16 scores (bf16 features imply bf16 sampling
# in "pixelscan" and "matmul", so their "_bf16" forms are the same routes).
CORR_TAKEN = {
    "float32": ("pixelscan", "matmul", "pallas", "gather"),
    "bfloat16": ("pixelscan", "matmul", "pixelscan_bf16", "matmul_bf16"),
}
# what each of the others computes instead
CORR_REFUSED = {
    ("float32", "pixelscan_bf16"): "samples the float32 features' scores at bf16",
    ("float32", "matmul_bf16"): "samples the float32 features' scores at bf16",
    ("bfloat16", "pallas"): "samples float32 scores of bf16 features (its v1 kernel)",
    ("bfloat16", "gather"): "weights the taps of bf16-rounded feature products at float32",
}
_PORT_FUNCTION = {"float32": "float32 scores sampled at float32 (K1)",
                  "bfloat16": "the score product rounded to bf16 and sampled at bf16 (K1 v2)"}


def corr_impl_of(name, dtype="float32"):
    """The port's correlation route (``CORR_IMPL``) for a JAX ``corr_impl``
    name at the compute ``dtype`` ("float32", "bfloat16" or "bf16", or a
    torch dtype); a name whose JAX route computes another function there is
    refused, with what the port computes instead."""
    dtype = str(dtype).removeprefix("torch.")
    dtype = {"bf16": "bfloat16"}.get(dtype, dtype)
    if dtype not in CORR_TAKEN:
        raise ValueError(f"the correlation computes in float32 or bfloat16, not {dtype!r}")
    if name in CORR_TAKEN[dtype]:
        return CORR_IMPL
    if (dtype, name) in CORR_REFUSED:
        raise ValueError(f"corr_impl={name!r} at {dtype} {CORR_REFUSED[dtype, name]}; the port computes "
                         f"{_PORT_FUNCTION[dtype]}, JAX's {', '.join(map(repr, CORR_TAKEN[dtype]))} at {dtype}")
    raise ValueError(f"unknown corr_impl {name!r}: expected one of "
                     f"{sorted(set(CORR_TAKEN['float32'] + CORR_TAKEN['bfloat16']))}")


def tap_coordinates(us, vs):
    """(B, S, H, W) pixel-center coordinates -> top-left taps and fractions,

    each (B, H*W, S): x0, y0 int32 and wx, wy float32.
    """
    B, S, H, W = us.shape
    x = us.permute(0, 2, 3, 1).reshape(B, H * W, S) - 0.5
    y = vs.permute(0, 2, 3, 1).reshape(B, H * W, S) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    # Coordinates beyond +-2^30 lie far outside any image; clamping them
    # keeps the int32 cast defined without moving any tap into range.
    lim = float(2**30)
    x0i = x0.clamp(-lim, lim).to(torch.int32)
    y0i = y0.clamp(-lim, lim).to(torch.int32)
    return x0i, y0i, x - x0, y - y0


def finish_corr(out, vis, x0, y0, wx, wy, Hs, Ws, dtype):
    """Apply the all-taps-in-bounds and visibility masks.

    out, x0, y0, wx, wy: (B, HW, S); vis: (B, S, H, W) bool.
    Returns corr, mask: (B, H, W, S) of ``dtype``, the features' dtype
    (``_finish_corr`` rules).
    """
    B, S, H, W = vis.shape
    x0, y0 = x0.long(), y0.long()

    def tap_valid(dy, dx):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= Ws - 1) & (yi >= 0) & (yi <= Hs - 1)
        wxx = wx if dx == 1 else (1.0 - wx)
        wyy = wy if dy == 1 else (1.0 - wy)
        return wxx * wyy * valid.float()

    wsum = tap_valid(0, 0) + tap_valid(0, 1) + tap_valid(1, 0) + tap_valid(1, 1)
    in_bounds = (wsum >= 0.9999).to(dtype)
    vis = vis.permute(0, 2, 3, 1).reshape(B, H * W, S).to(dtype)
    mask = in_bounds * vis
    corr = out.to(dtype) * mask
    return corr.reshape(B, H, W, S), mask.reshape(B, H, W, S)


def planesweep_correlation_single(feat_key, feat_src, intrinsics_key, intrinsics_src,
                                  key_to_source_transform, invdepths):
    """Correlation volume for one source view.

    Args:
        feat_key: (B, H, W, C); feat_src: (B, Hs, Ws, C), float32 or bfloat16.
        intrinsics_key, intrinsics_src: (B, 3, 3) relative intrinsics.
        key_to_source_transform: (B, 4, 4).
        invdepths: (B, S).

    Returns:
        corr, mask: (B, H, W, S) in the features' dtype.
    """
    B, H, W, C = feat_key.shape
    Hs, Ws = feat_src.shape[1], feat_src.shape[2]
    coeffs = make_epipolar_coeffs(intrinsics_key, intrinsics_src, key_to_source_transform,
                                  height=H, width=W, height_source=Hs, width_source=Ws)
    us, vs, vis = planesweep_points(coeffs, invdepths)
    S = us.shape[1]

    # scaled in place: the (B, HW, HsWs) score matrix is the largest buffer
    scores = torch.matmul(feat_key.reshape(B, H * W, C), feat_src.reshape(B, Hs * Ws, C).transpose(1, 2))
    scores.mul_(1.0 / math.sqrt(C))
    x0, y0, wx, wy = tap_coordinates(us, vs)
    out = planesweep_sample_with_grad(scores.reshape(B * H * W, Hs, Ws), y0.reshape(-1, S),
                                      wy.reshape(-1, S), x0.reshape(-1, S), wx.reshape(-1, S))
    return finish_corr(out.reshape(B, H * W, S), vis, x0, y0, wx, wy, Hs, Ws, feat_key.dtype)


def planesweep_correlation(feat_key, feat_sources, intrinsics_key, intrinsics_sources,
                           key_to_source_transforms, num_sampling_points=None,
                           min_depth=None, max_depth=None, invdepths=None,
                           sampling_type="linear_invdepth"):
    """Correlation volumes over all source views.

    Args:
        feat_key: (B, H, W, C); feat_sources: (B, V, Hs, Ws, C).
        intrinsics_key: (B, 3, 3); intrinsics_sources: (B, V, 3, 3) or None
            (key intrinsics reused, reference: planesweep_corr.py:441-442).
        key_to_source_transforms: (B, V, 4, 4).
        num_sampling_points / min_depth / max_depth, or explicit invdepths
            (B, S) (reference: planesweep_corr.py:464-487).

    Returns:
        corrs, masks: (B, V, H, W, S); invdepths: (B, S). With no source
        view (V = 0, an empty share of a view axis) they are empty and K1 is
        not launched.
    """
    B, V = feat_sources.shape[:2]
    if invdepths is None:
        if min_depth is None or max_depth is None or num_sampling_points is None:
            raise ValueError("pass invdepths, or num_sampling_points with min_depth and max_depth")
        invdepths = sampling_invdepths(min_depth, max_depth, num_sampling_points,
                                       sampling_type, device=feat_key.device)
        invdepths = invdepths.expand(B, invdepths.shape[-1])
    if intrinsics_sources is None:
        intrinsics_sources = intrinsics_key[:, None].expand(B, V, 3, 3)

    if V == 0:
        empty = feat_key.new_zeros((B, 0) + feat_key.shape[1:3] + invdepths.shape[-1:])
        return empty, empty, invdepths
    corrs, masks = [], []
    for v in range(V):
        corr, mask = planesweep_correlation_single(
            feat_key, feat_sources[:, v], intrinsics_key, intrinsics_sources[:, v],
            key_to_source_transforms[:, v], invdepths)
        corrs.append(corr)
        masks.append(mask)
    return torch.stack(corrs, 1), torch.stack(masks, 1), invdepths
