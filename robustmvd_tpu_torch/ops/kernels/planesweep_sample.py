"""K1: bilinear sampling of per-pixel score images at S plane-sweep points.

The wrapper of ``csrc/planesweep_sample.cu``, which replaces the TPU
kernels ``ops/pallas/planesweep_sample.py::planesweep_sample`` (v1, f32
scores) and ``ops/pallas/planesweep_sample_v2.py::planesweep_sample_v2``
(v2, bf16 scores and bf16 row weights) of the JAX package. The kernel's
source note says what bounds it and how it is laid out.

For a CUDA tensor the wrapper launches the kernel or raises. For a CPU
tensor it computes the same function with :func:`planesweep_sample_reference`,
the plain torch version, which is also what the kernel is held against.

:func:`planesweep_sample_with_grad` is K1 as a ``torch.autograd.Function``
for training: its backward is K1b (``planesweep_sample_backward.py``) and
gives the score images their gradient; the coordinates get none, as in the
JAX package, where they depend on no parameter.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, work
from .planesweep_sample_backward import planesweep_sample_backward

_NAME = "planesweep_sample"


def planesweep_sample_flops(P, S):
    """K1's work: 12 flops a sample (P key pixels x S hypotheses), the same
    for both score dtypes: three two-tap blends (two products and a sum
    each), the weights' complements 1 - wy and 1 - wx, and the flat offset
    of the top-left tap."""
    return 12 * P * S


def planesweep_sample_reference(corr_img, y0, wy, x0, wx):
    """Plain torch K1: gather the four taps of each (p, s) with zeros padding.

    Same arguments and result as :func:`planesweep_sample`. The arithmetic
    follows the TPU kernels: the row interpolation first, then the column
    one; with bf16 scores the row weights are rounded to bf16 as in v2.
    """
    P, Hs, Ws = corr_img.shape
    bf16 = corr_img.dtype == torch.bfloat16
    flat = corr_img.reshape(P, Hs * Ws)
    ty, tx = y0.long(), x0.long()

    def tap(dy, dx):
        yi, xi = ty + dy, tx + dx
        valid = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
        idx = torch.where(valid, yi * Ws + xi, torch.zeros_like(yi))
        vals = torch.gather(flat, 1, idx).float()
        return torch.where(valid, vals, torch.zeros_like(vals))

    wy0, wy1 = 1.0 - wy, wy
    if bf16:
        wy0, wy1 = wy0.bfloat16().float(), wy1.bfloat16().float()
    m0 = wy0 * tap(0, 0) + wy1 * tap(1, 0)
    m1 = wy0 * tap(0, 1) + wy1 * tap(1, 1)
    return (1.0 - wx) * m0 + wx * m1


def _check(corr_img, y0, wy, x0, wx):
    if corr_img.dim() != 3:
        raise ValueError(f"corr_img must be (P, Hs, Ws), got {tuple(corr_img.shape)}")
    if corr_img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_img must be float32 or bfloat16, got {corr_img.dtype}")
    P = corr_img.shape[0]
    S = y0.shape[-1] if y0.dim() == 2 else -1
    for name, t, dtype in (("y0", y0, torch.int32), ("wy", wy, torch.float32),
                           ("x0", x0, torch.int32), ("wx", wx, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (P, S):
            raise ValueError(f"{name} must be (P, S) = ({P}, {S}), got {tuple(t.shape)}")
        if t.device != corr_img.device:
            raise ValueError(f"{name} is on {t.device}, corr_img on {corr_img.device}")


def planesweep_sample(corr_img, y0, wy, x0, wx):
    """Sample per-hypothesis bilinear scores from per-pixel score images.

    Args:
        corr_img: (P, Hs, Ws) float32 (v1) or bfloat16 (v2) score images.
        y0, x0: (P, S) int32 top-left tap indices; may lie out of range
            (zeros padding).
        wy, wx: (P, S) float32 fractional weights.

    Returns:
        (P, S) float32 samples, unmasked.
    """
    _check(corr_img, y0, wy, x0, wx)
    with work.kernel(_NAME, planesweep_sample_flops(*y0.shape)):
        if corr_img.device.type == "cpu":
            return planesweep_sample_reference(corr_img, y0, wy, x0, wx)
        if corr_img.device.type != "cuda":
            raise ValueError(f"planesweep_sample runs on cuda or cpu, not {corr_img.device}")
        return _launch(corr_img, y0, wy, x0, wx)


def _launch(corr_img, y0, wy, x0, wx):
    tensors = [t.contiguous() for t in (corr_img, y0, wy, x0, wx)]
    P, Hs, Ws = corr_img.shape
    S = y0.shape[1]
    out = torch.empty((P, S), dtype=torch.float32, device=corr_img.device)
    fn = _entry("planesweep_sample_bf16" if corr_img.dtype == torch.bfloat16 else "planesweep_sample_f32")
    with torch.cuda.device(corr_img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), P, S, Hs, Ws, stream)
    if err != 0:
        raise RuntimeError(f"planesweep_sample kernel launch failed: cudaError {err}")
    planesweep_sample.launches += 1
    planesweep_sample.launches_by_dtype[str(corr_img.dtype).removeprefix("torch.")] += 1
    return out


# every launch, and the launches of each instantiation by score dtype (float32:
# K1, the TPU's v1; bfloat16: K1 v2)
planesweep_sample.launches = 0
planesweep_sample.launches_by_dtype = {"float32": 0, "bfloat16": 0}


class _PlanesweepSample(torch.autograd.Function):
    """K1 forward, K1b backward. Saves only the taps: the (P, Hs, Ws) score
    images are not needed for the gradient and are not kept. The gradient
    has the score images' dtype (bf16 for K1 v2)."""

    @staticmethod
    def forward(ctx, corr_img, y0, wy, x0, wx):
        ctx.save_for_backward(y0, wy, x0, wx)
        ctx.score_shape = tuple(corr_img.shape[1:])
        ctx.score_dtype = corr_img.dtype
        return planesweep_sample(corr_img, y0, wy, x0, wx)

    @staticmethod
    def backward(ctx, grad):
        y0, wy, x0, wx = ctx.saved_tensors
        d_corr = None
        if ctx.needs_input_grad[0]:
            d_corr = planesweep_sample_backward(grad, y0, wy, x0, wx, *ctx.score_shape,
                                                dtype=ctx.score_dtype)
        return d_corr, None, None, None, None


def planesweep_sample_with_grad(corr_img, y0, wy, x0, wx):
    """:func:`planesweep_sample`, differentiable with respect to ``corr_img``
    (K1b on the card, the plain ``scatter_add_`` version on the CPU)."""
    return _PlanesweepSample.apply(corr_img, y0, wy, x0, wx)


def _entry(symbol):
    fn = getattr(build.load(_NAME), symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return fn
