"""K1b: the backward of K1, the gradient of the sampled scores' images.

The wrapper of ``csrc/planesweep_sample_backward.cu``, a kernel with no TPU
counterpart: the JAX package differentiates its XLA correlation routes and
has no Pallas VJP of ``ops/pallas/planesweep_sample.py``. The kernel's
source note says what bounds it and how it is laid out.

For a CUDA tensor the wrapper launches the kernel or raises. For a CPU
tensor it computes the same function with
:func:`planesweep_sample_backward_reference`, the plain torch version
(``scatter_add_``), which is also what the kernel is held against. The
kernel accumulates with atomics, so its sums are not bit-exact.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "planesweep_sample_backward"


def planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws):
    """Plain torch K1b: scatter each (p, s)'s four weighted taps into a dense

    (P, Hs, Ws) float32 gradient, dropping taps out of range. Same arguments
    and result as :func:`planesweep_sample_backward`; the weights are formed
    as autograd forms them through ``planesweep_sample_reference`` (the
    column weight times the gradient first, then the row weight).
    """
    P, S = grad.shape
    out = torch.zeros((P, Hs * Ws), dtype=torch.float32, device=grad.device)
    ty, tx = y0.long(), x0.long()
    g = grad.float()
    gx = (g * (1.0 - wx), g * wx)
    wys = (1.0 - wy, wy)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = ty + dy, tx + dx
            valid = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
            idx = torch.where(valid, yi * Ws + xi, torch.zeros_like(yi))
            val = gx[dx] * wys[dy]
            out.scatter_add_(1, idx, torch.where(valid, val, torch.zeros_like(val)))
    return out.reshape(P, Hs, Ws)


def _check(grad, y0, wy, x0, wx, Hs, Ws):
    if grad.dim() != 2 or grad.dtype != torch.float32:
        raise ValueError(f"grad must be (P, S) float32, got {tuple(grad.shape)} {grad.dtype}")
    if Hs < 1 or Ws < 1:
        raise ValueError(f"score images must have a positive size, got ({Hs}, {Ws})")
    for name, t, dtype in (("y0", y0, torch.int32), ("wy", wy, torch.float32),
                           ("x0", x0, torch.int32), ("wx", wx, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != grad.shape:
            raise ValueError(f"{name} must be (P, S) = {tuple(grad.shape)}, got {tuple(t.shape)}")
        if t.device != grad.device:
            raise ValueError(f"{name} is on {t.device}, grad on {grad.device}")


def planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws):
    """The gradient of K1's (P, S) output with respect to its score images.

    Args:
        grad: (P, S) float32, the gradient of K1's output.
        y0, x0: (P, S) int32 top-left taps as K1 took them; may lie out of
            range (those taps get no gradient).
        wy, wx: (P, S) float32 fractional weights.
        Hs, Ws: the score images' size.

    Returns:
        (P, Hs, Ws) float32.
    """
    _check(grad, y0, wy, x0, wx, Hs, Ws)
    if grad.device.type == "cpu":
        return planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws)
    if grad.device.type != "cuda":
        raise ValueError(f"planesweep_sample_backward runs on cuda or cpu, not {grad.device}")
    tensors = [t.contiguous() for t in (grad, y0, wy, x0, wx)]
    P, S = grad.shape
    out = torch.empty((P, Hs, Ws), dtype=torch.float32, device=grad.device)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(*(t.data_ptr() for t in tensors), out.data_ptr(), P, S, Hs, Ws, stream)
    if err != 0:
        raise RuntimeError(f"planesweep_sample_backward kernel launch failed: cudaError {err}")
    planesweep_sample_backward.launches += 1
    return out


planesweep_sample_backward.launches = 0


def planesweep_sample_backward_route(Hs, Ws):
    """Which route the kernel takes on the current card for (Hs, Ws) score
    images: "shared" (a block per row in shared memory) or "global"
    (memset + global atomics, for rows beyond the block's shared memory)."""
    fn = build.load(_NAME).planesweep_sample_backward_route
    fn.argtypes, fn.restype = [ctypes.c_int32, ctypes.c_int32], ctypes.c_int
    return ("shared", "global")[fn(Hs, Ws)]


def _entry():
    fn = build.load(_NAME).planesweep_sample_backward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return fn
