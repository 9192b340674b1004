"""K1b: the backward of K1, the gradient of the sampled scores' images.

The wrapper of ``csrc/planesweep_sample_backward.cu``, a kernel with no TPU
counterpart: the JAX package differentiates its XLA correlation routes and
has no Pallas VJP of ``ops/pallas/planesweep_sample.py``. The kernel's
source note says what bounds it and how it is laid out.

For a CUDA tensor the wrapper launches the kernel or raises. For a CPU
tensor it computes the same function with
:func:`planesweep_sample_backward_reference`, the plain torch version
(``scatter_add_`` in float32, then a cast), which is also what the kernel is
held against. The kernel accumulates with atomics, so its sums are not
bit-exact. Its bf16 instantiation is the backward of K1 v2: the gradient of
bf16 score images, stored in bf16 from float32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, work

_NAME = "planesweep_sample_backward"


def planesweep_sample_backward_flops(P, S):
    """K1b's work: 10 flops a sample (P key pixels x S hypotheses), the same
    for both forms: the complements 1 - wx and 1 - wy, the gradient times
    the two column weights, those times the two row weights (the four tap
    gradients), and two flops for their adds into dS."""
    return 10 * P * S


def planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws, dtype=torch.float32):
    """Plain torch K1b: scatter each (p, s)'s four weighted taps into a dense

    (P, Hs, Ws) gradient, dropping taps out of range. Same arguments and
    result as :func:`planesweep_sample_backward`; the weights are formed as
    autograd forms them through ``planesweep_sample_reference`` (the column
    weight times the gradient first, then the row weight, rounded to bf16
    for bf16 scores as K1 v2 rounds it). The sums run in float32; the result
    is cast to ``dtype`` once.
    """
    P, S = grad.shape
    out = torch.zeros((P, Hs * Ws), dtype=torch.float32, device=grad.device)
    ty, tx = y0.long(), x0.long()
    g = grad.float()
    gx = (g * (1.0 - wx), g * wx)
    wys = (1.0 - wy, wy)
    if dtype == torch.bfloat16:
        wys = tuple(w.bfloat16().float() for w in wys)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = ty + dy, tx + dx
            valid = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
            idx = torch.where(valid, yi * Ws + xi, torch.zeros_like(yi))
            val = gx[dx] * wys[dy]
            out.scatter_add_(1, idx, torch.where(valid, val, torch.zeros_like(val)))
    return out.reshape(P, Hs, Ws).to(dtype)


def _check(grad, y0, wy, x0, wx, Hs, Ws, dtype):
    if grad.dim() != 2 or grad.dtype != torch.float32:
        raise ValueError(f"grad must be (P, S) float32, got {tuple(grad.shape)} {grad.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the score images' dtype must be float32 or bfloat16, got {dtype}")
    if Hs < 1 or Ws < 1:
        raise ValueError(f"score images must have a positive size, got ({Hs}, {Ws})")
    for name, t, tdtype in (("y0", y0, torch.int32), ("wy", wy, torch.float32),
                            ("x0", x0, torch.int32), ("wx", wx, torch.float32)):
        if t.dtype != tdtype:
            raise TypeError(f"{name} must be {tdtype}, got {t.dtype}")
        if t.shape != grad.shape:
            raise ValueError(f"{name} must be (P, S) = {tuple(grad.shape)}, got {tuple(t.shape)}")
        if t.device != grad.device:
            raise ValueError(f"{name} is on {t.device}, grad on {grad.device}")


def planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws, dtype=torch.float32):
    """The gradient of K1's (P, S) output with respect to its score images.

    Args:
        grad: (P, S) float32, the gradient of K1's output.
        y0, x0: (P, S) int32 top-left taps as K1 took them; may lie out of
            range (those taps get no gradient).
        wy, wx: (P, S) float32 fractional weights.
        Hs, Ws: the score images' size.
        dtype: the score images' dtype, float32 (K1) or bfloat16 (K1 v2,
            whose rounded row weights the gradient uses).

    Returns:
        (P, Hs, Ws) of ``dtype``, summed in float32.
    """
    _check(grad, y0, wy, x0, wx, Hs, Ws, dtype)
    with work.kernel(_NAME, planesweep_sample_backward_flops(*grad.shape)):
        if grad.device.type == "cpu":
            return planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws, dtype)
        if grad.device.type != "cuda":
            raise ValueError(f"planesweep_sample_backward runs on cuda or cpu, not {grad.device}")
        return _launch(grad, y0, wy, x0, wx, Hs, Ws, dtype)


def _launch(grad, y0, wy, x0, wx, Hs, Ws, dtype):
    tensors = [t.contiguous() for t in (grad, y0, wy, x0, wx)]
    P, S = grad.shape
    out = torch.empty((P, Hs, Ws), dtype=dtype, device=grad.device)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
        if dtype == torch.bfloat16:
            # the global route sums into a float32 scratch before its one rounding store
            scratch = (torch.empty((P, Hs, Ws), dtype=torch.float32, device=grad.device)
                       if planesweep_sample_backward_route(Hs, Ws) == "global" else None)
            err = _entry("planesweep_sample_backward_bf16")(
                *ptrs, None if scratch is None else scratch.data_ptr(), P, S, Hs, Ws, stream)
        else:
            err = _entry("planesweep_sample_backward")(*ptrs, P, S, Hs, Ws, stream)
    if err != 0:
        raise RuntimeError(f"planesweep_sample_backward kernel launch failed: cudaError {err}")
    planesweep_sample_backward.launches += 1
    planesweep_sample_backward.launches_by_dtype[str(dtype).removeprefix("torch.")] += 1
    return out


# every launch, and the launches of each instantiation by score dtype
planesweep_sample_backward.launches = 0
planesweep_sample_backward.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def planesweep_sample_backward_route(Hs, Ws):
    """Which route the kernel takes on the current card for (Hs, Ws) score
    images: "shared" (a block per row in shared memory) or "global"
    (memset + global atomics, for rows beyond the block's shared memory)."""
    fn = build.load(_NAME).planesweep_sample_backward_route
    fn.argtypes, fn.restype = [ctypes.c_int32, ctypes.c_int32], ctypes.c_int
    return ("shared", "global")[fn(Hs, Ws)]


def _entry(symbol):
    fn = getattr(build.load(_NAME), symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        pointers = 7 if symbol.endswith("_bf16") else 6  # the bf16 entry takes the scratch too
        fn.argtypes = [p] * pointers + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return fn
