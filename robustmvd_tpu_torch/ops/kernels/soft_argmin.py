"""K3: fused soft-argmin readout of a score volume.

The wrapper of ``csrc/soft_argmin.cu``, which replaces the TPU kernel
``ops/pallas/softargmin.py::fused_soft_argmin`` of the JAX package: softmax
over the hypothesis axis, the expected index, the entropy and the
probability mass within +-window of the expectation, in one kernel. The JAX
function's ``tile`` and ``interpret`` arguments set the TPU kernel's tiling
and are not taken.

For a CUDA tensor :func:`fused_soft_argmin` launches the kernel or raises,
as a ``torch.autograd.Function`` whose backward is the closed-form gradient
of the four results in torch ops (:func:`soft_argmin_backward`), the
gradient the JAX package takes through its XLA ``soft_argmin`` and
``entropy``; no kernel runs backward, and the backward does not call the
plain version. For a CPU tensor it computes the same function with
:func:`fused_soft_argmin_reference`, the plain torch version (the math of
the JAX ``fused_soft_argmin_reference``: ``ops/reductions.py``'s
``soft_argmin`` and ``entropy``), which is also what the kernel is held
against. The kernel's source note says what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from ..reductions import entropy, soft_argmin
from . import build

_NAME = "soft_argmin"


def fused_soft_argmin_reference(volume, window=2):
    """Plain torch K3; arguments and results as :func:`fused_soft_argmin`."""
    prob, expectation, mass = soft_argmin(volume, axis=1, keepdims=True, window=window)
    return prob, expectation, entropy(prob, axis=1, keepdims=True), mass


def fused_soft_argmin(volume, window=2):
    """Softmax over D, index expectation, entropy and windowed mass.

    Args:
        volume: (B, D, H, W) float32 score volume.
        window: the index window of the probability mass.

    Returns:
        prob (B, D, H, W), expectation (B, 1, H, W), entropy (B, 1, H, W),
        prob_map (B, 1, H, W): the mass within +-window of the expectation.
    """
    if volume.dim() != 4:
        raise ValueError(f"volume must be (B, D, H, W), got {tuple(volume.shape)}")
    if volume.dtype != torch.float32:
        raise TypeError(f"volume must be float32, got {volume.dtype}")
    if volume.device.type == "cpu":
        return fused_soft_argmin_reference(volume, window)
    if volume.device.type != "cuda":
        raise ValueError(f"soft_argmin runs on cuda or cpu, not {volume.device}")
    return _SoftArgmin.apply(volume.contiguous(), float(window))


def _launch(volume, window):
    B, D, H, W = volume.shape
    prob = torch.empty_like(volume)
    maps = [torch.empty((B, 1, H, W), dtype=torch.float32, device=volume.device) for _ in range(3)]
    fn = _entry()
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(volume.data_ptr(), prob.data_ptr(), *(m.data_ptr() for m in maps), B, D, H * W, window, stream)
    if err != 0:
        raise RuntimeError(f"soft_argmin kernel launch failed: cudaError {err}")
    fused_soft_argmin.launches += 1
    return (prob, *maps)


def soft_argmin_backward(prob, expectation, window, g_prob, g_expectation, g_entropy, g_mass):
    """The score volume's gradient from the results' gradients (any of them
    None), in closed form: with d the hypothesis index,
    ``g_p = g_prob + g_E d + g_H (-log clip(p, 1e-9, 1) - [1e-9 <= p <= 1])
    + g_M [|d - E| <= window]``, then through the softmax
    ``g_s = p (g_p - sum_d p g_p)``. The window mask is a step function of
    E and passes no gradient. prob (B, D, H, W); the rest (B, 1, H, W)."""
    g_p = torch.zeros_like(prob) if g_prob is None else g_prob.clone()
    index = None
    if g_expectation is not None or g_mass is not None:
        index = torch.arange(prob.shape[1], dtype=prob.dtype, device=prob.device).reshape(1, -1, 1, 1)
    if g_expectation is not None:
        g_p += g_expectation * index
    if g_entropy is not None:
        inside = ((prob >= 1e-9) & (prob <= 1.0)).to(prob.dtype)
        g_p -= g_entropy * (torch.log(prob.clamp(1e-9, 1.0)) + inside)
    if g_mass is not None:
        g_p += g_mass * (torch.abs(index - expectation) <= window).to(prob.dtype)
    return prob * (g_p - (prob * g_p).sum(dim=1, keepdim=True))


class _SoftArgmin(torch.autograd.Function):
    """K3 forward; backward :func:`soft_argmin_backward`, in torch ops."""

    @staticmethod
    def forward(ctx, volume, window):
        out = _launch(volume, window)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out[0], out[1])
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, g_prob, g_expectation, g_entropy, g_mass):
        prob, expectation = ctx.saved_tensors
        grad = soft_argmin_backward(prob, expectation, ctx.window, g_prob, g_expectation, g_entropy, g_mass)
        return grad, None


fused_soft_argmin.launches = 0


def soft_argmin_route(D):
    """The kernel's route for ``D`` hypotheses, as its C entry takes it:
    ``"registers"`` (compile-time D, each pixel's column in registers) or
    ``"generic"`` (four passes over D). Builds the kernel if it is not
    built."""
    fn = build.load(_NAME).soft_argmin_route
    fn.argtypes, fn.restype = [ctypes.c_int32], ctypes.c_int
    return "registers" if fn(D) else "generic"


def _entry():
    fn = build.load(_NAME).soft_argmin
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn
