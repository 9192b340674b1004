"""K3: fused soft-argmin readout of a score volume.

The wrapper of ``csrc/soft_argmin.cu``, which replaces the TPU kernel
``ops/pallas/softargmin.py::fused_soft_argmin`` of the JAX package: softmax
over the hypothesis axis, the expected index, the entropy and the
probability mass within +-window of the expectation, in one kernel. The JAX
function's ``tile`` and ``interpret`` arguments set the TPU kernel's tiling
and are not taken.

For a CUDA tensor :func:`fused_soft_argmin` launches the kernel or raises.
For a CPU tensor it computes the same function with
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
    B, D, H, W = volume.shape
    volume = volume.contiguous()
    prob = torch.empty_like(volume)
    maps = torch.empty((3, B, 1, H, W), dtype=torch.float32, device=volume.device)
    fn = _entry()
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(volume.data_ptr(), prob.data_ptr(), maps[0].data_ptr(), maps[1].data_ptr(), maps[2].data_ptr(),
                 B, D, H * W, float(window), stream)
    if err != 0:
        raise RuntimeError(f"soft_argmin kernel launch failed: cudaError {err}")
    fused_soft_argmin.launches += 1
    return prob, maps[0], maps[1], maps[2]


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
