"""K5: 3x3x3 stride-1 pad-1 convolution.

The wrapper of ``csrc/conv3d_banded.cu``, which replaces the TPU kernel
``ops/pallas/conv3d.py::conv3d_banded_pallas`` of the JAX package, the
Pallas form of its lane-packed conv (``conv3d_impl="banded"``/``"packed"``,
``ops/conv3d.py::conv3d_packed``). The function is the TPU kernel's:
``lax.conv_general_dilated(x, k, (1, 1, 1), ((1, 1),) * 3)`` in the JAX
layouts (NDHWC input, DHWIO kernel), with float32 accumulation and an
optional bias added after the sum (the JAX blocks add it after the conv).
``channels_first=True`` takes and gives NCDHW volumes instead, the port's
U-Net layout: the kernel reads and writes through element strides, so
neither layout pays a permute. The JAX function's ``tile``, ``block_d`` and
``interpret`` arguments set the TPU kernel's tiling and are not taken.

For a CUDA tensor :func:`conv3d_banded` launches the kernel (float32) or
raises, as a ``torch.autograd.Function`` whose backward is
``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` (the JAX VJP
differentiates the XLA conv; there is no backward kernel). For a CPU tensor
it computes the same function with :func:`conv3d_banded_reference`, the
plain torch version (27 shifted taps, each a channel contraction, summed in
float32), which is also what the kernel is held against. On the card,
more than 4 output channels run on the tensor cores (TF32 products in the
3xTF32 split, float32-accurate), the score heads on the CUDA cores; the
kernel's source note says what bounds each.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_NAME = "conv3d_banded"


def conv3d_banded_reference(x, kernel, bias=None):
    """Plain torch K5 on NDHWC ``x`` and a DHWIO ``kernel``; out in x's dtype."""
    B, D, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    out = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                term = torch.matmul(xp[:, dz : dz + D, dy : dy + H, dx : dx + W], kernel[dz, dy, dx].float())
                out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _check(x, kernel, bias, channels_first):
    if x.dim() != 5:
        raise ValueError(f"x must be a 5D volume, got {tuple(x.shape)}")
    cin = x.shape[1] if channels_first else x.shape[4]
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[4],):
        raise ValueError(f"bias must be ({kernel.shape[4]},), got {tuple(bias.shape)}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def conv3d_banded(x, kernel, bias=None, channels_first=False):
    """3x3x3 stride-1 pad-1 convolution.

    Args:
        x: (B, D, H, W, Cin), or (B, Cin, D, H, W) with ``channels_first``.
        kernel: (3, 3, 3, Cin, Cout), any strides (an ``nn.Conv3d`` weight
            as ``weight.permute(2, 3, 4, 1, 0)``).
        bias: (Cout,) or None.

    Returns:
        (B, D, H, W, Cout), or (B, Cout, D, H, W) with ``channels_first``,
        in x's dtype (float32 on the card).
    """
    _check(x, kernel, bias, channels_first)
    if x.device.type == "cpu":
        if not channels_first:
            return conv3d_banded_reference(x, kernel, bias)
        return conv3d_banded_reference(x.movedim(1, -1), kernel, bias).movedim(-1, 1).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_banded runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    return _Conv3dK5.apply(x, kernel, bias, channels_first)


conv3d_banded.launches = 0


def conv3d_banded_path(cout):
    """The kernel's route for ``cout`` output channels, as its C entry takes
    it: ``"cuda_cores"`` (the score heads) or ``"tf32x3_mma"`` (the tensor
    cores). Builds the kernel if it is not built."""
    fn = build.load(_NAME).conv3d_banded_route
    fn.argtypes, fn.restype = [ctypes.c_int32], ctypes.c_int
    return "tf32x3_mma" if fn(cout) else "cuda_cores"


def _axes(t, channels_first):
    """(B, C, D, H, W) sizes and element strides of a volume in either layout."""
    order = (0, 1, 2, 3, 4) if channels_first else (0, 4, 1, 2, 3)
    return [t.shape[a] for a in order], [t.stride(a) for a in order]


def _launch(x, kernel, bias, channels_first):
    (B, Cin, D, H, W), xs = _axes(x, channels_first)
    Cout = kernel.shape[4]
    shape = (B, Cout, D, H, W) if channels_first else (B, D, H, W, Cout)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _, os_ = _axes(out, channels_first)
    strides = [(ctypes.c_int64 * 5)(*s) for s in (xs, kernel.stride(), os_)]
    bias = bias.contiguous() if bias is not None else None
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), strides[0], kernel.data_ptr(), strides[1], bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), strides[2], B, Cin, Cout, D, H, W, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_banded kernel launch failed: cudaError {err}")
    conv3d_banded.launches += 1
    return out


class _Conv3dK5(torch.autograd.Function):
    """K5 forward; backward through ``torch.nn.grad`` (cuDNN), as the JAX VJP
    differentiates the XLA conv."""

    @staticmethod
    def forward(ctx, x, kernel, bias, channels_first):
        ctx.save_for_backward(x, kernel)
        ctx.channels_first = channels_first
        ctx.has_bias = bias is not None
        return _launch(x, kernel, bias, channels_first)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        cf = ctx.channels_first
        x_c, g_c = (x, grad) if cf else (x.movedim(-1, 1), grad.movedim(-1, 1))
        weight = kernel.permute(4, 3, 0, 1, 2)  # (Cout, Cin, 3, 3, 3)
        gx = gk = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x_c.shape, weight, g_c, padding=1)
            gx = gx if cf else gx.movedim(1, -1)
        if ctx.needs_input_grad[1]:
            gk = torch.nn.grad.conv3d_weight(x_c, weight.shape, g_c, padding=1).permute(2, 3, 4, 1, 0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g_c.sum(dim=(0, 2, 3, 4))
        return gx, gk, gb, None


def _entry():
    fn = build.load(_NAME).conv3d_banded
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
