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

Like the TPU kernel, K5 works in its input's dtype: float32, or bfloat16
for more than 4 output channels. A bf16 ``x`` takes a bf16 or float32
kernel, which is cast once to bf16 (JAX ``_kron_band(...).astype(x.dtype)``),
sums in float32, adds the bias in float32 and rounds once to bf16. The score
heads (Cout <= 4) are float32 only, as the JAX family's heads are: a bf16
head raises ``TypeError`` on either device.

For a CUDA tensor :func:`conv3d_banded` launches the kernel or raises, as a
``torch.autograd.Function`` whose backward is ``torch.nn.grad.conv3d_input``
/ ``conv3d_weight`` in the output's dtype (the JAX VJP differentiates the
XLA conv; there is no backward kernel). For a CPU tensor it computes the same
function with :func:`conv3d_banded_reference`, the plain torch version (27
shifted taps, each a channel contraction, summed in float32 over operands in
x's dtype), which is also what the kernel is held against. On the card,
more than 4 output channels run on the tensor cores (float32: TF32 products
in the 3xTF32 split, float32-accurate; bf16: one bf16 mma per product, on
weights the wrapper lays out by (dz, dy, dx, o, i) in the one copy that
casts them), the score heads on the CUDA cores; the kernel's source note
says what bounds each. Launches are counted in all and by x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, work

_NAME = "conv3d_banded"
# the C entry of each form by x's dtype
_FORMS = {torch.float32: "conv3d_banded", torch.bfloat16: "conv3d_banded_bf16"}


def conv3d_banded_flops(B, D, H, W, cin, cout, bias=False):
    """K5's work: 54 Cin Cout flops an output voxel (27 taps, a product and
    a sum each), and one more a channel for a bias; the same for both
    forms."""
    return B * D * H * W * cout * (54 * cin + (1 if bias else 0))


def conv3d_banded_reference(x, kernel, bias=None):
    """Plain torch K5 on NDHWC ``x`` and a DHWIO ``kernel``: the kernel
    rounded to x's dtype, products and sums in float32, the bias added in
    float32, the result rounded once to x's dtype."""
    B, D, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    kernel = kernel.to(x.dtype).float()
    out = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                term = torch.matmul(xp[:, dz : dz + D, dy : dy + H, dx : dx + W], kernel[dz, dy, dx])
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
    if x.dtype not in _FORMS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16 and kernel.shape[4] <= 4:
        raise TypeError(f"a score head ({kernel.shape[4]} output channels) runs in float32, not {x.dtype}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t is not None and t.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name} must be float32 or {x.dtype}, got {t.dtype}")


def conv3d_banded(x, kernel, bias=None, channels_first=False):
    """3x3x3 stride-1 pad-1 convolution.

    Args:
        x: (B, D, H, W, Cin), or (B, Cin, D, H, W) with ``channels_first``;
            float32, or bfloat16 for Cout > 4.
        kernel: (3, 3, 3, Cin, Cout), any strides (an ``nn.Conv3d`` weight
            as ``weight.permute(2, 3, 4, 1, 0)``); float32 or x's dtype.
            The bf16 form lays it out per call, in the one copy that casts
            it, unless it is already laid out
            (:func:`conv3d_banded_bf16_weights`, Cin a multiple of 8).
        bias: (Cout,) or None; float32 or x's dtype, added in float32.

    Returns:
        (B, D, H, W, Cout), or (B, Cout, D, H, W) with ``channels_first``,
        in x's dtype.
    """
    _check(x, kernel, bias, channels_first)
    (B, cin, D, H, W), _ = _axes(x, channels_first)
    with work.kernel(_NAME, conv3d_banded_flops(B, D, H, W, cin, kernel.shape[4], bias is not None)):
        if x.device.type == "cpu":
            if not channels_first:
                return conv3d_banded_reference(x, kernel, bias)
            return conv3d_banded_reference(x.movedim(1, -1), kernel, bias).movedim(-1, 1).contiguous()
        if x.device.type != "cuda":
            raise ValueError(f"conv3d_banded runs on cuda or cpu, not {x.device}")
        return _Conv3dK5.apply(x, kernel, bias, channels_first)


# every launch, and the launches of each form by x's dtype
conv3d_banded.launches = 0
conv3d_banded.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def conv3d_banded_path(cout, dtype=torch.float32):
    """The kernel's route for ``cout`` output channels of ``dtype``, as its C
    entries take it: ``"cuda_cores"`` (the float32 score heads),
    ``"tf32x3_mma"`` (float32 on the tensor cores) or ``"bf16_mma"``. Builds
    the kernel if it is not built."""
    fn = build.load(_NAME).conv3d_banded_route
    fn.argtypes, fn.restype = [ctypes.c_int32], ctypes.c_int
    if not fn(cout):
        return "cuda_cores"
    return "bf16_mma" if dtype == torch.bfloat16 else "tf32x3_mma"


def _axes(t, channels_first):
    """(B, C, D, H, W) sizes and element strides of a volume in either layout."""
    order = (0, 1, 2, 3, 4) if channels_first else (0, 4, 1, 2, 3)
    return [t.shape[a] for a in order], [t.stride(a) for a in order]


def conv3d_banded_bf16_weights(kernel):
    """The bf16 form's weights: ``kernel`` (DHWIO, any strides) rounded once
    to bf16, as the TPU kernel casts its band matrix, and laid out by (dz,
    dy, dx, o, i) with Cin padded with zeros to a multiple of 8, seen as a
    (3, 3, 3, Cin, Cout) view: the kernel copies a tap's 8 channels of an
    output as one 16-byte row. :func:`conv3d_banded` lays out every other
    kernel this way on each call, so a caller that keeps a bf16 weight may
    lay it out once with this function."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    pad = -cin % 8
    w = (torch.zeros if pad else torch.empty)((3, 3, 3, cout, cin + pad), dtype=torch.bfloat16, device=kernel.device)
    w[..., :cin] = kernel.permute(0, 1, 2, 4, 3)
    return w.permute(0, 1, 2, 4, 3)[:, :, :, :cin]


def _bf16_weights(kernel):
    """``kernel`` as the bf16 form reads it: as it is where it is bf16 with
    Cin a multiple of 8 and already meets the C entry's layout (unit Cin
    stride, the other strides multiples of 8, 16-byte aligned), so nothing
    pads it; else laid out anew (:func:`conv3d_banded_bf16_weights`). Nothing
    is kept between calls, so every change to the weight is seen."""
    s = kernel.stride()
    if (kernel.dtype == torch.bfloat16 and kernel.shape[3] % 8 == 0 and s[3] == 1 and s[4] >= kernel.shape[3]
            and all(v % 8 == 0 for v in (s[0], s[1], s[2], s[4])) and kernel.data_ptr() % 16 == 0):
        return kernel
    return conv3d_banded_bf16_weights(kernel)


def _launch(x, kernel, bias, channels_first):
    (B, Cin, D, H, W), xs = _axes(x, channels_first)
    Cout = kernel.shape[4]
    shape = (B, Cout, D, H, W) if channels_first else (B, D, H, W, Cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _, os_ = _axes(out, channels_first)
    # once per call, as the TPU kernel casts its band matrix
    kernel = kernel.to(x.dtype) if x.dtype == torch.float32 else _bf16_weights(kernel)
    strides = [(ctypes.c_int64 * 5)(*s) for s in (xs, kernel.stride(), os_)]
    bias = bias.float().contiguous() if bias is not None else None
    fn = _entry(_FORMS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), strides[0], kernel.data_ptr(), strides[1], bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), strides[2], B, Cin, Cout, D, H, W, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_banded kernel launch failed: cudaError {err}")
    conv3d_banded.launches += 1
    conv3d_banded.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return out


class _Conv3dK5(torch.autograd.Function):
    """K5 forward; backward through ``torch.nn.grad`` (cuDNN) in the output
    gradient's dtype, as the JAX VJP differentiates the XLA conv; each
    gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, kernel, bias, channels_first):
        ctx.save_for_backward(x, kernel)
        ctx.channels_first = channels_first
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _launch(x, kernel, bias, channels_first)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        cf = ctx.channels_first
        x_c, g_c = (x, grad) if cf else (x.movedim(-1, 1), grad.movedim(-1, 1))
        weight = kernel.permute(4, 3, 0, 1, 2).to(g_c.dtype)  # (Cout, Cin, 3, 3, 3)
        gx = gk = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x_c.shape, weight, g_c, padding=1)
            gx = gx if cf else gx.movedim(1, -1)
        if ctx.needs_input_grad[1]:
            gk = torch.nn.grad.conv3d_weight(x_c, weight.shape, g_c, padding=1).permute(2, 3, 4, 1, 0)
            gk = gk.to(kernel.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g_c.float().sum(dim=(0, 2, 3, 4)).to(ctx.bias_dtype)
        return gx, gk, gb, None


def _entry(name):
    fn = getattr(build.load(_NAME), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
