"""K2, group-correlation mode: fused homography warp + group-wise correlation.

The wrapper of ``csrc/sweep_group_cost.cu``, which replaces the TPU kernel
``ops/pallas/sweep_warp.py::_call_sweep`` (kernel ``_sweep_kernel``,
``agg="group"``) of the JAX package behind its entry
``homography_group_cost``: Vis-MVSNet's per-pair cost volume. The arguments
and layouts are the JAX entry's (channel-last maps); its ``dc``, ``band``
and ``interpret`` arguments set the TPU kernel's tiling and are not taken.

For a CUDA tensor :func:`homography_group_cost` launches the kernel or
raises. The kernel is forward-only, as the JAX kernel: a CUDA input that
requires grad while grad mode is on raises (``build.py::
refuse_gradient``), and Vis-MVSNet trains through ``warp_impl="xla"``. For a
CPU tensor it computes the same function with
:func:`homography_group_cost_reference`, the plain torch version (the TPU
kernel's coordinates, a bilinear gather, group sums written out in channel
order), which is also what the kernel is held against. The kernel's source
note says what bounds it and how its two routes work: the lane route (bf16
features whose groups fit a lane's 16 channels, as vis_mvsnet's C 32, G 8)
and the group route (float32 features and every other shape);
:func:`homography_group_cost_route` says which one a call takes.

The features are float32 or bf16, both of one dtype. bf16 features sample
as the TPU kernel does with its bf16 ``samp_dtype``: the x-tent weights are
rounded to bf16, each source row is blended in float32 and the rows are
weighted by float32 y-tents; products and group sums stay float32. Launches
are counted in ``launches`` and, by the features' dtype, in
``launches_by_dtype``.
"""

from __future__ import annotations

import ctypes

import torch

from ..sampling import _LIM, _finite_or_far, bilinear_sample
from . import build

_NAME = "sweep_group_cost"


def homography_coordinates(Amat, Bmat, w_dense):
    """Index-space source coordinates of every key pixel, as the TPU kernel
    forms them: ``M = A + B * w`` per pixel, ``p = M [x, y, 1]``, ``xi = p_x /
    (p_z + 1e-9) - 0.5`` (no clamp).

    Amat, Bmat: (B, 3, 3); w_dense: (B, D, H, W). Returns xi, yi (B, D, H, W).
    """
    B, D, H, W = w_dense.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=w_dense.device),
                            torch.arange(W, dtype=torch.float32, device=w_dense.device), indexing="ij")
    w = w_dense.float()

    def row(i):
        m = [Amat[:, i, j].float().reshape(B, 1, 1, 1) + Bmat[:, i, j].float().reshape(B, 1, 1, 1) * w
             for j in range(3)]
        return m[0] * xs + m[1] * ys + m[2]

    pz = row(2) + 1e-9
    return row(0) / pz - 0.5, row(1) / pz - 0.5


def sample_bf16_tents(src_feat, xi, yi):
    """Bilinear samples of a bf16 map as the TPU kernel takes them at bf16:
    x-tents ``1 - wx`` and ``1 - (1 - wx)`` rounded to bf16, each row
    blended in float32, the rows weighted by the float32 y-tents; zeros
    padding.

    src_feat: (B, Hs, Ws, C) bf16; xi, yi: (B, N). Returns (B, N, C) float32.
    """
    B, Hs, Ws, C = src_feat.shape
    x, y = _finite_or_far(xi), _finite_or_far(yi)
    x0, y0 = torch.floor(x), torch.floor(y)
    ux, wy = 1 - (x - x0), y - y0
    tx = (ux.bfloat16().float(), (1 - ux).bfloat16().float())
    ty = (1 - wy, wy)
    x0 = x0.clamp(-_LIM, _LIM).long()
    y0 = y0.clamp(-_LIM, _LIM).long()
    flat = src_feat.reshape(B, Hs * Ws, C)

    def tap(dy, dx):
        xs, ys = x0 + dx, y0 + dy
        valid = (xs >= 0) & (xs <= Ws - 1) & (ys >= 0) & (ys <= Hs - 1)
        idx = torch.where(valid, ys * Ws + xs, torch.zeros_like(xs))
        return torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C)).float() * valid[..., None]

    rows = [tap(dy, 0) * tx[0][..., None] + tap(dy, 1) * tx[1][..., None] for dy in (0, 1)]
    return rows[0] * ty[0][..., None] + rows[1] * ty[1][..., None]


def homography_group_cost_reference(ref_feat, src_feat, Amat, Bmat, w_dense, groups=8, out_dtype=torch.float32):
    """Plain torch K2 group mode; arguments as :func:`homography_group_cost`."""
    B, H, W, C = ref_feat.shape
    D = w_dense.shape[1]
    xi, yi = homography_coordinates(Amat, Bmat, w_dense)
    if src_feat.dtype == torch.bfloat16:
        warped = sample_bf16_tents(src_feat, xi.reshape(B, -1), yi.reshape(B, -1))
    else:
        warped, _ = bilinear_sample(src_feat, xi.reshape(B, -1), yi.reshape(B, -1))
    prod = (ref_feat.float()[:, None] * warped.reshape(B, D, H, W, C)).reshape(B, D, H, W, groups, C // groups)
    out = prod[..., 0]
    for j in range(1, C // groups):
        out = out + prod[..., j]
    return out.to(out_dtype)


def _check(ref_feat, src_feat, Amat, Bmat, w_dense, groups, out_dtype):
    if ref_feat.dim() != 4 or src_feat.dim() != 4:
        raise ValueError(f"ref_feat must be (B, H, W, C) and src_feat (B, Hs, Ws, C), got "
                         f"{tuple(ref_feat.shape)} and {tuple(src_feat.shape)}")
    B, H, W, C = ref_feat.shape
    if src_feat.shape[0] != B or src_feat.shape[3] != C:
        raise ValueError(f"src_feat {tuple(src_feat.shape)} does not match ref_feat {tuple(ref_feat.shape)}")
    if groups < 1 or C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if w_dense.dim() != 4 or tuple(w_dense.shape) != (B, w_dense.shape[1], H, W):
        raise ValueError(f"w_dense must be (B, D, H, W) = ({B}, D, {H}, {W}), got {tuple(w_dense.shape)}")
    for name, t in (("Amat", Amat), ("Bmat", Bmat)):
        if tuple(t.shape) != (B, 3, 3):
            raise ValueError(f"{name} must be ({B}, 3, 3), got {tuple(t.shape)}")
    if ref_feat.dtype not in (torch.float32, torch.bfloat16) or src_feat.dtype != ref_feat.dtype:
        raise TypeError(f"features must both be float32 or bfloat16, got {ref_feat.dtype}, {src_feat.dtype}")
    for name, t in (("ref_feat", ref_feat), ("src_feat", src_feat), ("Amat", Amat), ("Bmat", Bmat),
                    ("w_dense", w_dense)):
        if name not in ("ref_feat", "src_feat") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ref_feat.device:
            raise ValueError(f"{name} is on {t.device}, ref_feat on {ref_feat.device}")


def homography_group_cost(ref_feat, src_feat, Amat, Bmat, w_dense, groups=8, out_dtype=torch.float32):
    """The G-group correlation volume of a key and one source view.

    Args:
        ref_feat: (B, H, W, C) float32 or bfloat16 key features.
        src_feat: (B, Hs, Ws, C) source features, in ``ref_feat``'s dtype.
        Amat, Bmat: (B, 3, 3) float32: the homography ``A + B * w`` with the
            pixel-centre offset folded in (``M @ [[1, 0, .5], [0, 1, .5],
            [0, 0, 1]]``).
        w_dense: (B, D, H, W) float32 per-pixel multiplier
            (``1 / (depth + 1e-9)`` for fronto-parallel planes).
        groups: G, a divisor of C.
        out_dtype: float32 or bfloat16.

    Returns:
        (B, D, H, W, G) in ``out_dtype``.
    """
    _check(ref_feat, src_feat, Amat, Bmat, w_dense, groups, out_dtype)
    if ref_feat.device.type == "cpu":
        return homography_group_cost_reference(ref_feat, src_feat, Amat, Bmat, w_dense, groups, out_dtype)
    if ref_feat.device.type != "cuda":
        raise ValueError(f"sweep_group_cost runs on cuda or cpu, not {ref_feat.device}")
    build.refuse_gradient("sweep_group_cost (K2 group)", ref_feat, src_feat, Amat, Bmat, w_dense)
    B, H, W, C = ref_feat.shape
    Hs, Ws = src_feat.shape[1:3]
    D = w_dense.shape[1]
    if Hs * Ws * C >= 2**31:
        raise ValueError(f"a source map of {Hs}x{Ws}x{C} elements exceeds the kernel's int32 offsets")
    if H > 65535:
        raise ValueError(f"{H} key rows exceed the kernel's grid (at most 65535)")
    tensors = [t.contiguous() for t in (ref_feat, src_feat, Amat, Bmat, w_dense)]
    out = torch.empty((B, D, H, W, groups), dtype=out_dtype, device=ref_feat.device)
    fn = _entry()
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), B, D, H, W, Hs, Ws, C, groups,
                 int(ref_feat.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"sweep_group_cost kernel launch failed: cudaError {err}")
    homography_group_cost.launches += 1
    homography_group_cost.launches_by_dtype[str(ref_feat.dtype).removeprefix("torch.")] += 1
    return out


homography_group_cost.launches = 0
homography_group_cost.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def homography_group_cost_route(ref_feat, src_feat, groups=8, out_dtype=torch.float32, out=None):
    """The route the kernel takes for these CUDA maps: "lanes" (bf16
    features, 16 channels a lane holding whole groups, 1, 2, 4 or 8 lanes a
    pixel, the maps and ``out`` aligned to a lane's loads and stores) or
    "groups". ``out`` defaults to a fresh output, which the caching
    allocator aligns to 512 bytes."""
    fn = build.load(_NAME).sweep_group_cost_route
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, i, i, i, i]
        fn.restype = ctypes.c_int
    out_ptr = 512 if out is None else out.data_ptr()
    lanes = fn(ref_feat.data_ptr(), src_feat.data_ptr(), out_ptr, ref_feat.shape[-1], groups,
               int(ref_feat.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    return "lanes" if lanes else "groups"


def _entry():
    fn = build.load(_NAME).sweep_group_cost
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
