"""K2: fused plane-sweep warp + variance cost volume.

The wrapper of ``csrc/sweep_warp.cu``, which replaces the TPU kernel
``ops/pallas/sweep_warp.py::_call_sweep`` (kernel ``_sweep_kernel``) of the
JAX package in its variance mode. The three entries keep the JAX entries'
arguments and layouts (channel-last volumes):

- :func:`warp_variance`: MVSNet, source projections and the inverse
  reference projection, one depth per plane (``homo_warp`` convention);
- :func:`warp_variance_rt`: CVP-MVSNet's coarse level, per-view R, t and one
  depth per plane (``rt_planesweep_warp`` convention);
- :func:`warp_variance_dense`: CVP-MVSNet's refinement levels, per-pixel
  depth hypotheses.

The JAX entries' ``dc``, ``band`` and ``interpret`` arguments set the TPU
kernel's tiling and are not taken. The group-correlation entry
(``homography_group_cost``, Vis-MVSNet) is its own kernel,
``sweep_group_cost.py``.

For a CUDA tensor each entry launches the kernel or raises. The kernel is
forward-only, as the JAX kernel (which has no VJP): a CUDA input that
requires grad while grad mode is on raises (``build.py::refuse_gradient``), and
training takes the models' ``warp_impl="xla"`` route. For a CPU tensor
it computes the same function with :func:`sweep_variance_reference`, the
plain torch version (``rt_planesweep_warp`` per view, then
``E[x^2] - E[x]^2`` over the reference and the valid sources in float32),
which is also what the kernel is held against. The kernel's source note
says what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from ..homography import plane_sweep_transform, sweep_coordinates
from ..sampling import bilinear_sample
from . import build, work

_NAME = "sweep_warp"


def sweep_variance_flops(B, V, D, H, W, C):
    """K2's work: (15 + 11 C) flops a (key pixel, plane, source view): 15 for
    the tap coordinates and weights, and per channel 7 for the bilinear
    sample, 2 for the valid-view scale and the running sum, 2 for the square
    and its sum."""
    return B * D * H * W * V * (15 + 11 * C)


def sweep_variance_reference(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype=torch.float32):
    """Plain torch K2 (variance mode); arguments as :func:`sweep_variance`."""
    B, H, W, C = ref_feat.shape
    V, Hs, Ws = src_feats.shape[1:4]
    D = depth.shape[1]
    d = depth.reshape(B, D, H * W) if depth.dim() == 4 else depth
    refv = ref_feat.float()[:, None].expand(B, D, H, W, C)
    vsum, vsq = refv, refv * refv
    count = torch.ones(B, dtype=torch.float32, device=ref_feat.device)
    for v in range(V):
        xi, yi = sweep_coordinates(rot[:, v], trans[:, v], d, H, W, Hs, Ws)
        warped, _ = bilinear_sample(src_feats[:, v].float(), xi.reshape(B, -1), yi.reshape(B, -1))
        warped = warped.reshape(B, D, H, W, C) * src_valid[:, v].reshape(B, 1, 1, 1, 1)
        vsum = vsum + warped
        vsq = vsq + warped * warped
        count = count + src_valid[:, v]
    n = count.reshape(B, 1, 1, 1, 1)
    mean = vsum / n
    return (vsq / n - mean * mean).to(out_dtype)


def _check(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype):
    if ref_feat.dim() != 4 or src_feats.dim() != 5:
        raise ValueError(f"ref_feat must be (B, H, W, C) and src_feats (B, V, Hs, Ws, C), got "
                         f"{tuple(ref_feat.shape)} and {tuple(src_feats.shape)}")
    B, H, W, C = ref_feat.shape
    V = src_feats.shape[1]
    if src_feats.shape[0] != B or src_feats.shape[4] != C:
        raise ValueError(f"src_feats {tuple(src_feats.shape)} does not match ref_feat {tuple(ref_feat.shape)}")
    if ref_feat.dtype not in (torch.float32, torch.bfloat16) or src_feats.dtype != ref_feat.dtype:
        raise TypeError(f"features must both be float32 or bfloat16, got {ref_feat.dtype}, {src_feats.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    D = depth.shape[1] if depth.dim() >= 2 else -1
    if tuple(depth.shape) not in ((B, D), (B, D, H, W)):
        raise ValueError(f"depths must be (B, D) or (B, D, H, W), got {tuple(depth.shape)}")
    for name, t, shape in (("rot", rot, (B, V, 3, 3)), ("trans", trans, (B, V, 3)), ("src_valid", src_valid, (B, V))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("rot", rot), ("trans", trans), ("depths", depth), ("src_valid", src_valid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("src_feats", src_feats), ("rot", rot), ("trans", trans), ("depths", depth),
                    ("src_valid", src_valid)):
        if t.device != ref_feat.device:
            raise ValueError(f"{name} is on {t.device}, ref_feat on {ref_feat.device}")


def sweep_variance(ref_feat, src_feats, rot, trans, depth, src_valid=None, out_dtype=torch.float32):
    """The variance volume for per-view transforms and depths.

    Args:
        ref_feat: (B, H, W, C) float32 or bfloat16.
        src_feats: (B, V, Hs, Ws, C), the same dtype.
        rot: (B, V, 3, 3); trans: (B, V, 3) float32, src-from-ref.
        depth: (B, D) plane depths or (B, D, H, W) per-pixel depths, float32.
        src_valid: (B, V) 0/1 float32 (None: all views count).
        out_dtype: float32 or bfloat16.

    Returns:
        (B, D, H, W, C) in ``out_dtype``.
    """
    B, V = src_feats.shape[:2]
    if src_valid is None:
        src_valid = torch.ones((B, V), dtype=torch.float32, device=ref_feat.device)
    src_valid = src_valid.float()
    _check(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype)
    _, H, W, C = ref_feat.shape
    with work.kernel(_NAME, sweep_variance_flops(B, V, depth.shape[1], H, W, C)):
        if ref_feat.device.type == "cpu":
            return sweep_variance_reference(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype)
        if ref_feat.device.type != "cuda":
            raise ValueError(f"sweep_warp runs on cuda or cpu, not {ref_feat.device}")
        return _launch(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype)


def _launch(ref_feat, src_feats, rot, trans, depth, src_valid, out_dtype):
    build.refuse_gradient("sweep_warp (K2)", ref_feat, src_feats, rot, trans, depth)
    B, H, W, C = ref_feat.shape
    V = src_feats.shape[1]
    Hs, Ws = src_feats.shape[2:4]
    D = depth.shape[1]
    if Hs * Ws * C >= 2**31:
        raise ValueError(f"a source map of {Hs}x{Ws}x{C} elements exceeds the kernel's int32 offsets")
    if H > 65535:
        raise ValueError(f"{H} key rows exceed the kernel's grid (at most 65535)")
    tensors = [t.contiguous() for t in (ref_feat, src_feats, rot, trans, depth, src_valid)]
    out = torch.empty((B, D, H, W, C), dtype=out_dtype, device=ref_feat.device)
    fn = _entry()
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), B, V, D, H, W, Hs, Ws, C,
                 int(depth.dim() == 4), Ws / (Ws - 1), Hs / (Hs - 1),
                 int(ref_feat.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"sweep_warp kernel launch failed: cudaError {err}")
    sweep_variance.launches += 1
    return out


sweep_variance.launches = 0


def sweep_warp_tiling(V, W):
    """The kernel's row tiling for ``V`` source views and rows of ``W``
    pixels, as its C entry takes it: ``(tile, vc)``, the pixels of a row
    tile and the views whose taps shared memory holds (views beyond ``vc``
    get their taps per thread). Builds the kernel if it is not built."""
    fn = build.load(_NAME).sweep_warp_tiling
    fn.argtypes, fn.restype = [ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)], None
    tile_vc = (ctypes.c_int32 * 2)()
    fn(V, W, tile_vc)
    return tile_vc[0], tile_vc[1]


def warp_variance(ref_feat, src_feats, src_projs, ref_proj_inv, depth_values, src_valid=None,
                  out_dtype=torch.float32):
    """MVSNet's warp + variance (reference: blocks/utils.py:222-268 +

    mvsnet.py:124-137): src_projs (B, V, 4, 4), ref_proj_inv (B, 4, 4),
    depth_values (B, D). Returns (B, D, H, W, C)."""
    rot, trans = plane_sweep_transform(src_projs, ref_proj_inv)
    return sweep_variance(ref_feat, src_feats, rot.contiguous(), trans.contiguous(),
                          depth_values.float(), src_valid, out_dtype)


def warp_variance_rt(ref_feat, src_feats, rot, trans, depth_values, src_valid=None, out_dtype=torch.float32):
    """CVP-MVSNet's coarse warp + variance (``rt_planesweep_warp``

    convention): rot (B, V, 3, 3), trans (B, V, 3), depth_values (B, D)."""
    return sweep_variance(ref_feat, src_feats, rot.float(), trans.float(), depth_values.float(),
                          src_valid, out_dtype)


def warp_variance_dense(ref_feat, src_feats, rot, trans, depth_hypos, src_valid=None, out_dtype=torch.float32):
    """CVP-MVSNet's refinement warp + variance with per-pixel hypotheses

    (reference: cvp_mvsnet_components.py:375-456 ``proj_cost``):
    depth_hypos (B, D, H, W)."""
    return sweep_variance(ref_feat, src_feats, rot.float(), trans.float(), depth_hypos.float(),
                          src_valid, out_dtype)


def _entry():
    fn = build.load(_NAME).sweep_warp_variance
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, ctypes.c_float,
                       i, i, p]
        fn.restype = ctypes.c_int
    return fn
