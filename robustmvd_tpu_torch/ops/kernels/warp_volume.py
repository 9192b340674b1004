"""K4: the materialised plane-sweep warp volume.

The wrapper of ``csrc/warp_volume.cu``, which replaces the TPU kernel
``ops/pallas/warp_volume.py::homo_warp_pallas`` of the JAX package, the
drop-in for ``homo_warp`` (one ``(B, D, H, W, C)`` warped volume of a source
view) on MVSNet's ``warp_impl="xla"`` route. :func:`homo_warp_volume` keeps
the JAX entry's arguments (``(B, D)`` plane depths only, as the TPU kernel);
its ``block_rows`` and ``interpret`` set the TPU kernel's tiling and are not
taken. Float32 features give ``homo_warp``'s own function; bfloat16
features give ``homo_warp_pallas``'s (bf16 source, float32 weights); the
volume is float32 either way.

For a CUDA tensor :func:`homo_warp_volume` launches the kernel or raises.
The kernel is forward-only: the JAX kernel's VJP refuses training
(``ALLOW_TRAIN = False``), and a CUDA input that requires grad while grad
mode is on raises here (``build.py::refuse_gradient``). MVSNet trains
through ``ops/homography.py::homo_warp``, as JAX trains through its XLA
``homo_warp``. For a CPU tensor it computes the same function with
:func:`homo_warp_volume_reference`, the plain torch version
(``ops/homography.py::homo_warp``, ``rt_planesweep_warp``'s gather), which
is also what the kernel is held against. The
kernel's source note says what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from ..homography import homo_warp, plane_sweep_transform, rt_planesweep_warp
from . import build, work

_NAME = "warp_volume"


def homo_warp_volume_flops(B, D, H, W, C):
    """K4's work: (15 + 7 C) flops a (pixel, plane): 15 for the tap
    coordinates and weights, 7 a channel for the bilinear sample."""
    return B * D * H * W * (15 + 7 * C)


def homo_warp_volume_reference(src_feat, src_proj, ref_proj_inv, depth_values):
    """Plain torch K4 (``ops/homography.py::homo_warp``); arguments and
    result as :func:`homo_warp_volume`."""
    return homo_warp(src_feat, src_proj, ref_proj_inv, depth_values)


def _check(src_feat, rot, trans, depth):
    if src_feat.dim() != 4:
        raise ValueError(f"src_feat must be (B, H, W, C), got {tuple(src_feat.shape)}")
    if src_feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src_feat must be float32 or bfloat16, got {src_feat.dtype}")
    B = src_feat.shape[0]
    if depth.dim() != 2 or depth.shape[0] != B:
        raise ValueError(f"depth_values must be ({B}, D), got {tuple(depth.shape)}")
    for name, t, shape in (("src_proj @ ref_proj_inv rotation", rot, (B, 3, 3)), ("translation", trans, (B, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("projections", rot), ("depth_values", depth)):
        if t.device != src_feat.device:
            raise ValueError(f"{name} on {t.device}, src_feat on {src_feat.device}")


def homo_warp_volume(src_feat, src_proj, ref_proj_inv, depth_values):
    """The warped source volume of MVSNet's plane sweep.

    Args:
        src_feat: (B, H, W, C) float32 or bfloat16.
        src_proj: (B, 4, 4); ref_proj_inv: (B, 4, 4).
        depth_values: (B, D) plane depths.

    Returns:
        (B, D, H, W, C) float32, zeros where a sample leaves the map.
    """
    rot, trans = plane_sweep_transform(src_proj, ref_proj_inv)
    depth = depth_values.float()
    _check(src_feat, rot, trans, depth)
    B, H, W, C = src_feat.shape
    with work.kernel(_NAME, homo_warp_volume_flops(B, depth.shape[1], H, W, C)):
        if src_feat.device.type == "cpu":
            return rt_planesweep_warp(src_feat, rot, trans, depth)
        if src_feat.device.type != "cuda":
            raise ValueError(f"warp_volume runs on cuda or cpu, not {src_feat.device}")
        build.refuse_gradient("warp_volume (K4)", src_feat, src_proj, ref_proj_inv, depth_values)
        return _launch(src_feat, rot, trans, depth)


homo_warp_volume.launches = 0


def _launch(src_feat, rot, trans, depth):
    B, H, W, C = src_feat.shape
    D = depth.shape[1]
    tensors = [t.contiguous() for t in (src_feat, rot, trans, depth)]
    out = torch.empty((B, D, H, W, C), dtype=torch.float32, device=src_feat.device)
    fn = _entry()
    with torch.cuda.device(src_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), B, D, H, W, C, W / (W - 1), H / (H - 1),
                 int(src_feat.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"warp_volume kernel launch failed: cudaError {err}")
    homo_warp_volume.launches += 1
    return out


def _entry():
    fn = build.load(_NAME).warp_volume
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int32
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn
