"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, runs its plain torch
version for CPU tensors, and counts its launches in ``<wrapper>.launches``.
"""

from .conv3d import conv3d_banded, conv3d_banded_reference  # noqa: F401
from .planesweep_sample import planesweep_sample, planesweep_sample_reference  # noqa: F401
from .soft_argmin import fused_soft_argmin, fused_soft_argmin_reference  # noqa: F401
from .sweep_group_cost import homography_group_cost, homography_group_cost_reference  # noqa: F401
from .sweep_warp import (  # noqa: F401
    sweep_variance,
    sweep_variance_reference,
    warp_variance,
    warp_variance_dense,
    warp_variance_rt,
)
from .warp_volume import homo_warp_volume, homo_warp_volume_reference  # noqa: F401

# every kernel wrapper of the port by its source name (csrc/<name>.cu), for
# launch accounting and builds
KERNELS = {"planesweep_sample": planesweep_sample, "sweep_warp": sweep_variance,
           "sweep_group_cost": homography_group_cost, "soft_argmin": fused_soft_argmin,
           "conv3d_banded": conv3d_banded, "warp_volume": homo_warp_volume}
