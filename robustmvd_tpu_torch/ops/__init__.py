from .corr import planesweep_correlation, planesweep_correlation_single  # noqa: F401
from .epipolar import EpipolarCoeffs, make_epipolar_coeffs, planesweep_points, sampling_invdepths  # noqa: F401
from .homography import homo_warp, rt_planesweep_warp  # noqa: F401
from .interpolate import resize_bicubic_x2, resize_bilinear, resize_nearest  # noqa: F401
from .kernels.planesweep_sample import planesweep_sample, planesweep_sample_reference  # noqa: F401
from .kernels.sweep_warp import warp_variance, warp_variance_dense, warp_variance_rt  # noqa: F401
from .reductions import depth_regression, entropy, groupwise_correlation, soft_argmin  # noqa: F401
from .sampling import bilinear_sample, grid_sample_normalized, warp  # noqa: F401
