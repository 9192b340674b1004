from .corr import planesweep_correlation  # noqa: F401
from .epipolar import make_epipolar_coeffs, planesweep_points, sampling_invdepths  # noqa: F401
from .homography import homo_warp, rt_planesweep_warp  # noqa: F401
from .interpolate import resize_bicubic_x2, resize_bilinear  # noqa: F401
from .kernels.planesweep_sample import planesweep_sample, planesweep_sample_reference  # noqa: F401
from .kernels.sweep_warp import warp_variance, warp_variance_dense, warp_variance_rt  # noqa: F401
from .sampling import bilinear_sample  # noqa: F401
