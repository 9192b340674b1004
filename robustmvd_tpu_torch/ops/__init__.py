from .corr import planesweep_correlation  # noqa: F401
from .epipolar import make_epipolar_coeffs, planesweep_points, sampling_invdepths  # noqa: F401
from .interpolate import resize_bilinear  # noqa: F401
from .kernels.planesweep_sample import planesweep_sample, planesweep_sample_reference  # noqa: F401
