from .wrappers import ModelWrappers, add_repo_to_path, get_wrapper_path  # noqa: F401

# the wrapped models register themselves on import; an external repository
# is only touched when its wrapped model is created
from .monodepth2 import monodepth2_mono_stereo_1024x320_wrapped, monodepth2_mono_stereo_640x192_wrapped  # noqa: F401
from .midas import midas_big_v2_1_wrapped  # noqa: F401
from .mvsnet_pl import mvsnet_pl_wrapped  # noqa: F401
from .vis_mvsnet import vis_mvsnet_wrapped  # noqa: F401
from .cvp_mvsnet import cvp_mvsnet_wrapped  # noqa: F401
from .patchmatchnet import patchmatchnet_wrapped  # noqa: F401
