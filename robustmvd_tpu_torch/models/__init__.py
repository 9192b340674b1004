from .factory import cli_model_kwargs, create_model, prepare_custom_model  # noqa: F401
from .helpers import ModelBase, add_run_function  # noqa: F401
from .registry import has_model, list_models, register_model  # noqa: F401

# model definitions register themselves on import
from .robust_mvd import robust_mvd, robust_mvd_5M  # noqa: F401
from .mvsnet import mvsnet_train  # noqa: F401
from .cvp_mvsnet import cvp_mvsnet  # noqa: F401
from .vis_mvsnet import vis_mvsnet  # noqa: F401
from .wrappers import (  # noqa: F401
    cvp_mvsnet_wrapped,
    midas_big_v2_1_wrapped,
    monodepth2_mono_stereo_640x192_wrapped,
    monodepth2_mono_stereo_1024x320_wrapped,
    mvsnet_pl_wrapped,
    patchmatchnet_wrapped,
    vis_mvsnet_wrapped,
)
