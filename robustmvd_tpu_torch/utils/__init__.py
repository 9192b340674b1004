from . import logging  # noqa: F401
from .checkpoint import TrainStateSaver, WeightsOnlySaver  # noqa: F401
from .conversion import (  # noqa: F401
    add_batch_dim,
    batched_index,
    exclude_index,
    numpy_collate,
    remove_batch_dim,
    select_by_index,
    to_numpy,
)
from .geometry import (  # noqa: F401
    compute_depth_range,
    from_relative_intrinsics,
    invert_transform,
    normalize,
    rebase_poses_to_key,
    rot_from_transform,
    scale_intrinsics,
    to_relative_intrinsics,
    trans_from_transform,
    transform_from_rot_trans,
)
from .image import resize_bilinear, resize_bilinear_torch, resize_nearest  # noqa: F401
from .misc import (  # noqa: F401
    NanError,
    check_finite,
    class_exists,
    function_exists,
    get_class,
    get_full_class_name,
    get_function,
    module_exists,
    prepend_level,
    set_random_seed,
)
from .paths import get_path, load_paths  # noqa: F401
from .paths import load_paths as get_paths  # noqa: F401  (the reference's name, rmvd/utils/utils.py:372)
from .registry import Registry  # noqa: F401
from .torchutils import (  # noqa: F401
    check_torch_model_cuda,
    count_torch_model_parameters,
    get_torch_model_device,
    string_classes,
    to_cuda,
    to_torch,
    torch_collate,
)
from .vis import vis, vis_2d_array, vis_image  # noqa: F401
