from . import logging  # noqa: F401
from .conversion import (  # noqa: F401
    add_batch_dim,
    exclude_index,
    numpy_collate,
    remove_batch_dim,
    select_by_index,
    to_numpy,
)
from .geometry import (  # noqa: F401
    compute_depth_range,
    invert_transform,
    scale_intrinsics,
    to_relative_intrinsics,
    transform_from_rot_trans,
)
from .image import resize_bilinear, resize_bilinear_torch, resize_nearest  # noqa: F401
from .misc import get_full_class_name, prepend_level  # noqa: F401
from .paths import get_path, load_paths  # noqa: F401
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
