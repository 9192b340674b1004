from .conversion import add_batch_dim, remove_batch_dim, to_numpy  # noqa: F401
from .geometry import invert_transform, to_relative_intrinsics  # noqa: F401
from .image import resize_bilinear  # noqa: F401
from .registry import Registry  # noqa: F401
