"""Data parallelism over ``torch.distributed`` (the JAX package's ``parallel``):
the ("data", "view", "hyp") mesh, process-group start-up, and the active
mesh that the training step reduces over."""

from .context import data_group, get_mesh, use_mesh
from .mesh import (
    AXIS_DATA,
    AXIS_HYP,
    AXIS_VIEW,
    MeshSpec,
    data_sharding,
    init_distributed,
    init_distributed_from_env,
    make_mesh,
    replicate_sharding,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_HYP",
    "AXIS_VIEW",
    "MeshSpec",
    "make_mesh",
    "data_sharding",
    "replicate_sharding",
    "init_distributed",
    "init_distributed_from_env",
    "get_mesh",
    "use_mesh",
    "data_group",
]
