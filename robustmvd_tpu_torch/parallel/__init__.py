"""Parallelism over ``torch.distributed`` (the JAX package's ``parallel``):
the ("data", "view", "hyp") mesh, process-group start-up, the active mesh
and its axes' groups, and the differentiable collectives of the sharded
models (``collectives.py``)."""

from .collectives import all_gather, all_reduce_sum, fetch_window
from .context import (
    batch_stats_axes,
    data_group,
    get_mesh,
    hyp_group,
    share,
    shares,
    use_mesh,
    view_group,
)
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
    "view_group",
    "hyp_group",
    "share",
    "shares",
    "all_reduce_sum",
    "all_gather",
    "fetch_window",
    "batch_stats_axes",
]
