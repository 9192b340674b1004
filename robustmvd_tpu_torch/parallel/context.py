"""The active mesh, and the groups of its axes that the models and the training
step reduce over.

The JAX package's ``parallel/context.py`` in torch: ``use_mesh`` activates a
mesh for a block and ``get_mesh`` returns it. JAX's ``constrain`` pins a
GSPMD sharding on an intermediate and lets XLA insert the collectives
(``robustmvd_tpu/parallel/context.py:39-52``); torch has no such partitioner,
so the port has no ``constrain``: the code that shards calls the collectives
itself (``parallel/collectives.py``) on the groups read here.

- :func:`data_group`: the data axis. The training engine runs its step under
  ``use_mesh``, and the losses' masked means (``loss/utils.py::masked_mean``)
  and the family's BatchNorm (``ops/layers.py``) reduce their sums over it, so
  that a step over the ranks' local batches computes the statistics of the
  global batch, as JAX's sharded step does.
- :func:`view_group` and :func:`hyp_group`: the view and hyp axes, over which
  ``robust_mvd`` shards its source views and its depth hypotheses
  (``models/robust_mvd.py``, ``models/blocks/dispnet.py::LearnedFusion``),
  and the MVSNet family its hypotheses (``mvsnet_train`` with
  ``view_parallel`` its source views too): the cost volumes and the 3D
  layers over them hold a slab of D (``ops/sharded3d.py``). Every rank of a
  view x hyp group is given the same inputs; each takes its :func:`share`
  of the views or hypotheses.
- :func:`batch_stats_axes`: the axes over which BatchNorm sums its training
  statistics: the data axis, and the hyp axis too for a D-sharded volume.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

_state = threading.local()


class AxisGroup(NamedTuple):
    """One mesh axis as this rank sees it: the process group of the ranks
    that differ from it only along the axis, their number and its index."""

    group: object
    size: int
    rank: int


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` (a ``DeviceMesh`` or None) within the block."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _axis(name):
    """The active mesh's axis ``name`` as an :class:`AxisGroup` when it spans
    more than one process; None without a mesh or for an axis of one."""
    mesh = get_mesh()
    if mesh is None:
        return None
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None
    return AxisGroup(mesh.get_group(name), size, mesh.get_local_rank(name))


def data_group():
    """(process group, size, rank) of the active mesh's data axis when it
    spans more than one process; None otherwise, when every sum is local."""
    return _axis("data")


def view_group():
    """(process group, size, rank) of the active mesh's view axis, over which
    source views are sharded; None when it is 1 or no mesh is active."""
    return _axis("view")


def hyp_group():
    """(process group, size, rank) of the active mesh's hyp axis, over which
    depth hypotheses are sharded; None when it is 1 or no mesh is active."""
    return _axis("hyp")


def batch_stats_axes(hyp_sharded=False):
    """The axes (:class:`AxisGroup`) over which a BatchNorm in training sums
    its per-channel statistics: the data axis, and for a volume whose D is
    sharded over the hyp axis the hyp axis too (the sum over data x hyp is
    the sum over one of the sums over the other); those of more than one
    process, outermost first. Empty: the statistics are local."""
    axes = (data_group(), hyp_group() if hyp_sharded else None)
    return [axis for axis in axes if axis is not None]


def shares(n, size):
    """The contiguous shares of ``n`` items over ``size`` ranks, as (lo, hi)
    per rank: the first ``n % size`` ranks take one item more (a share may be
    empty where ``n < size``)."""
    base, extra = divmod(n, size)
    bounds = [r * base + min(r, extra) for r in range(size + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def share(n, axis):
    """(lo, hi) of this rank's share of ``n`` items along ``axis`` (an
    :class:`AxisGroup`); all of them, (0, n), for None."""
    return (0, n) if axis is None else shares(n, axis.size)[axis.rank]
