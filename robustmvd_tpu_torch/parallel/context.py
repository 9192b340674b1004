"""The active mesh: what the losses and BatchNorm reduce over in training.

The JAX package's ``parallel/context.py`` in torch: ``use_mesh`` activates a
mesh for a block and ``get_mesh`` returns it. JAX's ``constrain`` pins a
GSPMD sharding on an intermediate and lets XLA insert the collectives
(``robustmvd_tpu/parallel/context.py:39-52``); torch has no such partitioner
and the port's models carry no annotations, so it has no ``constrain``. The
one thing read from the mesh here is the data axis' process group,
:func:`data_group`: the training engine runs its step under ``use_mesh``, and
the losses' masked means (``loss/utils.py::masked_mean``) and the family's
BatchNorm (``ops/layers.py``) reduce their sums over it, so that a step over
the ranks' local batches computes the statistics of the global batch, as
JAX's sharded step does.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


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


def data_group():
    """(process group, size) of the active mesh's data axis when it spans
    more than one process; None otherwise, when every sum is local."""
    mesh = get_mesh()
    if mesh is None:
        return None
    from .mesh import AXIS_DATA

    size = mesh.size(mesh.mesh_dim_names.index(AXIS_DATA))
    return (mesh.get_group(AXIS_DATA), size) if size > 1 else None
