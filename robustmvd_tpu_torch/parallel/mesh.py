"""Device meshes and process groups over ``torch.distributed``.

The JAX package's ``parallel/mesh.py`` in torch. The reference's only
parallelism is single-process ``nn.DataParallel``
(rmvd/models/helpers.py:163-169); the JAX package names a mesh with the axes

    ("data", "view", "hyp")

and shards the batch over ``data``, the source views over ``view`` and the
depth hypotheses over ``hyp``. The port builds the same mesh with
``torch.distributed.device_mesh.init_device_mesh``, one process per device,
rank ``(d * view + v) * hyp + h`` at coordinates (d, v, h). It trains
data-parallel over ``data`` (``DistributedDataParallel`` in the training
engine, with the losses' masked means and BatchNorm's statistics reduced over
the data group); ``robust_mvd`` shards its source views over ``view`` and its
hypotheses over ``hyp`` with explicit collectives (``collectives.py``) on the
groups that ``context.py`` reads from the active mesh, and the MVSNet family
shards its cost volumes' hypotheses over ``hyp`` (``mvsnet_train`` with
``view_parallel`` its source views over ``view`` too; ``ops/sharded3d.py``).

Processes join with :func:`init_distributed` (or
:func:`init_distributed_from_env`, the launcher's environment contract)
before the mesh is built: NCCL where a card is available, gloo on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_VIEW = "view"
AXIS_HYP = "hyp"


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 on the data axis means "all remaining"."""

    data: int = -1
    view: int = 1
    hyp: int = 1

    def resolve(self, n_devices: int):
        data = self.data
        if data == -1:
            assert n_devices % (self.view * self.hyp) == 0, (
                f"{n_devices} devices not divisible by view*hyp = {self.view * self.hyp}")
            data = n_devices // (self.view * self.hyp)
        total = data * self.view * self.hyp
        assert total == n_devices, f"mesh {data}x{self.view}x{self.hyp} != {n_devices} devices"
        return (data, self.view, self.hyp)


def make_mesh(spec=None, device_type=None):
    """A ``DeviceMesh`` of shape ``spec.resolve(world size)`` with the dims
    ("data", "view", "hyp") over every process of the default group (one
    device each), which must be initialised. ``device_type`` defaults to
    "cuda" on the NCCL backend and "cpu" on gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    spec = spec or MeshSpec()
    shape = spec.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=(AXIS_DATA, AXIS_VIEW, AXIS_HYP))


def data_sharding(mesh):
    """DTensor placements that shard the leading (batch) dimension over the
    data axis and replicate over the others."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == AXIS_DATA else Replicate() for name in mesh.mesh_dim_names)


def replicate_sharding(mesh):
    """DTensor placements that replicate over every axis."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, backend=None):
    """Join the process group (once per process, before a mesh is built).

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``: a TCP rendezvous at that address. Without: torch's
    ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, as ``torchrun`` exports them). ``backend`` defaults to NCCL
    where a card is available and gloo elsewhere; with ``LOCAL_RANK`` set,
    that card becomes the process's current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")


def init_distributed_from_env(environ=None):
    """Join the process group from the launcher's environment contract.

    ``python -m robustmvd_tpu_torch.launch`` (and any scheduler template)
    exports ``RMVD_TPU_COORDINATOR`` / ``RMVD_TPU_NUM_PROCESSES`` /
    ``RMVD_TPU_PROCESS_ID``; ``RMVD_TPU_DIST_AUTO=1`` asks for torch's
    ``env://`` variables instead. Neither set: a single process, nothing to
    do. The CLIs call this once at start-up. Returns True if the process
    joined a group."""
    env = os.environ if environ is None else environ
    if dist.is_initialized():
        return True
    if env.get("RMVD_TPU_COORDINATOR"):
        init_distributed(coordinator_address=env["RMVD_TPU_COORDINATOR"],
                         num_processes=int(env.get("RMVD_TPU_NUM_PROCESSES", "1")),
                         process_id=int(env.get("RMVD_TPU_PROCESS_ID", "0")))
        return True
    if env.get("RMVD_TPU_DIST_AUTO"):
        init_distributed()
        return True
    return False
