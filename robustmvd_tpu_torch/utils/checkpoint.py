"""Checkpoints: iteration-stamped snapshots with pruning (reference:
rmvd/utils/checkpoint_utils.py:8-339), the JAX package's
``utils/checkpoint.py`` with torch's format, which is rmvd's own.

:class:`TrainStateSaver` stores the whole train state (``{"model",
"optimizer", "scheduler", "iteration"}``) as ``snapshot-iter-{:09d}.pt``
and keeps the newest ``max_to_keep``; :class:`WeightsOnlySaver` stores the
model's ``state_dict`` as ``{"model_state_dict": ...}``, the rmvd checkpoint
format that ``models/weights.py::load_checkpoint`` reads. The iteration is
parsed back from the file name. The JAX package writes orbax directories and
flax msgpack files under the same names.
"""

from __future__ import annotations

import os
import os.path as osp
import re

import torch

_ITER_RE = re.compile(r"snapshot-iter-(\d+)")


def iteration_from_path(path):
    """The iteration number in a snapshot's file name (reference:
    checkpoint_utils.py:336-339)."""
    m = _ITER_RE.search(osp.basename(str(path)))
    return int(m.group(1)) if m else None


class _Saver:
    def __init__(self, directory, max_to_keep=None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def path(self, iteration):
        return osp.join(self.directory, f"snapshot-iter-{iteration:09d}.pt")

    def snapshots(self):
        """Snapshot paths, oldest first."""
        names = [f for f in os.listdir(self.directory) if f.startswith("snapshot-iter-") and f.endswith(".pt")]
        return sorted((osp.join(self.directory, f) for f in names), key=iteration_from_path)

    def _write(self, obj, iteration):
        path = self.path(iteration)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)  # a snapshot is complete or absent
        if self.max_to_keep is not None:
            for old in self.snapshots()[: -self.max_to_keep]:
                os.remove(old)
        return path


class TrainStateSaver(_Saver):
    """Save and restore whole train states (reference: checkpoint_utils.py:258-320)."""

    def __init__(self, directory, max_to_keep=3):
        super().__init__(directory, max_to_keep)

    def save(self, state, iteration):
        return self._write(state, iteration)

    def restore(self):
        """(state, iteration) of the newest snapshot; (None, None) where there
        is none."""
        snaps = self.snapshots()
        if not snaps:
            return None, None
        return torch.load(snaps[-1], map_location="cpu", weights_only=True), iteration_from_path(snaps[-1])


class WeightsOnlySaver(_Saver):
    """Save model weights in rmvd's checkpoint format, which
    ``create_model(..., weights=path)`` loads (reference:
    checkpoint_utils.py:205-251)."""

    def save(self, state_dict, iteration):
        return self._write({"model_state_dict": state_dict}, iteration)
