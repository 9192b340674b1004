"""Wrapped-model adapter protocol.

Reference: rmvd/models/wrappers/wrappers.py:8-21 and the per-model wrappers,
through the JAX package's ``models/wrappers/``. A wrapped model adapts an
external torch repository (Vis-MVSNet, CVP-MVSNet, mvsnet_pl, PatchmatchNet,
monodepth2, MiDaS) to the run protocol: ``input_adapter`` (numpy, the JAX
wrapper's arithmetic), ``__call__`` (the external network, on ``device``)
and ``output_adapter`` (one copy back to numpy). The JAX package runs these
networks on the host CPU; the port moves each network and its inputs to the
device it was built for, the card unless the caller asks for the CPU.
``device`` (a ``torch.device``) tells the evaluation engine where to time
the forward.

External repository roots resolve from ``paths.toml`` next to this file
(``PATHS_FILE``); ``scripts/setup_*.sh`` fetch the repositories and their
weights, which needs the network.
"""

from __future__ import annotations

import abc
import os.path as osp
import sys
import tomllib

import numpy as np
import torch

from ...utils import add_batch_dim, remove_batch_dim, to_numpy

PATHS_FILE = osp.join(osp.dirname(osp.realpath(__file__)), "paths.toml")


def get_wrapper_path(*keys):
    """Resolve an external repo path from wrappers/paths.toml."""
    if not osp.isfile(PATHS_FILE):
        return None
    with open(PATHS_FILE, "rb") as f:
        node = tomllib.load(f)
    for key in keys:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def add_repo_to_path(name):
    """sys.path-insert an external repo (reference wrapper pattern)."""
    repo = get_wrapper_path(name, "root")
    if repo is None or not osp.isdir(repo):
        raise FileNotFoundError(
            f"External repository for '{name}' not found. Configure its root in "
            f"{PATHS_FILE} and run the corresponding setup script in "
            f"robustmvd_tpu_torch/models/wrappers/scripts/."
        )
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return repo


def check_pretrained(name, pretrained, weights):
    """A wrapped model runs its repository's own pretrained weights only."""
    if not pretrained or weights is not None:
        raise ValueError(f"{name} runs its repository's pretrained weights: pretrained=True, weights=None")


def load_repo_checkpoint(path):
    """A checkpoint file of an external repository, on the CPU.

    Unpickled in full (``weights_only=False``): the files are the ones the
    setup scripts fetch with the repository whose code the wrapper imports
    and runs anyway, so they are trusted as that code is; and a Lightning
    ``.ckpt`` (mvsnet_pl's) pickles its hyper-parameters as objects, which
    torch's weights-only loader, its default since 2.6, refuses."""
    return torch.load(path, map_location="cpu", weights_only=False)


class ModelWrappers(abc.ABC):
    """The wrapped-model protocol (reference: wrappers.py:8-21)."""

    name: str = ""
    trainable: bool = False
    device: torch.device

    @abc.abstractmethod
    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        ...

    @abc.abstractmethod
    def __call__(self, **sample):
        ...

    def output_adapter(self, model_output):
        """(pred, aux) of tensors on the device -> numpy, in one copy."""
        pred, aux = to_numpy(model_output)
        return pred, aux

    def run(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None, **_):
        no_batch_dim = images[0].ndim == 3
        if no_batch_dim:
            images, keyview_idx, poses, intrinsics, depth_range = add_batch_dim(
                [images, keyview_idx, poses, intrinsics, depth_range]
            )
        sample = self.input_adapter(
            images=images,
            keyview_idx=keyview_idx,
            poses=poses,
            intrinsics=intrinsics,
            depth_range=depth_range,
        )
        output = self(**sample)
        pred, aux = self.output_adapter(output)
        if no_batch_dim:
            pred, aux = remove_batch_dim((pred, aux))
        return pred, aux

    def num_parameters(self):
        model = getattr(self, "model", None)
        if model is not None and hasattr(model, "parameters"):
            return sum(int(np.prod(p.shape)) for p in model.parameters())
        return 0
