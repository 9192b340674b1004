"""Model base class: the host<->device boundary and the ``run()`` protocol.

A model of the port is an ``nn.Module`` with a host-side numpy
``input_adapter``, a device ``forward`` and an ``output_adapter`` back to
numpy. ``model.run(**sample)`` adds and removes the batch dim around
adapter -> forward -> adapter, as the reference's injected run function does
(rmvd/models/helpers.py:65-89), so code written against the reference's
model interface runs unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..utils import add_batch_dim, remove_batch_dim, to_numpy
from ..utils.image import resize_bilinear, resize_bilinear_torch


def resize_to_multiple(images, intrinsics, multiple):
    """Resize (B, 3, H, W) views up to a multiple of ``multiple`` and

    scale absolute intrinsics with them (the reference models' input
    adapters, e.g. rmvd/models/mvsnet.py:170-199). Numpy views are resized
    on the host, tensors (views the evaluation staged on the device) where
    they lie, with the same arithmetic, all in one call (one upload of the
    resize's taps). Returns (images, intrinsics, (ht, wd))."""
    orig_ht, orig_wd = images[0].shape[-2:]
    ht = int(math.ceil(orig_ht / multiple) * multiple)
    wd = int(math.ceil(orig_wd / multiple) * multiple)
    if (orig_ht, orig_wd) != (ht, wd):
        if isinstance(images[0], torch.Tensor):
            images = list(resize_bilinear_torch(torch.stack(images), (ht, wd)).unbind(0))
        else:
            images = [resize_bilinear(img, (ht, wd)) for img in images]
        sx, sy = wd / orig_wd, ht / orig_ht
        intrinsics = [K * np.array([[sx, 1, sx], [1, sy, sy], [1, 1, 1]], dtype=np.float32)
                      for K in intrinsics]
    return images, intrinsics, (ht, wd)


# the compute dtypes a ``dtype`` argument names (the JAX package's names)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype_of(dtype, model_name):
    """The torch dtype a model's ``dtype`` argument names."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{model_name} computes in float32 or bfloat16 (bf16), not {dtype!r}")
    return COMPUTE_DTYPES[dtype]


def to_device(a, device, dtype=np.float32):
    """numpy -> tensor on ``device`` (one upload, no host-side conversion

    beyond the dtype). A tensor is moved to ``device``: no copy where it
    already lies there."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def resolve_device(device):
    """``None`` means the card. Without a card, raise and name the CPU option."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or --device cpu) to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but no CUDA device is available")
    return device


class LazyNumpyDict(dict):
    """A dict whose values are converted on first access and kept so: the

    JAX package's ``LazyNumpyDict`` (robustmvd_tpu/models/helpers.py:27-56).
    The native models' output adapters return aux through it, so the
    evaluation, which drops aux, copies only pred to the host. The port's
    conversion is ``to_numpy``'s device->host copy, one per key (its models
    are NCHW inside: JAX's layout transpose has no counterpart).

    Stricter than JAX's, which converts on ``[]``, ``items()`` and
    ``values()`` only: ``get``, ``pop``, ``popitem``, ``setdefault``,
    ``copy``, ``|``, pickling and the copies ``dict(aux)`` / ``{**aux}``
    convert too, since a raw CUDA tensor, unlike a ``jax.Array``, does not
    pass for a numpy array. (Overriding ``__iter__`` sends the two copies
    through ``keys()`` and ``[]`` instead of the dict's own storage.)
    """

    def __init__(self, data, convert):
        super().__init__(data)
        self._convert = convert
        self._done = set()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if key not in self._done:
            value = self._convert(value)
            super().__setitem__(key, value)
            self._done.add(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._done.discard(key)

    def __iter__(self):
        return iter(self.keys())

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def pop(self, key, *default):
        if key not in self:
            return super().pop(key, *default)
        value = self[key]
        super().pop(key)
        self._done.discard(key)
        return value

    def popitem(self):
        key = next(reversed(self.keys()))
        return key, self.pop(key)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def copy(self):
        return dict(self)

    def __or__(self, other):
        return {**self, **other}

    def __reduce__(self):  # pickled and deep-copied as a plain dict of converted values
        return dict, (self.copy(),)


def _run(model, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
    no_batch_dim = images[0].ndim == 3
    if no_batch_dim:
        images, keyview_idx, poses, intrinsics, depth_range = add_batch_dim(
            [images, keyview_idx, poses, intrinsics, depth_range]
        )
    sample = model.input_adapter(
        images=images, keyview_idx=keyview_idx, poses=poses, intrinsics=intrinsics,
        depth_range=depth_range,
    )
    with torch.inference_mode():
        model_output = model(**sample)
    pred, aux = model.output_adapter(model_output)
    if no_batch_dim:
        pred, aux = remove_batch_dim((pred, aux))
    return pred, aux


class ModelBase(nn.Module):
    """An ``nn.Module`` with the reference model protocol.

    Subclasses provide ``input_adapter(images, keyview_idx, poses,
    intrinsics, depth_range)`` returning the keyword arguments of
    ``forward``, ``forward(**sample)`` returning (pred, aux), and optionally
    ``output_adapter``.
    """

    name: str = ""

    @property
    def device(self):
        """Where the parameters live; the input adapter puts inputs there."""
        return next(self.parameters()).device

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        raise NotImplementedError

    def output_adapter(self, model_output):
        """pred to the host in one copy; aux as a :class:`LazyNumpyDict`,
        each value copied on first access (the JAX package's native models'
        adapters)."""
        pred, aux = model_output
        return to_numpy(pred), LazyNumpyDict(aux, to_numpy)

    def run(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None, **_):
        """Numpy in -> numpy out, handling the batch dim

        (reference: rmvd/models/helpers.py:65-89)."""
        return _run(self, images, keyview_idx, poses, intrinsics, depth_range)


def add_run_function(model):
    """Attach the reference-style ``run`` to a duck-typed custom model

    with input_adapter / __call__ / output_adapter (reference:
    rmvd/models/factory.py:32-61 `prepare_custom_model`)."""
    if not hasattr(model, "run"):
        model.run = lambda images, keyview_idx, poses=None, intrinsics=None, depth_range=None, **_: _run(
            model, images, keyview_idx, poses, intrinsics, depth_range
        )
    return model
