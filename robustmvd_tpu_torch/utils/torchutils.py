"""Torch helpers of the wrapped-model path, the JAX package's
``utils/torchutils.py`` (reference: rmvd/utils/utils.py:106-295): numpy
containers to tensors on a device, default collation, and a torch model's
device and parameter count."""

from __future__ import annotations

import collections.abc
import re

import numpy as np
import torch
import torch.utils.data

string_classes = (str, bytes)

_np_str_obj_array_pattern = re.compile(r"[SaUO]")


def to_torch(data, device=None):
    """Recursively convert numpy containers to torch tensors on ``device``

    (reference: rmvd/utils/utils.py:126-167; string/object ndarrays pass
    through unconverted, like torch's default_convert)."""
    if data is None:
        return None
    elem_type = type(data)
    if isinstance(data, torch.Tensor):
        return data.to(device)
    if elem_type.__module__ == "numpy" and elem_type.__name__ not in ("str_", "string_"):
        if elem_type.__name__ == "ndarray" and _np_str_obj_array_pattern.search(data.dtype.str) is not None:
            return data
        return torch.as_tensor(np.ascontiguousarray(data), device=device)
    if isinstance(data, collections.abc.Mapping):
        try:
            return elem_type({k: to_torch(v, device=device) for k, v in data.items()})
        except TypeError:
            return {k: to_torch(v, device=device) for k, v in data.items()}
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(to_torch(d, device=device) for d in data))
    if isinstance(data, tuple):
        return [to_torch(d, device=device) for d in data]
    if isinstance(data, collections.abc.Sequence) and not isinstance(data, string_classes):
        try:
            return elem_type([to_torch(d, device=device) for d in data])
        except TypeError:
            return [to_torch(d, device=device) for d in data]
    return data


def to_cuda(data, device=None):
    """Recursively move torch tensors to CUDA (reference: utils.py:106-117);
    other values pass through. Raises where there is no CUDA device, as
    torch does."""
    if isinstance(data, dict):
        return {k: to_cuda(v, device) for k, v in data.items()}
    if isinstance(data, list):
        return [to_cuda(v, device) for v in data]
    if isinstance(data, tuple):
        return tuple(to_cuda(v, device) for v in data)
    if isinstance(data, torch.Tensor):
        return data.cuda(device=device)
    return data


def torch_collate(batch):
    """torch's default_collate (reference: utils.py:119-123)."""
    if batch is None:
        return None
    return torch.utils.data.default_collate(batch)


def get_torch_model_device(model):
    """Device of a torch model, asserting all params agree

    (reference: utils.py:275-282)."""
    it = iter(model.parameters())
    device = next(it).device
    if not all(p.device == device for p in it):
        raise RuntimeError("All model parameters need to be on the same device")
    return device


def check_torch_model_cuda(model):
    """True if the model lives on the GPU (reference: utils.py:285-291)."""
    it = iter(model.parameters())
    is_cuda = next(it).is_cuda
    if not all(p.is_cuda == is_cuda for p in it):
        raise RuntimeError("All model parameters need to be on the same device")
    return is_cuda


def count_torch_model_parameters(model):
    """Trainable parameter count (reference: utils.py:294-295)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
