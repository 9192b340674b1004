"""Host-side plumbing for the ``run()`` protocol: batch dims and numpy output.

The data contract (reference: rmvd/data/README.md "Data format"): a sample
is a dict with ``images`` (list of 3HW float32, 0..255), ``poses`` (list of
4x4 cur->key), ``intrinsics`` (list of 3x3), ``keyview_idx`` (int) and
``depth_range`` ((min, max)). ``add_batch_dim`` turns one such sample into a
batch of one, ``remove_batch_dim`` undoes it on the outputs.
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch


def _collate(batch):
    """Stack a list of samples along a new leading batch axis.

    Lists stay lists, each element batched (reference:
    rmvd/utils/utils.py:170-237).
    """
    elem = batch[0]
    if elem is None:
        return None
    if isinstance(elem, np.ndarray):
        return np.stack(batch, 0)
    if isinstance(elem, float):
        return np.array(batch, dtype=np.float32)
    if isinstance(elem, (int, np.integer, np.generic)):
        return np.array(batch)
    if isinstance(elem, collections.abc.Sequence):
        return [_collate(samples) for samples in zip(*batch)]
    raise TypeError(f"cannot collate elements of type {type(elem)}")


def add_batch_dim(sample):
    """Wrap a single (unbatched) sample into a batch of one."""
    return _collate([sample])


def remove_batch_dim(data):
    """Strip the leading batch axis from every array in a nested structure.

    Inverse of :func:`add_batch_dim` for batch size 1 (reference:
    rmvd/models/helpers.py:28-62).
    """
    if data is None:
        return None
    if isinstance(data, (np.ndarray, torch.Tensor)):
        return data[0]
    if isinstance(data, collections.abc.Mapping):
        return {k: remove_batch_dim(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [remove_batch_dim(v) for v in data]
    return data


def to_numpy(data):
    """Recursively convert tensors (on any device) to numpy arrays.

    Tensors of one device and dtype come back in one copy (a device->host
    copy synchronises, and the model's outputs are some 25 small maps); each
    array is a view of its own part of that copy. From the card the copy
    lands in page-locked memory, which PyTorch's host allocator recycles:
    a fresh pageable buffer of that size would be page-faulted in during
    the copy, frame after frame.
    """
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x.detach())
        elif isinstance(x, collections.abc.Mapping):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(data)
    arrays = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            flat = host.copy_(flat)
        flat = flat.cpu().numpy()
        offsets = np.cumsum([tensors[i].numel() for i in idx])[:-1]
        for i, part in zip(idx, np.split(flat, offsets)):
            arrays[i] = part.reshape(tensors[i].shape)
    it = iter(arrays)

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, collections.abc.Mapping):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [rebuild(v) for v in x]
        return x

    return rebuild(data)
