"""Host-side plumbing for the ``run()`` protocol: batch dims and numpy output.

The data contract (reference: rmvd/data/README.md "Data format"): a sample
is a dict with ``images`` (list of 3HW float32, 0..255), ``poses`` (list of
4x4 cur->key), ``intrinsics`` (list of 3x3), ``keyview_idx`` (int) and
``depth_range`` ((min, max)). ``numpy_collate`` batches samples,
``add_batch_dim`` turns one sample into a batch of one and
``remove_batch_dim`` undoes it on the outputs.
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch


def numpy_collate(batch):
    """Collate a list of samples into a batched sample.

    Dicts are collated per key; lists and tuples are transposed (a list of
    per-view arrays stays a list, each element batched); arrays and scalars
    are stacked along a new leading batch axis; strings stay a list
    (reference: rmvd/utils/utils.py:170-237).
    """
    elem = batch[0]
    if elem is None:
        return None
    if isinstance(elem, np.ndarray):
        return np.stack(batch, 0)
    if isinstance(elem, np.generic):
        return np.array(batch)
    if isinstance(elem, float):
        return np.array(batch, dtype=np.float32)
    if isinstance(elem, int):
        return np.array(batch)
    if isinstance(elem, str):
        return list(batch)
    if isinstance(elem, collections.abc.Mapping):
        return {key: numpy_collate([d[key] for d in batch]) for key in elem}
    if isinstance(elem, collections.abc.Sequence):
        if len({len(e) for e in batch}) != 1:
            raise RuntimeError("numpy_collate: each list in a batch must have equal length")
        return [numpy_collate(samples) for samples in zip(*batch)]
    raise TypeError(f"numpy_collate: unsupported element type {type(elem)}")


def add_batch_dim(sample):
    """Wrap a single (unbatched) sample into a batch of one."""
    return numpy_collate([sample])


def select_by_index(views, idx):
    """One element of a list of (possibly batched) views: ``idx`` is an int,
    or one index per batch sample (reference: rmvd/utils/utils.py:298-321)."""
    if isinstance(idx, (int, np.integer)):
        return views[int(idx)]
    indices = np.asarray(idx).reshape(-1)
    return np.stack([views[int(i)][b] for b, i in enumerate(indices)], 0)


def exclude_index(views, exclude_idx):
    """All elements of a view list but one index, per batch sample

    (reference: rmvd/utils/utils.py:324-347)."""
    if isinstance(exclude_idx, (int, np.integer)):
        return [v for i, v in enumerate(views) if i != int(exclude_idx)]
    per_sample = [[v[b] for i, v in enumerate(views) if i != int(e)]
                  for b, e in enumerate(np.asarray(exclude_idx).reshape(-1))]
    if not per_sample or not all(per_sample):
        return per_sample
    return [np.stack(group, 0) for group in zip(*per_sample)]


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
