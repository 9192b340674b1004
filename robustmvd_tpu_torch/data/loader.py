"""The data loader: ``torch.utils.data.DataLoader`` with ``numpy_collate``.

Samples stay numpy dicts; batches are collated with
:func:`~robustmvd_tpu_torch.utils.numpy_collate`. Workers (``num_workers``
> 0) are spawned processes, and an error in a worker is raised in the
caller. ``indices`` restricts the loader to a subset of the dataset and
``seed`` fixes the shuffle order.
"""

from __future__ import annotations

import torch

from ..utils import numpy_collate


class DataLoader(torch.utils.data.DataLoader):
    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=0, collate_fn=None,
                 drop_last=False, indices=None, seed=None):
        if indices is not None:
            dataset = torch.utils.data.Subset(dataset, list(indices))
        super().__init__(
            dataset, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers,
            collate_fn=collate_fn or numpy_collate, drop_last=drop_last,
            generator=None if seed is None else torch.Generator().manual_seed(seed),
            multiprocessing_context="spawn" if num_workers > 0 else None,
        )
