"""Dataset factory (reference: rmvd/data/factory.py:10-91)."""

from __future__ import annotations

import os

from .dataset import Dataset
from .loader import DataLoader
from .registry import get_dataset


def create_dataset(dataset_name_or_path, dataset_type=None, split=None, **kwargs):
    """A dataset by registry name, or re-opened from a ``dataset.cfg`` that an

    evaluation wrote (reference: rmvd/data/factory.py:10-34,
    dataset.py:256-304)."""
    if os.path.exists(dataset_name_or_path):
        return Dataset.from_config(dataset_name_or_path, **kwargs)
    cls = get_dataset(dataset_name_or_path, dataset_type=dataset_type, split=split)
    return cls(**kwargs)


def create_dataloader(dataset, batch_size=1, shuffle=False, num_workers=0, drop_last=False, collate_fn=None,
                      seed=None):
    """A loader over ``dataset`` (:class:`~robustmvd_tpu_torch.data.loader.DataLoader`;
    reference: rmvd/data/factory.py:36-91)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers,
                      drop_last=drop_last, collate_fn=collate_fn, seed=seed)
