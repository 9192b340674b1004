"""Concatenation of datasets with a cumulative index (reference:
rmvd/data/compound_dataset.py:5-91), the JAX package's
``data/compound_dataset.py``."""

from __future__ import annotations

import numpy as np

from .loader import DataLoader


class CompoundDataset:
    def __init__(self, datasets, common_keys=None):
        self.datasets = datasets
        self.dataset_lens = [len(ds) for ds in datasets]
        self.dataset_start_indices = [0] + list(np.cumsum(self.dataset_lens))[:-1]
        self.common_keys = common_keys

    @property
    def name(self):
        return "+".join(ds.name for ds in self.datasets)

    @property
    def full_name(self):
        return "+".join(ds.full_name for ds in self.datasets)

    def __str__(self):
        return self.name

    def __len__(self):
        return sum(self.dataset_lens)

    def __getitem__(self, index):
        for dataset_idx, dataset_start in enumerate(self.dataset_start_indices):
            if (
                dataset_idx == len(self.datasets) - 1
                or self.dataset_start_indices[dataset_idx + 1] > index
            ):
                sample = self.datasets[dataset_idx][index - dataset_start]
                break
        if self.common_keys is not None:
            sample = {k: sample[k] for k in self.common_keys}
        return sample

    def get_loader(self, **kwargs):
        return DataLoader(self, **kwargs)
