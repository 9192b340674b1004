"""Dataset updates: overlay dicts that patch loaded samples by index

(reference: rmvd/data/updates.py:17-96). The evaluation writes per-sample
prediction overlays back onto its dataset so that a viewer can show them.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np


class Update:
    """A single sample update; ``load`` returns a dict merged into the sample."""

    def load(self, orig_sample_dict, root=None):
        raise NotImplementedError


class DictUpdate(Update):
    """Update from a plain dict; string values pointing at .npy files are

    lazily loaded (reference: MultiMultiViewDepthEvaluationUpdate,
    multi_view_depth_evaluation.py:885-896)."""

    def __init__(self, update_dict=None):
        self.update_dict = update_dict or {}

    def load(self, orig_sample_dict, root=None):
        out = {}
        for key, val in self.update_dict.items():
            if isinstance(val, str) and osp.isfile(val):
                val = np.load(val)
            out[key] = val
        return out


class Updates:
    """A collection of per-index updates (reference: updates.py:17-63)."""

    def __init__(self, name=None, updates=None):
        self.name = name or type(self).__name__
        self._updates = updates or {}

    def __contains__(self, index):
        return index in self._updates

    def __len__(self):
        return len(self._updates)

    def apply_update(self, sample_dict, index):
        if index in self._updates:
            update = self._updates[index]
            if isinstance(update, dict):
                update = DictUpdate(update)
            sample_dict.update(update.load(sample_dict))
        return sample_dict


class PickledUpdates(Updates):
    """Updates stored in a pickle file (reference: updates.py:66-96)."""

    def __init__(self, path, name=None):
        with open(path, "rb") as f:
            updates = pickle.load(f)
        name = name or osp.splitext(osp.basename(path))[0]
        super().__init__(name=name, updates=updates)
