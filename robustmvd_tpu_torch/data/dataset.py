"""Dataset base class: the numpy host data path (reference:
rmvd/data/dataset.py:19-367).

A dataset is a list of lazy :class:`Sample` objects, read from the package's
own sample lists (``data/sample_lists/*.pickle``). Loading a sample runs
``_preprocess_sample`` (depth and inverse depth sanitised, depth_range, poses
rebased onto the key view), then the updates, the augmentations and the
input and target resizes. Roots come from ``data/paths.toml``.

The sample lists are pickles of the JAX package's classes (and rmvd's name
them ``rmvd.data.*``). :func:`load_sample_list` reads them with an
unpickler that maps such a class path onto this package's class of the same
module and name, so that reading them imports neither package.
"""

from __future__ import annotations

import abc
import importlib
import os.path as osp
import pickle

import numpy as np

from ..utils import logging
from ..utils import paths as paths_util
from ..utils.geometry import compute_depth_range, invert_transform
from .loader import DataLoader
from .transforms import ResizeInputs, ResizeTargets
from .registry import create_augmentation
from .updates import PickledUpdates

_PACKAGE = __name__.split(".")[0]


class Sample(abc.ABC):
    @abc.abstractmethod
    def load(self, root):
        ...


def port_module(module):
    """This package's module for a pickled class path of the same framework:

    ``<root>.data.<module>`` and ``<root>.utils.<module>``, where the root is
    rmvd's or one that this package's name starts with (the JAX package's),
    map onto ``<this package>.data.<module>`` and ``.utils.<module>``; any
    other path stays as it is."""
    root, _, tail = module.partition(".")
    if (root == "rmvd" or _PACKAGE.startswith(root)) and tail.split(".")[0] in ("data", "utils"):
        return f"{_PACKAGE}.{tail}"
    return module


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        return super().find_class(port_module(module), name)


def load_sample_list(path):
    """A pickled sample list (or config) with its classes taken from this
    package (:func:`port_module`)."""
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


def _sample_list_path(name):
    return osp.join(osp.dirname(osp.realpath(__file__)), "sample_lists", f"{name}.pickle")


def _preprocess_sample(sample):
    """Sanitize depth/invdepth, derive depth_range, rebase poses to the key

    view (reference: rmvd/data/dataset.py:343-367)."""
    assert ("depth" in sample or "invdepth" in sample) and not (
        "depth" in sample and "invdepth" in sample
    )

    if "depth" in sample:
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = sample["depth"].astype(np.float32)
            depth[depth <= 0] = 0
            depth[~np.isfinite(depth)] = 0
            sample["depth"] = depth
            sample["invdepth"] = np.nan_to_num(
                1 / depth, copy=False, nan=0, posinf=0, neginf=0
            )
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            invdepth = sample["invdepth"].astype(np.float32)
            invdepth[invdepth <= 0] = 0
            invdepth[~np.isfinite(invdepth)] = 0
            sample["invdepth"] = invdepth
            sample["depth"] = np.nan_to_num(
                1 / invdepth, copy=False, nan=0, posinf=0, neginf=0
            )

    if "depth_range" not in sample:
        sample["depth_range"] = compute_depth_range(depth=sample["depth"])

    key_idx = sample.get("keyview_idx", 0)
    key_to_ref = sample["poses"][key_idx]
    ref_to_key = invert_transform(key_to_ref)
    sample["poses"] = [
        np.dot(to_ref, ref_to_key) for to_ref in sample["poses"]
    ]
    return sample


class Dataset(abc.ABC):
    base_dataset: str = ""
    split: str = ""
    dataset_type: str = ""

    def __init__(
        self,
        root=None,
        augmentations=None,
        input_size=None,
        target_size=None,
        updates=None,
        update_strict=False,
        layouts=None,
        verbose=True,
        **kwargs,
    ):
        if augmentations is not None and not isinstance(augmentations, list):
            augmentations = [augmentations]
        self.verbose = verbose

        self.root = None
        self._init_root(root)

        if self.verbose:
            logging.info(f"Initializing dataset {self.name} from {self.root}")

        self.input_resize = ResizeInputs(size=input_size) if input_size is not None else None
        self.target_resize = ResizeTargets(size=target_size) if target_size is not None else None
        # callables on the sample dict, or augmentation presets by name
        self.augmentations = [create_augmentation(a) if isinstance(a, str) else a for a in augmentations or []]

        self.samples = []
        self._init_samples(**kwargs)
        self._layouts = {}
        self._init_layouts(layouts)
        self.updates = []
        self._allowed_indices = []
        self._init_updates(updates, update_strict)

        if self.verbose:
            logging.info(f"\tNumber of samples: {len(self)}")

    @property
    def name(self):
        if self.base_dataset:
            name = self.base_dataset
            if self.split:
                name = f"{name}.{self.split}"
            if self.dataset_type:
                name = f"{name}.{self.dataset_type}"
            return name
        return type(self).__name__

    @property
    def full_name(self):
        name = self.name
        for update in self.updates:
            name += f"+{update.name}"
        return name

    def _init_root(self, root):
        if isinstance(root, str):
            self.root = root
        elif isinstance(root, list):
            existing = [p for p in root if osp.isdir(p)]
            self.root = existing[0] if existing else root[0]

    def _get_path(self, *keys):
        return paths_util.get_path(*keys)

    def _init_samples(self, **kwargs):
        self._init_samples_from_list()

    def _init_samples_from_list(self):
        path = _sample_list_path(self.name)
        if self.verbose:
            logging.info(f"\tInitializing samples from list at {path}")
        self.samples = load_sample_list(path)

    def _write_samples_list(self, path=None):
        path = _sample_list_path(self.name) if path is None else path
        with open(path, "wb") as f:
            pickle.dump(self.samples, f)

    def _init_updates(self, updates, update_strict=False):
        if updates is not None:
            for update in updates:
                if isinstance(update, str):
                    update = PickledUpdates(path=update)
                self.updates.append(update)

        if update_strict:
            self._allowed_indices = [
                i
                for i in range(len(self.samples))
                if all(i in u for u in self.updates)
            ]
        else:
            self._allowed_indices = list(range(len(self.samples)))

    def _init_layouts(self, layouts):
        if layouts is not None:
            from .layout import Layout

            for layout in layouts:
                if not isinstance(layout, Layout):
                    layout = Layout.from_file(layout)
                self.add_layout(layout)

    def add_layout(self, layout):
        self._layouts[layout.name.lower()] = layout

    def get_layout_names(self):
        return list(self._layouts.keys())

    def get_layout(self, layout_name=None):
        layout_name = layout_name if layout_name is not None else "default"
        return self._layouts[layout_name.lower()]

    def __len__(self):
        return len(self._allowed_indices)

    def __getitem__(self, index):
        index = self._allowed_indices[index]
        sample = self.samples[index]

        sample_dict = sample.load(root=self.root)
        sample_dict["_index"] = index
        sample_dict["_dataset"] = self.full_name

        _preprocess_sample(sample_dict)

        for update in self.updates:
            update.apply_update(sample_dict, index=index)
        for augmentation in self.augmentations:
            augmentation(sample_dict)
        if self.input_resize is not None:
            self.input_resize(sample_dict)
        if self.target_resize is not None:
            self.target_resize(sample_dict)

        return sample_dict

    def __str__(self):
        return self.name

    def get_loader(
        self,
        batch_size=1,
        shuffle=False,
        num_workers=0,
        collate_fn=None,
        drop_last=False,
        indices=None,
        seed=None,
        **_,
    ):
        return DataLoader(
            self,
            batch_size=batch_size,
            shuffle=shuffle,
            num_workers=num_workers,
            collate_fn=collate_fn,
            drop_last=drop_last,
            indices=indices,
            seed=seed,
        )

    # --- config round-trip (reference: dataset.py:256-304) ---------------

    @classmethod
    def write_config(
        cls,
        path,
        dataset_cls_name,
        augmentations=None,
        input_size=None,
        updates=None,
        update_strict=False,
        layouts=None,
    ):
        config = {
            "dataset_cls_name": dataset_cls_name,
            "augmentations": augmentations,
            "input_size": input_size,
            "updates": updates,
            "update_strict": update_strict,
            "layouts": layouts,
        }
        with open(path, "wb") as f:
            pickle.dump(config, f)

    @classmethod
    def from_config(cls, path, more_updates=None, more_layouts=None, verbose=None):
        config = load_sample_list(path)

        if more_updates is not None:
            more_updates = more_updates if isinstance(more_updates, list) else [more_updates]
            config["updates"] = (config.get("updates") or []) + more_updates
        if more_layouts is not None:
            more_layouts = more_layouts if isinstance(more_layouts, list) else [more_layouts]
            config["layouts"] = (config.get("layouts") or []) + more_layouts
        if verbose is not None:
            config["verbose"] = verbose

        module_name, _, class_name = config.pop("dataset_cls_name").rpartition(".")
        dataset_cls = getattr(importlib.import_module(port_module(module_name)), class_name)
        return dataset_cls(**config)
