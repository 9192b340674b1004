"""Dataset registry keyed by (base_dataset, dataset_type, split).

Interface of the reference registry (rmvd/data/registry.py:8-252), as in the
JAX package: dataset names are dotted ``base[.split][.type]`` strings; a
registered default split resolves names like ``eth3d.mvd`` ->
``(eth3d, mvd, robustmvd)``. Augmentation and batch augmentation presets
have registries of their own, by name.
"""

from __future__ import annotations

_datasets = {}  # (base_dataset, dataset_type, split) -> dataset class
_default_splits = {}  # (base_dataset, dataset_type) -> split


def register_dataset(dataset_cls):
    key = (
        dataset_cls.base_dataset.lower(),
        dataset_cls.dataset_type.lower(),
        dataset_cls.split.lower(),
    )
    if key in _datasets:
        raise ValueError(f"Dataset {key} is already registered.")
    _datasets[key] = dataset_cls
    return dataset_cls


def register_default_dataset(dataset_cls):
    register_dataset(dataset_cls)
    key = (dataset_cls.base_dataset.lower(), dataset_cls.dataset_type.lower())
    if key in _default_splits:
        raise ValueError(f"Dataset {key} already has a default split.")
    _default_splits[key] = dataset_cls.split.lower()
    return dataset_cls


def _filter_datasets(base_dataset=None, dataset_type=None, split=None):
    base_dataset = base_dataset.lower() if base_dataset is not None else None
    dataset_type = dataset_type.lower() if dataset_type is not None else None
    split = split.lower() if split is not None else None
    keys = _datasets.keys()
    return [
        k
        for k in keys
        if (base_dataset is None or k[0] == base_dataset)
        and (dataset_type is None or k[1] == dataset_type)
        and (split is None or k[2] == split)
    ]


def list_datasets(
    base_dataset=None, dataset_type=None, split=None, no_dataset_type=False, no_split=False
):
    keys = _filter_datasets(base_dataset, dataset_type, split)
    names = [
        _build_dataset_name(*k, no_dataset_type=no_dataset_type, no_split=no_split)
        for k in keys
    ]
    return sorted(names)


def list_base_datasets(dataset_type=None, split=None):
    return sorted({k[0] for k in _filter_datasets(dataset_type=dataset_type, split=split)})


def list_dataset_types(base_dataset=None, split=None):
    return sorted({k[1] for k in _filter_datasets(base_dataset=base_dataset, split=split)})


def list_splits(base_dataset=None, dataset_type=None):
    return sorted(
        {k[2] for k in _filter_datasets(base_dataset=base_dataset, dataset_type=dataset_type)}
    )


def _peel_dataset_type(parts, dataset_type):
    """Remove a trailing known type token from the name's parts."""
    if parts[-1] in list_dataset_types():
        if dataset_type is not None and parts[-1] != dataset_type:
            raise ValueError("The given dataset name conflicts with the given dataset type.")
        return parts[:-1], parts[-1]
    return parts, dataset_type


def _split_dataset_name(dataset_name, dataset_type=None, split=None):
    """Parse a dotted dataset name -> (base_dataset, dataset_type, split).

    Resolution rules identical to the reference
    (rmvd/data/registry.py:114-146): a trailing known type token is peeled
    off; the default split fills in when none is given; an explicit split
    token is removed from the remaining parts; otherwise the last part is
    the split.
    """
    dataset_name = dataset_name.lower()
    dataset_type = dataset_type.lower() if dataset_type is not None else None
    split = split.lower() if split is not None else None

    parts = dataset_name.split(".")

    parts, dataset_type = _peel_dataset_type(parts, dataset_type)
    if dataset_type is None:
        raise ValueError(f"Dataset type must be provided. Available types: {','.join(list_dataset_types())}")

    if split is None and (".".join(parts), dataset_type) in _default_splits:
        split = _default_splits[(".".join(parts), dataset_type)]
    if split is not None and split in parts:
        parts.remove(split)
    if split is None:
        parts, split = parts[:-1], parts[-1]

    return ".".join(parts), dataset_type, split


def _build_dataset_name(
    dataset_name, dataset_type=None, split=None, no_dataset_type=False, no_split=False
):
    """Normalize to the canonical ``base.split.type`` dotted name

    (reference: rmvd/data/registry.py:149-179)."""
    dataset_name = dataset_name.lower()
    dataset_type = dataset_type.lower() if dataset_type is not None else None
    split = split.lower() if split is not None else None

    parts = dataset_name.split(".")

    parts, dataset_type = _peel_dataset_type(parts, dataset_type)

    if split is None and dataset_type is not None and (".".join(parts), dataset_type) in _default_splits:
        split = _default_splits[(".".join(parts), dataset_type)]
    if split is not None and split in parts:
        parts.remove(split)

    if split is not None and not no_split:
        parts = parts + [split]
    if dataset_type is not None and not no_dataset_type:
        parts = parts + [dataset_type]
    return ".".join(parts)


def has_dataset(dataset_name, dataset_type=None, split=None):
    try:
        key = _split_dataset_name(dataset_name, dataset_type, split)
    except (ValueError, IndexError):
        return False
    return key in _datasets


def get_dataset(dataset_name, dataset_type=None, split=None):
    key = _split_dataset_name(dataset_name, dataset_type, split)
    if key not in _datasets:
        raise ValueError(f"Dataset {key} is not registered. Available: {sorted(_datasets)}")
    return _datasets[key]


# augmentation presets and batch augmentation presets, by function name
_aug_fcts = {}
_batch_aug_fcts = {}


def register_augmentation(fn):
    _aug_fcts[fn.__name__] = fn
    return fn


def list_augmentations():
    return sorted(_aug_fcts)


def has_augmentation(name):
    return name in _aug_fcts


def create_augmentation(name, **kwargs):
    if not has_augmentation(name):
        raise ValueError(f'Unknown augmentation "{name}". Available: {" ".join(list_augmentations())}')
    return _aug_fcts[name](**kwargs)


def register_batch_augmentation(fn):
    _batch_aug_fcts[fn.__name__] = fn
    return fn


def list_batch_augmentations():
    return sorted(_batch_aug_fcts)


def has_batch_augmentation(name):
    return name in _batch_aug_fcts


def create_batch_augmentation(name, **kwargs):
    if not has_batch_augmentation(name):
        raise ValueError(f'Unknown batch augmentation "{name}". Available: {" ".join(list_batch_augmentations())}')
    return _batch_aug_fcts[name](**kwargs)
