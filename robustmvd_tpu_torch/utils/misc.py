"""Small helpers of the data layer, the evaluation and the CLIs (reference:
rmvd/utils/utils.py:12-19 ``set_random_seed``, ``get_full_class_name``,
:44-50 ``get_function``; rmvd/utils/pandas_utils.py:4-5 ``prepend_level``;
the JAX package's ``utils/utils_misc.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import random

import numpy as np
import torch


def set_random_seed(seed):
    """Seed Python's ``random``, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_full_class_name(obj):
    """``module.QualName`` of a class or of an object's class."""
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def prepend_level(df, name, value, axis=1):
    """A pandas frame with an outer index level ``name`` of constant ``value``."""
    import pandas as pd

    return pd.concat({value: df}, names=[name], axis=axis)


class NanError(Exception):
    """A non-finite value where there must be none (reference parity:
    rmvd/models/blocks/utils.py:91)."""


def check_finite(name, *arrays):
    """Raise :class:`NanError` naming the first of ``arrays`` (numpy arrays
    or tensors on any device) that holds a non-finite value."""
    for i, arr in enumerate(arrays):
        finite = torch.isfinite(arr).all() if isinstance(arr, torch.Tensor) else np.isfinite(np.asarray(arr)).all()
        if not finite:
            raise NanError(f"{name}[{i}] contains non-finite values")


def get_function(name):
    """The attribute a dotted ``module.attr`` path names."""
    mod_name, func_name = name.rsplit(".", 1)
    return getattr(importlib.import_module(mod_name), func_name)


def get_class(name):
    return get_function(name)


def module_exists(name):
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def function_exists(name):
    mod_name, fct_name = name.rsplit(".", 1)
    return module_exists(mod_name) and hasattr(importlib.import_module(mod_name), fct_name)


def class_exists(name):
    return function_exists(name)
