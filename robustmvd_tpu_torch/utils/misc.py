"""Small helpers of the data layer and the evaluation (reference:
rmvd/utils/utils.py:12-19 ``get_full_class_name``,
rmvd/utils/pandas_utils.py:4-5 ``prepend_level``)."""

from __future__ import annotations


def get_full_class_name(obj):
    """``module.QualName`` of a class or of an object's class."""
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def prepend_level(df, name, value, axis=1):
    """A pandas frame with an outer index level ``name`` of constant ``value``."""
    import pandas as pd

    return pd.concat({value: df}, names=[name], axis=axis)
