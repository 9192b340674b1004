"""Model registry (reference interface: rmvd/models/registry.py:7-53)."""

from __future__ import annotations

from ..utils.registry import Registry

_registry = Registry("model")


def register_model(arg=None, trainable=True):
    """Register a model entrypoint. Usable bare or with ``trainable=``."""

    def _register(fn):
        return _registry.register(fn, trainable=trainable)

    if callable(arg):
        return _register(arg)
    return _register


def list_models(trainable_only=False):
    names = _registry.list()
    if trainable_only:
        names = [n for n in names if _registry.meta(n).get("trainable", True)]
    return names


def has_model(name, trainable_only=False):
    return name in list_models(trainable_only=trainable_only)


def get_model(name):
    return _registry.get(name)
