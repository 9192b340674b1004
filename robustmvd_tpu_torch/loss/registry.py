"""Loss registry (reference interface: rmvd/loss/registry.py)."""

from ..utils.registry import Registry

_registry = Registry("loss")


def register_loss(fn):
    return _registry.register(fn)


def list_losses():
    return _registry.list()


def has_loss(name):
    return name in _registry.list()


def get_loss(name):
    return _registry.get(name)
