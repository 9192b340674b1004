"""Loss registry (reference interface: rmvd/loss/registry.py)."""

from ..utils.registry import Registry

_registry = Registry("loss")


def register_loss(fn, name=None):
    """Register a loss entrypoint under ``name`` (default: its own name)."""
    return _registry.register(fn, name=name)


def list_losses():
    return _registry.list()


def has_loss(name):
    return name in _registry.list()


def get_loss(name):
    return _registry.get(name)
