"""Optimizer and scheduler registries (reference interface: rmvd/optim/registry.py)."""

from ..utils.registry import Registry

_optimizers = Registry("optimizer")
_schedulers = Registry("scheduler")


def register_optimizer(fn):
    return _optimizers.register(fn)


def register_scheduler(fn):
    return _schedulers.register(fn)


def list_optimizers():
    return _optimizers.list()


def list_schedulers():
    return _schedulers.list()


def has_optimizer(name):
    return name in _optimizers.list()


def has_scheduler(name):
    return name in _schedulers.list()


def get_optimizer(name):
    return _optimizers.get(name)


def get_scheduler(name):
    return _schedulers.get(name)
