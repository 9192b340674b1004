"""Optimizer and scheduler factories (reference interface: rmvd/optim/factory.py:4-21)."""

from .registry import get_optimizer, get_scheduler


def create_optimizer(name, model=None, **kwargs):
    """A ``torch.optim`` optimizer over ``model``'s parameters, by name."""
    return get_optimizer(name)(model=model, **kwargs)


def create_scheduler(name, optimizer=None, **kwargs):
    """A ``torch.optim.lr_scheduler`` of ``optimizer``, by name."""
    return get_scheduler(name)(optimizer=optimizer, **kwargs)
