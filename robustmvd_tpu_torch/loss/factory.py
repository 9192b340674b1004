"""Loss factory (reference interface: rmvd/loss/factory.py:4)."""

from .registry import get_loss


def create_loss(name, model=None, **kwargs):
    """A loss by name. ``model`` gives the losses their L2 parameter set

    (reference: rmvd/loss/multi_scale_uni_laplace.py:58-77)."""
    return get_loss(name)(model=model, **kwargs)
