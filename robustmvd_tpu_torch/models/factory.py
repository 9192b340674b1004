"""Model factory (reference interface: rmvd/models/factory.py:8-61)."""

from __future__ import annotations

from ..ops.conv3d import conv3d_impl_of
from .helpers import add_run_function, resolve_device
from .mvsnet import warp_impl_of
from .registry import get_model

# lowering options that also take the JAX package's names for the same lowering
_JAX_NAMES = {"conv3d_impl": conv3d_impl_of, "warp_impl": warp_impl_of}


def create_model(name, pretrained=True, weights=None, train=False, device=None, **kwargs):
    """Create a model by registry name.

    Args:
        name: registered model name.
        pretrained: accepted for interface parity; there is no download,
            so without ``weights`` the weights are initialised from ``seed``.
        weights: path to a rmvd ``.pt`` checkpoint.
        train: training is not part of the port yet; must be False.
        device: ``None`` (the card), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
            Without a card, ``None`` raises instead of using the CPU.
        **kwargs: the model's own arguments; ``conv3d_impl`` and
            ``warp_impl`` also take the JAX package's names (``"packed"``,
            ``"dz2d"``; ``"auto"``, ``"pallas"``, ``"pallas_fused"``).
    """
    entrypoint = get_model(name)
    kwargs = {k: _JAX_NAMES[k](v) if k in _JAX_NAMES else v for k, v in kwargs.items()}
    model = entrypoint(pretrained=pretrained, weights=weights, train=train,
                       device=resolve_device(device), **kwargs)
    model.name = name
    return model


def prepare_custom_model(model):
    """Prepare a duck-typed custom model (input_adapter / __call__ /
    output_adapter) for the run protocol (reference: rmvd/models/factory.py:32-61)."""
    add_run_function(model)
    if not hasattr(model, "name"):
        model.name = type(model).__name__
    return model
