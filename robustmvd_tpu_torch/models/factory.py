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
        train: build the model for training (``.train()`` mode); only
            robust_mvd and robust_mvd_5M train in the port so far, the
            MVSNet family raises.
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


def cli_model_kwargs(model_name, dtype=None):
    """The CLIs' model options as create_model arguments (the JAX package's
    ``cli_model_kwargs``): ``--dtype`` exists only for the robust_mvd family
    and exits with a message for any other model. JAX's ``--no_remat`` has no
    counterpart: the port does not rematerialise."""
    if dtype is None:
        return {}
    if not str(model_name).startswith("robust_mvd"):
        raise SystemExit(f"--dtype is only supported by the robust_mvd family, not {model_name}")
    return {"dtype": dtype}


def prepare_custom_model(model):
    """Prepare a duck-typed custom model (input_adapter / __call__ /
    output_adapter) for the run protocol (reference: rmvd/models/factory.py:32-61)."""
    add_run_function(model)
    if not hasattr(model, "name"):
        model.name = type(model).__name__
    return model
