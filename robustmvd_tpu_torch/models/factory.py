"""Model factory (reference interface: rmvd/models/factory.py:8-61)."""

from __future__ import annotations

from ..ops.conv3d import conv3d_impl_of
from ..ops.corr import corr_impl_of
from .helpers import add_run_function, resolve_device
from .mvsnet import warp_impl_of
from .registry import get_model

# lowering options that also take the JAX package's names for the same lowering
# (corr_impl's also depend on the compute dtype)
_JAX_NAMES = {"conv3d_impl": conv3d_impl_of, "warp_impl": warp_impl_of, "corr_impl": corr_impl_of}
_BY_DTYPE = ("corr_impl",)
# the JAX package's options that only tile its TPU programs: the port computes
# the same function without them, so it takes no value for them
_TPU_TILING = {
    "slab_size": "the hypothesis slab of the JAX correlation's sampling scan on the TPU",
    "s2d": "the JAX encoder's space-to-depth rewrite of its stride-2 convolutions for the TPU",
}


def _lowering(key, value, kwargs):
    if key in _TPU_TILING:
        raise ValueError(f"{key} sets {_TPU_TILING[key]}; the port has no counterpart (one value per "
                         "behaviour), so it takes no such option")
    if key in _BY_DTYPE:
        return _JAX_NAMES[key](value, kwargs.get("dtype", "float32"))
    return _JAX_NAMES[key](value) if key in _JAX_NAMES else value


def create_model(name, pretrained=True, weights=None, train=False, device=None, **kwargs):
    """Create a model by registry name.

    Args:
        name: registered model name.
        pretrained: accepted for interface parity; there is no download,
            so without ``weights`` the weights are initialised from ``seed``.
        weights: path to a rmvd ``.pt`` checkpoint.
        train: build the model for training (``.train()`` mode), with the
            JAX package's training routes: the MVSNet family takes its
            ``warp_impl="xla"`` route (K2, K2 group and K4 are forward-only);
            vis_mvsnet trains its BatchNorms on batch statistics
            (``bn_mode="batch"``, or ``"frozen"``), mvsnet_train and
            cvp_mvsnet keep theirs frozen, and cvp_mvsnet spaces its
            refinement hypotheses by the constant training interval.
        device: ``None`` (the card), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
            Without a card, ``None`` raises instead of using the CPU.
        **kwargs: the model's own arguments; ``conv3d_impl`` and
            ``warp_impl`` also take the JAX package's names (``"packed"``,
            ``"dz2d"``; ``"auto"``, ``"pallas"``, ``"pallas_fused"``), and
            robust_mvd's ``corr_impl`` JAX's names of the routes that compute
            the port's correlation at its ``dtype``; JAX's TPU tiling options
            ``slab_size`` and ``s2d`` are refused.
    """
    entrypoint = get_model(name)
    kwargs = {k: _lowering(k, v, kwargs) for k, v in kwargs.items()}
    model = entrypoint(pretrained=pretrained, weights=weights, train=train,
                       device=resolve_device(device), **kwargs)
    model.name = name
    return model


def cli_model_kwargs(model_name, dtype=None, no_remat=False):
    """The CLIs' model options as create_model arguments (the JAX package's
    ``cli_model_kwargs``): ``--dtype`` and ``--no_remat`` exist only for the
    robust_mvd family and exit with JAX's message for any other model.
    ``--no_remat`` trains without recomputing the encoder, the cost-volume
    encoder and the decoder in the backward (``remat=False``)."""
    if (dtype is not None or no_remat) and not str(model_name).startswith("robust_mvd"):
        raise SystemExit(f"--dtype/--no_remat are only supported by the robust_mvd family, not {model_name}")
    kwargs = {} if dtype is None else {"dtype": dtype}
    if no_remat:
        kwargs["remat"] = False
    return kwargs


def prepare_custom_model(model):
    """Prepare a duck-typed custom model (input_adapter / __call__ /
    output_adapter) for the run protocol (reference: rmvd/models/factory.py:32-61)."""
    add_run_function(model)
    if not hasattr(model, "name"):
        model.name = type(model).__name__
    return model
