"""Losses by registry name (reference: rmvd/loss/__init__.py): the
robust_mvd training loss and the multi-scale MAE. The MVSNet family's losses
come with the family's training."""

from .factory import create_loss  # noqa: F401
from .registry import get_loss, has_loss, list_losses, register_loss  # noqa: F401

from . import multi_scale_mae, multi_scale_uni_laplace  # noqa: F401  (the losses register themselves)
from .multi_scale_mae import MultiScaleMAE  # noqa: F401
from .multi_scale_uni_laplace import MultiScaleUniLaplace  # noqa: F401
