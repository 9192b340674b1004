"""Losses by registry name (reference: rmvd/loss/__init__.py): the
robust_mvd training loss, the multi-scale MAE and the MVSNet family's three
(MVSNet's ``mvsnet_loss``, CVP-MVSNet's ``SL1Loss``, Vis-MVSNet's
``vismvsnet_loss``, also under its class name)."""

from .factory import create_loss  # noqa: F401
from .registry import get_loss, has_loss, list_losses, register_loss  # noqa: F401

from . import (  # noqa: F401  (the losses register themselves)
    multi_scale_mae,
    multi_scale_uni_laplace,
    mvsnet_sl1,
    single_scale_mae,
    vismvsnet_multiscale_multiview_aggregate,
)
from .multi_scale_mae import MultiScaleMAE  # noqa: F401
from .multi_scale_uni_laplace import MultiScaleUniLaplace  # noqa: F401
from .mvsnet_sl1 import SL1Loss  # noqa: F401
from .single_scale_mae import SingleScaleMAE  # noqa: F401
from .vismvsnet_multiscale_multiview_aggregate import VismvnsetMultiscaleMultiviewAggregate  # noqa: F401
