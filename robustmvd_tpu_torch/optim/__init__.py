"""Optimizers and learning-rate schedules by registry name (reference:
rmvd/optim/__init__.py), with the JAX package's optax semantics."""

from .factory import create_optimizer, create_scheduler  # noqa: F401
from .optims import RMSprop, adam, clip_grad_global_norm, flownet_scheduler, mvsnet_scheduler, rmsprop  # noqa: F401
from .registry import (  # noqa: F401
    has_optimizer,
    has_scheduler,
    list_optimizers,
    list_schedulers,
    register_optimizer,
    register_scheduler,
)
