"""Optimizers, learning-rate schedules and the gradient clip of the recipes.

The reference (rmvd/optim/optims.py:6-37) uses torch's optimizers; the JAX
package (``optim/optims.py``) optax's, and the port follows the JAX package
step for step:
- ``adam``: ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8), the same
  update as ``optax.adam``;
- ``rmsprop``: :class:`RMSprop`, ``optax.rmsprop(decay=0.9, eps=1e-8)``:
  ``g / sqrt(nu + eps)``. ``torch.optim.RMSprop`` adds eps outside the
  root, ``g / (sqrt(nu) + eps)``, which differs where nu is near eps;
- ``flownet_scheduler``: halve the rate once the count reaches 300k, 400k
  and 500k (``optax.piecewise_constant_schedule``);
- ``mvsnet_scheduler``: ``0.9999894640039382 ** count``, per step
  (``optax.exponential_decay``, in float32 as optax computes it).
The schedules are ``LambdaLR``s: with ``scheduler.step()`` after each
``optimizer.step()``, update i (from 0) takes the rate at count i, as in
optax. :func:`clip_grad_global_norm` is ``optax.clip_by_global_norm``.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_optimizer, register_scheduler


@register_optimizer
def adam(model=None, lr=1e-4, **_):
    """Adam with torch's defaults (betas 0.9/0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


@register_optimizer
def rmsprop(model=None, lr=1e-4, **_):
    """RMSprop with decay 0.9 and eps 1e-8 inside the root, as optax's."""
    return RMSprop(model.parameters(), lr=lr, decay=0.9, eps=1e-8)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: nu = (1 - decay) g^2 + decay nu; p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr=1e-4, decay=0.9, eps=1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - group["decay"]) * p.grad**2 + group["decay"] * nu)
                p.sub_(group["lr"] * (p.grad * torch.rsqrt(nu + group["eps"])))
        return loss


def _flownet_factor(count):
    factor = 1.0
    for boundary in (300_000, 400_000, 500_000):
        if count >= boundary:
            factor *= 0.5
    return factor


def _mvsnet_factor(count):
    return float(np.power(np.float32(0.9999894640039382), np.float32(count)))


@register_scheduler
def flownet_scheduler(optimizer=None, **_):
    """Halve the rate at counts 300k, 400k and 500k."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, _flownet_factor)


@register_scheduler
def mvsnet_scheduler(optimizer=None, **_):
    """Per-step exponential decay, a factor 0.9 every 10k steps."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, _mvsnet_factor)


@torch.no_grad()
def clip_grad_global_norm(parameters, max_norm):
    """Scale every gradient by max_norm / norm where the global norm is not

    below max_norm (``optax.clip_by_global_norm``: ``(g / norm) * max_norm``;
    ``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead).
    Decided on the device, without a host sync. Returns the global norm."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm
