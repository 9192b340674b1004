"""Convolutions that compute at a given dtype, for the models' mixed precision,
and the family's BatchNorm with flax's training statistics.

Each is the ``torch.nn`` module of its name with a ``dtype`` argument, as the
JAX blocks take flax's ``dtype=``: the parameters stay float32 (so the
``state_dict`` is the float32 model's), and the forward casts the input, the
weight and the bias to ``dtype`` (:class:`ComputeDtype`); at bf16 that is one
rounding of a float32 sum per output (cuDNN on the card). flax adds a
convolution's bias after rounding, in bf16: rounded twice where this rounds
once (the tests state that step in their bounds). At float32 the casts are
no-ops. The casts are explicit per module, not ``torch.autocast``, whose own
choice of float32 ops would differ from the JAX package's.

The 3D modules serve the MVSNet family's cost volumes. Under a mesh with a
hyp axis their D is sharded: the convolutions take the rank's share and the
input's global D (``total``) and give the rank's share of the output
(``ops/sharded3d.py``), and ``BatchNorm3d`` sums its training statistics
over the hyp axis too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.context import batch_stats_axes, hyp_group
from . import sharded3d


class ComputeDtype:
    """Mixin for a ``torch.nn`` convolution: float32 parameters, a forward
    at ``dtype`` (``compute_dtype``)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def cast(self, x):
        """The input, the weight and the bias at the compute dtype."""
        dt = self.compute_dtype
        return x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt)


class Conv2d(ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` computing at ``dtype``."""

    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class Conv3d(ComputeDtype, nn.Conv3d):
    """``nn.Conv3d`` computing at ``dtype`` (the family's strided and 1x1
    convolutions; the stride-1 3x3x3 ones are ``ops/conv3d.py::Conv3d``);
    D-sharded under a hyp axis (``sharded3d.conv3d``)."""

    def forward(self, x, total=None):
        axis = hyp_group()
        if axis is None:
            return self._conv_forward(*self.cast(x))
        return sharded3d.conv3d(self, x, total, axis)

    def d_out(self, total):
        """The output's D for an input of ``total`` planes."""
        return sharded3d.conv_depth(self, total)


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing at ``dtype``."""

    def forward(self, x):
        return F.conv_transpose2d(*self.cast(x), self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(ComputeDtype, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing at ``dtype``; D-sharded under a hyp
    axis (``sharded3d.conv_transpose3d``)."""

    def forward(self, x, total=None):
        axis = hyp_group()
        if axis is None:
            return F.conv_transpose3d(*self.cast(x), self.stride, self.padding, self.output_padding, self.groups,
                                      self.dilation)
        return sharded3d.conv_transpose3d(self, x, total, axis)

    def d_out(self, total):
        """The output's D for an input of ``total`` planes."""
        return sharded3d.conv_transpose_depth(self, total)


class _FlaxBatchNorm:
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` in training, the
    MVSNet family's BatchNorm (the JAX blocks, ``models/blocks/vis_mvsnet.py``
    and ``blocks/mvsnet.py``); in eval exactly the ``torch.nn`` module.

    In training the input is normalised with its biased batch statistics,
    computed in float32 whatever its dtype as flax computes them (mean and
    ``max(0, E[x^2] - E[x]^2)``), scaled and shifted in float32 and given back
    in the input's dtype; the running statistics move by ``momentum`` (0.1,
    flax's 0.9 the other way round) towards the batch mean and the *biased*
    batch variance. ``torch.nn``'s own BatchNorm moves them towards the
    unbiased variance, n / (n - 1) of it. The ``state_dict`` keys are
    ``torch.nn``'s, so the weight bridge (``models/weights.py``) is unchanged.

    Under data-parallel training (a data group active, ``parallel.context``)
    the statistics are the global batch's, as a sharded flax BatchNorm takes
    them: each rank's per-channel sums of x and x^2 (in float64) and its count
    are summed over the group by an all-reduce that autograd differentiates
    (its backward sums the gradients over the group), and every rank moves
    its running statistics by the same global ones. A module whose input is
    a D-sharded volume (``hyp_sharded``: ``BatchNorm3d``, the family's cost
    regularisers) sums over the hyp axis too (``batch_stats_axes``): data x
    hyp, one all-reduce per axis. The 2D modules (features, uncertainty
    heads) are replicated over hyp and keep the data axis: summing a
    replicated input over hyp would scale the sums and the count alike and
    give the same statistics, at hyp times the traffic.

    ``frozen`` keeps the module in eval mode whatever ``.train()`` asks: the
    JAX package trains its MVSNet, CVP-MVSNet and frozen Vis-MVSNet
    BatchNorms on their running averages (:func:`freeze_batchnorm`).
    """

    frozen = False
    hyp_sharded = False

    def train(self, mode=True):
        return super().train(bool(mode) and not self.frozen)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x32 = x.float()
        axes = batch_stats_axes(self.hyp_sharded)
        if not axes:
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
        else:
            mean, var = _global_batch_stats(x32, dims, [axis.group for axis in axes])
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        y = (x32 - mean.reshape(shape)) * (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)


def _global_batch_stats(x32, dims, groups):
    """Mean and biased variance per channel over every rank of ``groups``
    (process groups of orthogonal axes, summed one after the other). The
    sums are float64: E[x^2] - E[x]^2 cancels, and float32 sums in a rank
    order would put its rounding into the statistics."""
    from torch.distributed.nn.functional import all_reduce

    count = x32.new_full((1,), x32.numel() / x32.shape[1], dtype=torch.float64)
    sums = torch.cat([x32.sum(dims, dtype=torch.float64), (x32 * x32).sum(dims, dtype=torch.float64), count])
    for group in groups:
        sums = all_reduce(sums, group=group)
    channels = x32.shape[1]
    mean = sums[:channels] / sums[-1]
    var = torch.clamp(sums[channels:2 * channels] / sums[-1] - mean * mean, min=0.0)
    return mean.float(), var.float()


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training statistics (:class:`_FlaxBatchNorm`)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's training statistics (:class:`_FlaxBatchNorm`),
    over the hyp axis too: its input is a cost volume, D-sharded under it."""

    hyp_sharded = True


def freeze_batchnorm(model):
    """Keep every BatchNorm of ``model`` in eval mode (running statistics,
    not updated), whoever calls ``.train()`` later; returns ``model``."""
    for m in model.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.frozen = True
            m.eval()
    return model
