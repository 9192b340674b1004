"""Convolutions that compute at a given dtype, for the models' mixed precision.

Each is the ``torch.nn`` module of its name with a ``dtype`` argument, as the
JAX blocks take flax's ``dtype=``: the parameters stay float32 (so the
``state_dict`` is the float32 model's), and the forward casts the input, the
weight and the bias to ``dtype`` (:class:`ComputeDtype`); at bf16 that is one
rounding of a float32 sum per output (cuDNN on the card). flax adds a
convolution's bias after rounding, in bf16: rounded twice where this rounds
once (the tests state that step in their bounds). At float32 the casts are
no-ops. The casts are explicit per module, not ``torch.autocast``, whose own
choice of float32 ops would differ from the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    convolutions; the stride-1 3x3x3 ones are ``ops/conv3d.py::Conv3d``)."""

    def forward(self, x):
        return self._conv_forward(*self.cast(x))


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing at ``dtype``."""

    def forward(self, x):
        return F.conv_transpose2d(*self.cast(x), self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(ComputeDtype, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing at ``dtype``."""

    def forward(self, x):
        return F.conv_transpose3d(*self.cast(x), self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)
