"""The MVSNet family's 3x3x3 stride-1 convolution, by implementation.

Counterpart of the JAX package's ``ops/conv3d.py::conv3d_op``, through which
the family's blocks pick the lowering of their stride-1 3x3x3 convolutions
(``conv3d_impl``). The port has two, which compute the same function with
the same parameters:
- ``"banded"``: K5, ``ops/kernels/conv3d.py``, on NCDHW volumes through its
  strides; it stands in for the JAX lane-packed dot (``conv3d_packed``),
  whose Pallas form is K5 (``ops/pallas/conv3d.py``);
- ``"xla"``: ``nn.Conv3d`` (cuDNN on the card).
The JAX package's two other names are the same lowerings here
(:data:`CONV3D_ALIASES`): ``"packed"`` is the banded dot, ``"dz2d"`` (three
D-shifted 2D convs, a TPU reformulation) the plain conv; ``create_model``
maps them (:func:`conv3d_impl_of`).
:class:`Conv3d` is an ``nn.Conv3d``, so ``state_dict`` keys stay
``...conv.weight`` / ``.bias`` and the weight bridge (``models/weights.py``)
is the same for either lowering.

Its ``dtype`` is the compute dtype, as JAX's ``Conv3dPacked`` and
``conv3d_op`` take it: the parameters stay float32 and the forward casts the
input and the weight to it (K5 casts the kernel once itself). JAX adds the
bias after rounding, in the output's dtype; here the bias is added to the
float32 sum (by K5, or by cuDNN with the bias cast to ``dtype``) before the
one rounding. The family's biased convolutions are its float32 score heads,
where the two are the same.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .kernels.conv3d import conv3d_banded
from .layers import ComputeDtype

CONV3D_IMPLS = ("banded", "xla")
CONV3D_ALIASES = {"packed": "banded", "dz2d": "xla"}


def conv3d_impl_of(name):
    """The port's lowering for a JAX ``conv3d_impl`` name."""
    impl = CONV3D_ALIASES.get(name, name)
    if impl not in CONV3D_IMPLS:
        raise ValueError(f"unknown conv3d impl {name!r}: expected one of {CONV3D_IMPLS + tuple(CONV3D_ALIASES)}")
    return impl


class Conv3d(ComputeDtype, nn.Conv3d):
    """``nn.Conv3d(in_ch, out_ch, 3, padding=1, bias=bias)`` computing at
    ``dtype``, whose forward runs K5 for ``impl="banded"``."""

    def __init__(self, in_ch, out_ch, bias=False, impl="xla", dtype=torch.float32):
        if impl not in CONV3D_IMPLS:
            raise ValueError(f"unknown conv3d impl {impl!r}: expected one of {CONV3D_IMPLS}")
        super().__init__(in_ch, out_ch, 3, padding=1, bias=bias, dtype=dtype)
        self.impl = impl

    def forward(self, x):
        if self.impl == "banded":  # K5 takes the float32 kernel and bias
            return conv3d_banded(x.to(self.compute_dtype), self.weight.permute(2, 3, 4, 1, 0), self.bias,
                                 channels_first=True)
        return self._conv_forward(*self.cast(x))
