"""MVSNet blocks as NCHW / NCDHW ``nn.Module``s.

Counterparts of the JAX package's ``models/blocks/mvsnet.py`` (reference:
rmvd/models/blocks/mvsnet_components.py:8-123): ``FeatureNet`` (2D CNN,
3 -> 32 channels at 1/4 resolution) and ``CostRegNet`` (3D U-Net over the
variance volume, 8..64 channels, BatchNorm + ReLU, transposed convolutions
on the way up). Submodule names are the flax names (``conv0.conv``,
``conv0.bn``, ``conv7.conv``, ``prob``), so ``models/weights.py`` maps the
JAX parameter tree onto ``state_dict()`` one to one.

``conv3d_impl`` picks the lowering of the stride-1 3x3x3 convolutions
where the JAX blocks take it (``ops/conv3d.py``): "banded" runs K5, "xla"
cuDNN; the strided and transposed convolutions are
``nn.Conv3d`` / ``nn.ConvTranspose3d`` (cuDNN on the card). BatchNorm is
``ops/layers.py``'s (eps 1e-5): running statistics in eval, flax's batch
statistics in training; the MVSNet and CVP-MVSNet models keep it frozen in
eval while they train, as the JAX package does.

Each block takes a compute ``dtype``, as the JAX blocks do: the convolutions
run at it (``layers.py``, ``ops/conv3d.py``), the parameters stay float32,
and BatchNorm takes the convolution's bf16 output with its float32 running
statistics, computes in float32 and gives bf16, as flax's
``BatchNorm(dtype=...)`` does. ``CostRegNet``'s ``prob`` head is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv3d import Conv3d
from ...ops import layers


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BN + ReLU (reference: mvsnet_components.py:8-22)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, pad=1, dtype=torch.float32):
        super().__init__()
        self.conv = layers.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad, bias=False, dtype=dtype)
        self.bn = layers.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvBnReLU3D(nn.Module):
    """Conv3d(k3, pad 1, bias=False) + BN + ReLU

    (reference: mvsnet_components.py:25-41; cvp_mvsnet_components.py:85-128);
    ``conv3d_impl`` applies at stride 1 (JAX ``ConvBnReLU3D``)."""

    def __init__(self, in_ch, out_ch, stride=1, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        if stride == 1:
            self.conv = Conv3d(in_ch, out_ch, impl=conv3d_impl, dtype=dtype)
        else:
            self.conv = layers.Conv3d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn = layers.BatchNorm3d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBnReLU3D(nn.Module):
    """ConvTranspose3d(k3, s2, p1, output_padding=1, bias=False) + BN + ReLU:

    twice the input on each spatial axis."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__()
        self.conv = layers.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1, output_padding=1, bias=False,
                                           dtype=dtype)
        self.bn = layers.BatchNorm3d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class FeatureNet(nn.Module):
    """3 -> 32 channels at 1/4 resolution (reference: mvsnet_components.py:44-66)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for i, (in_ch, out_ch, k, s, p) in enumerate(((3, 8, 3, 1, 1), (8, 8, 3, 1, 1), (8, 16, 5, 2, 2),
                                                      (16, 16, 3, 1, 1), (16, 16, 3, 1, 1), (16, 32, 5, 2, 2),
                                                      (32, 32, 3, 1, 1))):
            setattr(self, f"conv{i}", ConvBnReLU(in_ch, out_ch, k, s, p, dtype))
        self.feature = layers.Conv2d(32, 32, 3, padding=1, dtype=dtype)

    def forward(self, x):
        for i in range(7):
            x = getattr(self, f"conv{i}")(x)
        return self.feature(x)


class CostRegNet(nn.Module):
    """3D U-Net over a (B, 32, D, h, w) volume -> (B, 1, D, h, w) logits

    (reference: mvsnet_components.py:69-123). As in the JAX block, ``conv0``
    never takes the banded lowering and ``prob`` does: with "banded" K5 runs
    ``conv2``, ``conv4``, ``conv6`` (at ``dtype``) and ``prob`` (float32)."""

    def __init__(self, in_ch=32, conv3d_impl="xla", dtype=torch.float32):
        super().__init__()
        impl, dt = conv3d_impl, dtype
        self.conv0 = ConvBnReLU3D(in_ch, 8, dtype=dt)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2, dtype=dt)
        self.conv2 = ConvBnReLU3D(16, 16, conv3d_impl=impl, dtype=dt)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2, dtype=dt)
        self.conv4 = ConvBnReLU3D(32, 32, conv3d_impl=impl, dtype=dt)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2, dtype=dt)
        self.conv6 = ConvBnReLU3D(64, 64, conv3d_impl=impl, dtype=dt)
        self.conv7 = DeconvBnReLU3D(64, 32, dt)
        self.conv9 = DeconvBnReLU3D(32, 16, dt)
        self.conv11 = DeconvBnReLU3D(16, 8, dt)
        self.prob = Conv3d(8, 1, bias=True, impl=impl)  # float32 (JAX :218)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


def init_weights(module, generator):
    """Random weights from ``generator``: kaiming-normal (fan-in, ReLU gain)

    for every convolution, zero biases, BatchNorm as constructed (scale 1,
    shift 0, mean 0, variance 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            std = math.sqrt(2.0 / fan_in)
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
