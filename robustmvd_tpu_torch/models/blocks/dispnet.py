"""DispNet-style blocks of the robust_mvd baseline, as NCHW ``nn.Module``s.

Counterparts of the JAX package's ``models/blocks/dispnet.py`` and of the
reference's blocks (rmvd/models/blocks/dispnet_encoder.py,
dispnet_context_encoder.py, dispnet_costvolume_encoder.py,
dispnet_decoder.py, learned_fusion.py). Submodule names follow the
reference, so ``state_dict()`` keys are the rmvd checkpoint's
(``encoder.conv1.0.weight``, ``fusion_block.corr_to_view_weight.0.weight``,
``decoder.deconv_1.0.weight``, ...) and the JAX package's
``convert_torch_state_dict`` maps them onto its parameter tree.

Weights are initialised as in the reference (rmvd/models/robust_mvd.py:39-55):
kaiming-normal with a=0.2 over fan-in for every conv and deconv, biases zero,
drawn from an explicit ``torch.Generator``.

Each block takes a compute ``dtype``, as the JAX blocks take flax's
``dtype=``: parameters stay float32, and each convolution casts its input,
weight and bias to the compute dtype (``layers.py``). The prediction heads
always run in float32 (``pred_block``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.interpolate import resize_bilinear
from ...ops.layers import Conv2d, ConvTranspose2d
from ...parallel.collectives import all_gather, all_reduce_sum, tie
from ...parallel.context import hyp_group, share, view_group


def leaky_relu(x):
    """LeakyReLU(0.2), the DispNet blocks' activation."""
    return F.leaky_relu(x, 0.2)


def conv_lrelu(in_ch, out_ch, kernel_size=3, stride=1, dtype=torch.float32):
    """Conv(k, s, symmetric padding) + LeakyReLU(0.2)

    (reference: rmvd/models/blocks/utils.py:14-27 `conv`)."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=(kernel_size - 1) // 2, dtype=dtype),
        nn.LeakyReLU(0.2),
    )


def deconv_lrelu(in_ch, out_ch, dtype=torch.float32):
    """ConvTranspose(k4, s2, p1) + LeakyReLU(0.2): output = 2x input

    (reference: dispnet_decoder.py:25-33 `deconv`)."""
    return nn.Sequential(ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, dtype=dtype), nn.LeakyReLU(0.2))


def iconv_block(in_ch, out_ch, dtype=torch.float32):
    """3x3 conv + LeakyReLU(0.2) on a skip concat (dispnet_decoder.py:8-14)."""
    return conv_lrelu(in_ch, out_ch, 3, 1, dtype)


def relu_and_sigmoid(x, min_val=-10.0, max_val=10.0):
    """Channel 0 of (N, C, H, W): ReLU; the others: a sigmoid scaled into

    [min, max] (reference: rmvd/models/blocks/utils.py:30-45)."""
    rng = max_val - min_val
    c0 = F.relu(x[:, :1])
    c1 = torch.sigmoid(x[:, 1:] * (4.0 / rng)) * rng + min_val
    return torch.cat([c0, c1], 1)


class ReLUAndSigmoid(nn.Module):
    """:func:`relu_and_sigmoid` as a module."""

    def __init__(self, min_val=-10.0, max_val=10.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val

    def forward(self, x):
        return relu_and_sigmoid(x, self.min_val, self.max_val)


def pred_block(in_ch):
    """3x3 conv -> (invdepth, log_b) + ReLUAndSigmoid(+-10), in float32 at any

    compute dtype, as the JAX ``PredBlock``: depth = 1/invdepth would carry
    bf16's relative error into the benchmark's metrics
    (reference: dispnet_decoder.py:17-23 `pred_block`)."""
    return nn.Sequential(Conv2d(in_ch, 2, 3, padding=1), ReLUAndSigmoid(-10.0, 10.0))


# the JAX package's flax names of the four blocks above: a torch module needs
# its input channels, so each takes (in_ch, out_ch, ...) where JAX's takes
# (features, ...)
ConvLReLU = conv_lrelu
DeconvLReLU = deconv_lrelu
IConvBlock = iconv_block
PredBlock = pred_block


def init_weights(module, generator):
    """kaiming_normal_(a=0.2, fan_in, leaky_relu) on conv/deconv weights, zero biases."""
    gain = math.sqrt(2.0 / (1.0 + 0.2**2))
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # torch's fan_in is weight.size(1) * kh * kw for both kinds
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            std = gain / math.sqrt(fan_in)
            with torch.no_grad():
                w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32) * std
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()


class DispnetEncoder(nn.Module):
    """3-conv feature encoder to 1/8 resolution, 64/128/256 channels

    (reference: rmvd/models/blocks/dispnet_encoder.py:6-27)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = conv_lrelu(3, 64, 7, 2, dtype)
        self.conv2 = conv_lrelu(64, 128, 5, 2, dtype)
        self.conv3 = conv_lrelu(128, 256, 3, 2, dtype)

    def forward(self, image):
        conv1 = self.conv1(image)
        conv2 = self.conv2(conv1)
        conv3a = self.conv3(conv2)
        return {"conv1": conv1, "conv2": conv2, "conv3a": conv3a}, conv3a


class DispnetContextEncoder(nn.Module):
    """1x1 conv 256 -> 32 on key features (dispnet_context_encoder.py:6-13)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv_redir = conv_lrelu(256, 32, 1, 1, dtype)

    def forward(self, conv3):
        return self.conv_redir(conv3)


class LearnedFusion(nn.Module):
    """Per-view weight CNN + softmax across views + mask-weighted average

    (reference: rmvd/models/blocks/learned_fusion.py:5-54). corrs and masks
    are (B, V, S, H, W); returns the fused (B, S, H, W) corr and mask. The
    weights, their softmax over views and the sums run at the compute dtype.

    Under a mesh with a view or hyp axis (``parallel.context``) the input is
    this rank's share: its ``V`` of the ``num_views`` source views, and its
    slab of the S hypotheses; the result is the whole fused volume, on every
    rank (JAX: ``robustmvd_tpu/models/robust_mvd.py:163-168``).

    - The first conv of the weight net takes the S hypotheses as input
      channels: over ``hyp`` it is row-parallel, each rank convolving its slab
      with its slice of the weight's input channels; the pre-activations are
      summed over ``hyp`` and the bias is added once, after the sum.
    - The softmax over views takes every view's weight: the (B, V, 1, H, W)
      weights are gathered over ``view``.
    - The weighted sums over views are summed over ``view`` (in float32,
      rounded once to the compute dtype), and the fused slabs gathered over
      ``hyp``.
    - A rank whose view share is empty adds zeros to the sums. Its empty
      volumes are tied to the weight net's parameters, so that its backward
      joins the view axis' all-reduces as the other ranks' backwards do
      (gloo would pair mismatched collectives otherwise).
    """

    def __init__(self, num_sampling_points=256, dtype=torch.float32):
        super().__init__()
        self.corr_to_view_weight = nn.Sequential(
            Conv2d(num_sampling_points, 128, 3, padding=1, dtype=dtype),
            nn.ReLU(),
            Conv2d(128, 1, 1, dtype=dtype),
        )

    def forward(self, corrs, masks, num_views=None):
        B, V, S, H, W = corrs.shape
        view, hyp = view_group(), hyp_group()
        num_views = V if num_views is None else num_views
        if V == 0 and view is not None:
            corrs = tie(corrs, *self.corr_to_view_weight.parameters())
        if num_views == 1:
            # single source view: pass-through (learned_fusion.py:49-52); an empty share's zeros
            fused_corr, fused_mask = (corrs[:, 0], masks[:, 0]) if V else (corrs.sum(1), masks.sum(1))
            if view is not None:
                fused_corr, fused_mask = all_reduce_sum(torch.stack([fused_corr, fused_mask]), view)
        else:
            w = self._view_logits(corrs.reshape(B * V, S, H, W), hyp).reshape(B, V, 1, H, W)
            if view is not None:
                w = all_gather(w, 1, num_views, view)
            w = torch.softmax(w, dim=1) + 1e-9
            if view is not None:
                lo, hi = share(num_views, view)
                w = w[:, lo:hi]
            view_weights = w * masks
            if view is None:
                weights_sum = view_weights.sum(1)
                corr_sum = (corrs * view_weights).sum(1)
            else:
                sums = torch.stack([view_weights.sum(1, dtype=torch.float32),
                                    (corrs * view_weights).sum(1, dtype=torch.float32)])
                weights_sum, corr_sum = all_reduce_sum(sums, view).to(corrs.dtype)
            fused_mask = (weights_sum != 0).to(corrs.dtype)
            fused_corr = corr_sum / (weights_sum + 1e-9) * fused_mask
        if hyp is not None:
            total = self.corr_to_view_weight[0].in_channels
            fused_corr, fused_mask = all_gather(torch.stack([fused_corr, fused_mask]), 2, total, hyp)
        return fused_corr, fused_mask

    def _view_logits(self, corrs, hyp):
        """The weight net on (N, S, H, W) corrs: (N, 1, H, W)."""
        if corrs.shape[0] == 0:  # an empty view share (then no rank of this hyp group has a view)
            return corrs.sum(1, keepdim=True)  # (0, 1, H, W), in the graph of the tied volumes
        if hyp is None:
            return self.corr_to_view_weight(corrs)
        conv0, relu, conv1 = self.corr_to_view_weight
        x, weight, bias = conv0.cast(corrs)
        lo, hi = share(conv0.in_channels, hyp)
        pre = F.conv2d(x, weight[:, lo:hi], None, conv0.stride, conv0.padding)
        pre = all_reduce_sum(pre, hyp) + bias.reshape(1, -1, 1, 1)
        return conv1(relu(pre))


class DispnetCostvolumeEncoder(nn.Module):
    """Context (32) + fused corr (S) -> 1/64 resolution, 1024 channels

    (reference: rmvd/models/blocks/dispnet_costvolume_encoder.py:7-50)."""

    def __init__(self, num_sampling_points=256, dtype=torch.float32):
        super().__init__()
        self.conv3_1 = conv_lrelu(32 + num_sampling_points, 256, dtype=dtype)
        self.conv4 = conv_lrelu(256, 512, stride=2, dtype=dtype)
        self.conv4_1 = conv_lrelu(512, 512, dtype=dtype)
        self.conv5 = conv_lrelu(512, 512, stride=2, dtype=dtype)
        self.conv5_1 = conv_lrelu(512, 512, dtype=dtype)
        self.conv6 = conv_lrelu(512, 1024, stride=2, dtype=dtype)
        self.conv6_1 = conv_lrelu(1024, 1024, dtype=dtype)

    def forward(self, corr, ctx):
        merged = torch.cat([ctx, corr.to(ctx.dtype)], 1)
        out = {"merged": merged}
        x = merged
        for name in ("conv3_1", "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"):
            x = out[name] = getattr(self, name)(x)
        return out, x


class DispnetDecoder(nn.Module):
    """6-scale decoder: deconv x2, skip concat, per-scale (invdepth, log_b)

    heads (reference: rmvd/models/blocks/dispnet_decoder.py:37-138). The
    upsampled predictions are detached before re-injection, as in the
    reference (:88-121), and cast to the features' dtype for the concat; the
    heads are float32.
    """

    # (deconv out channels, skip feature name, skip channels) per scale 1..5
    _SCALES = ((512, "conv5_1", 512), (256, "conv4_1", 512), (128, "conv3_1", 256),
               (64, "conv2", 128), (32, "conv1", 64))

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.pred_0 = pred_block(1024)
        in_ch = 1024
        for i, (ch, _, skip_ch) in enumerate(self._SCALES, start=1):
            setattr(self, f"deconv_{i}", deconv_lrelu(in_ch, ch, dtype))
            setattr(self, f"rfeat{i}", iconv_block(skip_ch + ch + 2, ch, dtype))
            setattr(self, f"pred_{i}", pred_block(ch))
            in_ch = ch

    def forward(self, enc_fused, all_enc):
        preds = {}

        def add_outputs(pred):
            # reference: dispnet_decoder.py:126-138
            mean, log_b = pred[:, 0:1], pred[:, 1:2]
            ent = torch.log(2 * torch.exp(log_b) + 1e-4) + 1
            preds.setdefault("invdepth_uncertainties_all", []).append(ent)
            preds.setdefault("invdepth_log_bs_all", []).append(log_b)
            preds.setdefault("invdepths_all", []).append(mean)
            preds["invdepth_uncertainty"] = ent
            preds["invdepth_log_b"] = log_b
            preds["invdepth"] = mean

        pred = self.pred_0(enc_fused)
        add_outputs(pred)
        x = enc_fused
        for i, (_, skip, _) in enumerate(self._SCALES, start=1):
            deconv = getattr(self, f"deconv_{i}")(x)
            up = resize_bilinear(pred, deconv.shape[-2:]).detach().to(deconv.dtype)
            x = getattr(self, f"rfeat{i}")(torch.cat([all_enc[skip], deconv, up], 1))
            pred = getattr(self, f"pred_{i}")(x)
            add_outputs(pred)
        return preds
