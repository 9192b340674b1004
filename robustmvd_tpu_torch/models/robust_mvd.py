"""robust_mvd — the Robust MVD paper baseline, in PyTorch.

Reference model: rmvd/models/robust_mvd.py:26-158. DispNet encoder on key +
source images -> context encoder -> plane-sweep correlation with 256
hypotheses, linear in inverse depth over [1/1000, 1/0.4] (:71-80) -> learned
fusion -> cost-volume encoder -> 6-scale decoder -> depth = 1/(invdepth +
1e-9), uncertainty = exp(log_b)/(invdepth + 1e-9) (:90-94). The input
adapter resizes to a multiple of 64, normalises images to img/255 - 0.4 and
converts intrinsics to relative ones (:101-132).

Counterpart of the JAX package's ``models/robust_mvd.py``. NCHW inside; the
correlation op keeps the JAX layouts at its interface. The view list is not
padded to a bucket size (that bounds XLA compiles only), so the forward has
no ``num_views`` masking.

``dtype="bfloat16"`` is JAX's mixed precision: the parameters, the input
pipeline, the epipolar coordinate math and the prediction heads stay
float32; images are cast to bf16 at the top of the forward, and the
convolutions, the correlation (bf16 scores sampled by K1 v2) and the fusion
run in bf16. ``depth`` and ``depth_uncertainty`` are float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.corr import planesweep_correlation
from ..utils import to_relative_intrinsics
from .blocks.dispnet import (
    DispnetContextEncoder,
    DispnetCostvolumeEncoder,
    DispnetDecoder,
    DispnetEncoder,
    LearnedFusion,
    init_weights,
)
from .helpers import ModelBase, compute_dtype_of, resize_to_multiple, to_device
from .registry import register_model
from .weights import load_checkpoint


def split_key_sources(stacked, keyview_idx):
    """Split (B, V, ...) stacked views into key (B, ...) and sources

    (B, V-1, ...) with a per-sample key index; the sources keep their order
    (the reference's select_by_index/exclude_index,
    rmvd/utils/utils.py:298-347).
    """
    B, V = stacked.shape[:2]
    ar = torch.arange(V, device=stacked.device)[None, :]
    is_key = (ar == keyview_idx.reshape(-1, 1).to(stacked.device)).to(torch.int32)
    order = torch.argsort(is_key, dim=1, stable=True)  # non-key views first

    def take(idx):
        idx_full = idx.reshape(idx.shape + (1,) * (stacked.dim() - 2)).expand(idx.shape + stacked.shape[2:])
        return torch.gather(stacked, 1, idx_full)

    key = take(order[:, V - 1:])[:, 0]
    return key, take(order[:, : V - 1])


# plane-sweep hypotheses: linear in inverse depth over [1/MAX_DEPTH, 1/MIN_DEPTH]
# (rmvd/models/robust_mvd.py:71-80)
NUM_SAMPLING_POINTS = 256
MIN_DEPTH = 0.4
MAX_DEPTH = 1000.0


class RobustMVD(ModelBase):
    """The forward takes images (B, V, 3, H, W) normalised, poses (B, V, 4, 4),

    intrinsics (B, V, 3, 3) relative and keyview_idx (B,). ``dtype`` names
    the compute dtype (``helpers.COMPUTE_DTYPES``); parameters are float32 either
    way, so the state dict and the weight bridge do not depend on it."""

    # the input adapter takes views already on the model's device: the
    # evaluation uploads each sample's views once for all of its runs
    supports_device_images = True

    def __init__(self, device, weights=None, seed=0, train=False, dtype="float32"):
        super().__init__()
        self.compute_dtype = cdt = compute_dtype_of(dtype, "robust_mvd")
        self.encoder = DispnetEncoder(cdt)
        self.context_encoder = DispnetContextEncoder(cdt)
        self.fusion_block = LearnedFusion(NUM_SAMPLING_POINTS, cdt)
        self.fusion_enc_block = DispnetCostvolumeEncoder(NUM_SAMPLING_POINTS, cdt)
        self.decoder = DispnetDecoder(cdt)
        if weights is None:
            init_weights(self, torch.Generator().manual_seed(seed))
        else:
            self.load_state_dict(load_checkpoint(weights))
        # the path has no BatchNorm and no dropout: the mode only tells the
        # caller whether the model was built for training
        self.to(device).train(train)

    def forward(self, images, poses, intrinsics, keyview_idx):
        B, V, _, H, W = images.shape
        images = images.to(self.compute_dtype)
        all_enc, _ = self.encoder(images.reshape(B * V, *images.shape[2:]))
        all_enc = {k: v.reshape(B, V, *v.shape[1:]) for k, v in all_enc.items()}

        conv1_key, _ = split_key_sources(all_enc["conv1"], keyview_idx)
        conv2_key, _ = split_key_sources(all_enc["conv2"], keyview_idx)
        enc_key, enc_sources = split_key_sources(all_enc["conv3a"], keyview_idx)
        K_key, K_sources = split_key_sources(intrinsics, keyview_idx)
        _, key_to_source = split_key_sources(poses, keyview_idx)

        ctx = self.context_encoder(enc_key)

        corrs, masks, _ = planesweep_correlation(
            feat_key=enc_key.permute(0, 2, 3, 1),
            feat_sources=enc_sources.permute(0, 1, 3, 4, 2),
            intrinsics_key=K_key,
            intrinsics_sources=K_sources,
            key_to_source_transforms=key_to_source,
            num_sampling_points=NUM_SAMPLING_POINTS,
            min_depth=MIN_DEPTH,
            max_depth=MAX_DEPTH,
        )
        # (B, V-1, H, W, S) -> (B, V-1, S, H, W)
        fused_corr, _ = self.fusion_block(corrs.permute(0, 1, 4, 2, 3), masks.permute(0, 1, 4, 2, 3))

        all_enc_fused, enc_fused = self.fusion_enc_block(corr=fused_corr, ctx=ctx)
        dec = self.decoder(enc_fused, {"conv1": conv1_key, "conv2": conv2_key, **all_enc_fused})

        pred = {
            "depth": 1.0 / (dec["invdepth"] + 1e-9),
            "depth_uncertainty": torch.exp(dec["invdepth_log_b"]) / (dec["invdepth"] + 1e-9),
        }
        aux = dict(dec)
        aux.update(pred)
        return pred, aux

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        """Resize to a multiple of 64, normalise to /255 - 0.4, relative K

        (reference: rmvd/models/robust_mvd.py:101-132). Takes a list of
        (B, 3, H, W) float32 views, numpy arrays or tensors already on the
        model's device (the evaluation's staged views); the result lies on
        the model's device. Numpy views are resized on the host and uploaded,
        staged views are resized where they lie with the same arithmetic
        (``utils/image.py::resize_bilinear_torch``; JAX's adapter pulls them
        back to the host for a resize instead). Either way they are
        normalised on the device; the division is by a device tensor, a true
        division like numpy's (a Python-scalar divisor may become a
        reciprocal-multiply), so both paths give the network the same bits.
        """
        if poses is None or intrinsics is None:
            raise ValueError("robust_mvd requires poses and intrinsics inputs")
        images, intrinsics, (ht, wd) = resize_to_multiple(images, intrinsics, 64)
        intrinsics = [to_relative_intrinsics(K, wd, ht) for K in intrinsics]
        device = self.device
        images = torch.stack([to_device(img, device) for img in images], dim=1)
        images = images / torch.tensor(255.0, device=device) - 0.4
        return {
            "images": images,
            "poses": to_device(np.stack(poses, axis=1), device),
            "intrinsics": to_device(np.stack(intrinsics, axis=1), device),
            "keyview_idx": to_device(np.asarray(keyview_idx).reshape(-1), device, np.int64),
        }


def _entry(weights, train, device, seed, dtype):
    return RobustMVD(device=device, weights=weights, seed=seed, train=train, dtype=dtype)


@register_model
def robust_mvd(pretrained=True, weights=None, train=False, device="cuda", seed=0, dtype="float32"):
    """The paper's baseline (rmvd/models/robust_mvd.py:151-158). There is no
    download: pass a rmvd ``.pt`` as ``weights``, or get weights from ``seed``.
    ``dtype``: "float32" or "bfloat16" ("bf16"), the compute dtype."""
    return _entry(weights, train, device, seed, dtype)


@register_model(trainable=False)
def robust_mvd_5M(pretrained=True, weights=None, train=False, device="cuda", seed=0, dtype="float32"):
    """The 5M-iteration variant (rmvd/models/robust_mvd.py:139-148)."""
    return _entry(weights, train, device, seed, dtype)
