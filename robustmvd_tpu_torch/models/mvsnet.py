"""mvsnet_train — MVSNet, fronto-parallel plane-sweep MVS, in PyTorch.

Reference model: rmvd/models/mvsnet.py:31-217, through the JAX package's
``models/mvsnet.py``. Projection matrices are K (scaled by 1/4, the feature
stride) @ pose with the key view's matrix inverted (:76-99); FeatureNet on
all views in one pass; the variance ``E[x^2] - E[x]^2`` over the key and the
warped source features (:124-137), which K2 (``ops/kernels/sweep_warp.py``)
computes in one kernel on the card; CostRegNet; softmax over the
hypotheses; depth regression; confidence = the probability mass of four
consecutive hypotheses at the expected index (:143-160). Hypotheses are
linear in depth between the first sample's range (default 0.2..100). The
input adapter resizes to a multiple of 32 and normalises with the ImageNet
statistics (:170-199), on the card.

``warp_impl`` picks the cost-volume route: "fused" (the default) runs K2;
"xla" warps each source view into a materialised (B, D, h, w, C) volume
and keeps running float32 sums of the views and their squares, updated in
place (JAX :188-215, without its optimization barrier, an XLA artefact):
with K4 (``ops/kernels/warp_volume.py::homo_warp_volume``), or, for a model
built with ``train=True``, through ``ops/homography.py::homo_warp`` (the
torch op of JAX's XLA ``homo_warp``, which JAX trains through: K2 and K4
are forward-only). The "xla" route is
slower and holds twice the memory at inference; it exists for what the JAX
package sends through it, training and view-parallel runs (the latter not
ported, ROADMAP). ``train=True`` takes the "xla" route and keeps BatchNorm
frozen on its running statistics while the model trains (JAX trains MVSNet
with ``train_bn=False``, :257-261). ``conv3d_impl`` picks the
lowering of CostRegNet's stride-1 3x3x3 convolutions (``ops/conv3d.py``):
"banded" runs K5, "xla" cuDNN. ``create_model`` also takes the JAX
package's names (:data:`WARP_ALIASES`, ``ops/conv3d.py::CONV3D_ALIASES``):
JAX's defaults "auto" and "dz2d" are "fused" and "xla" here.

``dtype="bfloat16"`` is JAX's mixed precision (:84-91): FeatureNet and
CostRegNet compute in bf16 with float32 parameters and BatchNorm statistics;
K2 sums in float32 and writes the variance in bf16, the "xla" route keeps
float32 running sums and casts the variance once; the ``prob`` head, the
softmax, the depth regression and the confidence are float32.

The JAX input adapter pads the view list to a bucket (that bounds XLA
compiles); the port does not, so every source view counts (JAX's
``src_valid`` is all ones here).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.homography import homo_warp, inverse, matmul_sums
from ..ops.kernels.sweep_warp import warp_variance
from ..ops.kernels.warp_volume import homo_warp_volume
from ..ops.layers import freeze_batchnorm
from ..ops.reductions import variance_over_views
from .blocks.mvsnet import CostRegNet, FeatureNet, init_weights
from .helpers import ModelBase, compute_dtype_of, resize_to_multiple, to_device
from .registry import register_model
from .robust_mvd import split_key_sources
from .weights import load_checkpoint

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
WARP_IMPLS = ("fused", "xla")
WARP_ALIASES = {"auto": "fused", "pallas": "fused", "pallas_fused": "fused"}


def warp_impl_of(name):
    """The port's cost-volume route for a JAX ``warp_impl`` name."""
    impl = WARP_ALIASES.get(name, name)
    if impl not in WARP_IMPLS:
        raise ValueError(f"unknown warp_impl {name!r}: expected one of {WARP_IMPLS + tuple(WARP_ALIASES)}")
    return impl


def check_warp_impl(impl):
    """A model's ``warp_impl``, one of the port's names (``create_model``
    maps the JAX names)."""
    if impl not in WARP_IMPLS:
        raise ValueError(f"unknown warp_impl {impl!r}: expected one of {WARP_IMPLS}")
    return impl


def unit_steps(num, device):
    """``jnp.linspace(0, 1, num)`` bit for bit as XLA computes it: float32

    ``i * (1 / (num - 1))`` (the compiler turns the division by a constant
    into a multiply by its float32 reciprocal), the last step exactly 1."""
    steps = torch.arange(num, dtype=torch.float32) * torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    steps[-1] = 1.0
    return steps.to(device)


def projection_matrices(intrinsics, poses, scale=0.25):
    """[K' @ pose[:3, :4]; 0 0 0 1] with K' = K with rows 0 and 1 scaled

    (reference: mvsnet.py:76-99). intrinsics (B, V, 3, 3), poses
    (B, V, 4, 4) -> (B, V, 4, 4)."""
    factor = torch.tensor([[scale] * 3, [scale] * 3, [1.0] * 3], dtype=intrinsics.dtype,
                          device=intrinsics.device)
    top = matmul_sums(intrinsics * factor, poses[..., :3, :4])
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def confidence_4tap(prob):
    """Probability mass of hypotheses i-1 .. i+2 around the truncated

    expected index i (reference: mvsnet.py:143-160). prob (B, D, h, w)."""
    D = prob.shape[1]
    padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = padded[:, 0:D] + padded[:, 1 : D + 1] + padded[:, 2 : D + 2] + padded[:, 3 : D + 3]
    index = torch.arange(D, dtype=prob.dtype, device=prob.device)[None, :, None, None]
    d_index = torch.sum(prob * index, dim=1).to(torch.int32)  # truncates, as astype(int32)
    return torch.gather(sum4, 1, d_index[:, None].long())[:, 0]


class MVSNet(ModelBase):
    """The forward takes images (B, V, 3, H, W) normalised, poses (B, V, 4, 4),

    absolute intrinsics (B, V, 3, 3), keyview_idx (B,) and optionally
    depth_range = (min (B,), max (B,))."""

    def __init__(self, device, num_sampling_steps=192, sample_in_inv_depth_space=False, weights=None, seed=0,
                 conv3d_impl="xla", warp_impl="fused", dtype="float32", train=False):
        super().__init__()
        self.num_sampling_steps = num_sampling_steps
        self.sample_in_inv_depth_space = sample_in_inv_depth_space
        # training differentiates through the warp: the "xla" route (JAX :254-256)
        # with homo_warp, since K4 is forward-only
        self.warp_impl = "xla" if train else check_warp_impl(warp_impl)
        self.warp = homo_warp if train else homo_warp_volume
        self.compute_dtype = cdt = compute_dtype_of(dtype, "mvsnet_train")
        self.feature = FeatureNet(cdt)
        self.cost_regularization = CostRegNet(conv3d_impl=conv3d_impl, dtype=cdt)
        if weights is None:
            init_weights(self, torch.Generator().manual_seed(seed))
        else:
            self.load_state_dict(load_checkpoint(weights))
        freeze_batchnorm(self.to(device).train(train))

    def depth_samples(self, B, depth_range, device):
        """(B, D) hypotheses from the first sample's range (mvsnet.py:46-74)."""
        if depth_range is None:
            lo = torch.tensor(0.2, device=device)
            hi = torch.tensor(100.0, device=device)
        else:
            lo, hi = depth_range[0].reshape(-1)[0], depth_range[1].reshape(-1)[0]
        steps = unit_steps(self.num_sampling_steps, device)
        if self.sample_in_inv_depth_space:
            inv = 1.0 / hi + steps * (1.0 / lo - 1.0 / hi)
            samples = torch.flip(1.0 / inv, [0])
        else:
            samples = lo + steps * (hi - lo)
        return samples[None].expand(B, -1)

    def forward(self, images, poses, intrinsics, keyview_idx, depth_range=None):
        B, V, _, H, W = images.shape
        depth_samples = self.depth_samples(B, depth_range, images.device)

        proj = projection_matrices(intrinsics, poses)
        is_key = torch.arange(V, device=images.device)[None, :] == keyview_idx.reshape(-1, 1)
        proj = torch.where(is_key[..., None, None], inverse(proj), proj)
        proj_key, proj_src = split_key_sources(proj, keyview_idx)

        cdt = self.compute_dtype
        feats = self.feature(images.reshape(B * V, 3, H, W))
        feats = feats.reshape(B, V, *feats.shape[1:]).permute(0, 1, 3, 4, 2)  # (B, V, h, w, C)
        ref_feats, src_feats = split_key_sources(feats, keyview_idx)

        if self.warp_impl == "xla":
            volume = self.warped_variance(ref_feats, src_feats, proj_src, proj_key, depth_samples,
                                          self.warp).to(cdt)
        else:
            volume = warp_variance(ref_feats, src_feats, proj_src, proj_key, depth_samples, out_dtype=cdt)
        cost_reg = self.cost_regularization(volume.permute(0, 4, 1, 2, 3).contiguous())[:, 0]
        prob = torch.softmax(cost_reg, dim=1)  # (B, D, h, w), float32 (the prob head)
        depth = torch.sum(prob * depth_samples[:, :, None, None], dim=1)
        uncertainty = 1.0 - confidence_4tap(prob)

        pred = {"depth": depth[:, None], "depth_uncertainty": uncertainty[:, None]}
        aux = {"depth": pred["depth"], "sampling_invdepths": 1.0 / torch.flip(depth_samples, [1])}
        return pred, aux

    @staticmethod
    def warped_variance(ref_feats, src_feats, proj_src, proj_key, depth_samples, warp=homo_warp_volume):
        """The float32 variance volume through one warped volume per source
        view (``warp``: K4, ``homo_warp_volume``, or in training
        ``homo_warp``) and float32 running sums (JAX :188-215)."""
        warped = (warp(src_feats[:, v], proj_src[:, v], proj_key, depth_samples)
                  for v in range(src_feats.shape[1]))
        return variance_over_views(ref_feats, warped, depth_samples.shape[1])

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        """Multiple-of-32 resize, ImageNet normalisation on the card

        (reference: mvsnet.py:170-199); divisions by device tensors are true
        divisions, like the numpy path's."""
        if poses is None or intrinsics is None:
            raise ValueError("mvsnet requires poses and intrinsics inputs")
        images, intrinsics, _ = resize_to_multiple(images, intrinsics, 32)
        device = self.device
        images = torch.stack([to_device(img, device) for img in images], dim=1)
        mean = to_device(IMAGENET_MEAN.reshape(3, 1, 1), device)
        std = to_device(IMAGENET_STD.reshape(3, 1, 1), device)
        images = (images / torch.tensor(255.0, device=device) - mean) / std
        sample = {
            "images": images,
            "poses": to_device(np.stack(poses, axis=1), device),
            "intrinsics": to_device(np.stack(intrinsics, axis=1), device),
            "keyview_idx": to_device(np.asarray(keyview_idx).reshape(-1), device, np.int64),
        }
        if depth_range is not None:
            sample["depth_range"] = tuple(to_device(np.asarray(r).reshape(-1), device) for r in depth_range)
        return sample


@register_model(trainable=False)
def mvsnet_train(pretrained=True, weights=None, train=False, device="cuda", seed=0, num_sampling_steps=256,
                 sample_in_inv_depth_space=False, conv3d_impl="xla", warp_impl="fused", dtype="float32"):
    """MVSNet as trained in the reference (mvsnet.py:206-217), 256 hypotheses;
    registered without pretrained weights: pass a port ``.pt`` as ``weights``,
    or get weights from ``seed``. Not in ``list_models(trainable_only=True)``,
    as in JAX, but ``train=True`` trains it (the "xla" route, BatchNorm
    frozen). ``conv3d_impl``, ``warp_impl`` (training takes "xla") and
    ``dtype`` ("float32" or "bfloat16") as in :class:`MVSNet`."""
    return MVSNet(device=device, num_sampling_steps=num_sampling_steps,
                  sample_in_inv_depth_space=sample_in_inv_depth_space, weights=weights, seed=seed,
                  conv3d_impl=conv3d_impl, warp_impl=warp_impl, dtype=dtype, train=train)
