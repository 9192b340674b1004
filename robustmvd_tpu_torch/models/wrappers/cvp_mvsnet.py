"""CVP-MVSNet wrapped model (reference parity: rmvd/models/wrappers/cvp_mvsnet.py),
the JAX package's ``models/wrappers/cvp_mvsnet.py``; the original network
runs on ``device``.

Needs >= 2 source views; evaluated with ``--view_ordering nearest
--min_source_views 2`` (eval_all.sh).
"""

from __future__ import annotations

import math
import os.path as osp
import sys

import numpy as np
import torch

from ...data.transforms import ResizeInputs
from ...utils import exclude_index, select_by_index
from ..helpers import to_device
from ..registry import register_model
from .wrappers import ModelWrappers, add_repo_to_path, check_pretrained, load_repo_checkpoint


class CVPMVSNetWrapped(ModelWrappers):
    def __init__(self, device, num_sampling_steps=192):
        repo_path = add_repo_to_path("cvp_mvsnet")
        inner = osp.join(repo_path, "CVP_MVSNet")
        if inner not in sys.path:
            sys.path.insert(0, inner)
        from models.net import network  # from the CVP-MVSNet repo

        class _Args:
            nsrc = None
            nscale = 5
            mode = "test"

        self.device = device
        self.args = _Args()
        self.model = network(self.args)
        state = load_repo_checkpoint(osp.join(inner, "checkpoints", "pretrained", "model_000027.ckpt"))["model"]
        self.model.load_state_dict(state, strict=False)
        self.model.to(device).eval()
        self.num_sampling_steps = num_sampling_steps

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        orig_ht, orig_wd = images[0].shape[-2:]
        ht = int(math.ceil(orig_ht / 64.0) * 64.0)
        wd = int(math.ceil(orig_wd / 64.0) * 64.0)
        if (orig_ht, orig_wd) != (ht, wd):
            resized = ResizeInputs(size=(ht, wd))({"images": images, "intrinsics": intrinsics})
            images, intrinsics = resized["images"], resized["intrinsics"]

        images = [img / 255.0 for img in images]
        if depth_range is None:
            depth_range = [np.array([0.2]), np.array([100.0])]
        min_depth, max_depth = depth_range
        return {
            "images": images,
            "poses": poses,
            "intrinsics": intrinsics,
            "keyview_idx": keyview_idx,
            "min_depth": min_depth,
            "max_depth": max_depth,
        }

    def __call__(self, images, poses, intrinsics, keyview_idx, min_depth, max_depth, **_):
        image_key = select_by_index(images, keyview_idx)
        images_src = exclude_index(images, keyview_idx)
        K_key = select_by_index(intrinsics, keyview_idx)
        K_src = exclude_index(intrinsics, keyview_idx)
        pose_key = select_by_index(poses, keyview_idx)
        poses_src = exclude_index(poses, keyview_idx)

        self.args.nsrc = len(images_src)
        device = self.device
        with torch.no_grad():
            out = self.model(
                ref_img=to_device(image_key, device),
                src_imgs=to_device(np.stack(images_src, 1), device),
                ref_in=to_device(K_key, device),
                src_in=to_device(np.stack(K_src, 1), device),
                ref_ex=to_device(pose_key, device),
                src_ex=to_device(np.stack(poses_src, 1), device),
                depth_min=to_device(np.asarray(min_depth).reshape(-1), device),
                depth_max=to_device(np.asarray(max_depth).reshape(-1), device),
            )
        depth = out["depth_est_list"][0]
        confidence = out["prob_confidence"]
        pred = {"depth": depth.unsqueeze(1), "depth_uncertainty": (1 - confidence).unsqueeze(1)}
        return pred, {}


@register_model(trainable=False)
def cvp_mvsnet_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("cvp_mvsnet_wrapped", pretrained, weights)
    return CVPMVSNetWrapped(device, num_sampling_steps=kwargs.get("num_sampling_steps", 192))
