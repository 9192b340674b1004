"""PatchmatchNet wrapped model (reference parity:
rmvd/models/wrappers/patchmatchnet.py), the JAX package's
``models/wrappers/patchmatchnet.py``; the original network runs on
``device``."""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ...utils import exclude_index, select_by_index
from ..helpers import to_device
from ..registry import register_model
from .wrappers import ModelWrappers, add_repo_to_path, check_pretrained, load_repo_checkpoint


class PatchmatchNetWrapped(ModelWrappers):
    def __init__(self, device, num_sampling_steps=192):
        repo_path = add_repo_to_path("patchmatchnet")
        from models.net import PatchmatchNet  # from the patchmatchnet repo

        self.device = device
        self.model = PatchmatchNet(
            patchmatch_interval_scale=[0.005, 0.0125, 0.025],
            propagation_range=[6, 4, 2],
            patchmatch_iteration=[1, 2, 2],
            patchmatch_num_sample=[8, 8, 16],
            propagate_neighbors=[0, 8, 16],
            evaluate_neighbors=[9, 9, 9],
        )
        state = load_repo_checkpoint(osp.join(repo_path, "checkpoints", "params_000007.ckpt"))["model"]
        self.model.load_state_dict({k[7:]: v for k, v in state.items()})
        self.model.to(device).eval()
        self.num_sampling_steps = num_sampling_steps

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        images = [img / 255.0 for img in images]
        if depth_range is None:
            depth_range = [np.array([0.2], dtype=np.float32), np.array([100], dtype=np.float32)]
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

        device = self.device
        with torch.no_grad():
            imgs = [to_device(image_key, device)] + [to_device(i, device) for i in images_src]
            intr = to_device(np.stack([K_key] + list(K_src), 1), device)
            ext = to_device(np.stack([pose_key] + list(poses_src), 1), device)
            depth, confidence, _ = self.model.forward(
                imgs,
                intr,
                ext,
                to_device(np.asarray(min_depth).reshape(-1), device),
                to_device(np.asarray(max_depth).reshape(-1), device),
            )
        pred = {"depth": depth, "depth_uncertainty": 1 - confidence.unsqueeze(1)}
        return pred, {}


@register_model(trainable=False)
def patchmatchnet_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("patchmatchnet_wrapped", pretrained, weights)
    return PatchmatchNetWrapped(device, num_sampling_steps=kwargs.get("num_sampling_steps", 192))
