"""Vis-MVSNet wrapped model (reference parity: rmvd/models/wrappers/vis_mvsnet.py),
the JAX package's ``models/wrappers/vis_mvsnet.py``: the same cam-tensor
packing, BGR, ImageNet normalisation and uint8 truncation on the host; the
original network runs on ``device``.
"""

from __future__ import annotations

import math
import os.path as osp

import numpy as np
import torch

from ...data.transforms import ResizeInputs
from ...utils import exclude_index, select_by_index
from ..helpers import to_device
from ..registry import register_model
from .wrappers import ModelWrappers, add_repo_to_path, check_pretrained, load_repo_checkpoint

_IMAGENET_SHIFT = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_SCALE = np.array([0.229, 0.224, 0.225], np.float32)


class VisMvsnetWrapped(ModelWrappers):
    def __init__(self, device, num_sampling_steps=192):
        repo_path = add_repo_to_path("vis_mvsnet")
        from model.cas import Model  # from the Vis-MVSNet repo

        self.device = device
        self.model = Model()
        state = load_repo_checkpoint(osp.join(repo_path, "pretrained_model", "vis", "20000.tar"))["state_dict"]
        self.model.load_state_dict(state)
        self.model.to(device).eval()
        self.num_sampling_steps = num_sampling_steps

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        orig_ht, orig_wd = images[0].shape[-2:]
        ht = int(math.ceil(orig_ht / 64.0) * 64.0)
        wd = int(math.ceil(orig_wd / 64.0) * 64.0)
        if (orig_ht, orig_wd) != (ht, wd):
            resized = ResizeInputs(size=(ht, wd))({"images": images, "intrinsics": intrinsics})
            images, intrinsics = resized["images"], resized["intrinsics"]

        out_images = []
        for img in images:
            x = (
                (img.astype(np.uint8).astype(np.float32) / 255.0)
                - _IMAGENET_SHIFT[:, None, None]
            ) / _IMAGENET_SCALE[:, None, None]
            out_images.append(x[:, ::-1].copy())  # RGB -> BGR

        depth_range = [0.2, 100] if depth_range is None else depth_range
        min_depth, max_depth = depth_range
        step_size = (np.asarray(max_depth) - np.asarray(min_depth)) / self.num_sampling_steps

        cams = []
        for K, pose in zip(intrinsics, poses):
            N = pose.shape[0]
            cam = np.zeros((N, 2, 4, 4), np.float32)
            cam[:, 0] = pose
            cam[:, 1, :3, :3] = K
            cam[:, 1, 3, 0] = np.asarray(min_depth).reshape(-1)
            cam[:, 1, 3, 1] = np.asarray(step_size).reshape(-1)
            cam[:, 1, 3, 2] = self.num_sampling_steps
            cam[:, 1, 3, 3] = np.asarray(max_depth).reshape(-1)
            cams.append(cam)

        return {"images": out_images, "keyview_idx": keyview_idx, "cams": cams}

    def __call__(self, images, cams, keyview_idx, **_):
        image_key = select_by_index(images, keyview_idx)
        images_src = exclude_index(images, keyview_idx)
        cam_key = select_by_index(cams, keyview_idx)
        cams_src = exclude_index(cams, keyview_idx)

        with torch.no_grad():
            inp = {
                "ref": to_device(image_key, self.device),
                "ref_cam": to_device(cam_key, self.device),
                "srcs": to_device(np.stack(images_src, 1), self.device),
                "srcs_cam": to_device(np.stack(cams_src, 1), self.device),
            }
            outputs, refined_depth, prob_maps = self.model(inp, [64, 32, 16], [4.0, 2.0, 1.0], mode="soft")
        pred = {"depth": refined_depth, "depth_uncertainty": 1 - prob_maps[2]}
        return pred, {}


@register_model(trainable=False)
def vis_mvsnet_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("vis_mvsnet_wrapped", pretrained, weights)
    return VisMvsnetWrapped(device, num_sampling_steps=kwargs.get("num_sampling_steps", 192))
