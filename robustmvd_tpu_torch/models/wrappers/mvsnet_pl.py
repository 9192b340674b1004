"""MVSNet-pl wrapped model (reference parity: rmvd/models/wrappers/mvsnet_pl.py),
the JAX package's ``models/wrappers/mvsnet_pl.py``: the unofficial
pytorch-lightning MVSNet, run on ``device``; projection matrices at quarter
scale, depth samples linear in depth or in inverse depth.
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


class MVSNetPlWrapped(ModelWrappers):
    def __init__(self, device, sample_in_inv_depth_space=False, num_sampling_steps=192):
        repo_path = add_repo_to_path("mvsnet_pl")
        from models.mvsnet import MVSNet  # from the mvsnet_pl repo

        self.device = device
        self.model = MVSNet()
        weights = load_repo_checkpoint(osp.join(repo_path, "_ckpt_epoch_14.ckpt"))["state_dict"]
        self.model.load_state_dict({k[6:]: v for k, v in weights.items()})
        self.model.to(device).eval()

        self.sample_in_inv_depth_space = sample_in_inv_depth_space
        self.num_sampling_steps = num_sampling_steps

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        N = images[0].shape[0]
        orig_ht, orig_wd = images[0].shape[-2:]
        ht = int(math.ceil(orig_ht / 64.0) * 64.0)
        wd = int(math.ceil(orig_wd / 64.0) * 64.0)
        if (orig_ht, orig_wd) != (ht, wd):
            resized = ResizeInputs(size=(ht, wd))({"images": images, "intrinsics": intrinsics})
            images, intrinsics = resized["images"], resized["intrinsics"]

        images = [
            ((img.astype(np.uint8).astype(np.float32) / 255.0) - _IMAGENET_SHIFT[:, None, None])
            / _IMAGENET_SCALE[:, None, None]
            for img in images
        ]

        proj_mats = []
        for idx, (K_batch, pose_batch) in enumerate(zip(intrinsics, poses)):
            mats = []
            for K, pose, kv in zip(K_batch, pose_batch, np.asarray(keyview_idx).reshape(-1)):
                scale_arr = np.array([[0.25] * 3, [0.25] * 3, [1.0] * 3])
                K = K * scale_arr
                proj = pose.copy()
                proj[:3, :4] = (K @ proj[:3, :4]).astype(np.float32)
                if idx == kv:
                    proj = np.linalg.inv(proj)
                mats.append(proj.astype(np.float32))
            proj_mats.append(np.stack(mats))

        if depth_range is None:
            if self.sample_in_inv_depth_space:
                samples = 1 / np.linspace(1 / 100, 1 / 0.2, self.num_sampling_steps, dtype=np.float32)[::-1]
            else:
                samples = np.linspace(0.2, 100, self.num_sampling_steps, dtype=np.float32)
            depth_samples = np.stack(N * [samples])
        else:
            min_depth, max_depth = depth_range
            if self.sample_in_inv_depth_space:
                depth_samples = (
                    1 / np.linspace(1 / max_depth, 1 / min_depth, self.num_sampling_steps, dtype=np.float32)[::-1]
                ).transpose()
            else:
                depth_samples = np.linspace(min_depth, max_depth, self.num_sampling_steps, dtype=np.float32).transpose()

        return {
            "images": images,
            "keyview_idx": keyview_idx,
            "proj_mats": proj_mats,
            "depth_samples": depth_samples,
        }

    def __call__(self, images, proj_mats, depth_samples, keyview_idx, **_):
        image_key = select_by_index(images, keyview_idx)
        images_src = exclude_index(images, keyview_idx)
        proj_key = select_by_index(proj_mats, keyview_idx)
        proj_src = exclude_index(proj_mats, keyview_idx)

        device = self.device
        with torch.no_grad():
            imgs = to_device(np.stack([image_key] + list(images_src), 1), device)
            projs = to_device(np.stack([proj_key] + list(proj_src), 1), device)
            depth, confidence = self.model.forward(imgs, projs, to_device(np.asarray(depth_samples), device))
        pred = {"depth": depth.unsqueeze(1), "depth_uncertainty": (1 - confidence).unsqueeze(1)}
        return pred, {}


@register_model(trainable=False)
def mvsnet_pl_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("mvsnet_pl_wrapped", pretrained, weights)
    cfg = {"sample_in_inv_depth_space": False, "num_sampling_steps": 192}
    cfg.update(kwargs)
    return MVSNetPlWrapped(device, **cfg)
