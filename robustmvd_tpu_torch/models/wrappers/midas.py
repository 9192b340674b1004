"""MiDaS wrapped model (reference parity: rmvd/models/wrappers/midas.py:20-97),
the JAX package's ``models/wrappers/midas.py``: the repository's own
``Resize``, ``NormalizeImage`` and ``PrepareForNet`` on the host, the
network on ``device``.

Single-view inverse depth; evaluated with ``least_squares_scale_shift``
alignment.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ...utils import select_by_index, to_numpy
from ..helpers import to_device
from ..registry import register_model
from .wrappers import ModelWrappers, add_repo_to_path, check_pretrained


class MidasWrapped(ModelWrappers):
    def __init__(self, device, weights_name):
        repo_path = add_repo_to_path("midas")
        from midas.midas_net import MidasNet
        from midas.transforms import NormalizeImage, PrepareForNet, Resize

        self.device = device
        # MidasNet loads its weights itself, with the repository's own torch.load
        self.model = MidasNet(osp.join(repo_path, "weights", weights_name), non_negative=True)
        self.model.to(device).eval()

        net_w = net_h = 384
        self._resize = Resize(
            net_w,
            net_h,
            resize_target=None,
            keep_aspect_ratio=True,
            ensure_multiple_of=32,
            resize_method="upper_bound",
        )
        self._normalize = NormalizeImage(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
        self._prepare = PrepareForNet()

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        image_batch = select_by_index(images, keyview_idx)
        out = []
        for image in image_batch:
            x = {"image": np.transpose(image / 255.0, (1, 2, 0))}
            x = self._resize(x)
            x = self._normalize(x)
            x = self._prepare(x)
            out.append(x["image"])
        return {"image": np.stack(out)}

    def __call__(self, image, **_):
        with torch.no_grad():
            return self.model(to_device(image, self.device))

    def output_adapter(self, model_output):
        pred_invdepth = to_numpy(model_output)
        with np.errstate(divide="ignore", invalid="ignore"):
            pred_depth = 1 / pred_invdepth
        return {"depth": pred_depth[:, None]}, {}


@register_model(trainable=False)
def midas_big_v2_1_wrapped(pretrained=True, weights=None, train=False, device="cuda", **kwargs):
    check_pretrained("midas_big_v2_1_wrapped", pretrained, weights)
    return MidasWrapped(device, weights_name="midas_v21-f6b98070.pt")
