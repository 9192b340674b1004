"""Host-side (numpy) resizes of a sample dict (reference:
rmvd/data/transforms.py:40-133): what the evaluation datasets use. The
augmentations wait for the training slice.

A sample has CHW float32 images in 0..255 and lists over views.
"""

from __future__ import annotations

import numpy as np

from ..utils.geometry import compute_depth_range
from ..utils.image import resize_bilinear, resize_nearest


def _resize_image_chw(image, size, order=1):
    if order == 0:
        return resize_nearest(image, size)
    return resize_bilinear(image, size)


class ResizeInputs:
    """Resize the images and rescale the intrinsics with them

    (reference: transforms.py:40-74)."""

    def __init__(self, size, interpolation_order=1):
        self._height, self._width = size
        self._order = interpolation_order

    def __call__(self, sample):
        orig_ht, orig_wd = sample["images"][0].shape[-2:]
        ht, wd = self._height, self._width
        if sample.get("images") is not None:
            sample["images"] = [_resize_image_chw(img, (ht, wd), self._order) for img in sample["images"]]
        if sample.get("intrinsics") is not None:
            scale_arr = np.array([[wd / orig_wd] * 3, [ht / orig_ht] * 3, [1.0] * 3], dtype=np.float32)
            sample["intrinsics"] = [K * scale_arr for K in sample["intrinsics"]]
        return sample


class ResizeTargets:
    """Order-0 resize of depth and inverse depth, and their depth range anew

    (reference: transforms.py:101-133)."""

    def __init__(self, size, interpolation_order=0):
        self._height, self._width = size
        self._order = interpolation_order

    def __call__(self, sample):
        size = (self._height, self._width)
        for key in ("depth", "invdepth"):
            if sample.get(key) is not None:
                sample[key] = _resize_image_chw(sample[key], size, self._order).astype(np.float32)
        if sample.get("depth_range") is not None:
            sample["depth_range"] = compute_depth_range(depth=sample.get("depth"), invdepth=sample.get("invdepth"))
        return sample
