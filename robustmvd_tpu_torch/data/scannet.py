"""ScanNet dataset (reference: rmvd/data/scannet.py).

Robust MVD split: 200 samples, 8 views key=3, images resized to 640x480
(reference: scannet.py:68-80). 16-bit depth PNGs are read with PIL
(the reference uses cv2.IMREAD_ANYDEPTH; PIL "I;16" decoding is
equivalent for these files).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .dataset import Dataset, Sample
from .layouts import AllImagesLayout, MVDSequentialDefaultLayout
from .registry import register_default_dataset


class ScanNetImage:
    def __init__(self, path, height, width):
        self.path = path
        self.height = height
        self.width = width

    def load(self, root):
        from PIL import Image

        image = Image.open(osp.join(root, self.path)).resize(
            (self.width, self.height), Image.LANCZOS
        )
        return np.array(image, dtype=np.float32).transpose(2, 0, 1)


class ScanNetDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        depth = np.array(Image.open(osp.join(root, self.path)), dtype=np.float32)
        depth = depth / 1000.0
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        return depth[None]


class ScanNetSample(Sample):
    def __init__(self, name, base):
        self.name = name
        self.base = base
        self.data = {}

    def load(self, root):
        base = osp.join(root, self.base)
        out = {"_base": base, "_name": self.name}
        for key, val in self.data.items():
            if not isinstance(val, list):
                out[key] = val.load(base) if getattr(val, "load", False) else val
            else:
                out[key] = [
                    ele if isinstance(ele, np.ndarray) else ele.load(base) for ele in val
                ]
        return out


@register_default_dataset
class ScanNetRobustMVD(Dataset):
    base_dataset = "scannet"
    split = "robustmvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("scannet", "root")
        default_layouts = [
            MVDSequentialDefaultLayout("default", num_views=8, keyview_idx=3),
            AllImagesLayout("all_images", num_views=8),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)
