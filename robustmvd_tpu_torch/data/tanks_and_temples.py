"""Tanks and Temples dataset (reference: rmvd/data/tanks_and_temples.py).

Robust MVD split: 69 samples, npz depths (reference:
tanks_and_temples.py:57-73).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .dataset import Dataset, Sample
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_default_dataset


class TanksAndTemplesImage:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        img = np.array(Image.open(osp.join(root, self.path)), dtype=np.float32)
        return img.transpose(2, 0, 1)


class TanksAndTemplesDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        depth = np.load(osp.join(root, self.path))["arr_0"]
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        return depth[None]


class TanksAndTemplesSample(Sample):
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
class TanksAndTemplesTrainRobustMVD(Dataset):
    base_dataset = "tanks_and_temples"
    split = "robustmvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("tanks_and_temples", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=11, max_views=4),
            AllImagesLayout("all_images", num_views=11),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)
