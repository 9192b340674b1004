"""ETH3D dataset (reference: rmvd/data/eth3d.py).

Robust MVD split: 104 samples, 11 views (reference: eth3d.py:60-75).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .dataset import Dataset, Sample
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_default_dataset


class ETH3DImage:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        img = np.array(Image.open(osp.join(root, self.path)))
        return img.transpose(2, 0, 1).astype(np.float32)


class ETH3DDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        height, width = 4032, 6048
        depth = np.fromfile(osp.join(root, self.path), dtype=np.float32).reshape(
            height, width
        )
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        return depth[None]


class ETH3DSample(Sample):
    def __init__(self, base, name):
        self.base = base
        self.name = name
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
class ETH3DTrainRobustMVD(Dataset):
    base_dataset = "eth3d"
    split = "robustmvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("eth3d", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=11, max_views=4),
            AllImagesLayout("all_images", num_views=11),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)
