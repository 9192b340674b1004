"""KITTI (reference: rmvd/data/kitti.py): the Robust MVD split (:62-77), 93

samples of 21 sequential views, key view 10, 16-bit PNG depths / 256; and
the Eigen dense-depth splits (:80-116), single views whose sample lists the
user generates (neither the reference nor the JAX package bundles them). The
class names are the JAX package's, which the sample lists' pickles name.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .dataset import Dataset, Sample
from .layouts import AllImagesLayout, MVDSequentialDefaultLayout
from .registry import register_dataset, register_default_dataset


class KITTIImage:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        image = np.array(
            Image.open(osp.join(root, self.path)).convert("RGB"), dtype=np.float32
        ).transpose(2, 0, 1)
        return image


class KITTIDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        depth_png = np.array(Image.open(osp.join(root, self.path)), dtype=int)
        assert np.max(depth_png) > 255, "KITTI depth maps must be 16 bit"
        depth = depth_png.astype(float) / 256.0
        depth[depth_png == 0] = np.nan
        depth = np.nan_to_num(depth.astype(np.float32), posinf=0.0, neginf=0.0, nan=0.0)
        return depth[None]  # 1HW


class KITTISample(Sample):
    def __init__(self, name):
        self.name = name
        self.data = {}

    def load(self, root):
        out = {"_base": root, "_name": self.name}
        for key, val in self.data.items():
            if not isinstance(val, list):
                out[key] = val.load(root) if getattr(val, "load", False) else val
            else:
                out[key] = [
                    ele if isinstance(ele, np.ndarray) else ele.load(root) for ele in val
                ]
        return out


@register_default_dataset
class KITTIRobustMVD(Dataset):
    base_dataset = "kitti"
    split = "robustmvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("kitti", "root")
        default_layouts = [
            MVDSequentialDefaultLayout("default", num_views=21, keyview_idx=10),
            AllImagesLayout("all_images", num_views=21),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)


class _KITTIEigenDenseDepth(Dataset):
    """KITTI's Eigen split with dense (annotated) depth: single-view samples
    (key view 0) from ``kitti.eigen_dense_depth_{test,train}.mvd.pickle`` in
    the package's sample lists (reference: rmvd/data/kitti.py:80-116)."""

    base_dataset = "kitti"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("kitti", "root")
        default_layouts = [
            MVDSequentialDefaultLayout("default", num_views=1, keyview_idx=0),
            AllImagesLayout("all_images", num_views=1),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)


@register_dataset
class KITTIEigenDenseDepthTest(_KITTIEigenDenseDepth):
    split = "eigen_dense_depth_test"


@register_dataset
class KITTIEigenDenseDepthTrain(_KITTIEigenDenseDepth):
    split = "eigen_dense_depth_train"
