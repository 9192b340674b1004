"""Synthetic in-memory dataset, the JAX package's ``synthetic.train.mvd``.

Deterministic random multi-view samples in the data contract (images 0..255
CHW, poses, intrinsics, depth), made from each sample's index as its seed;
no data on disk. The tests and ``chip_smoke.py`` evaluate on it.
"""

from __future__ import annotations

import numpy as np

from .dataset import Dataset, Sample
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_default_dataset


class SyntheticMVDSample(Sample):
    def __init__(self, seed, num_views, height, width, keyview_idx=0):
        self.seed = seed
        self.num_views = num_views
        self.height = height
        self.width = width
        self.keyview_idx = keyview_idx

    def load(self, root):
        rng = np.random.RandomState(self.seed)
        V, H, W = self.num_views, self.height, self.width

        images = [rng.rand(3, H, W).astype(np.float32) * 255 for _ in range(V)]
        K = np.array(
            [[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], dtype=np.float32
        )
        intrinsics = [K.copy() for _ in range(V)]

        poses = []
        for i in range(V):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = 0.1 * i  # lateral baseline
            poses.append(T)

        depth = (rng.rand(1, H, W).astype(np.float32) * 8.0 + 2.0)

        return {
            "_name": f"synthetic/{self.seed}",
            "images": images,
            "poses": poses,
            "intrinsics": intrinsics,
            "keyview_idx": int(self.keyview_idx),
            "depth": depth,
        }


@register_default_dataset
class SyntheticMVD(Dataset):
    base_dataset = "synthetic"
    split = "train"
    dataset_type = "mvd"

    def __init__(
        self,
        num_samples=16,
        num_views=3,
        height=64,
        width=128,
        keyview_idx=0,
        root=".",
        layouts=None,
        **kwargs,
    ):
        self._num_samples = num_samples
        self._num_views = num_views
        self._height = height
        self._width = width
        self._keyview_idx = keyview_idx
        kwargs.setdefault("verbose", False)
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=num_views, max_views=num_views),
            AllImagesLayout("all_images", num_views=num_views),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(root=root, layouts=layouts, **kwargs)

    def _init_samples(self, **kwargs):
        self.samples = [
            SyntheticMVDSample(
                i, self._num_views, self._height, self._width, self._keyview_idx
            )
            for i in range(self._num_samples)
        ]
