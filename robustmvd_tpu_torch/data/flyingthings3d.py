"""FlyingThings3D, the ``robust_mvd`` training split (reference:
rmvd/data/flyingthings3d.py:803-1034; the JAX package's
``data/flyingthings3d.py``): key frames 6-15, all C(12, 4) source-offset
combinations, subset-only filtering, depth from PFM disparity as
``1050 / -disparity``, ``.npy`` intrinsics and poses. The filter lists are
the package's own ``meta/flyingthings3d_filters.json``.

The sample list is generated from the root's directory tree on first use
and cached under ``data/sample_lists/`` (git-ignored), as the JAX package
caches it; a later dataset reads the cache, whatever its root.
"""

from __future__ import annotations

import itertools
import json
import os.path as osp

import numpy as np

from .dataset import Dataset, Sample, _sample_list_path
from .dtu import read_pfm
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_default_dataset
from .seqconf import DataConf, generate_sequence_samples

with open(osp.join(osp.dirname(__file__), "meta", "flyingthings3d_filters.json")) as _f:
    _FILTERS = json.load(_f)
SUBSET_FILTERED_SAMPLES = [tuple(x) for x in _FILTERS["subset_filtered_samples"]]
HARD_SAMPLES = [tuple(x) for x in _FILTERS["hard_samples"]]

_EXT_MAP = {"poses": "npy", "intrinsics": "npy"}


def _cam_dir(cam):
    return "left" if cam == "l" else "right"


def _load_image(root, cam, frame_num):
    from PIL import Image

    img = np.array(
        Image.open(osp.join(root, "frames_cleanpass", _cam_dir(cam), f"{frame_num:04d}.png"))
    )
    return img.transpose(2, 0, 1).astype(np.float32)


def _load_depth(root, cam, frame_num):
    disparity = read_pfm(
        osp.join(root, "disparities", _cam_dir(cam), f"{frame_num:04d}.pfm")
    )
    depth = 1050.0 / (-1 * disparity)
    depth[(depth < 0.0) | np.isinf(depth) | np.isnan(depth)] = 0.0
    return depth[None].astype(np.float32)


def _load_intrinsics(root, cam, frame_num):
    return np.load(
        osp.join(root, "intrinsics", _cam_dir(cam), f"{frame_num:04d}.npy")
    ).astype(np.float32)


def _load_pose(root, cam, frame_num):
    return np.load(osp.join(root, "poses", _cam_dir(cam), f"{frame_num:04d}.npy")).astype(
        np.float32
    )


def load(key, root, val):
    if isinstance(val, list):
        return [load(key, root, v) for v in val]
    if key == "images":
        return _load_image(root, *val)
    if key == "depth":
        return _load_depth(root, *val)
    if key == "intrinsics":
        return _load_intrinsics(root, *val)
    if key == "poses":
        return _load_pose(root, *val)
    return val


class FlyingThings3DSample(Sample):
    def __init__(self, base, name):
        self.base = base
        self.name = name
        self.data = {}

    def load(self, root):
        base = osp.join(root, self.base)
        out = {"_base": base, "_name": self.name}
        for key, val in self.data.items():
            out[key] = load(key, base, val)
        return out


class FlyingThings3D(Dataset):
    def _init_samples(self, sample_confs=None, filter_hard_samples=False, use_subset_only=False):
        path = _sample_list_path(self.name)
        if osp.isfile(path):
            super()._init_samples_from_list()
        else:
            filtered = []
            if filter_hard_samples:
                filtered += HARD_SAMPLES
            if use_subset_only:
                filtered += SUBSET_FILTERED_SAMPLES
            self.samples = generate_sequence_samples(self.root, sample_confs, FlyingThings3DSample,
                                                     filtered_ids=filtered)
            self._write_samples_list(path)


@register_default_dataset
class FlyingThings3DSeq4Train(FlyingThings3D):
    base_dataset = "flyingthings3d"
    split = "robust_mvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("flyingthings3d", "train", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=5, max_views=5),
            AllImagesLayout("all_images", num_views=5),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(
            sample_confs=self._get_sample_confs(),
            filter_hard_samples=False,
            use_subset_only=True,
            root=root,
            layouts=layouts,
            **kwargs,
        )

    def _get_sample_confs(self):
        """(reference: flyingthings3d.py:1005-1034)"""
        sample_confs = []
        offset_list = [-6, -5, -4, -3, -2, -1, 1, 2, 3, 4, 5, 6]
        for offsets in itertools.combinations(offset_list, 4):
            images = [DataConf("frames_cleanpass", "left", 0, ext_map=_EXT_MAP)]
            poses = [DataConf("poses", "left", 0, ext_map=_EXT_MAP)]
            intrinsics = [DataConf("intrinsics", "left", 0, ext_map=_EXT_MAP)]
            for offset in offsets:
                images.append(DataConf("frames_cleanpass", "left", offset, ext_map=_EXT_MAP))
                poses.append(DataConf("poses", "left", offset, ext_map=_EXT_MAP))
                intrinsics.append(DataConf("intrinsics", "left", offset, ext_map=_EXT_MAP))
            sample_confs.append(
                {
                    "images": images,
                    "poses": poses,
                    "intrinsics": intrinsics,
                    "depth": DataConf("disparities", "left", 0, ext_map=_EXT_MAP),
                    "keyview_idx": 0,
                }
            )
        return sample_confs
