"""BlendedMVS (reference: rmvd/data/blendedmvs.py; the JAX package's
``data/blendedmvs.py``). Splits: ``robust_mvd`` (key + 4 of the pair.txt
source views in all combinations, every 2nd sample; reference :417-447) and
``train_mvsnet`` (key + the 2 best source views; :449-468). Masked jpgs,
MVSNet cam files, rendered PFM depths (the port's own ``read_pfm``). The 106
training scene IDs are the package's own ``meta/blendedmvs_scenes.json``.

The sample list is generated from the root's scene directories on first
use and cached under ``data/sample_lists/`` (git-ignored), as the JAX
package caches it; a later dataset reads the cache, whatever its root.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from itertools import combinations

import numpy as np

from .dataset import Dataset, Sample, _sample_list_path
from .dtu import read_pfm
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_dataset, register_default_dataset

with open(osp.join(osp.dirname(__file__), "meta", "blendedmvs_scenes.json")) as _f:
    BMVS_TRAIN_SCENES = json.load(_f)["bmvs_train_scenes"]


def _load_image(root, view_id):
    from PIL import Image

    img = np.array(Image.open(osp.join(root, f"blended_images/{view_id:08d}_masked.jpg")))
    return img.transpose(2, 0, 1).astype(np.float32)


def _read_cam_file(root, view_id):
    with open(osp.join(root, f"cams/{view_id:08d}_cam.txt")) as f:
        return f.readlines()


def _load_pose(root, view_id):
    lines = _read_cam_file(root, view_id)[1:5]
    vals = [float(x) for line in lines for x in line.split()]
    return np.array(vals, dtype=np.float32).reshape(4, 4)


def _load_intrinsics(root, view_id):
    lines = _read_cam_file(root, view_id)[7:10]
    vals = [float(x) for line in lines for x in line.split()]
    return np.array(vals, dtype=np.float32).reshape(3, 3)


def _load_depth(root, view_id):
    depth = read_pfm(osp.join(root, f"rendered_depth_maps/{view_id:08d}.pfm"))
    depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
    return depth[None].astype(np.float32)


def load(key, root, val):
    if isinstance(val, list):
        return [load(key, root, v) for v in val]
    if hasattr(val, "load"):
        return val.load(root)
    if isinstance(val, (np.ndarray, np.generic)):
        return val  # already-loaded data
    if key == "images":
        return _load_image(root, val)
    if key == "depth":
        return _load_depth(root, val)
    if key == "intrinsics":
        return _load_intrinsics(root, val)
    if key == "poses":
        return _load_pose(root, val)
    return val


class BlendedMVSPair:
    """pair.txt parser, pads source lists to 10 (reference: :222-253)."""

    def __init__(self, path):
        with open(path) as f:
            lines = f.readlines()
        self.keyview_ids = [int(x.rstrip()) for x in lines[1::2]]
        pair_lines = [x.rstrip().split(" ") for x in lines[2::2]]
        self._other_view_ids = [list(map(int, pl[1::2])) for pl in pair_lines]
        self._other_view_scores = [list(map(float, pl[2::2])) for pl in pair_lines]
        for idx, ids in enumerate(self._other_view_ids):
            scores = self._other_view_scores[idx]
            while 0 < len(ids) < 10:
                n = min(len(ids), 10 - len(ids))
                ids += ids[:n]
                scores += scores[:n]
            self._other_view_ids[idx] = ids
            self._other_view_scores[idx] = scores

    def get_source_ids(self, keyview_id):
        return self._other_view_ids[self.keyview_ids.index(keyview_id)]

    def get_source_scores(self, keyview_id):
        return self._other_view_scores[self.keyview_ids.index(keyview_id)]


class BlendedMVSMinDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        with open(osp.join(root, self.path)) as f:
            depths = [float(x) for x in f.readlines()[11].split(" ")]
        return np.float32(depths[0])


class BlendedMVSMaxDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        with open(osp.join(root, self.path)) as f:
            depths = [float(x) for x in f.readlines()[11].split(" ")]
        return np.float32(depths[-1])


class BlendedMVSSample(Sample):
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


class BlendedMVSSequence:
    """(reference: blendedmvs.py:293-345)"""

    def __init__(self, root):
        self.root = root
        self.name = osp.split(root)[1]
        pair = BlendedMVSPair(osp.join(root, "cams", "pair.txt"))
        self.source_ids = {k: pair.get_source_ids(k) for k in pair.keyview_ids}
        self.source_scores = {k: pair.get_source_scores(k) for k in pair.keyview_ids}
        cam_files = [x for x in os.listdir(osp.join(root, "cams")) if x.endswith("cam.txt")]
        self.min_depths = {
            int(x[:8]): BlendedMVSMinDepth(osp.join("cams", x)).load(root) for x in cam_files
        }
        self.max_depths = {
            int(x[:8]): BlendedMVSMaxDepth(osp.join("cams", x)).load(root) for x in cam_files
        }
        images = [
            x for x in os.listdir(osp.join(root, "blended_images")) if x.endswith("masked.jpg")
        ]
        self.images = [int(x[:8]) for x in images]

    def __len__(self):
        return len(self.images)


class BlendedMVS(Dataset):
    def _init_samples(self, scene_names=None, num_source_views=None, all_combinations=True):
        path = _sample_list_path(self.name)
        if osp.isfile(path):
            super()._init_samples_from_list()
        else:
            self._init_samples_from_root_dir(
                scene_names=scene_names,
                num_source_views=num_source_views,
                all_combinations=all_combinations,
            )
            self._write_samples_list(path)

    def _init_samples_from_root_dir(
        self, scene_names=None, num_source_views=None, all_combinations=True
    ):
        seqs = [x for x in os.listdir(self.root) if osp.isdir(osp.join(self.root, x))]
        if scene_names is not None:
            seqs = [x for x in seqs if x in scene_names]
        seqs = [BlendedMVSSequence(osp.join(self.root, x)) for x in sorted(seqs)]

        for seq in seqs:
            for key_id in seq.source_ids.keys():
                all_source_ids = seq.source_ids[key_id]
                n = num_source_views if num_source_views is not None else len(all_source_ids)
                if all_combinations:
                    source_combos = [list(x) for x in combinations(all_source_ids, n)]
                else:
                    source_combos = [all_source_ids[:n]]
                for source_ids in source_combos:
                    sample = BlendedMVSSample(
                        name=f"{seq.name}/key{key_id:06d}", base=seq.name
                    )
                    all_ids = [key_id] + source_ids
                    sample.data["images"] = all_ids
                    sample.data["poses"] = all_ids
                    sample.data["intrinsics"] = all_ids
                    sample.data["depth"] = key_id
                    sample.data["depth_range"] = (
                        seq.min_depths[key_id],
                        seq.max_depths[key_id],
                    )
                    sample.data["keyview_idx"] = 0
                    self.samples.append(sample)


class BlendedMVSSeq4Train(BlendedMVS):
    # intentionally not registered (reference: :417)
    base_dataset = "blendedmvs"
    split = "seq4_train"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("blendedmvs", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=5, max_views=5),
            AllImagesLayout("all_images", num_views=5),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(
            scene_names=BMVS_TRAIN_SCENES,
            num_source_views=4,
            all_combinations=True,
            root=root,
            layouts=layouts,
            **kwargs,
        )


@register_default_dataset
class BlendedMVSSeq4TrainSmall(BlendedMVSSeq4Train):
    split = "robust_mvd"

    def _init_samples_from_root_dir(self, scene_names=None, num_source_views=None, all_combinations=True):
        super()._init_samples_from_root_dir(
            scene_names=scene_names,
            num_source_views=num_source_views,
            all_combinations=all_combinations,
        )
        self.samples = self.samples[::2]


@register_dataset
class BlendedMVSMVSNetTrain(BlendedMVS):
    base_dataset = "blendedmvs"
    split = "train_mvsnet"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("blendedmvs", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=3, max_views=3),
            AllImagesLayout("all_images", num_views=3),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(
            scene_names=BMVS_TRAIN_SCENES,
            num_source_views=2,
            all_combinations=False,
            root=root,
            layouts=layouts,
            **kwargs,
        )
