"""DTU (reference: rmvd/data/dtu.py:255-502): the Robust MVD split (110

samples) and the MVSNet training split (``train_mvsnet``, key + the 2 best
source views), pair.txt view selection, 7 light conditions, PFM depths /
1000, foreground masks. The 79 training scene names are the package's own
``meta/dtu_scenes.json``; both sample lists are the package's own copies.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import re
from itertools import combinations

import numpy as np

from .dataset import Dataset, Sample, _sample_list_path
from .layouts import AllImagesLayout, MVDUnstructuredDefaultLayout
from .registry import register_dataset, register_default_dataset

with open(osp.join(osp.dirname(__file__), "meta", "dtu_scenes.json")) as _f:
    DTU_TRAIN_SCENES = json.load(_f)["dtu_train_scenes"]


def read_pfm(path):
    """Read a PFM file into (H, W) or (3, H, W) float32

    (reference: dtu.py:141-173)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dim_line = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s(\d+)\s$", dim_line)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())

        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, f"{endian}f")
    shape = (height, width, 3) if color else (height, width)
    data = np.flipud(data.reshape(shape))
    if data.ndim == 3:
        data = data.transpose(2, 0, 1)
    return data


def _load_image(root, path):
    from PIL import Image

    view_id, light_idx = path
    img_path = osp.join(root, f"images/rect_{view_id:03d}_{light_idx}_r5000.png")
    img = np.array(Image.open(img_path))
    return img.transpose(2, 0, 1).astype(np.float32)


def _read_cam_file(root, view_id):
    with open(osp.join(root, f"cameras/{view_id:08d}_cam.txt")) as f:
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
    depth = read_pfm(osp.join(root, f"gt_depths/{view_id:08d}.pfm"))
    depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
    return depth[None].astype(np.float32)


def _load_mask(root, view_id):
    from PIL import Image

    mask = np.array(Image.open(osp.join(root, f"masks/{view_id:08d}.png")))
    return mask[None].astype(np.float32)


def load(key, root, val):
    """Load one entry of a sample's data (reference: dtu.py:239-255).

    As in the JAX package, loader objects (DTUImage, DTUDepth: what the
    Robust MVD sample list stores) load themselves; (view_id, light_idx)
    image tuples and view ids of a scene directory go through the readers
    below. The reference's dispatch handles only the latter.
    """
    if isinstance(val, list):
        return [load(key, root, v) for v in val]
    if hasattr(val, "load"):
        return val.load(root)
    if isinstance(val, (np.ndarray, np.generic)):
        return val  # already-loaded data (poses/intrinsics in the manifests)
    if key == "images":
        return _load_image(root, val)
    if key == "depth":
        return _load_depth(root, val)
    if key == "intrinsics":
        return _load_intrinsics(root, val)
    if key == "poses":
        return _load_pose(root, val)
    if key == "masks":
        return _load_mask(root, val)
    return val


class DTUPair:
    """pair.txt view selection; pads source lists up to 10 by repetition

    (reference: dtu.py:258-287)."""

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


class DTUMinDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        with open(osp.join(root, self.path)) as f:
            depths = [float(x) for x in f.readlines()[11].split(" ")]
        return depths[0]


class DTUMaxDepth:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        with open(osp.join(root, self.path)) as f:
            depths = [float(x) for x in f.readlines()[11].split(" ")]
        return depths[-1]


class DTUImage:
    def __init__(self, path):
        self.path = path

    def load(self, root):
        from PIL import Image

        return np.array(Image.open(osp.join(root, self.path)), dtype=np.float32).transpose(2, 0, 1)


class DTUDepth:
    def __init__(self, path, format=None):
        self.path = path

    def load(self, root):
        depth = read_pfm(osp.join(root, self.path)) / 1000
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        return depth[None]


class DTUSample(Sample):
    def __init__(self, name, base):
        self.name = name
        self.base = base
        self.data = {}

    def load(self, root):
        base = osp.join(root, self.base)
        out = {"_base": base, "_name": self.name}
        for key, val in self.data.items():
            out[key] = load(key, base, val)
        return out


class DTUScene:
    """Index of one DTU scan directory (reference: dtu.py:352-400)."""

    def __init__(self, root):
        self.root = root
        self.name = osp.split(root)[1]

        pair = DTUPair(osp.join(root, "cameras", "pair.txt"))
        self.source_ids = {k: pair.get_source_ids(k) for k in pair.keyview_ids}
        self.source_scores = {k: pair.get_source_scores(k) for k in pair.keyview_ids}

        cam_files = [x for x in os.listdir(osp.join(root, "cameras")) if x.endswith("cam.txt")]
        self.min_depths = {
            int(x[:8]): DTUMinDepth(osp.join("cameras", x)).load(root) for x in cam_files
        }
        self.max_depths = {
            int(x[:8]): DTUMaxDepth(osp.join("cameras", x)).load(root) for x in cam_files
        }

        images = [x for x in os.listdir(osp.join(root, "images")) if x.endswith("0_r5000.png")]
        self.images = [int(x.split("_")[1]) for x in images]
        depths = [x for x in os.listdir(osp.join(root, "gt_depths")) if x.endswith(".pfm")]
        self.depths = sorted(int(x[:8]) for x in depths)[: len(self.images)]
        self.intrinsics = [int(x[:8]) for x in cam_files]
        self.poses = [int(x[:8]) for x in cam_files]

    def __len__(self):
        return len(self.images)


class DTU(Dataset):
    base_dataset = "dtu"

    def _init_samples(self, scene_names=None, num_source_views=None, all_combinations=True):
        path = _sample_list_path(self.name)
        if path is not None and osp.isfile(path):
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
        scenes = [x for x in os.listdir(self.root) if osp.isdir(osp.join(self.root, x))]
        if scene_names is not None:
            scenes = [x for x in scenes if x in scene_names]
        scenes = [DTUScene(osp.join(self.root, x)) for x in sorted(scenes)]

        for scene in scenes:
            for key_id in scene.source_ids.keys():
                all_source_ids = scene.source_ids[key_id]
                n = num_source_views if num_source_views is not None else len(all_source_ids)
                if all_combinations:
                    source_id_combos = [list(x) for x in combinations(all_source_ids, n)]
                else:
                    source_id_combos = [all_source_ids[:n]]
                for light_idx in range(7):
                    for source_ids in source_id_combos:
                        sample = DTUSample(
                            name=f"{scene.name}/key{key_id:02d}/light{light_idx:02d}",
                            base=scene.name,
                        )
                        all_ids = [key_id] + source_ids
                        sample.data["images"] = [(x, light_idx) for x in all_ids]
                        sample.data["poses"] = all_ids
                        sample.data["intrinsics"] = all_ids
                        sample.data["masks"] = key_id
                        sample.data["depth"] = key_id
                        sample.data["depth_range"] = (
                            scene.min_depths[key_id],
                            scene.max_depths[key_id],
                        )
                        sample.data["keyview_idx"] = 0
                        self.samples.append(sample)


@register_default_dataset
class DTURobustMVD(DTU):
    split = "robustmvd"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("dtu", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=11, max_views=4),
            AllImagesLayout("all_images", num_views=11),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(
            scene_names=DTU_TRAIN_SCENES,
            num_source_views=2,
            root=root,
            layouts=layouts,
            **kwargs,
        )


@register_dataset
class DTUMvsnetTrain(DTU):
    split = "train_mvsnet"
    dataset_type = "mvd"

    def __init__(self, root=None, layouts=None, **kwargs):
        root = root if root is not None else self._get_path("dtu", "root")
        default_layouts = [
            MVDUnstructuredDefaultLayout("default", num_views=11, max_views=4),
            AllImagesLayout("all_images", num_views=11),
        ]
        layouts = default_layouts + layouts if layouts is not None else default_layouts
        super().__init__(
            scene_names=DTU_TRAIN_SCENES,
            num_source_views=2,
            all_combinations=False,
            root=root,
            layouts=layouts,
            **kwargs,
        )
