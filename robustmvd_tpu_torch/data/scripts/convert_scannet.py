#!/usr/bin/env python3
"""Export ScanNet ``.sens`` recordings to per-frame color/depth/pose files

(reference parity: rmvd/data/scripts/convert_scannet.py, modernized to
python3 + PIL; the .sens binary layout follows the public ScanNet
SensReader format). Defaults to the 62 test scenes of the robustmvd split.

A copy of the JAX package's ``robustmvd_tpu/data/scripts/convert_scannet.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.convert_scannet``.
"""

import argparse
import os
import os.path as osp
import struct
import zlib
from io import BytesIO

import numpy as np

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}

ROBUSTMVD_SCENES = [
    "scene0697_02", "scene0671_00", "scene0666_00", "scene0672_00", "scene0699_00",
    "scene0685_01", "scene0673_01", "scene0686_00", "scene0673_05", "scene0667_00",
    "scene0694_01", "scene0694_00", "scene0700_01", "scene0693_00", "scene0681_00",
    "scene0679_01", "scene0664_01", "scene0665_01", "scene0706_00", "scene0664_02",
    "scene0696_02", "scene0693_01", "scene0701_02", "scene0704_01", "scene0674_00",
    "scene0678_01", "scene0670_00", "scene0701_00", "scene0667_01", "scene0664_00",
    "scene0678_00", "scene0697_00", "scene0683_00", "scene0688_00", "scene0698_00",
    "scene0705_00", "scene0691_00", "scene0702_02", "scene0673_00", "scene0677_01",
    "scene0676_01", "scene0673_04", "scene0687_00", "scene0678_02", "scene0696_01",
    "scene0689_00", "scene0697_01", "scene0673_02", "scene0672_01", "scene0685_02",
    "scene0700_02", "scene0677_00", "scene0671_01", "scene0696_00", "scene0697_03",
    "scene0693_02", "scene0676_00", "scene0685_00", "scene0700_00", "scene0705_01",
    "scene0670_01", "scene0679_00",
]


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


class SensFile:
    def __init__(self, path):
        with open(path, "rb") as f:
            (version,) = _read(f, "I")
            assert version == 4, f"unsupported .sens version {version}"
            (strlen,) = _read(f, "Q")
            self.sensor_name = f.read(strlen).decode("ascii", "replace")
            self.intrinsic_color = np.array(_read(f, "f" * 16), np.float32).reshape(4, 4)
            self.extrinsic_color = np.array(_read(f, "f" * 16), np.float32).reshape(4, 4)
            self.intrinsic_depth = np.array(_read(f, "f" * 16), np.float32).reshape(4, 4)
            self.extrinsic_depth = np.array(_read(f, "f" * 16), np.float32).reshape(4, 4)
            self.color_compression = COMPRESSION_TYPE_COLOR[_read(f, "i")[0]]
            self.depth_compression = COMPRESSION_TYPE_DEPTH[_read(f, "i")[0]]
            self.color_width, self.color_height = _read(f, "II")
            self.depth_width, self.depth_height = _read(f, "II")
            (self.depth_shift,) = _read(f, "f")
            (num_frames,) = _read(f, "Q")

            self.frames = []
            for _ in range(num_frames):
                pose = np.array(_read(f, "f" * 16), np.float32).reshape(4, 4)
                _ts_c, _ts_d = _read(f, "QQ")
                color_bytes, depth_bytes = _read(f, "QQ")
                color = f.read(color_bytes)
                depth = f.read(depth_bytes)
                self.frames.append((pose, color, depth))

    def export(self, out_path, frame_skip=1):
        from PIL import Image

        dirs = {k: osp.join(out_path, k) for k in ("color", "depth", "pose", "intrinsic")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

        for idx in range(0, len(self.frames), frame_skip):
            pose, color, depth = self.frames[idx]
            assert self.color_compression == "jpeg"
            Image.open(BytesIO(color)).save(osp.join(dirs["color"], f"{idx}.jpg"))
            assert self.depth_compression == "zlib_ushort"
            depth_arr = np.frombuffer(zlib.decompress(depth), np.uint16).reshape(
                self.depth_height, self.depth_width
            )
            Image.fromarray(depth_arr).save(osp.join(dirs["depth"], f"{idx}.png"))
            np.savetxt(osp.join(dirs["pose"], f"{idx}.txt"), pose, fmt="%f")

        np.savetxt(osp.join(dirs["intrinsic"], "intrinsic_color.txt"), self.intrinsic_color, fmt="%f")
        np.savetxt(osp.join(dirs["intrinsic"], "extrinsic_color.txt"), self.extrinsic_color, fmt="%f")
        np.savetxt(osp.join(dirs["intrinsic"], "intrinsic_depth.txt"), self.intrinsic_depth, fmt="%f")
        np.savetxt(osp.join(dirs["intrinsic"], "extrinsic_depth.txt"), self.extrinsic_depth, fmt="%f")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("in_path")
    parser.add_argument("out_path")
    parser.add_argument("--all_scenes", action="store_true")
    args = parser.parse_args()

    in_path = osp.join(args.in_path, "scans")
    scenes = (
        sorted(x for x in os.listdir(in_path) if x.startswith("scene"))
        if args.all_scenes
        else ROBUSTMVD_SCENES
    )
    for scene in scenes:
        print(f"Converting {scene}")
        out = osp.join(args.out_path, scene)
        os.makedirs(out, exist_ok=True)
        SensFile(osp.join(in_path, scene, scene + ".sens")).export(out)
    print("Done")
