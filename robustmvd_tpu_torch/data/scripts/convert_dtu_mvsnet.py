#!/usr/bin/env python3
"""Convert the raw DTU download into the MVSNet-training layout

(reference parity: rmvd/data/scripts/convert_dtu_mvsnet.py): all light
conditions of the rectified images (index shifted by -1), GT depths, GT
masks, and the shared MVSNet camera files + pair.txt per scan.

A copy of the JAX package's ``robustmvd_tpu/data/scripts/convert_dtu_mvsnet.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.convert_dtu_mvsnet``.
"""

import argparse
import os
import os.path as osp
import shutil


def copy_rectified_images(in_base, out_base):
    in_base = osp.join(in_base, "Rectified")
    for scan in sorted(os.listdir(in_base)):
        in_path = osp.join(in_base, scan)
        out_path = osp.join(out_base, scan, "images")
        os.makedirs(out_path, exist_ok=True)
        for image in sorted(x for x in os.listdir(in_path) if x.endswith("r5000.png")):
            parts = image.split("_")
            corrected = f"{parts[0]}_{(int(parts[1]) - 1):03d}_{parts[2]}_{parts[3]}"
            shutil.copy(osp.join(in_path, image), osp.join(out_path, corrected))


def _copy_numbered(in_base, out_base, sub, ext, out_sub):
    in_base = osp.join(in_base, "dtu", "Depths_raw")
    for scan in sorted(os.listdir(in_base)):
        in_path = osp.join(in_base, scan)
        out_path = osp.join(out_base, scan, out_sub)
        os.makedirs(out_path, exist_ok=True)
        entries = sorted(x for x in os.listdir(in_path) if x.endswith(ext))
        for idx, entry in enumerate(entries):
            shutil.copy(osp.join(in_path, entry), osp.join(out_path, f"{idx:08d}{ext}"))


def copy_camera_params(in_base, out_base):
    cam_dir = osp.join(in_base, "dtu", "Cameras_1")
    pair_in = osp.join(cam_dir, "pair.txt")
    for scan in sorted(os.listdir(out_base)):
        out_path = osp.join(out_base, scan, "cameras")
        os.makedirs(out_path, exist_ok=True)
        shutil.copy(pair_in, osp.join(out_path, "pair.txt"))
        for camera in os.listdir(cam_dir):
            if camera.endswith("cam.txt"):
                shutil.copy(osp.join(cam_dir, camera), osp.join(out_path, camera))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("in_path")
    parser.add_argument("out_path")
    args = parser.parse_args()
    os.makedirs(args.out_path, exist_ok=True)
    copy_rectified_images(args.in_path, args.out_path)
    _copy_numbered(args.in_path, args.out_path, "Depths_raw", ".pfm", "gt_depths")
    _copy_numbered(args.in_path, args.out_path, "Depths_raw", ".png", "masks")
    copy_camera_params(args.in_path, args.out_path)
    print("Done")
