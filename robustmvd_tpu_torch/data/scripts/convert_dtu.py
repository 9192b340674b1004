#!/usr/bin/env python3
"""Convert the raw DTU download into the framework's on-disk layout

(reference parity: rmvd/data/scripts/convert_dtu.py): per-scan
``images/{idx:08d}.png`` from the light-condition-3 rectified images,
``gt_depths/{idx:08d}.pfm`` and the ``scan.ply`` points.

A copy of the JAX package's ``robustmvd_tpu/data/scripts/convert_dtu.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.convert_dtu``.
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
        images = sorted(x for x in os.listdir(in_path) if x.endswith("_3_r5000.png"))
        for idx, image in enumerate(images):
            shutil.copy(osp.join(in_path, image), osp.join(out_path, f"{idx:08d}.png"))
        print(f"{scan}: {len(images)} images")


def copy_gt_depths(in_base, out_base):
    in_base = osp.join(in_base, "dtu", "Depths_raw")
    for scan in sorted(os.listdir(in_base)):
        in_path = osp.join(in_base, scan)
        out_path = osp.join(out_base, scan, "gt_depths")
        os.makedirs(out_path, exist_ok=True)
        depths = sorted(x for x in os.listdir(in_path) if x.endswith(".pfm"))
        for idx, depth in enumerate(depths):
            shutil.copy(osp.join(in_path, depth), osp.join(out_path, f"{idx:08d}.pfm"))
        print(f"{scan}: {len(depths)} depths")


def copy_points(in_base, out_base):
    in_base = osp.join(in_base, "Points", "stl")
    for scan in sorted(x for x in os.listdir(in_base) if x.endswith(".ply")):
        scan_id = int(scan[3:6])
        out_path = osp.join(out_base, f"scan{scan_id}")
        os.makedirs(out_path, exist_ok=True)
        shutil.copy(osp.join(in_base, scan), osp.join(out_path, "scan.ply"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("in_path")
    parser.add_argument("out_path")
    args = parser.parse_args()
    os.makedirs(args.out_path, exist_ok=True)
    copy_rectified_images(args.in_path, args.out_path)
    copy_gt_depths(args.in_path, args.out_path)
    copy_points(args.in_path, args.out_path)
    print("Done")
