#!/usr/bin/env python3
"""Convert raw FlyingThings3D into the framework layout

(reference parity: rmvd/data/scripts/convert_flyingthings3d.py): links
images, copies disparities (negated into the standard sign), and derives
per-frame poses/intrinsics (.npy) from ``camera_data.txt`` with the
stereo-rig geometry (baseline 1.0 around the rig center, the rig's first
frame as reference, fx=fy=1050, c=(480, 270)).

A copy of the JAX package's ``robustmvd_tpu/data/scripts/convert_flyingthings3d.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.convert_flyingthings3d``.
"""

import argparse
import os
import os.path as osp
import shutil

import numpy as np

from ...utils.geometry import invert_transform
from ..dtu import read_pfm
from .convert_staticthings3d import link_tree


def write_pfm(path, image, scale=1):
    image = np.flipud(np.asarray(image, np.float32))
    with open(path, "wb") as f:
        color = image.ndim == 3 and image.shape[2] == 3
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def copy_disparities(in_path, out_path):
    base = osp.join(in_path, "disparity")
    if not osp.isdir(base):
        print(f"skipping disparities: {base} not found")
        return
    for split in sorted(os.listdir(base)):
        for seqtype in sorted(os.listdir(osp.join(base, split))):
            for seq in sorted(os.listdir(osp.join(base, split, seqtype))):
                for cam in sorted(os.listdir(osp.join(base, split, seqtype, seq))):
                    cam_dir = osp.join(base, split, seqtype, seq, cam)
                    out_dir = osp.join(out_path, split, seqtype, seq.zfill(4), "disparities", cam)
                    os.makedirs(out_dir, exist_ok=True)
                    for frame in sorted(os.listdir(cam_dir)):
                        frame_num, _ = osp.splitext(frame)
                        dst = osp.join(out_dir, f"{int(frame_num):04d}.pfm")
                        if not osp.isfile(dst):
                            shutil.copy(osp.join(cam_dir, frame), dst)


def convert_calibration(cam_file, out_seq_dir):
    """camera_data.txt -> per-frame poses/{left,right}/NNNN.npy and

    intrinsics/{left,right}/NNNN.npy (reference: :193-277)."""
    K = np.array([[1050.0, 0.0, 480.0], [0.0, 1050.0, 270.0], [0.0, 0.0, 1.0]])

    # the official files have blocks of 4 lines: Frame N / L ... / R ... / blank
    with open(cam_file) as f:
        raw = [x.strip() for x in f.readlines()]
    frames = raw[::4]
    poses_l = raw[1::4]

    dirs = {}
    for dtype in ("poses", "intrinsics"):
        for cam in ("left", "right"):
            d = osp.join(out_seq_dir, dtype, cam)
            os.makedirs(d, exist_ok=True)
            dirs[(dtype, cam)] = d

    L_to_center = np.identity(4)
    L_to_center[0][3] = +0.5
    R_to_center = np.identity(4)
    R_to_center[0][3] = -0.5
    rot = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])

    world_to_ref = None
    for i, frame in enumerate(frames):
        if not frame.startswith("Frame"):
            continue
        frame_num = f"{int(frame[6:]):04d}"
        pose_l = [float(x) for x in poses_l[i].split(" ")[1:]]
        world_to_L = np.array(pose_l).reshape(4, 4)

        world_to_center = world_to_L @ L_to_center @ rot
        if world_to_ref is None:
            world_to_ref = world_to_center.copy()

        center_to_world = invert_transform(world_to_center)
        left_to_ref = L_to_center @ center_to_world @ world_to_ref
        right_to_ref = R_to_center @ center_to_world @ world_to_ref

        np.save(osp.join(dirs[("poses", "left")], frame_num + ".npy"), left_to_ref)
        np.save(osp.join(dirs[("poses", "right")], frame_num + ".npy"), right_to_ref)
        np.save(osp.join(dirs[("intrinsics", "left")], frame_num + ".npy"), K)
        np.save(osp.join(dirs[("intrinsics", "right")], frame_num + ".npy"), K)


def copy_calibrations(in_path, out_path):
    base = osp.join(in_path, "camera_data")
    if not osp.isdir(base):
        print(f"skipping calibration: {base} not found")
        return
    for split in sorted(os.listdir(base)):
        for seqtype in sorted(os.listdir(osp.join(base, split))):
            for seq in sorted(os.listdir(osp.join(base, split, seqtype))):
                cam_file = osp.join(base, split, seqtype, seq, "camera_data.txt")
                if osp.isfile(cam_file):
                    convert_calibration(
                        cam_file, osp.join(out_path, split, seqtype, seq.zfill(4))
                    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("in_path")
    parser.add_argument("out_path")
    args = parser.parse_args()
    os.makedirs(args.out_path, exist_ok=True)
    link_tree(args.in_path, args.out_path, "frames_cleanpass", "png")
    copy_disparities(args.in_path, args.out_path)
    copy_calibrations(args.in_path, args.out_path)
    print("Done")
