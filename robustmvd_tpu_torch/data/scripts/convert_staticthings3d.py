#!/usr/bin/env python3
"""Link the raw StaticThings3D archives into the framework layout

(reference parity: rmvd/data/scripts/convert_staticthings3d.py): symlinks
``<split>/<seqtype>/<seq>/{frames_cleanpass,frames_finalpass,depths,poses,
intrinsics}/<cam>/NNNN.<ext>``.

A copy of the JAX package's ``robustmvd_tpu/data/scripts/convert_staticthings3d.py``
(the port imports nothing of that package); run it as
``python -m robustmvd_tpu_torch.data.scripts.convert_staticthings3d``.
"""

import argparse
import os
import os.path as osp


def _link(src, out_root, split, seqtype, seq, dtype, cam, frame_num, ext):
    out_dir = osp.join(out_root, split, seqtype, str(seq).zfill(4), dtype, cam)
    os.makedirs(out_dir, exist_ok=True)
    dst = osp.join(out_dir, f"{int(frame_num):04d}.{ext}")
    if not osp.isfile(dst):
        os.symlink(src, dst)


def link_tree(in_path, out_path, dtype, ext, cams_from_dir=True):
    """Walk <in>/<dtype>/<split>/<seqtype>/<seq>[/<cam>]/<frame>.<ext>."""
    base = osp.join(in_path, dtype)
    if not osp.isdir(base):
        print(f"skipping {dtype}: {base} not found")
        return
    for split in sorted(os.listdir(base)):
        for seqtype in sorted(os.listdir(osp.join(base, split))):
            for seq in sorted(os.listdir(osp.join(base, split, seqtype))):
                seq_dir = osp.join(base, split, seqtype, seq)
                cams = sorted(os.listdir(seq_dir)) if cams_from_dir else ["left", "right"]
                for cam in cams:
                    cam_dir = osp.join(seq_dir, cam) if cams_from_dir else seq_dir
                    for frame in sorted(os.listdir(cam_dir)):
                        frame_num, _ = osp.splitext(frame)
                        _link(
                            osp.join(cam_dir, frame),
                            out_path, split, seqtype, seq, dtype, cam,
                            int(frame_num), ext,
                        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("in_path")
    parser.add_argument("out_path")
    args = parser.parse_args()
    os.makedirs(args.out_path, exist_ok=True)
    link_tree(args.in_path, args.out_path, "frames_cleanpass", "png")
    link_tree(args.in_path, args.out_path, "frames_finalpass", "png")
    link_tree(args.in_path, args.out_path, "depths", "float3")
    link_tree(args.in_path, args.out_path, "poses", "float3")
    link_tree(args.in_path, args.out_path, "intrinsics", "float3", cams_from_dir=False)
    print("Done")
