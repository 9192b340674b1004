"""Inference CLI of the port (reference: rmvd inference.py).

Runs a model on a folder with a key view and source views
(key/{image.png,K.npy,to_ref_transform.npy} and source/N/...) and writes the
predicted depth, inverse depth and uncertainty as .npy and turbo PNGs:

    python -m robustmvd_tpu_torch.inference --model robust_mvd|mvsnet_train|cvp_mvsnet|vis_mvsnet \
        --input_path sample_data --output_path out/ [--weights x.pt] [--dtype bfloat16] [--device cuda]

Each model's depth range defaults as in its JAX module (0.2..100 for the
MVSNet family).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np

from .models import cli_model_kwargs, create_model, list_models
from .utils import invert_transform, resize_bilinear
from .utils.vis import vis


def load_data(path):
    """Load the key + source views and rebase poses onto the key view

    (reference: inference.py:18-55)."""
    from PIL import Image

    key_path = osp.join(path, "key")
    src_root = osp.join(path, "source")
    src_paths = sorted(osp.join(src_root, x) for x in os.listdir(src_root))

    def image(folder):
        return np.array(Image.open(osp.join(folder, "image.png")), dtype=np.float32).transpose(2, 0, 1)

    image_key = image(key_path)
    key_to_ref = np.load(osp.join(key_path, "to_ref_transform.npy"))
    ref_to_key = invert_transform(key_to_ref)
    images = [image_key]
    poses = [key_to_ref @ ref_to_key]
    intrinsics = [np.load(osp.join(key_path, "K.npy"))]
    for src in src_paths:
        images.append(image(src))
        intrinsics.append(np.load(osp.join(src, "K.npy")))
        poses.append(np.load(osp.join(src, "to_ref_transform.npy")) @ ref_to_key)

    sample = {"images": images, "intrinsics": intrinsics, "poses": poses, "keyview_idx": 0}
    h_orig, w_orig = image_key.shape[-2:]
    return sample, h_orig, w_orig


def write_pred(pred, output_path, h_orig, w_orig):
    """(reference: inference.py:58-98)"""
    depth = resize_bilinear(pred["depth"], (h_orig, w_orig))[0]
    np.save(osp.join(output_path, "depth.npy"), depth)
    vis(depth).save(osp.join(output_path, "depth.png"))

    with np.errstate(divide="ignore", invalid="ignore"):
        invdepth = np.nan_to_num(1 / depth, nan=0, posinf=0, neginf=0)
    np.save(osp.join(output_path, "invdepth.npy"), invdepth)
    vis(invdepth).save(osp.join(output_path, "invdepth.png"))

    if "depth_uncertainty" in pred:
        unc = resize_bilinear(pred["depth_uncertainty"], (h_orig, w_orig))[0]
        np.save(osp.join(output_path, "depth_uncertainty.npy"), unc)
        vis(unc).save(osp.join(output_path, "depth_uncertainty.png"))


def run(args, argv):
    if args.model is None:
        print(f"No model specified. Available models are: {', '.join(list_models())}")
        return
    print(f"Running inference on data from {args.input_path} with model {args.model} on {args.device}.")
    os.makedirs(args.output_path, exist_ok=True)
    with open(osp.join(args.output_path, "cmd.txt"), "w") as f:
        f.write("python -m robustmvd_tpu_torch.inference " + " ".join(argv))

    model = create_model(name=args.model, weights=args.weights, train=False, device=args.device,
                         **cli_model_kwargs(args.model, args.dtype))
    sample, h_orig, w_orig = load_data(args.input_path)
    pred, _ = model.run(**sample)
    write_pred(pred, args.output_path, h_orig, w_orig)
    print(f"Done. Output written to {args.output_path}.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input_path", default="sample_data", help="Path to folder with input data.")
    parser.add_argument("--output_path", default="sample_data/out", help="Path to folder for output data.")
    parser.add_argument("--model", help=f"Model. Available: {', '.join(list_models())}")
    parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                        help="Compute dtype of the robust_mvd family (float32 by default; bfloat16 runs the "
                             "convolutions and the correlation in bf16 with float32 sums and float32 heads).")
    parser.add_argument("--weights",
                        help="Path to model weights (.pt; robust_mvd also a JAX .msgpack snapshot). Optional.")
    parser.add_argument("--num_gpus", type=int, default=1,
                        help="Declared as in the JAX CLI, which never reads it; the card is --device.")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu.")
    return parser.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    run(parse_args(argv), argv)


if __name__ == "__main__":
    main()
