"""Evaluation CLI of the port (reference: rmvd eval.py; the JAX package's

root ``eval.py``): evaluate a model on one dataset (``--eval_type mvd``) or
on the five-dataset Robust MVD benchmark (``--eval_type robustmvd``):

    python -m robustmvd_tpu_torch.eval --eval_type mvd --dataset synthetic.train.mvd \\
        --model robust_mvd --inputs poses intrinsics --output out/ [--num_samples N] [--dtype bfloat16] \\
        [--device cuda]

The model runs on the card unless ``--device cpu`` is given; without a card
the default raises. Outputs: ``results.csv`` / ``.pickle`` and the rest of
the evaluation's files, ``log.txt`` and ``cmd.txt``; the event writer
(``utils/writer.py``) is set up in ``--log_dir`` (``--output`` by default),
as the JAX CLI sets it up.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import random
import sys

import numpy as np

from ..data import create_dataset, list_datasets
from ..models import cli_model_kwargs, create_model, list_models
from ..utils import logging, writer
from . import create_evaluation, list_evaluations


def evaluate(args, argv):
    random.seed(args.seed)
    np.random.seed(args.seed)

    if args.model is None:
        logging.info(f"No model specified. Available models: {', '.join(list_models())}")
        return
    if args.eval_type is None:
        logging.info(f"No evaluation type specified. Available: {', '.join(list_evaluations())}")
        return
    if args.eval_type != "robustmvd" and args.dataset is None:
        datasets = list_datasets(dataset_type=args.eval_type, no_dataset_type=True)
        logging.info(f"No dataset specified. Available datasets: {', '.join(datasets)}")
        return

    model_kwargs = cli_model_kwargs(args.model, args.dtype)

    log_dir = args.log_dir if args.log_dir is not None else args.output
    os.makedirs(args.output, exist_ok=True)
    writer.setup_writers(log_tensorboard=not args.no_tensorboard, log_wandb=args.wandb, out_dir=log_dir)
    log_file_path = osp.join(args.output, "log.txt")
    logging.add_log_file(log_file_path, flush_line=True)
    with open(osp.join(args.output, "cmd.txt"), "a") as f:
        f.write("python -m robustmvd_tpu_torch.eval " + " ".join(argv) + "\n")

    dataset = None
    if args.eval_type != "robustmvd":
        dataset = create_dataset(dataset_name_or_path=args.dataset, dataset_type=args.eval_type,
                                 input_size=args.input_size)
    model = create_model(name=args.model, weights=args.weights, train=False, device=args.device,
                         **model_kwargs)
    evaluation = create_evaluation(
        args.eval_type, out_dir=args.output, inputs=args.inputs, alignment=args.alignment,
        view_ordering=args.view_ordering, min_source_views=args.min_source_views,
        max_source_views=args.max_source_views, eval_uncertainty=args.eval_uncertainty,
    )
    samples = args.num_samples if args.num_samples is not None else args.samples
    qualitatives = args.qualitatives if args.qualitatives is not None else args.num_qualitatives
    try:
        evaluation(
            dataset=dataset, model=model, samples=samples, qualitatives=qualitatives,
            eth3d_size=args.eth3d_size, kitti_size=args.kitti_size, dtu_size=args.dtu_size,
            scannet_size=args.scannet_size, tanks_and_temples_size=args.tanks_and_temples_size,
            eval_name=args.eval_name, finished_iterations=args.finished_iterations,
        )
    finally:
        logging.remove_log_file(log_file_path)
        writer.setup_writers(out_dir=None)  # closes this run's backends


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", help=f"Model. Available: {', '.join(list_models())}")
    parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                        help="Compute dtype of the robust_mvd family (float32 by default; bfloat16 runs the "
                             "convolutions and the correlation in bf16 with float32 sums and float32 heads).")
    parser.add_argument("--weights", help="Path to rmvd model weights (.pt). Optional.")
    parser.add_argument("--eval_type", help="mvd | robustmvd")
    parser.add_argument("--dataset", help="Dataset name (for eval_type=mvd).")
    parser.add_argument("--output", default="./eval_out", help="Output directory.")
    parser.add_argument("--log_dir", help="Directory of the event writer's files (defaults to --output).")
    parser.add_argument("--inputs", nargs="*", help="Model input modalities.")
    parser.add_argument("--alignment", help="None | median | least_squares_scale_shift")
    parser.add_argument("--view_ordering", default="quasi-optimal")
    parser.add_argument("--min_source_views", type=int, default=1)
    parser.add_argument("--max_source_views", type=int)
    parser.add_argument("--eval_uncertainty", action="store_true", default=True)
    parser.add_argument("--no_eval_uncertainty", dest="eval_uncertainty", action="store_false")
    parser.add_argument("--input_size", type=int, nargs=2, help="(height, width)")
    parser.add_argument("--eth3d_size", type=int, nargs=2, default=None)
    parser.add_argument("--kitti_size", type=int, nargs=2, default=None)
    parser.add_argument("--dtu_size", type=int, nargs=2, default=None)
    parser.add_argument("--scannet_size", type=int, nargs=2, default=None)
    parser.add_argument("--tanks_and_temples_size", type=int, nargs=2, default=None)
    parser.add_argument("--num_samples", type=int, help="Evaluate only N samples.")
    parser.add_argument("--samples", type=int, nargs="*", help="Sample indices.")
    parser.add_argument("--num_qualitatives", type=int, default=10)
    parser.add_argument("--qualitatives", type=int, nargs="*")
    parser.add_argument("--eval_name")
    parser.add_argument("--finished_iterations", type=int)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu.")
    parser.add_argument("--no_tensorboard", action="store_true", help="Write events.jsonl only.")
    parser.add_argument("--wandb", action="store_true", help="Also log scalars to wandb where it imports.")
    parser.add_argument("--exp_id", help="Declared as in the JAX CLI, which never reads it; ignored.")
    parser.add_argument("--comment", help="Declared as in the JAX CLI, which never reads it; ignored.")
    return parser.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    evaluate(parse_args(argv), argv)
