"""Training CLI of the port (reference: rmvd train.py; the JAX package's
root ``train.py``). The paper recipe for robust_mvd (train_all.sh:8-18):

    python -m robustmvd_tpu_torch.train --training_type mvd --output out/ --model robust_mvd \\
        --inputs poses intrinsics --optimizer adam --lr 1e-4 --grad_clip_max_norm 5 \\
        --scheduler flownet_scheduler --loss robust_mvd_loss --batch_size 4 --max_iterations 600000 \\
        --dataset staticthings3d.robust_mvd.mvd \\
        --augmentations_per_dataset robust_mvd_augmentations_staticthings3d \\
        --batch_augmentations robust_mvd_batch_augmentations [--device cuda]

The model trains on the card unless ``--device cpu`` is given; without a
card the default raises. ``--data_parallel`` trains data-parallel over every
process of the launcher's group, one card (or CPU process) each, with the
global batch ``--batch_size`` times the processes:

    python -m robustmvd_tpu_torch.launch --local 2 -- -m robustmvd_tpu_torch.train --data_parallel ...

Started without the launcher it trains in a group of one process, and
refuses to where more than one card is visible. Outputs: ``log.txt``,
``cmd.txt``, ``events.jsonl`` (and TensorBoard's event files where
``tensorboard`` imports, unless ``--no_tensorboard``), ``checkpoints/`` and
``weights_only_checkpoints_dir/``; under ``--data_parallel`` rank 0 writes
them.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import random
import sys

import numpy as np
import torch

from ..data import create_compound_dataset, create_dataset, list_datasets
from ..launch import free_port
from ..loss import create_loss, list_losses
from ..models import cli_model_kwargs, create_model, list_models
from ..models.helpers import resolve_device
from ..optim import create_optimizer, create_scheduler, list_optimizers, list_schedulers
from ..parallel import MeshSpec, init_distributed, init_distributed_from_env, make_mesh
from ..utils import logging, writer
from . import create_training, list_trainings


def data_parallel_mesh(device):
    """The mesh of ``--data_parallel``: over the launcher's process group, or a
    group of this process alone where none was started (refused where more
    than one card is visible: one process drives one card)."""
    if not init_distributed_from_env():
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise RuntimeError("--data_parallel with several visible cards runs one process per card: start it "
                               "with python -m robustmvd_tpu_torch.launch --local N -- -m robustmvd_tpu_torch.train "
                               "...")
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl" if device.type == "cuda" else "gloo")
    return make_mesh(MeshSpec())


def train(args, argv):
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    if args.model is None:
        logging.info(f"No model specified. Available: {', '.join(list_models(trainable_only=True))}")
        return
    if args.training_type is None:
        logging.info(f"No training type specified. Available: {', '.join(list_trainings())}")
        return
    if args.augmentations is not None and args.augmentations_per_dataset is not None:
        logging.info("Error: --augmentations and --augmentations_per_dataset conflict.")
        return
    if args.dataset is None:
        logging.info(f"No dataset specified. Available: {', '.join(list_datasets())}")
        return
    if args.augmentations_per_dataset is not None and len(args.augmentations_per_dataset) != len(args.dataset):
        logging.info("Error: need one --augmentations_per_dataset per --dataset.")
        return
    if args.optimizer is None:
        logging.info(f"No optimizer specified. Available: {', '.join(list_optimizers())}")
        return
    if args.scheduler is None:
        logging.info(f"No scheduler specified. Available: {', '.join(list_schedulers())}")
        return
    if args.loss is None:
        logging.info(f"No loss specified. Available: {', '.join(list_losses())}")
        return

    model_kwargs = cli_model_kwargs(args.model, args.dtype)
    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device) if args.data_parallel else None
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())  # the launcher's card for this process
    writes = mesh is None or torch.distributed.get_rank() == 0

    os.makedirs(args.output, exist_ok=True)
    writer.setup_writers(log_tensorboard=not args.no_tensorboard, log_wandb=args.wandb,
                         out_dir=args.output if writes else None)
    log_file_path = osp.join(args.output, "log.txt")
    if writes:
        logging.add_log_file(log_file_path, flush_line=True)
        with open(osp.join(args.output, "cmd.txt"), "a") as f:
            f.write("python -m robustmvd_tpu_torch.train " + " ".join(argv) + "\n")

    try:
        datasets = []
        for idx, name in enumerate(args.dataset):
            augmentation = (args.augmentations_per_dataset[idx] if args.augmentations_per_dataset is not None
                            else args.augmentations)
            datasets.append(create_dataset(dataset_name_or_path=name, input_size=args.input_size,
                                           target_size=args.target_size, augmentations=augmentation))
        dataset = datasets[0] if len(datasets) == 1 else create_compound_dataset(datasets)

        model = create_model(name=args.model, pretrained=False, weights=args.weights, train=True, device=device,
                             **model_kwargs)
        optimizer = create_optimizer(name=args.optimizer, model=model, lr=args.lr)
        scheduler = create_scheduler(name=args.scheduler, optimizer=optimizer)
        loss = create_loss(name=args.loss, model=model)

        training = create_training(
            training_type=args.training_type, out_dir=args.output, model=model, dataset=dataset,
            optimizer=optimizer, scheduler=scheduler, loss=loss, batch_size=args.batch_size,
            max_iterations=args.max_iterations, inputs=args.inputs, batch_augmentations=args.batch_augmentations,
            grad_clip_max_norm=args.grad_clip_max_norm, num_workers=args.num_workers,
            log_interval=args.log_interval, mesh=mesh, verbose=True,
        )
        training()
    finally:
        logging.remove_log_file(log_file_path)
        writer.setup_writers(out_dir=None)  # closes this run's backends
        if mesh is not None:
            torch.distributed.destroy_process_group()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", help="Model to train.")
    parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                        help="Compute dtype of the robust_mvd family (float32 by default; bfloat16 runs the "
                             "convolutions and the correlation in bf16 with float32 sums and float32 heads).")
    parser.add_argument("--weights", help="Initial weights (a rmvd .pt). Optional.")
    parser.add_argument("--training_type", default="mvd")
    parser.add_argument("--dataset", nargs="*", help="Training dataset(s).")
    parser.add_argument("--augmentations", nargs="*")
    parser.add_argument("--augmentations_per_dataset", nargs="*")
    parser.add_argument("--batch_augmentations", nargs="*")
    parser.add_argument("--inputs", nargs="*")
    parser.add_argument("--input_size", type=int, nargs=2)
    parser.add_argument("--target_size", type=int, nargs=2)
    parser.add_argument("--output", default="./train_out")
    parser.add_argument("--optimizer", default="adam")
    parser.add_argument("--scheduler", default="flownet_scheduler")
    parser.add_argument("--loss")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--max_iterations", type=int, default=600000)
    parser.add_argument("--grad_clip_max_norm", type=float)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--log_interval", type=int, default=5000)
    parser.add_argument("--log_full_batch", action="store_true",
                        help="Declared as in the JAX CLI, which never reads it; ignored.")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data_parallel", action="store_true",
                        help="Data parallelism over the launcher's processes (python -m robustmvd_tpu_torch.launch), "
                             "one card each; the global batch is --batch_size times the processes.")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu.")
    parser.add_argument("--no_tensorboard", action="store_true", help="Write events.jsonl only.")
    parser.add_argument("--wandb", action="store_true", help="Also log scalars to wandb where it imports.")
    parser.add_argument("--exp_id", help="Declared as in the JAX CLI, which never reads it; ignored.")
    parser.add_argument("--comment", help="Declared as in the JAX CLI, which never reads it; ignored.")
    return parser.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    train(parse_args(argv), argv)
