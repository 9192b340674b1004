"""Scaling bench: frames/s of the robust_mvd forward on a batch of n x
``--per_device_batch`` at each device count n up to the cards there are (the
JAX package's ``bench_scaling.py``). On one card it measures batch
throughput; with more, each card runs its replica of the model on its share
of the batch, launched in turn from this process.

    python -m robustmvd_tpu_torch.bench.scaling [--device cpu] [--height 384] [--width 1280]
        [--per_device_batch 1] [--iters 10] [--num_sampling_points 256]

Prints one JSON line per device count: ``robust_mvd_fwd_scaling_n{n}``,
frames/s, and the efficiency against n times the one-device rate.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from ..models import create_model
from ..utils.profiler import time_fn
from .workloads import precision


def scaling_batch(B, V, H, W, rng):
    """bench_scaling.py's inputs (:53-60), in the port's layouts."""
    images = rng.rand(B, V, H, W, 3).astype(np.float32) - 0.4
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[:, 1:, 0, 3] = 0.1
    intrinsics = np.tile(np.array([[0.8, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], dtype=np.float32), (B, V, 1, 1))
    return {"images": torch.from_numpy(np.ascontiguousarray(images.transpose(0, 1, 4, 2, 3))),
            "poses": torch.from_numpy(poses), "intrinsics": torch.from_numpy(intrinsics),
            "keyview_idx": torch.zeros((B,), dtype=torch.int64)}


def sharded_forward(replicas, shards):
    """The depth's sum of each replica on its shard, launched in turn; on
    cards, the first card's stream waits for the others, so that an event
    on it after this call follows all of them."""
    with torch.inference_mode():
        sums = [model(**shard)[0]["depth"].sum() for model, shard in zip(replicas, shards)]
    first = sums[0].device
    if first.type == "cuda":
        for s in sums[1:]:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(s.device))
            torch.cuda.current_stream(first).wait_event(done)
    return sums


def main(args, devices=None):
    """One line per device count. ``devices``: the devices to scale over
    (default: every card, or the CPU with ``--device cpu``)."""
    if devices is None:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run the bench on the CPU")
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                   else [device])
    model = create_model("robust_mvd", pretrained=False, weights=None, remat=False, device=devices[0],
                         num_sampling_points=args.num_sampling_points)
    V, H, W = 3, args.height, args.width
    rng = np.random.RandomState(0)
    base_fps = None
    replicas = [model]
    for n in [c for c in (1, 2, 4, 8, 16, 32) if c <= len(devices)]:
        replicas += [copy.deepcopy(model).to(d) for d in devices[len(replicas):n]]
        B = n * args.per_device_batch
        batch = scaling_batch(B, V, H, W, rng)
        shards = [{k: v[i * args.per_device_batch:(i + 1) * args.per_device_batch].to(d) for k, v in batch.items()}
                  for i, d in enumerate(devices[:n])]
        with precision(True):
            # bench_scaling.py: one compile call and 3 more before the timed ones
            seconds = time_fn(sharded_forward, replicas, shards, iters=args.iters, burn_in=4, device=devices[0])
        fps = B / seconds
        if base_fps is None:
            base_fps = fps
        print(json.dumps({"metric": f"robust_mvd_fwd_scaling_n{n}", "value": round(fps, 3), "unit": "frames/s",
                          "devices": n, "scaling_efficiency": round(fps / (base_fps * n), 3)}), flush=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--per_device_batch", type=int, default=1)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (default: every card) or cpu")
    parser.add_argument("--num_sampling_points", type=int, default=256,
                        help="Plane-sweep hypotheses (a small value for a CPU run).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
