"""The published five-dataset evaluation protocol at its production shapes,
on the card: the JAX package's ``tools/bench_eval_protocol.py``.

Runs the evaluation engine (``MultiViewDepthEvaluation``: quasi-optimal view
ordering, the 1..V-1 source-view sweep, uncertainty and AUSE, clipping) with
robust_mvd over ``synthetic`` stand-ins that have each benchmark's input
size (eval_all.sh:53), view count and key view; real data needs downloads,
and the protocol's shapes are what this exercises. Per dataset: the mean
``runtime_model_in_msec`` (burn-in samples excluded, the engine's CUDA
events), the mean AUSE and the peak device memory. JAX's ``xla_compiles``
counts XLA's compiles by shape bucket and has no counterpart here.

    python -m robustmvd_tpu_torch.bench.eval_protocol [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# (name, (H, W), views, key view): sizes from eval_all.sh:53, view counts from
# the sample lists (tools/bench_eval_protocol.py:32-38)
PROTOCOL = [
    ("kitti", (384, 1280), 21, 10),
    ("dtu", (896, 1216), 11, 0),
    ("scannet", (448, 640), 8, 3),
    ("tanks_and_temples", (704, 1280), 11, 0),
    ("eth3d", (768, 1152), 11, 0),
]


def run_protocol(model=None, samples=4, burn_in=2, dtype="bfloat16", verbose=False, device="cuda",
                 protocol=PROTOCOL):
    """One row per dataset of ``protocol``; ``model`` defaults to a seeded
    robust_mvd at ``dtype`` on ``device``. The peak is the larger of the
    allocator's peak after the dataset (``utils/profiler.py::
    device_memory_stats``, reset before it; the engine resets it at every
    run, so this is the last run's) and the engine's per-run peaks; None
    off the card."""
    from ..data.synthetic import SyntheticMVD
    from ..eval.multi_view_depth_evaluation import MultiViewDepthEvaluation
    from ..models import create_model
    from ..utils.profiler import device_memory_stats

    if model is None:
        model = create_model("robust_mvd", pretrained=False, weights=None, dtype=dtype, device=device)
    device = model.device
    rows = []
    for name, (H, W), V, key_idx in protocol:
        dataset = SyntheticMVD(num_samples=samples, num_views=V, height=H, width=W, keyview_idx=key_idx,
                               input_size=(H, W))
        evaluation = MultiViewDepthEvaluation(out_dir=None, inputs=["poses", "intrinsics"],
                                              view_ordering="quasi-optimal", min_source_views=1,
                                              max_source_views=None, eval_uncertainty=True, clip_pred_depth=True,
                                              verbose=verbose)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        start = time.time()
        result = evaluation(dataset=dataset, model=model, burn_in_samples=burn_in)
        wall = time.time() - start
        peaks = [device_memory_stats(device).get("peak_mib_in_use", float("nan")),
                 float(result.loc[:, (slice(None), "device_mem_peak_in_mib")].max().max())]
        peaks = [p for p in peaks if p == p]  # NaN off the card
        rows.append({
            "metric": f"eval_protocol_{name}_{H}x{W}_{V}views",
            "value": round(float(result.loc[:, (slice(None), "runtime_model_in_msec")].mean().mean()), 3),
            "unit": "msec_model_per_run",
            "wall_sec_total": round(wall, 1),
            "samples": samples,
            "view_sweep": f"1..{V - 1}",
            "view_ordering": "quasi-optimal",
            "ause": float(result.loc[:, (slice(None), "ause")].mean().mean()),
            "peak_hbm_gb": round(max(peaks) / 1024, 3) if peaks else None,
            "dtype": dtype,
        })
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu.")
    args = parser.parse_args(argv)
    for row in run_protocol(device=args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
