"""The bench suite: the JAX bench's ``main()`` (bench.py:394-452) on the card.

    python -m robustmvd_tpu_torch.bench [--device cpu]

Runs the ten workloads of ``workloads.py`` and then the evaluation protocol
(``eval_protocol.py``; ``RMVD_BENCH_EVAL_PROTOCOL=0`` leaves it out), in
JAX's order, on one random stream (``np.random.RandomState(0)``). Selects by
``BENCH_ONLY`` (comma-separated substrings of the keys) and takes the
headline's dtype from ``BENCH_DTYPE`` (bfloat16 or float32), as JAX does.
Prints each workload's entries as one JSON line each as soon as it ends, so
that a cut run keeps what it measured, and last JAX's summary line:
``metric``, ``value``, ``unit``, ``vs_baseline`` (against 0.28 s a frame),
``device_kind`` and ``all``, here ``{metric: value}`` so that the line stays
short. A workload that raises gives an entry ``{"metric": key, "error":
...}`` (its traceback on stderr), the suite goes on, and the process exits
with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import numpy as np
import torch

from . import eval_protocol, workloads
from .flops import peak_flops

HEADLINE = "robust_mvd_forward_384x1280_3views"
BASELINE_SEC_PER_FRAME = 0.28  # bench.py:23-26, 49: a GPU-class proxy, indicative only


def summary(entries, device_kind, headline_dtype="bfloat16"):
    """JAX's last line, with ``all`` as {metric: value, or "error"}."""
    wanted = f"{HEADLINE}_{'bfloat16' if headline_dtype == 'bfloat16' else 'float32'}"
    headline = next((e for e in entries if e.get("metric") == wanted and "value" in e),
                    next((e for e in entries if "value" in e), None))
    value = headline["value"] if headline else None
    return {"metric": HEADLINE, "value": value, "unit": "frames/s",
            "vs_baseline": round(value / (1.0 / BASELINE_SEC_PER_FRAME), 3) if headline else None,
            "device_kind": device_kind,
            "all": {e["metric"]: e.get("value", "error") for e in entries}}


def main(argv=None):
    parser = argparse.ArgumentParser(description="The bench suite on the card.")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu.")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run the bench on the CPU")
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    bench = workloads.Bench(device=device, peak=peak_flops(device_kind) if device.type == "cuda" else None,
                            rng=np.random.RandomState(0))

    only = os.environ.get("BENCH_ONLY")
    runs = [(w.key, lambda w=w: w.run(bench)) for w in workloads.WORKLOADS]
    if os.environ.get("RMVD_BENCH_EVAL_PROTOCOL", "1") != "0":
        runs.append(("eval_protocol", lambda: eval_protocol.run_protocol(samples=3, burn_in=2, device=device)))

    entries, failed = [], False
    for key, run in runs:
        if only and not any(s in key for s in only.split(",")):
            continue
        try:
            result = run()
            rows = result if isinstance(result, list) else [result]
        except Exception as e:  # recorded, and the suite goes on
            traceback.print_exc()
            rows, failed = [{"metric": key, "error": f"{type(e).__name__}: {e}"}], True
        for row in rows:
            print(json.dumps(row), flush=True)
        entries.extend(rows)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(summary(entries, device_kind, os.environ.get("BENCH_DTYPE", "bfloat16"))), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
