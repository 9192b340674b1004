#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). Phases, each printing one JSON line:

1. build:   compile every CUDA kernel of the port from ``csrc/`` (one
            ``nvcc`` per source, all started together).
2. card:    the card's name and power limit (nvidia-smi), which every
            number below belongs to.
3. kernel:  K1 (plane-sweep score sampling) at the main path's shape,
            P = 48*160 key pixels, 48x160 score images, S = 256, taps from a
            real epipolar sweep; f32 and bf16 held against the plain torch
            version on the card; kernel, plain and library (grid_sample)
            times with CUDA events; the bytes bound.
4. parity:  robust_mvd on the card vs on the CPU, TF32 off, 64x128, 1+2 views.
5. main:    the inference CLI on sample_data/ (256x320, 1+3 views), then
            ``model.run`` at 384x1280 with 1+2 views, fp32: warm-up, timed
            frames, peak memory, and K1's launch count on that run; then
            where a frame's time goes: host-clock stages of ``model.run``
            and device time per kernel from torch.profiler.
6. the kernels line, and last the ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero; it does nothing
without a CUDA device. Weights are random, from a seed.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
MODEL_BOUNDS = (1e-4, 1e-3)  # mean, max relative error (tests/test_torch_port_model.py)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, runs=30, warmup=5):
    """Median of per-call CUDA-event times, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def set_tf32(enabled):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def relative_errors(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).mean() + 1e-12
    diff = np.abs(ours - ref)
    return float(diff.mean() / scale), float(diff.max() / scale)


def kitti_like_sample(rng, H, W, num_views):
    """Random images in the run() contract with KITTI-like intrinsics and a
    forward-moving camera (source views behind and ahead of the key)."""
    images = [rng.rand(1, 3, H, W).astype(np.float32) * 255 for _ in range(num_views)]
    K = np.array([[0.58 * W, 0, 0.5 * W], [0, 1.92 * H, 0.5 * H], [0, 0, 1]], np.float32)
    poses = []
    for i in range(num_views):
        T = np.eye(4, dtype=np.float32)
        offset = [0, -1, 1, -2, 2][i]
        T[:3, 3] = [0.02 * offset, 0.0, 0.8 * offset]
        angle = 0.01 * offset
        T[0, 0] = T[2, 2] = np.cos(angle)
        T[0, 2], T[2, 0] = np.sin(angle), -np.sin(angle)
        poses.append(T[None])
    return {"images": images, "poses": poses, "intrinsics": [K[None]] * num_views,
            "keyview_idx": np.zeros(1, np.int64)}


def phase_build():
    from robustmvd_tpu_torch.ops.kernels import KERNELS, build

    t0 = time.perf_counter()
    results = build.build(list(KERNELS), force=True)
    ptxas = {name: [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
             for name, (_, log) in results.items()}
    emit("build", seconds=time.perf_counter() - t0,
         kernels={name: seconds for name, (seconds, _) in results.items()}, ptxas=ptxas)


def phase_card():
    import torch

    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit("card", nvidia_smi=line, kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)


def k1_inputs(device, H=48, W=160, S=256):
    """K1's arguments as the main path gives them at 384x1280: taps from the
    epipolar sweep of a forward-moving KITTI-like camera pair."""
    import torch

    from robustmvd_tpu_torch.ops.corr import tap_coordinates
    from robustmvd_tpu_torch.ops.epipolar import make_epipolar_coeffs, planesweep_points, sampling_invdepths

    sample = kitti_like_sample(np.random.RandomState(0), 8 * H, 8 * W, 2)
    K_rel = torch.tensor(sample["intrinsics"][0] / np.array([[8 * W], [8 * H], [1]], np.float32), device=device)
    T = torch.tensor(sample["poses"][1], device=device)
    coeffs = make_epipolar_coeffs(K_rel, K_rel, T, H, W)
    us, vs, _ = planesweep_points(coeffs, sampling_invdepths(0.4, 1000.0, S, device=device))
    x0, y0, wx, wy = tap_coordinates(us, vs)
    gen = torch.Generator(device=device).manual_seed(0)
    corr = torch.randn((H * W, H, W), generator=gen, device=device)
    return corr, y0[0].contiguous(), wy[0].contiguous(), x0[0].contiguous(), wx[0].contiguous()


def k1_bound(corr, y0, x0):
    """Least time for K1 on these inputs: coordinates read once, output written
    once, and each distinct in-range score tap read once (data-dependent)."""
    import torch

    P, Hs, Ws = corr.shape
    S = y0.shape[1]
    ty, tx = y0.long(), x0.long()
    p = torch.arange(P, device=corr.device)[:, None]
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = ty + dy, tx + dx
            valid = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
            taps.append(((p * Hs + yi) * Ws + xi)[valid])
    distinct = int(torch.unique(torch.cat(taps)).numel())
    samples = P * S
    nbytes = samples * (4 * 4 + 4) + distinct * corr.element_size()
    flops = samples * 12
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "distinct_taps": distinct, "taps_in_range_share": distinct / (4 * samples),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.planesweep_sample import planesweep_sample, planesweep_sample_reference

    device = torch.device("cuda")
    corr, y0, wy, x0, wx = k1_inputs(device)
    P, Hs, Ws = corr.shape
    S = y0.shape[1]
    results = {}
    for mode, scores, limit in (("f32", corr, 1e-5), ("bf16", corr.bfloat16(), 1e-2 * float(corr.abs().max()))):
        out = planesweep_sample(scores, y0, wy, x0, wx)
        torch.cuda.synchronize()
        ref = planesweep_sample_reference(scores, y0, wy, x0, wx)
        err = float((out - ref).abs().max())
        if not err <= limit:
            raise AssertionError(f"K1 {mode} disagrees with its plain version: max_abs_err {err} > {limit}")
        bound = k1_bound(scores, y0, x0)
        results[mode] = {
            "max_abs_err": err, "limit": limit,
            "ms": time_ms(lambda: planesweep_sample(scores, y0, wy, x0, wx)),
            "plain_ms": time_ms(lambda: planesweep_sample_reference(scores, y0, wy, x0, wx), runs=20),
            **bound,
        }
    # yardstick: one library call computing the same samples (the port never calls it)
    gx = (2.0 * (x0.float() + wx) + 1.0) / Ws - 1.0
    gy = (2.0 * (y0.float() + wy) + 1.0) / Hs - 1.0
    grid = torch.stack([gx, gy], -1)[:, None]  # (P, 1, S, 2)
    img = corr[:, None]

    def library():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    lib_err = float((library()[:, 0, 0] - planesweep_sample(corr, y0, wy, x0, wx)).abs().max())
    results["f32"]["library_ms"] = time_ms(library)
    results["f32"]["library_max_abs_diff"] = lib_err
    results["bf16"]["library_ms"] = None
    emit("kernel", name="planesweep_sample", shape={"P": P, "Hs": Hs, "Ws": Ws, "S": S}, **results)
    return results


def phase_parity():
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    sample = kitti_like_sample(np.random.RandomState(1), 64, 128, 3)
    outs = {}
    for device in ("cpu", "cuda"):
        model = rmvd.create_model("robust_mvd", device=device, seed=0)
        outs[device] = model.run(**sample)
        del model
    (pc, ac), (pg, ag) = outs["cpu"], outs["cuda"]
    errors = {}
    for key in ("invdepths_all", "invdepth_log_bs_all"):
        for scale, (g, c) in enumerate(zip(ag[key], ac[key])):
            mean, mx = relative_errors(g, c)
            errors[f"{key}[{scale}]"] = [mean, mx]
            if not (mean <= MODEL_BOUNDS[0] and mx <= MODEL_BOUNDS[1]):
                raise AssertionError(f"card vs CPU {key}[{scale}]: mean {mean}, max {mx} > {MODEL_BOUNDS}")
    inv = ac["invdepth"]
    rel = np.abs(pg["depth"] - pc["depth"]) / pc["depth"]
    depth_err = [float(rel[inv > 0].mean()), float(rel[inv >= 1e-3].max())]
    if not (depth_err[0] <= MODEL_BOUNDS[0] and depth_err[1] <= MODEL_BOUNDS[1]):
        raise AssertionError(f"card vs CPU depth: {depth_err} > {MODEL_BOUNDS}")
    if not (inv > 0).mean() > 0.1:
        raise AssertionError("parity run predicts almost no positive invdepth: the check would be vacuous")
    emit("parity", tf32=tf32, shape=[64, 128], views=3, bounds=MODEL_BOUNDS, depth_rel_err=depth_err,
         invdepth_positive_share=float((inv > 0).mean()), errors=errors)
    torch.cuda.empty_cache()


def phase_main(counters):
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.inference import main as inference_main

    root = os.path.dirname(os.path.abspath(__file__))
    # the inference CLI, in-process so that its launches are counted
    with tempfile.TemporaryDirectory() as out:
        counters.reset()
        inference_main(["--model", "robust_mvd", "--input_path", os.path.join(root, "sample_data"),
                        "--output_path", out])
        cli_launches = counters.read()
        depth = np.load(os.path.join(out, "depth.npy"))
        if depth.shape != (256, 320) or not np.isfinite(depth).all():
            raise AssertionError(f"CLI depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        if cli_launches["planesweep_sample"] != 3:
            raise AssertionError(f"CLI with 3 source views launched K1 {cli_launches} times, expected 3")
    emit("main_cli", input="sample_data", shape=[256, 320], views=4, launches=cli_launches)

    model = rmvd.create_model("robust_mvd")
    sample = kitti_like_sample(np.random.RandomState(2), 384, 1280, 3)
    runs = {}
    for label, tf32_on in (("fp32", False), ("tf32_convs", True)):
        tf32 = set_tf32(False)
        if tf32_on:  # PyTorch's default: TF32 for cuDNN convolutions only
            torch.backends.cudnn.allow_tf32 = True
            tf32 = {**tf32, "cudnn.allow_tf32": True}
        warmup, frames = 3, 20
        counters.reset()
        for _ in range(warmup):
            pred, _ = model.run(**sample)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            pred, _ = model.run(**sample)  # ends in a device->host copy
            times.append((time.perf_counter() - t0) * 1e3)
        launches = counters.read()
        if launches["planesweep_sample"] != 2 * (warmup + frames):
            raise AssertionError(f"K1 launched {launches} times in {warmup + frames} frames of 2 source views")
        depth = pred["depth"]
        if depth.shape != (1, 1, 192, 640) or not np.isfinite(depth).all():
            raise AssertionError(f"main path depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        runs[label] = {
            "tf32": tf32, "ms_per_frame": statistics.median(times), "ms_per_frame_mean": statistics.mean(times),
            "ms_per_frame_min": min(times), "frames": frames, "warmup": warmup,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "launches": launches,
            "launches_per_frame": launches["planesweep_sample"] / (warmup + frames),
        }
    emit("main", shape=[384, 1280], views=3, dtype="float32", **runs)

    set_tf32(False)
    emit("breakdown", **device_breakdown(model, sample, frames=10))
    return runs


def device_breakdown(model, sample, frames):
    """Where a frame's time goes: host-clock stages of model.run, each ended
    by a synchronise, and device time per kernel from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    stages = {"input_adapter": [], "forward": [], "output_adapter": []}
    for _ in range(frames):
        t0 = time.perf_counter()
        inputs = model.input_adapter(**{k: sample[k] for k in ("images", "keyview_idx", "poses", "intrinsics")})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = model(**inputs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        model.output_adapter(out)
        t3 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[name].append(dt * 1e3)
    stage_ms = {name: statistics.median(v) for name, v in stages.items()}

    for _ in range(2):  # the first profile pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                model.run(**sample)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side events; their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3 / frames, e.count / frames))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    frame_ms = sum(stage_ms.values())
    by_kind = {}
    for name, ms, _ in rows:
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    return {
        "frames": frames, "stage_ms": stage_ms, "frame_ms": frame_ms,
        "device_ms_per_frame": device_ms,
        "device_busy_share": device_ms / frame_ms if device_ms else None,
        "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top": [{"name": k[:100], "ms_per_frame": ms, "calls_per_frame": n} for k, ms, n in rows[:20]],
    }


def kernel_kind(name):
    """Group profiler rows: convolutions (cuDNN), the score matmul (the only
    GEMM outside cuDNN), K1, copies, and the rest (elementwise, cat, gather)."""
    if "planesweep_sample" in name:
        return "k1_planesweep_sample"
    if "HtoD" in name or "DtoH" in name:
        return "memcpy_" + ("h2d" if "HtoD" in name else "d2h")
    if any(key in name for key in ("fprop", "convolve", "dgrad", "cudnn")):
        return "convolutions"
    if "gemm" in name:
        return "score_matmul"
    return "other"


class Counters:
    """Reset and read the launch count of every kernel wrapper of the port."""

    def __init__(self):
        from robustmvd_tpu_torch.ops.kernels import KERNELS

        self.kernels = KERNELS

    def reset(self):
        for fn in self.kernels.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.kernels.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    import robustmvd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.cuda.set_device(0)
    phase_build()
    phase_card()
    k1 = phase_kernel()
    phase_parity()
    runs = phase_main(Counters())

    f32, bf16 = k1["f32"], k1["bf16"]
    print(json.dumps({"kernels": [{
        "name": "planesweep_sample",
        "route": "cuda",
        "source": "robustmvd_tpu_torch/csrc/planesweep_sample.cu",
        "replaces": "robustmvd_tpu/ops/pallas/planesweep_sample.py:55; "
                    "robustmvd_tpu/ops/pallas/planesweep_sample_v2.py:64",
        "launches": runs["fp32"]["launches"]["planesweep_sample"],
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "bf16": {k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
