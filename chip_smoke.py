#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). Phases, each printing one JSON line:

1. build:   compile every CUDA kernel of the port from ``csrc/`` (one
            ``nvcc`` per source, all started together).
2. card:    the card's name and power limit (nvidia-smi), which every
            number below belongs to.
3. kernel:  K1 (plane-sweep score sampling) at the robust_mvd path's shape,
            P = 48*160 key pixels, 48x160 score images, S = 256, taps from a
            real epipolar sweep; f32 and bf16 held against the plain torch
            version on the card; kernel, plain and library (grid_sample, in
            f32 and in bf16) times with CUDA events; the bytes bound.
4. kernel:  K2 (fused plane-sweep warp + variance) at the family paths'
            shapes: mvsnet (B=1, V=2, D=256, 96x320, C=32) with f32 and bf16
            features, cvp's coarse level (R,t mode, D=48, 24x80, C=16) and
            its finest level (dense mode, D=8, 384x1280, C=16); each held
            against the plain torch version on the card; kernel, plain and
            grid_sample-route times; the bound and the bound share; K2 must
            beat its grid_sample route at mvsnet_f32.
5. parity:  robust_mvd (64x128), mvsnet_train and cvp_mvsnet (128x160) on
            the card vs on the CPU, TF32 off, 1+2 views (the family with
            cuDNN's deterministic algorithms).
6. main:    robust_mvd: the inference CLI on sample_data/ (256x320, 1+3
            views), then ``model.run`` at 384x1280 with 1+2 views, fp32 and
            TF32 convolutions: warm-up, timed frames, peak memory, and K1's
            launch count on that run; where a frame's time goes (host-clock
            stages of ``model.run``, device time per kernel from
            torch.profiler). Then the same for the MVSNet family: the CLI
            with mvsnet_train on sample_data/, and ``model.run`` of
            mvsnet_train and cvp_mvsnet at 384x1280 with 1+2 views, with K2's
            launches on each run.
7. vis:     K2's group mode (fused homography warp + 8-group correlation)
            at vis_mvsnet's three stage shapes and K3 (fused soft-argmin) at
            its pair and fused readout shapes, each held against its plain
            version on the card, timed beside the bound, the grid_sample
            route (K2 group, with the bound share, and required to beat the
            route at stage 3) and torch.softmax (K3, with the route its C
            entry takes for D, and required to beat torch.softmax at the
            stage-3 pair readout); vis_mvsnet on the card
            vs the CPU (128x192, TF32 off, cuDNN deterministic) with K5 and
            with cuDNN's 3D convolutions; the CLI with vis_mvsnet on
            sample_data/, and ``model.run`` at 384x1280 with 1+2 views, with
            both kernels' launches on each run.
8. K5/K4:   K5 (3x3x3 stride-1 conv) on NCDHW volumes at the shapes of
            mvsnet_train's CostRegNet (conv3d_impl="banded") and of
            vis_mvsnet's stage-3 regularisers, held against its plain version,
            timed beside the bound of the path it took (3xTF32 tensor cores
            for Cout > 4, CUDA cores for the score heads) and F.conv3d
            (cuDNN, TF32 off and on), and required to beat F.conv3d fp32 at
            mvsnet's conv4 and conv6; K4
            (materialised homo_warp volume) with f32 and bf16 features at
            mvsnet's (1, 256, 96, 320, 32), beside F.grid_sample, and
            required to beat it with f32 features. Card-vs-CPU
            parity also covers mvsnet_train with conv3d_impl="banded",
            warp_impl="xla" and cvp_mvsnet with "banded"; vis_mvsnet's default
            runs K5. The main paths add mvsnet_train on K4 + K5 and vis_mvsnet
            with conv3d_impl="xla" (cuDNN) beside its default, each with
            every kernel's launches per frame.
9. eval:    the evaluation engine (``create_evaluation("mvd")``) with
            robust_mvd at full width over ``synthetic``: on the card vs on the
            CPU (5 views, 128x256, 2 samples, nearest ordering, uncertainty,
            TF32 off, cuDNN deterministic), every metric column but runtime
            and memory within PERF.md §2's limits; then at KITTI's evaluation
            configuration (21 views, key view 10, 375x1242, quasi-optimal
            ordering, 3 samples, the first a burn-in sample) and at ETH3D's
            (11 views, 1024x1536, 2 samples): model runs and K1 launches per
            sample, the engine's runtimes, wall seconds per sample, host
            share, peak memory.
10. the kernels line, and last the ``{"ok": true, ...}`` line.

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
TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense TF32 on the tensor cores
MODEL_BOUNDS = (1e-4, 1e-3)  # mean, max relative error (tests/test_torch_port_model.py)
K2_LIMIT = 1e-5  # K2 (both modes) vs its plain version: the same op order, no fused multiply-add
# K3 vs its plain version (torch.softmax and sums over D in another order,
# expf/logf vs torch's): prob, expectation (+ 1e-6 * D: it reaches D - 1),
# entropy
K3_LIMITS = (1e-6, 1e-5, 1e-5)
FLIPPED_SHARE = 0.01  # uncertainty pixels whose truncated window index may differ
# cvp_mvsnet's finer levels space their hypotheses by the mean one-pixel
# interval, a mean over pixels that includes near-singular 2x2 solves, so
# rounding differences (the card's convolutions sum in another order) grow
# level by level. Its coarsest level (no interval) is held at MODEL_BOUNDS,
# its final depth and uncertainty here.
CVP_FINE_BOUNDS = (1e-2, 5e-2)
# the evaluation's 1.03-inlier ratio counts pixels on one side of a threshold:
# card vs CPU it may differ by this share of the pixels (PERF.md §2)
INLIER_FLIP_SHARE = 1e-3
EVAL_TIMING = ("runtime_model_in_sec", "runtime_model_in_msec", "runtime_model_and_io_in_sec",
               "runtime_model_and_io_in_msec", "device_mem_peak_in_mib")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, runs=30, warmup=5):
    """Median of per-call CUDA-event times, after warm-up. The timed calls
    are queued behind a sleep kernel (~10 ms), so that the events time the
    card's work and not the host's launch overhead between small kernels."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
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
    # bf16: grid_sample takes bf16 scores with a grid of the same dtype (so
    # the sample positions round to bf16 too: the diff is reported, not held)
    img16, grid16 = corr.bfloat16()[:, None], grid.bfloat16()

    def library_bf16():
        return F.grid_sample(img16, grid16, mode="bilinear", padding_mode="zeros", align_corners=False)

    ref16 = planesweep_sample(corr.bfloat16(), y0, wy, x0, wx)
    results["bf16"]["library_ms"] = time_ms(library_bf16)
    results["bf16"]["library_max_abs_diff"] = float((library_bf16()[:, 0, 0].float() - ref16).abs().max())
    emit("kernel", name="planesweep_sample", shape={"P": P, "Hs": Hs, "Ws": Ws, "S": S}, **results)
    return results


def sideways_sample(rng, H, W, num_views):
    """Random images with KITTI-like intrinsics and source cameras beside the
    key (a stereo-like rig with small rotations), the MVSNet family's usual
    geometry. Forward motion puts the epipole inside the image, where
    CVP-MVSNet's hypothesis interval has 0/0 pixels and its mean is NaN, as
    in the JAX package (ROADMAP queue 3)."""
    from scipy.spatial.transform import Rotation

    sample = kitti_like_sample(rng, H, W, num_views)
    for i in range(1, num_views):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        T[:3, 3] = [0.2 * [0, -1, 1, -2, 2][i], 0.02 * rng.randn(), 0.02 * rng.randn()]
        sample["poses"][i] = T[None]
    return sample


def k2_cases(device):
    """K2's arguments at the family paths' shapes, from a sideways KITTI-like
    rig at 384x1280: {case: (ref, src, rot, trans, depth)}."""
    import torch

    from robustmvd_tpu_torch.models.blocks.cvp_mvsnet import condition_intrinsics, proj_mat, src_from_ref
    from robustmvd_tpu_torch.models.mvsnet import projection_matrices, unit_steps
    from robustmvd_tpu_torch.ops.homography import inverse, plane_sweep_transform

    H, W = 384, 1280
    sample = sideways_sample(np.random.RandomState(3), H, W, 3)
    K = torch.tensor(np.stack(sample["intrinsics"], 1), device=device)  # (1, 3, 3, 3)
    poses = torch.tensor(np.stack(sample["poses"], 1), device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def feats(h, w, C):
        return (torch.randn((1, h, w, C), generator=gen, device=device),
                torch.randn((1, 2, h, w, C), generator=gen, device=device))

    cases = {}
    # mvsnet: 1/4 projections, the key's inverted, 256 planes over 0.2..100
    proj = projection_matrices(K, poses)
    rot, trans = plane_sweep_transform(proj[:, 1:], torch.linalg.inv(proj[:, 0]))
    depth = (0.2 + unit_steps(256, device) * (100.0 - 0.2))[None]
    cases["mvsnet_f32"] = (*feats(96, 320, 32), rot.contiguous(), trans.contiguous(), depth)
    ref, src = cases["mvsnet_f32"][:2]
    cases["mvsnet_bf16"] = (ref.bfloat16(), src.bfloat16(), *cases["mvsnet_f32"][2:])

    def rt(level, shapes):
        Ks = condition_intrinsics(K.reshape(3, 3, 3), (H, W), shapes)  # (3 views, S, 3, 3)
        ref_inv = inverse(proj_mat(Ks[0:1, level], poses[:, 0]))
        rts = [src_from_ref(Ks[i:i + 1, level], poses[:, i], ref_inv) for i in (1, 2)]
        return torch.stack([r for r, _ in rts], 1), torch.stack([t for _, t in rts], 1)

    shapes = [(H >> i, W >> i) for i in range(5)]
    # cvp coarsest level: 48 planes over 0.2..100 at 1/16
    step = (torch.tensor(100.0, device=device) - 0.2) / torch.tensor(47.0, device=device)
    planes = (0.2 + step * torch.arange(48, dtype=torch.float32, device=device))[None]
    cases["cvp_rt"] = (*feats(24, 80, 16), *rt(4, shapes), planes)
    # cvp finest level: 8 per-pixel hypotheses around a smooth depth map
    base = 5.0 + 20.0 * torch.rand((1, 1, 24, 80), generator=gen, device=device)
    base = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear", align_corners=False)
    levels = torch.arange(-4, 4, dtype=torch.float32, device=device)[None, :, None, None]
    cases["cvp_dense"] = (*feats(H, W, 16), *rt(0, shapes), (base + 0.25 * levels).contiguous())
    return cases


def k2_bound(ref, src, out_dtype, depth):
    """Least time for K2 on these inputs: the output written once, the key
    and source maps and (dense mode) the hypotheses read once, at the HBM
    rate; against (15 + 11 C) flops per (pixel, view) at the f32 rate."""
    import torch

    B, H, W, C = ref.shape
    V = src.shape[1]
    D = depth.shape[1]
    out_elt = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (B * D * H * W * C * out_elt + ref.numel() * ref.element_size() + src.numel() * src.element_size()
              + (depth.numel() * 4 if depth.dim() == 4 else 0))
    flops = B * D * H * W * V * (15 + 11 * C)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def grid_sample_route(ref, src, rot, trans, depth):
    """The yardstick: the same variance with one F.grid_sample per view over
    all planes, then torch ops (no single PyTorch call computes it)."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.homography import sweep_coordinates

    B, H, W, C = ref.shape
    V, Hs, Ws = src.shape[1:4]
    D = depth.shape[1]
    d = depth.reshape(B, D, H * W) if depth.dim() == 4 else depth
    grids = []
    for v in range(V):
        xi, yi = sweep_coordinates(rot[:, v], trans[:, v], d, H, W, Hs, Ws)
        grids.append(torch.stack([(2 * xi + 1) / Ws - 1, (2 * yi + 1) / Hs - 1], -1).reshape(B, D * H, W, 2))
    maps = [src[:, v].permute(0, 3, 1, 2).float() for v in range(V)]  # (B, C, Hs, Ws)
    refv = ref.float().permute(0, 3, 1, 2)[:, :, None]  # (B, C, 1, H, W)

    def run():
        vsum, vsq = refv, refv * refv
        for v in range(V):
            w = F.grid_sample(maps[v], grids[v], mode="bilinear", padding_mode="zeros",
                              align_corners=False).reshape(B, C, D, H, W)
            vsum, vsq = vsum + w, vsq + w * w
        mean = vsum / (V + 1)
        return vsq / (V + 1) - mean * mean  # (B, C, D, H, W)

    return run


def phase_kernel_k2():
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_warp import sweep_variance, sweep_variance_reference

    results = {}
    for case, (ref, src, rot, trans, depth) in k2_cases(torch.device("cuda")).items():
        valid = torch.ones((1, src.shape[1]), device=ref.device)
        out = sweep_variance(ref, src, rot, trans, depth, valid)
        torch.cuda.synchronize()
        plain = sweep_variance_reference(ref, src, rot, trans, depth, valid)
        err = float((out - plain).abs().max())
        if not (err <= K2_LIMIT and torch.isfinite(out).all()):
            raise AssertionError(f"K2 {case} disagrees with its plain version: max_abs_err {err} > {K2_LIMIT}")
        route = grid_sample_route(ref, src, rot, trans, depth)
        route_diff = float((route().permute(0, 2, 3, 4, 1) - out).abs().max())
        del plain
        torch.cuda.empty_cache()
        results[case] = {
            "shape": {"B": ref.shape[0], "V": src.shape[1], "D": depth.shape[1], "H": ref.shape[1],
                      "W": ref.shape[2], "C": ref.shape[3], "dtype": str(ref.dtype).replace("torch.", ""),
                      "hypotheses": "per-pixel" if depth.dim() == 4 else "per-plane"},
            "max_abs_err": err, "limit": K2_LIMIT,
            "ms": time_ms(lambda: sweep_variance(ref, src, rot, trans, depth, valid)),
            "plain_ms": time_ms(lambda: sweep_variance_reference(ref, src, rot, trans, depth, valid), runs=10,
                                warmup=2),
            "grid_sample_route_ms": time_ms(route, runs=10, warmup=2),
            "grid_sample_route_max_abs_diff": route_diff,
            **k2_bound(ref, src, torch.float32, depth),
        }
        results[case]["bound_share"] = results[case]["bound_ms"] / results[case]["ms"]
        torch.cuda.empty_cache()
    emit("kernel", name="sweep_warp", **results)
    main = results["mvsnet_f32"]
    if not main["ms"] < main["grid_sample_route_ms"]:
        raise AssertionError(f"K2 at mvsnet_f32 ({main['ms']} ms) is slower than its grid_sample route "
                             f"({main['grid_sample_route_ms']} ms)")
    return results


K5_LIMIT = 2e-5  # K5 vs its plain version on unit-scale inputs: float32 sums over 27 Cin taps in another order
# K5 at the main paths' shapes at 384x1280, 1+2 views (NCDHW in, Cin -> Cout, bias):
# mvsnet_train's CostRegNet convs with conv3d_impl="banded", vis_mvsnet's
# stage-3 pair regulariser (enc_0, over both pairs) and its dec_2_post
K5_CASES = {
    "mvsnet_conv2": ((1, 16, 128, 48, 160), 16, False),
    "mvsnet_conv4": ((1, 32, 64, 24, 80), 32, False),
    "mvsnet_conv6": ((1, 64, 32, 12, 40), 64, False),
    "mvsnet_prob": ((1, 8, 256, 96, 320), 1, True),
    "vis_stage3_reg": ((2, 8, 16, 192, 640), 8, False),
    "vis_stage3_dec_2_post": ((2, 16, 16, 192, 640), 8, False),
}
# the shapes where K5 on the CUDA cores alone was slower than cuDNN fp32 (1.7x, 2.6x)
K5_MUST_BEAT_LIBRARY = ("mvsnet_conv4", "mvsnet_conv6")


def k5_bound(x, cout, bias):
    """Least time for K5: input, weights and output moved once at the HBM
    rate, against 54 Cin Cout flops per output voxel (+ the bias add) at the
    rate of the arithmetic that gives a float32-accurate result on the path
    the kernel takes for Cout (``conv3d_banded_path``): the f32 rate on the
    CUDA cores (``ops_f32_ms``, also reported for the tensor-core path, as
    the bound of earlier rows), 3 TF32 products per f32 product at the TF32
    rate on the tensor cores (``ops_tc_ms``)."""
    from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded_path

    B, cin, D, H, W = x.shape
    voxels = B * D * H * W
    nbytes = 4 * (x.numel() + 27 * cin * cout + voxels * cout + (cout if bias else 0))
    flops = voxels * cout * (54 * cin + (1 if bias else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_f32_ms = flops / F32_FLOPS_PER_S * 1e3
    ops_tc_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    path = conv3d_banded_path(cout)
    ops_ms = ops_tc_ms if path == "tf32x3_mma" else ops_f32_ms
    return {"path": path, "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_f32_ms": ops_f32_ms,
            "ops_tc_ms": ops_tc_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel_k5():
    """K5 on NCDHW volumes (the family's layout) against its plain version
    (27 shifted NDHWC channel contractions); yardstick ``F.conv3d`` (cuDNN)
    with TF32 off and, as a second figure, on. Fails if K5 is slower than
    ``F.conv3d`` fp32 at the two shapes where the CUDA-core kernel lost
    (``K5_MUST_BEAT_LIBRARY``), after printing the times."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.conv3d import conv3d_banded, conv3d_banded_reference

    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    for case, (shape, cout, with_bias) in K5_CASES.items():
        cin = shape[1]
        x = torch.randn(shape, generator=gen, device="cuda")
        # an nn.Conv3d weight seen as DHWIO, as ops/conv3d.py passes it
        weight = torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda") / (27 * cin) ** 0.5
        k = weight.permute(2, 3, 4, 1, 0)
        bias = torch.randn((cout,), generator=gen, device="cuda") if with_bias else None
        set_tf32(False)
        out = conv3d_banded(x, k, bias, channels_first=True)
        torch.cuda.synchronize()
        plain = conv3d_banded_reference(x.movedim(1, -1), k, bias).movedim(-1, 1)
        err = float((out - plain).abs().max())
        if not (err <= K5_LIMIT and torch.isfinite(out).all()):
            raise AssertionError(f"K5 {case} disagrees with its plain version: max_abs_err {err} > {K5_LIMIT}")
        del plain

        def library():
            return F.conv3d(x, weight, bias, padding=1)

        lib_diff = float((library() - out).abs().max())
        lib_ms = time_ms(library)
        set_tf32(True)
        lib_tf32_ms = time_ms(library)
        set_tf32(False)
        results[case] = {
            "shape": list(shape), "cout": cout, "bias": with_bias, "max_abs_err": err, "limit": K5_LIMIT,
            "ms": time_ms(lambda: conv3d_banded(x, k, bias, channels_first=True)),
            "plain_ms": time_ms(lambda: conv3d_banded_reference(x.movedim(1, -1), k, bias), runs=10, warmup=2),
            "library_ms": lib_ms, "library_tf32_ms": lib_tf32_ms, "library_max_abs_diff": lib_diff,
            **k5_bound(x, cout, with_bias),
        }
        torch.cuda.empty_cache()
    emit("kernel", name="conv3d_banded", layout="NCDHW", **results)
    slower = {case: (results[case]["ms"], results[case]["library_ms"]) for case in K5_MUST_BEAT_LIBRARY
              if results[case]["ms"] >= results[case]["library_ms"]}
    if slower:
        raise AssertionError(f"K5 slower than F.conv3d fp32 (ms, library ms): {slower}")
    return results


def k4_inputs(device):
    """K4's arguments on mvsnet_train's warp_impl="xla" route at 384x1280:
    a source feature map (1, 96, 320, 32), its 1/4 projection, the key's
    inverse and 256 planes over 0.2..100, from a sideways KITTI-like rig."""
    import torch

    from robustmvd_tpu_torch.models.mvsnet import projection_matrices, unit_steps

    sample = sideways_sample(np.random.RandomState(3), 384, 1280, 2)
    K = torch.tensor(np.stack(sample["intrinsics"], 1), device=device)
    poses = torch.tensor(np.stack(sample["poses"], 1), device=device)
    proj = projection_matrices(K, poses)
    gen = torch.Generator(device=device).manual_seed(5)
    src = torch.randn((1, 96, 320, 32), generator=gen, device=device)
    depth = (0.2 + unit_steps(256, device) * (100.0 - 0.2))[None]
    return src, proj[:, 1].contiguous(), torch.linalg.inv(proj[:, 0]), depth


def k4_bound(src, depth):
    """Least time for K4: the float32 volume written once, the map and the
    depths read once, at the HBM rate; against (15 + 7 C) flops per pixel."""
    B, H, W, C = src.shape
    D = depth.shape[1]
    nbytes = B * D * H * W * C * 4 + src.numel() * src.element_size() + depth.numel() * 4
    flops = B * D * H * W * (15 + 7 * C)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel_k4():
    """K4 with float32 and bf16 features against its plain version; the
    yardstick is one ``F.grid_sample`` (zeros padding, align_corners=False)
    at the same coordinates, from an NCHW map into an NCHW volume. Fails if
    K4 with f32 features is slower than it, after printing the times."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.homography import plane_sweep_transform, sweep_coordinates
    from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume, homo_warp_volume_reference

    src32, proj, inv, depth = k4_inputs(torch.device("cuda"))
    B, H, W, C = src32.shape
    D = depth.shape[1]
    results = {}
    for mode, src, limit in (("f32", src32, 1e-6), ("bf16", src32.bfloat16(), 1e-5)):
        out = homo_warp_volume(src, proj, inv, depth)
        torch.cuda.synchronize()
        plain = homo_warp_volume_reference(src, proj, inv, depth)
        err = float((out - plain).abs().max())
        on_map = float((out != 0).any(-1).float().mean())
        if not (err <= limit and torch.isfinite(out).all() and on_map > 0.5):
            raise AssertionError(f"K4 {mode} disagrees with its plain version: max_abs_err {err} > {limit}, "
                                 f"on-map share {on_map}")
        del plain, out
        torch.cuda.empty_cache()
        results[mode] = {
            "shape": {"B": B, "D": D, "H": H, "W": W, "C": C}, "max_abs_err": err, "limit": limit,
            "on_map_share": on_map, "ms": time_ms(lambda: homo_warp_volume(src, proj, inv, depth)),
            "plain_ms": time_ms(lambda: homo_warp_volume_reference(src, proj, inv, depth), runs=5, warmup=1),
            **k4_bound(src, depth),
        }
        torch.cuda.empty_cache()
    rot, trans = plane_sweep_transform(proj, inv)
    xi, yi = sweep_coordinates(rot, trans, depth, H, W, H, W)
    grid = torch.stack([(2 * xi + 1) / W - 1, (2 * yi + 1) / H - 1], -1).reshape(B, D * H, W, 2)
    src_c = src32.permute(0, 3, 1, 2).contiguous()  # (B, C, H, W)

    def library():
        return F.grid_sample(src_c, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    diff = (library().reshape(B, C, D, H, W).permute(0, 2, 3, 4, 1) - homo_warp_volume(src32, proj, inv, depth))
    results["f32"]["library_max_abs_diff"] = float(diff.abs().max())
    del diff
    torch.cuda.empty_cache()
    results["f32"]["library_ms"] = time_ms(library, runs=10, warmup=2)
    results["bf16"]["library_ms"] = None  # grid_sample would round the grid to bf16 too
    emit("kernel", name="warp_volume", **results)
    torch.cuda.empty_cache()
    if not results["f32"]["ms"] < results["f32"]["library_ms"]:
        raise AssertionError(f"K4 f32 {results['f32']['ms']} ms is slower than F.grid_sample f32 "
                             f"{results['f32']['library_ms']} ms")
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


# The family's main paths at 384x1280, 1+2 views: label -> (model, create_model
# arguments, launches per frame of each kernel that must run; cvp at nscale 5)
FAMILY = {
    "mvsnet_train": ("mvsnet_train", {}, {"sweep_warp": 1}),
    "cvp_mvsnet": ("cvp_mvsnet", {}, {"sweep_warp": 5}),
    "mvsnet_train_banded_xla": ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"},
                                {"warp_volume": 2, "conv3d_banded": 4, "sweep_warp": 0}),
}
# the card-vs-CPU configurations: the defaults and K4's and K5's paths
FAMILY_PARITY = {label: FAMILY[label][:2] for label in FAMILY}
FAMILY_PARITY["cvp_mvsnet_banded"] = ("cvp_mvsnet", {"conv3d_impl": "banded"})


def phase_family_parity(counters):
    """The family on the card vs on the CPU, TF32 off, with cuDNN's
    deterministic algorithms: cvp's finer levels magnify rounding, and the
    default algorithms' run-to-run spread alone moved its uncertainty's max
    error between 0.039 and 0.050 on one card."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    sample = sideways_sample(np.random.RandomState(4), 128, 160, 3)
    sample["depth_range"] = (np.array([1.0], np.float32), np.array([50.0], np.float32))
    report = {}
    for label, (name, kwargs) in FAMILY_PARITY.items():
        outs = {}
        for device in ("cpu", "cuda"):
            model = rmvd.create_model(name, device=device, seed=0, **kwargs)
            counters.reset()
            outs[device] = model.run(**sample)
            del model
        launches = {k: v for k, v in counters.read().items() if v}  # the card's run
        (pc, ac), (pg, ag) = outs["cpu"], outs["cuda"]
        c = pc["depth"]
        if not (np.isfinite(c).all() and c.std() > 1e-3 * np.abs(c).mean()):
            raise AssertionError(f"{label} parity run: depth not finite or flat (std {c.std()}): vacuous check")
        checks = {"depth": (pg["depth"], c, MODEL_BOUNDS)}
        if name == "cvp_mvsnet":
            checks = {"depth_coarsest": (ag["depths_all"][-1], ac["depths_all"][-1], MODEL_BOUNDS),
                      "depth": (pg["depth"], c, CVP_FINE_BOUNDS),
                      "depth_uncertainty": (pg["depth_uncertainty"], pc["depth_uncertainty"], CVP_FINE_BOUNDS)}
        errors = {}
        for key, (g, ref, bounds) in checks.items():
            mean, mx = relative_errors(g, ref)
            errors[key] = [mean, mx]
            if not (mean <= bounds[0] and mx <= bounds[1]):
                raise AssertionError(f"card vs CPU {label} {key}: mean {mean}, max {mx} > {bounds}")
        uc, ug = pc["depth_uncertainty"], pg["depth_uncertainty"]
        flipped = float((np.abs(ug - uc) > 1e-4 * np.abs(uc).mean()).mean())
        if name == "mvsnet_train" and not flipped <= FLIPPED_SHARE:
            raise AssertionError(f"card vs CPU {label} uncertainty: {flipped} of the pixels differ > {FLIPPED_SHARE}")
        impl = kwargs.get("conv3d_impl")
        if (impl == "banded") != bool(launches.get("conv3d_banded")) or (
                kwargs.get("warp_impl") == "xla") != bool(launches.get("warp_volume")):
            raise AssertionError(f"{label} on the card launched {launches}")
        report[label] = {"kwargs": kwargs, "shape": list(c.shape), "rel_err": errors,
                         "uncertainty_flipped_share": flipped, "launches": launches,
                         "depth_std_over_mean": float(c.std() / np.abs(c).mean())}
    torch.backends.cudnn.deterministic = False
    emit("parity_family", tf32=tf32, cudnn_deterministic=True, input_shape=[128, 160], views=3,
         bounds=MODEL_BOUNDS, cvp_fine_bounds=CVP_FINE_BOUNDS, flipped_limit=FLIPPED_SHARE, **report)
    torch.cuda.empty_cache()


def timed_frames(model, sample, counters, warmup=3, frames=20):
    """Warm-up and timed ``model.run`` frames with the launch counts reset
    just before and read just after; returns (last pred, stats)."""
    import torch

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
    return pred, {"ms_per_frame": statistics.median(times), "ms_per_frame_mean": statistics.mean(times),
                  "ms_per_frame_min": min(times), "frames": frames, "warmup": warmup,
                  "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "launches": launches,
                  "launches_per_frame": {k: v / (warmup + frames) for k, v in launches.items()}}


def phase_family_main(counters):
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.inference import main as inference_main

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        counters.reset()
        inference_main(["--model", "mvsnet_train", "--input_path", os.path.join(root, "sample_data"),
                        "--output_path", out])
        cli_launches = counters.read()
        depth = np.load(os.path.join(out, "depth.npy"))
        if depth.shape != (256, 320) or not np.isfinite(depth).all():
            raise AssertionError(f"mvsnet CLI depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        if cli_launches["sweep_warp"] != 1:
            raise AssertionError(f"mvsnet CLI launched K2 {cli_launches} times, expected 1")
    emit("main_cli_family", model="mvsnet_train", input="sample_data", shape=[256, 320], views=4,
         launches=cli_launches)

    sample = sideways_sample(np.random.RandomState(5), 384, 1280, 3)
    runs = {}
    for path, (name, kwargs, per_frame) in FAMILY.items():
        model = rmvd.create_model(name, **kwargs)
        runs[path] = {}
        for label, tf32_on in (("fp32", False), ("tf32_convs", True)):
            tf32 = set_tf32(False)
            if tf32_on:  # PyTorch's default: TF32 for cuDNN convolutions only
                torch.backends.cudnn.allow_tf32 = True
                tf32 = {**tf32, "cudnn.allow_tf32": True}
            pred, stats = timed_frames(model, sample, counters)
            check_launches(path, stats, per_frame)
            depth = pred["depth"]
            expected = (1, 1, 96, 320) if name == "mvsnet_train" else (1, 1, 384, 1280)
            if depth.shape != expected or not np.isfinite(depth).all():
                raise AssertionError(f"{path} depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
            runs[path][label] = {"tf32": tf32, **stats}
        set_tf32(False)
        emit("main_family", model=name, path=path, kwargs=kwargs, shape=[384, 1280], views=3, dtype="float32",
             **runs[path])
        emit("breakdown_family", model=name, path=path, **device_breakdown(model, sample, frames=5))
        del model
        torch.cuda.empty_cache()
    return runs


def check_launches(path, stats, per_frame):
    """Each listed kernel launched exactly its count per frame in the run."""
    frames = stats["warmup"] + stats["frames"]
    for name, n in per_frame.items():
        if stats["launches"][name] != n * frames:
            raise AssertionError(f"{path}: {name} launched {stats['launches']} times in {frames} frames, "
                                 f"expected {n} per frame")


# per frame at 1+2 views, by conv3d_impl: K5 ten times per stage at the default
VIS_LAUNCHES = {"banded": {"sweep_group_cost": 6, "soft_argmin": 6, "conv3d_banded": 30},
                "xla": {"sweep_group_cost": 6, "soft_argmin": 6, "conv3d_banded": 0}}


def k2_group_cases(device):
    """K2 group mode's arguments at vis_mvsnet's stage shapes (B=1, C=32),
    from a sideways KITTI-like rig at 384x1280: the key and the first source
    cam scaled to the stage, per-pixel w = 1 / (depth + 1e-9) around a
    smooth depth map, as stages 2 and 3 get it: {stage: (ref, src, A, B, w)}."""
    import torch

    from robustmvd_tpu_torch.models.blocks.vis_mvsnet import PIXEL_CENTRES, scale_camera
    from robustmvd_tpu_torch.models.vis_mvsnet import DEPTH_NUMS, FEATURE_STRIDES, INTERVAL_SCALES
    from robustmvd_tpu_torch.ops.homography import get_homography_coeffs, matmul_sums

    H, W = 384, 1280
    sample = sideways_sample(np.random.RandomState(6), H, W, 2)
    cams = torch.zeros((2, 2, 4, 4), device=device)
    cams[:, 0] = torch.tensor(np.concatenate(sample["poses"]), device=device)
    cams[:, 1, :3, :3] = torch.tensor(np.concatenate(sample["intrinsics"]), device=device)
    centres = torch.tensor(PIXEL_CENTRES, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    base = 5.0 + 20.0 * torch.rand((1, 1, 24, 80), generator=gen, device=device)
    cases = {}
    for stage, (D, stride, scale) in enumerate(zip(DEPTH_NUMS, FEATURE_STRIDES, INTERVAL_SCALES), 1):
        h, w = H // stride, W // stride
        A, Bm = get_homography_coeffs(scale_camera(cams[0:1], 1 / stride), scale_camera(cams[1:2], 1 / stride))
        start = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
        interval = (100.0 - 0.2) / 192 * scale
        depth = start - D * interval / 2 + interval * torch.arange(D, device=device).reshape(1, D, 1, 1)
        cases[f"stage{stage}"] = (
            torch.randn((1, h, w, 32), generator=gen, device=device),
            torch.randn((1, h, w, 32), generator=gen, device=device),
            matmul_sums(A, centres).contiguous(), matmul_sums(Bm, centres).contiguous(),
            (1.0 / (depth.clamp_min(0.2) + 1e-9)).contiguous())
    return cases


def k2_group_bound(ref, src, w, G):
    """Least time for K2 group on these inputs: the output, the key and
    source maps and the per-pixel w each moved once, at the HBM rate;
    against (45 + 9 C) flops per pixel at the f32 rate."""
    B, D, H, W = w.shape
    C = ref.shape[3]
    nbytes = B * D * H * W * G * 4 + (ref.numel() + src.numel() + w.numel()) * 4
    flops = B * D * H * W * (45 + 9 * C)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def group_grid_sample_route(ref, src, A, Bm, w, G):
    """The yardstick: one F.grid_sample over all D planes at the kernel's
    coordinates, then the product with the key and the group sums (no
    single PyTorch call computes it)."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import homography_coordinates

    B, H, W, C = ref.shape
    D = w.shape[1]
    Hs, Ws = src.shape[1:3]
    xi, yi = homography_coordinates(A, Bm, w)
    grid = torch.stack([(2 * xi + 1) / Ws - 1, (2 * yi + 1) / Hs - 1], -1).reshape(B, D * H, W, 2)
    src_c = src.permute(0, 3, 1, 2).contiguous()
    ref_c = ref.permute(0, 3, 1, 2)[:, :, None]  # (B, C, 1, H, W)

    def run():
        warped = F.grid_sample(src_c, grid, mode="bilinear", padding_mode="zeros",
                               align_corners=False).reshape(B, C, D, H, W)
        return (warped * ref_c).reshape(B, G, C // G, D, H, W).sum(2)  # (B, G, D, H, W)

    return run


def phase_kernel_k2_group():
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import (
        homography_group_cost,
        homography_group_cost_reference,
    )

    results = {}
    for case, (ref, src, A, Bm, w) in k2_group_cases(torch.device("cuda")).items():
        out = homography_group_cost(ref, src, A, Bm, w)
        torch.cuda.synchronize()
        plain = homography_group_cost_reference(ref, src, A, Bm, w)
        err = float((out - plain).abs().max())
        if not (err <= K2_LIMIT and torch.isfinite(out).all()):
            raise AssertionError(f"K2 group {case} disagrees with its plain version: max_abs_err {err} > {K2_LIMIT}")
        on_map = float((out != 0).any(-1).float().mean())
        if not on_map > 0.5:
            raise AssertionError(f"K2 group {case}: only {on_map} of the samples land on the map: vacuous check")
        route = group_grid_sample_route(ref, src, A, Bm, w, 8)
        route_diff = float((route().permute(0, 2, 3, 4, 1) - out).abs().max())
        del plain
        torch.cuda.empty_cache()
        results[case] = {
            "shape": {"B": 1, "D": w.shape[1], "H": ref.shape[1], "W": ref.shape[2], "C": ref.shape[3], "G": 8,
                      "w": "per-pixel"},
            "max_abs_err": err, "limit": K2_LIMIT, "on_map_share": on_map,
            "ms": time_ms(lambda: homography_group_cost(ref, src, A, Bm, w)),
            "plain_ms": time_ms(lambda: homography_group_cost_reference(ref, src, A, Bm, w), runs=10, warmup=2),
            "grid_sample_route_ms": time_ms(route, runs=10, warmup=2),
            "grid_sample_route_max_abs_diff": route_diff,
            **k2_group_bound(ref, src, w, 8),
        }
        results[case]["bound_share"] = results[case]["bound_ms"] / results[case]["ms"]
        torch.cuda.empty_cache()
    emit("kernel", name="sweep_group_cost", **results)
    main = results["stage3"]
    if not main["ms"] < main["grid_sample_route_ms"]:
        raise AssertionError(f"K2 group at stage3 ({main['ms']} ms) is slower than its grid_sample route "
                             f"({main['grid_sample_route_ms']} ms)")
    return results


def k3_bound(volume):
    """Least time for K3: the volume read once, the probability volume and
    three maps written once, at the HBM rate; against ~20 flops per element
    (exp, log and division counted as one each) at the f32 rate."""
    B, D, H, W = volume.shape
    nbytes = 2 * volume.numel() * 4 + 3 * B * H * W * 4
    flops = 20 * volume.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel_k3():
    """K3 at vis_mvsnet's readout shapes at 384x1280 with 1+2 views: the
    pair readout (2, D, h, w) and the fused one (1, D, h, w) of each stage.
    prob, expectation and entropy are held at K3_LIMITS; the window mass
    may differ on FLIPPED_SHARE of the pixels (the mask flips at ties).
    Fails if K3 is slower than ``torch.softmax`` alone at the stage-3 pair
    readout, after printing the times."""
    import torch

    from robustmvd_tpu_torch.models.vis_mvsnet import DEPTH_NUMS, FEATURE_STRIDES
    from robustmvd_tpu_torch.ops.kernels.soft_argmin import (
        fused_soft_argmin,
        fused_soft_argmin_reference,
        soft_argmin_route,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for stage, (D, stride) in enumerate(zip(DEPTH_NUMS, FEATURE_STRIDES), 1):
        for readout, B in (("pair", 2), ("fused", 1)):
            vol = torch.randn((B, D, 384 // stride, 1280 // stride), generator=gen, device="cuda") * 3
            out = fused_soft_argmin(vol, window=2)
            torch.cuda.synchronize()
            plain = fused_soft_argmin_reference(vol, window=2)
            errs = {name: float((a - b).abs().max()) for name, a, b in
                    zip(("prob", "expectation", "entropy", "prob_map"), out, plain)}
            flipped = float(((out[3] - plain[3]).abs() > 1e-5).float().mean())
            limits = {"prob": K3_LIMITS[0], "expectation": K3_LIMITS[1] + 1e-6 * D, "entropy": K3_LIMITS[2]}
            if not (all(errs[k] <= v for k, v in limits.items()) and flipped <= FLIPPED_SHARE):
                raise AssertionError(f"K3 stage {stage} {readout} disagrees with its plain version: {errs}, "
                                     f"mask flipped on {flipped} of the pixels")
            results[f"stage{stage}_{readout}"] = {
                "shape": list(vol.shape), "path": soft_argmin_route(D),
                "max_abs_err": max(errs[k] for k in limits), "errors": errs,
                "limits": limits, "prob_map_flipped_share": flipped,
                "ms": time_ms(lambda: fused_soft_argmin(vol, window=2)),
                "plain_ms": time_ms(lambda: fused_soft_argmin_reference(vol, window=2), runs=10, warmup=2),
                "library_ms": time_ms(lambda: torch.softmax(vol, dim=1)),  # torch.softmax alone over D
                **k3_bound(vol),
            }
    emit("kernel", name="soft_argmin", **results)
    pair = results["stage3_pair"]
    if not pair["ms"] < pair["library_ms"]:
        raise AssertionError(f"K3 at the stage-3 pair {pair['ms']} ms is slower than torch.softmax "
                             f"{pair['library_ms']} ms")
    return results


def phase_vis_parity(counters):
    """vis_mvsnet on the card vs on the CPU, TF32 off, cuDNN deterministic,
    with each lowering of its 3D convolutions: the default (K5) and cuDNN's."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    sample = sideways_sample(np.random.RandomState(7), 128, 192, 3)
    sample["depth_range"] = (np.array([1.0], np.float32), np.array([50.0], np.float32))
    report = {}
    for impl, per_frame in VIS_LAUNCHES.items():
        outs = {}
        for device in ("cpu", "cuda"):
            model = rmvd.create_model("vis_mvsnet", device=device, seed=0, conv3d_impl=impl)
            counters.reset()
            outs[device] = model.run(**sample)
            del model
        launches = {k: v for k, v in counters.read().items() if v}  # the card's run
        expected = {k: v for k, v in per_frame.items() if v}
        if launches != expected:
            raise AssertionError(f"vis_mvsnet conv3d_impl={impl} parity run on the card launched {launches}, "
                                 f"expected {expected}")
        (pc, _), (pg, _) = outs["cpu"], outs["cuda"]
        c = pc["depth"]
        if not (np.isfinite(c).all() and c.std() > 1e-3 * np.abs(c).mean()):
            raise AssertionError(f"vis_mvsnet parity run: depth not finite or flat (std {c.std()}): vacuous check")
        mean, mx = relative_errors(pg["depth"], c)
        if not (mean <= MODEL_BOUNDS[0] and mx <= MODEL_BOUNDS[1]):
            raise AssertionError(f"card vs CPU vis_mvsnet conv3d_impl={impl} depth: mean {mean}, max {mx} > "
                                 f"{MODEL_BOUNDS}")
        diff = np.abs(pg["depth_uncertainty"] - pc["depth_uncertainty"])
        unc = {"mean_abs_diff": float(diff.mean()), "share_over_1e-3": float((diff > 1e-3).mean())}
        if not (unc["mean_abs_diff"] <= 1e-4 and unc["share_over_1e-3"] <= FLIPPED_SHARE):
            raise AssertionError(f"card vs CPU vis_mvsnet conv3d_impl={impl} uncertainty: {unc}")
        report[impl] = {"shape": list(c.shape), "depth_rel_err": [mean, mx], "uncertainty": unc,
                        "launches": launches, "depth_std_over_mean": float(c.std() / np.abs(c).mean())}
    torch.backends.cudnn.deterministic = False
    emit("parity_vis", tf32=tf32, cudnn_deterministic=True, input_shape=[128, 192], views=3, bounds=MODEL_BOUNDS,
         flipped_limit=FLIPPED_SHARE, **report)
    torch.cuda.empty_cache()


def phase_vis_main(counters):
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.inference import main as inference_main

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        counters.reset()
        inference_main(["--model", "vis_mvsnet", "--input_path", os.path.join(root, "sample_data"),
                        "--output_path", out])
        cli_launches = counters.read()
        depth = np.load(os.path.join(out, "depth.npy"))
        if depth.shape != (256, 320) or not np.isfinite(depth).all():
            raise AssertionError(f"vis CLI depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        if (cli_launches["sweep_group_cost"], cli_launches["soft_argmin"], cli_launches["conv3d_banded"]) != (9, 6, 30):
            raise AssertionError(f"vis CLI with 3 source views launched {cli_launches}, expected 9 K2 group, 6 K3, "
                                 "30 K5")
    emit("main_cli_vis", model="vis_mvsnet", input="sample_data", shape=[256, 320], views=4, launches=cli_launches)

    sample = sideways_sample(np.random.RandomState(8), 384, 1280, 3)
    runs = {}
    for impl, per_frame in VIS_LAUNCHES.items():  # the default (K5), then cuDNN's 3D convolutions
        model = rmvd.create_model("vis_mvsnet", conv3d_impl=impl)
        runs[impl] = {}
        for label, tf32_on in (("fp32", False), ("tf32_convs", True)):
            tf32 = set_tf32(False)
            if tf32_on:  # PyTorch's default: TF32 for cuDNN convolutions only
                torch.backends.cudnn.allow_tf32 = True
                tf32 = {**tf32, "cudnn.allow_tf32": True}
            pred, stats = timed_frames(model, sample, counters)
            check_launches(f"vis_mvsnet conv3d_impl={impl}", stats, per_frame)
            depth = pred["depth"]
            if depth.shape != (1, 1, 192, 640) or not np.isfinite(depth).all():
                raise AssertionError(f"vis_mvsnet depth: shape {depth.shape}, finite {np.isfinite(depth).all()}")
            runs[impl][label] = {"tf32": tf32, **stats}
        set_tf32(False)
        emit("main_vis", model="vis_mvsnet", conv3d_impl=impl, shape=[384, 1280], views=3, dtype="float32",
             **runs[impl])
        emit("breakdown_vis", model="vis_mvsnet", conv3d_impl=impl, **device_breakdown(model, sample, frames=5))
        del model
        torch.cuda.empty_cache()
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


def compare_eval_tables(ours, ref, curves_ours, curves_ref):
    """Card vs CPU evaluation results: the view counts and densities equal,
    the 1.03-inlier ratios within INLIER_FLIP_SHARE of the pixels, the other
    metrics (absrel, AUSE) and the per-sample sparsification curves within
    MODEL_BOUNDS. Returns the errors; raises on a miss."""
    errors = {}
    if list(ours.columns) != list(ref.columns):
        raise AssertionError(f"evaluation columns differ: {list(ours.columns)} vs {list(ref.columns)}")
    for column in ours.columns:
        if column[1] in EVAL_TIMING:
            continue
        a, b = ours[column].to_numpy(np.float64), ref[column].to_numpy(np.float64)
        name = f"{column[0]}/{column[1]}"
        if column[1] in ("num_views", "pred_depth_density"):
            errors[name] = float(np.abs(a - b).max())
            ok = np.array_equal(a, b)
        elif column[1] == "inliers103":  # percent
            errors[name] = float(np.abs(a - b).max() / 100)
            ok = errors[name] <= INLIER_FLIP_SHARE
        else:
            errors[name] = relative_errors(a, b)
            ok = errors[name][0] <= MODEL_BOUNDS[0] and errors[name][1] <= MODEL_BOUNDS[1]
        if not ok:
            raise AssertionError(f"evaluation card vs CPU, {name}: {errors[name]} ({a} vs {b})")
    for curve in ("pred", "oracle"):
        a, b = (c.xs(curve, level="curve").to_numpy(np.float64) for c in (curves_ours, curves_ref))
        errors[f"curve_{curve}"] = relative_errors(a, b)
        if not (errors[f"curve_{curve}"][0] <= MODEL_BOUNDS[0] and errors[f"curve_{curve}"][1] <= MODEL_BOUNDS[1]):
            raise AssertionError(f"evaluation card vs CPU, {curve} sparsification curve: {errors[f'curve_{curve}']}")
    return errors


def phase_eval_parity(counters):
    """create_evaluation("mvd") with robust_mvd (seeded weights) on the card
    and on the CPU, over the same synthetic samples."""
    import pandas as pd
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    config = dict(num_views=5, height=128, width=256, num_samples=2)
    tables, curves, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cpu", "cuda"):
            evaluation = rmvd.create_evaluation("mvd", out_dir=os.path.join(tmp, device), inputs=["poses", "intrinsics"],
                                                view_ordering="nearest", eval_uncertainty=True, verbose=False)
            model = rmvd.create_model("robust_mvd", device=device, seed=0)
            counters.reset()
            tables[device] = evaluation(dataset=rmvd.create_dataset("synthetic.train.mvd", **config), model=model,
                                        qualitatives=0, burn_in_samples=1)
            launches[device] = counters.read()["planesweep_sample"]
            curves[device] = pd.read_pickle(os.path.join(tmp, device, "per_sample", "sparsification_curves.pickle"))
            del model
    torch.backends.cudnn.deterministic = False
    # nearest ordering sweeps 1..4 source views: 10 launches of K1 per sample on the card, none on the CPU
    if launches != {"cpu": 0, "cuda": 10 * config["num_samples"]}:
        raise AssertionError(f"evaluation K1 launches {launches}, expected 0 on the CPU and 20 on the card")
    errors = compare_eval_tables(tables["cuda"], tables["cpu"], curves["cuda"], curves["cpu"])
    best = tables["cuda"]["best"]
    emit("eval_parity", tf32=tf32, **config, view_ordering="nearest", bounds=MODEL_BOUNDS,
         inlier_flip_share=INLIER_FLIP_SHARE, k1_launches=launches, errors=errors,
         best_absrel=best["absrel"].tolist(), best_num_views=best["num_views"].tolist(),
         best_ause=best["ause"].tolist(), best_inliers103=best["inliers103"].tolist())
    torch.cuda.empty_cache()


class TimedDataset:
    """A dataset that notes the host clock when the engine loads each sample."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.starts = []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        self.starts.append(time.perf_counter())
        return self.dataset[index]


def phase_eval_run(counters, label, num_views, keyview_idx, height, width, num_samples, cut):
    """create_evaluation("mvd") with robust_mvd (full width, fp32, seeded
    weights) over ``synthetic`` at a benchmark dataset's view count and image
    size, quasi-optimal ordering, uncertainty on, the first sample a burn-in
    sample. Each of the engine's model runs is noted with its runtimes and
    memory; K1's launches are counted over the whole evaluation."""
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.utils import numpy_collate

    tf32 = set_tf32(False)
    dataset = TimedDataset(rmvd.create_dataset("synthetic.train.mvd", num_samples=num_samples, num_views=num_views,
                                               keyview_idx=keyview_idx, height=height, width=width))
    model = rmvd.create_model("robust_mvd", seed=0)
    evaluation = rmvd.create_evaluation("mvd", inputs=["poses", "intrinsics"], view_ordering="quasi-optimal",
                                        eval_uncertainty=True, verbose=False)
    runs = []
    run_model = evaluation._run_model

    def noted_run(sample_inputs):
        pred, runtimes, memory = run_model(sample_inputs)
        runs.append((evaluation.cur_sample_num, runtimes["runtime_model_in_msec"],
                     runtimes["runtime_model_and_io_in_msec"], memory["device_mem_peak_in_mib"]))
        return pred, runtimes, memory

    evaluation._run_model = noted_run
    counters.reset()
    results = evaluation(dataset=dataset, model=model, qualitatives=0, burn_in_samples=1)
    end = time.perf_counter()
    k1 = counters.read()["planesweep_sample"]
    # the forward with every view (the sweep's last run), alone: its peak and where its time goes
    sample = numpy_collate([dataset.dataset[0]])
    frame = {k: sample[k] for k in ("images", "keyview_idx", "poses", "intrinsics")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.run(**frame)
    all_views = {"peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                 **device_breakdown(model, frame, frames=2)}
    del model
    torch.cuda.empty_cache()

    sources = num_views - 1
    runs_per_sample = sources + sources  # quasi-optimal pairs, then the sweep over 1..V-1 source views
    k1_per_sample = sources + sources * (sources + 1) // 2
    per_sample = [[r for r in runs if r[0] == n] for n in range(num_samples)]
    starts = dataset.starts + [end]
    walls = [b - a for a, b in zip(starts, starts[1:])]
    if [len(r) for r in per_sample] != [runs_per_sample] * num_samples:
        raise AssertionError(f"{label}: model runs per sample {[len(r) for r in per_sample]}, "
                             f"expected {runs_per_sample}")
    if k1 != k1_per_sample * num_samples:
        raise AssertionError(f"{label}: K1 launched {k1} times in {num_samples} samples, "
                             f"expected {k1_per_sample} per sample")
    timed = [r for r in runs if r[0] >= 1]
    # host time outside the forward: inside the run (adapters, copies) and outside the runs (data, metrics)
    adapters_share = [sum(r[2] - r[1] for r in per_sample[n]) / 1e3 / walls[n] for n in range(1, num_samples)]
    if not all(np.isfinite(r[1]) and np.isfinite(r[2]) and r[3] > 0 for r in timed):
        raise AssertionError(f"{label}: a timed run has no runtime or memory figure: {timed}")
    if not all(np.isnan(r[1]) for r in per_sample[0]):
        raise AssertionError(f"{label}: the burn-in sample's runs were timed")
    absrel = results["best"]["absrel"].to_numpy(np.float64)
    if not np.isfinite(absrel).all():
        raise AssertionError(f"{label}: absrel {absrel}")
    host_share = [1 - sum(r[1] for r in per_sample[n]) / 1e3 / walls[n] for n in range(1, num_samples)]
    sweep_ms = {n: float(results[n]["runtime_model_in_msec"].iloc[1:].median()) for n in (1, sources // 2, sources)}
    emit(label, tf32=tf32, views=num_views, keyview_idx=keyview_idx, size=[height, width],
         model_input=[-(-height // 64) * 64, -(-width // 64) * 64], samples=num_samples, burn_in_samples=1, cut=cut,
         model_runs_per_sample=runs_per_sample, k1_launches_per_sample=k1 / num_samples,
         runtime_model_ms_median=statistics.median(r[1] for r in timed),
         runtime_model_and_io_ms_median=statistics.median(r[2] for r in timed),
         runtime_model_ms_by_source_views=sweep_ms,
         wall_s_per_sample=walls, wall_s_per_timed_sample_median=statistics.median(walls[1:]),
         host_share=host_share, host_share_in_adapters=adapters_share,
         device_mem_peak_mib=max(r[3] for r in timed), all_views_forward=all_views,
         best_absrel=absrel.tolist(), best_num_views=results["best"]["num_views"].tolist())
    return {"k1_launches": k1, "k1_launches_per_sample": k1 / num_samples}


def kernel_kind(name):
    """Group profiler rows: convolutions (cuDNN, 2D and 3D, direct, implicit
    GEMM and FFT), GEMMs outside cuDNN (robust_mvd's score matmul; the
    family's bicubic resize), K1, K2,
    K2's group mode, K3, K4, K5, copies, and the rest (elementwise, cat, gather,
    softmax)."""
    if "planesweep_sample" in name:
        return "k1_planesweep_sample"
    if "warp_volume_kernel" in name:
        return "k4_warp_volume"
    if "conv3d_k3_kernel" in name:
        return "k5_conv3d_banded"
    if "sweep_warp" in name:
        return "k2_sweep_warp"
    if "homography_group_cost" in name:
        return "k2_group_cost"
    if "soft_argmin_" in name:
        return "k3_soft_argmin"
    if "HtoD" in name or "DtoH" in name:
        return "memcpy_" + ("h2d" if "HtoD" in name else "d2h")
    if any(key in name for key in ("fprop", "convolve", "dgrad", "cudnn", "fft", "cf32", "region_transform")):
        return "convolutions"  # fft, cf32 (complex GEMM), region_transform: cuDNN's FFT convolutions
    if "gemm" in name:
        return "gemm"
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
    k2 = phase_kernel_k2()
    k2g = phase_kernel_k2_group()
    k3 = phase_kernel_k3()
    k5 = phase_kernel_k5()
    k4 = phase_kernel_k4()
    counters = Counters()
    phase_parity()
    phase_family_parity(counters)
    phase_vis_parity(counters)
    runs = phase_main(counters)
    family = phase_family_main(counters)
    vis = phase_vis_main(counters)
    phase_eval_parity(counters)
    evals = {
        "eval_kitti": phase_eval_run(counters, "eval_kitti", num_views=21, keyview_idx=10, height=375, width=1242,
                                     num_samples=3, cut="samples: 3 (synthetic data); views and size as KITTI's"),
        "eval_eth3d": phase_eval_run(counters, "eval_eth3d", num_views=11, keyview_idx=0, height=1024, width=1536,
                                     num_samples=2, cut="samples: 2 (synthetic data); views and size as ETH3D's"),
    }

    f32, bf16 = k1["f32"], k1["bf16"]
    k2_main = k2["mvsnet_f32"]
    k2_launches = {path: family[path]["fp32"]["launches"]["sweep_warp"] for path in ("mvsnet_train", "cvp_mvsnet")}
    k5_launches = {"vis_mvsnet": vis["banded"]["fp32"]["launches"]["conv3d_banded"],
                   "mvsnet_train_banded_xla": family["mvsnet_train_banded_xla"]["fp32"]["launches"]["conv3d_banded"]}
    k5_main = k5["vis_stage3_reg"]
    k4_main = k4["f32"]
    print(json.dumps({"kernels": [{
        "name": "planesweep_sample",
        "route": "cuda",
        "status": "ported",
        "source": "robustmvd_tpu_torch/csrc/planesweep_sample.cu",
        "replaces": "robustmvd_tpu/ops/pallas/planesweep_sample.py:55; "
                    "robustmvd_tpu/ops/pallas/planesweep_sample_v2.py:64",
        "launches": runs["fp32"]["launches"]["planesweep_sample"],
        "launches_by_path": {"robust_mvd": runs["fp32"]["launches"]["planesweep_sample"],
                             **{path: r["k1_launches"] for path, r in evals.items()}},
        "launches_per_eval_sample": {path: r["k1_launches_per_sample"] for path, r in evals.items()},
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "bf16": {k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "sweep_warp",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/sweep_warp.cu",
        "replaces": "robustmvd_tpu/ops/pallas/sweep_warp.py:287 (_call_sweep, kernel _sweep_kernel :179; "
                    "entries warp_variance :373, warp_variance_rt :446, warp_variance_dense :465)",
        "launches": sum(k2_launches.values()),
        "launches_by_path": k2_launches,
        "max_abs_err": k2_main["max_abs_err"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it; the yardstick is the grid_sample route
        "grid_sample_route_ms": k2_main["grid_sample_route_ms"],
        "cases": {case: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "grid_sample_route_ms", "bound_ms",
                                           "bound_by", "bound_share")} for case, r in k2.items()},
    }, {
        "name": "sweep_group_cost",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/sweep_group_cost.cu",
        "replaces": "robustmvd_tpu/ops/pallas/sweep_warp.py:287 (_call_sweep, kernel _sweep_kernel :179, "
                    "agg='group'; entry homography_group_cost :579)",
        "launches": vis["banded"]["fp32"]["launches"]["sweep_group_cost"],
        "max_abs_err": max(r["max_abs_err"] for r in k2g.values()),
        "ms": k2g["stage3"]["ms"],
        "plain_ms": k2g["stage3"]["plain_ms"],
        "bound_ms": k2g["stage3"]["bound_ms"],
        "bound_by": k2g["stage3"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it; the yardstick is the grid_sample route
        "grid_sample_route_ms": k2g["stage3"]["grid_sample_route_ms"],
        "cases": {case: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "grid_sample_route_ms", "bound_ms",
                                           "bound_by", "bound_share")} for case, r in k2g.items()},
    }, {
        "name": "soft_argmin",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/soft_argmin.cu",
        "replaces": "robustmvd_tpu/ops/pallas/softargmin.py:46 (fused_soft_argmin, pallas_call :92)",
        "launches": vis["banded"]["fp32"]["launches"]["soft_argmin"],
        "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
        "ms": k3["stage3_pair"]["ms"],
        "plain_ms": k3["stage3_pair"]["plain_ms"],
        "bound_ms": k3["stage3_pair"]["bound_ms"],
        "bound_by": k3["stage3_pair"]["bound_by"],
        "library_ms": k3["stage3_pair"]["library_ms"],  # torch.softmax over D alone
        "path": k3["stage3_pair"]["path"],
        "cases": {case: {k: r[k] for k in ("path", "max_abs_err", "prob_map_flipped_share", "ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_by")} for case, r in k3.items()},
    }, {
        "name": "conv3d_banded",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/conv3d_banded.cu",
        "replaces": "robustmvd_tpu/ops/pallas/conv3d.py:145 (conv3d_banded_pallas; _conv3d_banded_pallas :66, "
                    "pallas_call :101)",
        "launches": sum(k5_launches.values()),
        "launches_by_path": k5_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k5.values()),
        "ms": k5_main["ms"],
        "plain_ms": k5_main["plain_ms"],
        "bound_ms": k5_main["bound_ms"],
        "bound_by": k5_main["bound_by"],
        "library_ms": k5_main["library_ms"],  # F.conv3d (cuDNN), TF32 off
        "library_tf32_ms": k5_main["library_tf32_ms"],
        "path": k5_main["path"],
        "cases": {case: {k: r[k] for k in ("path", "max_abs_err", "ms", "plain_ms", "library_ms", "library_tf32_ms",
                                           "bound_ms", "bound_by")} for case, r in k5.items()},
    }, {
        "name": "warp_volume",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/warp_volume.cu",
        "replaces": "robustmvd_tpu/ops/pallas/warp_volume.py:216 (homo_warp_pallas; _homo_warp_pallas :169, "
                    "pallas_call :197)",
        "launches": family["mvsnet_train_banded_xla"]["fp32"]["launches"]["warp_volume"],
        "launches_by_path": {"mvsnet_train_banded_xla":
                             family["mvsnet_train_banded_xla"]["fp32"]["launches"]["warp_volume"]},
        "max_abs_err": k4_main["max_abs_err"],
        "ms": k4_main["ms"],
        "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"],
        "bound_by": k4_main["bound_by"],
        "library_ms": k4_main["library_ms"],  # F.grid_sample at the same coordinates
        "cases": {mode: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                  for mode, r in k4.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
