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
            robust_mvd at full width over ``synthetic``, each sample's views
            uploaded once and resized on the card (``resize_bilinear_torch``):
            on the card vs on the CPU (5 views, 128x256 and 120x250 -> 128x256,
            2 samples, nearest ordering, uncertainty, TF32 off, cuDNN
            deterministic), every metric column but runtime and memory within
            PERF.md §2's limits; ``resize_parity`` (KITTI's 21 views
            375x1242 -> 384x1280 resized on the card against the host's
            numpy resize, max abs diff within 2^-16 x 255); then at KITTI's
            evaluation configuration (21 views, key view 10, 375x1242,
            quasi-optimal ordering, 3 samples, the first a burn-in sample) and
            at ETH3D's (11 views, 1024x1536, 2 samples): model runs and K1
            launches per sample, the engine's runtimes, wall seconds per
            sample, host share and the adapters' share, peak memory, and the
            burn-in sample's host-to-device copies (torch.profiler), which
            must come to one upload of its views.
9b. models: ``vis_rmvd_checkpoint`` (vis_mvsnet's seeded weights saved in
            rmvd's naming, loaded with ``create_model(weights=...)``: a
            384x1280 frame bit-equal to the port-named load's, K5, K2 group
            and K3 30, 6 and 6 times); ``wrapped`` (the seven wrapped models
            on stub repositories written by ``tests/wrapper_stubs.py``: built
            on the card with every parameter there, ``model.run`` at each
            stub's native size against the CPU within 1e-5, 3 + 10 timed
            runs).
10. train:  K1b (the backward of K1) at the recipe's shape (B = 4, 48x96
            score images of 384x768 crops, S = 256), held against its plain
            version, timed beside its bound and grid_sample's input gradient;
            K1's autograd Function on the card vs the CPU; one recipe step
            (the engine's train_step) of robust_mvd on the card vs the CPU
            (1+2 views, 64x128, TF32 off, cuDNN deterministic) at iterations
            0 and 2000: loss, gradients, parameters after the update; then
            the recipe through ``create_training`` (``train_main``, the main
            path of this slice): ``synthetic`` with 5 views at 540x960
            through the StaticThings3D augmentations and the batch
            augmentations, batch 4, fp32: 3 warm-up and 10 timed steps
            (ms per step, host share, peak MiB, losses, K1 and K1b
            launches: 4 each per step), a resume from the final snapshot,
            and a profile of one step by kernel kind.
11. bf16:   robust_mvd at ``dtype="bfloat16"`` (bf16 convolutions and
            correlation, float32 heads): K1b's bf16 form at the recipe's
            shape (in phase ``kernel_k1b``: held against its plain version
            within one bf16 step of the largest |dS|, timed beside the
            float32 form plus a cast and beside grid_sample's bf16 input
            gradient); ``parity_bf16`` (card vs CPU, 1+2 views, 64x128,
            mean |d invdepth| within 0.05 of the fp32 invdepth's mean);
            ``main_bf16`` (``model.run`` at 384x1280, 1+2 views, beside
            phase main's fp32: ms per frame, peak, K1 v2 twice per frame);
            ``eval_kitti_bf16`` (as eval_kitti, 2 samples, the first a
            burn-in: K1 v2 230 times per sample, the all-views forward's
            FFT time); ``train_bf16`` (the paper recipe as train_all.sh
            scripts it, through the train CLI, on the StaticThings3D +
            BlendedMVS compound over a raw-size tree that the script writes:
            3 warm-up and 5 timed steps, K1 v2 and K1b's bf16 form 4 times
            per step, then two profiled steps).
12. family bf16: the MVSNet family at ``dtype="bfloat16"`` (bf16
            convolutions and cost volumes, float32 parameters, heads and
            variance sums): K5's bf16 form at phase 8's shapes with Cout > 4
            (in phase ``kernel`` conv3d_banded: held against its plain
            version within one bf16 step of the largest |out|, timed beside
            K5 fp32 and cuDNN's bf16 ``F.conv3d``, the bound at the dense bf16
            rate; required to beat ``F.conv3d`` bf16 at every one of them,
            ``K5_BF16_MUST_BEAT_LIBRARY``) and at the 18 shapes one vis_mvsnet
            bf16 frame launches it with (phase ``kernel_k5_vis_frame``: the
            shapes recorded in ``main_family_bf16``'s own vis run, their
            calls per frame summing to the wrapper's launches per frame there,
            each held against its plain version and timed beside
            ``F.conv3d`` bf16 with its bound and the per-call weight layout,
            and the sums weighted by calls per frame); K2 group's bf16 form (bf16 features, vis's bf16 fused
            route, its lane route) at phase 7's shapes in phase ``kernel`` sweep_group_cost
            (bit for bit against its plain version, timed beside the float32 form and required to beat
            it at every stage, ``K2_GROUP_BF16_MUST_BEAT_F32``);
            ``parity_family_bf16`` (the three models with conditioned score
            heads card vs CPU at 128x192, cvp and vis on both warp routes,
            scored as the benchmark scores depth: absrel < 0.5 points,
            1.03-inliers > 99%); ``main_family_bf16`` (``model.run`` at
            384x1280, 1+2 views, 3 + 20 frames, beside phases main_family /
            main_vis's fp32, with each kernel's launches per frame by dtype:
            vis's default launches K2 group's bf16 form 6 times and K5's 24
            times, its score heads 6 in float32) with
            ``breakdown_family_bf16`` (K5's device time split by form:
            the bf16 mma route and the float32 score heads);
            ``main_family_xla`` (cvp's and vis's
            ``warp_impl="xla"`` routes at fp32 beside their fused routes).
13. family training (the MVSNet family's training):
            ``kernel_k3_grad`` (K3's autograd gradient, the kernel forward
            and the closed-form backward in torch ops, against autograd
            through its plain version at vis's training readouts, 256x320,
            batch 2, with and without the window mass; forward, backward
            and plain times); ``train_vis_parity`` (one vis_mvsnet train
            step card vs CPU at 128x160, score heads conditioned: loss,
            gradients, BatchNorm running statistics); ``train_vis`` (the JAX
            bench's vis configuration, batch 2, 1+2 views, 256x320, adam 1e-3,
            mvsnet_scheduler, vismvsnet_loss, fp32, TF32 off, through
            create_training on ``synthetic``: 3 + 10 steps, K5 45 and K3 9
            times per step, the running statistics moved, a resume, a
            profiled step); ``train_vis_bf16`` (the same at bf16 through
            create_training, 3 + 5 steps, K5's bf16 form 36 and its float32 heads 9
            times per step); ``train_family`` (mvsnet_train with mvsnet_loss,
            D 48, and cvp_mvsnet with SL1Loss at 128x160, 3 steps each, the
            first loss against the CPU's).
14. logging, data parallelism, the profiler: ``train_writer`` (the recipe
            through create_training after ``setup_writers``, as train_main,
            ``log_interval`` 2, 3 + 10 steps: ms per logged and unlogged step,
            ``_log_all``'s host ms, the events by type, whether tensorboard
            imports, K1 (4 per step and 4 per logging forward) and K1b; then
            the parameters after 4 steps logged every step against 4 steps
            unlogged, bit-equal, with two unlogged runs as the yardstick);
            ``train_ddp`` (the recipe's train CLI on the StaticThings3D tree,
            without and with ``--data_parallel`` through ``python -m
            robustmvd_tpu_torch.launch --local 1``: NCCL, world size 1, 3 + 5
            steps, ms per step side by side, K1 and K1b 4 per step on each
            side, the parameters after 3 steps within rtol 1e-6);
            ``train_vis_ddp`` (vis at train_vis's configuration through
            create_training, without and with a mesh in the launcher's child,
            3 steps: K5 45 and K3 9 per step on each side, parameters and
            BatchNorm running statistics within rtol 1e-6);
            ``profile_main`` (``utils/profiler.trace`` around one robust_mvd
            frame at 384x1280, 1+2 views: K1's kernel in the Chrome trace;
            ``time_fn``'s ms per frame beside phase main's;
            ``device_memory_stats``).
15. the kernels line, and last the ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero; it does nothing
without a CUDA device. Weights are random, from a seed.
"""

import contextlib
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
MODEL_BOUNDS = (1e-4, 1e-3)  # mean, max relative error (tests/test_torch_port_model.py)
# K1b vs its plain version, relative to the largest |dS|: atomics add the taps
# of coinciding hypotheses in another order
K1B_LIMIT = 1e-5
# K1b's bf16 form vs its plain version, relative to the largest |dS|: the float32
# sums differ as above, so a value may round to the neighbouring bf16 step
K1B_BF16_LIMIT = 2.0**-8
# robust_mvd at bf16 against the same weights elsewhere (the port on the CPU):
# mean |d invdepth| / mean |invdepth at fp32|, the JAX package's bf16 bound
# (tests/test_models.py:113-114, tests/test_torch_port_bf16.py)
BF16_MODEL_BOUND = 0.05
K2_LIMIT = 1e-5  # K2 (both modes) vs its plain version: the same op order, no fused multiply-add
# K2 group's bf16 form against its float32 form in the same run: every stage (the float32 design with 8-byte
# bf16 loads was slower than the float32 form at all three)
K2_GROUP_BF16_MUST_BEAT_F32 = ("stage1", "stage2", "stage3")
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
# cuDNN's FFT convolutions by kernel name: the transforms, the complex GEMMs between them
FFT_KERNEL_KEYS = ("fft", "cf32", "cf16", "region_transform")
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
# K5's bf16 form against cuDNN's bf16 F.conv3d: every shape with Cout > 4 (its first form lost at conv4 and
# conv6, 1.6x and 3.4x)
K5_BF16_MUST_BEAT_LIBRARY = tuple(case for case, (_, cout, _) in K5_CASES.items() if cout > 4)
# K5's bf16 form vs its plain version, relative to max |plain|: 2^-8 for the one
# rounding to bf16, and 2^-8 of slack for the float32 sums' other order, which
# can put a value on the other side of a rounding boundary (one bf16 step)
K5_BF16_LIMIT = 2.0**-7


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


def k5_bound_bf16(x, cout):
    """Least time for K5's bf16 form: bf16 input, weights and output moved
    once at the HBM rate, against 54 Cin Cout flops per output voxel at the
    dense bf16 tensor-core rate."""
    B, cin, D, H, W = x.shape
    voxels = B * D * H * W
    nbytes = 2 * (x.numel() + 27 * cin * cout + voxels * cout)
    flops = voxels * cout * 54 * cin
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {"path": "bf16_mma", "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def k5_case_bf16(x, weight, cout):
    """K5's bf16 form at one shape (Cout > 4; no bias, as the family's bf16
    convolutions): held against its plain version within K5_BF16_LIMIT, timed
    beside cuDNN's ``F.conv3d`` at bf16 (the same rounding of float32 sums),
    each on its weight prepared once; ``weight_layout_ms`` is what laying out
    the float32 weight costs K5 on each call in a model."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.conv3d import (conv3d_banded, conv3d_banded_bf16_weights,
                                                         conv3d_banded_reference)

    xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    # laid out once, as cuDNN's weight is cast once, outside the timing; the model lays it out per call
    kb = conv3d_banded_bf16_weights(weight.permute(2, 3, 4, 1, 0))
    out = conv3d_banded(xb, kb, None, channels_first=True)
    torch.cuda.synchronize()
    plain = conv3d_banded_reference(xb.movedim(1, -1), kb).movedim(-1, 1)
    if out.dtype != torch.bfloat16:
        raise AssertionError(f"K5 bf16 wrote {out.dtype}")
    diff = (out.float() - plain.float()).abs()
    scale = float(plain.float().abs().max())
    err = float(diff.max())
    if not (err <= K5_BF16_LIMIT * scale and torch.isfinite(out).all()):
        raise AssertionError(f"K5 bf16 disagrees with its plain version: max_abs_err {err} > {K5_BF16_LIMIT} x {scale}")
    flipped = float((diff > 0).float().mean())
    del plain, diff

    def library():
        return F.conv3d(xb, wb, None, padding=1)

    lib_diff = float((library().float() - out.float()).abs().max())
    return {"max_abs_err": err, "limit": K5_BF16_LIMIT * scale, "max_abs_ref": scale, "differing_share": flipped,
            "ms": time_ms(lambda: conv3d_banded(xb, kb, None, channels_first=True)),
            "plain_ms": time_ms(lambda: conv3d_banded_reference(xb.movedim(1, -1), kb), runs=10, warmup=2),
            "library_ms": time_ms(library), "library_max_abs_diff": lib_diff,
            "weight_layout_ms": time_ms(lambda: conv3d_banded_bf16_weights(weight.permute(2, 3, 4, 1, 0))),
            **k5_bound_bf16(x, cout)}


def phase_kernel_k5():
    """K5 on NCDHW volumes (the family's layout) against its plain version
    (27 shifted NDHWC channel contractions); yardstick ``F.conv3d`` (cuDNN)
    with TF32 off and, as a second figure, on. Fails if K5 is slower than
    ``F.conv3d`` fp32 at the two shapes where the CUDA-core kernel lost
    (``K5_MUST_BEAT_LIBRARY``), after printing the times. Every shape with
    Cout > 4 also runs K5's bf16 form (``k5_case_bf16``), beside the float32
    form's time, and fails if it is slower than ``F.conv3d`` bf16
    (``K5_BF16_MUST_BEAT_LIBRARY``); the score heads stay float32."""
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
        if cout > 4:
            results[case]["bf16"] = {**k5_case_bf16(x, weight, cout), "f32_ms": results[case]["ms"]}
        torch.cuda.empty_cache()
    emit("kernel", name="conv3d_banded", layout="NCDHW", **results)
    slower = {case: (results[case]["ms"], results[case]["library_ms"]) for case in K5_MUST_BEAT_LIBRARY
              if results[case]["ms"] >= results[case]["library_ms"]}
    slower_bf16 = {case: (results[case]["bf16"]["ms"], results[case]["bf16"]["library_ms"])
                   for case in K5_BF16_MUST_BEAT_LIBRARY
                   if results[case]["bf16"]["ms"] >= results[case]["bf16"]["library_ms"]}
    if slower or slower_bf16:
        raise AssertionError(f"K5 slower than F.conv3d (ms, library ms): fp32 {slower}, bf16 {slower_bf16}")
    return results


@contextlib.contextmanager
def k5_bf16_calls():
    """{(x shape, Cout): calls} of K5's bf16 form through ``ops.conv3d``
    (the module attribute its ``Conv3d`` calls, wrapped for the block), each
    input checked to be a contiguous NCDHW volume."""
    import torch

    from robustmvd_tpu_torch.ops import conv3d as conv3d_op

    inner, seen = conv3d_op.conv3d_banded, {}

    def record(x, kernel, bias=None, channels_first=False):
        if x.dtype == torch.bfloat16:
            if not (channels_first and x.is_contiguous()):
                raise AssertionError(f"vis bf16 K5 input {tuple(x.shape)} is not a contiguous NCDHW volume")
            key = (tuple(x.shape), kernel.shape[4])
            seen[key] = seen.get(key, 0) + 1
        return inner(x, kernel, bias, channels_first)

    conv3d_op.conv3d_banded = record
    try:
        yield seen
    finally:
        conv3d_op.conv3d_banded = inner


def phase_kernel_k5_vis_frame(calls_per_frame):
    """K5's bf16 form at every shape a vis_mvsnet bf16 frame launches it with
    (``calls_per_frame``, {(x shape, Cout): calls}, as recorded in phase
    ``main_family_bf16``'s vis run; 18 at 384x1280): each held against its
    plain version within K5_BF16_LIMIT on random NCDHW inputs and an
    nn.Conv3d weight, timed beside cuDNN's ``F.conv3d`` bf16 (each on its
    weight prepared once), with its bound and the per-call layout of the
    float32 weight the model pays; and the frame's sums, each shape weighted
    by its calls per frame."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.conv3d import (conv3d_banded, conv3d_banded_bf16_weights,
                                                         conv3d_banded_reference)

    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = []
    for (shape, cout), calls in sorted(calls_per_frame.items()):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        weight32 = torch.randn((cout, shape[1], 3, 3, 3), generator=gen, device="cuda") / (27 * shape[1]) ** 0.5
        weight = weight32.to(torch.bfloat16)
        k = conv3d_banded_bf16_weights(weight32.permute(2, 3, 4, 1, 0))
        out = conv3d_banded(x, k, None, channels_first=True)
        torch.cuda.synchronize()
        plain = conv3d_banded_reference(x.movedim(1, -1), k).movedim(-1, 1).float()
        scale, err = float(plain.abs().max()), float((out.float() - plain).abs().max())
        del plain
        if not (err <= K5_BF16_LIMIT * scale and torch.isfinite(out).all()):
            raise AssertionError(f"K5 bf16 at vis shape {shape} -> {cout} disagrees with its plain version: "
                                 f"max_abs_err {err} > {K5_BF16_LIMIT} x {scale}")
        shapes.append({"shape": list(shape), "cout": cout, "calls_per_frame": calls, "max_abs_err": err,
                       "ms": time_ms(lambda: conv3d_banded(x, k, None, channels_first=True)),
                       "library_ms": time_ms(lambda: F.conv3d(x, weight, None, padding=1)),
                       "weight_layout_ms": time_ms(lambda: conv3d_banded_bf16_weights(
                           weight32.permute(2, 3, 4, 1, 0))),
                       **{key: v for key, v in k5_bound_bf16(x, cout).items() if key in ("bound_ms", "bound_by")}})
        del x, out
        torch.cuda.empty_cache()
    frame = {key: sum(r["calls_per_frame"] * r[key] for r in shapes)
             for key in ("ms", "bound_ms", "library_ms", "weight_layout_ms")}
    frame["calls"] = sum(r["calls_per_frame"] for r in shapes)
    emit("kernel_k5_vis_frame", model="vis_mvsnet", dtype="bfloat16", input_shape=[384, 1280], views=3,
         distinct_shapes=len(shapes), call_weighted=frame, shapes=shapes)
    return {"distinct_shapes": len(shapes), "call_weighted": frame, "shapes": shapes}


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


def phase_parity_bf16(counters):
    """robust_mvd at bf16 on the card vs on the CPU: same seeded weights, B =
    1, 1+2 views, 64x128; the finest invdepth's mean |d| over the mean
    |invdepth| of the CPU's fp32 forward within BF16_MODEL_BOUND, as the JAX
    package holds its bf16 forward (the coarser scales, down to 1x2 pixels,
    are reported); float32 heads; K1 v2 once per source view on the card."""
    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    sample = kitti_like_sample(np.random.RandomState(1), 64, 128, 3)
    outs = {}
    for device, dtype in (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "bfloat16")):
        model = rmvd.create_model("robust_mvd", device=device, seed=0, dtype=dtype)
        counters.reset()
        outs[device, dtype] = model.run(**sample)[1]
        launches = counters.read()
        del model
    if launches["planesweep_sample[bfloat16]"] != 2 or launches["planesweep_sample[float32]"] != 0:
        raise AssertionError(f"robust_mvd bf16 on the card launched {launches}, expected K1 v2 twice")
    ref, cpu, card = outs["cpu", "float32"], outs["cpu", "bfloat16"], outs["cuda", "bfloat16"]
    errors = {}
    for key in ("invdepths_all", "invdepth_log_bs_all"):
        for scale, (g, c, f) in enumerate(zip(card[key], cpu[key], ref[key])):
            if g.dtype != np.float32:
                raise AssertionError(f"bf16 heads must be float32, {key}[{scale}] is {g.dtype}")
            norm = np.abs(f).mean() + 1e-6
            errors[f"{key}[{scale}]"] = {"card_vs_cpu": float(np.abs(g - c).mean() / norm),
                                         "card_vs_cpu_fp32": float(np.abs(g - f).mean() / norm),
                                         "cpu_vs_cpu_fp32": float(np.abs(c - f).mean() / norm)}
    held = errors[f"invdepths_all[{len(card['invdepths_all']) - 1}]"]
    if not held["card_vs_cpu"] < BF16_MODEL_BOUND:
        raise AssertionError(f"robust_mvd bf16 card vs CPU, finest invdepth: {held} (bound {BF16_MODEL_BOUND})")
    if not (ref["invdepth"] > 0).mean() > 0.1:
        raise AssertionError("bf16 parity run predicts almost no positive invdepth: the check would be vacuous")
    emit("parity_bf16", tf32=tf32, shape=[64, 128], views=3, bound=BF16_MODEL_BOUND, k1_launches_card=launches,
         errors=errors)


def phase_main_bf16(counters, fp32_runs):
    """robust_mvd at bf16 through ``model.run`` at 384x1280, 1+2 views, as
    phase ``main``: ms per frame, peak, K1 v2's launches (2 per frame), beside
    phase main's fp32; then where a frame's time goes."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    model = rmvd.create_model("robust_mvd", dtype="bfloat16")
    sample = kitti_like_sample(np.random.RandomState(2), 384, 1280, 3)
    pred, stats = timed_frames(model, sample, counters)
    frames = stats["warmup"] + stats["frames"]
    if stats["launches"]["planesweep_sample[bfloat16]"] != 2 * frames or stats["launches"]["planesweep_sample[float32]"]:
        raise AssertionError(f"robust_mvd bf16: launches {stats['launches']} in {frames} frames, expected K1 v2 "
                             "twice per frame and no float32 K1")
    depth = pred["depth"]
    if depth.shape != (1, 1, 192, 640) or depth.dtype != np.float32 or not np.isfinite(depth).all():
        raise AssertionError(f"bf16 depth: shape {depth.shape}, {depth.dtype}, finite {np.isfinite(depth).all()}")
    fp32 = {k: fp32_runs["fp32"][k] for k in ("ms_per_frame", "ms_per_frame_mean", "ms_per_frame_min", "peak_mib")}
    emit("main_bf16", shape=[384, 1280], views=3, dtype="bfloat16", tf32=tf32, **stats,
         k1_v2_launches_per_frame=stats["launches"]["planesweep_sample[bfloat16]"] / frames, fp32=fp32)
    emit("breakdown_bf16", **device_breakdown(model, sample, frames=10))
    del model
    torch.cuda.empty_cache()
    return stats


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


# The family at bf16 (384x1280, 1+2 views): label -> (model, create_model
# arguments, launches per frame; K5 by dtype: the score heads stay float32)
FAMILY_BF16 = {
    "mvsnet_train": ("mvsnet_train", {}, {"sweep_warp": 1}),
    "cvp_mvsnet": ("cvp_mvsnet", {}, {"sweep_warp": 5}),
    "mvsnet_train_banded_xla": ("mvsnet_train", {"conv3d_impl": "banded", "warp_impl": "xla"},
                                {"warp_volume": 2, "sweep_warp": 0, "conv3d_banded[bfloat16]": 3,
                                 "conv3d_banded[float32]": 1}),
    "vis_mvsnet": ("vis_mvsnet", {}, {"sweep_group_cost[bfloat16]": 6, "sweep_group_cost[float32]": 0,
                                      "soft_argmin": 6, "conv3d_banded[bfloat16]": 24,
                                      "conv3d_banded[float32]": 6}),
}
# the XLA warp routes of cvp and vis (float32), beside their fused routes
FAMILY_XLA = {
    "cvp_mvsnet_xla": ("cvp_mvsnet", {"warp_impl": "xla"}, {"sweep_warp": 0}),
    "vis_mvsnet_xla": ("vis_mvsnet", {"warp_impl": "xla"}, {"sweep_group_cost": 0, "soft_argmin": 6,
                                                            "conv3d_banded[float32]": 30}),
}
# card vs CPU at bf16: the defaults, K4's and K5's paths and both warp routes
FAMILY_PARITY_BF16 = {**{label: FAMILY_BF16[label] for label in FAMILY_BF16},
                      "cvp_mvsnet_xla": ("cvp_mvsnet", {"warp_impl": "xla"}, {"sweep_warp": 0}),
                      "vis_mvsnet_xla": ("vis_mvsnet", {"warp_impl": "xla"},
                                         {"sweep_group_cost": 0, "conv3d_banded[bfloat16]": 24})}
# bf16 depth card vs CPU, scored as the benchmark scores depth with the CPU's
# as ground truth: absrel below half a point and 1.03-inliers above 99%,
# tighter than the bounds the JAX package holds its bf16 family to against
# fp32 (1 point, 97%: tests/test_family_bf16.py:93-94). The random models'
# score heads are scaled (FAMILY_HEAD_GAINS) so that their own bf16-vs-fp32
# distance on the CPU stays under 0.3 points while depth still varies, and
# planted kernel faults fail these bounds (tests/test_torch_port_family_bf16.py;
# tests/test_torch_port_cuda.py holds a copy of both constants).
FAMILY_BF16_BOUNDS = {"absrel": 0.5, "inliers": 99.0}
FAMILY_HEAD_GAINS = {"mvsnet_train": 4.0, "cvp_mvsnet": 1.0, "vis_mvsnet": 0.25}


def conditioned_heads(model, name):
    """``model`` with its score heads' weights (``prob``, ``prob0``,
    ``final_conv``) scaled by the model's FAMILY_HEAD_GAINS."""
    import torch

    with torch.no_grad():
        for path, module in model.named_modules():
            if path.rsplit(".", 1)[-1] in ("prob", "prob0", "final_conv"):
                module.weight.mul_(FAMILY_HEAD_GAINS[name])
    return model


def tilted_sample(seed, H, W):
    """Three views with tilted, rotated cameras and a (1, 10) depth range (a
    camera that only rotates about y makes CVP-MVSNet's interval singular on
    the principal row)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    images = [rng.rand(1, 3, H, W).astype(np.float32) * 255 for _ in range(3)]
    K = np.array([[[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]], np.float32)
    poses = [np.eye(4, dtype=np.float32)[None] for _ in range(3)]
    for i in (1, 2):
        poses[i][0, :3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        poses[i][0, :3, 3] = rng.randn(3) * 0.1 + [0.1 * i, 0.0, 0.0]
    return dict(images=images, poses=poses, intrinsics=[K] * 3, keyview_idx=np.zeros(1, np.int64),
                depth_range=(np.array([1.0], np.float32), np.array([10.0], np.float32)))


def depth_scores(pred, gt):
    """(absrel in points, 1.03-inliers in %) of ``pred`` against ``gt``."""
    from robustmvd_tpu_torch.eval.metrics import m_rel_ae, thresh_inliers

    ones = np.ones_like(gt)
    return (float(m_rel_ae(gt=gt, pred=pred, mask=ones, output_scaling_factor=100.0)),
            float(thresh_inliers(gt=gt, pred=pred, thresh=1.03, mask=ones, output_scaling_factor=100.0)))


def phase_family_parity_bf16(counters):
    """The family at bf16 on the card vs on the CPU (the port's plain
    versions, oneDNN's bf16 convolutions), TF32 off, cuDNN deterministic,
    1+2 views at 128x192 (tilted_sample), heads conditioned: the card's
    depth within FAMILY_BF16_BOUNDS of the CPU's; the CPU's own bf16 vs fp32
    distance reported beside it; each path's kernels launched on the card,
    K2 group and K5 by dtype."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    sample = tilted_sample(6, 128, 192)
    report = {}
    for label, (name, kwargs, per_frame) in FAMILY_PARITY_BF16.items():
        outs = {}
        for device, dtype in (("cpu", "float32"), ("cpu", "bfloat16"), ("cuda", "bfloat16")):
            model = conditioned_heads(rmvd.create_model(name, device=device, seed=0, dtype=dtype, **kwargs), name)
            counters.reset()
            outs[device if dtype == "bfloat16" else "cpu_fp32"] = model.run(**sample)
            del model
        launches = counters.read()  # the card's run
        wrong = {k: launches[k] for k, n in per_frame.items() if launches[k] != n}
        if wrong:
            raise AssertionError(f"{label} bf16 on the card launched {wrong}, expected {per_frame}")
        (pc, ac), (pg, ag) = outs["cpu"], outs["cuda"]
        c, g = pc["depth"], pg["depth"]
        if not (np.isfinite(c).all() and np.isfinite(g).all() and c.std() > 5e-2 * np.abs(c).mean()):
            raise AssertionError(f"{label} bf16 parity run: depth not finite or flat (std {c.std()})")
        if g.dtype != np.float32:
            raise AssertionError(f"{label} bf16 depth is {g.dtype}: the heads must be float32")
        absrel, inliers = depth_scores(g, c)
        noise = depth_scores(c, outs["cpu_fp32"][0]["depth"])
        if not (absrel < FAMILY_BF16_BOUNDS["absrel"] and inliers > FAMILY_BF16_BOUNDS["inliers"]):
            raise AssertionError(f"card vs CPU {label} bf16: absrel {absrel} points, inliers {inliers}% "
                                 f"(bounds {FAMILY_BF16_BOUNDS}; the CPU's bf16 vs fp32: {noise})")
        report[label] = {"kwargs": kwargs, "shape": list(c.shape), "absrel": absrel, "inliers": inliers,
                         "cpu_bf16_vs_fp32": {"absrel": noise[0], "inliers": noise[1]},
                         "rel_err": list(relative_errors(g, c)),
                         "uncertainty_mean_abs_diff": float(np.abs(pg["depth_uncertainty"] -
                                                                   pc["depth_uncertainty"]).mean()),
                         "launches": {k: v for k, v in launches.items() if v},
                         "depth_std_over_mean": float(c.std() / np.abs(c).mean())}
        if name == "cvp_mvsnet":
            report[label]["coarsest_rel_err"] = list(relative_errors(ag["depths_all"][-1], ac["depths_all"][-1]))
    torch.backends.cudnn.deterministic = False
    emit("parity_family_bf16", tf32=tf32, cudnn_deterministic=True, input_shape=[128, 192], views=3,
         bounds=FAMILY_BF16_BOUNDS, head_gains=FAMILY_HEAD_GAINS, **report)
    torch.cuda.empty_cache()


def phase_family_main_bf16(counters, family, vis):
    """``model.run`` of the family at bf16 (FAMILY_BF16) and of cvp's and
    vis's XLA warp routes at fp32 (FAMILY_XLA), 384x1280, 1+2 views, TF32
    off, 3 warm-up and 20 timed frames as in the fp32 phases (over 5 the
    host clock spread 5-30% between calls), beside phases main_family's and
    main_vis's fp32 runs of the same model; each path's launches per frame
    checked (vis's default launches K2 group's and K5's bf16 forms 6 and 24
    times), and K5 bf16's shapes, calls per frame through ``ops.conv3d``
    that sum to its launches; where a bf16 frame's time goes."""
    import torch

    import robustmvd_tpu_torch as rmvd

    fp32 = {"mvsnet_train": family["mvsnet_train"], "cvp_mvsnet": family["cvp_mvsnet"],
            "mvsnet_train_banded_xla": family["mvsnet_train_banded_xla"], "vis_mvsnet": vis["banded"]}
    fused = {"cvp_mvsnet_xla": family["cvp_mvsnet"], "vis_mvsnet_xla": vis["banded"]}
    keys = ("ms_per_frame", "ms_per_frame_mean", "ms_per_frame_min", "peak_mib", "launches_per_frame")
    sample = sideways_sample(np.random.RandomState(5), 384, 1280, 3)
    runs = {}
    for table, dtype, beside in ((FAMILY_BF16, "bfloat16", fp32), (FAMILY_XLA, "float32", fused)):
        for path, (name, kwargs, per_frame) in table.items():
            tf32 = set_tf32(False)
            model = rmvd.create_model(name, dtype=dtype, **kwargs)
            with k5_bf16_calls() as calls:
                pred, stats = timed_frames(model, sample, counters, warmup=3, frames=20)
            check_launches(f"{path} {dtype}", stats, per_frame)
            if calls:  # every call through ops.conv3d is one launch of the wrapper, none other
                n = stats["warmup"] + stats["frames"]
                if (sum(calls.values()) != stats["launches"]["conv3d_banded[bfloat16]"] or
                        any(c % n for c in calls.values())):
                    raise AssertionError(f"{path} {dtype}: K5 bf16 calls {calls} in {n} frames, launches "
                                         f"{stats['launches']['conv3d_banded[bfloat16]']}")
                runs[path, "k5_bf16_calls_per_frame"] = {key: c // n for key, c in calls.items()}
            depth = pred["depth"]
            expected = (1, 1, 96, 320) if name == "mvsnet_train" else (
                (1, 1, 192, 640) if name == "vis_mvsnet" else (1, 1, 384, 1280))
            if depth.shape != expected or depth.dtype != np.float32 or not np.isfinite(depth).all():
                raise AssertionError(f"{path} {dtype} depth: shape {depth.shape}, {depth.dtype}, "
                                     f"finite {np.isfinite(depth).all()}")
            runs[path, dtype] = stats
            other = {k: beside[path]["fp32"][k] for k in keys}
            emit("main_family_bf16" if dtype == "bfloat16" else "main_family_xla", model=name, path=path,
                 kwargs=kwargs, shape=[384, 1280], views=3, dtype=dtype, tf32=tf32, **stats,
                 **{"fp32" if dtype == "bfloat16" else "fused_fp32": other})
            if dtype == "bfloat16":
                breakdown = device_breakdown(model, sample, frames=3)
                kinds = breakdown["device_ms_by_kind"]
                forms = {"bf16_mma": kinds.get("k5_conv3d_banded_bf16", 0.0),
                         "float32_heads": kinds.get("k5_conv3d_banded", 0.0)}
                runs[path, "k5_ms_by_form"] = {**forms, "sum": sum(forms.values())}
                runs[path, "k2_group_ms"] = kinds.get("k2_group_cost", 0.0)
                if per_frame.get("sweep_group_cost[bfloat16]") and not runs[path, "k2_group_ms"] > 0:
                    raise AssertionError(f"{path} bf16: the profile attributes no device time to K2 group "
                                         f"(kernel_kind misses its kernel's name)")
                emit("breakdown_family_bf16", model=name, path=path, k5_ms_by_form=runs[path, "k5_ms_by_form"],
                     k2_group_ms=runs[path, "k2_group_ms"], **breakdown)
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
VIS_LAUNCHES = {"banded": {"sweep_group_cost": 6, "sweep_group_cost[float32]": 6, "soft_argmin": 6,
                           "conv3d_banded": 30, "conv3d_banded[float32]": 30},
                "xla": {"sweep_group_cost": 6, "sweep_group_cost[float32]": 6, "soft_argmin": 6, "conv3d_banded": 0,
                        "conv3d_banded[float32]": 0}}


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


def k2_group_bound(ref, src, w, G, out_bytes=4):
    """Least time for K2 group on these inputs: the output (``out_bytes`` a
    value), the key and source maps (in their dtype) and the per-pixel w
    each moved once, at the HBM rate; against (45 + 9 C) flops per pixel at
    the f32 rate (the sums are float32 at either feature dtype)."""
    B, D, H, W = w.shape
    C = ref.shape[3]
    nbytes = (B * D * H * W * G * out_bytes + (ref.numel() + src.numel()) * ref.element_size()
              + w.numel() * w.element_size())
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

    grid = grid.to(src.dtype)  # grid_sample takes its grid in the input's dtype

    def run():
        warped = F.grid_sample(src_c, grid, mode="bilinear", padding_mode="zeros",
                               align_corners=False).reshape(B, C, D, H, W)
        return (warped * ref_c).reshape(B, G, C // G, D, H, W).sum(2)  # (B, G, D, H, W)

    return run


def k2_group_case_bf16(case, ref, src, A, Bm, w):
    """K2 group's bf16 form (bf16 features and output, as vis_mvsnet's bf16
    path calls it) on one case's inputs rounded to bf16, held bit for bit
    against its plain version (the same order of operations, one rounding)
    and timed beside the float32 form and the grid_sample route at bf16
    (coordinates rounded to bf16 there: a yardstick of time only)."""
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import (
        homography_group_cost,
        homography_group_cost_reference,
        homography_group_cost_route,
    )

    ref, src = ref.bfloat16(), src.bfloat16()
    bf16 = torch.bfloat16
    out = homography_group_cost(ref, src, A, Bm, w, out_dtype=bf16)
    torch.cuda.synchronize()
    plain = homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=bf16)
    err = float((out.float() - plain.float()).abs().max())
    if not (torch.equal(out, plain) and torch.isfinite(out).all() and out.dtype == bf16):
        raise AssertionError(f"K2 group bf16 {case} differs from its plain version: max_abs_err {err}")
    del plain
    torch.cuda.empty_cache()
    route = group_grid_sample_route(ref, src, A, Bm, w, 8)
    result = {"route": homography_group_cost_route(ref, src, out_dtype=bf16), "max_abs_err": err, "limit": 0.0,
              "ms": time_ms(lambda: homography_group_cost(ref, src, A, Bm, w, out_dtype=bf16)),
              "plain_ms": time_ms(lambda: homography_group_cost_reference(ref, src, A, Bm, w, out_dtype=bf16),
                                  runs=10, warmup=2),
              "grid_sample_route_ms": time_ms(route, runs=10, warmup=2),
              **k2_group_bound(ref, src, w, 8, out_bytes=2)}
    result["bound_share"] = result["bound_ms"] / result["ms"]
    return result


def check_k2_group_bf16_beats_f32(results):
    """Raise unless K2 group's bf16 form ran faster than its float32 form at
    every stage of K2_GROUP_BF16_MUST_BEAT_F32 (``results``: phase
    ``kernel`` sweep_group_cost's, both forms timed in the same run)."""
    slower = {case: (results[case]["bf16"]["ms"], results[case]["ms"]) for case in K2_GROUP_BF16_MUST_BEAT_F32
              if not results[case]["bf16"]["ms"] < results[case]["ms"]}
    if slower:
        raise AssertionError(f"K2 group's bf16 form is no faster than its float32 form at {slower} "
                             f"(bf16 ms, float32 ms)")


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
        results[case]["bf16"] = k2_group_case_bf16(case, ref, src, A, Bm, w)
        torch.cuda.empty_cache()
    emit("kernel", name="sweep_group_cost", **results)
    main = results["stage3"]
    if not main["ms"] < main["grid_sample_route_ms"]:
        raise AssertionError(f"K2 group at stage3 ({main['ms']} ms) is slower than its grid_sample route "
                             f"({main['grid_sample_route_ms']} ms)")
    check_k2_group_bf16_beats_f32(results)
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
    fft_ms = sum(ms for name, ms, _ in rows if any(key in name for key in FFT_KERNEL_KEYS))
    return {
        "frames": frames, "stage_ms": stage_ms, "frame_ms": frame_ms,
        "device_ms_per_frame": device_ms, "convolutions_fft_ms_per_frame": fft_ms,
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
    # 128x256 as it is, and 120x250, which the staged views are resized from on each device
    for height, width in ((128, 256), (120, 250)):
        config = dict(num_views=5, height=height, width=width, num_samples=2)
        tables, curves, launches = {}, {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for device in ("cpu", "cuda"):
                evaluation = rmvd.create_evaluation("mvd", out_dir=os.path.join(tmp, device),
                                                    inputs=["poses", "intrinsics"], view_ordering="nearest",
                                                    eval_uncertainty=True, verbose=False)
                model = rmvd.create_model("robust_mvd", device=device, seed=0)
                counters.reset()
                tables[device] = evaluation(dataset=rmvd.create_dataset("synthetic.train.mvd", **config),
                                            model=model, qualitatives=0, burn_in_samples=1)
                launches[device] = counters.read()["planesweep_sample"]
                curves[device] = pd.read_pickle(os.path.join(tmp, device, "per_sample",
                                                             "sparsification_curves.pickle"))
                del model
        # nearest ordering sweeps 1..4 source views: 10 launches of K1 per sample on the card, none on the CPU
        if launches != {"cpu": 0, "cuda": 10 * config["num_samples"]}:
            raise AssertionError(f"evaluation K1 launches {launches}, expected 0 on the CPU and 20 on the card")
        errors = compare_eval_tables(tables["cuda"], tables["cpu"], curves["cuda"], curves["cpu"])
        best = tables["cuda"]["best"]
        emit("eval_parity", tf32=tf32, **config, model_input=[-(-height // 64) * 64, -(-width // 64) * 64],
             view_ordering="nearest", bounds=MODEL_BOUNDS, inlier_flip_share=INLIER_FLIP_SHARE,
             k1_launches=launches, errors=errors, best_absrel=best["absrel"].tolist(),
             best_num_views=best["num_views"].tolist(), best_ause=best["ause"].tolist(),
             best_inliers103=best["inliers103"].tolist())
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()


def h2d_copies(prof):
    """The bytes of each host-to-device copy in a torch.profiler trace
    (CUPTI's memcpy records, as the Chrome trace export writes them)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies = [e for e in events if "Memcpy HtoD" in e.get("name", "")]
    sizes = [e["args"]["bytes"] for e in copies if "bytes" in e.get("args", {})]
    if not copies or len(sizes) != len(copies):
        raise AssertionError(f"the trace has {len(copies)} host-to-device copies, {len(sizes)} with a byte count")
    return sizes


class TimedDataset:
    """A dataset that notes the host clock when the engine loads each sample.
    After ``profile_first_sample()``, the runs up to the second sample (the
    first, a burn-in sample whose times the engine and this script leave
    out) run under torch.profiler, which counts their host-to-device
    copies."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.starts = []
        self.profiler = None
        self.h2d_first_sample = None

    def profile_first_sample(self):
        """Start the profiler before the evaluation: copies issued right
        after ``start()`` were seen to go unrecorded (9 of 21 views in one
        run, all 21 in another), so copies of 4 MB and a pause come first."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.profiler = profile(activities=[ProfilerActivity.CUDA])
        self.profiler.start()
        for _ in range(8):  # below a view's size: counted among the small copies
            torch.ones(1 << 20).cuda()
        torch.cuda.synchronize()
        time.sleep(1.0)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        if self.profiler is not None and self.starts:  # the first sample's runs have ended
            self.profiler.stop()
            self.h2d_first_sample = h2d_copies(self.profiler)
            self.profiler = None
        self.starts.append(time.perf_counter())
        return self.dataset[index]


def phase_eval_run(counters, label, num_views, keyview_idx, height, width, num_samples, cut, dtype="float32"):
    """create_evaluation("mvd") with robust_mvd (full width, seeded weights,
    compute ``dtype``) over ``synthetic`` at a benchmark dataset's view count
    and image size, quasi-optimal ordering, uncertainty on, the first sample
    a burn-in sample. Each of the engine's model runs is noted with its
    runtimes and memory; K1's launches are counted over the whole evaluation
    (at bf16 all of them K1 v2's). The engine uploads each sample's views
    once (robust_mvd takes staged views): the burn-in sample's host-to-device
    copies of a view's size or more, counted by torch.profiler, must not
    exceed one upload of its views (a profiler that drops records can only
    count fewer; where it recorded none of them, the first sample alone is
    measured again in a new session, at most twice); the small copies of each
    run (poses, intrinsics, the resize's taps) are reported beside them."""
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.utils import numpy_collate

    tf32 = set_tf32(False)
    dataset = TimedDataset(rmvd.create_dataset("synthetic.train.mvd", num_samples=num_samples, num_views=num_views,
                                               keyview_idx=keyview_idx, height=height, width=width))
    model = rmvd.create_model("robust_mvd", seed=0, dtype=dtype)
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
    dataset.profile_first_sample()
    results = evaluation(dataset=dataset, model=model, qualitatives=0, burn_in_samples=1)
    end = time.perf_counter()
    launches = counters.read()
    # the profiler drops every large copy's record in some sessions (calls 7 and 10 of PR 17: none of the 21 or 11
    # uploads, while the runs' small copies were recorded): then the first sample alone is measured again, in a
    # new session and a new evaluation, at most twice
    view_bytes = 3 * height * width * 4
    h2d, h2d_sessions = dataset.h2d_first_sample, 1
    while not any(b >= view_bytes for b in h2d) and h2d_sessions < 3:
        again = TimedDataset(rmvd.create_dataset("synthetic.train.mvd", num_samples=1, num_views=num_views,
                                                 keyview_idx=keyview_idx, height=height, width=width))
        again.profile_first_sample()
        rmvd.create_evaluation("mvd", inputs=["poses", "intrinsics"], view_ordering="quasi-optimal",
                               eval_uncertainty=True, verbose=False)(dataset=again, model=model, qualitatives=0,
                                                                    burn_in_samples=0)
        again.profiler.stop()
        h2d, h2d_sessions = h2d_copies(again.profiler), h2d_sessions + 1
    k1 = launches["planesweep_sample"]
    if launches[f"planesweep_sample[{dtype}]"] != k1:
        raise AssertionError(f"{label}: K1 launches {launches}, expected all of them at {dtype}")
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
    image_copies = [b for b in h2d if b >= view_bytes]
    h2d_report = {"profiler_sessions": h2d_sessions, "image_bytes": sum(image_copies),
                  "image_copies": len(image_copies),
                  "views_once_bytes": num_views * view_bytes, "other_bytes": sum(h2d) - sum(image_copies),
                  "other_copies": len(h2d) - len(image_copies)}
    if not 0 < sum(image_copies) <= num_views * view_bytes:
        raise AssertionError(f"{label}: the burn-in sample's host-to-device copies of image size {h2d_report}: none "
                             f"recorded, or more than one upload of its {num_views} views of {view_bytes} bytes")
    host_share = [1 - sum(r[1] for r in per_sample[n]) / 1e3 / walls[n] for n in range(1, num_samples)]
    sweep_ms = {n: float(results[n]["runtime_model_in_msec"].iloc[1:].median()) for n in (1, sources // 2, sources)}
    emit(label, tf32=tf32, dtype=dtype, views=num_views, keyview_idx=keyview_idx, size=[height, width],
         model_input=[-(-height // 64) * 64, -(-width // 64) * 64], samples=num_samples, burn_in_samples=1, cut=cut,
         model_runs_per_sample=runs_per_sample, k1_launches_per_sample=k1 / num_samples,
         runtime_model_ms_median=statistics.median(r[1] for r in timed),
         runtime_model_and_io_ms_median=statistics.median(r[2] for r in timed),
         runtime_model_ms_by_source_views=sweep_ms,
         wall_s_per_sample=walls, wall_s_per_timed_sample_median=statistics.median(walls[1:]),
         host_share=host_share, host_share_in_adapters=adapters_share, h2d_per_sample=h2d_report,
         device_mem_peak_mib=max(r[3] for r in timed), all_views_forward=all_views,
         best_absrel=absrel.tolist(), best_num_views=results["best"]["num_views"].tolist())
    return {"k1_launches": k1, "k1_launches_per_sample": k1 / num_samples}


def phase_resize_parity():
    """The staged views' resize on the card (``utils/image.py::resize_bilinear_torch``)
    against the numpy resize on the host, for KITTI's 21 views at 375x1242 ->
    384x1280: the largest absolute difference (raises above 2^-16 x 255), and
    both resizes' times for the 21 views."""
    import torch

    from robustmvd_tpu_torch.utils.image import resize_bilinear, resize_bilinear_torch

    rng = np.random.RandomState(9)
    views = [(rng.rand(1, 3, 375, 1242) * 255).astype(np.float32) for _ in range(21)]
    staged = [torch.from_numpy(v).cuda() for v in views]
    size = (384, 1280)
    diff = max(float(np.abs(resize_bilinear_torch(x, size).cpu().numpy() - resize_bilinear(v, size)).max())
               for x, v in zip(staged, views))
    limit = 2.0**-16 * 255
    if diff > limit:
        raise AssertionError(f"resize on the card vs the host: max abs diff {diff} > {limit}")
    device_ms = time_ms(lambda: [resize_bilinear_torch(x, size) for x in staged], runs=10, warmup=2)
    t0 = time.perf_counter()
    for v in views:
        resize_bilinear(v, size)
    host_ms = (time.perf_counter() - t0) * 1e3
    emit("resize_parity", views=21, size=[375, 1242], model_input=list(size), max_abs_diff=diff, limit=limit,
         bit_equal=diff == 0, device_ms_21_views=device_ms, host_numpy_ms_21_views=host_ms)


# the native input size of each stub (wrapper_stubs.py): monodepth2's from its encoder checkpoint, MiDaS's
# 192x384 (its Resize keeps it), the rest a multiple of 64
WRAPPED_NATIVE = {"midas_big_v2_1_wrapped": (192, 384)}


def phase_wrapped():
    """The seven wrapped models on stub repositories (``tests/wrapper_stubs.py``:
    the real repositories' import layout and checkpoint naming, seeded
    weights; mvsnet_pl's checkpoint pickles Lightning-style hyper-parameter
    objects), pointed at through the wrappers module's ``PATHS_FILE``: each
    name built with ``create_model`` (the card), every parameter of its
    network on the card, ``model.run`` on a 1+2-view sample at its native
    size against the same wrapper built with ``device="cpu"`` (TF32 off, max
    |d| within 1e-5 of the mean |ref|), then 3 + 10 timed runs."""
    import torch

    import robustmvd_tpu_torch as rmvd
    import robustmvd_tpu_torch.models.wrappers.wrappers as wrappers
    from robustmvd_tpu_torch.utils import check_torch_model_cuda

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from wrapper_stubs import WRAPPED, isolated_imports, stub_sample, write_stub_repos

    tf32 = set_tf32(False)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths_file, wrappers.PATHS_FILE = wrappers.PATHS_FILE, write_stub_repos(tmp, seed=0, lightning_hparams=True)
        try:
            for name in WRAPPED:
                with isolated_imports():
                    card = rmvd.create_model(name)
                    cpu = rmvd.create_model(name, device="cpu")
                networks = [v for v in vars(card).values() if isinstance(v, torch.nn.Module)]
                on_card = [check_torch_model_cuda(net) for net in networks]  # raises where a network is split
                if card.device.type != "cuda" or not on_card or not all(on_card):
                    raise AssertionError(f"{name}: device {card.device}, networks on the card {on_card}")
                height, width = WRAPPED_NATIVE.get(name, (getattr(card, "height", 64), getattr(card, "width", 128)))
                sample = stub_sample(seed=3, height=height, width=width)
                ours, _ = card.run(**sample)
                ref, _ = cpu.run(**stub_sample(seed=3, height=height, width=width))
                errors = {}
                for key in ref:
                    if not (isinstance(ours[key], np.ndarray) and np.isfinite(ours[key]).all()):
                        raise AssertionError(f"{name}: {key} not a finite numpy array")
                    errors[key] = float(np.abs(ours[key] - ref[key]).max() / np.abs(ref[key]).mean())
                if max(errors.values()) > 1e-5:
                    raise AssertionError(f"{name}: card vs CPU {errors} > 1e-5")
                for _ in range(3):
                    card.run(**sample)
                times = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    card.run(**sample)  # ends in a device->host copy
                    times.append((time.perf_counter() - t0) * 1e3)
                report[name] = {"size": [height, width], "pred_shape": list(ours["depth"].shape),
                                "max_rel_err": errors, "ms_per_run": statistics.median(times),
                                "ms_per_run_min": min(times), "parameters": card.num_parameters()}
        finally:
            wrappers.PATHS_FILE = paths_file
    emit("wrapped", tf32=tf32, views=3, runs="3 + 10", note="stub networks of a few channels: times are the "
         "wrappers' host adapters and transfers, not the real networks'", **report)
    torch.cuda.empty_cache()


def phase_vis_rmvd_checkpoint(counters):
    """vis_mvsnet's seeded weights saved in the port's naming and in rmvd's
    (``models/weights.py::vis_state_dict_to_rmvd``), each loaded with
    ``create_model("vis_mvsnet", weights=...)`` and run on a 384x1280,
    1+2-view frame: the depths equal bit for bit, and the rmvd-named
    model's frame launches K5, K2 group and K3 30, 6 and 6 times."""
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.models.weights import RMVD_VIS_KEY, vis_state_dict_to_rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    sample = sideways_sample(np.random.RandomState(8), 384, 1280, 3)
    preds, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        state = {k: v.cpu() for k, v in rmvd.create_model("vis_mvsnet", seed=0).state_dict().items()}
        rmvd_state = vis_state_dict_to_rmvd(state)
        if RMVD_VIS_KEY not in rmvd_state:
            raise AssertionError("the rmvd-named state dict lacks its key")
        for naming, named in (("port", state), ("rmvd", rmvd_state)):
            path = os.path.join(tmp, f"{naming}.pt")
            torch.save({"model_state_dict": named}, path)
            model = rmvd.create_model("vis_mvsnet", weights=path)
            counters.reset()
            preds[naming], _ = model.run(**sample)
            launches[naming] = counters.read()
            del model
    torch.backends.cudnn.deterministic = False
    expected = {"conv3d_banded": 30, "sweep_group_cost": 6, "soft_argmin": 6}
    if {k: launches["rmvd"][k] for k in expected} != expected:
        raise AssertionError(f"vis_mvsnet from an rmvd checkpoint launched {launches['rmvd']}, expected {expected}")
    depth = preds["rmvd"]["depth"]
    if not (np.isfinite(depth).all() and np.array_equal(depth, preds["port"]["depth"])):
        raise AssertionError("vis_mvsnet from an rmvd checkpoint: depth not finite or not the port-named load's")
    emit("vis_rmvd_checkpoint", tf32=tf32, shape=[384, 1280], views=3, tensors=len(rmvd_state),
         renamed=sum(k not in state for k in rmvd_state), depth_bit_equal=True,
         uncertainty_bit_equal=bool(np.array_equal(preds["rmvd"]["depth_uncertainty"],
                                                   preds["port"]["depth_uncertainty"])),
         launches={k: launches["rmvd"][k] for k in expected})
    torch.cuda.empty_cache()
    return launches["rmvd"]


# --- training: K1b, card-vs-CPU parity of a recipe step, the recipe's main path ---


def k1b_inputs(device):
    """K1b's arguments at the recipe's shape: K1's taps for B = 4 key images
    of 48x96 features (384x768 crops), S = 256, from a real epipolar sweep
    (many taps coincide along it, some fall outside the image), and a random
    gradient of K1's output."""
    import torch

    _, y0, wy, x0, wx = k1_inputs(device, H=48, W=96)
    y0, wy, x0, wx = (a.repeat(4, 1).contiguous() for a in (y0, wy, x0, wx))
    grad = torch.randn(y0.shape, generator=torch.Generator(device=device).manual_seed(1), device=device)
    return grad, y0, wy, x0, wx, 48, 96


def k1b_bound(grad, Hs, Ws, out_bytes=4):
    """Least time for K1b: dS written once (``out_bytes`` per element: 4 in
    float32, 2 in bf16), the gradient and four tap arrays read once, against
    ~10 flops per sample."""
    P, S = grad.shape
    nbytes = P * Hs * Ws * out_bytes + P * S * 5 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = P * S * 10 / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel_k1b():
    """K1b against its plain version at the recipe's shape; the autograd
    Function's gradient on the card against the CPU's; the yardstick is
    grid_sample's input gradient for the same samples."""
    import torch

    from robustmvd_tpu_torch.ops.kernels.planesweep_sample import planesweep_sample_with_grad
    from robustmvd_tpu_torch.ops.kernels.planesweep_sample_backward import (
        planesweep_sample_backward,
        planesweep_sample_backward_reference,
        planesweep_sample_backward_route,
    )

    device = torch.device("cuda")
    grad, y0, wy, x0, wx, Hs, Ws = k1b_inputs(device)
    P, S = grad.shape
    out = planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws)
    torch.cuda.synchronize()
    ref = planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws)
    scale = float(ref.abs().max())
    limit = K1B_LIMIT * scale
    err = float((out - ref).abs().max())
    if not err <= limit:
        raise AssertionError(f"K1b disagrees with its plain version: max_abs_err {err} > {limit}")
    # the taps this gradient scatters: how many coincide and how many fall outside
    ty, tx = y0.long(), x0.long()
    inside = (ty >= 0) & (ty < Hs - 1) & (tx >= 0) & (tx < Ws - 1)
    flat = (torch.arange(P, device=device)[:, None] * Hs + ty) * Ws + tx
    distinct = int(torch.unique(flat[inside]).numel())
    taps = {"samples_all_taps_inside": int(inside.sum()), "samples_some_tap_outside": int((~inside).sum()),
            "distinct_top_left_taps_inside": distinct}
    if not (distinct < taps["samples_all_taps_inside"] and taps["samples_some_tap_outside"] > 0):
        raise AssertionError(f"K1b's inputs lack coinciding or out-of-range taps: {taps}")

    # the Function on the card vs on the CPU: K1 forward, K1b backward
    corr = torch.randn((P, Hs, Ws), generator=torch.Generator(device=device).manual_seed(2), device=device)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaf = corr.to(dev).clone().requires_grad_()
        planesweep_sample_with_grad(leaf, *(a.to(dev) for a in (y0, wy, x0, wx))).backward(grad.to(dev))
        grads[dev] = leaf.grad
    function_err = float((grads["cuda"].cpu() - grads["cpu"]).abs().max())
    if not function_err <= limit:
        raise AssertionError(f"K1's Function gradient, card vs CPU: max_abs_err {function_err} > {limit}")

    # yardstick: grid_sample's input gradient for the same samples (N = P, one channel, S points)
    gx = (2.0 * (x0.float() + wx) + 1.0) / Ws - 1.0
    gy = (2.0 * (y0.float() + wy) + 1.0) / Hs - 1.0
    grid = torch.stack([gx, gy], -1)[:, None]  # (P, 1, S, 2)
    img = corr[:, None]
    g4 = grad[:, None, None]

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(g4, img, grid, 0, 0, False, [True, False])[0]

    lib_diff = float((library()[:, 0] - out).abs().max())
    result = {
        "max_abs_err": err, "limit": limit, "grad_scale": scale, "function_card_vs_cpu_max_abs_err": function_err,
        "route": planesweep_sample_backward_route(Hs, Ws),
        "ms": time_ms(lambda: planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws)),
        "plain_ms": time_ms(lambda: planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws), runs=10),
        "library_ms": time_ms(library), "library_max_abs_diff": lib_diff, **taps, **k1b_bound(grad, Hs, Ws),
    }
    result["bf16"] = kernel_k1b_bf16(grad, y0, wy, x0, wx, Hs, Ws, corr, grid)
    emit("kernel_k1b", name="planesweep_sample_backward", shape={"P": P, "Hs": Hs, "Ws": Ws, "S": S}, **result)
    torch.cuda.empty_cache()
    return result


def kernel_k1b_bf16(grad, y0, wy, x0, wx, Hs, Ws, corr, grid):
    """K1b's bf16 form (the backward of K1 v2) on the same inputs: held
    against its plain version within one bf16 step of the largest |dS|
    (K1B_BF16_LIMIT), timed beside the float32 form followed by a cast, and
    beside grid_sample's input gradient at bf16 (bf16 image, grid and
    gradient, so its sample positions round to bf16 too: the diff is reported,
    not held); the bound counts the bf16 store."""
    import torch

    from robustmvd_tpu_torch.ops.kernels.planesweep_sample_backward import (
        planesweep_sample_backward,
        planesweep_sample_backward_reference,
    )

    bf16 = torch.bfloat16
    out = planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws, dtype=bf16)
    torch.cuda.synchronize()
    ref = planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws, dtype=bf16)
    scale = float(ref.float().abs().max())
    limit = K1B_BF16_LIMIT * scale
    err = float((out.float() - ref.float()).abs().max())
    if out.dtype != bf16 or not err <= limit:
        raise AssertionError(f"K1b bf16 disagrees with its plain version: {out.dtype}, max_abs_err {err} > {limit}")
    img16, grid16, g16 = corr.to(bf16)[:, None], grid.to(bf16), grad.to(bf16)[:, None, None]

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(g16, img16, grid16, 0, 0, False, [True, False])[0]

    return {
        "max_abs_err": err, "limit": limit, "grad_scale": scale,
        "ms": time_ms(lambda: planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws, dtype=bf16)),
        "f32_then_cast_ms": time_ms(lambda: planesweep_sample_backward(grad, y0, wy, x0, wx, Hs, Ws).to(bf16)),
        "plain_ms": time_ms(lambda: planesweep_sample_backward_reference(grad, y0, wy, x0, wx, Hs, Ws, dtype=bf16),
                            runs=10),
        "library_ms": time_ms(library),
        "library_max_abs_diff": float((library()[:, 0].float() - out.float()).abs().max()),
        **k1b_bound(grad, Hs, Ws, out_bytes=2),
    }


def train_batch(rng, B, V, H, W):
    """A recipe batch as the engine feeds the model: images normalised to
    [-0.4, 0.6], relative intrinsics, key->source poses with small rotations
    and a lateral baseline, and inverse depth ground truth with holes."""
    images = rng.rand(B, V, 3, H, W).astype(np.float32) - 0.4
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (B, V, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for v in range(1, V):
        angle = rng.randn(3) * 0.05
        c, s = np.cos(angle), np.sin(angle)
        poses[:, v, :3, :3] = (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
                               @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
                               @ np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]]))
        poses[:, v, :3, 3] = [0.1 * v, 0.02 * rng.randn(), 0.02 * rng.randn()]
    invdepth = (1.0 / (rng.rand(B, 1, H, W) * 8.0 + 2.0)).astype(np.float32)
    invdepth[:, :, ::7, ::5] = 0.0
    return ({"images": images, "poses": poses, "intrinsics": K, "keyview_idx": np.zeros(B, np.int64)},
            {"invdepth": invdepth})


def recipe_engine(out_dir, model, dataset, max_iterations, batch_size, num_workers=0, **kwargs):
    """The recipe (train_all.sh:8-18) through create_training: adam 1e-4,
    flownet_scheduler, clip 5, robust_mvd_loss, robust_mvd_batch_augmentations
    (``kwargs``: the engine's other arguments, as log_interval)."""
    import robustmvd_tpu_torch as rmvd

    optimizer = rmvd.create_optimizer("adam", model=model, lr=1e-4)
    return rmvd.create_training(
        "mvd", out_dir=out_dir, model=model, dataset=dataset, optimizer=optimizer,
        scheduler=rmvd.create_scheduler("flownet_scheduler", optimizer=optimizer),
        loss=rmvd.create_loss("robust_mvd_loss", model=model), batch_size=batch_size,
        max_iterations=max_iterations, inputs=["poses", "intrinsics"],
        batch_augmentations="robust_mvd_batch_augmentations", grad_clip_max_norm=5.0, num_workers=num_workers,
        verbose=False, **kwargs)


def grad_errors(ours, ref):
    """Per parameter, max |d| against the bound of tests/test_gradient_parity.py:
    rtol 2e-3 and atol max(2e-3 x the leaf's max |g|, 1e-4 x the largest max |g|)."""
    global_scale = max(float(r.abs().max()) for r in ref.values()) + 1e-12
    worst, failed = {}, []
    for name, r in ref.items():
        o = ours[name]
        atol = max(2e-3 * (float(r.abs().max()) + 1e-12), 1e-4 * global_scale)
        excess = float(((o - r).abs() - (atol + 2e-3 * r.abs())).max())
        worst[name] = float((o - r).abs().max())
        if excess > 0:
            failed.append(name)
    return worst, failed


def phase_train_parity(counters):
    """One recipe step (the engine's train_step: forward, loss, backward,
    clip, adam, schedule) of full-width robust_mvd on the card vs on the CPU:
    same seeded weights and batch, B = 1, 1+2 views, 64x128, TF32 off, cuDNN
    deterministic; loss, gradients and the parameters after the update, at
    iteration 0 (MAE) and 2000 (Laplacian NLL)."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    inputs, gt = train_batch(np.random.RandomState(3), 1, 3, 64, 128)
    lr = 1e-4
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=1, num_views=3, height=64, width=128)
        for iteration in (0, 2000):
            steps = {}
            for device in ("cpu", "cuda"):
                model = rmvd.create_model("robust_mvd", device=device, seed=0, train=True)
                training = recipe_engine(os.path.join(tmp, f"{device}_{iteration}"), model, dataset, 1, 1)
                training.finished_iterations = iteration
                before = {n: p.detach().clone() for n, p in model.named_parameters()}
                counters.reset()
                loss, _ = training.train_step({k: torch.from_numpy(v).to(device) for k, v in inputs.items()},
                                              {k: torch.from_numpy(v).to(device) for k, v in gt.items()})
                steps[device] = {"loss": float(loss), "launches": counters.read(),
                                 "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                                 "before": {n: v.cpu() for n, v in before.items()},
                                 "after": {n: p.detach().cpu() for n, p in model.named_parameters()}}
                del model, training
            card, cpu = steps["cuda"], steps["cpu"]
            loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
            if not loss_rel <= 1e-4:
                raise AssertionError(f"train step at {iteration}: loss card {card['loss']} vs CPU {cpu['loss']}")
            worst, failed = grad_errors(card["grads"], cpu["grads"])
            if failed:
                raise AssertionError(f"train step at {iteration}: gradients off the bound at {failed}")
            # Adam's first step moves p by lr g / (|g| + eps): a gradient difference d moves it by at most
            # lr min(2, 2 |d| / (|g| + eps)); plus float32 rounding of p
            update_excess = []
            for name, g in cpu["grads"].items():
                d = (card["grads"][name] - g).abs()
                tol = 1e-6 * cpu["before"][name].abs() + lr * (1e-4 + torch.clamp(2 * d / (g.abs() + 1e-8), max=2.0))
                update_excess.append(float(((card["after"][name] - cpu["after"][name]).abs() - tol).max()))
            if max(update_excess) > 0:
                raise AssertionError(f"train step at {iteration}: parameters after the update off by "
                                     f"{max(update_excess)} beyond their bound")
            moved = sum(int((cpu["after"][n] != cpu["before"][n]).sum()) for n in cpu["before"])
            if card["launches"]["planesweep_sample"] != 2 or card["launches"]["planesweep_sample_backward"] != 2:
                raise AssertionError(f"train step on the card launched {card['launches']}, expected K1 and K1b twice")
            results[iteration] = {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_rel,
                                  "grad_max_abs_err_worst": max(worst.values()),
                                  "grad_max_abs_err_worst_param": max(worst, key=worst.get),
                                  "update_excess_max": max(update_excess), "params_moved": moved,
                                  "launches_card": {k: v for k, v in card["launches"].items() if v}}
    torch.backends.cudnn.deterministic = False
    if results[0]["loss_cpu"] == results[2000]["loss_cpu"]:
        raise AssertionError("iterations 0 and 2000 gave one loss: the NLL branch was not taken")
    emit("train_parity", tf32=tf32, batch=1, views=3, shape=[64, 128], lr=lr, steps=results)
    torch.cuda.empty_cache()


def train_kernel_kind(name):
    """Group a training step's kernels: K1b, K1, K5 (and its bf16 form), K3,
    cuDNN's convolutions forward (fprop), backward (dgrad, wgrad) and FFT
    (either direction), GEMMs outside cuDNN (the score matmul and its
    backward), the optimizer, the rest."""
    if "planesweep_sample_backward" in name:
        return "k1b_planesweep_sample_backward"
    if "planesweep_sample" in name:
        return "k1_planesweep_sample"
    if "conv3d_k3_bf16_kernel" in name:
        return "k5_conv3d_banded_bf16"
    if "conv3d_k3_kernel" in name:
        return "k5_conv3d_banded"
    if "soft_argmin_" in name:
        return "k3_soft_argmin"
    if any(key in name for key in FFT_KERNEL_KEYS):
        return "convolutions_fft"
    if "dgrad" in name or "wgrad" in name:
        return "convolutions_backward"
    if any(key in name for key in ("fprop", "convolve", "cudnn")):
        return "convolutions_forward"
    if "gemm" in name:
        return "gemm"
    if "multi_tensor_apply" in name or "adam" in name.lower():
        return "optimizer"
    if "HtoD" in name or "DtoH" in name:
        return "memcpy"
    return "other"


def phase_train_main(counters):
    """The recipe through create_training on the card: synthetic.train.mvd
    with 5 views at StaticThings3D's raw 540x960, its augmentations (384x768
    crops), the batch augmentations, batch 4, fp32, TF32 off; 3 warm-up and
    10 timed steps, then a resume from the final snapshot and one more step;
    a profile of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    warmup, timed, batch = 3, 10, 4
    workers = min(8, os.cpu_count() or 1)
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=4 * batch * (warmup + timed), num_views=5,
                                  height=540, width=960, augmentations="robust_mvd_augmentations_staticthings3d")
    np.random.seed(42)
    torch.manual_seed(42)
    with tempfile.TemporaryDirectory() as out_dir:
        model = rmvd.create_model("robust_mvd", seed=0, train=True)
        training = recipe_engine(out_dir, model, dataset, warmup + timed, batch, num_workers=workers)
        step = training.train_step
        notes = []

        def noted_step(sample_inputs, sample_gt):
            if len(notes) == warmup:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            loss, sub_losses = step(sample_inputs, sample_gt)
            end.record()
            notes.append((t0, start, end, loss))
            if len(notes) == warmup + timed:  # the last step ends on the card, before the final snapshots
                torch.cuda.synchronize()
                notes.append(time.perf_counter())
            return loss, sub_losses

        training.train_step = noted_step
        counters.reset()
        t_start = time.perf_counter()
        training()
        launches = counters.read()
        t_end = notes.pop()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        losses = [float(n[3]) for n in notes]
        if len(notes) != warmup + timed or not all(np.isfinite(losses)):
            raise AssertionError(f"train_main: {len(notes)} steps, losses {losses}")
        per_step = {"planesweep_sample": launches["planesweep_sample"] / len(notes),
                    "planesweep_sample_backward": launches["planesweep_sample_backward"] / len(notes)}
        if per_step != {"planesweep_sample": 4.0, "planesweep_sample_backward": 4.0}:
            raise AssertionError(f"train_main: launches {launches} in {len(notes)} steps, expected 4 K1 and 4 K1b "
                                 "per step (4 source views)")
        starts = [n[0] for n in notes] + [t_end]
        walls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])][warmup:]
        device_ms = [n[1].elapsed_time(n[2]) for n in notes][warmup:]
        host_share = [1 - d / w for d, w in zip(device_ms, walls)]
        snaps = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
        if snaps != [f"snapshot-iter-{warmup + timed:09d}.pt"]:
            raise AssertionError(f"train_main: snapshots {snaps}")

        # resume: a new model and engine pick up the snapshot and take one more step
        t0 = time.perf_counter()
        model2 = rmvd.create_model("robust_mvd", seed=1, train=True)
        resumed = recipe_engine(out_dir, model2, dataset, warmup + timed + 1, batch, num_workers=workers)
        resume_s = time.perf_counter() - t0
        if resumed.finished_iterations != warmup + timed or any(
                not torch.equal(p, q) for p, q in zip(model.state_dict().values(), model2.state_dict().values())):
            raise AssertionError("train_main: the resumed engine did not restore the snapshot")
        resumed_losses = []
        resumed_step = resumed.train_step

        def kept_step(sample_inputs, sample_gt):
            loss, sub_losses = resumed_step(sample_inputs, sample_gt)
            resumed_losses.append(float(loss))
            return loss, sub_losses

        resumed.train_step = kept_step
        if resumed()["iteration"] != warmup + timed + 1 or not np.isfinite(resumed_losses).all():
            raise AssertionError(f"train_main: the resumed step gave {resumed_losses}")

        # one step under the profiler, on a batch prepared before it
        inputs, gt = training.prepare_batch(rmvd.utils.numpy_collate([dataset[i] for i in range(batch)]))
        torch.cuda.synchronize()
        for _ in range(2):  # the first profile pays the tracer's start-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(inputs, gt)
                torch.cuda.synchronize()
                profiled_ms = (time.perf_counter() - t0) * 1e3
        del model, model2, training, resumed
    breakdown = step_breakdown(prof, profiled_ms)
    result = {"ms_per_step": statistics.median(walls), "ms_per_step_mean": statistics.mean(walls),
              "ms_per_step_min": min(walls), "ms_per_timed_step": walls, "device_ms_per_timed_step": device_ms,
              "device_ms_per_step": statistics.median(device_ms),
              "host_share": statistics.median(host_share), "peak_mib": peak_mib, "launches": launches,
              "launches_per_step": per_step, "losses": losses, "resumed_losses": resumed_losses,
              "resume_s": resume_s, "wall_s_to_last_step": t_end - t_start}
    emit("train_main", tf32=tf32, dataset="synthetic.train.mvd", raw_size=[540, 960], crop=[384, 768], views=5,
         batch=batch, warmup=warmup, timed=timed, workers=workers, dtype="float32", **result)
    emit("breakdown_train", **breakdown)
    torch.cuda.empty_cache()
    return result


def step_breakdown(prof, step_ms):
    """A profiled training step's device time by kernel kind (train_kernel_kind)."""
    import torch

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    by_kind = {}
    for name, ms, _ in rows:
        by_kind[train_kernel_kind(name)] = by_kind.get(train_kernel_kind(name), 0.0) + ms
    device_total = sum(r[1] for r in rows)
    return {"step_ms": step_ms, "device_ms": device_total, "device_busy_share": device_total / step_ms,
            "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
            "top": [{"name": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:20]]}


# --- the recipe at bf16 over the StaticThings3D + BlendedMVS readers ---

RECIPE_DATASETS = ("staticthings3d.robust_mvd.mvd", "blendedmvs.robust_mvd.mvd")


def write_float3(path, arr):
    """lmb-freiburg .float3: "float", the rank, the dims minor to major, raw float32."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"float\n{arr.ndim}\n".encode() + "".join(f"{d}\n" for d in reversed(arr.shape)).encode())
        f.write(arr.astype(np.float32).tobytes())


def write_pfm(path, arr):
    """Little-endian grayscale PFM, rows bottom-up."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode() + np.flipud(arr).astype("<f4").tobytes())


def write_image(path, rng, height, width):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((rng.rand(height, width, 3) * 255).astype(np.uint8)).save(path)


def write_recipe_tree(root, rng):
    """Raw-format trees of the recipe's two training datasets, at their raw
    sizes, for their readers: one StaticThings3D sequence (``TRAIN/A/0000``)
    of 22 frames at 540x960 (png, float3 depth, K and pose), enough for key
    frames 6..15 with every source offset within +-6; one BlendedMVS training
    scene of 11 views at 576x768 (masked jpg, MVSNet cam file, PFM depth,
    pair.txt with 10 sources per key). Random images, depths inside the
    augmentations' range, cameras along a line. Returns both roots."""
    from robustmvd_tpu_torch.data.blendedmvs import BMVS_TRAIN_SCENES

    seq = os.path.join(root, "staticthings3d", "TRAIN", "A", "0000")
    K = np.array([[1050.0, 0, 479.5], [0, 1050.0, 269.5], [0, 0, 1]], np.float32)
    for fn in range(22):
        write_image(os.path.join(seq, "frames_cleanpass", "left", f"{fn:04d}.png"), rng, 540, 960)
        write_float3(os.path.join(seq, "depths", "left", f"{fn:04d}.float3"), rng.rand(540, 960) * 28 + 2)
        write_float3(os.path.join(seq, "intrinsics", "left", f"{fn:04d}.float3"), K)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.05 * fn, 0.01 * rng.randn(), 0.01 * rng.randn()]
        write_float3(os.path.join(seq, "poses", "left", f"{fn:04d}.float3"), pose)
    scene = os.path.join(root, "blendedmvs", BMVS_TRAIN_SCENES[0])
    views = 11
    for v in range(views):
        write_image(os.path.join(scene, "blended_images", f"{v:08d}_masked.jpg"), rng, 576, 768)
        write_pfm(os.path.join(scene, "rendered_depth_maps", f"{v:08d}.pfm"),
                  (rng.rand(576, 768) * 2 + 1).astype(np.float32))
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * v, 0.0, 0.0]
        lines = ["extrinsic", *(" ".join(f"{x:.6f}" for x in row) for row in pose), "", "intrinsic",
                 "600.0 0.0 384.0", "0.0 600.0 288.0", "0.0 0.0 1.0", "", "1.0 0.01 192 3.0", ""]
        os.makedirs(os.path.join(scene, "cams"), exist_ok=True)
        with open(os.path.join(scene, "cams", f"{v:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines))
    with open(os.path.join(scene, "cams", "pair.txt"), "w") as f:
        f.write(f"{views}\n")
        for v in range(views):
            sources = [u for u in range(views) if u != v]
            f.write(f"{v}\n{len(sources)} " + " ".join(f"{u} {10.0 - abs(u - v):.1f}" for u in sources) + "\n")
    return os.path.join(root, "staticthings3d", "TRAIN"), os.path.join(root, "blendedmvs")


def phase_train_bf16(counters, fp32):
    """The paper recipe at bf16 as ``train_all.sh`` scripts it, through the
    train CLI's code path (``robustmvd_tpu_torch.train.cli.main``): the
    ``staticthings3d.robust_mvd.mvd`` + ``blendedmvs.robust_mvd.mvd`` compound
    (one ``--dataset`` flag with two values), each with its augmentations
    (384x768 crops), the batch augmentations, adam 1e-4, flownet_scheduler,
    clip 5, robust_mvd_loss, batch 4, 8 loader workers, over a tree written at
    the datasets' raw sizes (write_recipe_tree; the roots through the user's
    paths file, the generated sample lists into the temporary directory).
    3 warm-up and 5 timed steps: ms per step, CUDA-event ms, host share, peak
    MiB, every loss finite, K1 v2 and K1b's bf16 form 4 times per step; then
    two more steps under the profiler (the first pays its start-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import robustmvd_tpu_torch.data.blendedmvs as bmvs_module
    import robustmvd_tpu_torch.data.dataset as dataset_module
    import robustmvd_tpu_torch.data.staticthings3d as st3d_module
    import robustmvd_tpu_torch.utils.paths as paths
    from robustmvd_tpu_torch.train.cli import main as train_main
    from robustmvd_tpu_torch.train.multi_view_depth_training import MultiViewDepthTraining

    tf32 = set_tf32(False)
    warmup, timed, profiled, batch = 3, 5, 2, 4
    workers = min(8, os.cpu_count() or 1)
    notes, profiles = [], []
    step = MultiViewDepthTraining.train_step

    def noted_step(self, sample_inputs, sample_gt):
        if len(notes) == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if len(notes) >= warmup + timed:  # the profiled steps, after the timed ones
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                loss, sub_losses = step(self, sample_inputs, sample_gt)
                torch.cuda.synchronize()
            profiles.append((prof, (time.perf_counter() - t0) * 1e3))
            notes.append((None, None, None, loss))
            return loss, sub_losses
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, sub_losses = step(self, sample_inputs, sample_gt)
        end.record()
        notes.append((t0, start, end, loss))
        if len(notes) == warmup + timed:
            torch.cuda.synchronize()
            notes.append(time.perf_counter())
        return loss, sub_losses

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        st3d_root, bmvs_root = write_recipe_tree(tmp, np.random.RandomState(11))
        tree_s = time.perf_counter() - t0
        paths_file = os.path.join(tmp, "rmvd_data_paths.toml")
        with open(paths_file, "w") as f:
            f.write(f'[staticthings3d.train]\nroot = "{st3d_root}"\n\n[blendedmvs]\nroot = "{bmvs_root}"\n')
        lists = os.path.join(tmp, "sample_lists")
        os.makedirs(lists)
        original = dataset_module._sample_list_path

        def redirect(name):
            return os.path.join(lists, f"{name}.pickle") if name in RECIPE_DATASETS else original(name)

        saved = (paths.USER_PATHS_FILE, st3d_module._sample_list_path, bmvs_module._sample_list_path)
        out = os.path.join(tmp, "out")
        try:
            paths.USER_PATHS_FILE = type(saved[0])(paths_file)
            dataset_module._sample_list_path = st3d_module._sample_list_path = redirect
            bmvs_module._sample_list_path = redirect
            MultiViewDepthTraining.train_step = noted_step
            counters.reset()
            t_start = time.perf_counter()
            train_main(["--training_type", "mvd", "--output", out, "--model", "robust_mvd", "--dtype", "bfloat16",
                        "--inputs", "poses", "intrinsics", "--optimizer", "adam", "--lr", "1e-4",
                        "--grad_clip_max_norm", "5", "--scheduler", "flownet_scheduler", "--loss", "robust_mvd_loss",
                        "--batch_size", str(batch), "--max_iterations", str(warmup + timed + profiled),
                        "--dataset", *RECIPE_DATASETS,
                        "--augmentations_per_dataset", "robust_mvd_augmentations_staticthings3d",
                        "robust_mvd_augmentations_blendedmvs",
                        "--batch_augmentations", "robust_mvd_batch_augmentations", "--num_workers", str(workers)])
            launches = counters.read()
        finally:
            paths.USER_PATHS_FILE = saved[0]
            dataset_module._sample_list_path = original
            st3d_module._sample_list_path, bmvs_module._sample_list_path = saved[1:]
            MultiViewDepthTraining.train_step = step
        with open(os.path.join(out, "log.txt")) as f:
            dataset_line = next(line.strip() for line in f if "Dataset:" in line)
        snaps = sorted(os.listdir(os.path.join(out, "checkpoints")))
        # the CLI writes TensorBoard where it imports: iteration 0's logging forward then launches K1 v2 4 times
        logging_forwards = int(any(f.startswith("events.out.tfevents") for f in os.listdir(out)))
    steps = warmup + timed + profiled
    t_end = notes.pop(warmup + timed)
    losses = [float(n[3]) for n in notes]
    if len(notes) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train_bf16: {len(notes)} steps, losses {losses}")
    if snaps != [f"snapshot-iter-{steps:09d}.pt"] or "+" not in dataset_line:
        raise AssertionError(f"train_bf16: snapshots {snaps}, {dataset_line}")
    per_step = {name: (launches[name] - (4 * logging_forwards if name == "planesweep_sample[bfloat16]" else 0)) / steps
                for name in ("planesweep_sample[bfloat16]", "planesweep_sample[float32]",
                             "planesweep_sample_backward[bfloat16]", "planesweep_sample_backward[float32]")}
    if per_step != {"planesweep_sample[bfloat16]": 4.0, "planesweep_sample[float32]": 0.0,
                    "planesweep_sample_backward[bfloat16]": 4.0, "planesweep_sample_backward[float32]": 0.0}:
        raise AssertionError(f"train_bf16: launches {launches} in {steps} steps, expected 4 K1 v2 and 4 K1b bf16 "
                             "per step (4 source views) and no float32 form")
    timed_notes = notes[:warmup + timed]
    starts = [n[0] for n in timed_notes] + [t_end]
    all_walls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    all_device_ms = [n[1].elapsed_time(n[2]) for n in timed_notes]
    walls, device_ms = all_walls[warmup:], all_device_ms[warmup:]
    result = {"ms_per_step": statistics.median(walls), "ms_per_step_mean": statistics.mean(walls),
              "ms_per_step_min": min(walls), "ms_per_timed_step": walls, "device_ms_per_timed_step": device_ms,
              "device_ms_per_step": statistics.median(device_ms),
              "host_share": statistics.median(1 - d / w for d, w in zip(device_ms, walls)),
              "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "launches": launches,
              "launches_per_step": per_step, "losses": losses, "wall_s_to_last_step": t_end - t_start,
              # the CLI's set-up and the loader's first batch, then the warm-up steps (the first one pays
              # the bf16 kernels' first use while the loader's workers load the CPU)
              "s_to_first_step": timed_notes[0][0] - t_start, "warmup_ms_per_step": all_walls[:warmup],
              "warmup_device_ms_per_step": all_device_ms[:warmup], "tree_s": tree_s, "dataset": dataset_line,
              "logging_forwards": logging_forwards}
    fp32_side = {k: fp32[k] for k in ("ms_per_step", "device_ms_per_step", "host_share", "peak_mib")}
    emit("train_bf16", tf32=tf32, datasets=RECIPE_DATASETS, raw_sizes={"staticthings3d": [540, 960],
                                                                      "blendedmvs": [576, 768]},
         crop=[384, 768], views=5, batch=batch, warmup=warmup, timed=timed, workers=workers, dtype="bfloat16",
         cut="steps: 3 + 5 (+ 2 profiled); one StaticThings3D sequence and one BlendedMVS scene of random data",
         fp32_train_main=fp32_side, **result)
    emit("breakdown_train_bf16", **step_breakdown(*profiles[-1]))
    torch.cuda.empty_cache()
    return result


# --- the MVSNet family's training: K3's gradient, vis_mvsnet's steps, mvsnet_train and cvp_mvsnet ---

K3_GRAD_SHAPES = ((2, 64, 32, 40), (2, 32, 64, 80), (2, 16, 128, 160))  # vis's readouts at 256x320, batch 2
# K3's gradient (the kernel forward, the closed-form backward) vs autograd through its plain version, relative
# to the gradient's largest |value|: the kernel's prob differs from the plain version's by up to 1e-6
K3_GRAD_LIMIT = 1e-4
VIS_TRAIN_LAUNCHES = {"conv3d_banded": 45, "soft_argmin": 9}  # per step, 1+2 views: pairs one at a time
VIS_TRAIN_LAUNCHES_BF16 = {"conv3d_banded[bfloat16]": 36, "conv3d_banded[float32]": 9, "soft_argmin": 9}


def k3_backward_bound(volume):
    """Least time for K3's backward: prob read once, the three upstream maps
    and the expectation read once, the score gradient written once, at the
    HBM rate; against ~12 flops per element (log counted as one) at the f32
    rate."""
    B, D, H, W = volume.shape
    nbytes = 2 * volume.numel() * 4 + 4 * B * H * W * 4
    flops = 12 * volume.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_kernel_k3_grad(device="cuda"):
    """K3's autograd gradient at vis's training readouts (256x320, batch 2):
    the kernel's forward and the closed-form backward against autograd through
    the plain version, random upstream gradients of the expectation, the
    entropy and (``mass``) the window mass, window 2; within K3_GRAD_LIMIT of
    the gradient's largest |value|, pixels whose window mask differs between
    the two expectations left out (at most FLIPPED_SHARE). Times: the forward,
    the backward alone (``soft_argmin_backward`` on the saved results), and
    the plain version's forward + backward."""
    import torch

    from robustmvd_tpu_torch.ops.kernels.soft_argmin import (
        fused_soft_argmin,
        fused_soft_argmin_reference,
        soft_argmin_backward,
    )

    gen = torch.Generator(device=device).manual_seed(12)
    results = {}
    for shape in K3_GRAD_SHAPES:
        B, D, H, W = shape
        vol = torch.randn(shape, generator=gen, device=device) * 3
        gs = [torch.randn((B, 1, H, W), generator=gen, device=device) for _ in range(3)]
        for mass in (False, True):
            grads, outs = [], []
            for fn in (fused_soft_argmin, fused_soft_argmin_reference):
                leaf = vol.clone().requires_grad_()
                out = fn(leaf, window=2)
                terms = [out[1], out[2]] + ([out[3]] if mass else [])
                torch.autograd.backward(terms, gs[:len(terms)])
                grads.append(leaf.grad)
                outs.append([o.detach() for o in out])
            index = torch.arange(D, device=device, dtype=torch.float32).reshape(1, D, 1, 1)
            keep = torch.ones((B, 1, H, W), dtype=torch.bool, device=device)
            if mass:
                keep = ((torch.abs(index - outs[0][1]) <= 2) == (torch.abs(index - outs[1][1]) <= 2)).all(1, True)
            flipped = 1.0 - float(keep.float().mean())
            err = float(((grads[0] - grads[1]).abs() * keep).max())
            scale = float(grads[1].abs().max())
            if not (err <= K3_GRAD_LIMIT * scale and flipped <= FLIPPED_SHARE and torch.isfinite(grads[0]).all()):
                raise AssertionError(f"K3's gradient at {shape} (mass {mass}) is off its plain version's by {err} "
                                     f"(max |grad| {scale}), mask flipped on {flipped} of the pixels")
            prob, expectation = outs[0][0], outs[0][1]
            upstream = (None, gs[0], gs[1], gs[2] if mass else None)

            def plain_step():
                leaf = vol.clone().requires_grad_()
                out = fused_soft_argmin_reference(leaf, window=2)
                terms = [out[1], out[2]] + ([out[3]] if mass else [])
                torch.autograd.backward(terms, gs[:len(terms)])

            results[f"{'x'.join(map(str, shape))}{'_mass' if mass else ''}"] = {
                "shape": list(shape), "mass": mass, "max_abs_err": err, "grad_max_abs": scale,
                "limit": K3_GRAD_LIMIT * scale, "flipped_share": flipped,
                "forward_ms": time_ms(lambda: fused_soft_argmin(vol, window=2)) if device == "cuda" else None,
                "backward_ms": time_ms(lambda: soft_argmin_backward(prob, expectation, 2.0, *upstream))
                if device == "cuda" else None,
                "plain_forward_backward_ms": time_ms(plain_step, runs=10, warmup=2) if device == "cuda" else None,
                **k3_backward_bound(vol),
            }
    emit("kernel_k3_grad", **results)
    return results


def family_engine(out_dir, model, dataset, loss, max_iterations, batch_size, num_workers=0, lr=1e-3, **kwargs):
    """The family's training through create_training, as the JAX bench trains
    vis_mvsnet (bench.py:257-340): adam lr 1e-3, mvsnet_scheduler, no clip
    (``kwargs``: the engine's other arguments, as mesh)."""
    import robustmvd_tpu_torch as rmvd

    optimizer = rmvd.create_optimizer("adam", model=model, lr=lr)
    return rmvd.create_training(
        "mvd", out_dir=out_dir, model=model, dataset=dataset, optimizer=optimizer,
        scheduler=rmvd.create_scheduler("mvsnet_scheduler", optimizer=optimizer),
        loss=rmvd.create_loss(loss, model=model), batch_size=batch_size, max_iterations=max_iterations,
        num_workers=num_workers, verbose=False, **kwargs)


def running_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running" in k}


def timed_steps(step, warmup, timed, notes):
    """``step`` wrapped to note each call: host clock, CUDA events, loss; the
    peak memory reset after the warm-up; the card synchronised after the last
    timed step, whose end time is noted too."""
    import torch

    def noted_step(*args):
        if len(notes) == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, sub_losses = step(*args)
        end.record()
        notes.append((t0, start, end, loss))
        if len(notes) == warmup + timed:
            torch.cuda.synchronize()
            notes.append(time.perf_counter())
        return loss, sub_losses

    return noted_step


def step_times(notes, warmup):
    """(walls, device ms) of the timed steps from ``timed_steps``' notes."""
    t_end = notes.pop()
    starts = [n[0] for n in notes] + [t_end]
    walls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])][warmup:]
    return walls, [n[1].elapsed_time(n[2]) for n in notes][warmup:]


def check_family_launches(label, launches, steps, expected):
    per_step = {name: launches[name] / steps for name in expected}
    others = {k: v for k, v in launches.items() if v and k.split("[")[0] not in {n.split("[")[0] for n in expected}}
    if per_step != expected or others:
        raise AssertionError(f"{label}: launches {launches} in {steps} steps, expected {expected} per step and no "
                             "other kernel")
    return per_step


def phase_train_vis(counters, size=(256, 320), warmup=3, timed=10):
    """vis_mvsnet's training as the JAX bench configures it (bench.py:257-340:
    batch 2, 1+2 views, 256x320, adam 1e-3, mvsnet_scheduler,
    vismvsnet_loss), at fp32 with TF32 off, through create_training on
    ``synthetic.train.mvd``: BatchNorm on batch statistics, the pairs one at a
    time, the "xla" warp route; 3 warm-up and 10 timed steps (ms per step,
    host share, peak MiB, K5 and K3 launches per step, every loss finite),
    the running statistics moved, every parameter upstream of the readouts
    with a gradient, a resume from the final snapshot and one more step, a
    profile of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    batch = 2
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=batch * (warmup + timed), num_views=3,
                                  height=size[0], width=size[1])
    torch.manual_seed(42)
    with tempfile.TemporaryDirectory() as out_dir:
        model = rmvd.create_model("vis_mvsnet", seed=0, train=True)
        initial = running_stats(model)
        training = family_engine(out_dir, model, dataset, "vismvsnet_loss", warmup + timed, batch)
        step = training.train_step
        notes = []
        training.train_step = timed_steps(step, warmup, timed, notes)
        counters.reset()
        training()
        launches = counters.read()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        losses = [float(n[3]) for n in notes[:-1]]
        if len(losses) != warmup + timed or not all(np.isfinite(losses)):
            raise AssertionError(f"train_vis: {len(losses)} steps, losses {losses}")
        per_step = check_family_launches("train_vis", launches, warmup + timed, VIS_TRAIN_LAUNCHES)
        walls, device_ms = step_times(notes, warmup)
        moved = [k for k, v in running_stats(model).items() if not torch.equal(v, initial[k])]
        no_grad = sorted(n for n, p in model.named_parameters() if p.grad is None or not p.grad.any())
        if len(moved) != len(initial) or any(not n.endswith("uncert_net.head_1.weight") for n in no_grad):
            raise AssertionError(f"train_vis: {len(moved)} of {len(initial)} running statistics moved; "
                                 f"no gradient at {no_grad}")

        t0 = time.perf_counter()
        model2 = rmvd.create_model("vis_mvsnet", seed=1, train=True)
        resumed = family_engine(out_dir, model2, dataset, "vismvsnet_loss", warmup + timed + 1, batch)
        resume_s = time.perf_counter() - t0
        if resumed.finished_iterations != warmup + timed or any(
                not torch.equal(p, q) for p, q in zip(model.state_dict().values(), model2.state_dict().values())):
            raise AssertionError("train_vis: the resumed engine did not restore the snapshot")
        if resumed()["iteration"] != warmup + timed + 1:
            raise AssertionError("train_vis: the resumed engine took no step")

        inputs, gt = training.prepare_batch(rmvd.utils.numpy_collate([dataset[i] for i in range(batch)]))
        torch.cuda.synchronize()
        for _ in range(2):  # the first profile pays the tracer's start-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(inputs, gt)
                torch.cuda.synchronize()
                profiled_ms = (time.perf_counter() - t0) * 1e3
        del model, model2, training, resumed
    result = {"ms_per_step": statistics.median(walls), "ms_per_step_mean": statistics.mean(walls),
              "ms_per_step_min": min(walls), "ms_per_timed_step": walls, "device_ms_per_timed_step": device_ms,
              "device_ms_per_step": statistics.median(device_ms),
              "host_share": statistics.median(1 - d / w for d, w in zip(device_ms, walls)), "peak_mib": peak_mib,
              "launches": launches, "launches_per_step": per_step, "losses": losses,
              "running_stats_moved": len(moved), "params_without_gradient": no_grad, "resume_s": resume_s}
    emit("train_vis", tf32=tf32, dataset="synthetic.train.mvd", size=list(size), views=3, batch=batch,
         warmup=warmup, timed=timed, dtype="float32", **result)
    emit("breakdown_train_vis", **step_breakdown(prof, profiled_ms))
    torch.cuda.empty_cache()
    return result


def phase_train_vis_bf16(counters, fp32, size=(256, 320), warmup=3, timed=5):
    """The same at ``dtype="bfloat16"``: ``create_model("vis_mvsnet",
    train=True, dtype="bfloat16")`` through create_training (the train CLI
    refuses ``--dtype`` for the family, as JAX's does), on
    ``synthetic.train.mvd`` at 256x320, batch 2, 2 loader workers. 3 warm-up
    and 5 timed steps: ms per step, host share, peak MiB, every loss finite,
    K5's bf16 form 36 times, its float32 score heads 9 times and K3 9 times
    per step, the final snapshot written."""
    import torch

    import robustmvd_tpu_torch as rmvd

    tf32 = set_tf32(False)
    batch = 2
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=batch * (warmup + timed), num_views=3,
                                  height=size[0], width=size[1])
    notes = []
    torch.manual_seed(42)
    with tempfile.TemporaryDirectory() as out:
        model = rmvd.create_model("vis_mvsnet", seed=0, train=True, dtype="bfloat16")
        training = family_engine(out, model, dataset, "vismvsnet_loss", warmup + timed, batch, num_workers=2)
        training.train_step = timed_steps(training.train_step, warmup, timed, notes)
        counters.reset()
        training()
        launches = counters.read()
        del model, training
        snaps = sorted(os.listdir(os.path.join(out, "checkpoints")))
    losses = [float(n[3]) for n in notes[:-1]]
    if len(losses) != warmup + timed or not all(np.isfinite(losses)):
        raise AssertionError(f"train_vis_bf16: {len(losses)} steps, losses {losses}")
    if snaps != [f"snapshot-iter-{warmup + timed:09d}.pt"]:
        raise AssertionError(f"train_vis_bf16: snapshots {snaps}")
    per_step = check_family_launches("train_vis_bf16", launches, warmup + timed, VIS_TRAIN_LAUNCHES_BF16)
    walls, device_ms = step_times(notes, warmup)
    result = {"ms_per_step": statistics.median(walls), "ms_per_step_mean": statistics.mean(walls),
              "ms_per_step_min": min(walls), "ms_per_timed_step": walls, "device_ms_per_timed_step": device_ms,
              "device_ms_per_step": statistics.median(device_ms),
              "host_share": statistics.median(1 - d / w for d, w in zip(device_ms, walls)),
              "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "launches": launches,
              "launches_per_step": per_step, "losses": losses}
    emit("train_vis_bf16", tf32=tf32, dataset="synthetic.train.mvd", size=list(size), views=3, batch=batch,
         warmup=warmup, timed=timed, dtype="bfloat16",
         fp32_train_vis={k: fp32[k] for k in ("ms_per_step", "device_ms_per_step", "host_share", "peak_mib")},
         **result)
    torch.cuda.empty_cache()
    return result


def family_train_batch(seed, B, H, W):
    """A synthetic batch as the engine feeds the family: images 0..255 (the
    engines apply no input adapter), absolute intrinsics, poses, depth."""
    import robustmvd_tpu_torch as rmvd

    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=seed + B, num_views=3, height=H, width=W)
    return rmvd.utils.numpy_collate([dataset[seed + i] for i in range(B)])


def family_step(name, device, loss, batch, counters=None, **kwargs):
    """One engine train_step of a family model built with train=True and
    seed 0 (score heads conditioned): {"loss", "grads", "stats" (running
    statistics after the step), "initial_stats", "launches" (with
    ``counters``), "training"}."""
    import robustmvd_tpu_torch as rmvd

    model = conditioned_heads(rmvd.create_model(name, device=device, seed=0, train=True, **kwargs), name)
    initial = {k: v.cpu() for k, v in running_stats(model).items()}
    with tempfile.TemporaryDirectory() as tmp:  # train_step writes nothing there
        training = family_engine(tmp, model, rmvd.create_dataset("synthetic.train.mvd", num_samples=1), loss, 3, 1)
    inputs, gt = training.prepare_batch(batch)
    if counters is not None:
        counters.reset()
    total, _ = training.train_step(inputs, gt)
    training.finished_iterations += 1
    launches = counters.read() if counters is not None else None
    return {"loss": float(total), "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                           if p.grad is not None},
            "stats": {k: v.cpu() for k, v in running_stats(model).items()}, "initial_stats": initial,
            "launches": launches, "training": training}


def phase_train_vis_parity(counters, size=(128, 160), device="cuda"):
    """One vis_mvsnet train step (the engine's train_step) on the card vs the
    CPU: seed-0 weights with the score heads conditioned (FAMILY_HEAD_GAINS),
    128x160, B 1, 1+2 views, TF32 off, cuDNN deterministic: the loss within
    rtol 1e-4, the gradients at train_parity's bounds (grad_errors), the
    running statistics after the step within rtol 1e-5 (atol 1e-6); K5 45
    and K3 9 times on the card."""
    import torch

    tf32 = set_tf32(False)
    torch.backends.cudnn.deterministic = True
    try:
        batch = family_train_batch(3, 1, *size)
        card = family_step("vis_mvsnet", device, "vismvsnet_loss", batch, counters)
        cpu = family_step("vis_mvsnet", "cpu", "vismvsnet_loss", batch)
    finally:
        torch.backends.cudnn.deterministic = False
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    worst, failed = grad_errors(card["grads"], cpu["grads"])
    stats_excess = max(float(((card["stats"][k] - v).abs() - (1e-5 * v.abs() + 1e-6)).max())
                       for k, v in cpu["stats"].items())
    moved = sum(not torch.equal(v, card["initial_stats"][k]) for k, v in card["stats"].items())
    per_step = {k: card["launches"][k] for k in VIS_TRAIN_LAUNCHES}
    if not (loss_rel <= 1e-4 and not failed and stats_excess <= 0 and per_step == VIS_TRAIN_LAUNCHES
            and card["grads"].keys() == cpu["grads"].keys() and moved == len(card["stats"])):
        raise AssertionError(f"train_vis_parity: loss {card['loss']} vs {cpu['loss']}, gradients off at {failed}, "
                             f"running statistics off by {stats_excess} ({moved} moved), launches {card['launches']}")
    result = {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_rel,
              "grad_max_abs_err_worst": max(worst.values()), "grad_max_abs_err_worst_param": max(worst, key=worst.get),
              "running_stats_excess_max": stats_excess, "running_stats_moved": moved,
              "launches_card": {k: v for k, v in card["launches"].items() if v}}
    emit("train_vis_parity", tf32=tf32, batch=1, views=3, shape=list(size), heads=FAMILY_HEAD_GAINS["vis_mvsnet"],
         **result)
    torch.cuda.empty_cache()
    return result


def phase_train_family(counters, size=(128, 160), device="cuda"):
    """mvsnet_train (``mvsnet_loss``, 48 hypotheses) and cvp_mvsnet
    (``SL1Loss``, nscale 5) with ``train=True`` (the "xla" routes, BatchNorm
    frozen, cvp's constant training interval): 3 engine train_steps each on
    the card at 128x160, B 1, 1+2 views, score heads conditioned; every loss
    finite, the first within mvsnet rtol 1e-4 / cvp 1e-2 (its finer levels,
    CVP_FINE_BOUNDS) of the same step on the CPU, the running statistics
    unchanged; no forward-only kernel launched."""
    import torch

    tf32 = set_tf32(False)
    results = {}
    for name, loss, kwargs, rtol in (("mvsnet_train", "mvsnet_loss", {"num_sampling_steps": 48}, 1e-4),
                                     ("cvp_mvsnet", "SL1Loss", {}, CVP_FINE_BOUNDS[0])):
        torch.backends.cudnn.deterministic = True
        try:
            batches = [family_train_batch(seed, 1, *size) for seed in (4, 5, 6)]
            card = family_step(name, device, loss, batches[0], counters, **kwargs)
            cpu = family_step(name, "cpu", loss, batches[0], **kwargs)
        finally:
            torch.backends.cudnn.deterministic = False
        training = card["training"]
        losses = [card["loss"]]
        for batch in batches[1:]:
            inputs, gt = training.prepare_batch(batch)
            losses.append(float(training.train_step(inputs, gt)[0]))
            training.finished_iterations += 1
        unchanged = all(torch.equal(v.cpu(), card["initial_stats"][k]) for k, v in running_stats(training.model).items())
        rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        forward_only = {k: v for k, v in card["launches"].items() if v and k.split("[")[0] in
                        ("sweep_warp", "sweep_group_cost", "warp_volume")}
        if not (np.isfinite(losses).all() and rel <= rtol and unchanged and not forward_only):
            raise AssertionError(f"train_family {name}: losses {losses}, first vs CPU {cpu['loss']} ({rel}), running "
                                 f"statistics unchanged {unchanged}, forward-only launches {forward_only}")
        results[name] = {"losses": losses, "loss_cpu": cpu["loss"], "first_loss_rel_err": rel, "rtol": rtol,
                         "running_stats_unchanged": unchanged,
                         "launches_first_step": {k: v for k, v in card["launches"].items() if v}}
        del card, cpu, training
    emit("train_family", tf32=tf32, batch=1, views=3, shape=list(size), **results)
    torch.cuda.empty_cache()
    return results


# --- the event writer, data parallelism at world size 1, the profiler ---

# the recipe's train CLI on the StaticThings3D reader; no TensorBoard, so no logging forward
RECIPE_ST3D_ARGS = ["--training_type", "mvd", "--model", "robust_mvd", "--inputs", "poses", "intrinsics",
                    "--optimizer", "adam", "--lr", "1e-4", "--grad_clip_max_norm", "5", "--scheduler",
                    "flownet_scheduler", "--loss", "robust_mvd_loss", "--dataset", RECIPE_DATASETS[0],
                    "--augmentations_per_dataset", "robust_mvd_augmentations_staticthings3d",
                    "--batch_augmentations", "robust_mvd_batch_augmentations", "--no_tensorboard"]


def state_diff(ours, ref):
    """Two state dicts: bit-equal, entries that differ, max |d|, max over
    entries of max |d| / max |ref|, and ||d|| / ||ref|| over every float
    entry (``rel_l2``)."""
    import torch

    differ, max_abs, max_rel, d2, r2 = 0, 0.0, 0.0, 0.0, 0.0
    for k, v in ref.items():
        if v.is_floating_point():
            r2 += float(v.double().pow(2).sum())
        if torch.equal(ours[k], v):
            continue
        differ += 1
        d = (ours[k].double() - v.double()).abs()
        d2 += float(d.pow(2).sum()) if v.is_floating_point() else 0.0
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float(d.max()) / (float(v.double().abs().max()) or 1.0))
    return {"bit_equal": differ == 0, "entries_differing": differ, "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "rel_l2": (d2 / r2) ** 0.5 if r2 else 0.0}


def phase_train_writer(counters, warmup=3, timed=10, batch=4):
    """The recipe through create_training after ``setup_writers``, as the train
    CLI calls them (``events.jsonl``, and TensorBoard where ``tensorboard``
    imports): train_main's data (``synthetic.train.mvd``, 5 views at 540x960,
    the StaticThings3D augmentations' 384x768 crops, the batch
    augmentations), batch 4, fp32, TF32 off, ``log_interval`` 2 and the
    default ``log_loss_interval``: 3 + 10 steps. ms per step for the logged
    and the unlogged steps apart (host clock from one ``train_step`` call to
    the next: a logged step's interval holds ``_log_all``, whose host time is
    noted too), the events flushed by type and name, K1 and K1b launches (the
    logging forward launches K1 4 times). Then the parameters after 4 steps
    with ``log_interval`` 1 against 4 steps without logging, from one seed
    (synthetic 5-view batches at the crops' 384x768 without the augmentations,
    whose host time phase train_ddp reports; no loader workers, cuDNN's
    deterministic algorithms), with two runs
    without logging against each other as the yardstick (the card's backward
    is not deterministic: see phase_data_parallel), and the train state
    (parameters, running statistics, Adam's moments, the torch, CUDA and numpy
    generators) bit-equal before and after each ``_log_all`` call (the
    logged run's 4 and iteration 0's of each run without logging)."""
    import importlib.util

    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.utils import writer

    tf32 = set_tf32(False)
    workers = min(8, os.cpu_count() or 1)
    dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=4 * batch * (warmup + timed), num_views=5,
                                  height=540, width=960, augmentations="robust_mvd_augmentations_staticthings3d")
    flushed = {}
    write_out_storage = writer.write_out_storage

    def counted_write_out_storage():
        for e in writer._EVENT_STORAGE:
            flushed[e["type"]] = flushed.get(e["type"], 0) + 1
        write_out_storage()

    with tempfile.TemporaryDirectory() as out_dir:
        np.random.seed(42)
        torch.manual_seed(42)
        writer.setup_writers(log_tensorboard=True, out_dir=out_dir)
        tensorboard_files = len([f for f in os.listdir(out_dir) if f.startswith("events.out.tfevents")])
        images = writer.writes_images()  # the logging forward, images and histograms need TensorBoard
        model = rmvd.create_model("robust_mvd", seed=0, train=True)
        training = recipe_engine(out_dir, model, dataset, warmup + timed, batch, num_workers=workers, log_interval=2)
        step, log_all = training.train_step, training._log_all
        starts, log_all_ms = [], []

        def noted_step(sample_inputs, sample_gt):
            starts.append(time.perf_counter())
            return step(sample_inputs, sample_gt)

        def noted_log_all(*args):
            t0 = time.perf_counter()
            log_all(*args)
            log_all_ms.append((time.perf_counter() - t0) * 1e3)

        training.train_step, training._log_all = noted_step, noted_log_all
        writer.write_out_storage = counted_write_out_storage
        try:
            counters.reset()
            training()
            launches = counters.read()
        finally:
            writer.write_out_storage = write_out_storage
            writer.setup_writers(out_dir=None)
        with open(os.path.join(out_dir, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        del model, training
    steps = warmup + timed
    logged = [i for i in range(steps) if i % 2 == 0]
    walls = {i: (b - a) * 1e3 for i, (a, b) in enumerate(zip(starts, starts[1:]))}
    by_prefix = {}
    for e in events:
        by_prefix[e["name"].split("/")[0]] = by_prefix.get(e["name"].split("/")[0], 0) + 1
    forwards = len(logged) if images else 0
    expected = {"planesweep_sample": 4 * (steps + forwards), "planesweep_sample_backward": 4 * steps}
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"train_writer: launches {launches}, expected {expected} (4 per step, 4 per logging "
                             "forward)")
    steps_logged = sorted({e["step"] for e in events if e["name"] == "03_params/encoder_norm"})
    if steps_logged != logged or flushed.get("image", 0) < 2 * forwards or flushed.get("histogram", 0) != 5 * forwards \
            or not all(e["value"] is not None and np.isfinite(e["value"]) for e in events):
        raise AssertionError(f"train_writer: parameter norms at {steps_logged}, flushed {flushed}")

    # the train state after 4 steps: logging every step vs none (twice); and around each _log_all call
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    states, untouched = {}, []

    def train_state(engine):
        return {"model": {k: v.clone() for k, v in engine.model.state_dict().items()},
                "optimizer": [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                              for s in engine.optimizer.state.values()],
                "rng": (torch.get_rng_state(), torch.cuda.get_rng_state(), np.random.get_state()[1].copy())}

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if torch.is_tensor(a) else bool(np.all(a == b))

    crops = rmvd.create_dataset("synthetic.train.mvd", num_samples=4 * batch, num_views=5, height=384, width=768)
    for label, interval in (("logged", 1), ("plain", 10 ** 9), ("plain_again", 10 ** 9)):
        np.random.seed(42)
        torch.manual_seed(42)
        with tempfile.TemporaryDirectory() as out_dir:
            writer.setup_writers(out_dir=out_dir if interval == 1 else None)  # TensorBoard: the logging forward
            model = rmvd.create_model("robust_mvd", seed=0, train=True)
            engine = recipe_engine(out_dir, model, crops, 4, batch, num_workers=0, log_interval=interval,
                                   log_loss_interval=interval)
            engine_log_all = engine._log_all

            def checked_log_all(*args, engine=engine, engine_log_all=engine_log_all):
                before = train_state(engine)
                engine_log_all(*args)
                untouched.append(same(before, train_state(engine)))

            engine._log_all = checked_log_all
            engine()
            writer.setup_writers(out_dir=None)
            states[label] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            del model, engine
    torch.backends.cudnn.deterministic = False
    logged_vs_plain = state_diff(states["logged"], states["plain"])
    plain_vs_plain = state_diff(states["plain_again"], states["plain"])
    # iteration 0 logs in every run (0 % interval == 0, as in the JAX engine): 4 + 1 + 1 calls; the runs without a
    # writer take no logging forward
    if untouched != [True] * 6 or not logged_vs_plain["bit_equal"] and (
            plain_vs_plain["bit_equal"] or logged_vs_plain["rel_l2"] > 10 * max(plain_vs_plain["rel_l2"], 1e-6)):
        raise AssertionError(f"train_writer: logging moved the train state: around each _log_all {untouched}; after "
                             f"4 steps {logged_vs_plain}, two runs without logging {plain_vs_plain}")
    result = {"ms_per_logged_step": statistics.median(walls[i] for i in logged if warmup <= i < steps - 1),
              "ms_per_unlogged_step": statistics.median(walls[i] for i in range(warmup, steps - 1) if i % 2),
              "log_all_ms": log_all_ms, "log_all_ms_median": statistics.median(log_all_ms[2:]),
              "ms_per_step": walls, "events_jsonl_by_type": {t: sum(e["type"] == t for e in events)
                                                             for t in {e["type"] for e in events}},
              "events_jsonl_by_prefix": by_prefix, "events_flushed_by_type": flushed,
              "tensorboard_imports": importlib.util.find_spec("tensorboard") is not None,
              "tensorboard_files": tensorboard_files, "launches": launches,
              "log_all_left_the_state_bit_equal": untouched,
              "params_after_4_steps_logged_vs_plain": logged_vs_plain,
              "params_after_4_steps_plain_vs_plain": plain_vs_plain}
    emit("train_writer", tf32=tf32, dataset="synthetic.train.mvd", raw_size=[540, 960], crop=[384, 768], views=5,
         batch=batch, warmup=warmup, timed=timed, workers=workers, log_interval=2, log_loss_interval=100,
         logged_steps=logged, **result)
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def recipe_roots(tmp, st3d_root, bmvs_root):
    """The recipe datasets' roots through the user's paths file, their
    generated sample lists into ``tmp``, for the block."""
    import robustmvd_tpu_torch.data.blendedmvs as bmvs_module
    import robustmvd_tpu_torch.data.dataset as dataset_module
    import robustmvd_tpu_torch.data.staticthings3d as st3d_module
    import robustmvd_tpu_torch.utils.paths as paths

    paths_file = os.path.join(tmp, "rmvd_data_paths.toml")
    with open(paths_file, "w") as f:
        f.write(f'[staticthings3d.train]\nroot = "{st3d_root}"\n\n[blendedmvs]\nroot = "{bmvs_root}"\n')
    lists = os.path.join(tmp, "sample_lists")
    os.makedirs(lists, exist_ok=True)
    original = dataset_module._sample_list_path

    def redirect(name):
        return os.path.join(lists, f"{name}.pickle") if name in RECIPE_DATASETS else original(name)

    saved = (paths.USER_PATHS_FILE, st3d_module._sample_list_path, bmvs_module._sample_list_path)
    try:
        paths.USER_PATHS_FILE = type(saved[0])(paths_file)
        dataset_module._sample_list_path = st3d_module._sample_list_path = bmvs_module._sample_list_path = redirect
        yield
    finally:
        paths.USER_PATHS_FILE = saved[0]
        dataset_module._sample_list_path = original
        st3d_module._sample_list_path, bmvs_module._sample_list_path = saved[1:]


def noted_engine_steps(notes, snapshot_after, snapshots):
    """Patch ``MultiViewDepthTraining.train_step`` to note each call (host
    clock, CUDA events, loss) and keep the model's state after
    ``snapshot_after`` calls; returns the original."""
    import torch

    from robustmvd_tpu_torch.train.multi_view_depth_training import MultiViewDepthTraining

    step = MultiViewDepthTraining.train_step

    def noted_step(self, sample_inputs, sample_gt):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, sub_losses = step(self, sample_inputs, sample_gt)
        end.record()
        notes.append((t0, start, end, loss, self.world, type(self.train_model).__name__, time.perf_counter() - t0))
        if len(notes) == snapshot_after:
            snapshots.append({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()})
        return loss, sub_losses

    MultiViewDepthTraining.train_step = noted_step
    return step


def data_parallel_run(spec, data_parallel, label=None, steps=None, workers=None):
    """One run of a data-parallel phase (``spec["kind"]``: "recipe", the train
    CLI over the StaticThings3D tree; "vis", create_training as train_vis
    builds it) with or without ``--data_parallel`` / a mesh, ``steps`` steps
    (the spec's warm-up and timed ones by default). TF32 off, cuDNN's
    deterministic algorithms. Returns ms per step (host clock from one step
    to the next, after the warm-up), CUDA-event ms, losses, the launches, and
    writes the state after ``spec["compare_after"]`` steps to
    ``spec["out"]/<label>.pt``."""
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.train.multi_view_depth_training import MultiViewDepthTraining

    set_tf32(False)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    label = label or ("ddp" if data_parallel else "plain")
    steps = steps or spec["warmup"] + spec["timed"]
    workers = spec.get("workers", 0) if workers is None else workers
    notes, snapshots = [], []
    counters = Counters()
    step = noted_engine_steps(notes, spec["compare_after"], snapshots)
    try:
        counters.reset()
        t0 = time.perf_counter()
        if spec["kind"] == "recipe":
            from robustmvd_tpu_torch.train.cli import main as train_main

            with recipe_roots(spec["tmp"], spec["st3d_root"], spec["bmvs_root"]):
                train_main(RECIPE_ST3D_ARGS + ["--output", os.path.join(spec["out"], label), "--batch_size",
                                               str(spec["batch"]), "--max_iterations", str(steps), "--num_workers",
                                               str(workers)] + (["--data_parallel"] if data_parallel else []))
        else:
            from robustmvd_tpu_torch.parallel import MeshSpec, init_distributed_from_env, make_mesh

            mesh = None
            if data_parallel:
                assert init_distributed_from_env(), "the launcher's environment is missing"
                mesh = make_mesh(MeshSpec())
            np.random.seed(42)
            torch.manual_seed(42)
            # one dataset (and so one shuffle) whatever the number of steps
            dataset = rmvd.create_dataset("synthetic.train.mvd", num_samples=spec["batch"] * (spec["warmup"] + spec[
                "timed"]), num_views=3, height=spec["size"][0], width=spec["size"][1])
            model = rmvd.create_model("vis_mvsnet", seed=0, train=True)
            family_engine(os.path.join(spec["out"], label), model, dataset, "vismvsnet_loss", steps, spec["batch"],
                          num_workers=workers, mesh=mesh)()
            if mesh is not None:
                torch.distributed.destroy_process_group()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counters.read()
    finally:
        MultiViewDepthTraining.train_step = step
        torch.backends.cudnn.deterministic = False
    starts = [n[0] for n in notes]
    walls = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])][spec["warmup"]:] or [float("nan")]
    torch.save(snapshots[0], os.path.join(spec["out"], f"{label}.pt"))
    return {"ms_per_step": statistics.median(walls), "ms_per_timed_step": walls,
            "device_ms_per_step": statistics.median(n[1].elapsed_time(n[2]) for n in notes[spec["warmup"]:] or notes),
            "step_call_host_ms": statistics.median(n[6] * 1e3 for n in notes[spec["warmup"]:] or notes),
            "losses": [float(n[3]) for n in notes], "launches": launches, "steps": len(notes), "wall_s": wall_s,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "world_size": notes[-1][4],
            "train_model": notes[-1][5]}


def ddp_child():
    """The data-parallel side of a phase, in a process that
    ``python -m robustmvd_tpu_torch.launch`` started: ``sys.argv[1]`` is the
    spec's JSON file; the result goes to ``<out>/ddp.json``."""
    import torch

    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    result = data_parallel_run(spec, data_parallel=True)
    with open(os.path.join(spec["out"], "ddp.json"), "w") as f:
        json.dump(result, f)
    return 0


def phase_data_parallel(label, spec, expected_per_step):
    """``spec``'s run without data parallelism in this process, then with it
    through ``python -m robustmvd_tpu_torch.launch --local 1`` (NCCL, world
    size 1) in a child: ms per step side by side, each side's launches
    (``expected_per_step`` of each kernel named there, on every step), and
    the state dict after ``spec["compare_after"]`` steps (parameters and
    BatchNorm running statistics) against the run without: within rtol 1e-6
    where two runs without data parallelism agree so (bit-equal expected),
    else a ||difference|| / ||state|| at most 10 times those two runs' or
    1e-5, whichever is larger (the spread of that distance between pairs of
    runs is about 5x on vis; a step that drops a gradient or a statistic
    moves the state by 1e-4 and more; the yardstick: the run without data
    parallelism and a second one of ``compare_after`` steps).
    The
    recipe's backward is not deterministic on the card (K1b adds taps with
    shared-memory atomics), and Adam turns the last bits of a gradient near 0
    into a step of up to the learning rate."""
    import torch

    plain = data_parallel_run(spec, data_parallel=False)
    data_parallel_run(spec, data_parallel=False, label="again", steps=spec["compare_after"])
    yardstick = state_diff(torch.load(os.path.join(spec["out"], "again.pt")),
                           torch.load(os.path.join(spec["out"], "plain.pt")))
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "robustmvd_tpu_torch.launch", "--local", "1", "--timeout", "600",
                            "--", "-c", "import sys, chip_smoke; sys.exit(chip_smoke.ddp_child())", path],
                           cwd=root, capture_output=True, text=True, timeout=660)
    launcher_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"{label}: the launcher's child failed ({child.returncode}):\n"
                             f"{child.stdout[-4000:]}\n{child.stderr[-2000:]}")
    with open(os.path.join(spec["out"], "ddp.json")) as f:
        ddp = json.load(f)
    steps = spec["warmup"] + spec["timed"]
    for side, result in (("plain", plain), ("ddp", ddp)):
        got = {name: result["launches"][name] / steps for name in expected_per_step}
        if (got != expected_per_step or result["steps"] != steps or not np.isfinite(result["losses"]).all()
                or (result["train_model"] == "DistributedDataParallel") != (side == "ddp")
                or result["world_size"] != 1):
            raise AssertionError(f"{label} {side}: {result['steps']} steps through {result['train_model']} at world "
                                 f"size {result['world_size']}, launches per step {got}, expected "
                                 f"{expected_per_step}; losses {result['losses']}")
    diff = state_diff(*(torch.load(os.path.join(spec["out"], f"{run}.pt")) for run in ("ddp", "plain")))
    metric = "max_rel_diff" if yardstick["bit_equal"] else "rel_l2"
    limit = 1e-6 if yardstick["bit_equal"] else 10 * max(yardstick["rel_l2"], 1e-6)
    if diff[metric] > limit:
        raise AssertionError(f"{label}: the data-parallel state after {spec['compare_after']} steps differs: {diff}; "
                             f"two runs without data parallelism: {yardstick}")
    return plain, ddp, {"state_after_steps": spec["compare_after"], **diff, "limit": {metric: limit},
                        "two_plain_runs": yardstick, "launcher_s": launcher_s}


def phase_train_ddp(counters, warmup=3, timed=5, batch=4):
    """The recipe (the train CLI's arguments of ``train_all.sh:8-18`` on the
    StaticThings3D reader over a raw-size tree, its augmentations' 384x768
    crops, batch 4, fp32) without and with ``--data_parallel`` through the
    launcher (world size 1, NCCL): 3 + 5 steps each, K1 and K1b 4 times per
    step on both sides, the parameters after 3 steps within rtol 1e-6
    (bit-equal expected) where the card's steps are deterministic, else held
    to two plain runs' distance (phase_data_parallel). No loader workers:
    8 spawned workers took the first batch 60 s on the card's host, twice a
    phase; so the wall ms per step is the loader's (``sample_host_s``: one
    sample read and augmented on the host), and DDP's cost reads in the
    CUDA-event ms of ``train_step`` and its host ms (the call's own time)."""
    import robustmvd_tpu_torch as rmvd

    with tempfile.TemporaryDirectory() as tmp:
        st3d_root, bmvs_root = write_recipe_tree(tmp, np.random.RandomState(11))
        with recipe_roots(tmp, st3d_root, bmvs_root):
            dataset = rmvd.create_dataset(RECIPE_DATASETS[0], augmentations="robust_mvd_augmentations_staticthings3d")
            t0 = time.perf_counter()
            for i in range(4):
                dataset[i * 97]
            sample_host_s = (time.perf_counter() - t0) / 4
        spec = {"kind": "recipe", "tmp": tmp, "st3d_root": st3d_root, "bmvs_root": bmvs_root, "out": tmp,
                "warmup": warmup, "timed": timed, "batch": batch, "workers": 0, "compare_after": 3}
        plain, ddp, state = phase_data_parallel(
            "train_ddp", spec, {"planesweep_sample": 4.0, "planesweep_sample_backward": 4.0})
    result = {"ms_per_step": ddp["ms_per_step"], "plain_ms_per_step": plain["ms_per_step"],
              "sample_host_s": sample_host_s,
              "device_ms_per_step": ddp["device_ms_per_step"], "plain_device_ms_per_step": plain["device_ms_per_step"],
              "ddp_device_ms_per_step": ddp["device_ms_per_step"] - plain["device_ms_per_step"],
              "step_call_host_ms": ddp["step_call_host_ms"], "plain_step_call_host_ms": plain["step_call_host_ms"],
              "ms_per_timed_step": ddp["ms_per_timed_step"], "plain_ms_per_timed_step": plain["ms_per_timed_step"],
              "launches": ddp["launches"], "plain_launches": plain["launches"], "losses": ddp["losses"],
              "plain_losses": plain["losses"], "peak_mib": ddp["peak_mib"], "world_size": ddp["world_size"],
              "params": state}
    emit("train_ddp", dataset=RECIPE_DATASETS[0], raw_size=[540, 960], crop=[384, 768], views=5, batch=batch,
         warmup=warmup, timed=timed, workers=0, backend="nccl", cudnn="deterministic", tf32=False, **result)
    return result


def phase_train_vis_ddp(counters, size=(256, 320), warmup=2, timed=3, batch=2):
    """vis_mvsnet at train_vis's configuration (batch 2, 1+2 views, 256x320,
    adam 1e-3, mvsnet_scheduler, fp32) through create_training without and
    with a mesh (the launcher's child, world size 1, NCCL): 3 steps each, K5
    45 and K3 9 times per step on both sides, the parameters and BatchNorm
    running statistics after 3 steps within rtol 1e-6 (bit-equal expected)
    where the card's steps are deterministic, else held to two plain runs'
    distance (phase_data_parallel); 2 + 3 steps, ms per step side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"kind": "vis", "out": tmp, "size": list(size), "warmup": warmup, "timed": timed, "batch": batch,
                "compare_after": 3}
        plain, ddp, state = phase_data_parallel("train_vis_ddp", spec, dict(VIS_TRAIN_LAUNCHES))
    result = {"ms_per_step": ddp["ms_per_step"], "plain_ms_per_step": plain["ms_per_step"],
              "device_ms_per_step": ddp["device_ms_per_step"], "plain_device_ms_per_step": plain["device_ms_per_step"],
              "step_call_host_ms": ddp["step_call_host_ms"], "plain_step_call_host_ms": plain["step_call_host_ms"],
              "launches": ddp["launches"], "plain_launches": plain["launches"], "losses": ddp["losses"],
              "plain_losses": plain["losses"], "world_size": ddp["world_size"], "state": state}
    emit("train_vis_ddp", dataset="synthetic.train.mvd", size=list(size), views=3, batch=batch, warmup=warmup,
         timed=timed,
         backend="nccl", cudnn="deterministic", tf32=False, **result)
    return result


def phase_profile_main(counters, fp32_runs):
    """The port's profiler around robust_mvd's main path: ``utils/profiler.
    trace`` around one ``model.run`` at 384x1280 with 1+2 views (fp32, TF32
    off), whose Chrome trace must hold K1's kernel; ``time_fn``'s ms per
    frame (CUDA events, 3 burn-in and 20 timed frames) beside phase main's
    host-clock median; ``device_memory_stats``."""
    import torch

    import robustmvd_tpu_torch as rmvd
    from robustmvd_tpu_torch.utils import profiler

    set_tf32(False)
    model = rmvd.create_model("robust_mvd")
    sample = kitti_like_sample(np.random.RandomState(2), 384, 1280, 3)
    model.run(**sample)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as log_dir:
        counters.reset()
        with profiler.trace(log_dir, device="cuda") as prof:
            model.run(**sample)
        launches = counters.read()
        with open(os.path.join(log_dir, "trace.json")) as f:
            trace_events = json.load(f)["traceEvents"]
    k1_events = [e for e in trace_events if e.get("cat") == "kernel" and "planesweep_sample" in e.get("name", "")]
    if len(k1_events) != 2 or launches["planesweep_sample"] != 2:
        raise AssertionError(f"profile_main: {len(k1_events)} K1 kernel events in the trace, "
                             f"{launches['planesweep_sample']} launches; expected 2")
    device_ms = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    counters.reset()
    seconds = profiler.time_fn(lambda: model.run(**sample), iters=20, burn_in=3, device="cuda")
    time_fn_launches = counters.read()["planesweep_sample"]
    result = {"time_fn_ms_per_frame": seconds * 1e3, "main_ms_per_frame": fp32_runs["ms_per_frame"],
              "trace_k1_kernel": k1_events[0]["name"], "trace_k1_events": len(k1_events),
              "trace_kernel_events": sum(e.get("cat") == "kernel" for e in trace_events),
              "traced_frame_device_ms": device_ms, "device_memory_stats": profiler.device_memory_stats("cuda"),
              "launches": {"traced_frame": launches["planesweep_sample"], "time_fn": time_fn_launches}}
    emit("profile_main", shape=[384, 1280], views=3, dtype="float32", tf32=False, **result)
    del model
    torch.cuda.empty_cache()
    return result


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
    if "conv3d_k3_bf16_kernel" in name:
        return "k5_conv3d_banded_bf16"
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
    if any(key in name for key in ("fprop", "convolve", "dgrad", "cudnn") + FFT_KERNEL_KEYS):
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
            if hasattr(fn, "launches_by_dtype"):
                fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)

    def read(self):
        """Every wrapper's launches by source name; for the wrappers with one
        instantiation per dtype (K1, K1b, K2 group, K5) also each one's, as
        "name[dtype]"."""
        counts = {}
        for name, fn in self.kernels.items():
            counts[name] = fn.launches
            for dtype, n in getattr(fn, "launches_by_dtype", {}).items():
                counts[f"{name}[{dtype}]"] = n
        return counts


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
    k1b = phase_kernel_k1b()
    k2 = phase_kernel_k2()
    k2g = phase_kernel_k2_group()
    k3 = phase_kernel_k3()
    k5 = phase_kernel_k5()
    k4 = phase_kernel_k4()
    counters = Counters()
    phase_parity()
    phase_parity_bf16(counters)
    phase_family_parity(counters)
    phase_vis_parity(counters)
    phase_family_parity_bf16(counters)
    runs = phase_main(counters)
    runs_bf16 = phase_main_bf16(counters, runs)
    family = phase_family_main(counters)
    vis = phase_vis_main(counters)
    family_bf16 = phase_family_main_bf16(counters, family, vis)
    k5_frame = phase_kernel_k5_vis_frame(family_bf16["vis_mvsnet", "k5_bf16_calls_per_frame"])
    vis_rmvd = phase_vis_rmvd_checkpoint(counters)
    phase_wrapped()
    phase_eval_parity(counters)
    phase_resize_parity()
    evals = {
        "eval_kitti": phase_eval_run(counters, "eval_kitti", num_views=21, keyview_idx=10, height=375, width=1242,
                                     num_samples=3, cut="samples: 3 (synthetic data); views and size as KITTI's"),
        "eval_eth3d": phase_eval_run(counters, "eval_eth3d", num_views=11, keyview_idx=0, height=1024, width=1536,
                                     num_samples=2, cut="samples: 2 (synthetic data); views and size as ETH3D's"),
    }
    eval_bf16 = phase_eval_run(counters, "eval_kitti_bf16", num_views=21, keyview_idx=10, height=375, width=1242,
                               num_samples=2, dtype="bfloat16",
                               cut="samples: 2 (synthetic data); views and size as KITTI's")
    phase_train_parity(counters)
    train = phase_train_main(counters)
    train_bf16 = phase_train_bf16(counters, train)
    k3_grad = phase_kernel_k3_grad()
    vis_parity = phase_train_vis_parity(counters)
    vis_train = phase_train_vis(counters)
    vis_train_bf16 = phase_train_vis_bf16(counters, vis_train)
    phase_train_family(counters)
    train_writer = phase_train_writer(counters)
    train_ddp = phase_train_ddp(counters)
    train_vis_ddp = phase_train_vis_ddp(counters)
    profile_main = phase_profile_main(counters, runs["fp32"])

    f32, bf16 = k1["f32"], k1["bf16"]
    # K1 v2 (the bf16 instantiation) and K1b's bf16 form on the bf16 paths
    v2_launches = {"robust_mvd_bf16": runs_bf16["launches"]["planesweep_sample[bfloat16]"],
                   "eval_kitti_bf16": eval_bf16["k1_launches"],
                   "train_bf16": train_bf16["launches"]["planesweep_sample[bfloat16]"]}
    k1b_bf16_launches = {"train_bf16": train_bf16["launches"]["planesweep_sample_backward[bfloat16]"]}
    k2_main = k2["mvsnet_f32"]
    k2_launches = {path: family[path]["fp32"]["launches"]["sweep_warp"] for path in ("mvsnet_train", "cvp_mvsnet")}
    k5_launches = {"vis_mvsnet": vis["banded"]["fp32"]["launches"]["conv3d_banded"],
                   "vis_rmvd_checkpoint": vis_rmvd["conv3d_banded"],
                   "mvsnet_train_banded_xla": family["mvsnet_train_banded_xla"]["fp32"]["launches"]["conv3d_banded"],
                   "train_vis": vis_train["launches"]["conv3d_banded"],
                   "train_vis_parity": vis_parity["launches_card"]["conv3d_banded"],
                   "train_vis_ddp": train_vis_ddp["launches"]["conv3d_banded"]}
    k5_main = k5["vis_stage3_reg"]
    k5_bf16 = {case: r["bf16"] for case, r in k5.items() if "bf16" in r}
    k5_bf16_runs = {path: family_bf16[path, "bfloat16"] for path in ("vis_mvsnet", "mvsnet_train_banded_xla")}
    k5_bf16_launches = {f"{path}_bf16": r["launches"]["conv3d_banded[bfloat16]"] for path, r in k5_bf16_runs.items()}
    k5_bf16_launches["train_vis_bf16"] = vis_train_bf16["launches"]["conv3d_banded[bfloat16]"]
    k4_main = k4["f32"]
    k2g_bf16 = {case: r["bf16"] for case, r in k2g.items()}
    k2g_bf16_run = family_bf16["vis_mvsnet", "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "planesweep_sample",
        "route": "cuda",
        "status": "ported",
        "source": "robustmvd_tpu_torch/csrc/planesweep_sample.cu",
        "replaces": "robustmvd_tpu/ops/pallas/planesweep_sample.py:55; "
                    "robustmvd_tpu/ops/pallas/planesweep_sample_v2.py:64",
        "launches": runs["fp32"]["launches"]["planesweep_sample"],
        "launches_by_path": {"robust_mvd": runs["fp32"]["launches"]["planesweep_sample"],
                             **{path: r["k1_launches"] for path, r in evals.items()},
                             "train_main": train["launches"]["planesweep_sample"],
                             "train_writer": train_writer["launches"]["planesweep_sample"],
                             "train_ddp": train_ddp["launches"]["planesweep_sample"],
                             "profile_main": profile_main["launches"]["traced_frame"]},
        "launches_per_eval_sample": {path: r["k1_launches_per_sample"] for path, r in evals.items()},
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "bf16": {**{k: bf16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                 "replaces": "robustmvd_tpu/ops/pallas/planesweep_sample_v2.py:64",
                 "launches": sum(v2_launches.values()), "launches_by_path": v2_launches,
                 "launches_per_frame": runs_bf16["launches"]["planesweep_sample[bfloat16]"] / (
                     runs_bf16["warmup"] + runs_bf16["frames"]),
                 "launches_per_eval_sample": eval_bf16["k1_launches_per_sample"],
                 "launches_per_train_step": train_bf16["launches_per_step"]["planesweep_sample[bfloat16]"]},
    }, {
        "name": "planesweep_sample_backward",
        "route": "cuda",
        "status": "new",
        "source": "robustmvd_tpu_torch/csrc/planesweep_sample_backward.cu",
        "replaces": "none: the backward of robustmvd_tpu/ops/pallas/planesweep_sample.py:55, which has no Pallas "
                    "VJP (the JAX package differentiates its XLA correlation routes)",
        "launches": train["launches"]["planesweep_sample_backward"],
        "launches_by_path": {"train_main": train["launches"]["planesweep_sample_backward"],
                             "train_writer": train_writer["launches"]["planesweep_sample_backward"],
                             "train_ddp": train_ddp["launches"]["planesweep_sample_backward"]},
        "launches_per_train_step": train["launches_per_step"]["planesweep_sample_backward"],
        "max_abs_err": k1b["max_abs_err"],
        "ms": k1b["ms"],
        "plain_ms": k1b["plain_ms"],
        "bound_ms": k1b["bound_ms"],
        "bound_by": k1b["bound_by"],
        "library_ms": k1b["library_ms"],  # grid_sample's input gradient for the same samples
        "kernel_route": k1b["route"],
        "bf16": {**{k: k1b["bf16"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "f32_then_cast_ms")},
                 "launches": sum(k1b_bf16_launches.values()), "launches_by_path": k1b_bf16_launches,
                 "launches_per_train_step": train_bf16["launches_per_step"]["planesweep_sample_backward[bfloat16]"]},
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
        "launches_by_path": {"vis_mvsnet": vis["banded"]["fp32"]["launches"]["sweep_group_cost"],
                             "vis_rmvd_checkpoint": vis_rmvd["sweep_group_cost"]},
        "max_abs_err": max(r["max_abs_err"] for r in k2g.values()),
        "ms": k2g["stage3"]["ms"],
        "plain_ms": k2g["stage3"]["plain_ms"],
        "bound_ms": k2g["stage3"]["bound_ms"],
        "bound_by": k2g["stage3"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it; the yardstick is the grid_sample route
        "grid_sample_route_ms": k2g["stage3"]["grid_sample_route_ms"],
        "cases": {case: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "grid_sample_route_ms", "bound_ms",
                                           "bound_by", "bound_share")} for case, r in k2g.items()},
        "bf16": {**{k: k2g_bf16["stage3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                        "grid_sample_route_ms", "route")},
                 "status": "redesigned",
                 "max_abs_err": max(r["max_abs_err"] for r in k2g_bf16.values()),
                 "library_ms": None,
                 "bound_share": {case: r["bound_share"] for case, r in k2g_bf16.items()},
                 # faster than the float32 form at each (K2_GROUP_BF16_MUST_BEAT_F32, checked in phase kernel)
                 "beats_f32": {case: k2g_bf16[case]["ms"] < k2g[case]["ms"] for case in K2_GROUP_BF16_MUST_BEAT_F32},
                 # the profiled vis bf16 frame's K2 group device ms (6 launches)
                 "vis_bf16_frame_profiled_ms": family_bf16["vis_mvsnet", "k2_group_ms"],
                 "launches": k2g_bf16_run["launches"]["sweep_group_cost[bfloat16]"],
                 "launches_by_path": {"vis_mvsnet_bf16": k2g_bf16_run["launches"]["sweep_group_cost[bfloat16]"]},
                 "launches_per_frame": {"vis_mvsnet_bf16":
                                        k2g_bf16_run["launches_per_frame"]["sweep_group_cost[bfloat16]"]},
                 "cases": {case: {k: r[k] for k in ("route", "max_abs_err", "limit", "ms", "plain_ms",
                                                    "grid_sample_route_ms", "bound_ms", "bound_by", "bound_share")}
                           for case, r in k2g_bf16.items()}},
    }, {
        "name": "soft_argmin",
        "route": "cuda",
        "status": "redesigned",
        "source": "robustmvd_tpu_torch/csrc/soft_argmin.cu",
        "replaces": "robustmvd_tpu/ops/pallas/softargmin.py:46 (fused_soft_argmin, pallas_call :92)",
        "launches": vis["banded"]["fp32"]["launches"]["soft_argmin"],
        "launches_by_path": {"vis_mvsnet": vis["banded"]["fp32"]["launches"]["soft_argmin"],
                             "vis_rmvd_checkpoint": vis_rmvd["soft_argmin"],
                             "train_vis": vis_train["launches"]["soft_argmin"],
                             "train_vis_bf16": vis_train_bf16["launches"]["soft_argmin"],
                             "train_vis_parity": vis_parity["launches_card"]["soft_argmin"],
                             "train_vis_ddp": train_vis_ddp["launches"]["soft_argmin"]},
        "launches_per_train_step": {"train_vis": vis_train["launches_per_step"]["soft_argmin"],
                                    "train_vis_bf16": vis_train_bf16["launches_per_step"]["soft_argmin"]},
        # the closed-form backward in torch ops (no kernel) at vis's training readouts, 256x320, batch 2
        "backward": {case: {k: r[k] for k in ("max_abs_err", "limit", "flipped_share", "forward_ms", "backward_ms",
                                              "plain_forward_backward_ms", "bound_ms", "bound_by")}
                     for case, r in k3_grad.items()},
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
        "launches_per_train_step": {"train_vis": vis_train["launches_per_step"]["conv3d_banded"],
                                    "train_vis_bf16": vis_train_bf16["launches_per_step"]["conv3d_banded[float32]"]},
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
        "bf16": {**{k: k5_bf16["vis_stage3_reg"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "f32_ms")},
                 "max_abs_err": max(r["max_abs_err"] for r in k5_bf16.values()),
                 "library_ms": k5_bf16["vis_stage3_reg"]["library_ms"],  # F.conv3d (cuDNN) at bf16
                 "launches": sum(k5_bf16_launches.values()), "launches_by_path": k5_bf16_launches,
                 "launches_per_frame": {f"{path}_bf16": r["launches_per_frame"]["conv3d_banded[bfloat16]"]
                                        for path, r in k5_bf16_runs.items()},
                 "launches_per_train_step": {"train_vis_bf16":
                                             vis_train_bf16["launches_per_step"]["conv3d_banded[bfloat16]"]},
                 "cases": {case: {k: r[k] for k in ("max_abs_err", "limit", "differing_share", "ms", "plain_ms",
                                                    "library_ms", "weight_layout_ms", "f32_ms", "bound_ms",
                                                    "bound_by")}
                           for case, r in k5_bf16.items()},
                 # faster than F.conv3d bf16 at each (K5_BF16_MUST_BEAT_LIBRARY, checked in phase kernel)
                 "beats_library": {case: k5_bf16[case]["ms"] < k5_bf16[case]["library_ms"]
                                   for case in K5_BF16_MUST_BEAT_LIBRARY},
                 # the 18 shapes of the main path's vis bf16 frame, each timed alone, weighted by its calls per
                 # frame in that run (their sum checked equal to launches_per_frame["vis_mvsnet_bf16"])
                 "vis_bf16_frame": {"distinct_shapes": k5_frame["distinct_shapes"], **k5_frame["call_weighted"]},
                 # the profiled vis bf16 frame's K5 device ms: the bf16 mma route, the float32 score heads
                 "vis_bf16_frame_profiled_ms_by_form": family_bf16["vis_mvsnet", "k5_ms_by_form"]},
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
