#!/usr/bin/env python3
"""Time design variants of the PyTorch port's K2, K2 group (float32 and bf16), K3, K4 and K5 bf16 CUDA kernels.

    python3 tools/torch_kernel_variants.py [--kernels k2,k2_group,k2_group_bf16,k4,k3,k5_bf16] [--baseline DIR]
                                           [--out FILE]

Runs from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Builds copies of ``robustmvd_tpu_torch/csrc/sweep_warp.cu`` (K2),
``sweep_group_cost.cu`` (K2 group, its group route and, for
``k2_group_bf16``, the bf16 lane route), ``soft_argmin.cu`` (K3),
``warp_volume.cu`` (K4) and ``conv3d_banded.cu`` (K5's bf16 form), each with
one design choice changed (threads per block, row tiles, planes per block,
where K2 group reads the key; the bf16 lane route's taps, planes a turn,
lane width, planes a lane, a source band in shared memory; K5 bf16's tile by
Cout; for K5 bf16 also ablations that drop the halo copies, the weights'
copies, the transposition or the products, timed to show where its time
goes), into ``build/variants/``; with
``--baseline``, also the sources of the same names found in DIR (an earlier
commit's, e.g. from ``git show <commit>:robustmvd_tpu_torch/csrc/<name>.cu``).
Each variant is loaded with ctypes in place of the built kernel, held
against the plain version at ``chip_smoke.py``'s shapes (K2 and K2 group,
float32 and bf16, bit for bit at every case of ``k2_cases`` and
``k2_group_cases``; K4 bit for bit
at mvsnet's (1, 256, 96, 320, 32), f32 and bf16 features; K3 within
``K3_LIMITS`` at vis_mvsnet's six readout shapes) and timed with
``chip_smoke.time_ms``, twice, in the order A B C ... C B A. The yardsticks
(the ``grid_sample`` routes, ``F.grid_sample``, ``torch.softmax``) are timed
in the same turns. Each kernel is also timed inside its models: its device
time per frame in torch.profiler over ``model.run`` at 384x1280 with 1+2
views (chip_smoke.py's main paths: mvsnet_train and cvp_mvsnet for K2,
vis_mvsnet for K2 group and K3, vis_mvsnet at bf16 for K2 group's bf16 form
and K5's), per variant (K2, K2 group: the repo's source and the baseline),
in the same order. Prints one JSON line per kernel, with the ptxas report
(and for ``k2_group_bf16`` the SASS opcode counts of vis's lane kernel),
and writes them to FILE (default ``build/kernel_variants.jsonl``).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the shapes, limits and timer of the chip check)

# variant -> {text in the source: its replacement}
K4_VARIANTS = {
    "tile128": {"constexpr int kMaxTile = 512;": "constexpr int kMaxTile = 128;"},
    "tile256": {"constexpr int kMaxTile = 512;": "constexpr int kMaxTile = 256;"},
    "threads256": {"constexpr int kThreads = 128;": "constexpr int kThreads = 256;"},
    "threads512": {"constexpr int kThreads = 128;": "constexpr int kThreads = 512;"},
}
K3_VARIANTS = {
    "threads64": {"constexpr int kThreads = 128;": "constexpr int kThreads = 64;"},
    "threads256": {"constexpr int kThreads = 128;": "constexpr int kThreads = 256;"},
}
K2_VARIANTS = {
    "tile128": {"constexpr int kMaxTile = 512;": "constexpr int kMaxTile = 128;"},
    "tile256": {"constexpr int kMaxTile = 512;": "constexpr int kMaxTile = 256;"},
    "planes1": {"constexpr int kPlanes = 2;": "constexpr int kPlanes = 1;"},
    "planes4": {"constexpr int kPlanes = 2;": "constexpr int kPlanes = 4;"},
    "threads256": {"constexpr int kThreads = 128;": "constexpr int kThreads = 256;"},
}
K2_GROUP_VARIANTS = {
    "threads256": {"constexpr int kThreads = 128;": "constexpr int kThreads = 256;"},
    "threads512": {"constexpr int kThreads = 128;": "constexpr int kThreads = 512;"},
    "planes4": {"constexpr int kPlanes = 8;": "constexpr int kPlanes = 4;"},
    "planes16": {"constexpr int kPlanes = 8;": "constexpr int kPlanes = 16;"},
    "tile32": {"constexpr int kMaxTile = 64;": "constexpr int kMaxTile = 32;"},
    "tile128": {"constexpr int kMaxTile = 64;": "constexpr int kMaxTile = 128;",
                "constexpr int kTileFloats = 2048;": "constexpr int kTileFloats = 4096;"},
    # the key read in place with __ldg (through L1) instead of staged in shared memory
    "key_in_place": {"if (taps + key <= kSmemBytes) {": "if (false) {"},
}
# K2 group's bf16 form (the lane route; at C 32, G 8 two lanes of 32 bytes a
# pixel, 2 planes a turn, 16 planes a lane): each lane computing every
# plane's taps itself instead of receiving them by shuffle; 1 plane a turn;
# lanes of 16 bytes (4 a pixel, 4 planes a turn), 8 bytes (8 a pixel) or 64
# bytes (1 a pixel, its own taps); 4, 8 or 32 planes a lane
LANE_BYTES = "constexpr int kLaneBytes = 32;"
LANE_PLANES = "constexpr int kLanePlanes = 16;"
K2_GROUP_BF16_VARIANTS = {
    "taps_per_lane": {"constexpr bool kShuffleTaps = true;": "constexpr bool kShuffleTaps = false;"},
    "unroll1": {"constexpr int kUnroll = 4;": "constexpr int kUnroll = 1;"},
    "lanes4": {LANE_BYTES: LANE_BYTES.replace("32", "16")},
    "lanes8": {LANE_BYTES: LANE_BYTES.replace("32", "8")},
    "lanes1": {LANE_BYTES: LANE_BYTES.replace("32", "64")},
    "planes4": {LANE_PLANES: LANE_PLANES.replace("16", "4")},
    "planes8": {LANE_PLANES: LANE_PLANES.replace("16", "8")},
    "planes32": {LANE_PLANES: LANE_PLANES.replace("16", "32")},
    # registers capped for 5 resident blocks of 128 threads an SM (<= 102 a thread; the repo takes 128)
    "minblocks5": {"__global__ void __launch_bounds__(kLaneThreads)":
                   "__global__ void __launch_bounds__(kLaneThreads, 5)"},
}
# the source band in shared memory instead of L1: each turn the block takes the rows and columns its taps
# span (taps whose tents are all 0 read the band's first cell), copies them into 32 KB of shared memory
# where they fit and its pixels share one batch element, and gathers from there (else from global memory
# as the repo does); two barriers a turn, the window's bounds by warp reductions and shared atomics
K2_GROUP_BF16_BAND = {
    """  const int64_t plane = HW * G;  // between one plane's outputs and the next's
""": """  const int64_t plane = HW * G;  // between one plane's outputs and the next's
  constexpr int kBandBytes = 32 * 1024;
  __shared__ uint4 band[kBandBytes / 16];
  __shared__ int band_box[2][4];  // rows min, max, columns min, max; by the turn's parity
  const __nv_bfloat16* src_b = src + (int64_t)b * Hs * Ws * C;
  const int64_t block_first = (int64_t)blockIdx.x * (kLaneThreads / LPP);
  const int64_t block_last = block_first + kLaneThreads / LPP - 1;
  const bool one_batch = block_first / HW == (block_last < B * HW ? block_last : B * HW - 1) / HW;
  if (threadIdx.x == 0) band_box[0][0] = band_box[0][2] = 0x7fffffff, band_box[0][1] = band_box[0][3] = -1;
  __syncthreads();
  int turn = 0;
""",
    """      int off[U], dx[U], dy[U];
      float4 wt[U];
      if constexpr (kShuffle) {
        int o = 0, ox = 0, oy = 0;
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (active && d + part % U < d1)
          homography_corner(Am, Bmm, __ldg(w_turn + part % U * HW), xf, yf, Hs, Ws, C, o, ox, oy, t);
""": """      int off[U], dx[U], dy[U];
      float4 wt[U];
      bool staged = false;
      if constexpr (kShuffle) {
        int o = 0, ox = 0, oy = 0;
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (active && d + part % U < d1)
          homography_corner(Am, Bmm, __ldg(w_turn + part % U * HW), xf, yf, Hs, Ws, C, o, ox, oy, t);
        const bool touches = (t.x != 0.0f || t.y != 0.0f) && (t.z != 0.0f || t.w != 0.0f);
        const int cell = o / C, ty = cell / Ws, tx = cell - ty * Ws;
        int* box = band_box[turn & 1];
        {
          const int r0 = __reduce_min_sync(kFullMask, touches ? ty : 0x7fffffff);
          const int r1 = __reduce_max_sync(kFullMask, touches ? ty + (oy != 0) : -1);
          const int c0 = __reduce_min_sync(kFullMask, touches ? tx : 0x7fffffff);
          const int c1 = __reduce_max_sync(kFullMask, touches ? tx + (ox != 0) : -1);
          if ((threadIdx.x & 31) == 0) {
            atomicMin(box, r0), atomicMax(box + 1, r1), atomicMin(box + 2, c0), atomicMax(box + 3, c1);
          }
        }
        __syncthreads();
        const int r0 = box[0], r1 = box[1], c0 = box[2], c1 = box[3];
        const int nr = r1 - r0 + 1, nc = c1 - c0 + 1;
        staged = one_batch && r0 <= r1 && (int64_t)nr * nc * C * 2 <= kBandBytes;
        if (threadIdx.x == 0) {  // the next turn's box, read by no one since this turn's first barrier
          int* next = band_box[(turn + 1) & 1];
          next[0] = next[2] = 0x7fffffff, next[1] = next[3] = -1;
        }
        if (staged) {
          const int per_row = nc * C / 8;  // 16-byte pieces
          for (int i = threadIdx.x; i < nr * per_row; i += kLaneThreads) {
            const int r = i / per_row;
            band[i] = __ldg(reinterpret_cast<const uint4*>(src_b + ((int64_t)(r0 + r) * Ws + c0) * C) +
                            (i - r * per_row));
          }
          o = touches ? ((ty - r0) * nc + (tx - c0)) * C : 0;
          ox = touches ? ox : 0;
          oy = touches && oy != 0 ? nc * C : 0;
        }
        __syncthreads();
        ++turn;
""",
    """        const __nv_bfloat16* t00 = map + off[j];
        load_words<WORDS>(t00, raw[j][0]);
""": """        if (staged) {
          const __nv_bfloat16* s00 = reinterpret_cast<const __nv_bfloat16*>(band) + part * LC + off[j];
          const __nv_bfloat16* taps[4] = {s00, s00 + dx[j], s00 + dy[j], s00 + dy[j] + dx[j]};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int i = 0; i < WORDS / 4; ++i) {
              const uint4 a = reinterpret_cast<const uint4*>(taps[k])[i];
              raw[j][k][4 * i] = a.x, raw[j][k][4 * i + 1] = a.y;
              raw[j][k][4 * i + 2] = a.z, raw[j][k][4 * i + 3] = a.w;
            }
          }
          continue;
        }
        const __nv_bfloat16* t00 = map + off[j];
        load_words<WORDS>(t00, raw[j][0]);
""",
}
K2_GROUP_BF16_VARIANTS["band_smem"] = K2_GROUP_BF16_BAND


# K5's bf16 form: tile choices by Cout, and ablations that drop one phase of
# a step (their outputs are wrong; they are timed, not checked)
K5_BF16_WIDE = "  return launch<Tile<8, 2, 1, 2, 2, 2>>(p, B, stream);"
K5_BF16_MID = "  if (Cout <= 16) return launch<Tile<4, 2, 4, 2, 1>>(p, B, stream);"
K5_BF16_NARROW = "  if (Cout <= 8) return launch<Tile<8, 2, 4, 1, 1>>(p, B, stream);"
K5_BF16_VARIANTS = {
    "mid_4x8x16": {K5_BF16_MID: K5_BF16_MID.replace("<4, 2, 4, 2, 1>", "<4, 4, 2, 2, 1>")},
    "narrow_tz4": {K5_BF16_NARROW: K5_BF16_NARROW.replace("<8, 2, 4, 1, 1>", "<4, 2, 4, 1, 1>")},
}
K5_BF16_ABLATIONS = {
    # the halo's TMA copy dropped, and its bytes from what the stage's barrier expects
    "no_copies": {"    if (threadIdx.x == T::ISSUER) tma_load(st, &p.map, bar_of<T>(st), o.x0 - 8, c0, o.y0 - 1, o.z0 - 1, o.b);\n": "",
                  "(p.tma ? T::STAGE : 0)": "0"},
    "no_transpose": {"      transpose<T>(st, kg);\n": ""},
    # the weights' TMA copies dropped, and their bytes from what the barrier expects
    "no_weight_copies": {"    for (int k = 0; k < nw; ++k) tma_load(": "    for (int k = 0; k < 0; ++k) tma_load(",
                         " + nw * T::WCHUNK);": ");"},
    "no_products": {"    if (c + kg < p.chunks) multiply<T>(": "    if (false) multiply<T>("},
}


def build_variants(name, variants, baseline):
    """{variant: library path}: the repo's source as "repo", each variant,
    and the baseline's source; all compiled in parallel."""
    from robustmvd_tpu_torch.ops.kernels import build

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / f"{name}.cu").read_text()
    sources = {"repo": text}
    for variant, edits in variants.items():
        edited = text
        for old, new in edits.items():
            if old not in edited:
                raise RuntimeError(f"{name} variant {variant}: {old!r} is not in the source")
            edited = edited.replace(old, new)
        sources[variant] = edited
    if baseline:
        sources["baseline"] = (Path(baseline) / f"{name}.cu").read_text()
    procs = {}
    for variant, src in sources.items():
        cu, lib = out_dir / f"{name}_{variant}.cu", out_dir / f"lib{name}_{variant}.so"
        cu.write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {variant}:\n{log}")
        libs[variant] = lib
        ptxas[variant] = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        ptxas[variant + "_by_kernel"] = ptxas_by_kernel(log)
    return libs, ptxas


def ptxas_by_kernel(log):
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas -v``'s report."""
    import re

    kernels, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = entry.group(1)
            kernels[current] = {}
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and current:
            kernels[current].update(spill_stores=int(spills.group(1)), spill_loads=int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and current:
            kernels[current]["registers"] = int(regs.group(1))
    return kernels


def sass_opcodes(lib, match):
    """{"instructions", "by_opcode"} of the kernel in library ``lib`` whose
    mangled name holds ``match``, counted in ``cuobjdump -sass``'s listing
    (``cuobjdump`` beside ``nvcc``); None where no kernel matches."""
    import collections
    import re

    from robustmvd_tpu_torch.ops.kernels import build

    cuobjdump = str(Path(build._nvcc()).with_name("cuobjdump"))
    listing = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True,
                             timeout=300).stdout
    for function in re.split(r"\n\s*Function : ", listing)[1:]:
        if match in function.split("\n", 1)[0]:
            ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", function))
            return {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common())}
    return None


def use(name, lib):
    """Make the wrapper of kernel ``name`` call the library at ``lib``."""
    from robustmvd_tpu_torch.ops.kernels import build

    build._loaded[name] = ctypes.CDLL(str(lib))


def in_turns(labels, time_one):
    """{label: [ms first turn, ms second turn]}, in the order A B ... B A."""
    times = {label: [] for label in labels}
    for label in list(labels) + list(reversed(labels)):
        times[label].append(time_one(label))
    return times


def k4(baseline):
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.homography import plane_sweep_transform, sweep_coordinates
    from robustmvd_tpu_torch.ops.kernels.warp_volume import homo_warp_volume, homo_warp_volume_reference

    libs, ptxas = build_variants("warp_volume", K4_VARIANTS, baseline)
    src32, proj, inv, depth = chip_smoke.k4_inputs(torch.device("cuda"))
    B, H, W, C = src32.shape
    D = depth.shape[1]
    report = {"name": "warp_volume", "shape": [B, D, H, W, C], "ptxas": ptxas,
              "bound": chip_smoke.k4_bound(src32, depth)}
    for mode, src in (("f32", src32), ("bf16", src32.bfloat16())):
        plain = homo_warp_volume_reference(src, proj, inv, depth)
        for variant, lib in libs.items():
            use("warp_volume", lib)
            if not torch.equal(homo_warp_volume(src, proj, inv, depth), plain):
                raise AssertionError(f"K4 {variant} {mode} differs from its plain version")
        del plain
        torch.cuda.empty_cache()

        def time_one(variant):
            use("warp_volume", libs[variant])
            return chip_smoke.time_ms(lambda: homo_warp_volume(src, proj, inv, depth))

        report[mode] = in_turns(list(libs), time_one)
    rot, trans = plane_sweep_transform(proj, inv)
    xi, yi = sweep_coordinates(rot, trans, depth, H, W, H, W)
    grid = torch.stack([(2 * xi + 1) / W - 1, (2 * yi + 1) / H - 1], -1).reshape(B, D * H, W, 2)
    src_c = src32.permute(0, 3, 1, 2).contiguous()
    report["grid_sample_f32_ms"] = chip_smoke.time_ms(
        lambda: F.grid_sample(src_c, grid, mode="bilinear", padding_mode="zeros", align_corners=False),
        runs=10, warmup=2)
    use("warp_volume", libs["repo"])
    return report


def k3(baseline):
    import torch

    from robustmvd_tpu_torch.models.vis_mvsnet import DEPTH_NUMS, FEATURE_STRIDES
    from robustmvd_tpu_torch.ops.kernels.soft_argmin import fused_soft_argmin, fused_soft_argmin_reference

    libs, ptxas = build_variants("soft_argmin", K3_VARIANTS, baseline)
    report = {"name": "soft_argmin", "ptxas": ptxas, "cases": {}}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for stage, (D, stride) in enumerate(zip(DEPTH_NUMS, FEATURE_STRIDES), 1):
        for readout, B in (("pair", 2), ("fused", 1)):
            vol = torch.randn((B, D, 384 // stride, 1280 // stride), generator=gen, device="cuda") * 3
            plain = fused_soft_argmin_reference(vol, window=2)
            limits = (chip_smoke.K3_LIMITS[0], chip_smoke.K3_LIMITS[1] + 1e-6 * D, chip_smoke.K3_LIMITS[2])
            for variant, lib in libs.items():
                use("soft_argmin", lib)
                out = fused_soft_argmin(vol, window=2)
                errs = [float((a - b).abs().max()) for a, b in zip(out[:3], plain[:3])]
                flipped = float(((out[3] - plain[3]).abs() > 1e-5).float().mean())
                if not (all(e <= lim for e, lim in zip(errs, limits)) and flipped <= chip_smoke.FLIPPED_SHARE):
                    raise AssertionError(f"K3 {variant} stage {stage} {readout}: {errs}, flipped {flipped}")

            def time_one(variant):
                if variant == "torch.softmax":
                    return chip_smoke.time_ms(lambda: torch.softmax(vol, dim=1))
                use("soft_argmin", libs[variant])
                return chip_smoke.time_ms(lambda: fused_soft_argmin(vol, window=2))

            report["cases"][f"stage{stage}_{readout}"] = {
                "shape": list(vol.shape), "bound": chip_smoke.k3_bound(vol),
                "ms": in_turns([*libs, "torch.softmax"], time_one)}
    report["in_vis_mvsnet"] = in_model("soft_argmin", "soft_argmin", "vis_mvsnet", libs)
    use("soft_argmin", libs["repo"])
    return report


def in_model(name, match, model_name, libs, frames=5, dtype="float32"):
    """{variant: [device ms per frame of the kernels whose name holds
    ``match`` (a string, or a tuple of them), first and second turn]} over
    ``model_name`` frames at 384x1280, 1+2 views, from torch.profiler, with
    kernel ``name`` loaded from each library of ``libs`` in turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import robustmvd_tpu_torch as rmvd

    model = rmvd.create_model(model_name, dtype=dtype)
    sample = chip_smoke.sideways_sample(chip_smoke.np.random.RandomState(8), 384, 1280, 3)
    chip_smoke.set_tf32(False)

    def time_one(variant):
        use(name, libs[variant])
        model.run(**sample)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                model.run(**sample)
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if any(m in e.key for m in ((match,) if isinstance(match, str) else match)):
                dev_us = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if dev_us is None else dev_us
        return us / 1e3 / frames

    times = in_turns(list(libs), time_one)
    use(name, libs["repo"])
    del model
    torch.cuda.empty_cache()
    return times


def k2(baseline):
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_warp import sweep_variance, sweep_variance_reference

    libs, ptxas = build_variants("sweep_warp", K2_VARIANTS, baseline)
    report = {"name": "sweep_warp", "ptxas": ptxas, "cases": {}}
    for case, (ref, src, rot, trans, depth) in chip_smoke.k2_cases(torch.device("cuda")).items():
        valid = torch.ones((1, src.shape[1]), device=ref.device)
        plain = sweep_variance_reference(ref, src, rot, trans, depth, valid)
        for variant, lib in libs.items():
            use("sweep_warp", lib)
            if not torch.equal(sweep_variance(ref, src, rot, trans, depth, valid), plain):
                raise AssertionError(f"K2 {variant} {case} differs from its plain version")
        del plain
        torch.cuda.empty_cache()
        route = chip_smoke.grid_sample_route(ref, src, rot, trans, depth)

        def time_one(variant):
            if variant == "grid_sample_route":
                return chip_smoke.time_ms(route, runs=10, warmup=2)
            use("sweep_warp", libs[variant])
            return chip_smoke.time_ms(lambda: sweep_variance(ref, src, rot, trans, depth, valid))

        report["cases"][case] = {"shape": [*ref.shape, src.shape[1], depth.shape[1]],
                                 "bound": chip_smoke.k2_bound(ref, src, torch.float32, depth),
                                 "ms": in_turns([*libs, "grid_sample_route"], time_one)}
        del route
        torch.cuda.empty_cache()
    pair = {k: libs[k] for k in ("repo", "baseline") if k in libs}
    report["in_models"] = {m: in_model("sweep_warp", "sweep_warp", m, pair) for m in ("mvsnet_train", "cvp_mvsnet")}
    use("sweep_warp", libs["repo"])
    return report


def k2_group(baseline):
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import (
        homography_group_cost,
        homography_group_cost_reference,
    )

    libs, ptxas = build_variants("sweep_group_cost", K2_GROUP_VARIANTS, baseline)
    report = {"name": "sweep_group_cost", "ptxas": ptxas, "cases": {}}
    for case, (ref, src, A, Bm, w) in chip_smoke.k2_group_cases(torch.device("cuda")).items():
        plain = homography_group_cost_reference(ref, src, A, Bm, w)
        for variant, lib in libs.items():
            use("sweep_group_cost", lib)
            if not torch.equal(homography_group_cost(ref, src, A, Bm, w), plain):
                raise AssertionError(f"K2 group {variant} {case} differs from its plain version")
        route = chip_smoke.group_grid_sample_route(ref, src, A, Bm, w, 8)

        def time_one(variant):
            if variant == "grid_sample_route":
                return chip_smoke.time_ms(route, runs=10, warmup=2)
            use("sweep_group_cost", libs[variant])
            return chip_smoke.time_ms(lambda: homography_group_cost(ref, src, A, Bm, w))

        report["cases"][case] = {"shape": [*w.shape, ref.shape[3], 8],
                                 "bound": chip_smoke.k2_group_bound(ref, src, w, 8),
                                 "ms": in_turns([*libs, "grid_sample_route"], time_one)}
    pair = {k: libs[k] for k in ("repo", "baseline") if k in libs}
    report["in_models"] = {"vis_mvsnet": in_model("sweep_group_cost", "homography_group_cost", "vis_mvsnet", pair)}
    use("sweep_group_cost", libs["repo"])
    return report


def k2_group_bf16(baseline):
    """K2 group's bf16 form (bf16 features and output, as vis_mvsnet's bf16
    path calls it) at chip_smoke.py's three stage shapes: each variant of
    the lane route bit for bit against the plain version (w per pixel, and
    per plane as stage 1 passes it), then timed in turns with the baseline
    (an earlier ``sweep_group_cost.cu``); the float32 form in turns (the
    repo's group route, the baseline), each bit for bit; the ptxas report of the lane kernel at vis's C 32, G 8; the
    bf16 form inside vis_mvsnet at bf16, repo against baseline."""
    import torch

    from robustmvd_tpu_torch.ops.kernels.sweep_group_cost import (
        homography_group_cost,
        homography_group_cost_reference,
        homography_group_cost_route,
    )

    libs, ptxas = build_variants("sweep_group_cost", K2_GROUP_BF16_VARIANTS, baseline)
    # <bf16 out, C/G 4, any lanes a pixel>: vis_mvsnet's bf16 call
    vis_kernel = {variant: {k: v for k, v in kernels.items() if "lanes_kernelI13__nv_bfloat16Li4E" in k}
                  for variant, kernels in ptxas.items() if variant.endswith("_by_kernel")}
    # vis_mvsnet's instantiation <bf16 out, C/G 4, 2 lanes a pixel>, as the repo compiles it
    report = {"name": "sweep_group_cost_bf16", "ptxas_lane_kernels": vis_kernel, "cases": {},
              "sass_vis_kernel": sass_opcodes(libs["repo"], "lanes_kernelI13__nv_bfloat16Li4ELi2EE")}
    bf16 = torch.bfloat16
    for case, (ref32, src32, A, Bm, w) in chip_smoke.k2_group_cases(torch.device("cuda")).items():
        ref, src = ref32.bfloat16(), src32.bfloat16()
        D = w.shape[1]
        per_plane = w.mean(dim=(2, 3), keepdim=True).expand_as(w).contiguous()
        use("sweep_group_cost", libs["repo"])
        route = homography_group_cost_route(ref, src, out_dtype=bf16)
        for w_in in (w, per_plane):
            plain = homography_group_cost_reference(ref, src, A, Bm, w_in, out_dtype=bf16)
            for variant, lib in libs.items():
                use("sweep_group_cost", lib)
                if not torch.equal(homography_group_cost(ref, src, A, Bm, w_in, out_dtype=bf16), plain):
                    raise AssertionError(f"K2 group bf16 {variant} {case} differs from its plain version")
            del plain
        plain32 = homography_group_cost_reference(ref32, src32, A, Bm, w)
        for variant in ("repo", "baseline"):
            if variant in libs:
                use("sweep_group_cost", libs[variant])
                if not torch.equal(homography_group_cost(ref32, src32, A, Bm, w), plain32):
                    raise AssertionError(f"K2 group float32 {variant} {case} differs from its plain version")
        del plain32, per_plane
        torch.cuda.empty_cache()

        def time_bf16(variant):
            use("sweep_group_cost", libs[variant])
            return chip_smoke.time_ms(lambda: homography_group_cost(ref, src, A, Bm, w, out_dtype=bf16))

        def time_f32(variant):
            use("sweep_group_cost", libs[variant])
            return chip_smoke.time_ms(lambda: homography_group_cost(ref32, src32, A, Bm, w))

        report["cases"][case] = {
            "shape": [*w.shape, ref.shape[3], 8], "route": route, "D": D,
            "bound": chip_smoke.k2_group_bound(ref, src, w, 8, out_bytes=2),
            "bound_f32": chip_smoke.k2_group_bound(ref32, src32, w, 8),
            "ms": in_turns(list(libs), time_bf16),
            "f32_ms": in_turns([v for v in ("repo", "baseline") if v in libs], time_f32)}
    pair = {k: libs[k] for k in ("repo", "baseline") if k in libs}
    report["in_vis_mvsnet_bf16"] = in_model("sweep_group_cost", "homography_group_cost", "vis_mvsnet", pair,
                                            dtype="bfloat16")
    use("sweep_group_cost", libs["repo"])
    return report


def k5_bf16(baseline):
    """K5's bf16 form at chip_smoke.py's K5_CASES with Cout > 4 (NCDHW, an
    nn.Conv3d weight): each variant within K5_BF16_LIMIT of the plain
    version, the ablations unchecked; all timed in turns beside cuDNN's
    ``F.conv3d`` at bf16; then the float32 form at all six K5_CASES and the
    bf16 form inside vis_mvsnet at bf16 (repo and baseline, in turns)."""
    import torch
    import torch.nn.functional as F

    from robustmvd_tpu_torch.ops.kernels.conv3d import (conv3d_banded, conv3d_banded_bf16_weights,
                                                         conv3d_banded_reference)

    libs, ptxas = build_variants("conv3d_banded", {**K5_BF16_VARIANTS, **K5_BF16_ABLATIONS}, baseline)
    report = {"name": "conv3d_banded_bf16", "ptxas": ptxas, "cases": {}}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for case, (shape, cout, _) in chip_smoke.K5_CASES.items():
        if cout <= 4:
            continue
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        weight = (torch.randn((cout, shape[1], 3, 3, 3), generator=gen, device="cuda") / (27 * shape[1]) ** 0.5)
        weight = weight.to(torch.bfloat16)
        k = conv3d_banded_bf16_weights(weight.permute(2, 3, 4, 1, 0))  # laid out once, as cuDNN's is cast once
        plain = conv3d_banded_reference(x.movedim(1, -1), k).movedim(-1, 1).float()
        scale = float(plain.abs().max())
        for variant, lib in libs.items():
            if variant in K5_BF16_ABLATIONS:
                continue
            use("conv3d_banded", lib)
            err = float((conv3d_banded(x, k, None, channels_first=True).float() - plain).abs().max())
            if not err <= chip_smoke.K5_BF16_LIMIT * scale:
                raise AssertionError(f"K5 bf16 {variant} {case}: max_abs_err {err} > {chip_smoke.K5_BF16_LIMIT} x {scale}")
        del plain
        torch.cuda.empty_cache()

        def time_one(variant):
            if variant == "cudnn":
                return chip_smoke.time_ms(lambda: F.conv3d(x, weight, None, padding=1))
            use("conv3d_banded", libs[variant])
            return chip_smoke.time_ms(lambda: conv3d_banded(x, k, None, channels_first=True))

        report["cases"][case] = {"shape": list(shape), "cout": cout, "bound": chip_smoke.k5_bound_bf16(x, cout),
                                 "ms": in_turns([*libs, "cudnn"], time_one)}
    pair = {k: libs[k] for k in ("repo", "baseline") if k in libs}
    # the float32 form (its code was reshaped around the bf16 route): repo and baseline at the six K5_CASES
    report["f32_cases"] = {}
    for case, (shape, cout, with_bias) in chip_smoke.K5_CASES.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        k = (torch.randn((cout, shape[1], 3, 3, 3), generator=gen, device="cuda") / (27 * shape[1]) ** 0.5)
        k = k.permute(2, 3, 4, 1, 0)
        bias = torch.randn((cout,), generator=gen, device="cuda") if with_bias else None

        def time_f32(variant):
            use("conv3d_banded", pair[variant])
            return chip_smoke.time_ms(lambda: conv3d_banded(x, k, bias, channels_first=True))

        report["f32_cases"][case] = in_turns(list(pair), time_f32)
    # vis's bf16 frame runs no float32 tensor-core K5: conv3d_k3_kernel_mma is a baseline's bf16 form
    report["in_vis_mvsnet_bf16"] = in_model("conv3d_banded", ("conv3d_k3_bf16_kernel", "conv3d_k3_kernel_mma"),
                                            "vis_mvsnet", pair, dtype="bfloat16")
    use("conv3d_banded", libs["repo"])
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="k2,k2_group,k2_group_bf16,k4,k3,k5_bf16",
                        help="comma-separated, from k2, k2_group, k2_group_bf16, k4, k3, k5_bf16 (default: all, "
                             "in that order)")
    parser.add_argument("--baseline", help="a directory with earlier sources of the kernels (csrc/<name>.cu)")
    parser.add_argument("--out", default=str(ROOT / "build" / "kernel_variants.jsonl"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for kernel in args.kernels.split(","):
            report = {"k2": k2, "k2_group": k2_group, "k2_group_bf16": k2_group_bf16, "k4": k4, "k3": k3,
                      "k5_bf16": k5_bf16}[kernel](args.baseline)
            line = json.dumps({"card": card, **report})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
