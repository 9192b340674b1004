// Fused plane-sweep warp + variance (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/sweep_warp.py (_call_sweep
// with kernel _sweep_kernel, variance aggregation), which serves the entries
// warp_variance, warp_variance_rt and warp_variance_dense there. For every
// output pixel (b, d, y, x) and channel c it writes
//
//     out = E[f^2] - E[f]^2   over f in {ref[b, y, x, c]} and, for each source
//                             view v with valid[b, v] = 1, the bilinear sample
//                             of src[b, v, :, :, c] at the plane-sweep point
//
// in float32 registers, and stores only the result. The sweep point of the
// reference pixel (x, y) at depth z (one per plane, or one per pixel in the
// dense mode) in source view v with transform (R, T) is
//
//     p  = (R[:, 0] * x + R[:, 1] * y + R[:, 2]) * z + T
//     xi = p_x / p_z * sx - 0.5,   yi = p_y / p_z * sy - 0.5
//
// (sx = Ws / (Ws - 1), the reference's align_corners quirk), sampled with
// zeros padding. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), in the order of the plain torch version
// in ops/kernels/sweep_warp.py (views in order, taps 00, 01, 10, 11), so the
// card and the CPU round alike. Non-finite coordinates become 1e9 (all taps
// outside), and the floor is clamped to +-2^30 before the integer cast.
//
// Bound: bytes. The output volume (B*D*H*W*C values, 1 GB at mvsnet's
// 256 planes) is written once and dominates; the key and source maps (a few
// MB each) are read from L2, and the work is ~15 flops per (pixel, view) for
// the coordinates plus ~11 per channel, far below the ~20 flop/byte at which
// the H100's f32 rate binds. Behind the bytes, the gathers: four 16-byte
// tap loads per (vector, view) through L1 and L2, ~8 GB of requests per call
// at mvsnet's shape against the 1 GB written, and 8 IEEE divisions and ~90
// rounded products and sums per 8-channel vector.
//
// Design: the TPU kernel turns sampling into x-tent matmuls over bands of
// source rows because a TPU cannot gather; Hopper gathers. A block takes one
// tile of one output row: the tile along W from blockIdx.x (W split into
// equal tiles of at most kMaxTile pixels, fewer where many views must fit
// in shared memory), the row y from blockIdx.y and b with a run of kPlanes
// planes from blockIdx.z, so no index is divided per pixel. For each plane,
// phase 1: one thread per pixel reads its depth and computes, once for each
// view, the four int32 tap offsets into the view's map (-1 off the map) and
// the four bilinear weights, into shared memory (32 B per (pixel, view)).
// Phase 2: the tile's output is one contiguous run of n * C values, which
// the block walks as vectors of VEC channels (VEC = 8 where C % 8 == 0 and
// the pointers are 16-byte aligned, else 1): each
// thread loads the key's vector, reads the taps from shared memory (a
// broadcast), gathers the four taps of each view with __ldg (an off-map
// tap reads a zero vector) and writes the variance with a streaming store
// (__stcs), so that the volume does not push the source maps out of L2.
// Views beyond what shared memory holds at the smallest tile (kMaxSlots /
// kMinTile, 48) have their taps computed in phase 2 by each thread, in the
// same op order. Per-map offsets are 32-bit: Hs * Ws * C < 2^31 is required.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 512;   // output pixels per block
constexpr int kMinTile = 32;    // the least a block takes where views are many
constexpr int kPlanes = 2;      // planes per block, one after another (the variants script's choice)
constexpr int kMaxSlots = 1536; // (pixel, view) taps in shared memory: 48 KB

// A zero vector that off-map taps read in place of the map (fewer registers
// than zero-filling each tap).
__device__ __align__(16) unsigned char kZeros[32] = {0};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void widen(uint32_t raw, float& lo, float& hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  lo = f.x, hi = f.y;
}

__device__ __forceinline__ uint32_t narrow(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// VEC (1 or 8) consecutive channels of one map position, widened to float:
// two 16-byte loads for float, one for bf16.
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(__ldg(p));
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    widen(raw.x, v[0], v[1]), widen(raw.y, v[2], v[3]), widen(raw.z, v[4], v[5]), widen(raw.w, v[6], v[7]);
  }
}

// Streaming stores (evict-first) of VEC values.
template <int VEC>
__device__ __forceinline__ void store_streaming(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      __stcs(reinterpret_cast<float4*>(p) + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

template <int VEC>
__device__ __forceinline__ void store_streaming(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16(v[0])));
  } else {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(narrow(v[0], v[1]), narrow(v[2], v[3]), narrow(v[4], v[5]), narrow(v[6], v[7])));
  }
}

// Taps of one (pixel, view), in the plain version's op order: element
// offsets of the taps (00, 01, 10, 11) into the view's map, -1 for a tap
// off the map, and the bilinear weights.
__device__ __forceinline__ void sweep_taps(const float* __restrict__ R, const float* __restrict__ T, float xf,
                                           float yf, float z, float sx, float sy, int Hs, int Ws, int C,
                                           int4& offset, float4& weight) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(R + 3 * i), xf), __fmul_rn(__ldg(R + 3 * i + 1), yf)),
                              __ldg(R + 3 * i + 2));
    p[i] = __fadd_rn(__fmul_rn(r, z), __ldg(T + i));
  }
  float xi = __fsub_rn(__fmul_rn(__fdiv_rn(p[0], p[2]), sx), 0.5f);
  float yi = __fsub_rn(__fmul_rn(__fdiv_rn(p[1], p[2]), sy), 0.5f);
  if (!isfinite(xi)) xi = 1e9f;
  if (!isfinite(yi)) yi = 1e9f;
  const float x0f = floorf(xi), y0f = floorf(yi);
  const float wx = __fsub_rn(xi, x0f), wy = __fsub_rn(yi, y0f);
  const float lim = 1073741824.0f;  // 2^30
  const int x0 = (int)fminf(fmaxf(x0f, -lim), lim);
  const int y0 = (int)fminf(fmaxf(y0f, -lim), lim);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  weight = make_float4(__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy));
  const bool x0_in = x0 >= 0 && x0 <= Ws - 1, x1_in = x0 >= -1 && x0 <= Ws - 2;
  const bool y0_in = y0 >= 0 && y0 <= Hs - 1, y1_in = y0 >= -1 && y0 <= Hs - 2;
  // modulo 2^32, exact for every tap on the map (Hs * Ws * C < 2^31)
  const uint32_t base = ((uint32_t)y0 * (uint32_t)Ws + (uint32_t)x0) * (uint32_t)C;
  const uint32_t below = (uint32_t)Ws * (uint32_t)C;
  offset = make_int4(x0_in && y0_in ? (int)base : -1, x1_in && y0_in ? (int)(base + C) : -1,
                     x0_in && y1_in ? (int)(base + below) : -1, x1_in && y1_in ? (int)(base + below + C) : -1);
}

template <typename TIn, typename TOut, int VEC>
__global__ void __launch_bounds__(kThreads)
sweep_warp_variance_kernel(const TIn* __restrict__ ref,      // (B, H, W, C)
                           const TIn* __restrict__ src,      // (B, V, Hs, Ws, C)
                           const float* __restrict__ rot,    // (B, V, 3, 3)
                           const float* __restrict__ trans,  // (B, V, 3)
                           const float* __restrict__ depth,  // (B, D) or (B, D, H, W)
                           const float* __restrict__ valid,  // (B, V)
                           TOut* __restrict__ out,           // (B, D, H, W, C)
                           int B, int V, int D, int H, int W, int Hs, int Ws, int C, int dense, float sx,
                           float sy, int tile, int vc, int dblocks) {
  // taps of (view v < vc, pixel i) at [v * tile + i]
  extern __shared__ int4 smem[];
  int4* tap_offset = smem;
  float4* tap_weight = reinterpret_cast<float4*>(smem + vc * tile);
  const TIn* zeros = reinterpret_cast<const TIn*>(kZeros);
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int n = min(tile, W - x0);
  const int lanes = C / VEC;  // vectors per pixel
  const int total = n * lanes;
  // this thread's first (pixel, vector) and its step of kThreads vectors
  const int first_pixel = threadIdx.x / lanes, first_vec = threadIdx.x % lanes;
  const int step_pixel = kThreads / lanes, step_vec = kThreads % lanes;
  const int64_t map_size = (int64_t)Hs * Ws * C;
  const float yf = (float)y;
  for (int bz = blockIdx.z; bz < B * dblocks; bz += gridDim.z) {
    const int b = bz / dblocks;
    const int d0 = (bz - b * dblocks) * kPlanes;
    const int planes = min(kPlanes, D - d0);
    float count = 1.0f;
    for (int v = 0; v < V; ++v) count = __fadd_rn(count, __ldg(valid + b * V + v));
    const TIn* key = ref + (((int64_t)b * H + y) * W + x0) * C;
    for (int p = 0; p < planes; ++p) {
      const int64_t bd = (int64_t)b * D + d0 + p;
      const float* zrow = depth + (dense ? (bd * H + y) * W + x0 : bd);
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float z = __ldg(zrow + (dense ? i : 0));
        for (int v = 0; v < vc; ++v) {
          const int bv = b * V + v;
          sweep_taps(rot + bv * 9, trans + bv * 3, (float)(x0 + i), yf, z, sx, sy, Hs, Ws, C,
                     tap_offset[v * tile + i], tap_weight[v * tile + i]);
        }
      }
      __syncthreads();
      TOut* run = out + ((bd * H + y) * W + x0) * C;
      int pixel = first_pixel, vec = first_vec;
      for (int j = threadIdx.x; j < total; j += kThreads) {
        const int c = vec * VEC;
        float vsum[VEC], vsq[VEC];
        load<VEC>(key + (int64_t)j * VEC, vsum);  // the key's run is contiguous like the output's
#pragma unroll
        for (int e = 0; e < VEC; ++e) vsq[e] = __fmul_rn(vsum[e], vsum[e]);
        for (int v = 0; v < V; ++v) {
          const int bv = b * V + v;
          int4 o;
          float4 w4;
          if (v < vc) {
            o = tap_offset[v * tile + pixel];
            w4 = tap_weight[v * tile + pixel];
          } else {  // more views than shared memory holds
            const float z = __ldg(zrow + (dense ? pixel : 0));
            sweep_taps(rot + bv * 9, trans + bv * 3, (float)(x0 + pixel), yf, z, sx, sy, Hs, Ws, C, o, w4);
          }
          const TIn* map = src + bv * map_size + c;
          const int offsets[4] = {o.x, o.y, o.z, o.w};
          const float weights[4] = {w4.x, w4.y, w4.z, w4.w};
          float a[4][VEC];
#pragma unroll
          for (int k = 0; k < 4; ++k) load<VEC>(offsets[k] >= 0 ? map + offsets[k] : zeros, a[k]);
          const float val = __ldg(valid + bv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float warped = __fmul_rn(a[0][e], weights[0]);
#pragma unroll
            for (int k = 1; k < 4; ++k) warped = __fadd_rn(warped, __fmul_rn(a[k][e], weights[k]));
            const float w = __fmul_rn(warped, val);
            vsum[e] = __fadd_rn(vsum[e], w);
            vsq[e] = __fadd_rn(vsq[e], __fmul_rn(w, w));
          }
        }
        float res[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float mean = __fdiv_rn(vsum[e], count);
          res[e] = __fsub_rn(__fdiv_rn(vsq[e], count), __fmul_rn(mean, mean));
        }
        store_streaming<VEC>(run + (int64_t)j * VEC, res);
        pixel += step_pixel;
        vec += step_vec;
        if (vec >= lanes) vec -= lanes, ++pixel;
      }
      __syncthreads();  // the taps are rewritten for the next plane
    }
  }
}

// The row tile for V views and rows of W pixels: at most kMaxTile pixels,
// fewer where the views' taps would not fit, at least kMinTile (views
// beyond vc, the views whose taps shared memory holds, are then computed in
// phase 2); W split into equal tiles.
void row_tiling(int V, int W, int& tiles, int& tile, int& vc) {
  const int cap = std::max(kMinTile, std::min(kMaxTile, kMaxSlots / std::max(V, 1)));
  tiles = (W + cap - 1) / cap;
  tile = (W + tiles - 1) / tiles;
  vc = std::min(V, kMaxSlots / tile);
}

template <typename TIn, typename TOut, int VEC>
int launch_vec(const void* ref, const void* src, const void* rot, const void* trans, const void* depth,
               const void* valid, void* out, int B, int V, int D, int H, int W, int Hs, int Ws, int C, int dense,
               float sx, float sy, void* stream) {
  int tiles, tile, vc;
  row_tiling(V, W, tiles, tile, vc);
  const int dblocks = (D + kPlanes - 1) / kPlanes;
  const int BZ = B * dblocks;
  const dim3 grid(tiles, H, BZ < 65535 ? BZ : 65535);  // beyond 65535 in a loop
  const size_t smem = (size_t)vc * tile * (sizeof(int4) + sizeof(float4));
  sweep_warp_variance_kernel<TIn, TOut, VEC><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const TIn*>(ref), static_cast<const TIn*>(src), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(depth), static_cast<const float*>(valid),
      static_cast<TOut*>(out), B, V, D, H, W, Hs, Ws, C, dense, sx, sy, tile, vc, dblocks);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TIn, typename TOut>
int launch(const void* ref, const void* src, const void* rot, const void* trans, const void* depth,
           const void* valid, void* out, int B, int V, int D, int H, int W, int Hs, int Ws, int C, int dense,
           float sx, float sy, void* stream) {
  if ((int64_t)B * D * H * W == 0 || C == 0) return 0;
  // int32 offsets into one map; H rows on gridDim.y
  if ((int64_t)Hs * Ws * C >= (1LL << 31) || (int64_t)B * D >= (1LL << 31) || H > 65535)
    return (int)cudaErrorInvalidValue;
  // VEC = 8 channels per thread where the channel-last rows allow whole
  // vectors (16-byte aligned loads and stores)
  if (C % 8 == 0 && aligned(ref, 16) && aligned(src, 16) && aligned(out, 16)) {
    return launch_vec<TIn, TOut, 8>(ref, src, rot, trans, depth, valid, out, B, V, D, H, W, Hs, Ws, C, dense, sx,
                                    sy, stream);
  }
  return launch_vec<TIn, TOut, 1>(ref, src, rot, trans, depth, valid, out, B, V, D, H, W, Hs, Ws, C, dense, sx,
                                  sy, stream);
}

}  // namespace

// The row tile (pixels) and the views whose taps shared memory holds, for V
// views and rows of W pixels: tile_vc[0], tile_vc[1].
extern "C" void sweep_warp_tiling(int32_t V, int32_t W, int32_t* tile_vc) {
  int tiles;
  row_tiling(V, W, tiles, tile_vc[0], tile_vc[1]);
}

// in_bf16 / out_bf16 select bf16 (else float32) features and output.
extern "C" int sweep_warp_variance(const void* ref, const void* src, const void* rot,
                                   const void* trans, const void* depth, const void* valid,
                                   void* out, int32_t B, int32_t V, int32_t D, int32_t H, int32_t W,
                                   int32_t Hs, int32_t Ws, int32_t C, int32_t dense, float sx,
                                   float sy, int32_t in_bf16, int32_t out_bf16, void* stream) {
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(ref, src, rot, trans, depth, valid, out, B, V, D,
                                                           H, W, Hs, Ws, C, dense, sx, sy, stream)
                    : launch<__nv_bfloat16, float>(ref, src, rot, trans, depth, valid, out, B, V, D, H,
                                                   W, Hs, Ws, C, dense, sx, sy, stream);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(ref, src, rot, trans, depth, valid, out, B, V, D, H, W,
                                                 Hs, Ws, C, dense, sx, sy, stream)
                  : launch<float, float>(ref, src, rot, trans, depth, valid, out, B, V, D, H, W, Hs, Ws,
                                         C, dense, sx, sy, stream);
}
