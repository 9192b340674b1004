// Fused homography warp + group-wise correlation (K2, group mode) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/sweep_warp.py (_call_sweep
// with kernel _sweep_kernel, agg="group"), which serves the entry
// homography_group_cost there: Vis-MVSNet's per-pair cost volume. For every
// output pixel (b, d, y, x) and group g of G it writes
//
//     out = sum over the C/G channels c of group g of
//           ref[b, y, x, c] * (bilinear sample of src[b, :, :, c] at (xi, yi))
//
// in float32 registers, and stores only the result. The sample point comes
// from the per-pixel homography M = A + B * w (w = w_dense[b, d, y, x], A and
// B per batch with the pixel-centre offset folded in):
//
//     p  = M [x, y, 1]^T
//     xi = p_x / (p_z + 1e-9) - 0.5,   yi = p_y / (p_z + 1e-9) - 0.5
//
// with zeros padding and no clamp of the coordinates (the TPU kernel's
// semantics; rmvd's interpolate() clamps to +-1.1 of the map, which differs
// only on maps narrower than about 10 px). Every product and sum is rounded
// on its own (__fmul_rn, __fadd_rn: no fused multiply-add), in the order of
// the plain torch version in ops/kernels/sweep_group_cost.py (taps 00, 01,
// 10, 11; the group's channels in order), so the card and the CPU round
// alike. Non-finite coordinates become 1e9 (all taps outside, zeros out),
// and the floor is clamped to +-2^30 before the integer cast.
//
// bf16 features (ref and src both bf16) sample as the TPU kernel does with
// samp_dtype = bf16: the x-tent weights 1 - wx and 1 - (1 - wx) are rounded
// to bf16, each source row is blended in float32 (s = a0 * tx0 + a1 * tx1,
// exact products), and the two rows are weighted by the float32 y-tents
// (warped = s0 * (1 - wy) + s1 * wy). The key is widened to float32, the
// products and the group sums are float32, and the output is rounded once
// to out_dtype.
//
// Bound: bytes. The output (B*D*H*W*G values), the per-pixel multipliers w
// (B*D*H*W) and the key and source maps (4 or 2 bytes a channel) are each
// moved once at least; the work is ~45 flops per pixel for the coordinates
// and weights plus ~9 per channel, about 9 flops per output byte at C = 32,
// G = 8: below the ~20 flop/byte at which the H100's f32 rate binds. Behind
// the bytes, the four tap gathers of every (pixel, plane) are served by L1
// and L2.
//
// Design: the TPU kernel turns sampling into x-tent matmuls over bands of
// source rows because a TPU cannot gather; Hopper gathers. A block takes one
// tile of one key row and a chunk of kPlanes planes: the tile along W from
// blockIdx.x (W split into equal tiles of at most kMaxTile pixels, fewer
// for wide C), the row y from blockIdx.y and b with the chunk from
// blockIdx.z, so no index is divided per pixel. Phase 1: the block copies
// the tile's key features (one contiguous run of n * C values) into shared
// memory once for all of its planes, widened to float32, and one thread per
// (pixel, plane) computes the homography taps once (four int32 offsets, -1
// off the map, and four weights) into shared memory. Phase 2: plane by
// plane, the threads walk the plane's n * G outputs, one (pixel, group)
// each; a thread reads the taps (a broadcast) and the group's key channels
// from shared memory, gathers the group's channels of the four taps with
// __ldg (4 channels per load, 16 bytes in float32 and 8 in bf16, where
// C/G % 4 == 0 and the maps are aligned, else one channel at a time), sums
// them in channel order and writes the result with a streaming store
// (__stcs): the G outputs of a pixel are consecutive, so a warp stores
// contiguous rows. Where the key tile cannot fit in shared memory even at
// one pixel (C > ~12000), it is read from global memory instead. Per-map
// offsets are 32-bit: Hs * Ws * C < 2^31 is required.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 64;       // key pixels per block
constexpr int kPlanes = 8;         // planes per block, the key's tile loaded once for all of them
constexpr int kTileFloats = 2048;  // the key tile's size that sets the tile for wide C
constexpr int kSmemBytes = 48 * 1024;

// VEC channels from global memory, widened to float32.
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

// The key's channels from the shared-memory tile.
template <int VEC>
__device__ __forceinline__ void load_key(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void store_streaming(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_streaming(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16(v)));
}

// Taps of one pixel, in the plain version's op order: element offsets of
// the taps (00, 01, 10, 11) into the source map, -1 for a tap off the map,
// and the weights: the four bilinear weights (float32 features), or
// SEPARABLE (bf16 features) the bf16-rounded x-tents and the y-tents
// (tx0, tx1, 1 - wy, wy).
template <bool SEPARABLE>
__device__ __forceinline__ void homography_taps(const float (&A)[9], const float (&Bm)[9], float w, float xf,
                                                float yf, int Hs, int Ws, int C, int4& offset, float4& weight) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m0 = __fadd_rn(A[3 * i], __fmul_rn(Bm[3 * i], w));
    const float m1 = __fadd_rn(A[3 * i + 1], __fmul_rn(Bm[3 * i + 1], w));
    const float m2 = __fadd_rn(A[3 * i + 2], __fmul_rn(Bm[3 * i + 2], w));
    p[i] = __fadd_rn(__fadd_rn(__fmul_rn(m0, xf), __fmul_rn(m1, yf)), m2);
  }
  const float pz = __fadd_rn(p[2], 1e-9f);
  float xi = __fsub_rn(__fdiv_rn(p[0], pz), 0.5f);
  float yi = __fsub_rn(__fdiv_rn(p[1], pz), 0.5f);
  if (!isfinite(xi)) xi = 1e9f;
  if (!isfinite(yi)) yi = 1e9f;
  const float x0f = floorf(xi), y0f = floorf(yi);
  const float wx = __fsub_rn(xi, x0f), wy = __fsub_rn(yi, y0f);
  const float lim = 1073741824.0f;  // 2^30
  const int x0 = (int)fminf(fmaxf(x0f, -lim), lim);
  const int y0 = (int)fminf(fmaxf(y0f, -lim), lim);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  if constexpr (SEPARABLE) {
    const float tx0 = __bfloat162float(__float2bfloat16(ux));
    const float tx1 = __bfloat162float(__float2bfloat16(__fsub_rn(1.0f, ux)));
    weight = make_float4(tx0, tx1, uy, wy);
  } else {
    weight = make_float4(__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy));
  }
  const bool x0_in = x0 >= 0 && x0 <= Ws - 1, x1_in = x0 >= -1 && x0 <= Ws - 2;
  const bool y0_in = y0 >= 0 && y0 <= Hs - 1, y1_in = y0 >= -1 && y0 <= Hs - 2;
  // modulo 2^32, exact for every tap on the map (Hs * Ws * C < 2^31)
  const uint32_t base = ((uint32_t)y0 * (uint32_t)Ws + (uint32_t)x0) * (uint32_t)C;
  const uint32_t below = (uint32_t)Ws * (uint32_t)C;
  offset = make_int4(x0_in && y0_in ? (int)base : -1, x1_in && y0_in ? (int)(base + C) : -1,
                     x0_in && y1_in ? (int)(base + below) : -1, x1_in && y1_in ? (int)(base + below + C) : -1);
}

// KEY_SMEM: the key tile is copied to shared memory (else read in place).
template <typename TIn, typename TOut, int VEC, bool KEY_SMEM>
__global__ void __launch_bounds__(kThreads)
homography_group_cost_kernel(const TIn* __restrict__ ref,    // (B, H, W, C)
                             const TIn* __restrict__ src,    // (B, Hs, Ws, C)
                             const float* __restrict__ A,    // (B, 3, 3)
                             const float* __restrict__ Bm,   // (B, 3, 3)
                             const float* __restrict__ w,    // (B, D, H, W)
                             TOut* __restrict__ out,         // (B, D, H, W, G)
                             int B, int D, int H, int W, int Hs, int Ws, int C, int G, int tile, int dblocks) {
  // taps of (plane p, pixel i) at [p * tile + i], then the key tile (n * C floats)
  constexpr bool kSeparable = std::is_same<TIn, __nv_bfloat16>::value;
  extern __shared__ int4 smem[];
  int4* tap_offset = smem;
  float4* tap_weight = reinterpret_cast<float4*>(smem + kPlanes * tile);
  float* key_tile = reinterpret_cast<float*>(tap_weight + kPlanes * tile);
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int n = min(tile, W - x0);
  const int cg = C / G;
  const int total = n * G;
  // this thread's first (pixel, group) and its step of kThreads outputs
  const int first_pixel = threadIdx.x / G, first_group = threadIdx.x % G;
  const int step_pixel = kThreads / G, step_group = kThreads % G;
  const float yf = (float)y;
  for (int bz = blockIdx.z; bz < B * dblocks; bz += gridDim.z) {
    const int b = bz / dblocks;
    const int d0 = (bz - b * dblocks) * kPlanes;
    const int planes = min(kPlanes, D - d0);
    const int64_t bd0 = (int64_t)b * D + d0;
    const TIn* key_row = ref + (((int64_t)b * H + y) * W + x0) * C;
    if constexpr (KEY_SMEM) {
      for (int e = threadIdx.x * VEC; e < n * C; e += kThreads * VEC) {
        float v[VEC];
        load<VEC>(key_row + e, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) key_tile[e + k] = v[k];
      }
    }
    float Am[9], Bmm[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) Am[i] = __ldg(A + b * 9 + i), Bmm[i] = __ldg(Bm + b * 9 + i);
    for (int s = threadIdx.x; s < planes * n; s += kThreads) {
      const int p = s / n, i = s - p * n;
      const float wp = __ldg(w + ((bd0 + p) * H + y) * W + x0 + i);
      homography_taps<kSeparable>(Am, Bmm, wp, (float)(x0 + i), yf, Hs, Ws, C, tap_offset[p * tile + i],
                      tap_weight[p * tile + i]);
    }
    __syncthreads();
    const TIn* map = src + (int64_t)b * Hs * Ws * C;
    for (int p = 0; p < planes; ++p) {
      TOut* run = out + ((bd0 + p) * H + y) * W * (int64_t)G + (int64_t)x0 * G;
      int pixel = first_pixel, g = first_group;
      for (int j = threadIdx.x; j < total; j += kThreads) {
        const int4 o = tap_offset[p * tile + pixel];
        const float4 w4 = tap_weight[p * tile + pixel];
        const int offsets[4] = {o.x, o.y, o.z, o.w};
        const float weights[4] = {w4.x, w4.y, w4.z, w4.w};
        const int c0 = g * cg;
        float acc = 0.0f;
        for (int c = c0; c < c0 + cg; c += VEC) {
          float r[VEC], a[4][VEC];
          if constexpr (KEY_SMEM) {
            load_key<VEC>(key_tile + pixel * C + c, r);
          } else {
            load<VEC>(key_row + pixel * C + c, r);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (offsets[k] >= 0) {
              load<VEC>(map + offsets[k] + c, a[k]);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) a[k][e] = 0.0f;
            }
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float warped;
            if constexpr (kSeparable) {  // rows first, then the y-tents
              const float s0 = __fadd_rn(__fmul_rn(a[0][e], weights[0]), __fmul_rn(a[1][e], weights[1]));
              const float s1 = __fadd_rn(__fmul_rn(a[2][e], weights[0]), __fmul_rn(a[3][e], weights[1]));
              warped = __fadd_rn(__fmul_rn(s0, weights[2]), __fmul_rn(s1, weights[3]));
            } else {
              warped = __fmul_rn(a[0][e], weights[0]);
#pragma unroll
              for (int k = 1; k < 4; ++k) warped = __fadd_rn(warped, __fmul_rn(a[k][e], weights[k]));
            }
            const float prod = __fmul_rn(r[e], warped);
            acc = (c + e == c0) ? prod : __fadd_rn(acc, prod);  // the group's first channel
          }
        }
        store_streaming(run + j, acc);
        pixel += step_pixel;
        g += step_group;
        if (g >= G) g -= G, ++pixel;
      }
    }
    __syncthreads();  // the taps and the key tile are rewritten for the next chunk
  }
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TIn, typename TOut, int VEC, bool KEY_SMEM>
int launch_tile(const TIn* ref, const TIn* src, const float* A, const float* Bm, const float* w, void* out,
                int B, int D, int H, int W, int Hs, int Ws, int C, int G, int tile, size_t smem, void* stream) {
  const int tiles = (W + tile - 1) / tile;
  const int dblocks = (D + kPlanes - 1) / kPlanes;
  const int BZ = B * dblocks;
  const dim3 grid(tiles, H, BZ < 65535 ? BZ : 65535);  // beyond 65535 in a loop
  homography_group_cost_kernel<TIn, TOut, VEC, KEY_SMEM><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      ref, src, A, Bm, w, static_cast<TOut*>(out), B, D, H, W, Hs, Ws, C, G, tile, dblocks);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, int VEC>
int launch_vec(const TIn* ref, const TIn* src, const float* A, const float* Bm, const float* w, void* out,
               int B, int D, int H, int W, int Hs, int Ws, int C, int G, void* stream) {
  // the row tile: at most kMaxTile pixels and about kTileFloats key floats;
  // W split into equal tiles
  const int cap = std::max(1, std::min(kMaxTile, kTileFloats / std::max(C, 1)));
  const int tiles = (W + cap - 1) / cap;
  const int tile = (W + tiles - 1) / tiles;
  const size_t taps = (size_t)kPlanes * tile * (sizeof(int4) + sizeof(float4));
  const size_t key = (size_t)tile * C * sizeof(float);
  if (taps + key <= kSmemBytes) {
    return launch_tile<TIn, TOut, VEC, true>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, tile, taps + key,
                                        stream);
  }
  return launch_tile<TIn, TOut, VEC, false>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, tile, taps, stream);
}

template <typename TIn, typename TOut>
int launch(const TIn* ref, const TIn* src, const float* A, const float* Bm, const float* w, void* out,
           int B, int D, int H, int W, int Hs, int Ws, int C, int G, void* stream) {
  if ((int64_t)B * D * H * W == 0 || G == 0) return 0;
  // int32 offsets into one map; H rows on gridDim.y
  if (C % G != 0 || (int64_t)Hs * Ws * C >= (1LL << 31) || (int64_t)B * D >= (1LL << 31) || H > 65535)
    return (int)cudaErrorInvalidValue;
  // 4 channels per load where each group is whole vectors and the rows are aligned
  if ((C / G) % 4 == 0 && aligned(ref, 4 * sizeof(TIn)) && aligned(src, 4 * sizeof(TIn))) {
    return launch_vec<TIn, TOut, 4>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, stream);
  }
  return launch_vec<TIn, TOut, 1>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, stream);
}

template <typename TIn>
int launch_in(const void* ref, const void* src, const void* A, const void* Bm, const void* w, void* out, int B,
              int D, int H, int W, int Hs, int Ws, int C, int G, int out_bf16, void* stream) {
  const TIn* r = static_cast<const TIn*>(ref);
  const TIn* s = static_cast<const TIn*>(src);
  const float* a = static_cast<const float*>(A);
  const float* bm = static_cast<const float*>(Bm);
  const float* wd = static_cast<const float*>(w);
  return out_bf16 ? launch<TIn, __nv_bfloat16>(r, s, a, bm, wd, out, B, D, H, W, Hs, Ws, C, G, stream)
                  : launch<TIn, float>(r, s, a, bm, wd, out, B, D, H, W, Hs, Ws, C, G, stream);
}

}  // namespace

// in_bf16 / out_bf16 select bf16 (else float32) features and output; the
// homography and the multipliers are float32.
extern "C" int sweep_group_cost(const void* ref, const void* src, const void* A, const void* Bm, const void* w,
                                void* out, int32_t B, int32_t D, int32_t H, int32_t W, int32_t Hs, int32_t Ws,
                                int32_t C, int32_t G, int32_t in_bf16, int32_t out_bf16, void* stream) {
  return in_bf16 ? launch_in<__nv_bfloat16>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, out_bf16, stream)
                 : launch_in<float>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, out_bf16, stream);
}
