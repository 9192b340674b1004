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
// source rows because a TPU cannot gather; Hopper gathers. Two routes,
// chosen by sweep_group_cost_route below.
//
// The lane route (bf16 features whose groups fit a lane: C/G divides the
// kLaneBytes / 2 = 16 channels of a lane, C is 1, 2, 4 or 8 lanes wide, the
// maps and the output aligned): LPP = C / 16 lanes serve one key pixel (2 at
// C 32), each owning 16 consecutive channels, so each tap is two 16-byte
// __ldg per lane. The key pixel is flattened over (b, y, x) on blockIdx.x
// and the planes are split into chunks of kLanePlanes on blockIdx.y. A lane
// loads its key channels once, widened to float32 into registers, and walks
// the chunk's planes min(kUnroll, LPP) at a time (a turn): lane `part` of
// the pixel computes the taps of plane d + part (w, the homography, the
// corner and the weights in registers) and __shfl_sync hands each plane's
// taps to the pixel's other lanes, so no lane repeats another's coordinate
// arithmetic and nothing passes through shared memory or a barrier. Every
// tap is clamped onto the map and the tent of a column or row off the map
// is set to 0 instead (on the map is separable in x and y), so the lane
// issues all of the turn's gathers unpredicated, as one corner offset and
// two steps, and a clamped tap adds a * 0 = 0 where the plain version adds
// its zero: the same sums for finite features. It blends and multiplies in
// float32 in the plain version's order (a group never spans two lanes, so
// its sum keeps channel order) and writes its 16 / (C/G) groups' sums as one
// vector (four bf16 in 8 bytes at C 32, G 8: a warp stores 256 contiguous
// bytes a plane) with a streaming store. No shared memory: L1 keeps all of
// its 256 KB for the gathered source lines. What holds it above its bytes
// bound is the issue of instructions: the plain version's order leaves 11
// float32 operations and 4 bf16 widenings per channel and plane, with no
// fused multiply-add.
//
// The group route (every other shape: float32 features, C/G not dividing
// 8, unaligned maps): a block takes one tile of one key row and a chunk of
// kPlanes planes: the tile along W from
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

// the lane route
constexpr int kLaneThreads = 128;
constexpr int kLaneBytes = 32;       // a lane's channels: two 16-byte loads per tap
constexpr int kUnroll = 4;           // planes whose gathers a lane issues together, at most
constexpr int kLanePlanes = 16;      // planes per lane; blockIdx.y takes the chunks
constexpr bool kShuffleTaps = true;  // one lane per plane computes the taps and shuffles them on
constexpr unsigned kFullMask = 0xffffffffu;

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

// The sample point of one pixel, in the plain version's op order: the top
// left tap (x0, y0), clamped to +-2^30, and the weights: the four bilinear
// weights (float32 features), or SEPARABLE (bf16 features) the bf16-rounded
// x-tents and the y-tents (tx0, tx1, 1 - wy, wy). homography_taps turns it
// into the element offsets of the taps (00, 01, 10, 11) into the source
// map, -1 for a tap off the map.
template <bool SEPARABLE>
__device__ __forceinline__ void sample_point(const float (&A)[9], const float (&Bm)[9], float w, float xf, float yf,
                                             int2& corner, float4& weight) {
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
  corner = make_int2(x0, y0);
}

template <bool SEPARABLE>
__device__ __forceinline__ void homography_taps(const float (&A)[9], const float (&Bm)[9], float w, float xf,
                                                float yf, int Hs, int Ws, int C, int4& offset, float4& weight) {
  int2 corner;
  sample_point<SEPARABLE>(A, Bm, w, xf, yf, corner, weight);
  const int x0 = corner.x, y0 = corner.y;
  const bool x0_in = x0 >= 0 && x0 <= Ws - 1, x1_in = x0 >= -1 && x0 <= Ws - 2;
  const bool y0_in = y0 >= 0 && y0 <= Hs - 1, y1_in = y0 >= -1 && y0 <= Hs - 2;
  // modulo 2^32, exact for every tap on the map (Hs * Ws * C < 2^31)
  const uint32_t base = ((uint32_t)y0 * (uint32_t)Ws + (uint32_t)x0) * (uint32_t)C;
  const uint32_t below = (uint32_t)Ws * (uint32_t)C;
  offset = make_int4(x0_in && y0_in ? (int)base : -1, x1_in && y0_in ? (int)(base + C) : -1,
                     x0_in && y1_in ? (int)(base + below) : -1, x1_in && y1_in ? (int)(base + below + C) : -1);
}

// The lane route's form of the taps (bf16 features): every tap clamped onto
// the map, so that all four can be loaded, and the tent of a column or row
// off the map set to 0 instead (on the map is separable: tap (dy, dx) lies
// on it where column x0 + dx and row y0 + dy both do), so that a clamped
// tap adds a0 * 0 = 0 where the plain version adds its zero: the same sums
// for finite features. The element offset of tap 00, and those of taps 01
// and 10 relative to it (0 or C; 0 or Ws * C); the weights (tx0, tx1, 1 -
// wy, wy).
__device__ __forceinline__ void homography_corner(const float (&A)[9], const float (&Bm)[9], float w, float xf,
                                                  float yf, int Hs, int Ws, int C, int& offset, int& dx, int& dy,
                                                  float4& weight) {
  int2 corner;
  sample_point<true>(A, Bm, w, xf, yf, corner, weight);
  const int x0 = corner.x, y0 = corner.y;
  if (!(x0 >= 0 && x0 <= Ws - 1)) weight.x = 0.0f;
  if (!(x0 >= -1 && x0 <= Ws - 2)) weight.y = 0.0f;
  if (!(y0 >= 0 && y0 <= Hs - 1)) weight.z = 0.0f;
  if (!(y0 >= -1 && y0 <= Hs - 2)) weight.w = 0.0f;
  const int cx0 = min(max(x0, 0), Ws - 1), cx1 = min(max(x0, -1), Ws - 2) + 1;
  const int cy0 = min(max(y0, 0), Hs - 1), cy1 = min(max(y0, -1), Hs - 2) + 1;
  offset = (cy0 * Ws + cx0) * C;
  dx = (cx1 - cx0) * C;
  dy = (cy1 - cy0) * Ws * C;
}

// WORDS 32-bit words from global memory, as they lie.
template <int WORDS>
__device__ __forceinline__ void load_words(const void* p, uint32_t* v) {
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p) + i);
      v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z, v[4 * i + 3] = a.w;
    }
  } else {
    static_assert(WORDS == 2, "a lane loads 8 or a multiple of 16 bytes");
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = a.x, v[1] = a.y;
  }
}

// bf16 channel e of a lane's words, widened to float32 (the low half of a
// word is the even channel).
__device__ __forceinline__ float channel(const uint32_t* raw, int e) {
  return __uint_as_float((e & 1) ? (raw[e >> 1] & 0xffff0000u) : (raw[e >> 1] << 16));
}

// A lane's NG consecutive group sums in one streaming store.
template <int NG>
__device__ __forceinline__ void store_groups(float* p, const float* v) {
  if constexpr (NG == 1) {
    __stcs(p, v[0]);
  } else if constexpr (NG == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < NG; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

template <int NG>
__device__ __forceinline__ void store_groups(__nv_bfloat16* p, const float* v) {
  if constexpr (NG == 1) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16(v[0])));
  } else {
    uint32_t packed[NG / 2];  // two sums rounded in one cvt.rn.bf16x2.f32, the first in the low half
#pragma unroll
    for (int i = 0; i < NG / 2; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      packed[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    if constexpr (NG == 2) {
      __stcs(reinterpret_cast<unsigned int*>(p), packed[0]);
    } else if constexpr (NG == 4) {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(packed[0], packed[1]));
    } else {
      static_assert(NG % 8 == 0, "a lane holds 1, 2, 4 or a multiple of 8 groups");
#pragma unroll
      for (int i = 0; i < NG / 2; i += 4)
        __stcs(reinterpret_cast<uint4*>(p) + i / 4,
               make_uint4(packed[i], packed[i + 1], packed[i + 2], packed[i + 3]));
    }
  }
}

// The lane route: LPP lanes per key pixel, each owning LC = kLaneBytes / 2
// consecutive bf16 channels, whole groups of CG (C = LC * LPP, G = C / CG
// are compile-time). The key pixel runs over (b, y, x) on blockIdx.x;
// blockIdx.y takes chunks of kLanePlanes planes.
template <typename TOut, int CG, int LPP>
__global__ void __launch_bounds__(kLaneThreads)
homography_group_cost_lanes_kernel(const __nv_bfloat16* __restrict__ ref,  // (B, H, W, C)
                                   const __nv_bfloat16* __restrict__ src,  // (B, Hs, Ws, C)
                                   const float* __restrict__ A,            // (B, 3, 3)
                                   const float* __restrict__ Bm,           // (B, 3, 3)
                                   const float* __restrict__ w,            // (B, D, H, W)
                                   TOut* __restrict__ out,                 // (B, D, H, W, G)
                                   int B, int D, int H, int W, int Hs, int Ws, int chunks) {
  constexpr int LC = kLaneBytes / 2;
  constexpr int WORDS = kLaneBytes / 4;
  constexpr int C = LC * LPP;
  constexpr int G = C / CG;
  constexpr int NG = LC / CG;  // groups per lane
  // shuffled taps come from the pixel's own lanes (1 lane: its own); planes per turn: at most LPP when
  // shuffled, and at most 64 words of gathers in flight
  constexpr bool kShuffle = kShuffleTaps && LPP > 1;
  constexpr int kMaxTurn = 16 / WORDS > 1 ? 16 / WORDS : 1;
  constexpr int kTurn = kUnroll < kMaxTurn ? kUnroll : kMaxTurn;
  constexpr int U = kShuffle && kTurn > LPP ? LPP : kTurn;
  const int64_t HW = (int64_t)H * W;
  const int64_t lane = (int64_t)blockIdx.x * kLaneThreads + threadIdx.x;
  const int part = (int)(lane % LPP);  // also the lane's rank in its LPP-wide shuffle segment
  // lanes past the last pixel stay in the loop for the shuffles and touch nothing
  const bool active = lane / LPP < B * HW;
  const int64_t pixel = active ? lane / LPP : 0;
  const int b = (int)(pixel / HW);
  const int64_t yx = pixel - b * HW;
  const int y = (int)(yx / W);
  const float xf = (float)(yx - (int64_t)y * W), yf = (float)y;
  float key[LC];
  {
    uint32_t raw[WORDS];
    load_words<WORDS>(ref + pixel * C + part * LC, raw);
#pragma unroll
    for (int e = 0; e < LC; ++e) key[e] = channel(raw, e);
  }
  float Am[9], Bmm[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) Am[i] = __ldg(A + b * 9 + i), Bmm[i] = __ldg(Bm + b * 9 + i);
  const __nv_bfloat16* map = src + (int64_t)b * Hs * Ws * C + part * LC;
  const int64_t plane = HW * G;  // between one plane's outputs and the next's
  for (int chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y) {
    const int d0 = chunk * kLanePlanes, d1 = min(D, d0 + kLanePlanes);
    const float* w_turn = w + ((int64_t)b * D + d0) * HW + yx;
    TOut* out_turn = out + ((int64_t)b * D + d0) * plane + yx * G + part * NG;
    for (int d = d0; d < d1; d += U, w_turn += U * HW, out_turn += U * plane) {
      int off[U], dx[U], dy[U];
      float4 wt[U];
      if constexpr (kShuffle) {
        int o = 0, ox = 0, oy = 0;
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (active && d + part % U < d1)
          homography_corner(Am, Bmm, __ldg(w_turn + part % U * HW), xf, yf, Hs, Ws, C, o, ox, oy, t);
#pragma unroll
        for (int j = 0; j < U; ++j) {
          off[j] = __shfl_sync(kFullMask, o, j, LPP);
          dx[j] = __shfl_sync(kFullMask, ox, j, LPP);
          dy[j] = __shfl_sync(kFullMask, oy, j, LPP);
          wt[j] = make_float4(__shfl_sync(kFullMask, t.x, j, LPP), __shfl_sync(kFullMask, t.y, j, LPP),
                              __shfl_sync(kFullMask, t.z, j, LPP), __shfl_sync(kFullMask, t.w, j, LPP));
        }
      } else {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          off[j] = 0, dx[j] = 0, dy[j] = 0;
          wt[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (active && d + j < d1)
            homography_corner(Am, Bmm, __ldg(w_turn + j * HW), xf, yf, Hs, Ws, C, off[j], dx[j], dy[j], wt[j]);
        }
      }
      // the turn's 4 U gathers, all issued before any is used; every tap lies on the map
      uint32_t raw[U][4][WORDS];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const __nv_bfloat16* t00 = map + off[j];
        load_words<WORDS>(t00, raw[j][0]);
        load_words<WORDS>(t00 + dx[j], raw[j][1]);
        load_words<WORDS>(t00 + dy[j], raw[j][2]);
        load_words<WORDS>(t00 + dy[j] + dx[j], raw[j][3]);
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (!(active && d + j < d1)) continue;
        const float4 t = wt[j];
        float acc[NG];
#pragma unroll
        for (int e = 0; e < LC; ++e) {
          float a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = channel(raw[j][k], e);
          // rows first, then the y-tents
          const float s0 = __fadd_rn(__fmul_rn(a[0], t.x), __fmul_rn(a[1], t.y));
          const float s1 = __fadd_rn(__fmul_rn(a[2], t.x), __fmul_rn(a[3], t.y));
          const float prod = __fmul_rn(key[e], __fadd_rn(__fmul_rn(s0, t.z), __fmul_rn(s1, t.w)));
          acc[e / CG] = (e % CG == 0) ? prod : __fadd_rn(acc[e / CG], prod);  // the group's channels in order
        }
        store_groups<NG>(out_turn + j * plane, acc);
      }
    }
  }
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

template <typename TOut, int CG, int LPP>
int launch_lanes(const __nv_bfloat16* ref, const __nv_bfloat16* src, const float* A, const float* Bm,
                 const float* w, void* out, int B, int D, int H, int W, int Hs, int Ws, void* stream) {
  const int64_t blocks = ((int64_t)B * H * W * LPP + kLaneThreads - 1) / kLaneThreads;
  const int chunks = (D + kLanePlanes - 1) / kLanePlanes;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, chunks < 65535 ? chunks : 65535);  // beyond 65535 in a loop
  homography_group_cost_lanes_kernel<TOut, CG, LPP><<<grid, kLaneThreads, 0, (cudaStream_t)stream>>>(
      ref, src, A, Bm, w, static_cast<TOut*>(out), B, D, H, W, Hs, Ws, chunks);
  return (int)cudaGetLastError();
}

// The lane route's instantiations: C / G channels per group dividing a
// lane's LC, 1, 2, 4 or 8 lanes per pixel.
template <typename TOut, int CG>
int launch_lanes_cg(const __nv_bfloat16* ref, const __nv_bfloat16* src, const float* A, const float* Bm,
                    const float* w, void* out, int B, int D, int H, int W, int Hs, int Ws, int lpp, void* stream) {
  switch (lpp) {
    case 1: return launch_lanes<TOut, CG, 1>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, stream);
    case 2: return launch_lanes<TOut, CG, 2>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, stream);
    case 4: return launch_lanes<TOut, CG, 4>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, stream);
    case 8: return launch_lanes<TOut, CG, 8>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TOut>
int launch_lanes_any(const __nv_bfloat16* ref, const __nv_bfloat16* src, const float* A, const float* Bm,
                     const float* w, void* out, int B, int D, int H, int W, int Hs, int Ws, int C, int G,
                     void* stream) {
  constexpr int LC = kLaneBytes / 2;
  const int lpp = C / LC;
  switch (C / G) {
    case 1: return launch_lanes_cg<TOut, 1>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, lpp, stream);
    case 2:
      if constexpr (LC % 2 == 0)
        return launch_lanes_cg<TOut, 2>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, lpp, stream);
      break;
    case 4:
      if constexpr (LC % 4 == 0)
        return launch_lanes_cg<TOut, 4>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, lpp, stream);
      break;
    case 8:
      if constexpr (LC % 8 == 0)
        return launch_lanes_cg<TOut, 8>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, lpp, stream);
      break;
    case 16:
      if constexpr (LC % 16 == 0)
        return launch_lanes_cg<TOut, 16>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, lpp, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// 1 where the lane route takes the shape (bf16 features; C / G dividing a
// lane's channels; 1, 2, 4 or 8 lanes per pixel; the maps aligned to a lane's
// load and the output to a lane's store), else 0: the group route.
int lane_route(const void* ref, const void* src, const void* out, int C, int G, bool in_bf16, bool out_bf16) {
  if (!in_bf16 || G <= 0 || C <= 0 || C % G != 0) return 0;
  const int lc = kLaneBytes / 2, cg = C / G, lpp = C / lc;
  if (lc % cg != 0 || C % lc != 0 || (lpp != 1 && lpp != 2 && lpp != 4 && lpp != 8)) return 0;
  const size_t load = kLaneBytes < 16 ? kLaneBytes : 16, store = (size_t)(lc / cg) * (out_bf16 ? 2 : 4);
  return aligned(ref, load) && aligned(src, load) && aligned(out, store < 16 ? store : 16);
}

template <typename TIn, typename TOut>
int launch(const TIn* ref, const TIn* src, const float* A, const float* Bm, const float* w, void* out,
           int B, int D, int H, int W, int Hs, int Ws, int C, int G, void* stream) {
  if ((int64_t)B * D * H * W == 0 || G == 0) return 0;
  // int32 offsets into one map; H rows on gridDim.y
  if (C % G != 0 || (int64_t)Hs * Ws * C >= (1LL << 31) || (int64_t)B * D >= (1LL << 31) || H > 65535)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<TIn, __nv_bfloat16>::value) {
    if (lane_route(ref, src, out, C, G, true, std::is_same<TOut, __nv_bfloat16>::value))
      return launch_lanes_any<TOut>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, stream);
  }
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

// The route sweep_group_cost takes: 1 the lane route, 0 the group route
// (the design note above). out: the output's address.
extern "C" int sweep_group_cost_route(const void* ref, const void* src, const void* out, int32_t C, int32_t G,
                                      int32_t in_bf16, int32_t out_bf16) {
  return lane_route(ref, src, out, C, G, in_bf16 != 0, out_bf16 != 0);
}

// in_bf16 / out_bf16 select bf16 (else float32) features and output; the
// homography and the multipliers are float32.
extern "C" int sweep_group_cost(const void* ref, const void* src, const void* A, const void* Bm, const void* w,
                                void* out, int32_t B, int32_t D, int32_t H, int32_t W, int32_t Hs, int32_t Ws,
                                int32_t C, int32_t G, int32_t in_bf16, int32_t out_bf16, void* stream) {
  return in_bf16 ? launch_in<__nv_bfloat16>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, out_bf16, stream)
                 : launch_in<float>(ref, src, A, Bm, w, out, B, D, H, W, Hs, Ws, C, G, out_bf16, stream);
}
