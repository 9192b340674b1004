// Materialised plane-sweep warp volume (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/warp_volume.py
// (homo_warp_pallas, kernel _warp_kernel), the drop-in for homo_warp on
// MVSNet's warp_impl="xla" route. For every output pixel (b, d, y, x) and
// channel c it writes the bilinear sample (zeros padding, no z-mask) of
// src[b, :, :, c] at the plane-sweep point of the reference pixel (x, y) at
// depth z = depth[b, d] under the transform (R, T):
//
//     p  = (R[:, 0] * x + R[:, 1] * y + R[:, 2]) * z + T
//     xi = p_x / p_z * sx - 0.5,   yi = p_y / p_z * sy - 0.5
//
// (sx = W / (W - 1), the reference's align_corners quirk), the four taps
// weighted w00, w01, w10, w11 in float32 and summed in that order. Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), in the order of the plain torch version
// (ops/homography.py::rt_planesweep_warp), so the card and the CPU round
// alike; the coordinate and tap code is K2's (csrc/sweep_warp.cu).
// Non-finite coordinates become 1e9 (all taps outside), and the floor is
// clamped to +-2^30 before the integer cast. Two instantiations: float32
// features (homo_warp's own function) and bfloat16 features
// (homo_warp_pallas: bf16 source, float32 weights), float32 out.
//
// Bound: bytes. The volume (B*D*H*W*C float32) is written once and
// dominates; the source map (a few MB) is read from L2, and the work is
// ~15 flops per pixel for the coordinates plus 7 per channel.
//
// Design: the TPU kernel builds a quad-tap buffer and contracts a one-hot
// matrix against it on the MXU because a TPU cannot gather. Hopper gathers.
// A block takes one tile of one output row (b, d, y): the whole row where
// W <= kMaxTile pixels, else W split into equal tiles (blockIdx.x), with y
// from blockIdx.y and b * D + d from blockIdx.z. Phase 1: one thread per
// pixel computes its taps once (four int32 element offsets into the map, -1
// off the map, and four weights) into shared memory. Phase 2: the tile's
// output is one contiguous run of n * C floats, which the block walks as
// consecutive vectors of VEC channels (VEC = 4 where C % 4 == 0 and the
// pointers allow: one 16-byte load per tap for float, 8 bytes for bf16),
// reads the pixel's taps from shared memory (a broadcast), gathers the four
// taps with __ldg and writes the sum with a streaming store (__stcs), so
// that the 1 GB volume does not push the source map out of L2. Per-map
// offsets are 32-bit: H * W * C < 2^31 is required.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 512;  // output pixels per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive channels of one map position, widened to float.
template <typename T, int VEC>
struct Channels;

template <typename T>
struct Channels<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) { v[0] = to_f32(__ldg(p)); }
};

template <>
struct Channels<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};

template <>
struct Channels<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  }
};

template <int VEC>
__device__ __forceinline__ void store_streaming(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// Taps of one pixel, in the plain version's op order: element offsets of
// the taps (00, 01, 10, 11) into the map, -1 for a tap off the map, and the
// bilinear weights.
__device__ __forceinline__ void sweep_taps(const float (&R)[9], const float (&T)[3], float xf, float yf, float z,
                                           float sx, float sy, int H, int W, int C, int4& offset, float4& weight) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r = __fadd_rn(__fadd_rn(__fmul_rn(R[3 * i], xf), __fmul_rn(R[3 * i + 1], yf)), R[3 * i + 2]);
    p[i] = __fadd_rn(__fmul_rn(r, z), T[i]);
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
  const bool x0_in = x0 >= 0 && x0 <= W - 1, x1_in = x0 >= -1 && x0 <= W - 2;
  const bool y0_in = y0 >= 0 && y0 <= H - 1, y1_in = y0 >= -1 && y0 <= H - 2;
  // modulo 2^32, exact for every tap on the map (H * W * C < 2^31)
  const uint32_t base = ((uint32_t)y0 * (uint32_t)W + (uint32_t)x0) * (uint32_t)C;
  const uint32_t below = (uint32_t)W * (uint32_t)C;
  offset = make_int4(x0_in && y0_in ? (int)base : -1, x1_in && y0_in ? (int)(base + C) : -1,
                     x0_in && y1_in ? (int)(base + below) : -1, x1_in && y1_in ? (int)(base + below + C) : -1);
}

template <typename TIn, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_volume_kernel(const TIn* __restrict__ src,      // (B, H, W, C)
                   const float* __restrict__ rot,    // (B, 3, 3)
                   const float* __restrict__ trans,  // (B, 3)
                   const float* __restrict__ depth,  // (B, D)
                   float* __restrict__ out,          // (B, D, H, W, C)
                   int BD, int D, int H, int W, int C, int tile, float sx, float sy) {
  __shared__ int4 tap_offset[kMaxTile];
  __shared__ float4 tap_weight[kMaxTile];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int n = min(tile, W - x0);
  const int lanes = C / VEC;  // vectors per pixel
  const int total = n * lanes;
  // this thread's first (pixel, vector) and its step of kThreads vectors
  const int first_pixel = threadIdx.x / lanes, first_vec = threadIdx.x % lanes;
  const int step_pixel = kThreads / lanes, step_vec = kThreads % lanes;
  for (int bd = blockIdx.z; bd < BD; bd += gridDim.z) {
    const int b = bd / D;
    float R[9], T[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = __ldg(rot + b * 9 + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = __ldg(trans + b * 3 + i);
    const float z = __ldg(depth + bd);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sweep_taps(R, T, (float)(x0 + i), (float)y, z, sx, sy, H, W, C, tap_offset[i], tap_weight[i]);
    }
    __syncthreads();
    const TIn* map = src + (int64_t)b * H * W * C;
    float* run = out + (((int64_t)bd * H + y) * W + x0) * C;
    int pixel = first_pixel, vec = first_vec;
    for (int j = threadIdx.x; j < total; j += kThreads) {
      const int4 o = tap_offset[pixel];
      const float4 w4 = tap_weight[pixel];
      const int offsets[4] = {o.x, o.y, o.z, o.w};
      const float weights[4] = {w4.x, w4.y, w4.z, w4.w};
      const int c = vec * VEC;
      float a[4][VEC];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (offsets[k] >= 0) {
          Channels<TIn, VEC>::load(map + offsets[k] + c, a[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[k][e] = 0.0f;
        }
      }
      float warped[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        warped[e] = __fmul_rn(a[0][e], weights[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k) warped[e] = __fadd_rn(warped[e], __fmul_rn(a[k][e], weights[k]));
      }
      store_streaming<VEC>(run + (int64_t)j * VEC, warped);
      pixel += step_pixel;
      vec += step_vec;
      if (vec >= lanes) vec -= lanes, ++pixel;
    }
    __syncthreads();  // the taps are rewritten for the next row
  }
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TIn, int VEC>
int launch_vec(const void* src, const void* rot, const void* trans, const void* depth, void* out, int B, int D,
               int H, int W, int C, float sx, float sy, void* stream) {
  const int tiles = (W + kMaxTile - 1) / kMaxTile;
  const int tile = (W + tiles - 1) / tiles;
  const int BD = B * D;
  const dim3 grid(tiles, H, BD < 65535 ? BD : 65535);  // rows beyond 65535 in a loop
  warp_volume_kernel<TIn, VEC><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const TIn*>(src), static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<float*>(out), BD, D, H, W, C, tile, sx, sy);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch(const void* src, const void* rot, const void* trans, const void* depth, void* out, int B, int D,
           int H, int W, int C, float sx, float sy, void* stream) {
  if ((int64_t)B * D * H * W == 0 || C == 0) return 0;
  // int32 offsets into one map; H rows on gridDim.y
  if ((int64_t)H * W * C >= (1LL << 31) || (int64_t)B * D >= (1LL << 31) || H > 65535)
    return (int)cudaErrorInvalidValue;
  // VEC = 4 channels per load and store where the channel-last rows allow whole vectors
  if (C % 4 == 0 && aligned(src, 4 * sizeof(TIn)) && aligned(out, 4 * sizeof(float))) {
    return launch_vec<TIn, 4>(src, rot, trans, depth, out, B, D, H, W, C, sx, sy, stream);
  }
  return launch_vec<TIn, 1>(src, rot, trans, depth, out, B, D, H, W, C, sx, sy, stream);
}

}  // namespace

// in_bf16 selects bf16 (else float32) features; the output is float32.
extern "C" int warp_volume(const void* src, const void* rot, const void* trans, const void* depth, void* out,
                           int32_t B, int32_t D, int32_t H, int32_t W, int32_t C, float sx, float sy,
                           int32_t in_bf16, void* stream) {
  if (in_bf16) {
    return launch<__nv_bfloat16>(src, rot, trans, depth, out, B, D, H, W, C, sx, sy, stream);
  }
  return launch<float>(src, rot, trans, depth, out, B, D, H, W, C, sx, sy, stream);
}
