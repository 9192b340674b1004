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
// clamped to +-2^30 before the integer cast; tap offsets are 64-bit. Two
// instantiations: float32 features (homo_warp's own function) and bfloat16
// features (homo_warp_pallas: bf16 source, float32 weights), float32 out.
//
// Bound: bytes. The volume (B*D*H*W*C float32) is written once and
// dominates; the source map (a few MB) is read from L2, and the work is
// ~15 flops per pixel for the coordinates plus 7 per channel.
//
// Design: the TPU kernel builds a quad-tap buffer and contracts a one-hot
// matrix against it on the MXU because a TPU cannot gather. Hopper gathers:
// a group of lanes takes one output pixel, four consecutive channels per
// lane where C % 4 == 0 and the rows are aligned (one 16-byte load per tap
// for float, 8 bytes for bf16; one 16-byte store), so tap loads and the
// output store are coalesced: 8 lanes per pixel at C = 32. Each lane
// computes the pixel's coordinates itself. Pixel indices are 32-bit;
// grid-stride loop over pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive channels of one map position, widened to float.
template <typename T, int VEC>
struct Channels;

template <typename T>
struct Channels<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) { v[0] = to_f32(p[0]); }
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
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

struct Tap {
  int64_t offset[4];  // element offsets of the taps (00, 01, 10, 11) into the map
  float weight[4];    // bilinear weights; a tap outside the map has offset -1
};

// Coordinates and taps of one pixel, in the plain version's op order.
__device__ __forceinline__ Tap sweep_taps(const float* __restrict__ R, const float* __restrict__ T,
                                          float xf, float yf, float z, float sx, float sy, int H, int W,
                                          int C) {
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
  const int64_t x0 = (int64_t)fminf(fmaxf(x0f, -lim), lim);
  const int64_t y0 = (int64_t)fminf(fmaxf(y0f, -lim), lim);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const float w[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
  Tap tap;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t xk = x0 + (k & 1), yk = y0 + (k >> 1);
    const bool in = xk >= 0 && xk <= W - 1 && yk >= 0 && yk <= H - 1;
    tap.offset[k] = in ? (yk * W + xk) * C : -1;
    tap.weight[k] = w[k];
  }
  return tap;
}

template <typename TIn, int VEC>
__global__ void warp_volume_kernel(const TIn* __restrict__ src,      // (B, H, W, C)
                                   const float* __restrict__ rot,    // (B, 3, 3)
                                   const float* __restrict__ trans,  // (B, 3)
                                   const float* __restrict__ depth,  // (B, D)
                                   float* __restrict__ out,          // (B, D, H, W, C)
                                   uint32_t npix, uint32_t D, uint32_t H, uint32_t W, int C, float sx,
                                   float sy, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const uint32_t first = (uint32_t)(((uint64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2);
  const uint32_t stride = (uint32_t)(((uint64_t)gridDim.x * blockDim.x) >> lanes_log2);
  for (uint32_t p = first; p < npix; p += stride) {
    const uint32_t x = p % W;
    uint32_t t = p / W;
    const uint32_t y = t % H;
    t /= H;
    const uint32_t d = t % D;
    const int64_t b = t / D;
    const Tap tap = sweep_taps(rot + b * 9, trans + b * 3, (float)x, (float)y, depth[b * D + d], sx, sy,
                               (int)H, (int)W, C);
    const TIn* map = src + b * H * W * C;
    float* outp = out + (int64_t)p * C;
    for (int c = lane * VEC; c < C; c += lanes * VEC) {
      float warped[VEC];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a[VEC];
        if (tap.offset[k] >= 0) {
          Channels<TIn, VEC>::load(map + tap.offset[k] + c, a);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float term = __fmul_rn(a[j], tap.weight[k]);
          warped[j] = k == 0 ? term : __fadd_rn(warped[j], term);
        }
      }
      store<VEC>(outp + c, warped);
    }
  }
}

template <typename TIn, int VEC>
int launch_vec(const void* src, const void* rot, const void* trans, const void* depth, void* out, int64_t npix,
               int D, int H, int W, int C, float sx, float sy, void* stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) * VEC < C && lanes_log2 < 5) ++lanes_log2;
  const int threads = 256;
  const int64_t per_block = threads >> lanes_log2;
  int64_t blocks = (npix + per_block - 1) / per_block;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride beyond this
  warp_volume_kernel<TIn, VEC><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const TIn*>(src), static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<float*>(out), (uint32_t)npix, (uint32_t)D, (uint32_t)H,
      (uint32_t)W, C, sx, sy, lanes_log2);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TIn>
int launch(const void* src, const void* rot, const void* trans, const void* depth, void* out, int B, int D,
           int H, int W, int C, float sx, float sy, void* stream) {
  const int64_t npix = (int64_t)B * D * H * W;
  if (npix == 0 || C == 0) return 0;
  if (npix >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // 4 channels per lane where the channel-last rows allow whole vectors
  if (C % 4 == 0 && aligned(src, 4 * sizeof(TIn)) && aligned(out, 4 * sizeof(float))) {
    return launch_vec<TIn, 4>(src, rot, trans, depth, out, npix, D, H, W, C, sx, sy, stream);
  }
  return launch_vec<TIn, 1>(src, rot, trans, depth, out, npix, D, H, W, C, sx, sy, stream);
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
