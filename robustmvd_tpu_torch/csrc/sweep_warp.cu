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
// in ops/kernels/sweep_warp.py, so the card and the CPU round alike.
// Non-finite coordinates become 1e9 (all taps outside), and the floor is
// clamped to +-2^30 before the integer cast; tap offsets are 64-bit.
//
// Bound: bytes. The output volume (B*D*H*W*C values) is written once and
// dominates; the source maps (a few MB per view) are read from L2, and the
// work is ~15 flops per (pixel, view) for the coordinates plus ~11 per
// channel, far below the ~20 flop/byte at which the H100's f32 rate binds.
//
// Design: the TPU kernel turns sampling into x-tent matmuls over bands of
// source rows because a TPU cannot gather. Hopper gathers: a group of lanes
// takes one output pixel with lanes over the channels of the channel-last
// maps, four consecutive channels per lane where C % 4 == 0 and the rows are
// aligned (one 16-byte load per tap for float), so tap loads and the output
// store are coalesced: 8 lanes per pixel at C = 32, 4 at C = 16. Each lane
// computes the pixel's coordinates itself (no shuffles); fewer lanes per
// pixel means less of that repeated work. Pixel indices are 32-bit (integer
// division by H, W, D is the costliest part of the index math). Grid-stride
// loop over pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive channels of one map position, loaded and stored at once
// (16 B per lane for float, 8 B for bf16) and widened to float.
template <typename T, int VEC>
struct Channels;

template <typename T>
struct Channels<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) { v[0] = to_f32(p[0]); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { p[0] = v[0]; }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) { p[0] = __float2bfloat16(v[0]); }
};

template <>
struct Channels<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
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
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    Channels<float, 4>::store(p, v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    Channels<float, 4>::store(p, v);
  }
};

struct Tap {
  int64_t offset[4];  // element offsets of the taps (00, 01, 10, 11) into one view's map
  float weight[4];    // bilinear weights; a tap outside the map has offset -1
};

// Coordinates and taps of one (pixel, view), in the plain version's op order.
__device__ __forceinline__ Tap sweep_taps(const float* __restrict__ R, const float* __restrict__ T,
                                          float xf, float yf, float z, float sx, float sy,
                                          int Hs, int Ws, int C) {
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
    const bool in = xk >= 0 && xk <= Ws - 1 && yk >= 0 && yk <= Hs - 1;
    tap.offset[k] = in ? (yk * Ws + xk) * C : -1;
    tap.weight[k] = w[k];
  }
  return tap;
}

// A group of `lanes` threads per output pixel; each lane takes VEC
// consecutive channels at a time. Pixel indices are 32-bit (the wrapper
// checks B*D*H*W < 2^31), memory offsets 64-bit.
template <typename TIn, typename TOut, int VEC>
__global__ void sweep_warp_variance_kernel(const TIn* __restrict__ ref,      // (B, H, W, C)
                                           const TIn* __restrict__ src,      // (B, V, Hs, Ws, C)
                                           const float* __restrict__ rot,    // (B, V, 3, 3)
                                           const float* __restrict__ trans,  // (B, V, 3)
                                           const float* __restrict__ depth,  // (B, D) or (B, D, H, W)
                                           const float* __restrict__ valid,  // (B, V)
                                           TOut* __restrict__ out,           // (B, D, H, W, C)
                                           uint32_t npix, int V, uint32_t D, uint32_t H, uint32_t W,
                                           int Hs, int Ws, int C, int dense, float sx, float sy,
                                           int lanes_log2) {
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
    const float z = dense ? depth[p] : depth[b * D + d];
    const float xf = (float)x, yf = (float)y;
    const TIn* refp = ref + ((b * H + y) * W + x) * C;
    TOut* outp = out + (int64_t)p * C;
    for (int c = lane * VEC; c - lane * VEC < C; c += lanes * VEC) {
      const bool active = c < C;  // C is a multiple of VEC
      float r[VEC], vsum[VEC], vsq[VEC];
      if (active) {
        Channels<TIn, VEC>::load(refp + c, r);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) vsum[j] = r[j], vsq[j] = __fmul_rn(r[j], r[j]);
      float count = 1.0f;
      for (int v = 0; v < V; ++v) {
        const int64_t bv = b * V + v;
        const Tap tap = sweep_taps(rot + bv * 9, trans + bv * 3, xf, yf, z, sx, sy, Hs, Ws, C);
        const TIn* map = src + bv * Hs * Ws * C;
        float warped[VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float a[VEC];
          if (active && tap.offset[k] >= 0) {
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
        const float val = valid[bv];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float w = __fmul_rn(warped[j], val);
          vsum[j] = __fadd_rn(vsum[j], w);
          vsq[j] = __fadd_rn(vsq[j], __fmul_rn(w, w));
        }
        count = __fadd_rn(count, val);
      }
      if (active) {
        float res[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float mean = __fdiv_rn(vsum[j], count);
          res[j] = __fsub_rn(__fdiv_rn(vsq[j], count), __fmul_rn(mean, mean));
        }
        Channels<TOut, VEC>::store(outp + c, res);
      }
    }
  }
}

template <typename TIn, typename TOut, int VEC>
int launch_vec(const void* ref, const void* src, const void* rot, const void* trans, const void* depth,
               const void* valid, void* out, int64_t npix, int V, int D, int H, int W, int Hs, int Ws,
               int C, int dense, float sx, float sy, void* stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) * VEC < C && lanes_log2 < 5) ++lanes_log2;
  const int threads = 256;
  const int64_t per_block = threads >> lanes_log2;
  int64_t blocks = (npix + per_block - 1) / per_block;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride beyond this
  sweep_warp_variance_kernel<TIn, TOut, VEC><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const TIn*>(ref), static_cast<const TIn*>(src), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(depth),
      static_cast<const float*>(valid), static_cast<TOut*>(out), (uint32_t)npix, V, (uint32_t)D,
      (uint32_t)H, (uint32_t)W, Hs, Ws, C, dense, sx, sy, lanes_log2);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TIn, typename TOut>
int launch(const void* ref, const void* src, const void* rot, const void* trans, const void* depth,
           const void* valid, void* out, int B, int V, int D, int H, int W, int Hs, int Ws, int C,
           int dense, float sx, float sy, void* stream) {
  const int64_t npix = (int64_t)B * D * H * W;
  if (npix == 0 || C == 0) return 0;
  if (npix >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // 4 channels per lane where the channel-last rows allow whole vectors
  if (C % 4 == 0 && aligned(ref, 4 * sizeof(TIn)) && aligned(src, 4 * sizeof(TIn)) &&
      aligned(out, 4 * sizeof(TOut))) {
    return launch_vec<TIn, TOut, 4>(ref, src, rot, trans, depth, valid, out, npix, V, D, H, W, Hs, Ws, C,
                                    dense, sx, sy, stream);
  }
  return launch_vec<TIn, TOut, 1>(ref, src, rot, trans, depth, valid, out, npix, V, D, H, W, Hs, Ws, C,
                                  dense, sx, sy, stream);
}

}  // namespace

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
