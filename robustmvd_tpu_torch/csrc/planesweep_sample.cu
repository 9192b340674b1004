// Plane-sweep score sampling (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernels robustmvd_tpu/ops/pallas/planesweep_sample.py
// (planesweep_sample, kernel _kernel) and
// robustmvd_tpu/ops/pallas/planesweep_sample_v2.py (planesweep_sample_v2).
// Given per-key-pixel score images corr (P, Hs, Ws) and, per (pixel p,
// hypothesis s), the top-left tap (y0, x0) with fractions (wy, wx), it writes
//
//     out[p, s] = (1-wx) * ((1-wy) * c[y0, x0]   + wy * c[y0+1, x0])
//               +    wx  * ((1-wy) * c[y0, x0+1] + wy * c[y0+1, x0+1])
//
// with c = corr[p], zeros padding (a tap outside [0,Hs) x [0,Ws) adds 0) and
// no masks (the caller applies them). The float instantiation is v1. The
// bf16 instantiation is v2: scores stored in bf16 and the row weights
// (1-wy, wy) rounded to bf16, as v2 rounds its two-hot row matrix before the
// MXU dot; x-weights and the accumulation stay f32.
//
// Bound: bytes, not operations. Each sample reads 16 B of coordinates,
// writes 4 B and gathers at most four scores; it does about ten flops, far
// below the ~20 flop/B at which the H100's f32 rate would bind. The (P, Hs,
// Ws) score volume is far larger than what is read from it: only the taps
// near each epipolar line are touched.
//
// Design: the TPU kernel builds a two-hot (S, Hs) row matrix and runs an MXU
// dot because a TPU cannot gather; Hopper gathers well, so each thread takes
// one (p, s) and loads its four taps directly. Threads of a block run over s
// for the same p (S is the fast axis), so the coordinate loads and output
// stores are coalesced and the taps of one block fall into one score image,
// which the L1/L2 caches serve. Index math is 64-bit and each tap is tested
// against the image before it is loaded, so sentinel coordinates (+-1e9)
// never form an address.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_score(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_score(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float row_weight(float w, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16(w)) : w;
}

template <typename T, bool kBf16Rows>
__global__ void planesweep_sample_kernel(const T* __restrict__ corr,
                                         const int32_t* __restrict__ y0,
                                         const float* __restrict__ wy,
                                         const int32_t* __restrict__ x0,
                                         const float* __restrict__ wx,
                                         float* __restrict__ out,
                                         int64_t n, int32_t S, int32_t Hs, int32_t Ws) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t p = i / S;
    const int64_t ty = y0[i];
    const int64_t tx = x0[i];
    const float fy = wy[i];
    const float fx = wx[i];
    const float wy0 = row_weight(1.0f - fy, kBf16Rows);
    const float wy1 = row_weight(fy, kBf16Rows);

    const T* img = corr + p * (int64_t)Hs * Ws;
    const bool r0 = ty >= 0 && ty < Hs;
    const bool r1 = ty + 1 >= 0 && ty + 1 < Hs;
    const bool c0 = tx >= 0 && tx < Ws;
    const bool c1 = tx + 1 >= 0 && tx + 1 < Ws;

    const float a00 = (r0 && c0) ? load_score(img + ty * Ws + tx) : 0.0f;
    const float a01 = (r0 && c1) ? load_score(img + ty * Ws + tx + 1) : 0.0f;
    const float a10 = (r1 && c0) ? load_score(img + (ty + 1) * Ws + tx) : 0.0f;
    const float a11 = (r1 && c1) ? load_score(img + (ty + 1) * Ws + tx + 1) : 0.0f;

    const float m0 = wy0 * a00 + wy1 * a10;
    const float m1 = wy0 * a01 + wy1 * a11;
    out[i] = (1.0f - fx) * m0 + fx * m1;
  }
}

template <typename T, bool kBf16Rows>
int launch(const void* corr, const void* y0, const void* wy, const void* x0, const void* wx,
           void* out, int64_t P, int32_t S, int32_t Hs, int32_t Ws, void* stream) {
  const int64_t n = P * S;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond this
  planesweep_sample_kernel<T, kBf16Rows><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(corr), static_cast<const int32_t*>(y0),
      static_cast<const float*>(wy), static_cast<const int32_t*>(x0),
      static_cast<const float*>(wx), static_cast<float*>(out), n, S, Hs, Ws);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int planesweep_sample_f32(const void* corr, const void* y0, const void* wy,
                                     const void* x0, const void* wx, void* out, int64_t P,
                                     int32_t S, int32_t Hs, int32_t Ws, void* stream) {
  return launch<float, false>(corr, y0, wy, x0, wx, out, P, S, Hs, Ws, stream);
}

extern "C" int planesweep_sample_bf16(const void* corr, const void* y0, const void* wy,
                                      const void* x0, const void* wx, void* out, int64_t P,
                                      int32_t S, int32_t Hs, int32_t Ws, void* stream) {
  return launch<__nv_bfloat16, true>(corr, y0, wy, x0, wx, out, P, S, Hs, Ws, stream);
}
