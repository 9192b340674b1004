// The backward of plane-sweep score sampling (K1b) for Hopper (sm_90a).
//
// A new kernel with no TPU counterpart: the JAX package differentiates its
// XLA correlation routes and has no Pallas VJP of
// robustmvd_tpu/ops/pallas/planesweep_sample.py. K1 (planesweep_sample.cu)
// computes, for each key pixel p and hypothesis s,
//
//     out[p, s] = (1-wx) * ((1-wy) * c[y0, x0]   + wy * c[y0+1, x0])
//               +    wx  * ((1-wy) * c[y0, x0+1] + wy * c[y0+1, x0+1])
//
// with c = corr[p] and zeros padding. Given g = dL/dout (P, S), this kernel
// writes the dense gradient of the score images, dS (P, Hs, Ws): each
// in-range tap of each (p, s) receives (g * wx') * wy' (the column weight
// first, then the row weight, as autograd through the forward's arithmetic
// forms it), taps out of range are dropped, and every other element is zero.
// Taps of different hypotheses hit the same pixel, so a row accumulates.
//
// Two instantiations, one per score type of K1. The float one stores dS in
// float32. The bf16 one is the backward of K1's bf16 instantiation (the
// TPU's planesweep_sample_v2): its row weights are rounded to bf16 as the
// forward rounds them, the sums still run in float32, and dS is rounded to
// bf16 once, when it is stored.
//
// Bound: bytes. dS is written once (4 or 2 Hs Ws bytes per row) and g, y0,
// x0, wy, wx are read once (20 bytes per sample); about ten flops per
// sample. At the training shape (P = 4*48*96, 48x96 score images, S = 256)
// the write is 340 MB per source view in float32, 170 MB in bf16.
//
// Design: a block per row p zeroes a shared float row of Hs*Ws, adds its
// 4 S taps there with shared-memory atomics, then writes the row out as
// coalesced stores (16 bytes a thread where the row allows it: four floats,
// or eight bf16 rounded from two float4 reads): dS is written exactly once
// and no global atomic runs. A row of 48x160 takes 30 KB, ETH3D's 128x192
// 96 KB; rows beyond the block's opt-in shared memory (227 KB on the H100)
// take the global route: a memset, then one thread per (p, s) with global
// atomicAdd, into dS itself in float32, or into a float32 scratch that the
// caller allocates and a last pass rounds into the bf16 dS. Atomic order
// varies, so sums are not bit-exact run to run. Index math is 64-bit and
// each tap is tested against the image before its address is formed, so
// sentinel coordinates (+-1e9) never form an address.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int64_t i00, i01, i10, i11;  // flat offsets in the row, -1 when out of range
  float w00, w01, w10, w11;
};

__device__ __forceinline__ float row_weight(float w, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16(w)) : w;
}

template <bool kBf16Rows>
__device__ __forceinline__ Taps sample_taps(const float* __restrict__ grad, const int32_t* __restrict__ y0,
                                            const float* __restrict__ wy, const int32_t* __restrict__ x0,
                                            const float* __restrict__ wx, int64_t i, int32_t Hs,
                                            int32_t Ws) {
  const float g = grad[i];
  const int64_t ty = y0[i];
  const int64_t tx = x0[i];
  const float fy = wy[i];
  const float fx = wx[i];
  const float gx0 = g * (1.0f - fx);
  const float gx1 = g * fx;
  const float wy0 = row_weight(1.0f - fy, kBf16Rows);
  const float wy1 = row_weight(fy, kBf16Rows);
  const bool r0 = ty >= 0 && ty < Hs;
  const bool r1 = ty + 1 >= 0 && ty + 1 < Hs;
  const bool c0 = tx >= 0 && tx < Ws;
  const bool c1 = tx + 1 >= 0 && tx + 1 < Ws;
  Taps t;
  t.i00 = (r0 && c0) ? ty * Ws + tx : -1;
  t.i01 = (r0 && c1) ? ty * Ws + tx + 1 : -1;
  t.i10 = (r1 && c0) ? (ty + 1) * Ws + tx : -1;
  t.i11 = (r1 && c1) ? (ty + 1) * Ws + tx + 1 : -1;
  t.w00 = gx0 * wy0;
  t.w10 = gx0 * wy1;
  t.w01 = gx1 * wy0;
  t.w11 = gx1 * wy1;
  return t;
}

__device__ __forceinline__ void add_taps(float* row, const Taps& t) {
  if (t.i00 >= 0) atomicAdd(row + t.i00, t.w00);
  if (t.i10 >= 0) atomicAdd(row + t.i10, t.w10);
  if (t.i01 >= 0) atomicAdd(row + t.i01, t.w01);
  if (t.i11 >= 0) atomicAdd(row + t.i11, t.w11);
}

// One block's row, from shared memory to dS. Rows of a multiple of 4 (float)
// or 8 (bf16) elements start 16-byte aligned and go out as 16-byte stores.
__device__ __forceinline__ void store_row(float* dst, const float* row, int64_t n) {
  if (n % 4 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(row);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int64_t k = threadIdx.x; k < n / 4; k += blockDim.x) dst4[k] = src4[k];
  } else {
    for (int64_t k = threadIdx.x; k < n; k += blockDim.x) dst[k] = row[k];
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float* row, int64_t n) {
  if (n % 8 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(row);
    uint4* dst8 = reinterpret_cast<uint4*>(dst);
    for (int64_t k = threadIdx.x; k < n / 8; k += blockDim.x) {
      const float4 a = src4[2 * k];
      const float4 b = src4[2 * k + 1];
      dst8[k] = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                           pack_bf16x2(b.z, b.w));
    }
  } else {
    for (int64_t k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __float2bfloat16(row[k]);
  }
}

template <typename T, bool kBf16Rows>
__global__ void planesweep_sample_backward_shared_kernel(const float* __restrict__ grad,
                                                         const int32_t* __restrict__ y0,
                                                         const float* __restrict__ wy,
                                                         const int32_t* __restrict__ x0,
                                                         const float* __restrict__ wx,
                                                         T* __restrict__ out, int64_t P, int32_t S,
                                                         int32_t Hs, int32_t Ws) {
  extern __shared__ float4 row4[];  // 16-byte aligned for the row's vector reads
  float* row = reinterpret_cast<float*>(row4);
  const int64_t n = (int64_t)Hs * Ws;
  for (int64_t p = blockIdx.x; p < P; p += gridDim.x) {
    for (int64_t k = threadIdx.x; k < n; k += blockDim.x) row[k] = 0.0f;
    __syncthreads();
    for (int32_t s = threadIdx.x; s < S; s += blockDim.x) {
      add_taps(row, sample_taps<kBf16Rows>(grad, y0, wy, x0, wx, p * S + s, Hs, Ws));
    }
    __syncthreads();
    store_row(out + p * n, row, n);
    __syncthreads();  // the row is zeroed again for the next p
  }
}

template <bool kBf16Rows>
__global__ void planesweep_sample_backward_global_kernel(const float* __restrict__ grad,
                                                         const int32_t* __restrict__ y0,
                                                         const float* __restrict__ wy,
                                                         const int32_t* __restrict__ x0,
                                                         const float* __restrict__ wx,
                                                         float* __restrict__ out, int64_t total, int32_t S,
                                                         int32_t Hs, int32_t Ws) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    add_taps(out + (i / S) * (int64_t)Hs * Ws, sample_taps<kBf16Rows>(grad, y0, wy, x0, wx, i, Hs, Ws));
  }
}

// The global route's last pass for bf16: the float32 sums, rounded once.
__global__ void round_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

int max_shared_bytes() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return 0;
  return bytes;
}

unsigned grid_stride_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond this
  return (unsigned)blocks;
}

int route(int32_t Hs, int32_t Ws) {
  return (int64_t)Hs * Ws * (int64_t)sizeof(float) <= max_shared_bytes() ? 0 : 1;
}

// T is dS's type. For bf16 on the global route, scratch is a float32 buffer
// of P Hs Ws elements that the caller allocated; it is unused otherwise.
template <typename T>
int launch(const void* grad, const void* y0, const void* wy, const void* x0, const void* wx, void* out,
           void* scratch, int64_t P, int32_t S, int32_t Hs, int32_t Ws, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (P == 0 || (int64_t)Hs * Ws == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const float* g = static_cast<const float*>(grad);
  const int32_t* ty = static_cast<const int32_t*>(y0);
  const float* fy = static_cast<const float*>(wy);
  const int32_t* tx = static_cast<const int32_t*>(x0);
  const float* fx = static_cast<const float*>(wx);
  T* dst = static_cast<T*>(out);
  const int64_t n = P * (int64_t)Hs * Ws;
  if (route(Hs, Ws) == 0) {
    const int bytes = Hs * Ws * (int)sizeof(float);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(planesweep_sample_backward_shared_kernel<T, kBf16>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t blocks = P < (1LL << 30) ? P : (1LL << 30);
    planesweep_sample_backward_shared_kernel<T, kBf16><<<(unsigned)blocks, threads, bytes, st>>>(
        g, ty, fy, tx, fx, dst, P, S, Hs, Ws);
    return (int)cudaGetLastError();
  }
  if (kBf16 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* sums = kBf16 ? static_cast<float*>(scratch) : reinterpret_cast<float*>(dst);
  const cudaError_t err = cudaMemsetAsync(sums, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = P * S;
  if (total > 0) {
    planesweep_sample_backward_global_kernel<kBf16><<<grid_stride_blocks(total, threads), threads, 0, st>>>(
        g, ty, fy, tx, fx, sums, total, S, Hs, Ws);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  if constexpr (kBf16) {
    round_to_bf16_kernel<<<grid_stride_blocks(n, threads), threads, 0, st>>>(
        sums, reinterpret_cast<__nv_bfloat16*>(dst), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// 0: a block per row in shared memory; 1: memset + global atomics.
extern "C" int planesweep_sample_backward_route(int32_t Hs, int32_t Ws) { return route(Hs, Ws); }

extern "C" int planesweep_sample_backward(const void* grad, const void* y0, const void* wy, const void* x0,
                                          const void* wx, void* out, int64_t P, int32_t S, int32_t Hs,
                                          int32_t Ws, void* stream) {
  return launch<float>(grad, y0, wy, x0, wx, out, nullptr, P, S, Hs, Ws, stream);
}

extern "C" int planesweep_sample_backward_bf16(const void* grad, const void* y0, const void* wy, const void* x0,
                                               const void* wx, void* out, void* scratch, int64_t P, int32_t S,
                                               int32_t Hs, int32_t Ws, void* stream) {
  return launch<__nv_bfloat16>(grad, y0, wy, x0, wx, out, scratch, P, S, Hs, Ws, stream);
}
