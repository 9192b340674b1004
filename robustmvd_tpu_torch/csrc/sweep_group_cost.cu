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
// the plain torch version in ops/kernels/sweep_group_cost.py, so the card and
// the CPU round alike. Non-finite coordinates become 1e9 (all taps outside),
// and the floor is clamped to +-2^30 before the integer cast; tap offsets are
// 64-bit.
//
// Bound: bytes. The output (B*D*H*W*G values), the per-pixel multipliers w
// (B*D*H*W) and the key and source maps are each moved once at least; the
// work is ~45 flops per pixel for the coordinates and weights plus ~9 per
// channel, about 9 flops per output byte at C = 32, G = 8: below the ~20
// flop/byte at which the H100's f32 rate binds.
//
// Design: the TPU kernel turns sampling into x-tent matmuls over bands of
// source rows because a TPU cannot gather; Hopper gathers. A group of lanes
// takes one output pixel, one lane per correlation group, and each lane sums
// its group's channels in order, so no sum crosses lanes and the op order is
// the plain version's. Where the group's channels allow whole vectors
// (C/G % 4 == 0, 16-byte aligned maps) a lane loads four channels per 16-byte
// load: at C = 32, G = 8 a lane's four channels are exactly its group, the 8
// lanes of a pixel read each 128-byte tap row together and store the pixel's
// 8 outputs as one 32-byte row. Otherwise a lane loads one channel at a time.
// Each lane computes its pixel's coordinates itself (no shuffles). Pixel
// indices are 32-bit; grid-stride loop over pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load<1>(const float* p, float (&v)[1]) { v[0] = __ldg(p); }

template <>
__device__ __forceinline__ void load<4>(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Tap {
  int64_t offset[4];  // element offsets of the taps (00, 01, 10, 11) into the source map
  float weight[4];    // bilinear weights; a tap outside the map has offset -1
};

// Coordinates and taps of one pixel, in the plain version's op order.
__device__ __forceinline__ Tap homography_taps(const float* __restrict__ A, const float* __restrict__ Bm,
                                               float w, float xf, float yf, int Hs, int Ws, int C) {
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
  const int64_t x0 = (int64_t)fminf(fmaxf(x0f, -lim), lim);
  const int64_t y0 = (int64_t)fminf(fmaxf(y0f, -lim), lim);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const float wt[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
  Tap tap;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t xk = x0 + (k & 1), yk = y0 + (k >> 1);
    const bool in = xk >= 0 && xk <= Ws - 1 && yk >= 0 && yk <= Hs - 1;
    tap.offset[k] = in ? (yk * Ws + xk) * C : -1;
    tap.weight[k] = wt[k];
  }
  return tap;
}

// A group of `lanes` threads per output pixel, lane g summing group g (and
// g + lanes, ... where G > lanes), VEC channels per load.
template <typename TOut, int VEC>
__global__ void homography_group_cost_kernel(const float* __restrict__ ref,  // (B, H, W, C)
                                             const float* __restrict__ src,  // (B, Hs, Ws, C)
                                             const float* __restrict__ A,    // (B, 3, 3)
                                             const float* __restrict__ Bm,   // (B, 3, 3)
                                             const float* __restrict__ w,    // (B, D, H, W)
                                             TOut* __restrict__ out,         // (B, D, H, W, G)
                                             uint32_t npix, uint32_t D, uint32_t H, uint32_t W, int Hs,
                                             int Ws, int C, int G, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int cg = C / G;
  const uint32_t first = (uint32_t)(((uint64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2);
  const uint32_t stride = (uint32_t)(((uint64_t)gridDim.x * blockDim.x) >> lanes_log2);
  for (uint32_t p = first; p < npix; p += stride) {
    const uint32_t x = p % W;
    uint32_t t = p / W;
    const uint32_t y = t % H;
    const int64_t b = t / H / D;
    const Tap tap = homography_taps(A + b * 9, Bm + b * 9, w[p], (float)x, (float)y, Hs, Ws, C);
    const float* refp = ref + ((b * H + y) * W + x) * C;
    const float* map = src + b * Hs * Ws * C;
    for (int g = lane; g < G; g += lanes) {
      float acc = 0.0f;
      for (int c = g * cg; c < (g + 1) * cg; c += VEC) {
        float r[VEC], warped[VEC];
        load<VEC>(refp + c, r);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float a[VEC];
          if (tap.offset[k] >= 0) {
            load<VEC>(map + tap.offset[k] + c, a);
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
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float prod = __fmul_rn(r[j], warped[j]);
          acc = (c + j == g * cg) ? prod : __fadd_rn(acc, prod);  // the group's first channel
        }
      }
      store(out + (int64_t)p * G + g, acc);
    }
  }
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename TOut, int VEC>
int launch_vec(const float* ref, const float* src, const float* A, const float* Bm, const float* w, void* out,
               int64_t npix, int D, int H, int W, int Hs, int Ws, int C, int G, void* stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < G && lanes_log2 < 5) ++lanes_log2;
  const int threads = 256;
  const int64_t per_block = threads >> lanes_log2;
  int64_t blocks = (npix + per_block - 1) / per_block;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride beyond this
  homography_group_cost_kernel<TOut, VEC><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      ref, src, A, Bm, w, static_cast<TOut*>(out), (uint32_t)npix, (uint32_t)D, (uint32_t)H, (uint32_t)W, Hs,
      Ws, C, G, lanes_log2);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch(const float* ref, const float* src, const float* A, const float* Bm, const float* w, void* out,
           int B, int D, int H, int W, int Hs, int Ws, int C, int G, void* stream) {
  const int64_t npix = (int64_t)B * D * H * W;
  if (npix == 0 || G == 0) return 0;
  if (npix >= (1LL << 31) || C % G != 0) return (int)cudaErrorInvalidValue;
  // 4 channels per load where each group is whole vectors and the rows are aligned
  if ((C / G) % 4 == 0 && aligned(ref, 16) && aligned(src, 16)) {
    return launch_vec<TOut, 4>(ref, src, A, Bm, w, out, npix, D, H, W, Hs, Ws, C, G, stream);
  }
  return launch_vec<TOut, 1>(ref, src, A, Bm, w, out, npix, D, H, W, Hs, Ws, C, G, stream);
}

}  // namespace

// out_bf16 selects a bf16 (else float32) output.
extern "C" int sweep_group_cost(const void* ref, const void* src, const void* A, const void* Bm, const void* w,
                                void* out, int32_t B, int32_t D, int32_t H, int32_t W, int32_t Hs, int32_t Ws,
                                int32_t C, int32_t G, int32_t out_bf16, void* stream) {
  const float* args[5] = {static_cast<const float*>(ref), static_cast<const float*>(src),
                          static_cast<const float*>(A), static_cast<const float*>(Bm),
                          static_cast<const float*>(w)};
  return out_bf16 ? launch<__nv_bfloat16>(args[0], args[1], args[2], args[3], args[4], out, B, D, H, W, Hs, Ws,
                                          C, G, stream)
                  : launch<float>(args[0], args[1], args[2], args[3], args[4], out, B, D, H, W, Hs, Ws, C, G,
                                  stream);
}
