// Fused soft-argmin readout (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/softargmin.py
// (fused_soft_argmin, kernel _kernel). For a (B, D, H, W) float32 score
// volume and every pixel (b, y, x) it computes, over the hypothesis axis d,
//
//     p_d         = exp(v_d - max v) / sum exp(v - max v)   (written out)
//     expectation = sum d * p_d
//     entropy     = sum -p_d * log(clip(p_d, 1e-9, 1))
//     mass        = sum p_d * (|d - expectation| <= window)
//
// the readouts of the MVSNet family (rmvd/models/blocks/utils.py:51-68:
// soft_argmin, entropy and soft_argmin's windowed probability mass), with
// expf / logf (no fast-math intrinsics). Every sum runs over d in order,
// each product and sum rounded on its own. The mass multiplies by the mask
// as the reference does, so a non-finite p makes it NaN there too.
//
// Bound: bytes. The volume is read once and the probability volume written
// once (8 bytes per element), plus three (B, 1, H, W) maps; the work is an
// exp, a log, a division and ~10 more flops per element, about 2 flops per
// byte, below the ~20 flop/byte at which the H100's f32 rate binds.
//
// Design: the TPU kernel holds a (D, 512) tile of pixel columns in VMEM.
// Here a thread takes whole pixel columns; adjacent threads take adjacent
// pixels, so every load and store of the strided D axis is coalesced. Two
// routes, chosen by soft_argmin_route below:
// - registers, for the D that vis_mvsnet uses (16, 32, 64; compile-time D):
//   the thread loads its column into registers with all D loads in flight,
//   computes one expf per element, then the probabilities, expectation and
//   entropy, then the window mass, from registers; the probabilities are
//   written once with streaming stores and never read back. (Two adjacent
//   pixels per thread with float2 loads were slower at every vis shape:
//   more registers, half the threads.)
// - generic, any other D: four passes over the column (max, exp-sum,
//   probabilities with expectation and entropy, window mass), the later
//   passes finding the block's columns in L1 or L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float window_mask(int d, float e, float window) {
  return fabsf(__fsub_rn((float)d, e)) <= window ? 1.0f : 0.0f;
}

// The register route: one pixel column per thread, D known at compile time.
template <int D>
__global__ void __launch_bounds__(kThreads)
soft_argmin_registers_kernel(const float* __restrict__ volume,     // (B, D, H, W)
                             float* __restrict__ prob,             // (B, D, H, W)
                             float* __restrict__ expectation,      // (B, 1, H, W)
                             float* __restrict__ entropy,          // (B, 1, H, W)
                             float* __restrict__ mass,             // (B, 1, H, W)
                             uint32_t npix, uint32_t HW, float window) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int64_t base = (int64_t)(i / HW) * D * HW + i % HW;  // (b, 0, pixel)
  float v[D];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = __ldg(volume + base + (int64_t)d * HW);
  float vmax = -INFINITY;
#pragma unroll
  for (int d = 0; d < D; ++d) vmax = fmaxf(vmax, v[d]);
  float sum = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = expf(__fsub_rn(v[d], vmax));
    sum = __fadd_rn(sum, v[d]);
  }
  float e = 0.0f, h = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = __fdiv_rn(v[d], sum);
    e = __fadd_rn(e, __fmul_rn((float)d, v[d]));
    h = __fadd_rn(h, __fmul_rn(-v[d], logf(fminf(fmaxf(v[d], 1e-9f), 1.0f))));
  }
  float m = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) m = __fadd_rn(m, __fmul_rn(v[d], window_mask(d, e, window)));
#pragma unroll
  for (int d = 0; d < D; ++d) __stcs(prob + base + (int64_t)d * HW, v[d]);
  expectation[i] = e;
  entropy[i] = h;
  mass[i] = m;
}

// The generic route: one pixel column per thread, four passes over D.
__global__ void __launch_bounds__(kThreads)
soft_argmin_generic_kernel(const float* __restrict__ volume,  // (B, D, H, W)
                           float* prob,                        // (B, D, H, W)
                           float* __restrict__ expectation,    // (B, 1, H, W)
                           float* __restrict__ entropy,        // (B, 1, H, W)
                           float* __restrict__ mass,           // (B, 1, H, W)
                           uint32_t npix, uint32_t HW, int D, float window) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int64_t base = (int64_t)(i / HW) * D * HW + i % HW;  // (b, 0, pixel)
  const float* v = volume + base;
  float* p = prob + base;
  float vmax = -INFINITY;
  for (int d = 0; d < D; ++d) vmax = fmaxf(vmax, __ldg(v + (int64_t)d * HW));
  float sum = 0.0f;
  for (int d = 0; d < D; ++d) sum = __fadd_rn(sum, expf(__fsub_rn(__ldg(v + (int64_t)d * HW), vmax)));
  float e = 0.0f, h = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float pd = __fdiv_rn(expf(__fsub_rn(__ldg(v + (int64_t)d * HW), vmax)), sum);
    p[(int64_t)d * HW] = pd;
    e = __fadd_rn(e, __fmul_rn((float)d, pd));
    h = __fadd_rn(h, __fmul_rn(-pd, logf(fminf(fmaxf(pd, 1e-9f), 1.0f))));
  }
  float m = 0.0f;
  for (int d = 0; d < D; ++d) m = __fadd_rn(m, __fmul_rn(p[(int64_t)d * HW], window_mask(d, e, window)));
  expectation[i] = e;
  entropy[i] = h;
  mass[i] = m;
}

template <int D>
int launch_registers(const void* volume, void* prob, void* expectation, void* entropy, void* mass, int64_t npix,
                     int HW, float window, void* stream) {
  soft_argmin_registers_kernel<D><<<(unsigned)((npix + kThreads - 1) / kThreads), kThreads, 0,
                                    (cudaStream_t)stream>>>(
      static_cast<const float*>(volume), static_cast<float*>(prob), static_cast<float*>(expectation),
      static_cast<float*>(entropy), static_cast<float*>(mass), (uint32_t)npix, (uint32_t)HW, window);
  return (int)cudaGetLastError();
}

}  // namespace

// The route soft_argmin takes for D hypotheses: 1 the register route (the D
// that vis_mvsnet uses), 0 the generic four-pass kernel.
extern "C" int soft_argmin_route(int32_t D) { return D == 16 || D == 32 || D == 64; }

extern "C" int soft_argmin(const void* volume, void* prob, void* expectation, void* entropy, void* mass,
                           int32_t B, int32_t D, int32_t HW, float window, void* stream) {
  const int64_t npix = (int64_t)B * HW;
  if (npix == 0 || D == 0) return 0;
  if (npix * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  switch (soft_argmin_route(D) ? D : 0) {
    case 16: return launch_registers<16>(volume, prob, expectation, entropy, mass, npix, HW, window, stream);
    case 32: return launch_registers<32>(volume, prob, expectation, entropy, mass, npix, HW, window, stream);
    case 64: return launch_registers<64>(volume, prob, expectation, entropy, mass, npix, HW, window, stream);
    default: break;
  }
  soft_argmin_generic_kernel<<<(unsigned)((npix + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(volume), static_cast<float*>(prob), static_cast<float*>(expectation),
      static_cast<float*>(entropy), static_cast<float*>(mass), (uint32_t)npix, (uint32_t)HW, D, window);
  return (int)cudaGetLastError();
}
