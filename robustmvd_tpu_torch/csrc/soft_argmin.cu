// Fused soft-argmin readout (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/softargmin.py
// (fused_soft_argmin, kernel _kernel). For a (B, D, H, W) float32 score
// volume and every pixel (b, y, x) it computes, over the hypothesis axis d,
//
//     p_d         = exp(v_d - max v) / sum exp(v - max v)   (written out)
//     expectation = sum d * p_d
//     entropy     = sum -p_d * log(clip(p_d, 1e-9, 1))
//     mass        = sum p_d over |d - expectation| <= window
//
// the readouts of the MVSNet family (rmvd/models/blocks/utils.py:51-68:
// soft_argmin, entropy and soft_argmin's windowed probability mass), with
// expf / logf (no fast-math intrinsics).
//
// Bound: bytes. The volume is read once and the probability volume written
// once (8 bytes per element), plus three (B, 1, H, W) maps; the work is an
// exp, a log, a division and ~10 more flops per element, about 2 flops per
// byte, below the ~20 flop/byte at which the H100's f32 rate binds.
//
// Design: the TPU kernel holds a (D, 512) tile of pixel columns in VMEM.
// Here one thread takes one pixel column and walks D in four passes (max,
// exp-sum, probabilities with expectation and entropy, window mass); adjacent
// threads take adjacent pixels, so every load and store of the strided D axis
// is coalesced. Only the first pass reads the volume from device memory: the
// later passes find a block's columns (256 pixels x D x 4 bytes) in L1 or L2.
// The expectation is summed over the rounded probabilities before the window
// pass, as the reference orders it. Grid-stride loop over pixels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void soft_argmin_kernel(const float* __restrict__ volume,  // (B, D, H, W)
                                   float* prob,                        // (B, D, H, W)
                                   float* __restrict__ expectation,    // (B, 1, H, W)
                                   float* __restrict__ entropy,        // (B, 1, H, W)
                                   float* __restrict__ mass,           // (B, 1, H, W)
                                   uint32_t npix, uint32_t HW, int D, float window) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < npix; i += stride) {
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
    for (int d = 0; d < D; ++d) {
      if (fabsf(__fsub_rn((float)d, e)) <= window) m = __fadd_rn(m, p[(int64_t)d * HW]);
    }
    expectation[i] = e;
    entropy[i] = h;
    mass[i] = m;
  }
}

}  // namespace

extern "C" int soft_argmin(const void* volume, void* prob, void* expectation, void* entropy, void* mass,
                           int32_t B, int32_t D, int32_t HW, float window, void* stream) {
  const int64_t npix = (int64_t)B * HW;
  if (npix == 0 || D == 0) return 0;
  if (npix * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (npix + threads - 1) / threads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;  // grid-stride beyond this
  soft_argmin_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(volume), static_cast<float*>(prob), static_cast<float*>(expectation),
      static_cast<float*>(entropy), static_cast<float*>(mass), (uint32_t)npix, (uint32_t)HW, D, window);
  return (int)cudaGetLastError();
}
