// 3x3x3 stride-1 pad-1 convolution (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel robustmvd_tpu/ops/pallas/conv3d.py
// (conv3d_banded_pallas, kernel _kernel), the Pallas form of the JAX
// package's lane-packed conv (conv3d_impl="banded"/"packed"). It computes
//
//     out[b, o, z, y, x] = sum over (dz, dy, dx, i) of
//                          in[b, i, z + dz - 1, y + dy - 1, x + dx - 1] * k[dz, dy, dx, i, o]
//                          (+ bias[o], added after the sum)
//
// with zeros outside the volume, float32 in, float32 accumulation, float32
// out: the lax.conv_general_dilated semantics of the TPU kernel, not its
// banded (T+2)*C lane packing, which exists only because the TPU's lanes are
// 128 wide. Input, output and weights are addressed through explicit
// element strides, so one source serves the port's NCDHW U-Nets and the JAX
// layout (NDHWC input, DHWIO kernel) without a permute; the weight of an
// nn.Conv3d, (O, I, 3, 3, 3), is passed as a strided DHWIO view.
//
// Bound: operations. 54 * Cin * Cout flops per output voxel against
// 4 * (Cin + Cout) bytes moved: at Cin = Cout = 16 that is ~108 flop/byte,
// above the ~20 flop/byte where the H100's float32 rate (67 TFLOP/s, no
// tensor cores) binds. Only the one-output-channel score heads (Cout = 1)
// are bound by bytes.
//
// Design (a first, simple version): a block of 8 x 32 threads takes an
// output tile of 4 planes x 8 rows x 32 columns and up to COB output
// channels; each thread keeps the 4 x COB sums of its column in registers.
// Input channels are taken four at a time: the block stages the 6 x 10 x 34
// halo of those channels and their 27 x COB weights in shared memory
// (~40 KB), then each thread walks the 9 (dy, dx) taps, reads the 6 input
// planes of its column once and uses each weight triple (dz = 0, 1, 2) for
// its 4 output planes. Rows of 32 columns make the staging loads and the
// output stores coalesced along W in NCDHW. TF32 tensor cores, wgmma and
// TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // output columns per block (the lanes of a warp)
constexpr int TH = 8;   // output rows per block (one warp each)
constexpr int TD = 4;   // output planes per thread
constexpr int CI = 4;   // input channels per shared-memory stage
constexpr int XW = TW + 2, XH = TH + 2, XD = TD + 2;

struct Strides {  // element strides of a 5D volume, by axis
  int64_t b, c, d, h, w;
};

struct KStrides {  // element strides of the DHWIO kernel
  int64_t dz, dy, dx, i, o;
};

template <int COB>
__global__ void __launch_bounds__(TW * TH)
conv3d_k3_kernel(const float* __restrict__ in, Strides is, const float* __restrict__ k, KStrides ks,
                 const float* __restrict__ bias, float* __restrict__ out, Strides os, int Cin, int Cout,
                 int D, int H, int W, int tiles_w, int co_blocks) {
  __shared__ float xs[CI][XD][XH][XW];
  __shared__ float wsm[CI][27][COB];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = (blockIdx.x % tiles_w) * TW, y0 = (blockIdx.x / tiles_w) * TH;
  const int z0 = blockIdx.y * TD;
  const int b = blockIdx.z / co_blocks, o0 = (blockIdx.z % co_blocks) * COB;
  const float* inb = in + b * is.b;

  float acc[TD][COB];
#pragma unroll
  for (int t = 0; t < TD; ++t)
#pragma unroll
    for (int o = 0; o < COB; ++o) acc[t][o] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    __syncthreads();  // the previous stage is consumed
    for (int e = tid; e < CI * XD * XH * XW; e += TW * TH) {
      const int xx = e % XW;
      int r = e / XW;
      const int yy = r % XH;
      r /= XH;
      const int zz = r % XD;
      const int ci = r / XD;
      const int gx = x0 + xx - 1, gy = y0 + yy - 1, gz = z0 + zz - 1, gc = c0 + ci;
      float v = 0.0f;
      if (gc < Cin && gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(inb + gc * is.c + gz * is.d + gy * is.h + gx * is.w);
      xs[ci][zz][yy][xx] = v;
    }
    for (int e = tid; e < CI * 27 * COB; e += TW * TH) {
      const int o = e % COB;
      const int tap = (e / COB) % 27;
      const int ci = e / (COB * 27);
      const int gc = c0 + ci, go = o0 + o;
      float v = 0.0f;
      if (gc < Cin && go < Cout)
        v = __ldg(k + (tap / 9) * ks.dz + ((tap / 3) % 3) * ks.dy + (tap % 3) * ks.dx + gc * ks.i + go * ks.o);
      wsm[ci][tap][o] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[XD];
#pragma unroll
          for (int z = 0; z < XD; ++z) xv[z] = xs[ci][z][ty + dy][tx + dx];
#pragma unroll
          for (int o = 0; o < COB; ++o) {
            const float k0 = wsm[ci][dy * 3 + dx][o];
            const float k1 = wsm[ci][9 + dy * 3 + dx][o];
            const float k2 = wsm[ci][18 + dy * 3 + dx][o];
#pragma unroll
            for (int t = 0; t < TD; ++t)
              acc[t][o] = fmaf(xv[t + 2], k2, fmaf(xv[t + 1], k1, fmaf(xv[t], k0, acc[t][o])));
          }
        }
      }
    }
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  float* outb = out + b * os.b + y * os.h + x * os.w;
#pragma unroll
  for (int o = 0; o < COB; ++o) {
    const int go = o0 + o;
    if (go >= Cout) break;
    const float add = bias != nullptr ? bias[go] : 0.0f;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int z = z0 + t;
      if (z < D) outb[go * os.c + z * os.d] = acc[t][o] + add;
    }
  }
}

template <int COB>
int launch(const float* in, Strides is, const float* k, KStrides ks, const float* bias, float* out,
           Strides os, int B, int Cin, int Cout, int D, int H, int W, void* stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int co_blocks = (Cout + COB - 1) / COB;
  const int64_t gx = (int64_t)tiles_w * tiles_h, gy = (D + TD - 1) / TD, gz = (int64_t)B * co_blocks;
  if (gx >= (1LL << 31) || gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  conv3d_k3_kernel<COB><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)gz), dim3(TW, TH), 0, (cudaStream_t)stream>>>(
      in, is, k, ks, bias, out, os, Cin, Cout, D, H, W, tiles_w, co_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: in_strides / out_strides by axis (b, c, d, h, w),
// k_strides by (dz, dy, dx, i, o). bias may be null.
extern "C" int conv3d_banded(const void* in, const int64_t* in_strides, const void* k, const int64_t* k_strides,
                             const void* bias, void* out, const int64_t* out_strides, int32_t B, int32_t Cin,
                             int32_t Cout, int32_t D, int32_t H, int32_t W, void* stream) {
  if ((int64_t)B * Cin * Cout * D * H * W == 0) return 0;
  const Strides is{in_strides[0], in_strides[1], in_strides[2], in_strides[3], in_strides[4]};
  const Strides os{out_strides[0], out_strides[1], out_strides[2], out_strides[3], out_strides[4]};
  const KStrides ks{k_strides[0], k_strides[1], k_strides[2], k_strides[3], k_strides[4]};
  const float *x = static_cast<const float*>(in), *w = static_cast<const float*>(k);
  const float* bs = static_cast<const float*>(bias);
  float* y = static_cast<float*>(out);
  if (Cout == 1) return launch<1>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
  if (Cout <= 4) return launch<4>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
  if (Cout <= 8) return launch<8>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
  return launch<16>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
}
