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
// with zeros outside the volume, float32 in, float32 out: the
// lax.conv_general_dilated semantics of the TPU kernel, not its banded
// (T+2)*C lane packing, which exists only because the TPU's lanes are 128
// wide. Input, output and weights are addressed through explicit element
// strides, so one source serves the port's NCDHW U-Nets and the JAX layout
// (NDHWC input, DHWIO kernel) without a permute; the weight of an
// nn.Conv3d, (O, I, 3, 3, 3), is passed as a strided DHWIO view.
//
// Bound: operations. 54 * Cin * Cout flops per output voxel against
// 4 * (Cin + Cout) bytes moved: ~108 flop/byte at Cin = Cout = 16. Only
// the score heads (Cout <= 4) are bound by bytes.
//
// Cout > 4: an implicit GEMM on the tensor cores (conv3d_k3_kernel_mma).
// Per batch element M is the output voxels, N is Cout, K is 27 taps x Cin.
//   - A tile is a box of 4 planes x 2*WY rows x 8*WX columns by BN output
//     channels. Each warp takes 4 planes x 2 rows x 8 columns by 8*WN
//     channels: four m16 fragments (one per plane; a fragment's rows g and
//     g + 8 are column g of the warp's two rows) by WN n8 fragments. Columns
//     in eights keep the ragged W of 40 and 80 whole.
//   - Tiles of 8 warps: 4 x 8 x 16 voxels by 8 channels (Cout <= 8) or 16.
//     For Cout > 16 on a volume too small to give each resident block two
//     such tiles (mvsnet's conv6, 32 x 12 x 40), 4 x 4 x 8 voxels by 32
//     channels, two warps along N: 240 tiles for 264 resident blocks, where
//     the wide tile gives 192 for 132. Each output sums its products in the
//     same order in every tile, so the choice moves no bit.
//   - K is walked as (8-channel chunk, dy, dx, dz). For a chunk the block
//     stages the tile's halo (6 planes x (2*WY + 2) rows x (8*WX + 8)
//     columns, from x0 - 4 so that rows start on 16 bytes) and the chunk's
//     27 x 8 x BN weights in shared memory with cp.async. Positions outside
//     the volume, channels >= Cin and outputs >= Cout are zero-filled by the
//     copy (a source size of 0). Rows copy as 16-byte vectors when W is
//     unit-stride and everything is 16-byte aligned (NCDHW, W % 4 == 0),
//     else element by element; weights element by element, in the order of
//     their memory.
//   - Blocks are persistent, one per resident slot, and walk their tiles'
//     (tile, chunk) steps through a ring of two stages: the copies of the
//     next step, in this tile or the next, overlap this step's products. A
//     volume of 8 channels (vis_mvsnet) is one chunk per tile, so without
//     the ring across tiles every block would wait for its copies.
//   - A fragments are read straight from the halo at the tap's offset (no
//     im2col in device memory). For each (dy, dx) a warp splits the B
//     fragments of the 3 dz taps, then reads the six halo planes once each:
//     plane p feeds output plane p - dz. The halo's channel pitch is 8 mod 32
//     words and the weights lie by (channel, output, tap) with pitches of 1
//     and 28 mod 32, so the fragment loads are free of bank conflicts.
//   - float32 accuracy from TF32 mma.sync (m16n8k8) with the 3xTF32 split:
//     hi = rna(x), lo = rna(x - hi) for both operands (rna: cvt.rna.tf32's
//     rounding in integer ops; inf and NaN pass through hi, so they reach the
//     output as in the plain version), lo*hi + hi*lo + hi*hi summed in float32
//     registers, lo*lo dropped. Each product keeps ~21 of float32's 24 bits,
//     against ~11 for one TF32 pass.
//   - The tensor cores' float32 adds are not rounded to nearest: each mma
//     can lose up to an ulp of its accumulator, and one accumulator over all
//     27 * Cin / 8 * 3 mmas missed 2e-5 at Cin = 32 and 64. So the mmas of
//     one dy (27) go into a partial that is then added to the float32 sum
//     with round-to-nearest adds.
//   - Bound in practice by the instructions around the mmas and their
//     stalls, not by the tensor cores (mma.sync alone runs several times
//     faster): each A and B element costs a shared-memory load and 5 integer
//     and float ops for its split, ~5 instructions per mma at Cout = 8.
// Cout <= 4 (the score heads, bound by bytes): a direct conv on the CUDA
// cores (conv3d_k3_kernel), one thread per output column of 4 planes x COB
// output channels, halo tile and weights of 4 input channels in shared
// memory.
//
// bf16 (conv3d_banded_bf16, Cout > 4): the TPU kernel's bf16 form, which
// casts the band matrix to x.dtype, sums in float32 and writes x.dtype. The
// same tiles, ring and persistent blocks on bf16 mma.sync (m16n8k16): one
// pass, no split; float32 accumulators (each dy's 9 mmas in a partial added
// with round-to-nearest adds, as above); the bias added in float32; the
// output rounded once to bf16. A 32-bit word of shared memory holds the two
// bf16 of a channel pair at one voxel (or one tap and output), which is the
// operand register of m16n8k16, so a stage holds 16 channels in the words of
// the float32 form's 8 and the fragment loads keep its bank pattern. Pairs of
// NCDHW channels lie apart in memory and cp.async cannot interleave them, so
// the block stages with plain loads (8 bytes, 4 columns of each channel of a
// pair, merged by byte permutes into one 16-byte shared store, where W is
// unit-stride and W % 4 == 0; else 2 bytes at a time) and one stage, not the
// ring: a block's copies do not overlap its products, and the halved shared
// memory lets more blocks share an SM, whose products overlap them. Bound:
// bytes at vis's 8- and 16-channel shapes, operations at the dense bf16 rate
// (989 TFLOP/s) from 32 channels. The score heads stay float32 (the JAX
// family's heads are float32), so there is no bf16 CUDA-core route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {  // element strides of a 5D volume, by axis
  int64_t b, c, d, h, w;
};

struct KStrides {  // element strides of the DHWIO kernel
  int64_t dz, dy, dx, i, o;
};

// ---------------------------------------------------------------------------
// Cout > 4: implicit GEMM on the tensor cores, 3xTF32 (float32) or bf16.

constexpr int TZ = 4;  // output planes of a tile, one m16 fragment each per warp
constexpr int KC = 8;  // 32-bit channel slots per stage: the k of one tf32 mma, 8 channel pairs of a bf16 one

// input channels per stage
template <bool BF>
__host__ __device__ constexpr int stage_channels() {
  return BF ? 2 * KC : KC;
}

// A tile: 4 planes x 2*WY rows x 8*WX columns x BN = 8*WN*WNW output
// channels, for WY x WX x WNW warps of 4 planes x 2 rows x 8 columns x 8*WN.
template <int WY, int WX, int WN, int WNW>
struct Tile {
  static constexpr int WM = WY * WX, THREADS = 32 * WM * WNW;
  static constexpr int BY = 2 * WY, BX = 8 * WX, BN = 8 * WN * WNW;  // output rows, columns, channels
  static constexpr int HP = TZ + 2, HY = BY + 2, HX = BX + 8;        // halo planes, rows, columns (x0 - 4 ..)
  static constexpr int RP = HX, PP = HY * HX;                        // row and plane pitch
  static constexpr int CP = (HP * PP - 8 + 31) / 32 * 32 + 8;        // channel pitch, 8 mod 32
  // weights by (channel, output, tap): output pitch 28 = 28 mod 32 and
  // channel pitch 1 mod 32 put a B fragment's 4 channels x 8 outputs in 32
  // distinct banks
  static constexpr int TP = 28, KP = BN * TP + 1;
  static constexpr int XS = KC * CP, WS = KC * KP;  // halo and weight floats of a stage
  static constexpr int STAGE = XS + WS;
};

// Shared memory of an instantiation: the float32 form's ring of two stages,
// the bf16 form's one stage.
template <class T, bool BF>
constexpr int smem_bytes() {
  return (BF ? 1 : 2) * T::STAGE * 4;
}

struct Conv {  // a launch's arguments; in, k and out are float, or bf16 for the bf16 form
  const void* in;
  Strides is;
  const void* k;
  int32_t kdz, kdy, kdx, ki, ko;  // DHWIO strides: the weights hold < 2^31 elements
  const float* bias;
  void* out;
  Strides os;
  int Cin, Cout, D, H, W;
  int tiles_x, tiles_y, tiles_z, n_tiles, tiles, chunks;
  bool vec;         // vector halo rows: unit W stride, W % 4 == 0, aligned to 16 (float32) or 8 (bf16) bytes
  bool taps_inner;  // the weights' taps lie closer in memory than their outputs (an nn.Conv3d weight)
};

struct Origin {  // a tile: batch element, first output plane, row, column, channel
  int b, z0, y0, x0, o0;
};

template <class T>
__device__ __forceinline__ Origin origin_of(const Conv& p, int tile) {
  Origin o;
  o.o0 = tile % p.n_tiles * T::BN;
  tile /= p.n_tiles;
  o.x0 = tile % p.tiles_x * T::BX;
  tile /= p.tiles_x;
  o.y0 = tile % p.tiles_y * T::BY;
  tile /= p.tiles_y;
  o.z0 = tile % p.tiles_z * TZ;
  o.b = tile / p.tiles_z;
  return o;
}

// cvt.rna.tf32.f32's rounding (10 mantissa bits, ties away from zero) in
// integer ops, the same bits for finite x. The add alone would carry a NaN's
// mantissa into its sign and make it a zero, so words with an all-ones
// exponent pass unchanged: inf stays inf, and a NaN stays NaN for the
// tensor cores, which read its top 10 mantissa bits (a NaN made by the
// card or by the host's arithmetic has the top one set).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  return fabsf(x) < __int_as_float(0x7f800000) ? (u + 0x1000u) & 0xffffe000u : u;  // |x| < inf: not inf, not NaN
}

// The add alone, for x - hi of a finite x, which is finite.
__device__ __forceinline__ uint32_t tf32_rna_finite(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// hi and lo of x. For a non-finite x, lo is garbage but every product with hi
// is non-finite, so the sums stay non-finite wherever the plain version's are.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna_finite(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A register: the channel pair (2k, 2k + 1) of a row, the lower channel in the
// lower half; B likewise by output.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(ok ? 4 : 0));
}

// Start the copies of input channels c0 .. c0 + 7 of tile o's halo and of
// their weights into one stage (xs, ws).
template <class T>
__device__ __forceinline__ void stage(float* xs, float* ws, const Conv& p, const Origin& o, int c0) {
  const int tid = threadIdx.x;
  const float* in = static_cast<const float*>(p.in) + o.b * p.is.b;
  if (p.vec) {
    constexpr int XV = T::HX / 4, N = KC * T::HP * T::HY * XV;
    for (int e = tid; e < N; e += T::THREADS) {
      const int v = e % XV, yy = e / XV % T::HY, pl = e / (XV * T::HY) % T::HP, c = e / (XV * T::HY * T::HP);
      const int gz = o.z0 - 1 + pl, gy = o.y0 - 1 + yy, gx = o.x0 - 4 + 4 * v, gc = c0 + c;
      const bool ok = gc < p.Cin && gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      cp_async16(xs + c * T::CP + pl * T::PP + yy * T::RP + 4 * v,
                 ok ? in + gc * p.is.c + gz * p.is.d + gy * p.is.h + gx : in, ok);
    }
  } else {
    constexpr int N = KC * T::HP * T::HY * T::HX;
    for (int e = tid; e < N; e += T::THREADS) {
      const int xx = e % T::HX, yy = e / T::HX % T::HY, pl = e / (T::HX * T::HY) % T::HP,
                c = e / (T::HX * T::HY * T::HP);
      const int gz = o.z0 - 1 + pl, gy = o.y0 - 1 + yy, gx = o.x0 - 4 + xx, gc = c0 + c;
      const bool ok = gc < p.Cin && gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      cp_async4(xs + c * T::CP + pl * T::PP + yy * T::RP + xx,
                ok ? in + gc * p.is.c + gz * p.is.d + gy * p.is.h + gx * p.is.w : in, ok);
    }
  }
  // weights, in the order of their memory: consecutive threads read
  // neighbouring taps of an nn.Conv3d weight, or neighbouring outputs of a
  // DHWIO one
  for (int e = tid; e < 27 * KC * T::BN; e += T::THREADS) {
    int tap, kk, n;
    if (p.taps_inner) {
      tap = e % 27, kk = e / 27 % KC, n = e / (27 * KC);
    } else {
      n = e % T::BN, kk = e / T::BN % KC, tap = e / (T::BN * KC);
    }
    const bool ok = c0 + kk < p.Cin && o.o0 + n < p.Cout;
    const float* src = static_cast<const float*>(p.k);
    if (ok) src += (tap / 9) * p.kdz + (tap / 3 % 3) * p.kdy + (tap % 3) * p.kdx + (c0 + kk) * p.ki + (o.o0 + n) * p.ko;
    cp_async4(ws + kk * T::KP + n * T::TP + tap, src, ok);
  }
}

// The bf16 form of stage: input channels c0 .. c0 + 15 as 8 channel pairs, a
// pair per 32-bit word in the float32 form's places, with 2-byte loads
// (zero outside the volume, for channels >= Cin and outputs >= Cout).
template <class T>
__device__ __forceinline__ void stage_bf16(uint32_t* xs, uint32_t* ws, const Conv& p, const Origin& o, int c0) {
  const int tid = threadIdx.x;
  const unsigned short* in = static_cast<const unsigned short*>(p.in) + o.b * p.is.b;
  if (p.vec) {  // 4 columns of each channel of a pair: two 8-byte loads, one 16-byte store
    constexpr int XV = T::HX / 4, N = KC * T::HP * T::HY * XV;
    for (int e = tid; e < N; e += T::THREADS) {
      const int v = e % XV, yy = e / XV % T::HY, pl = e / (XV * T::HY) % T::HP, c = e / (XV * T::HY * T::HP);
      const int gz = o.z0 - 1 + pl, gy = o.y0 - 1 + yy, gx = o.x0 - 4 + 4 * v, gc = c0 + 2 * c;
      uint2 lo = make_uint2(0, 0), hi = make_uint2(0, 0);
      if (gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {  // the 4 columns, or none
        const unsigned short* src = in + gz * p.is.d + gy * p.is.h + gx;
        if (gc < p.Cin) lo = __ldg(reinterpret_cast<const uint2*>(src + gc * p.is.c));
        if (gc + 1 < p.Cin) hi = __ldg(reinterpret_cast<const uint2*>(src + (gc + 1) * p.is.c));
      }
      // word j: column gx + j of channel gc in its lower half, of gc + 1 in its upper half
      *reinterpret_cast<uint4*>(xs + c * T::CP + pl * T::PP + yy * T::RP + 4 * v) =
          make_uint4(__byte_perm(lo.x, hi.x, 0x5410), __byte_perm(lo.x, hi.x, 0x7632),
                     __byte_perm(lo.y, hi.y, 0x5410), __byte_perm(lo.y, hi.y, 0x7632));
    }
  } else {
    constexpr int N = KC * T::HP * T::HY * T::HX;
    for (int e = tid; e < N; e += T::THREADS) {
      const int xx = e % T::HX, yy = e / T::HX % T::HY, pl = e / (T::HX * T::HY) % T::HP,
                c = e / (T::HX * T::HY * T::HP);
      const int gz = o.z0 - 1 + pl, gy = o.y0 - 1 + yy, gx = o.x0 - 4 + xx, gc = c0 + 2 * c;
      uint32_t lo = 0, hi = 0;
      if (gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        const unsigned short* src = in + gz * p.is.d + gy * p.is.h + gx * p.is.w;
        if (gc < p.Cin) lo = __ldg(src + gc * p.is.c);
        if (gc + 1 < p.Cin) hi = __ldg(src + (gc + 1) * p.is.c);
      }
      xs[c * T::CP + pl * T::PP + yy * T::RP + xx] = lo | hi << 16;
    }
  }
  const unsigned short* k = static_cast<const unsigned short*>(p.k);
  for (int e = tid; e < 27 * KC * T::BN; e += T::THREADS) {
    int tap, kk, n;
    if (p.taps_inner) {
      tap = e % 27, kk = e / 27 % KC, n = e / (27 * KC);
    } else {
      n = e % T::BN, kk = e / T::BN % KC, tap = e / (T::BN * KC);
    }
    const int gc = c0 + 2 * kk;
    uint32_t lo = 0, hi = 0;
    if (o.o0 + n < p.Cout) {
      const unsigned short* src = k + (tap / 9) * p.kdz + (tap / 3 % 3) * p.kdy + (tap % 3) * p.kdx + (o.o0 + n) * p.ko;
      if (gc < p.Cin) lo = __ldg(src + gc * p.ki);
      if (gc + 1 < p.Cin) hi = __ldg(src + (gc + 1) * p.ki);
    }
    ws[kk * T::KP + n * T::TP + tap] = lo | hi << 16;
  }
}

// acc += one stage's products for the warp's 4 planes x 2 rows x 8 columns
// (rows yl, yl + 1 and columns xl .. xl + 7 of the tile) and WN n8 fragments
// (outputs nl .. nl + 8*WN - 1 of the tile).
template <class T, int WN>
__device__ __forceinline__ void multiply(const float* xs, const float* ws, float (&acc)[TZ][WN][4], int yl, int xl,
                                         int nl, int g, int t) {
  // this thread's A element (row g, k t) at tap (0, 0, 0): channel t, halo
  // plane 0, row yl, column xl + g - 1 + 4
  const float* xa = xs + t * T::CP + yl * T::RP + xl + g + 3;
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
    float part[TZ][WN][4];  // this dy's 9 taps, added to acc with round-to-nearest
#pragma unroll
    for (int j = 0; j < TZ; ++j)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) part[j][n][h] = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t bhi[3][WN][2], blo[3][WN][2];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        // this thread's B element (k t, column g) at the tap
        const float* wb = ws + t * T::KP + (nl + g) * T::TP + dz * 9 + dy * 3 + dx;
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          split(wb[8 * n * T::TP], bhi[dz][n][0], blo[dz][n][0]);               // k t
          split(wb[4 * T::KP + 8 * n * T::TP], bhi[dz][n][1], blo[dz][n][1]);  // k t + 4
        }
      }
#pragma unroll
      for (int pl = 0; pl < TZ + 2; ++pl) {  // halo plane pl feeds output plane pl - dz
        const float* q = xa + pl * T::PP + dy * T::RP + dx;
        uint32_t ahi[4], alo[4];
        split(q[0], ahi[0], alo[0]);                  // row g (the warp's first row), k t
        split(q[T::RP], ahi[1], alo[1]);              // row g + 8 (its second row), k t
        split(q[4 * T::CP], ahi[2], alo[2]);          // row g, k t + 4
        split(q[4 * T::CP + T::RP], ahi[3], alo[3]);  // row g + 8, k t + 4
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int j = pl - dz;
          if (j < 0 || j >= TZ) continue;
#pragma unroll
          for (int n = 0; n < WN; ++n) {
            mma_tf32(part[j][n], alo, bhi[dz][n]);
            mma_tf32(part[j][n], ahi, blo[dz][n]);
            mma_tf32(part[j][n], ahi, bhi[dz][n]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TZ; ++j)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[j][n][h] += part[j][n][h];
  }
}

// The bf16 form of multiply: one bf16 mma per (plane, dz, n8 fragment) and
// tap, on the words stage_bf16 wrote. A register: pair t (k 2t, 2t + 1) or
// t + 4 of row g or g + 8; B: pair t or t + 4 of output g.
template <class T, int WN>
__device__ __forceinline__ void multiply_bf16(const uint32_t* xs, const uint32_t* ws, float (&acc)[TZ][WN][4],
                                              int yl, int xl, int nl, int g, int t) {
  const uint32_t* xa = xs + t * T::CP + yl * T::RP + xl + g + 3;
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
    float part[TZ][WN][4];
#pragma unroll
    for (int j = 0; j < TZ; ++j)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) part[j][n][h] = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint32_t b[3][WN][2];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const uint32_t* wb = ws + t * T::KP + (nl + g) * T::TP + dz * 9 + dy * 3 + dx;
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          b[dz][n][0] = wb[8 * n * T::TP];
          b[dz][n][1] = wb[4 * T::KP + 8 * n * T::TP];
        }
      }
#pragma unroll
      for (int pl = 0; pl < TZ + 2; ++pl) {
        const uint32_t* q = xa + pl * T::PP + dy * T::RP + dx;
        const uint32_t a[4] = {q[0], q[T::RP], q[4 * T::CP], q[4 * T::CP + T::RP]};
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int j = pl - dz;
          if (j < 0 || j >= TZ) continue;
#pragma unroll
          for (int n = 0; n < WN; ++n) mma_bf16(part[j][n], a, b[dz][n]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TZ; ++j)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[j][n][h] += part[j][n][h];
  }
}

// Write tile o's sums (+ bias) and clear them. Accumulator h of a fragment:
// row g (h < 2) or g + 8, column 2t + (h & 1).
template <class T, int WN, bool BF>
__device__ __forceinline__ void store(const Conv& p, const Origin& o, float (&acc)[TZ][WN][4], int yl, int xl,
                                      int nl, int g, int t) {
#pragma unroll
  for (int j = 0; j < TZ; ++j) {
    const int z = o.z0 + j;
#pragma unroll
    for (int n = 0; n < WN; ++n) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int y = o.y0 + yl + (h >> 1), x = o.x0 + xl + g, oc = o.o0 + nl + 8 * n + 2 * t + (h & 1);
        if (z < p.D && y < p.H && x < p.W && oc < p.Cout) {
          const int64_t at = o.b * p.os.b + oc * p.os.c + z * p.os.d + y * p.os.h + x * p.os.w;
          const float v = acc[j][n][h] + (p.bias != nullptr ? p.bias[oc] : 0.0f);
          if constexpr (BF)
            static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(v);  // the one rounding
          else
            static_cast<float*>(p.out)[at] = v;
        }
        acc[j][n][h] = 0.0f;
      }
    }
  }
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ... and walks
// their (tile, chunk) steps, in the float32 form through the ring of two
// stages, so the copies of the next step, in the same tile or the next one,
// overlap this step's products; in the bf16 form through one stage.
template <int WY, int WX, int WN, int WNW, bool BF>
__global__ void __launch_bounds__(32 * WY * WX * WNW) conv3d_k3_kernel_mma(const __grid_constant__ Conv p) {
  using T = Tile<WY, WX, WN, WNW>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp % T::WM;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread-in-group
  // the warp's rows, columns and output channels in a tile
  const int yl = 2 * (wm / WX), xl = 8 * (wm % WX), nl = 8 * WN * (warp / T::WM);
  float acc[TZ][WN][4];
#pragma unroll
  for (int j = 0; j < TZ; ++j)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[j][n][h] = 0.0f;

  if constexpr (BF) {  // one stage: copy a (tile, chunk) step, then its products
    uint32_t* const xs = reinterpret_cast<uint32_t*>(smem);
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Origin o = origin_of<T>(p, tile);
      for (int c = 0; c < p.chunks; ++c) {
        __syncthreads();  // the previous step's products are done with the stage
        stage_bf16<T>(xs, xs + T::XS, p, o, c * stage_channels<true>());
        __syncthreads();
        multiply_bf16<T, WN>(xs, xs + T::XS, acc, yl, xl, nl, g, t);
      }
      store<T, WN, true>(p, o, acc, yl, xl, nl, g, t);
    }
  } else {
    int tile = blockIdx.x, c = 0;
    Origin o = origin_of<T>(p, tile);
    stage<T>(smem, smem + T::XS, p, o, 0);
    asm volatile("cp.async.commit_group;");
    for (int s = 0;; ++s) {
      const bool last = c + 1 == p.chunks;  // the tile's last chunk
      const int next = last ? tile + (int)gridDim.x : tile;
      const bool more = next < p.tiles;
      const Origin no = last && more ? origin_of<T>(p, next) : o;
      if (more) {
        float* nxt = smem + ((s + 1) & 1) * T::STAGE;
        stage<T>(nxt, nxt + T::XS, p, no, last ? 0 : (c + 1) * KC);
      }
      asm volatile("cp.async.commit_group;");  // possibly empty: this step's group is then the only one in flight
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();
      const float* xs = smem + (s & 1) * T::STAGE;
      multiply<T, WN>(xs, xs + T::XS, acc, yl, xl, nl, g, t);
      __syncthreads();  // the stage is consumed before step s + 2 is copied into it
      if (last) store<T, WN, false>(p, o, acc, yl, xl, nl, g, t);
      if (!more) break;
      tile = next;
      c = last ? 0 : c + 1;
      o = no;
    }
  }
}

// The blocks of an instantiation that fit on the current device at once
// (cached per instantiation), after allowing it its shared memory.
template <int WY, int WX, int WN, int WNW, bool BF>
int resident_blocks(int* blocks) {
  using T = Tile<WY, WX, WN, WNW>;
  const auto kernel = conv3d_k3_kernel_mma<WY, WX, WN, WNW, BF>;
  static int cached_device = -1, cached_blocks = 0;
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    constexpr int smem = smem_bytes<T, BF>();
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_blocks = sms * per_sm;
    cached_device = device;
  }
  *blocks = cached_blocks;
  return 0;
}

template <class T>
int64_t tile_count(const Conv& p, int B) {
  return (int64_t)B * ((p.D + TZ - 1) / TZ) * ((p.H + T::BY - 1) / T::BY) * ((p.W + T::BX - 1) / T::BX) *
         ((p.Cout + T::BN - 1) / T::BN);
}

template <int WY, int WX, int WN, int WNW, bool BF>
int launch_tc(Conv p, int B, void* stream) {
  using T = Tile<WY, WX, WN, WNW>;
  int blocks;
  if (const int e = resident_blocks<WY, WX, WN, WNW, BF>(&blocks)) return e;
  p.tiles_x = (p.W + T::BX - 1) / T::BX;
  p.tiles_y = (p.H + T::BY - 1) / T::BY;
  p.tiles_z = (p.D + TZ - 1) / TZ;
  p.n_tiles = (p.Cout + T::BN - 1) / T::BN;
  p.chunks = (p.Cin + stage_channels<BF>() - 1) / stage_channels<BF>();
  const int64_t tiles = tile_count<T>(p, B);
  if (tiles >= (1LL << 31) - blocks) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.vec = p.is.w == 1 && p.W % 4 == 0 && p.is.h % 4 == 0 && p.is.d % 4 == 0 && p.is.c % 4 == 0 &&
          p.is.b % 4 == 0 && (reinterpret_cast<uintptr_t>(p.in) & (BF ? 7 : 15)) == 0;
  p.taps_inner = p.kdx <= p.ko;
  const int grid = tiles < blocks ? (int)tiles : blocks;
  conv3d_k3_kernel_mma<WY, WX, WN, WNW, BF><<<grid, T::THREADS, smem_bytes<T, BF>(), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Cout <= 4: direct conv on the CUDA cores.

constexpr int TW = 32;  // output columns per block (the lanes of a warp)
constexpr int TH = 8;   // output rows per block (one warp each)
constexpr int TD = 4;   // output planes per thread
constexpr int CI = 4;   // input channels per shared-memory stage
constexpr int XW = TW + 2, XH = TH + 2, XD = TD + 2;

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

// The tensor-core route: the tile by Cout and volume, then the launch.
template <bool BF>
int launch_mma(const void* x, Strides is, const void* w, KStrides ks, const float* bs, void* y, Strides os, int B,
               int Cin, int Cout, int D, int H, int W, void* stream) {
  const int64_t k_span = 2 * (ks.dz + ks.dy + ks.dx) + (int64_t)(Cin - 1) * ks.i + (int64_t)(Cout - 1) * ks.o;
  if (ks.dz < 0 || ks.dy < 0 || ks.dx < 0 || ks.i < 0 || ks.o < 0 || k_span >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Conv p{x, is, w, (int32_t)ks.dz, (int32_t)ks.dy, (int32_t)ks.dx, (int32_t)ks.i, (int32_t)ks.o, bs, y, os,
               Cin, Cout, D, H, W};
  if (Cout <= 8) return launch_tc<4, 2, 1, 1, BF>(p, B, stream);
  if (Cout > 16) {  // a small volume: 4 x 4 x 8 boxes with two warps along N, if 4 x 8 x 16 boxes leave blocks idle
    int blocks;
    if (const int e = resident_blocks<4, 2, 2, 1, BF>(&blocks)) return e;
    if (tile_count<Tile<4, 2, 2, 1>>(p, B) < 2 * (int64_t)blocks) return launch_tc<2, 1, 2, 2, BF>(p, B, stream);
  }
  return launch_tc<4, 2, 2, 1, BF>(p, B, stream);
}

}  // namespace

// The route conv3d_banded takes for Cout output channels: 0 for the CUDA
// cores (the score heads), 1 for the tensor cores.
extern "C" int conv3d_banded_route(int32_t Cout) { return Cout > 4 ? 1 : 0; }

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
  if (conv3d_banded_route(Cout) == 0)
    return Cout == 1 ? launch<1>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream)
                     : launch<4>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
  return launch_mma<false>(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
}

// conv3d_banded on bf16 x, weights and out, float32 bias (may be null), for
// Cout > 4 only (the score heads stay float32): the tensor cores' bf16 form.
extern "C" int conv3d_banded_bf16(const void* in, const int64_t* in_strides, const void* k,
                                  const int64_t* k_strides, const void* bias, void* out, const int64_t* out_strides,
                                  int32_t B, int32_t Cin, int32_t Cout, int32_t D, int32_t H, int32_t W,
                                  void* stream) {
  if (conv3d_banded_route(Cout) == 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Cin * Cout * D * H * W == 0) return 0;
  const Strides is{in_strides[0], in_strides[1], in_strides[2], in_strides[3], in_strides[4]};
  const Strides os{out_strides[0], out_strides[1], out_strides[2], out_strides[3], out_strides[4]};
  const KStrides ks{k_strides[0], k_strides[1], k_strides[2], k_strides[3], k_strides[4]};
  return launch_mma<true>(in, is, k, ks, static_cast<const float*>(bias), out, os, B, Cin, Cout, D, H, W, stream);
}
