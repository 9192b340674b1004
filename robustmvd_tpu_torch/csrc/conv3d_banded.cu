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
// casts the band matrix to x.dtype, sums in float32 and writes x.dtype. Its
// own implicit GEMM on bf16 mma.sync (m16n8k16), conv3d_k3_bf16_kernel:
//   - Bound: bytes at vis's 8- and 16-channel volumes and mvsnet's conv2
//     (bf16 in and out, 54 Cin Cout / 2 (Cin + Cout) flop/byte, below the
//     card's ~295), operations at the dense bf16 rate from 32 channels. In
//     practice: the rate at which mma.sync issues (below the dense peak,
//     which wgmma alone reaches), the shared-memory reads of the operands and
//     the per-step synchronisation around a tile's copies.
//   - Shared memory holds the halo channels-last: a voxel's 8 channels of a
//     chunk are one 16-byte row, so ldmatrix hands each lane the channel pair
//     of m16n8k16's A register at any tap (a dx shift moves by 16 bytes).
//   - NCDHW input (unit W stride, the other strides on 16 bytes; the
//     U-Nets' layout): one TMA copy per step (cp.async.bulk.tensor on a map
//     with dims (W, C, H, D, B)) brings the halo from x0 - 8 (the copy's
//     innermost start must lie on 16 bytes) as (plane, row) slabs of 8
//     channel rows, zero-filled outside the volume and beyond Cin; each 8 x 8
//     block of (channel, column) is then transposed in place by one
//     ldmatrix.trans and one stmatrix: no per-element permutes. Any other
//     layout (NDHWC, a W stride off 16 bytes) is staged with 2-byte loads,
//     channels-last at once.
//   - A chunk is 8 channels, and one k16 carries two taps of them: the 27
//     taps, ordered (dy, dx, dz), pair into 14 k16 (the last with a zero
//     half), so 8 input channels fill K and no zero channels are staged.
//     Each (dy, dx) reads the halo planes once with ldmatrix.x4 (two planes
//     x two rows of 8 columns); halo plane P feeds output plane P - dz.
//   - The weights come by TMA from the wrapper's (dz, dy, dx, o, i) copy,
//     a box of (8 channels, the block's outputs, 27 taps) per chunk: all
//     chunks once per block where they fit and a block takes more than one
//     tile (the grid is a multiple of the output tiles, so its tiles share
//     them), else each step's own chunks beside its halo (mvsnet's conv6:
//     one tile per block).
//   - Persistent blocks walk their (tile, chunks) steps through a ring of
//     two stages with an mbarrier each: the next step's copies are in flight
//     during this step's transposition and products.
//   - For Cout > 16 a stage holds two chunks and K is split inside the
//     block: each of two warp groups transposes and multiplies its own chunk,
//     syncing only itself; at the tile's end each hands the other half its
//     sums through the stage and writes the half it was handed.
//   - Sums: each chunk's 14 mmas go into a float32 partial, added to its
//     group's float32 sum with round-to-nearest adds (the tensor cores' adds
//     are not); the groups' sums added; the float32 bias added; one rounding
//     to bf16.
//   - NCDHW output through shared memory: stmatrix.trans turns fragments
//     into rows of one output channel, and the WX warps of a row pair write
//     rows of BX columns with 16-byte stores; other layouts with 2-byte
//     stores.
//   - Tiles: 8 planes x 4 rows x 32 columns by 8 channels for Cout <= 8
//     (vis), 4 x 4 x 32 by 16 for Cout <= 16, 8 x 4 x 8 by 32 with the
//     split K for wider Cout (mvsnet's conv4 and conv6: 480 and 120 tiles).
// The score heads stay float32 (the JAX family's heads are float32), so
// there is no bf16 CUDA-core route.

#include <cuda.h>
#include <cudaTypedefs.h>
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
// float32, Cout > 4: implicit GEMM on the tensor cores, 3xTF32.

constexpr int TZ = 4;  // output planes of a tile, one m16 fragment each per warp
constexpr int KC = 8;  // input channels per stage: the k of one tf32 mma

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

// Shared memory of an instantiation: the ring of two stages.
template <class T>
constexpr int smem_bytes() {
  return 2 * T::STAGE * 4;
}

struct Conv {  // a launch's arguments; in, k and out are float
  const void* in;
  Strides is;
  const void* k;
  int32_t kdz, kdy, kdx, ki, ko;  // DHWIO strides: the weights hold < 2^31 elements
  const float* bias;
  void* out;
  Strides os;
  int Cin, Cout, D, H, W;
  int tiles_x, tiles_y, tiles_z, n_tiles, tiles, chunks;
  bool vec;         // vector halo rows: unit W stride, W % 4 == 0, aligned to 16 bytes
  bool taps_inner;  // the weights' taps lie closer in memory than their outputs (an nn.Conv3d weight)
};

struct Origin {  // a tile: batch element, first output plane, row, column, channel
  int b, z0, y0, x0, o0;
};

// Tile number tile of a launch p (either form's Conv), for tiles of PLANES
// planes and T's rows, columns and channels; channels vary fastest.
template <int PLANES, class T, class P>
__device__ __forceinline__ Origin origin_of(const P& p, int tile) {
  Origin o;
  o.o0 = tile % p.n_tiles * T::BN;
  tile /= p.n_tiles;
  o.x0 = tile % p.tiles_x * T::BX;
  tile /= p.tiles_x;
  o.y0 = tile % p.tiles_y * T::BY;
  tile /= p.tiles_y;
  o.z0 = tile % p.tiles_z * PLANES;
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

// Write tile o's sums (+ bias) and clear them. Accumulator h of a fragment:
// row g (h < 2) or g + 8, column 2t + (h & 1).
template <class T, int WN>
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
          static_cast<float*>(p.out)[at] = acc[j][n][h] + (p.bias != nullptr ? p.bias[oc] : 0.0f);
        }
        acc[j][n][h] = 0.0f;
      }
    }
  }
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ... and walks
// their (tile, chunk) steps through the ring of two stages, so the copies of
// the next step, in the same tile or the next one, overlap this step's
// products.
template <int WY, int WX, int WN, int WNW>
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

  {
    int tile = blockIdx.x, c = 0;
    Origin o = origin_of<TZ, T>(p, tile);
    stage<T>(smem, smem + T::XS, p, o, 0);
    asm volatile("cp.async.commit_group;");
    for (int s = 0;; ++s) {
      const bool last = c + 1 == p.chunks;  // the tile's last chunk
      const int next = last ? tile + (int)gridDim.x : tile;
      const bool more = next < p.tiles;
      const Origin no = last && more ? origin_of<TZ, T>(p, next) : o;
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
      if (last) store<T, WN>(p, o, acc, yl, xl, nl, g, t);
      if (!more) break;
      tile = next;
      c = last ? 0 : c + 1;
      o = no;
    }
  }
}

// The SMs and the opt-in shared memory per block of a device.
cudaError_t device_limits(int device, int* sms, int* smem_max) {
  const cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The blocks of an instantiation that fit on the current device at once
// (cached per instantiation), after allowing it its shared memory.
template <int WY, int WX, int WN, int WNW>
int resident_blocks(int* blocks) {
  using T = Tile<WY, WX, WN, WNW>;
  const auto kernel = conv3d_k3_kernel_mma<WY, WX, WN, WNW>;
  static int cached_device = -1, cached_blocks = 0;
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device != cached_device) {
    int sms = 0, smem_max = 0, per_sm = 0;
    constexpr int smem = smem_bytes<T>();
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
        (e = device_limits(device, &sms, &smem_max)) != cudaSuccess ||
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

template <int WY, int WX, int WN, int WNW>
int launch_tc(Conv p, int B, void* stream) {
  using T = Tile<WY, WX, WN, WNW>;
  int blocks;
  if (const int e = resident_blocks<WY, WX, WN, WNW>(&blocks)) return e;
  p.tiles_x = (p.W + T::BX - 1) / T::BX;
  p.tiles_y = (p.H + T::BY - 1) / T::BY;
  p.tiles_z = (p.D + TZ - 1) / TZ;
  p.n_tiles = (p.Cout + T::BN - 1) / T::BN;
  p.chunks = (p.Cin + KC - 1) / KC;
  const int64_t tiles = tile_count<T>(p, B);
  if (tiles >= (1LL << 31) - blocks) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.vec = p.is.w == 1 && p.W % 4 == 0 && p.is.h % 4 == 0 && p.is.d % 4 == 0 && p.is.c % 4 == 0 &&
          p.is.b % 4 == 0 && (reinterpret_cast<uintptr_t>(p.in) & 15) == 0;
  p.taps_inner = p.kdx <= p.ko;
  const int grid = tiles < blocks ? (int)tiles : blocks;
  conv3d_k3_kernel_mma<WY, WX, WN, WNW><<<grid, T::THREADS, smem_bytes<T>(), (cudaStream_t)stream>>>(p);
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
int launch_mma(const float* x, Strides is, const float* w, KStrides ks, const float* bs, float* y, Strides os, int B,
               int Cin, int Cout, int D, int H, int W, void* stream) {
  const int64_t k_span = 2 * (ks.dz + ks.dy + ks.dx) + (int64_t)(Cin - 1) * ks.i + (int64_t)(Cout - 1) * ks.o;
  if (ks.dz < 0 || ks.dy < 0 || ks.dx < 0 || ks.i < 0 || ks.o < 0 || k_span >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Conv p{x, is, w, (int32_t)ks.dz, (int32_t)ks.dy, (int32_t)ks.dx, (int32_t)ks.i, (int32_t)ks.o, bs, y, os,
               Cin, Cout, D, H, W};
  if (Cout <= 8) return launch_tc<4, 2, 1, 1>(p, B, stream);
  if (Cout > 16) {  // a small volume: 4 x 4 x 8 boxes with two warps along N, if 4 x 8 x 16 boxes leave blocks idle
    int blocks;
    if (const int e = resident_blocks<4, 2, 2, 1>(&blocks)) return e;
    if (tile_count<Tile<4, 2, 2, 1>>(p, B) < 2 * (int64_t)blocks) return launch_tc<2, 1, 2, 2>(p, B, stream);
  }
  return launch_tc<4, 2, 2, 1>(p, B, stream);
}

// ---------------------------------------------------------------------------
// bf16, Cout > 4: implicit GEMM on bf16 mma.sync (the note at the top).

namespace bf {

// A tile: TZ planes x 2*WY rows x 8*WX columns x BN = 8*WN*WNW output
// channels, for WY x WX x WNW warps of TZ planes x 2 rows x 8 columns x 8*WN
// channels: TZ m16 fragments (one per plane; a fragment's rows g and g + 8
// are column g of the warp's two rows) by WN n8 fragments. A stage holds KS
// chunks of 8 channels, chunk h multiplied by the h-th of KS groups of such
// warps (a split of K inside the block, summed at the tile's end).
template <int TZ_, int WY_, int WX_, int WN_, int WNW_, int KS_ = 1>
struct Tile {
  static constexpr int TZ = TZ_, WY = WY_, WX = WX_, WN = WN_, WNW = WNW_, KS = KS_;
  static constexpr int WM = WY * WX, WK = WM * WNW, WARPS = WK * KS, THREADS = 32 * WARPS;  // WK: warps of a K group
  static constexpr int BY = 2 * WY, BX = 8 * WX, BN = 8 * WN * WNW;  // output rows, columns, channels
  // the halo's planes, rows and columns, from x0 - 8 (the TMA copy starts on
  // 16 bytes), of which x0 - 1 .. x0 + BX are used; a voxel's 8 channels are
  // one 16-byte row
  static constexpr int HP = TZ + 2, HY = BY + 2, HX = BX + 16;
  static constexpr int RP = KS * HX, PP = HY * RP;      // voxel pitch of a row and a plane: chunk h at h * HX
  static constexpr int STAGE = HP * HY * RP * 16;        // bytes of a ring stage's halo
  static constexpr int STAGE_BAR = STAGE + 128;          // and of its barrier, keeping stages on 128 bytes
  static constexpr int WCHUNK = 27 * BN * 16;      // bytes of an 8-channel chunk's weights
  // A group (the WX warps of one row pair, N range and K group) writes its
  // NCDHW outputs through shared memory, 4 planes at a time: rows of BX
  // columns, one per (plane, row, channel), ORP 16-byte chunks apart (odd:
  // stmatrix.trans's 8 rows in distinct banks).
  static constexpr int GROUPS = WY * WNW * KS, ORP = WX % 2 ? WX + 2 : WX + 1;
  static constexpr int OUT = 4 * 2 * 8 * WN * ORP * 16;  // bytes of a group's output rows
  static constexpr int MIN_BLOCKS = THREADS >= 256 && KS == 1 ? 2 : 1;  // resident blocks per SM the registers allow
  // the thread that starts the TMA copies: in the last warp, whose share of the transposition is the smallest
  static constexpr int ISSUER = THREADS - 32;
  static_assert(TZ % 4 == 0 && STAGE % 128 == 0, "4 planes per output pass; stages on 128 bytes for the TMA");
  static_assert(KS == 1 || (KS == 2 && TZ % 8 == 0 && WK * 32 * TZ * WN * 16 <= STAGE),
                "two K groups, each writing 4 planes or more, exchange half their sums through a stage");
};

struct Conv {  // a launch's arguments
  CUtensorMap map;   // the NCDHW input's TMA map: dims (W, C, H, D, B), box (HX, 8 KS, HY, HP, 1)
  CUtensorMap wmap;  // the weights' TMA map: dims (i, o, dx, dy, dz), box (8, BN, 3, 3, 3)
  const __nv_bfloat16* in;
  Strides is;
  const __nv_bfloat16* k;  // by (dz, dy, dx, o, i), unit i stride: a tap's 8 channels of an output are 16 bytes
  int64_t kdz, kdy, kdx, ko;
  const float* bias;
  __nv_bfloat16* out;
  Strides os;
  int Cin, Cout, D, H, W;
  int tiles_x, tiles_y, tiles_z, n_tiles, tiles, chunks;
  bool stream;   // each step copies its chunks' weights (else the first copies them all, once per block)
  bool tma;      // the halo comes by TMA (an NCDHW volume, the map in map), else with 2-byte loads
  bool rows_out;  // the output is written in rows of 8 columns (NCDHW), else by element
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n .reg .pred ready;\n WAIT%=:\n mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
      " @!ready bra WAIT%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A stage's barrier, just past its halo.
template <class T>
__device__ __forceinline__ uint32_t bar_of(uint32_t st) {
  return st + T::STAGE;
}

// Arrive on the barrier at bar, which then waits for bytes more to arrive.
__device__ __forceinline__ void expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Copy the box at (x, c, y, z, b) of a 5D map into shared memory at dst; its
// bytes arrive on the barrier at bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x, int c, int y, int z,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, "
      "%6}], [%7];" ::"r"(dst),
      "l"(map), "r"(x), "r"(c), "r"(y), "r"(z), "r"(b), "r"(bar)
      : "memory");
}

// lo and hi rounded to bf16 (the one rounding), lo in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// Start the copies of input channels c0 .. c0 + 8 KS - 1 of tile o's halo,
// halo columns x0 - 8 .. x0 - 9 + HX, into the stage at st. NCDHW: one TMA
// copy by the issuer, arriving on the stage's barrier, as (plane, row) slabs
// of 8 channel rows, which transpose turns channels-last; the copy writes the
// zeros outside the volume and for channels >= Cin. Other strides: a channel
// pair per 32-bit store from 2-byte loads, channels-last at once.
template <class T>
__device__ __forceinline__ void stage_halo(uint32_t st, const Conv& p, const Origin& o, int c0) {
  if (p.tma) {
    if (threadIdx.x == T::ISSUER) tma_load(st, &p.map, bar_of<T>(st), o.x0 - 8, c0, o.y0 - 1, o.z0 - 1, o.b);
    return;
  }
  constexpr int XN = T::BX + 2, N = 4 * T::KS * T::HP * T::HY * XN;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(p.in + o.b * p.is.b);
  for (int e = threadIdx.x; e < N; e += T::THREADS) {
    const int t = e % 4, xx = e / 4 % XN, yy = e / (4 * XN) % T::HY, pl = e / (4 * XN * T::HY) % T::HP;
    const int h = e / (4 * XN * T::HY * T::HP);
    const int gz = o.z0 - 1 + pl, gy = o.y0 - 1 + yy, gx = o.x0 - 1 + xx, gc = c0 + 8 * h + 2 * t;
    uint32_t lo = 0, hi = 0;
    if (gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const unsigned short* q = src + gz * p.is.d + gy * p.is.h + gx * p.is.w;
      if (gc < p.Cin) lo = __ldg(q + gc * p.is.c);
      if (gc + 1 < p.Cin) hi = __ldg(q + (gc + 1) * p.is.c);
    }
    sts32(st + (pl * T::PP + yy * T::RP + h * T::HX + xx + 7) * 16 + 4 * t, lo | hi << 16);
  }
}

// ldmatrix.trans and stmatrix of 1, 2 or 4 matrices
template <int N>
__device__ __forceinline__ void ldsm_trans(uint32_t* r, uint32_t addr) {
  if constexpr (N == 4)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else if constexpr (N == 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];" : "=r"(r[0]) : "r"(addr) : "memory");
}

template <int N>
__device__ __forceinline__ void stsm(uint32_t addr, const uint32_t* r) {
  if constexpr (N == 4)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(r[0]), "r"(r[1]),
                 "r"(r[2]), "r"(r[3])
                 : "memory");
  else if constexpr (N == 2)
    asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};" ::"r"(addr), "r"(r[0]), "r"(r[1])
                 : "memory");
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x1.shared.b16 [%0], {%1};" ::"r"(addr), "r"(r[0]) : "memory");
}

// Chunk kg of the NCDHW stage turned channels-last in place by K group kg,
// two (plane, row) slabs per warp at a time: the chunk's 8 channel rows x HX
// columns of a slab, in blocks of 8 x 8, are all read by ldmatrix.trans
// (lane 8i + r: channel r of a block), then written as HX columns x 8
// channels (lane 8i + r: a block's column r), in the same bytes.
template <class T>
__device__ __forceinline__ void transpose(uint32_t st, int kg) {
  constexpr int NB = T::HX / 8, N4 = NB / 4 * 4, NR = NB % 4;  // blocks of a chunk: by four, then by two and one
  constexpr int SLABS = T::HP * T::HY;
  static_assert(SLABS % 2 == 0 && 1 + T::GROUPS + T::KS <= 16, "slabs go two at a time; named barriers");
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  for (int slab = 2 * (threadIdx.x / 32 % T::WK); slab < SLABS; slab += 2 * T::WK) {  // two slabs' reads in flight
    uint32_t v[2][NB];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t row = st + ((slab + u) * T::RP + (8 * kg + r) * T::HX / 8) * 16;  // channel 8 kg + r's
#pragma unroll
      for (int k = 0; k < N4; k += 4) ldsm_trans<4>(v[u] + k, row + (k + i) * 16);
      if constexpr (NR & 2) ldsm_trans<2>(v[u] + N4, row + (N4 + i % 2) * 16);
      if constexpr (NR & 1) ldsm_trans<1>(v[u] + NB - 1, row + (NB - 1) * 16);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t col = st + ((slab + u) * T::RP + kg * T::HX + r) * 16;  // chunk kg's column r
#pragma unroll
      for (int k = 0; k < N4; k += 4) stsm<4>(col + (k + i) * 128, v[u] + k);
      if constexpr (NR & 2) stsm<2>(col + (N4 + i % 2) * 128, v[u] + N4);
      if constexpr (NR & 1) stsm<1>(col + (NB - 1) * 128, v[u] + NB - 1);
    }
    __syncwarp();
  }
}

// Start step s's copies into its stage st, for chunks c .. c + KS - 1 of
// tile o: the halo (stage_halo) and, where the weights stream or s is the
// block's first step, the weights of those chunks or of all (a TMA box per
// chunk into wt, by (tap, output, 8 channels), zero for outputs >= Cout).
// The stage's barrier expects the TMA copies' bytes (none for a halo copied
// by the threads and weights that stay).
template <class T>
__device__ __forceinline__ void stage_step(uint32_t st, uint32_t wt, const Conv& p, const Origin& o, int c, int s) {
  if (threadIdx.x == T::ISSUER) {
    const int w0 = p.stream ? c : 0, nw = p.stream ? min(T::KS, p.chunks - c) : s == 0 ? p.chunks : 0;
    expect(bar_of<T>(st), (p.tma ? T::STAGE : 0) + nw * T::WCHUNK);
    for (int k = 0; k < nw; ++k) tma_load(wt + k * T::WCHUNK, &p.wmap, bar_of<T>(st), 8 * (w0 + k), o.o0, 0, 0, 0);
  }
  stage_halo<T>(st, p, o, 8 * c);
}

// acc += one 8-channel chunk's products for the warp's TZ planes x 2 rows x
// 8 columns and WN n8 fragments, summed in a float32 partial first. a: the
// lane's ldmatrix row at tap (0, 0, 0) of halo plane 0 (lanes 8i + r: row r
// of matrix i, the planes P and P + 1 by the rows yl and yl + 1); b: the
// lane's B word (output g, channels 2t, 2t + 1) at tap 0 of the warp's first
// n8 fragment. Slot s = 3 (3 dy + dx) + dz is tap (dz, dy, dx); k16 step s / 2
// takes slots s & ~1 (k 0-7) and s | 1 (k 8-15), the last one a zero half.
template <class T>
__device__ __forceinline__ void multiply(uint32_t a, uint32_t b, float (&acc)[T::TZ][T::WN][4]) {
  constexpr int TZ = T::TZ, WN = T::WN;
  float part[TZ][WN][4];
#pragma unroll
  for (int j = 0; j < TZ; ++j)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) part[j][n][h] = 0.0f;
  uint32_t rows[2][TZ + 2][2];  // each halo plane's two rows at this (dy, dx) and the previous one
#pragma unroll
  for (int q = 0; q < 9; ++q) {  // (dy, dx) = (q / 3, q % 3)
#pragma unroll
    for (int P = 0; P < TZ + 2; P += 2) {
      uint32_t r[4];
      ldsm4(r, a + (P * T::PP + q / 3 * T::RP + q % 3) * 16);
      rows[q & 1][P][0] = r[0], rows[q & 1][P][1] = r[1], rows[q & 1][P + 1][0] = r[2], rows[q & 1][P + 1][1] = r[3];
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int s = 3 * q + dz;
      if (s % 2 == 0 && s != 26) continue;  // the first slot of a step
      const int sa = s & ~1, qa = sa / 3, dza = sa % 3;
      uint32_t w[WN][2];
#pragma unroll
      for (int n = 0; n < WN; ++n) {
        w[n][0] = lds32(b + ((dza * 9 + qa) * T::BN + 8 * n) * 16);
        w[n][1] = s == 26 ? 0u : lds32(b + ((dz * 9 + q) * T::BN + 8 * n) * 16);
      }
#pragma unroll
      for (int j = 0; j < TZ; ++j) {  // halo plane j + dz feeds output plane j
        const uint32_t af[4] = {rows[qa & 1][j + dza][0], rows[qa & 1][j + dza][1], rows[q & 1][j + dz][0],
                                rows[q & 1][j + dz][1]};
#pragma unroll
        for (int n = 0; n < WN; ++n) mma_bf16(part[j][n], af, w[n]);
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

__device__ __forceinline__ void bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Write planes J0 .. J1 - 1 of tile o's sums + bias, rounded once to bf16,
// and clear all.
// Accumulator h of a fragment: row g (h < 2) or g + 8, output 2t + (h & 1).
// NCDHW rows go through the group's rows in shared memory (rows, the group's
// named barrier 1 + group): a fragment's two 8 x 8 matrices (rows yl and
// yl + 1) by stmatrix.trans as 8 rows of 8 columns, one per output channel,
// into the (plane, row, channel) rows of BX columns; each 16 bytes of a row
// are then one store, a group's threads along the row. Other layouts: an
// element per 2-byte store.
template <class T, int J0, int J1>
__device__ __forceinline__ void store(const Conv& p, const Origin& o, float (&acc)[T::TZ][T::WN][4], int yl, int xl,
                                      int nl, uint32_t rows, int group) {
  constexpr int TZ = T::TZ, WN = T::WN, RN = 8 * WN;  // RN: the warp's output channels
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, gt = xl / 8 * 32 + lane;  // gt: thread in group
  float bias[WN][2];
#pragma unroll
  for (int n = 0; n < WN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oc = o.o0 + nl + 8 * n + 2 * t + h;
      bias[n][h] = p.bias != nullptr && oc < p.Cout ? p.bias[oc] : 0.0f;
    }
  if (!p.rows_out) {
#pragma unroll
    for (int j = J0; j < J1; ++j)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int z = o.z0 + j, y = o.y0 + yl + (h >> 1), x = o.x0 + xl + g, oc = o.o0 + nl + 8 * n + 2 * t + (h & 1);
          if (z < p.D && y < p.H && x < p.W && oc < p.Cout)
            p.out[o.b * p.os.b + oc * p.os.c + z * p.os.d + y * p.os.h + x * p.os.w] =
                __float2bfloat16_rn(acc[j][n][h] + bias[n][h & 1]);
        }
  } else {
#pragma unroll
    for (int j0 = J0; j0 < J1; j0 += 4) {
#pragma unroll
      for (int f = 0; f < 4 * WN; f += 2) {  // fragments f = (j - j0) WN + n and f + 1: matrices 2f .. 2f + 3
        uint32_t r[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + (f + u) / WN, n = (f + u) % WN;
          r[2 * u] = pack(acc[j][n][0] + bias[n][0], acc[j][n][1] + bias[n][1]);
          r[2 * u + 1] = pack(acc[j][n][2] + bias[n][0], acc[j][n][3] + bias[n][1]);
        }
        // row (jj, yr, channel 8n + i), columns xl .. xl + 7
        const int m = 2 * f + (lane >> 3), jj = m / 2 / WN, n = m / 2 % WN, yr = m % 2, i = lane & 7;
        stsm4_trans(rows + (((jj * 2 + yr) * RN + 8 * n + i) * T::ORP + xl / 8) * 16, r);
      }
      bar(1 + group, 32 * T::WX);
      constexpr int CHUNKS = 4 * 2 * RN * T::WX;  // 16-byte chunks of the group's rows
#pragma unroll
      for (int e = gt; e < CHUNKS; e += 32 * T::WX) {
        const int k = e % T::WX, row = e / T::WX, c = row % RN, yr = row / RN % 2, jj = row / (2 * RN);
        const int z = o.z0 + j0 + jj, y = o.y0 + yl + yr, x = o.x0 + 8 * k, oc = o.o0 + nl + c;
        const uint4 v = lds128(rows + (row * T::ORP + k) * 16);
        if (z < p.D && y < p.H && x < p.W && oc < p.Cout)
          *reinterpret_cast<uint4*>(p.out + o.b * p.os.b + oc * p.os.c + z * p.os.d + y * p.os.h + x) = v;
      }
      bar(1 + group, 32 * T::WX);
    }
  }
#pragma unroll
  for (int j = 0; j < TZ; ++j)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[j][n][h] = 0.0f;
}

// A K group's planes J .. J + TZ / 2 - 1 of its sums into the other group's
// half of the stage (a lane's float4s 32 apart), and back, added.
template <class T, int J>
__device__ __forceinline__ void hand_over(float (&acc)[T::TZ][T::WN][4], float4* half) {
#pragma unroll
  for (int j = 0; j < T::TZ / 2; ++j)
#pragma unroll
    for (int n = 0; n < T::WN; ++n)
      half[(j * T::WN + n) * 32] = make_float4(acc[J + j][n][0], acc[J + j][n][1], acc[J + j][n][2], acc[J + j][n][3]);
}

template <class T, int J>
__device__ __forceinline__ void take_over(float (&acc)[T::TZ][T::WN][4], const float4* half) {
#pragma unroll
  for (int j = 0; j < T::TZ / 2; ++j)
#pragma unroll
    for (int n = 0; n < T::WN; ++n) {
      const float4 v = half[(j * T::WN + n) * 32];
      acc[J + j][n][0] += v.x, acc[J + j][n][1] += v.y, acc[J + j][n][2] += v.z, acc[J + j][n][3] += v.w;
    }
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ... (all of one
// output range, the grid being a multiple of the output tiles) and walks
// their (tile, chunk) steps through the ring of two stages: the copies of the
// next step are in flight while this step's stage is transposed and
// multiplied. Shared memory: the two stages, each with its barrier at its
// end; the weights of every chunk, or of each stage's KS chunks where they
// stream; each group's output rows.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS) conv3d_k3_bf16_kernel(const __grid_constant__ Conv p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem), wt = base + 2 * T::STAGE_BAR;
  const int lane = threadIdx.x & 31, kg = threadIdx.x / 32 / T::WK, warp = threadIdx.x / 32 % T::WK, wm = warp % T::WM;
  // the warp's rows, columns and output channels in a tile (kg: its K group)
  const int yl = 2 * (wm / T::WX), xl = 8 * (wm % T::WX), nl = 8 * T::WN * (warp / T::WM);
  const uint32_t a = ((lane >> 4) * T::PP + (yl + ((lane >> 3) & 1)) * T::RP + xl + (lane & 7) + 7) * 16;
  const uint32_t b = (nl + (lane >> 2)) * 16 + 4 * (lane & 3);
  const int group = (kg * T::WNW + warp / T::WM) * T::WY + wm / T::WX;  // the warps of rows yl, yl + 1, outputs nl ..
  const uint32_t rows = wt + (p.stream ? 2 * T::KS : p.chunks) * T::WCHUNK + group * T::OUT;
  float acc[T::TZ][T::WN][4];
#pragma unroll
  for (int j = 0; j < T::TZ; ++j)
#pragma unroll
    for (int n = 0; n < T::WN; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[j][n][h] = 0.0f;

  if (threadIdx.x == T::ISSUER) {
    mbar_init(bar_of<T>(base));
    mbar_init(bar_of<T>(base + T::STAGE_BAR));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int tile = blockIdx.x, c = 0;
  Origin o = origin_of<T::TZ, T>(p, tile);
  stage_step<T>(base, wt, p, o, 0, 0);  // only the issuer, which initialised them, touches the barriers before the sync
  __syncthreads();
  for (int s = 0;; ++s) {
    const uint32_t st = base + (s & 1) * T::STAGE_BAR;
    mbar_wait(bar_of<T>(st), (s >> 1) & 1);  // the stage's (s / 2)-th copy
    __syncthreads();  // step s's copies are visible; every warp is done with step s - 1's stage
    const bool last = c + T::KS >= p.chunks;  // the tile's last chunks
    const int next = last ? tile + (int)gridDim.x : tile;
    const bool more = next < p.tiles;
    const Origin no = last && more ? origin_of<T::TZ, T>(p, next) : o;
    if (more)
      stage_step<T>(base + ((s + 1) & 1) * T::STAGE_BAR, wt + ((s + 1) & 1) * T::KS * T::WCHUNK, p, no,
                    last ? 0 : c + T::KS, s + 1);
    if (p.tma) {
      transpose<T>(st, kg);
      // the transposition's writes before the copy that next overwrites the stage
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    if constexpr (T::KS == 1)
      __syncthreads();
    else
      bar(1 + T::GROUPS + kg, 32 * T::WK);  // a K group needs its own chunk only
    const uint32_t w = wt + ((p.stream ? (s & 1) * T::KS : c) + kg) * T::WCHUNK;  // chunk c + kg's weights
    if (c + kg < p.chunks) multiply<T>(st + a + kg * T::HX * 16, w + b, acc);
    if (last) {
      if constexpr (T::KS > 1) {
        // the two K groups' sums, sum 0 + sum 1 (as sum 1 + sum 0: the same bits): each hands the other, through
        // the stage, the planes it does not write, adds the other's half of its own, and writes that half
        constexpr int H = T::TZ / 2, PART = T::WK * 32 * H * T::WN;  // float4s of a group's half
        float4* half = reinterpret_cast<float4*>(smem + (s & 1) * T::STAGE_BAR) + warp * 32 * H * T::WN + lane;
        __syncthreads();  // both groups are done with the stage
        if (kg == 0)
          hand_over<T, H>(acc, half);
        else
          hand_over<T, 0>(acc, half + PART);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before the stage's next copy
        __syncthreads();
        if (kg == 0) {
          take_over<T, 0>(acc, half + PART);
          store<T, 0, H>(p, o, acc, yl, xl, nl, rows, group);
        } else {
          take_over<T, H>(acc, half);
          store<T, H, T::TZ>(p, o, acc, yl, xl, nl, rows, group);
        }
      } else {
        store<T, 0, T::TZ>(p, o, acc, yl, xl, nl, rows, group);
      }
    }
    if (!more) break;
    tile = next;
    c = last ? 0 : c + T::KS;
    o = no;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// A 5D bf16 TMA map (cuTensorMapEncodeTiled, found through the runtime):
// whether it was encoded.
bool encode_tiled(CUtensorMap* map, void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box, const cuuint32_t* unit) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map of an NCDHW input (unit W stride, the other strides multiples
// of 8, 16-byte aligned): dims (W, C, H, D, B), so that a box lands as (plane,
// row) slabs of 8 channel rows of HX columns. False where it cannot be
// encoded; the kernel then stages with 2-byte loads.
template <class T>
bool encode_map(Conv& p, int B) {
  const Strides& s = p.is;
  if (s.w != 1 || s.h % 8 || s.d % 8 || s.c % 8 || s.b % 8 || !aligned16(p.in)) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)p.W, (cuuint64_t)p.Cin, (cuuint64_t)p.H, (cuuint64_t)p.D, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)s.c * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.d * 2,
                                 (cuuint64_t)(B > 1 ? s.b : p.D * s.d) * 2};  // bytes, of dims 1 .. 4
  const cuuint32_t box[5] = {T::HX, 8 * T::KS, T::HY, T::HP, 1}, unit[5] = {1, 1, 1, 1, 1};
  return encode_tiled(&p.map, const_cast<__nv_bfloat16*>(p.in), dims, strides, box, unit);
}

// The weights' TMA map (the launch checked their strides).
template <class T>
bool encode_weights(Conv& p) {
  const cuuint64_t dims[5] = {8 * (cuuint64_t)p.chunks, (cuuint64_t)p.Cout, 3, 3, 3};
  const cuuint64_t strides[4] = {(cuuint64_t)p.ko * 2, (cuuint64_t)p.kdx * 2, (cuuint64_t)p.kdy * 2,
                                 (cuuint64_t)p.kdz * 2};
  const cuuint32_t box[5] = {8, T::BN, 3, 3, 3}, unit[5] = {1, 1, 1, 1, 1};
  return encode_tiled(&p.wmap, const_cast<__nv_bfloat16*>(p.k), dims, strides, box, unit);
}

template <class T>
int launch(Conv& p, int B, void* stream) {
  const auto kernel = conv3d_k3_bf16_kernel<T>;
  static int cached_device = -1, sms = 0, smem_max = 0;
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device != cached_device) {
    if ((e = device_limits(device, &sms, &smem_max)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max)) != cudaSuccess)
      return (int)e;
    cached_device = device;
  }
  p.tiles_x = (p.W + T::BX - 1) / T::BX;
  p.tiles_y = (p.H + T::BY - 1) / T::BY;
  p.tiles_z = (p.D + T::TZ - 1) / T::TZ;
  p.n_tiles = (p.Cout + T::BN - 1) / T::BN;
  p.chunks = (p.Cin + 7) / 8;
  const int64_t tiles = (int64_t)B * p.tiles_z * p.tiles_y * p.tiles_x * p.n_tiles;
  constexpr int fixed = 2 * T::STAGE_BAR + T::GROUPS * T::OUT;
  const int stay = fixed + p.chunks * T::WCHUNK, streamed = fixed + 2 * T::KS * T::WCHUNK;  // shared memory
  if (smem_max < streamed || tiles >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  // the weights stay where they fit and a block takes more than one tile; else each step copies its own
  int per_sm = 0;
  if (stay <= smem_max && (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, stay)))
    return (int)e;
  p.stream = per_sm < 1 || tiles <= (int64_t)sms * per_sm;
  const int smem = p.stream ? streamed : stay;
  if (p.stream && (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, smem)))
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p.tiles = (int)tiles;
  if (!encode_weights<T>(p)) return (int)cudaErrorInvalidValue;
  p.tma = encode_map<T>(p, B);
  const Strides& os = p.os;  // rows of 8 columns where they are whole and on 16 bytes
  p.rows_out = os.w == 1 && p.W % 8 == 0 && os.h % 8 == 0 && os.d % 8 == 0 && os.c % 8 == 0 && os.b % 8 == 0 &&
               aligned16(p.out);
  // resident blocks, a multiple of the output tiles: a block's tiles share their outputs' weights
  int64_t grid = tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm;
  grid = grid < p.n_tiles ? p.n_tiles : grid - grid % p.n_tiles;
  kernel<<<(int)grid, T::THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The tile by Cout, then the launch. The weights must lie by (dz, dy, dx, o,
// i) with unit i stride, 8 * ceil(Cin / 8) channels (zeros beyond Cin), the
// other strides multiples of 8 and a 16-byte aligned start.
int launch_mma(const void* x, Strides is, const void* w, KStrides ks, const float* bs, void* y, Strides os, int B,
               int Cin, int Cout, int D, int H, int W, void* stream) {
  if (ks.i != 1 || ks.o % 8 != 0 || ks.dx % 8 != 0 || ks.dy % 8 != 0 || ks.dz % 8 != 0 || ks.o < 8 * ((Cin + 7) / 8) ||
      !aligned16(w))
    return (int)cudaErrorInvalidValue;
  Conv p{};
  p.in = static_cast<const __nv_bfloat16*>(x), p.is = is, p.k = static_cast<const __nv_bfloat16*>(w);
  p.kdz = ks.dz, p.kdy = ks.dy, p.kdx = ks.dx, p.ko = ks.o, p.bias = bs;
  p.out = static_cast<__nv_bfloat16*>(y), p.os = os, p.Cin = Cin, p.Cout = Cout, p.D = D, p.H = H, p.W = W;
  if (Cout <= 8) return launch<Tile<8, 2, 4, 1, 1>>(p, B, stream);
  if (Cout <= 16) return launch<Tile<4, 2, 4, 2, 1>>(p, B, stream);
  return launch<Tile<8, 2, 1, 2, 2, 2>>(p, B, stream);
}

}  // namespace bf

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
  return launch_mma(x, is, w, ks, bs, y, os, B, Cin, Cout, D, H, W, stream);
}

// conv3d_banded on bf16 x, weights and out, float32 bias (may be null), for
// Cout > 4 only (the score heads stay float32): the tensor cores' bf16 form.
// The weights lie by (dz, dy, dx, o, i) with unit i stride and 8 * ceil(Cin
// / 8) channels, zeros beyond Cin (k_strides still by (dz, dy, dx, i, o)),
// the other strides multiples of 8, 16-byte aligned; else cudaErrorInvalidValue.
extern "C" int conv3d_banded_bf16(const void* in, const int64_t* in_strides, const void* k,
                                  const int64_t* k_strides, const void* bias, void* out, const int64_t* out_strides,
                                  int32_t B, int32_t Cin, int32_t Cout, int32_t D, int32_t H, int32_t W,
                                  void* stream) {
  if (conv3d_banded_route(Cout) == 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Cin * Cout * D * H * W == 0) return 0;
  const Strides is{in_strides[0], in_strides[1], in_strides[2], in_strides[3], in_strides[4]};
  const Strides os{out_strides[0], out_strides[1], out_strides[2], out_strides[3], out_strides[4]};
  const KStrides ks{k_strides[0], k_strides[1], k_strides[2], k_strides[3], k_strides[4]};
  return bf::launch_mma(in, is, k, ks, static_cast<const float*>(bias), out, os, B, Cin, Cout, D, H, W, stream);
}
