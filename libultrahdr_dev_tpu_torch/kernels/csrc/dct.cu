// B2: forward 8x8 DCT + quantization + zigzag, and
// B5: dequantization + inverse 8x8 DCT, for the port's jpeg/dct.py.
//
// Replaces libultrahdr_dev_tpu/jpeg/dct.py:fdct_zigzag (reached through
// parallel/sharding.py:_fdct_zigzag) and dct.py:_idct_kernel /
// dequant_idct.
//
// Bound: both by memory traffic, each pixel read or written once and
// each int16 coefficient written or read once (about 59 MB per
// 4080x3072 4:2:0 frame with its gain map). B2's arithmetic is JAX's:
// three bf16 x bf16 products with float32 results, 24,576 operations a
// block (7.5 GOP a frame), which the tensor cores (989 TFLOP/s bf16)
// could do in under half the byte time and the CUDA cores (67 TFLOP/s
// f32) not in less than six times it. B5's separable inverse is 2,048
// float32 operations a block.
//
// B2 design: a warp takes a tile of 16 horizontally adjacent blocks of
// one block row (8 rows x 128 pixels, one 128-byte load a row into
// shared memory; the last row and column repeat for edge padding, as
// sharding._fdct_zigzag pads with mode="edge"). For each bf16 term of
// kron(D, D), each block row r and each 8-wide group j of output
// columns (zigzag order) it issues one
// mma.sync.m16n8k8.row.col.f32.bf16.bf16.f32: A the row r of the 16
// blocks (u8 - 128, exact in bf16), B the 8 x 8 slice
// KRON_ZIG[t, 8r:8r+8, 8j:8j+8] (jpeg/dct.py:kron_mma_fragments lays
// the terms out in B-fragment order; a CTA stages the 24 KB once in
// shared memory), a zero accumulator: 192 mma a tile. The int16
// results pass through shared memory and leave as 2 KB of 16-byte
// stores. The CTAs are persistent and walk the tiles.
//
// B2 numerics: the JAX version's dots sum the 64 products of a block
// as a pairwise float32 tree (XLA's CPU dot). A product (a sample in
// [-128, 127] times a bf16 term) is exact, and a row of 8 products sums
// exactly in float32: over every (term, row, output column) the largest
// |row sum| any input can give is under 2^24 times the smallest
// weight's last bit (19.5, 23.6 and 23.4 bits for the three terms;
// tests/test_torch_dct.py::test_kron_row_sums_fit_float32). So one
// k = 8 mma with a zero accumulator has one right answer, the exact
// row sum, as long as the tensor core keeps the row's < 24-bit span;
// chip_smoke.py checks every row sum of the adversarial rows of every
// triple on the card (uhdr_mma_row_sums). Rows are never chained
// through the accumulator (its additions are not the IEEE tree). The
// tree ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), (d0 + d1) + d2 and the
// quantisation run on the CUDA cores: round(c / q) half to even is
// taken from c * (1 / q) wherever that cannot round differently from
// the IEEE quotient, and from the IEEE division itself near a tie
// (quantize). The result equals the JAX value and the plain version
// bit for bit. JAX's encode programs (parallel/sharding.py:
// _gainmap_and_coefs) quantise by tables that are constants of the
// program, and XLA rewrites c / q there as c * RN(1 / q); with `recip`
// the kernel takes that product alone, so it matches those programs on
// exact ties as well (a coefficient of -45.5 against q = 7 gives -7
// there and -6 by the IEEE quotient).
//
// B5 design: a thread per 8x8 block, a warp per 32 horizontally
// adjacent blocks (4 KB of contiguous coefficients, read with 16-byte
// loads into a padded shared tile), the block de-zigzagged and
// dequantised into registers, both 1-D passes in registers, and each
// pixel row of the block written as one 8-byte store (256 contiguous
// bytes across the warp). D and inv_zig come from the by-value Tables,
// indexed by constants, so from the parameter bank.
//
// B5 numerics, kept from the first kernel so its pixels do not change:
// F[u][v] = coef * q, tmp[x][v] = sum over u = 0..7 of D[u][x] * F[u][v],
// then out[x][y] = sum over v = 0..7 of tmp[x][v] * D[v][y], each step
// a separately rounded float32 multiply and add (the build has
// -fmad=false), D the float32 table, then rintf(acc + 128) and the
// clamp. Like the JAX einsum at Precision.HIGHEST, u is contracted
// before v, no TF32. Two liberties change no pixel: products equal by
// the DCT's symmetry up to sign are computed once (rep, flip), and a
// sum starts from its first product where the first kernel added it to
// 0.0f (which differs only in the sign of a zero sum, and no pixel can
// see that). Rounding is __float2int_rn / rintf: half to even, like
// jnp.round.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Constant tables, passed by value from the host (jpeg/dct.py builds
// them): the float32 DCT matrix and the natural index -> zigzag
// position permutation. Indexed by constants after unrolling, they are
// read from the kernel's parameter bank.
struct Tables {
  float d[64];
  int inv_zig[64];
};

// ---------------------------------------------------------------------
// B2
// ---------------------------------------------------------------------

constexpr int kFTile = 16;               // blocks a warp tile (the mma's M)
constexpr int kFWarps = 8;
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFCtasPerSm = 3;
// B fragments: (term, column group, row half, lane, row in half) u32,
// two bf16 each; a lane reads four rows' fragments as one uint4.
constexpr int kFragVecs = 3 * 8 * 2 * 32;
// Staging: a block's 64 int16 and a 16-byte pad, so that a warp's
// 32-bit epilogue stores fall in 32 distinct banks.
constexpr int kOutStride = 72;

// d = A * B + 0: A 16 x 8 bf16 (two u32 a lane), B 8 x 8 bf16 (one).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.0f));
}

// 1.5 * 2^23: for |y| < 2^22, y + kRound rounds y to an integer (half
// to even) whose two's complement sits in the low bits of the float.
constexpr float kRound = 12582912.0f;

// Two u8 samples (the low two bytes of p) -> two bf16 of sample - 128,
// exact (an integer in [-128, 127] has at most 8 significant bits):
// 2^23 + sample built in the float's mantissa, less 2^23 + 128.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t p) {
  float x0 = __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7650)) -
             8388736.0f;
  float x1 = __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7651)) -
             8388736.0f;
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// The tile's 8 rows (w % 4 == 0, 4-byte aligned rows): a lane's word of
// each; a word past the last column repeats that row's last pixel, and
// rows past the last repeat it, as sharding._fdct_zigzag pads.
__device__ __forceinline__ void load_rows(uint32_t (&v)[8],
                                          const uint8_t* src, int h, int w,
                                          int by, int x0, int lane) {
  int col = x0 + 4 * lane;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = src + (size_t)min(by * 8 + r, h - 1) * w;
    v[r] = col < w ? __ldg(reinterpret_cast<const uint32_t*>(row + col))
                   : 0x01010101u * row[w - 1];
  }
}

// (uint16_t)__float2int_rn(c[i] / q), for blocks g (i = 0, 1) and
// g + 8 (i = 2, 3) at columns o (even i) and o + 1 (odd i), packed two
// a word. y = c * RN(1 / q) is within |c / q| * 1.5 * 2^-23 (< |y| *
// 2^-22.4) of the IEEE quotient, so the two round to the same integer
// unless y lies within |y| * 2^-20 of a half-integer; then (rarely) the
// division itself decides. One branch for the four. With recip, y
// itself is rounded: round(c * RN(1 / q)), XLA's form for a constant q.
__device__ __forceinline__ void quantize(uint32_t& v0, uint32_t& v1,
                                         const float (&c)[4], float q0,
                                         float q1, float rq0, float rq1,
                                         bool recip) {
  float y[4] = {c[0] * rq0, c[1] * rq1, c[2] * rq0, c[3] * rq1};
  uint32_t u[4];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = y[i] + kRound;
    float gap = fabsf(fabsf(y[i] - (t - kRound)) - 0.5f);
    near |= !(gap > fabsf(y[i]) * 0x1p-20f);
    u[i] = __float_as_uint(t);
  }
  if (near && !recip) {
    u[0] = (uint32_t)__float2int_rn(c[0] / q0);
    u[1] = (uint32_t)__float2int_rn(c[1] / q1);
    u[2] = (uint32_t)__float2int_rn(c[2] / q0);
    u[3] = (uint32_t)__float2int_rn(c[3] / q1);
  }
  v0 = __byte_perm(u[0], u[1], 0x5410);
  v1 = __byte_perm(u[2], u[3], 0x5410);
}

// The ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) tree of the 8
// row sums of one term (f: the lane's four rows' fragments of each row
// half), each row sum one mma.
__device__ __forceinline__ void term_tree(float (&d)[4],
                                          const uint32_t (&a)[8][2],
                                          uint4 lo, uint4 hi) {
  float r0[4], r1[4], s[4], u[4];
  mma_bf16(r0, a[0][0], a[0][1], lo.x);
  mma_bf16(r1, a[1][0], a[1][1], lo.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = r0[i] + r1[i];
  mma_bf16(r0, a[2][0], a[2][1], lo.z);
  mma_bf16(r1, a[3][0], a[3][1], lo.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = s[i] + (r0[i] + r1[i]);
  mma_bf16(r0, a[4][0], a[4][1], hi.x);
  mma_bf16(r1, a[5][0], a[5][1], hi.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = r0[i] + r1[i];
  mma_bf16(r0, a[6][0], a[6][1], hi.z);
  mma_bf16(r1, a[7][0], a[7][1], hi.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = s[i] + (u[i] + (r0[i] + r1[i]));
}

__global__ void __launch_bounds__(kFThreads, kFCtasPerSm)
fdct_quant_kernel(const uint8_t* __restrict__ plane,
                  const int32_t* __restrict__ q,
                  const uint4* __restrict__ frags,
                  int16_t* __restrict__ out, int n, int h, int w, int bh,
                  int bw, int recip, Tables tab) {
  __shared__ uint4 bf[kFragVecs];
  __shared__ float qz[64], rqz[64];
  // Per warp: the tile's 8 x 128 samples, then (over them) its int16
  // results.
  __shared__ __align__(16) int16_t stage[kFWarps][kFTile * kOutStride];

  int t = threadIdx.x;
  for (int i = t; i < kFragVecs; i += kFThreads) bf[i] = frags[i];
  if (t < 64) {
    qz[tab.inv_zig[t]] = (float)q[t];
    rqz[tab.inv_zig[t]] = 1.0f / (float)q[t];
  }
  __syncthreads();

  int lane = t & 31, warp = t >> 5;
  int g = lane >> 2, tq = lane & 3;
  int16_t* st = stage[warp];
  uint8_t* px = reinterpret_cast<uint8_t*>(st);
  unsigned tiles_x = (bw + kFTile - 1) / kFTile;
  unsigned n_tiles = (unsigned)n * bh * tiles_x;
  bool words = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(plane) & 3) == 0;
  for (unsigned tile = blockIdx.x * kFWarps + warp; tile < n_tiles;
       tile += gridDim.x * kFWarps) {
    unsigned rest = tile / tiles_x;
    int bx0 = (int)(tile - rest * tiles_x) * kFTile, x0 = bx0 * 8;
    int b = (int)(rest / bh);
    int by = (int)(rest - (unsigned)b * bh);
    const uint8_t* src = plane + (size_t)b * h * w;
    if (words) {
      // A warp's load is one whole row: 128 contiguous bytes.
      uint32_t v[8];
      load_rows(v, src, h, w, by, x0, lane);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        reinterpret_cast<uint32_t*>(px)[r * 32 + lane] = v[r];
    } else {
      for (int i = lane; i < 8 * 128; i += 32) {
        int py = min(by * 8 + (i >> 7), h - 1);
        int col = min(x0 + (i & 127), w - 1);
        px[i] = src[(size_t)py * w + col];
      }
    }
    __syncwarp();
    // A fragments: row r of blocks g and g + 8, samples 2 tq and
    // 2 tq + 1.
    uint32_t a[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint16_t* row = reinterpret_cast<const uint16_t*>(px + r * 128);
      a[r][0] = bf16_pair(row[g * 4 + tq]);
      a[r][1] = bf16_pair(row[(g + 8) * 4 + tq]);
    }
    __syncwarp();
    // Column group j: this lane's results are blocks g and g + 8 at
    // zigzag columns 8 j + 2 tq and 8 j + 2 tq + 1.
#pragma unroll 4
    for (int j = 0; j < 8; ++j) {
      float c[4], d[4];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint4* f = bf + (term * 8 + j) * 64 + lane;
        term_tree(d, a, f[0], f[32]);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = term == 0 ? d[i] : c[i] + d[i];
      }
      int o = j * 8 + 2 * tq;
      uint32_t v0, v1;
      quantize(v0, v1, c, qz[o], qz[o + 1], rqz[o], rqz[o + 1], recip);
      *reinterpret_cast<uint32_t*>(st + g * kOutStride + o) = v0;
      *reinterpret_cast<uint32_t*>(st + (g + 8) * kOutStride + o) = v1;
    }
    __syncwarp();
    // Adjacent blocks are adjacent in (n, bh * bw, 64): the tile's live
    // blocks leave as one contiguous run of 128-byte blocks.
    int live = min(kFTile, bw - bx0);
    uint4* dst = reinterpret_cast<uint4*>(
        out + (((size_t)b * bh + by) * bw + bx0) * 64);
    for (int i = lane; i < live * 8; i += 32)
      dst[i] = *reinterpret_cast<const uint4*>(st + (i >> 3) * kOutStride +
                                               (i & 7) * 8);
    __syncwarp();
  }
}

// The premise B2 rests on, for chip_smoke.py to check on the card: a
// warp per 16-block tile ((tiles, 8 rows, 128) samples, laid out as B2
// stages them), every row sum as B2's mma gives it, in lane order
// (tile, term, column group, row, lane, 4).
__global__ void mma_row_sums_kernel(const uint8_t* __restrict__ tiles,
                                    const uint4* __restrict__ frags,
                                    float* __restrict__ out, int n_tiles) {
  int lane = threadIdx.x & 31;
  int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  int g = lane >> 2, tq = lane & 3;
  const uint16_t* px =
      reinterpret_cast<const uint16_t*>(tiles + (size_t)tile * 1024);
  uint32_t a[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    a[r][0] = bf16_pair(px[r * 64 + g * 4 + tq]);
    a[r][1] = bf16_pair(px[r * 64 + (g + 8) * 4 + tq]);
  }
  float4* o = reinterpret_cast<float4*>(out) + (size_t)tile * 3 * 8 * 8 * 32;
  for (int f = 0; f < 3 * 8; ++f) {
    uint4 lo = frags[f * 64 + lane], hi = frags[f * 64 + 32 + lane];
    uint32_t b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float d[4];
      mma_bf16(d, a[r][0], a[r][1], b[r]);
      o[(f * 8 + r) * 32 + lane] = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
}

// ---------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------

constexpr int kIWarps = 4;
constexpr int kIThreads = 32 * kIWarps;
constexpr int kIBlocks = 32 * kIWarps;   // blocks a CTA
// At most 85 registers a thread, so six CTAs fit an SM (with more, the
// compiler's choice of 96 cost a fifth of the time on the H100).
constexpr int kICtasPerSm = 6;
// Shared tile: a block's 64 int16 in 33 words, so that the warp's
// 16-byte loads land conflict-free and so do its per-thread reads.
constexpr int kIStride = 33;

// The DCT matrix's symmetry: D[u][x] = c_u cos(k pi / 16) with
// k = (2 x + 1) u mod 32, so |D[u][x]| depends only on k folded into
// [0, 8], and D[u][x] < 0 for 8 < k < 24. Row u holds at most four
// magnitudes, each first met at x = rep(u, x) < 4, and
// D[u][x] = +-D[u][rep(u, x)] bit for bit in the float32 table
// (tests/test_torch_dct.py::test_idct_table_symmetry): 22 of the 64
// entries carry every product.
__host__ __device__ constexpr int fold(int u, int x) {
  return ((2 * x + 1) * u) % 16 > 8 ? 16 - ((2 * x + 1) * u) % 16
                                    : ((2 * x + 1) * u) % 16;
}
__host__ __device__ constexpr bool negative(int u, int x) {
  return ((2 * x + 1) * u) % 32 > 8 && ((2 * x + 1) * u) % 32 < 24;
}
__host__ __device__ constexpr int rep(int u, int x) {
  return fold(u, 0) == fold(u, x)   ? 0
         : fold(u, 1) == fold(u, x) ? 1
         : fold(u, 2) == fold(u, x) ? 2
         : fold(u, 3) == fold(u, x) ? 3
                                    : x;
}
__host__ __device__ constexpr bool flip(int u, int x) {
  return negative(u, x) != negative(u, rep(u, x));
}

__global__ void __launch_bounds__(kIThreads, kICtasPerSm)
dequant_idct_kernel(const int16_t* __restrict__ coefs,
                    const int32_t* __restrict__ q, uint8_t* __restrict__ out,
                    int bh, int bw, const Tables tab) {
  __shared__ __align__(16) float qs[64];
  __shared__ uint32_t tile[kIWarps][32 * kIStride];

  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int b = blockIdx.z, by = blockIdx.y;
  if (t < 64) qs[t] = (float)q[(size_t)b * 64 + t];
  int bx0 = blockIdx.x * kIBlocks + warp * 32;
  int live = min(32, bw - bx0);
  const uint4* src = reinterpret_cast<const uint4*>(
      coefs + (((size_t)b * bh + by) * bw + bx0) * 64);
  uint32_t* mine = tile[warp];
  uint4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (lane + 32 * k < live * 8) v[k] = __ldg(src + lane + 32 * k);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int i = lane + 32 * k;
    if (i < live * 8) {
      uint32_t* s = mine + (i >> 3) * kIStride + (i & 7) * 4;
      s[0] = v[k].x;
      s[1] = v[k].y;
      s[2] = v[k].z;
      s[3] = v[k].w;
    }
  }
  __syncthreads();
  if (lane >= live) return;

  // F[u][v] = coef[zigzag(u, v)] * q[u][v], k = 8 u + v.
  const int16_t* blk = reinterpret_cast<const int16_t*>(mine +
                                                        lane * kIStride);
  float f[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) f[k] = (float)blk[tab.inv_zig[k]] * qs[k];

  // Pass 1, a column v of F at a time: tmp[x][v] = sum over u = 0..7 of
  // D[u][x] * F[u][v]. fl(D[u][x] * F) = +-fl(D[u][rep] * F) (rounding
  // to nearest is symmetric), so a column's 22 distinct products are
  // computed once and added with their signs, in the same order.
  float tmp[64];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float p[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (rep(u, x) == x) p[u][x] = tab.d[u * 8 + x] * f[u * 8 + v];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float pu = flip(u, x) ? -p[u][rep(u, x)] : p[u][rep(u, x)];
        acc = u == 0 ? pu : acc + pu;
      }
      tmp[x * 8 + v] = acc;
    }
  }
  // Pass 2, a pixel row x at a time: out[x][y] = sum over v = 0..7 of
  // tmp[x][v] * D[v][y], the same way; one 8-byte store a row.
  size_t row = (size_t)bw * 8;
  uint8_t* dst = out + ((size_t)b * bh + by) * 8 * row +
                 (size_t)(bx0 + lane) * 8;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float p[8][4];
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (rep(v, y) == y) p[v][y] = tmp[x * 8 + v] * tab.d[v * 8 + y];
    uint32_t half[2] = {0u, 0u};
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float pv = flip(v, y) ? -p[v][rep(v, y)] : p[v][rep(v, y)];
        acc = v == 0 ? pv : acc + pv;
      }
      uint32_t pix = (uint32_t)fminf(fmaxf(rintf(acc + 128.0f), 0.0f),
                                     255.0f);
      half[y >> 2] |= pix << (8 * (y & 3));
    }
    *reinterpret_cast<uint2*>(dst + x * row) = make_uint2(half[0], half[1]);
  }
}

// d: host float[64]; inv_zig: host int[64].
Tables make_tables(const float* d, const int* inv_zig) {
  Tables tab;
  for (int i = 0; i < 64; ++i) {
    tab.d[i] = d[i];
    tab.inv_zig[i] = inv_zig[i];
  }
  return tab;
}

}  // namespace

extern "C" {

// plane: (n, h, w) u8; q: (64,) int32 natural order; frags: the
// (3, 8, 2, 32, 4) uint32 B fragments of jpeg/dct.py; out:
// (n, bh*bw, 64) int16 zigzag, bh = ceil(h/8), bw = ceil(w/8); d,
// inv_zig: host tables.
int uhdr_fdct_quant(const void* plane, const void* q, const void* frags,
                    void* out, int n, int h, int w, int recip,
                    const float* d, const int* inv_zig, void* stream) {
  int bh = (h + 7) / 8, bw = (w + 7) / 8;
  long long tiles = (long long)n * bh * ((bw + kFTile - 1) / kFTile);
  if (tiles == 0) return (int)cudaSuccess;
  // The current device's SM count (the caller makes the plane's device
  // current), queried on each call: cards of one host may differ, and
  // the query is not a stream operation, so it is legal while capturing.
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long ctas = (tiles + kFWarps - 1) / kFWarps;
  if (ctas > (long long)sms * kFCtasPerSm) ctas = (long long)sms * kFCtasPerSm;
  fdct_quant_kernel<<<(unsigned)ctas, kFThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, (const int32_t*)q, (const uint4*)frags,
      (int16_t*)out, n, h, w, bh, bw, recip, make_tables(d, inv_zig));
  return (int)cudaGetLastError();
}

// tiles: (n_tiles, 8, 128) u8; frags: as uhdr_fdct_quant's; out:
// (n_tiles, 3, 8, 8, 32, 4) float32.
int uhdr_mma_row_sums(const void* tiles, const void* frags, void* out,
                      int n_tiles, void* stream) {
  if (n_tiles == 0) return (int)cudaSuccess;
  mma_row_sums_kernel<<<(n_tiles + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tiles, (const uint4*)frags, (float*)out, n_tiles);
  return (int)cudaGetLastError();
}

// coefs: (n, bh*bw, 64) int16 zigzag; q: (n, 64) int32 natural order;
// out: (n, bh*8, bw*8) u8.
int uhdr_dequant_idct(const void* coefs, const void* q, void* out, int n,
                      int bh, int bw, const float* d, const int* inv_zig,
                      void* stream) {
  dim3 grid((bw + kIBlocks - 1) / kIBlocks, bh, n);
  dequant_idct_kernel<<<grid, kIThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)q, (uint8_t*)out, bh, bw,
      make_tables(d, inv_zig));
  return (int)cudaGetLastError();
}

}  // extern "C"
