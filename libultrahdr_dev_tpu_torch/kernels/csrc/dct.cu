// B2: forward 8x8 DCT + quantization + zigzag, and
// B5: dequantization + inverse 8x8 DCT, for the port's jpeg/dct.py.
//
// Replaces libultrahdr_dev_tpu/jpeg/dct.py:fdct_zigzag (reached through
// parallel/sharding.py:_fdct_zigzag) and dct.py:_idct_kernel /
// dequant_idct.
//
// Bound: B5 by memory traffic: per 4080x3072 frame the separable
// inverse is about 0.6 GFLOP while the coefficients and planes move
// about 60 MB. B2 computes the JAX version's kron form, 3 x 64 float32
// multiply-adds per coefficient (about 3.6 G per 4:2:0 frame); read
// from L1, the 48 KB of terms cost about as much as the arithmetic.
// Each pixel is read and each coefficient written once.
//
// Numerics:
//  - fDCT: the JAX version multiplies the bf16 samples by the three
//    bf16 terms of kron(D, D) (columns in zigzag order) in three K=64
//    dots whose float32 result is the pairwise tree sum of the products,
//    then forms (d0 + d1) + d2 and rounds c / q half to even. A product
//    (an 8-bit sample times a bf16 term) has 16 significant bits and a
//    row of 8 products sums within 24, so a block row sums exactly in
//    float32 in any order; the kernel then adds the 8 row sums as the
//    tree ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), which is the only place
//    the dot rounds. The result equals the JAX value and the plain
//    version bit for bit.
//  - IDCT: D in float32, u contracted before v, like the JAX einsum at
//    Precision.HIGHEST; no TF32 anywhere. A block with only a DC term
//    gives the same float as JAX bit for bit.
//  - Rounding is __float2int_rn / rintf: half to even, like jnp.round.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlocksPerCta = 4;
constexpr int kThreads = 64 * kBlocksPerCta;
// B2: a CTA covers kFBlocks horizontally adjacent blocks; each of its
// threads computes one zigzag coefficient o of kFPer of them.
constexpr int kFBlocks = 16;
constexpr int kFPer = kFBlocks * 64 / kThreads;

// Constant tables, passed by value from the host (jpeg/dct.py builds
// them): the float32 DCT matrix and the natural index -> zigzag
// position permutation.
struct Tables {
  float d[64];
  int inv_zig[64];
};

// Thread layout: t = r * 32 + blk * 8 + c, so a warp covers one row r of
// four adjacent blocks.
__device__ __forceinline__ void thread_coords(int* r, int* blk, int* c) {
  int t = threadIdx.x;
  *r = t >> 5;
  *blk = (t >> 3) & 3;
  *c = t & 7;
}

// kron: (3, 64, 64) float32, term t, sample k = 8 * row + col, output
// column o in zigzag order (jpeg/dct.py KRON_ZIG).
__global__ void fdct_quant_kernel(const uint8_t* __restrict__ plane,
                                  const int32_t* __restrict__ q,
                                  const float* __restrict__ kron,
                                  int16_t* __restrict__ out, int h, int w,
                                  int bh, int bw, Tables tab) {
  __shared__ float xs[kFBlocks][64];
  __shared__ float qz[64];

  int t = threadIdx.x;
  int b = blockIdx.z;
  int by = blockIdx.y;
  int bx0 = blockIdx.x * kFBlocks;
  if (t < 64) qz[tab.inv_zig[t]] = (float)q[t];
  // Load 8 rows x (kFBlocks * 8) pixels; edge padding clamps reads to
  // the last row / column, as sharding._fdct_zigzag pads with
  // mode="edge".
  const uint8_t* src = plane + (size_t)b * h * w;
  for (int i = t; i < kFBlocks * 64; i += kThreads) {
    int r = i / (kFBlocks * 8), col = i % (kFBlocks * 8);
    int py = min(by * 8 + r, h - 1);
    int px = min(bx0 * 8 + col, w - 1);
    xs[col >> 3][r * 8 + (col & 7)] =
        (float)src[(size_t)py * w + px] - 128.0f;
  }
  __syncthreads();

  int o = t & 63;
  int g = t >> 6;
  float c[kFPer];
#pragma unroll
  for (int j = 0; j < kFPer; ++j) c[j] = 0.0f;
  // One term at a time: unrolled over the three, the hoisted loads of
  // the terms spill to the stack.
#pragma unroll 1
  for (int term = 0; term < 3; ++term) {
    const float* m = kron + term * 4096 + o;
    float rs[kFPer][8];
#pragma unroll
    for (int row = 0; row < 8; ++row) {
#pragma unroll
      for (int j = 0; j < kFPer; ++j) rs[j][row] = 0.0f;
#pragma unroll
      for (int col = 0; col < 8; ++col) {
        float mk = __ldg(m + (row * 8 + col) * 64);
#pragma unroll
        for (int j = 0; j < kFPer; ++j)
          rs[j][row] += xs[g * kFPer + j][row * 8 + col] * mk;
      }
    }
#pragma unroll
    for (int j = 0; j < kFPer; ++j) {
      float d = ((rs[j][0] + rs[j][1]) + (rs[j][2] + rs[j][3])) +
                ((rs[j][4] + rs[j][5]) + (rs[j][6] + rs[j][7]));
      c[j] = term == 0 ? d : c[j] + d;
    }
  }
#pragma unroll
  for (int j = 0; j < kFPer; ++j) {
    int bx = bx0 + g * kFPer + j;
    if (bx < bw) {
      size_t base = (((size_t)b * bh + by) * bw + bx) * 64;
      out[base + o] = (int16_t)__float2int_rn(c[j] / qz[o]);
    }
  }
}

__global__ void dequant_idct_kernel(const int16_t* __restrict__ coefs,
                                    const int32_t* __restrict__ q,
                                    uint8_t* __restrict__ out, int bh,
                                    int bw, const Tables tab) {
  __shared__ float d[64];
  __shared__ int inv_zig[64];
  __shared__ float fs[kBlocksPerCta][8][9];
  __shared__ float tmp[kBlocksPerCta][8][9];

  int t = threadIdx.x;
  int b = blockIdx.z;
  if (t < 64) {
    d[t] = tab.d[t];
    inv_zig[t] = tab.inv_zig[t];
  }
  __syncthreads();
  int r, blk, c;
  thread_coords(&r, &blk, &c);
  int by = blockIdx.y;
  int bx = blockIdx.x * kBlocksPerCta + blk;
  bool live = bx < bw;
  // F[u][v] = coef[zigzag(u, v)] * q[u][v]   (thread: u = r, v = c)
  int k = r * 8 + c;
  float f = 0.0f;
  if (live) {
    size_t base = (((size_t)b * bh + by) * bw + bx) * 64;
    f = (float)coefs[base + inv_zig[k]] * (float)q[(size_t)b * 64 + k];
  }
  fs[blk][r][c] = f;
  __syncthreads();

  // tmp[x][v] = sum_u D[u][x] * F[u][v]   (thread: x = r, v = c)
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < 8; ++u) acc += d[u * 8 + r] * fs[blk][u][c];
  tmp[blk][r][c] = acc;
  __syncthreads();

  // out[x][y] = sum_v tmp[x][v] * D[v][y]   (thread: x = r, y = c)
  acc = 0.0f;
#pragma unroll
  for (int v = 0; v < 8; ++v) acc += tmp[blk][r][v] * d[v * 8 + c];
  if (live) {
    float pix = fminf(fmaxf(rintf(acc + 128.0f), 0.0f), 255.0f);
    size_t w = (size_t)bw * 8;
    size_t o = ((size_t)b * bh * 8 + by * 8 + r) * w + bx * 8 + c;
    out[o] = (uint8_t)pix;
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

// plane: (n, h, w) u8; q: (64,) int32 natural order; kron: (3, 64, 64)
// float32; out: (n, bh*bw, 64) int16 zigzag, bh = ceil(h/8),
// bw = ceil(w/8); d, inv_zig: host tables.
int uhdr_fdct_quant(const void* plane, const void* q, const void* kron,
                    void* out, int n, int h, int w, const float* d,
                    const int* inv_zig, void* stream) {
  int bh = (h + 7) / 8, bw = (w + 7) / 8;
  dim3 grid((bw + kFBlocks - 1) / kFBlocks, bh, n);
  fdct_quant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, (const int32_t*)q, (const float*)kron,
      (int16_t*)out, h, w, bh, bw, make_tables(d, inv_zig));
  return (int)cudaGetLastError();
}

// coefs: (n, bh*bw, 64) int16 zigzag; q: (n, 64) int32 natural order;
// out: (n, bh*8, bw*8) u8.
int uhdr_dequant_idct(const void* coefs, const void* q, void* out, int n,
                      int bh, int bw, const float* d, const int* inv_zig,
                      void* stream) {
  dim3 grid((bw + kBlocksPerCta - 1) / kBlocksPerCta, bh, n);
  dequant_idct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)q, (uint8_t*)out, bh, bw,
      make_tables(d, inv_zig));
  return (int)cudaGetLastError();
}

}  // extern "C"
