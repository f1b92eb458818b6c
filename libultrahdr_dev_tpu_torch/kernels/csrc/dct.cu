// B2: forward 8x8 DCT + quantization + zigzag, and
// B5: dequantization + inverse 8x8 DCT, for the port's jpeg/dct.py.
//
// Replaces libultrahdr_dev_tpu/jpeg/dct.py:fdct_zigzag (reached through
// parallel/sharding.py:_fdct_zigzag) and dct.py:_idct_kernel /
// dequant_idct.
//
// Bound: memory traffic. Per 4080x3072 frame the separable transform is
// about 0.6 GFLOP each way while the planes and coefficients move about
// 60 MB (u8 in, int16 out, or back), so an H100 spends far longer on
// the bytes than on the arithmetic. The design keeps each pixel read
// and each coefficient written exactly once: one thread per sample,
// 256 threads per CTA covering four horizontally adjacent blocks, so
// that a warp reads or writes 32 consecutive pixels of one row. Both
// passes of the separable transform stay in shared memory.
//
// Numerics:
//  - fDCT: it uses Ds = 2*sqrt(2)*D, whose rows 0 and 4 are exactly +-1,
//    and scales the result by 1/8. The coefficients with both
//    frequencies in {0, 4} are then exact integer sums over 8, as the
//    JAX version's kron(D, D) matmul computes them, so the frequent
//    exact .5 ties of c/q (DC at quality 95 is q = 2) round half to even
//    the same way on both sides. Other coefficients agree to ~1e-6 and
//    may differ by 1 only at such near-ties.
//  - IDCT: D in float32, u contracted before v, like the JAX einsum at
//    Precision.HIGHEST; no TF32 anywhere. A block with only a DC term
//    gives the same float as JAX bit for bit.
//  - Rounding is __float2int_rn / rintf: half to even, like jnp.round.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlocksPerCta = 4;
constexpr int kThreads = 64 * kBlocksPerCta;

// Constant tables, passed by value from the host (jpeg/dct.py builds
// them): the forward scaled matrix, the float32 DCT matrix, and the
// natural index -> zigzag position permutation.
struct Tables {
  float ds[64];
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

__global__ void fdct_quant_kernel(const uint8_t* __restrict__ plane,
                                  const int32_t* __restrict__ q,
                                  int16_t* __restrict__ out, int h, int w,
                                  int bh, int bw, const Tables tab) {
  __shared__ float ds[64];
  __shared__ float qs[64];
  __shared__ int inv_zig[64];
  __shared__ float xs[kBlocksPerCta][8][9];
  __shared__ float tmp[kBlocksPerCta][8][9];

  int t = threadIdx.x;
  if (t < 64) {
    ds[t] = tab.ds[t];
    qs[t] = (float)q[t];
    inv_zig[t] = tab.inv_zig[t];
  }
  int r, blk, c;
  thread_coords(&r, &blk, &c);
  int b = blockIdx.z;
  int by = blockIdx.y;
  int bx = blockIdx.x * kBlocksPerCta + blk;
  // Edge padding: clamp reads to the last row / column, as
  // sharding._fdct_zigzag pads with mode="edge".
  int py = min(by * 8 + r, h - 1);
  int px = min(bx * 8 + c, w - 1);
  const uint8_t* src = plane + (size_t)b * h * w;
  xs[blk][r][c] = (float)src[(size_t)py * w + px] - 128.0f;
  __syncthreads();

  // tmp[u][y] = sum_x Ds[u][x] * X[x][y]   (thread: u = r, y = c)
  float acc = 0.0f;
#pragma unroll
  for (int x = 0; x < 8; ++x) acc += ds[r * 8 + x] * xs[blk][x][c];
  tmp[blk][r][c] = acc;
  __syncthreads();

  // T[u][v] = sum_y tmp[u][y] * Ds[v][y]   (thread: u = r, v = c)
  acc = 0.0f;
#pragma unroll
  for (int y = 0; y < 8; ++y) acc += tmp[blk][r][y] * ds[c * 8 + y];
  if (bx < bw) {
    int k = r * 8 + c;
    float coef = (acc * 0.125f) / qs[k];
    size_t o = (((size_t)b * bh + by) * bw + bx) * 64 + inv_zig[k];
    out[o] = (int16_t)__float2int_rn(coef);
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

// ds, d: host float[64]; inv_zig: host int[64].
Tables make_tables(const float* ds, const float* d, const int* inv_zig) {
  Tables tab;
  for (int i = 0; i < 64; ++i) {
    tab.ds[i] = ds[i];
    tab.d[i] = d[i];
    tab.inv_zig[i] = inv_zig[i];
  }
  return tab;
}

}  // namespace

extern "C" {

// plane: (n, h, w) u8; q: (64,) int32 natural order; out: (n, bh*bw, 64)
// int16 zigzag, bh = ceil(h/8), bw = ceil(w/8).
int uhdr_fdct_quant(const void* plane, const void* q, void* out, int n,
                    int h, int w, const float* ds, const float* d,
                    const int* inv_zig, void* stream) {
  int bh = (h + 7) / 8, bw = (w + 7) / 8;
  dim3 grid((bw + kBlocksPerCta - 1) / kBlocksPerCta, bh, n);
  fdct_quant_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, (const int32_t*)q, (int16_t*)out, h, w, bh,
      bw, make_tables(ds, d, inv_zig));
  return (int)cudaGetLastError();
}

// coefs: (n, bh*bw, 64) int16 zigzag; q: (n, 64) int32 natural order;
// out: (n, bh*8, bw*8) u8.
int uhdr_dequant_idct(const void* coefs, const void* q, void* out, int n,
                      int bh, int bw, const float* ds, const float* d,
                      const int* inv_zig, void* stream) {
  dim3 grid((bw + kBlocksPerCta - 1) / kBlocksPerCta, bh, n);
  dequant_idct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coefs, (const int32_t*)q, (uint8_t*)out, bh, bw,
      make_tables(ds, d, inv_zig));
  return (int)cudaGetLastError();
}

}  // extern "C"
