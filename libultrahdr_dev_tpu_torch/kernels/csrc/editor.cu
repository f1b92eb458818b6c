// B13: the effect chain of the port's ops/editor.py (crop, mirror,
// rotate, resize of the u8 planes of one image).
//
// Replaces libultrahdr_dev_tpu/ops/editor.py:71-152 (crop, mirror,
// rotate, resize and apply_effects: one jnp slice, flip, rot90 or gather
// per effect and plane, each materializing its plane).
//
// Premise. Every step of a plan maps each output axis to exactly one
// input axis, independently of the other axis: a crop adds an offset, a
// mirror flips one axis, a 90- or 270-degree turn swaps the axes and
// flips one, a 180-degree turn flips both, a resize maps i -> i * n_in
// // n_out on its own axis. So a whole chain is one swap bit and two 1-D
// maps R (output rows) and C (output columns): dst[y][x] = src[R[y]][C[x]]
// without a swap, src[C[x]][R[y]] with one. walk() computes one entry of
// a map by running the steps backwards; ops/editor.py:axis_maps is its
// specification, held against the JAX package by the CPU tests.
//
// Bound: bytes. The work is pure data movement, one byte read and one
// written per output pixel, so the floor is the output planes plus the
// source bytes they touch at 3.35 TB/s. Design:
// - One launch covers every plane of the image (Y, U, V or Y alone): a
//   by-value table gives each plane its pointers, shape, steps and first
//   tile. No intermediate plane exists.
// - A CTA owns a tile of 64 output rows x 4 chunks, a chunk being an
//   aligned 16 bytes of the output row (a row of any width and address
//   starts with a partial chunk). The prologue walks the tile's 64 rows
//   and its 80-column window through the steps once, into shared memory,
//   in 32-bit arithmetic; a resize divides as 32-bit unsigned integers
//   (the wrapper checks that i * n_in fits).
// - Unswapped tiles read source rows: where C runs +1 across the window
//   (crops), 16-byte loads (funnel-shifted words when unaligned); where
//   it runs -1 (mirrors), the same loads with bytes reversed by
//   __byte_perm; otherwise (resizes) byte gathers that hit L1. Each full
//   chunk is one 16-byte store.
// - Swapped tiles (90 and 270 degrees; a kernel of their own, so that
//   their loads in flight cost the other tiles no registers) stage the
//   source patch in padded shared memory, read along source rows (each
//   thread's 20 loads in flight together), and write output chunks
//   along output rows (a shared-memory tiled transpose).
// - Partial chunks (row ends, odd widths, unaligned rows) take a byte
//   path inside the same kernel.
// A chain longer than kMaxSteps runs as successive launches.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSteps = 16;   // ops/editor.py:MAX_STEPS
constexpr int kMaxPlanes = 3;   // Y, U, V
constexpr int kRows = 64;       // output rows of a tile
constexpr int kChunks = 4;      // 16-byte output chunks of a tile row
constexpr int kWin = 16 * kChunks + 16;  // window: 64 columns + 15 of shift
constexpr int kPitch = kRows + 4;        // staged patch row, padded
constexpr int kThreads = kRows * kChunks;
enum Kind : int { kCrop = 0, kMirror = 1, kRotate = 2, kResize = 3 };

// One step: kind, the plane's (h, w) before it, then its parameters:
// crop (top, left, out h, out w), mirror (horizontal, -, -, -), rotate
// (clockwise degrees, -, -, -), resize (-, -, out h, out w).
struct Step {
  int kind, h, w, a, b, c, d;
};

struct PlaneJob {
  const uint8_t* src;
  long long stride;   // source row stride in bytes
  uint8_t* dst;       // (oh, ow), contiguous
  int oh, ow;
  int tiles_x;        // tiles across a row
  int tile0;          // this plane's first tile in the grid
  Step s[kMaxSteps];
};

struct Job {
  int planes, steps;
  PlaneJob p[kMaxPlanes];
};

// Source coordinate of coordinate v on output axis `axis` (0 rows, 1
// columns), the steps run backwards; *axis ends as the source axis.
__device__ int walk(const Step* s, int n, int* axis, int v) {
  int ax = *axis;
  for (int i = n - 1; i >= 0; --i) {
    const Step& t = s[i];
    switch (t.kind) {
      case kCrop:
        v += ax ? t.b : t.a;
        break;
      case kMirror:
        if (ax == (t.a ? 1 : 0)) v = (ax ? t.w : t.h) - 1 - v;
        break;
      case kRotate:  // out (i, j) of the clockwise turn of in (h, w)
        if (t.a == 180) {
          v = (ax ? t.w : t.h) - 1 - v;
        } else {
          if (t.a == 90 ? ax == 1 : ax == 0)
            v = (t.a == 90 ? t.h : t.w) - 1 - v;
          ax ^= 1;
        }
        break;
      default:  // nearest neighbour, (i * ih) // oh as the JAX resize
        v = (int)((unsigned)v * (unsigned)(ax ? t.w : t.h) /
                  (unsigned)(ax ? t.d : t.c));
        break;
    }
  }
  *axis = ax;
  return v;
}

__device__ __forceinline__ uint32_t rev(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// 16 source bytes from p, which holds them all (aligned 16-byte load, or
// the aligned words that cover them, funnel-shifted).
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  uintptr_t a = (uintptr_t)p;
  if ((a & 15) == 0) return __ldg((const uint4*)p);
  const uint32_t* q = (const uint32_t*)(a & ~(uintptr_t)3);
  int s = (int)(a & 3) * 8;
  uint32_t w0 = __ldg(q), w1 = __ldg(q + 1), w2 = __ldg(q + 2),
           w3 = __ldg(q + 3);
  if (s == 0) return make_uint4(w0, w1, w2, w3);
  uint32_t w4 = __ldg(q + 4);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// kSwap: the chain turns the planes a quarter (an odd count of 90- and
// 270-degree steps); every plane of an image has the same steps.
template <bool kSwap>
__global__ void __launch_bounds__(kThreads) edit_kernel(Job job) {
  __shared__ int rmap[kRows];   // source coordinate of each tile row
  __shared__ int cmap[kWin];    // of each window column (-1 outside)
  __shared__ uint8_t patch[kWin][kPitch];  // swapped tiles: [x][y]

  int t = blockIdx.x, pi = 0;
  while (pi + 1 < job.planes && t >= job.p[pi + 1].tile0) ++pi;
  const PlaneJob& P = job.p[pi];
  t -= P.tile0;
  const int y0 = (t / P.tiles_x) * kRows;
  const int c0 = (t % P.tiles_x) * kChunks;  // first chunk of the tile
  // Chunk c of a row whose start lies m bytes past a 16-byte boundary
  // holds columns [16c - m, 16c - m + 16): the tile's columns lie in
  // [16 c0 - 15, 16 c0 + 64).
  const int xlo = 16 * c0 - 15;
  const int n = job.steps, oh = P.oh, ow = P.ow;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows + kWin; i += kThreads) {
    int axis;
    if (i < kRows) {
      int y = y0 + i;
      axis = 0;
      rmap[i] = y < oh ? walk(P.s, n, &axis, y) : -1;
    } else {
      int x = xlo + i - kRows;
      axis = 1;
      cmap[i - kRows] = x >= 0 && x < ow ? walk(P.s, n, &axis, x) : -1;
    }
  }
  __syncthreads();

  if (!kSwap) {
    // The shape of C over the window's valid columns: +1, -1 or other.
    const int f = xlo < 0 ? -xlo : 0;  // first valid column (xlo < ow)
    bool inc = true, dec = true;
    for (int i = tid; i < kWin; i += kThreads) {
      if (i > f && cmap[i] >= 0) {
        int d = cmap[i] - cmap[f];
        inc = inc && d == i - f;
        dec = dec && d == f - i;
      }
    }
    inc = __syncthreads_and(inc);
    dec = __syncthreads_and(dec);
    const int r = tid / kChunks, y = y0 + r;
    if (y >= oh) return;
    uint8_t* drow = P.dst + (size_t)y * ow;
    const int x0 = 16 * (c0 + tid % kChunks) - (int)((uintptr_t)drow & 15);
    if (x0 >= ow) return;
    const uint8_t* srow = P.src + (long long)rmap[r] * P.stride;
    const int* cm = cmap + (x0 - xlo);  // cm[k] = C[x0 + k]
    if (x0 >= 0 && x0 + 16 <= ow) {
      uint4 v;
      if (inc) {
        v = load16(srow + cm[0]);
      } else if (dec) {
        uint4 u = load16(srow + cm[15]);
        v = make_uint4(rev(u.w), rev(u.z), rev(u.y), rev(u.x));
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = pack4(srow[cm[4 * q]], srow[cm[4 * q + 1]],
                       srow[cm[4 * q + 2]], srow[cm[4 * q + 3]]);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *(uint4*)(drow + x0) = v;
    } else {
      for (int k = 0; k < 16; ++k) {
        int x = x0 + k;
        if (x >= 0 && x < ow) drow[x] = srow[cm[k]];
      }
    }
    return;
  }

  // Swapped: patch[x - xlo][y - y0] = src[C[x]][R[y]]; consecutive
  // threads take consecutive tile rows, i.e. consecutive source columns.
  // All of a thread's loads are issued before its first store.
  constexpr int kLoads = kWin * kRows / kThreads;
  static_assert(kLoads * kThreads == kWin * kRows, "whole patch rows");
  const int sc = rmap[tid % kRows], x1 = tid / kRows;
  uint8_t v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int sr = cmap[x1 + k * (kThreads / kRows)];
    v[k] = sr >= 0 && sc >= 0
               ? __ldg(P.src + (long long)sr * P.stride + sc) : 0;
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k)
    patch[x1 + k * (kThreads / kRows)][tid % kRows] = v[k];
  __syncthreads();
  const int r = tid % kRows, y = y0 + r;
  if (y >= oh) return;
  uint8_t* drow = P.dst + (size_t)y * ow;
  const int x0 = 16 * (c0 + tid / kRows) - (int)((uintptr_t)drow & 15);
  if (x0 >= ow) return;
  const int xi = x0 - xlo;
  if (x0 >= 0 && x0 + 16 <= ow) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = pack4(patch[xi + 4 * q][r], patch[xi + 4 * q + 1][r],
                   patch[xi + 4 * q + 2][r], patch[xi + 4 * q + 3][r]);
    *(uint4*)(drow + x0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; k < 16; ++k) {
      int x = x0 + k;
      if (x >= 0 && x < ow) drow[x] = patch[xi + k][r];
    }
  }
}

}  // namespace

extern "C" {

// planes (1..kMaxPlanes) edited by the same n (1..kMaxSteps) steps each,
// in one launch. ptrs: per plane (src, src row stride in bytes, dst),
// dst (oh, ow) contiguous; ints: per plane (oh, ow,
// then n descriptors of 7 int32, first step first); both in host memory.
int uhdr_edit_planes(const long long* ptrs, const int* ints, int planes,
                     int n, void* stream) {
  if (n < 1 || n > kMaxSteps || planes < 1 || planes > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  Job job;
  job.planes = planes;
  job.steps = n;
  int tiles = 0;
  bool swap = false;
  for (int i = 0; i < n; ++i)
    swap ^= ints[2 + 7 * i] == kRotate && ints[2 + 7 * i + 3] != 180;
  for (int k = 0; k < planes; ++k) {
    PlaneJob& p = job.p[k];
    const long long* q = ptrs + 3 * k;
    const int* v = ints + k * (2 + 7 * n);
    p.src = (const uint8_t*)q[0];
    p.stride = q[1];
    p.dst = (uint8_t*)q[2];
    p.oh = v[0];
    p.ow = v[1];
    for (int i = 0; i < n; ++i) {
      const int* s = v + 2 + 7 * i;
      p.s[i] = Step{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
    }
    // Chunks of a row: at most (ow + 30) / 16, its first one partial.
    p.tiles_x = ((p.ow + 30) / 16 + kChunks - 1) / kChunks;
    p.tile0 = tiles;
    if (p.oh > 0 && p.ow > 0)
      tiles += p.tiles_x * ((p.oh + kRows - 1) / kRows);
  }
  if (tiles == 0) return (int)cudaSuccess;
  if (swap)
    edit_kernel<true><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(job);
  else
    edit_kernel<false><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(job);
  return (int)cudaGetLastError();
}

}  // extern "C"
