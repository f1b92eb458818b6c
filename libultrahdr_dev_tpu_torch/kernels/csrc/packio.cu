// The packed host<->device transfers of the serving loop, for the port's
// parallel/packio.py, and the planes composite of ops/gainmap.py:
//
//   B0   uhdr_p010_dense_unpack   sharding.py:61 _unpack_p010_device
//                                 (the dense upload: hi8 + 2-bit tails)
//   B14  uhdr_p010_seg_unpack     packio.py:216 _unpack_fn, with the
//                                 split of sharding.py:71 fused in
//   B15  uhdr_rice_stats          packio.py:421-491, 650-732 (Rice pass 1,
//                                 8-bit arm: residuals, per-segment k)
//   B16  uhdr_rice_order          packio.py:749-954 (Rice pack: the
//        uhdr_rice_emit           stable rank order, then the buckets)
//   B18  uhdr_planes_composite    ops/gainmap.py:264 planes_composite
//
// (file:line in libultrahdr_dev_tpu). Every kernel is bit-exact with its
// plain PyTorch version in parallel/packio.py / ops/gainmap.py.
//
// Bound: bytes, for all of them; none does more than a few dozen integer
// operations per sample. What each design does about it:
//
// - B0 and B18 are one streaming pass, one thread per 4 output samples
//   (B0) or per output byte (B18), coalesced reads and writes.
// - B14 gives each thread one column of one 32-row delta group: it walks
//   the group's 32 rows, reads each row's segment index (the same for a
//   warp: a broadcast) and one u32 word of that segment's bucket
//   (neighbouring threads read neighbouring words), and keeps the running
//   sum in a register, so the cumulative sum costs no extra pass and the
//   tall (n*h*3/2, w) plane is never stored: each row goes straight to
//   the y or uv output, << 6.
// - B15 runs one CTA per 256-sample segment (one thread per sample): each
//   thread forms its residual from the composite in place (the column
//   edge padding is an index clamp), the block reduces the ten k costs
//   with warp shuffles, and thread 0 picks k. Both schemes share the one
//   read of the composite.
// - B16 is two launches. uhdr_rice_order is one CTA (1024 threads, a warp
//   per contiguous range of segments) that reads the per-segment map
//   twice: per-warp rank counts (__match_any_sync groups the lanes of one
//   rank), an exclusive scan over warps, then each segment's place in the
//   stable (rank, index) order of both bucket families, which is what
//   JAX's jnp.sort of (rank << 22) | index computes. It also writes the
//   fused head (counts, fit flag) and the bucket offsets. One CTA is the
//   slow pattern B19's scan showed (PERF.md section 6); chip_smoke.py
//   times it apart. uhdr_rice_emit gives each output row one warp: eight
//   samples a lane (one 16-byte load), the remainder words OR-ed in
//   shared memory, the unary terminator positions from a warp scan of
//   q + 1, then a coalesced store of the row's words.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

using uhdr::Plane;

constexpr int kL = 256;   // samples per segment
constexpr int kG = 32;    // rows per delta group
constexpr int kZero = 15;  // k code of an all-zero segment (8/10-bit)
constexpr int kKmax = 9;   // widest remainder (k in 0..9)
constexpr int kUcap = 24;  // unary words cap per segment
__constant__ int kUcls[7] = {8, 10, 12, 14, 16, 20, 24};

// ---------------------------------------------------------------------------
// B0: (hi << 2 | lo2) << 6 over the dense upload, both planes in one
// launch (blockIdx.y picks y or uv).
// ---------------------------------------------------------------------------

struct DensePlane {
  const uint8_t* hi;    // one byte per sample, 4-byte aligned
  const uint8_t* lob;   // one byte per 4 samples, 2 bits each
  uint2* out;           // 4 int16 samples per thread
  long long quads;
};

__global__ void dense_kernel(DensePlane y, DensePlane uv) {
  // Select field by field: a reference to one of the two parameters
  // makes the compiler copy both to the stack in every thread.
  const bool is_uv = blockIdx.y != 0;
  const long long quads = is_uv ? uv.quads : y.quads;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  uint32_t h4 = ((const uint32_t*)(is_uv ? uv.hi : y.hi))[i];
  uint32_t lo = (is_uv ? uv.lob : y.lob)[i];
  uint32_t v[4];
  for (int e = 0; e < 4; ++e)
    v[e] = ((((h4 >> (8 * e)) & 255u) << 2) | ((lo >> (2 * e)) & 3u)) << 6;
  (is_uv ? uv.out : y.out)[i] =
      make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// ---------------------------------------------------------------------------
// B14: the segment-packed upload -> MSB-aligned y (n, h, w) and uv
// (n, h/2, w) int16 (u16 bits). Blob: [bucket 2][bucket 5][bucket 10]
// [perm], perm[row * nsegw + s] = 0 for an all-zero segment, else the
// 1-based row in the bucket order; sample j of a segment sits in word
// j % nw at shift (j / nw) * bw.
// ---------------------------------------------------------------------------

struct SegPlan {
  int rows, w, nsegw, yrows;
  int n2, n5;
  long long off5, off10, offperm;
};

__global__ void seg_kernel(const uint32_t* __restrict__ blob, SegPlan p,
                           uint16_t* __restrict__ y,
                           uint16_t* __restrict__ uv) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= p.w) return;
  const int s = x >> 8, j = x & (kL - 1);
  const int32_t* perm = (const int32_t*)(blob + p.offperm);
  int acc = 0;
  for (int i = 0; i < kG; ++i) {
    const int r = blockIdx.y * kG + i;
    int row = perm[(long long)r * p.nsegw + s];
    uint32_t z = 0;
    if (row > 0) {
      row -= 1;
      int bw, nw;
      long long base;
      if (row < p.n2) {
        bw = 2, nw = 16, base = 0;
      } else if ((row -= p.n2) < p.n5) {
        bw = 5, nw = 43, base = p.off5;
      } else {
        row -= p.n5;
        bw = 10, nw = 86, base = p.off10;
      }
      uint32_t word = blob[base + (long long)row * nw + j % nw];
      z = (word >> ((j / nw) * bw)) & ((1u << bw) - 1u);
    }
    acc += (int)(z >> 1) ^ -(int)(z & 1u);
    const uint16_t v = (uint16_t)((acc & 1023) << 6);
    if (r < p.yrows)
      y[(long long)r * p.w + x] = v;
    else
      uv[(long long)(r - p.yrows) * p.w + x] = v;
  }
}

// ---------------------------------------------------------------------------
// B15: Rice pass 1 over a u8 composite of `rows` rows of width w (the
// planar readback: the three "planes" are the composite's thirds, so the
// decorrelation is the identity), columns edge-padded to nsegw * 256.
// mode 0: vertical deltas, 1: MED, 2: both (vertical into zs0 and map
// rows 0-1, MED into zs1 and rows 2-3). Map rows: [k code, unary words].
// ---------------------------------------------------------------------------

__device__ __forceinline__ int zigzag8(int d) {
  const int ds = ((d + 128) & 255) - 128;
  return (ds << 1) ^ (ds >> 31);
}

// Sum over the CTA's 256 threads of v[0..9]; the result in tot[] of
// thread 0.
__device__ __forceinline__ void reduce10(int* v, int (*part)[10], int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 10; ++k) {
    int x = v[k];
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < 10; ++k) {
      int s = 0;
      for (int w = 0; w < 8; ++w) s += part[w][k];
      tot[k] = s;
    }
  __syncthreads();
}

// JAX _rice_seg_stats: the k with the fewest bits among those whose
// unary part fits kUcap words (strict < keeps the smallest k).
__device__ __forceinline__ void pick_k(const int* sq, uint8_t* kc,
                                       uint8_t* uw) {
  int best_bits = 1 << 30, best_k = 0, best_uw = 0;
  for (int k = 0; k < 10; ++k) {
    const int uwk = (sq[k] + kL + 31) >> 5;
    const int bits = sq[k] + kL * (1 + k);
    if (uwk <= kUcap && bits < best_bits) {
      best_bits = bits, best_k = k, best_uw = uwk;
    }
  }
  const bool zero = sq[0] == 0;
  *kc = (uint8_t)(zero ? kZero : best_k);
  *uw = (uint8_t)(zero ? 0 : best_uw);
}

__global__ void __launch_bounds__(256)
stats_kernel(const uint8_t* __restrict__ comp, int w, int nsegw, int mode,
             long long nseg, int16_t* __restrict__ zs0,
             int16_t* __restrict__ zs1, uint8_t* __restrict__ maps) {
  __shared__ int part[8][10];
  __shared__ int tot[10];
  const long long q = blockIdx.x;
  const long long r = q / nsegw;
  const int x = (int)(q % nsegw) * kL + threadIdx.x;
  const uint8_t* row = comp + r * w;
  const uint8_t* up_row = row - w;
  const bool gstart = r % kG == 0;
  const int xc = min(x, w - 1), xl = min(x - 1, w - 1);
  const int cur = row[xc];
  const int up = gstart ? 0 : up_row[xc];
  const long long o = q * kL + threadIdx.x;
  int v[10];
  int m = 0;
  for (int scheme = 0; scheme < 2; ++scheme) {
    const bool med = scheme == 1;
    if ((mode == 0 && med) || (mode == 1 && !med)) continue;
    int pred = up;
    if (med) {
      const int left = x == 0 ? 0 : row[xl];
      const int ul = (gstart || x == 0) ? 0 : up_row[xl];
      const int mx = max(left, up), mn = min(left, up);
      pred = ul >= mx ? mn : (ul <= mn ? mx : left + up - ul);
    }
    const int z = zigzag8((cur - pred) & 255);
    (m == 0 ? zs0 : zs1)[o] = (int16_t)z;
    for (int k = 0; k < 10; ++k) v[k] = z >> k;
    reduce10(v, part, tot);
    if (threadIdx.x == 0)
      pick_k(tot, maps + (2 * m) * nseg + q, maps + (2 * m + 1) * nseg + q);
    ++m;
  }
}

// ---------------------------------------------------------------------------
// B16 order: ranks of the remainder family (k, the all-zero class last:
// 11 ranks) and of the unary family (word-count class, all-zero last: 8
// ranks) -> each segment's place in the stable (rank, index) order.
// ---------------------------------------------------------------------------

struct RicePads {
  int rem[10];  // pow2-padded rows of each remainder bucket (k = 0..9)
  int un[7];    // ... of each unary class
};

constexpr int kRanks = 19;  // 11 remainder ranks, then 8 unary ranks

__device__ __forceinline__ void ranks_of(uint8_t kc, uint8_t uw, int* rr,
                                         int* ur) {
  if (kc == kZero) {
    *rr = 10, *ur = 7;
    return;
  }
  *rr = kc;
  int c = 0;
  while (c < 7 && kUcls[c] < uw) ++c;  // searchsorted, left side
  *ur = c;
}

__global__ void __launch_bounds__(1024)
order_kernel(const uint8_t* __restrict__ kmap,
             const uint8_t* __restrict__ uwmap, int nseg,
             int32_t* __restrict__ sidx_rem, int32_t* __restrict__ sidx_un,
             int32_t* offs, uint32_t* head, int med, RicePads pads,
             uint8_t* pad_bytes, int npad_bytes) {
  __shared__ int cnt[32][kRanks];
  __shared__ int total[kRanks];
  __shared__ int base[kRanks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int per = (nseg + 31) / 32;
  const int lo = warp * per, hi = min(lo + per, nseg);
  if (lane < kRanks) cnt[warp][lane] = 0;
  __syncwarp();
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    int rr = -1, ur = -1;
    if (i < hi) ranks_of(kmap[i], uwmap[i], &rr, &ur);
    unsigned mr = __match_any_sync(0xffffffffu, rr);
    unsigned mu = __match_any_sync(0xffffffffu, ur + 11);
    if (rr >= 0 && (mr & lt) == 0) cnt[warp][rr] += __popc(mr);
    if (ur >= 0 && (mu & lt) == 0) cnt[warp][11 + ur] += __popc(mu);
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x < kRanks) {
    int run = 0;
    for (int w = 0; w < 32; ++w) {
      const int c = cnt[w][threadIdx.x];
      cnt[w][threadIdx.x] = run;
      run += c;
    }
    total[threadIdx.x] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int r = 0; r < 11; ++r) base[r] = b, b += total[r];
    b = 0;
    for (int r = 11; r < kRanks; ++r) base[r] = b, b += total[r];
    if (offs) {
      for (int r = 0; r < 10; ++r) offs[r] = base[r];
      for (int c = 0; c < 7; ++c) offs[10 + c] = base[11 + c];
    }
    if (head) {
      bool fit = true;
      for (int r = 0; r < 10; ++r) fit = fit && total[r] <= pads.rem[r];
      for (int c = 0; c < 7; ++c) fit = fit && total[11 + c] <= pads.un[c];
      head[0] = fit ? 1u : 0u;
      head[1] = (uint32_t)med;
      for (int r = 0; r < kRanks; ++r) head[2 + r] = (uint32_t)total[r];
    }
    for (int e = 0; e < npad_bytes; ++e) pad_bytes[e] = 0;
  }
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    int rr = -1, ur = -1;
    if (i < hi) ranks_of(kmap[i], uwmap[i], &rr, &ur);
    unsigned mr = __match_any_sync(0xffffffffu, rr);
    unsigned mu = __match_any_sync(0xffffffffu, ur + 11);
    if (rr >= 0)
      sidx_rem[base[rr] + cnt[warp][rr] + __popc(mr & lt)] = i;
    if (ur >= 0)
      sidx_un[base[11 + ur] + cnt[warp][11 + ur] + __popc(mu & lt)] = i;
    __syncwarp();
    if (rr >= 0 && (mr & lt) == 0) cnt[warp][rr] += __popc(mr);
    if (ur >= 0 && (mu & lt) == 0) cnt[warp][11 + ur] += __popc(mu);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// B16 emit: one warp per output row. Bucket b < 9 is the remainder bucket
// of k = b + 1 (sample j of the segment, masked to k bits, in word j % nw
// at shift (j / nw) * k); bucket b >= 9 is unary class b - 9 (bit p of
// the row for each terminator position p = cumsum(q + 1) - 1, q = z >>
// min(k code, 9); positions past the class's words are dropped). Row r of
// bucket b packs the segment at place offs[...] + r of its family's
// order, segment 0 past the end (JAX's zero tail pad).
// ---------------------------------------------------------------------------

struct RiceRows {
  int start[17];        // first row of each bucket; start[16] = all rows
  int nw[16];           // words per row
  long long woff[16];   // first word of each bucket in the blob
};

__global__ void __launch_bounds__(256)
emit_kernel(const uint16_t* __restrict__ zs, const uint8_t* __restrict__ kmap,
            const int32_t* __restrict__ sidx_rem,
            const int32_t* __restrict__ sidx_un,
            const int32_t* __restrict__ offs, int nseg, RiceRows rows,
            uint32_t* __restrict__ blob) {
  __shared__ uint32_t words[8][96];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = blockIdx.x * 8 + warp;
  if (R >= rows.start[16]) return;
  int b = 0;
  while (R >= rows.start[b + 1]) ++b;
  const int r = R - rows.start[b];
  const int nw = rows.nw[b];
  uint32_t* sw = words[warp];
  for (int i = lane; i < nw; i += 32) sw[i] = 0u;
  const bool rem = b < 9;
  // offs: remainder buckets k = 0..9 at [0, 10), unary classes at
  // [10, 17); bucket b is entry k = b + 1, or 10 + (b - 9): b + 1 both.
  const int pos = offs[b + 1] + r;
  const int idx = pos < nseg ? (rem ? sidx_rem[pos] : sidx_un[pos]) : 0;
  const uint4 raw = *(const uint4*)(zs + (long long)idx * kL + lane * 8);
  const uint32_t pair[4] = {raw.x, raw.y, raw.z, raw.w};
  int z[8];
  for (int e = 0; e < 8; ++e) z[e] = (pair[e >> 1] >> (16 * (e & 1))) & 0xFFFF;
  __syncwarp();
  if (rem) {
    const int k = b + 1;
    const uint32_t mask = (1u << k) - 1u;
    for (int e = 0; e < 8; ++e) {
      const int j = lane * 8 + e;
      atomicOr(&sw[j % nw], ((uint32_t)z[e] & mask) << ((j / nw) * k));
    }
  } else {
    const int kk = min((int)kmap[idx], kKmax);
    int incl = 0;
    for (int e = 0; e < 8; ++e) incl += (z[e] >> kk) + 1;
    int scan = incl;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, scan, d);
      if (lane >= d) scan += t;
    }
    int p = scan - incl - 1;
    for (int e = 0; e < 8; ++e) {
      p += (z[e] >> kk) + 1;
      if ((p >> 5) < nw) atomicOr(&sw[p >> 5], 1u << (p & 31));
    }
  }
  __syncwarp();
  uint32_t* out = blob + rows.woff[b] + (long long)r * nw;
  for (int i = lane; i < nw; i += 32) out[i] = sw[i];
}

// ---------------------------------------------------------------------------
// B18: the u8 composite [Y | U|V side by side | gain map], each part
// edge-padded to wc columns, rows padded to `rows` by repeating the last.
// ---------------------------------------------------------------------------

__global__ void composite_kernel(Plane yp, Plane up, Plane vp, Plane gp,
                                 int h, int w, int ch, int cw, int gh, int gw,
                                 int rows, int wc, uint8_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y, b = blockIdx.z;
  if (x >= wc) return;
  uint8_t v;
  if (r < h) {
    v = yp.at(b, r, min(x, w - 1));
  } else if (r < h + ch) {
    const int rr = r - h;
    v = x < cw ? up.at(b, rr, x) : vp.at(b, rr, min(x - cw, cw - 1));
  } else {
    v = gp.at(b, min(r - h - ch, gh - 1), min(x, gw - 1));
  }
  out[((long long)b * rows + r) * wc + x] = v;
}

inline int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

}  // namespace

extern "C" {

// B0. y hi/lob, uv hi/lob, y out, uv out: counts of 4-sample quads.
int uhdr_p010_dense_unpack(const void* yhi, const void* ylo, const void* uhi,
                           const void* ulo, void* yout, void* uvout,
                           long long yquads, long long uvquads,
                           void* stream) {
  DensePlane y{(const uint8_t*)yhi, (const uint8_t*)ylo, (uint2*)yout,
               yquads};
  DensePlane uv{(const uint8_t*)uhi, (const uint8_t*)ulo, (uint2*)uvout,
                uvquads};
  dim3 grid(blocks(yquads > uvquads ? yquads : uvquads, 256), 2);
  dense_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(y, uv);
  return (int)cudaGetLastError();
}

// B14. blob: the fused u32 blob; rows (a multiple of 32) x w tall plane
// of which the first yrows are y; n2/n5/n10 the padded bucket rows.
int uhdr_p010_seg_unpack(const void* blob, int rows, int w, int nsegw,
                         int yrows, int n2, int n5, int n10, void* y,
                         void* uv, void* stream) {
  SegPlan p{rows, w, nsegw, yrows, n2, n5,
            (long long)n2 * 16, (long long)n2 * 16 + (long long)n5 * 43,
            (long long)n2 * 16 + (long long)n5 * 43 + (long long)n10 * 86};
  dim3 grid(blocks(w, 256), rows / kG);
  seg_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blob, p, (uint16_t*)y, (uint16_t*)uv);
  return (int)cudaGetLastError();
}

// B15. comp: rows x w u8; zs0/zs1: (nseg, 256) int16 (zs1 only in mode
// 2); maps: (2 or 4, nseg) u8.
int uhdr_rice_stats(const void* comp, long long rows, int w, int nsegw,
                    int mode, void* zs0, void* zs1, void* maps,
                    void* stream) {
  const long long nseg = rows * nsegw;
  stats_kernel<<<(unsigned)nseg, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, w, nsegw, mode, nseg, (int16_t*)zs0,
      (int16_t*)zs1, (uint8_t*)maps);
  return (int)cudaGetLastError();
}

// B16 order. kmap/uwmap: nseg u8 each; sidx_rem/sidx_un: nseg int32 out;
// offs: 17 int32 out or null; head: 21 u32 out or null (with the pads
// for its fit flag); pad: bytes to zero after the map (fused layout).
int uhdr_rice_order(const void* kmap, const void* uwmap, int nseg,
                    void* sidx_rem, void* sidx_un, void* offs, void* head,
                    int med, const int* rem_pads, const int* un_pads,
                    void* pad, int npad, void* stream) {
  RicePads pads;
  for (int j = 0; j < 10; ++j) pads.rem[j] = rem_pads[j];
  for (int c = 0; c < 7; ++c) pads.un[c] = un_pads[c];
  order_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)kmap, (const uint8_t*)uwmap, nseg, (int32_t*)sidx_rem,
      (int32_t*)sidx_un, (int32_t*)offs, (uint32_t*)head, med, pads,
      (uint8_t*)pad, npad);
  return (int)cudaGetLastError();
}

// B16 emit. zs: (nseg, 256) int16; kmap: nseg u8; offs: 17 int32 on the
// device; start (17), nw (16), woff (16): the bucket rows, host arrays.
int uhdr_rice_emit(const void* zs, const void* kmap, const void* sidx_rem,
                   const void* sidx_un, const void* offs, int nseg,
                   const int* start, const int* nw, const long long* woff,
                   void* blob, void* stream) {
  RiceRows rows;
  for (int b = 0; b < 17; ++b) rows.start[b] = start[b];
  for (int b = 0; b < 16; ++b) rows.nw[b] = nw[b], rows.woff[b] = woff[b];
  if (rows.start[16] == 0) return 0;
  emit_kernel<<<blocks(rows.start[16], 8), 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)zs, (const uint8_t*)kmap, (const int32_t*)sidx_rem,
      (const int32_t*)sidx_un, (const int32_t*)offs, nseg, rows,
      (uint32_t*)blob);
  return (int)cudaGetLastError();
}

// B18. y/u/v/g: u8 planes with (batch, row) strides in bytes and unit
// column stride; out: (n, rows, wc) u8.
int uhdr_planes_composite(const void* y, const void* u, const void* v,
                          const void* g, long long ysb, long long ysr,
                          long long usb, long long usr, long long vsb,
                          long long vsr, long long gsb, long long gsr,
                          void* out, int n, int h, int w, int ch, int cw,
                          int gh, int gw, int rows, int wc, void* stream) {
  Plane yp{(const uint8_t*)y, ysb, ysr}, up{(const uint8_t*)u, usb, usr};
  Plane vp{(const uint8_t*)v, vsb, vsr}, gp{(const uint8_t*)g, gsb, gsr};
  dim3 grid(blocks(wc, 256), rows, n);
  composite_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      yp, up, vp, gp, h, w, ch, cw, gh, gw, rows, wc, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
