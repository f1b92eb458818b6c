// The packed host<->device transfers of the serving loop, for the port's
// parallel/packio.py, and the planes composite of ops/gainmap.py:
//
//   B0   uhdr_p010_dense_unpack   sharding.py:61 _unpack_p010_device
//                                 (the dense upload: hi8 + 2-bit tails)
//   B14  uhdr_p010_seg_unpack     packio.py:216 _unpack_fn, with the
//                                 split of sharding.py:71 fused in
//   B15  uhdr_rice_stats          packio.py:421-491, 650-732 (Rice pass 1
//                                 at 8, 10 and 16 bits: decorrelation,
//                                 residuals, per-segment k)
//   B16  uhdr_rice_order          packio.py:749-954 (Rice pack: the
//        uhdr_rice_emit           stable rank order, then the buckets)
//   B17  uhdr_rct_widths          packio.py:509 _rct_widths_fn, :535
//        uhdr_rct_pack            _rct_devpack_fn (the RCT fine-width
//                                 readback)
//   B18  uhdr_planes_composite    ops/gainmap.py:264 planes_composite
//   B21  uhdr_plane_widths        packio.py:269 _widths_fn, :299
//        uhdr_plane_pack          _devpack_fn (a 10-bit plane's pack)
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
//   thread forms its residual from the source in place. The pixel
//   formats' channels are split and decorrelated on the load, so the
//   stacked (G, R-G, B-G) planes are never stored, and the column edge
//   padding is an index clamp. The block reduces the 10 (or 16) k costs
//   with warp shuffles, and thread 0 picks k. Both schemes share the one
//   read of the source.
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
// - B17 is B15's load (one warp per 64-sample segment, the maximum by
//   __reduce_max_sync), B16's one-CTA counting order over the 9 width
//   ranks, and B16's warp-per-row emit.
// - B21 is B17's design on one 10-bit plane with 256-sample segments; the
//   host's gather index replaces the order.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

using uhdr::Plane;

constexpr int kL = 256;   // samples per segment
constexpr int kG = 32;    // rows per delta group
constexpr int kZero = 15;  // k code of an all-zero segment (8/10-bit)
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
// B15: Rice pass 1. The source is a u8 composite (bits 8: the planar
// readback, whose three "planes" are the composite's thirds), an (n, h,
// w) u32 RGBA1010102 batch (bits 10) or an (n, h, w, 4) u16 F16-halves
// batch (bits 16); the two pixel formats are decorrelated on the load
// into the stacked planes (G, R-G, B-G mod 2^bits) of 3 * n * h rows.
// Columns are edge-padded to nsegw * 256. mode 0: vertical deltas, 1:
// MED, 2: both (vertical into zs0 and map rows 0-1, MED into zs1 and rows
// 2-3). Map rows: [k code, unary words].
// ---------------------------------------------------------------------------

struct PixSrc {
  const void* p;
  long long nh;  // rows of one stacked plane (n * h)
  int w;
};

// Stacked-plane sample (row r, column x) of BITS-bit samples (8: the
// composite, 10: RGBA1010102 words, 16: F16 halves); x is already
// clamped.
template <int BITS>
__device__ __forceinline__ int pix_at(const PixSrc& s, long long r, int x) {
  if (BITS == 8) return ((const uint8_t*)s.p)[r * s.w + x];
  const int plane = (int)(r / s.nh);
  const long long o = (r - plane * s.nh) * s.w + x;
  int rr, gg, bb;
  if (BITS == 10) {
    const uint32_t v = ((const uint32_t*)s.p)[o];
    rr = v & 1023, gg = (v >> 10) & 1023, bb = (v >> 20) & 1023;
  } else {
    const uint2 v = ((const uint2*)s.p)[o];
    rr = v.x & 0xFFFF, gg = v.x >> 16, bb = v.y & 0xFFFF;
  }
  return plane == 0 ? gg : ((plane == 1 ? rr : bb) - gg) & ((1 << BITS) - 1);
}

__device__ __forceinline__ int zigzag_bits(int d, int bits) {
  const int mask = (1 << bits) - 1, half = 1 << (bits - 1);
  const int ds = ((d + half) & mask) - half;
  return (ds << 1) ^ (ds >> 31);
}

// Sum over the CTA's 256 threads of v[0..nk); the result in tot[] of
// every thread.
__device__ __forceinline__ void reduce_k(int* v, int nk, int (*part)[16],
                                         int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < nk; ++k) {
    int x = v[k];
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < nk) {
    int s = 0;
    for (int w = 0; w < 8; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// JAX _rice_seg_stats: the k with the fewest bits among those whose
// unary part fits kUcap words (strict < keeps the smallest k).
__device__ __forceinline__ void pick_k(const int* sq, int nk, int zero_code,
                                       uint8_t* kc, uint8_t* uw) {
  int best_bits = 1 << 30, best_k = 0, best_uw = 0;
  for (int k = 0; k < nk; ++k) {
    const int uwk = (sq[k] + kL + 31) >> 5;
    const int bits = sq[k] + kL * (1 + k);
    if (uwk <= kUcap && bits < best_bits) {
      best_bits = bits, best_k = k, best_uw = uwk;
    }
  }
  const bool zero = sq[0] == 0;
  *kc = (uint8_t)(zero ? zero_code : best_k);
  *uw = (uint8_t)(zero ? 0 : best_uw);
}

template <int BITS>
__global__ void __launch_bounds__(256)
stats_kernel(PixSrc src, int nsegw, int mode, long long nseg,
             int16_t* __restrict__ zs0, int16_t* __restrict__ zs1,
             uint8_t* __restrict__ maps) {
  __shared__ int part[8][16];
  __shared__ int tot[16];
  constexpr int bits = BITS;
  constexpr int nk = bits == 16 ? 16 : 10;
  constexpr int zero_code = bits == 16 ? 31 : kZero;
  const long long q = blockIdx.x;
  const long long r = q / nsegw;
  const int w = src.w;
  const int x = (int)(q % nsegw) * kL + threadIdx.x;
  const bool gstart = r % kG == 0;
  const int xc = min(x, w - 1), xl = min(x - 1, w - 1);
  const int cur = pix_at<BITS>(src, r, xc);
  const int up = gstart ? 0 : pix_at<BITS>(src, r - 1, xc);
  const long long o = q * kL + threadIdx.x;
  constexpr int mask = (1 << bits) - 1;
  int v[16];
  int m = 0;
  for (int scheme = 0; scheme < 2; ++scheme) {
    const bool med = scheme == 1;
    if ((mode == 0 && med) || (mode == 1 && !med)) continue;
    int pred = up;
    if (med) {
      const int left = x == 0 ? 0 : pix_at<BITS>(src, r, xl);
      const int ul = (gstart || x == 0) ? 0 : pix_at<BITS>(src, r - 1, xl);
      const int mx = max(left, up), mn = min(left, up);
      pred = ul >= mx ? mn : (ul <= mn ? mx : left + up - ul);
    }
    const int z = zigzag_bits((cur - pred) & mask, bits);
    (m == 0 ? zs0 : zs1)[o] = (int16_t)z;
    for (int k = 0; k < nk; ++k) v[k] = z >> k;
    reduce_k(v, nk, part, tot);
    if (threadIdx.x == 0)
      pick_k(tot, nk, zero_code, maps + (2 * m) * nseg + q,
             maps + (2 * m + 1) * nseg + q);
    ++m;
  }
}

// ---------------------------------------------------------------------------
// Stable (rank, index) order by counting: one CTA of 1024 threads, a
// warp per contiguous range of the `n` items. Per-warp rank counts
// (__match_any_sync groups the lanes of one rank), an exclusive scan over
// warps, then each item's place. JAX computes the same order with
// jnp.sort of (rank << 22) | index. RankFn(i, fam) gives item i's rank in
// family fam (or -1 for none); a family's places start at base[] of its
// first rank and run through its ranks in order.
// ---------------------------------------------------------------------------

constexpr int kMaxRanks = 25;  // 17 remainder ranks + 8 unary ranks

template <class RankFn>
__device__ void count_ranks(int n, int nfam, const RankFn& rank_of,
                            int (*cnt)[kMaxRanks], int nranks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int per = (n + 31) / 32;
  const int lo = warp * per, hi = min(lo + per, n);
  if (lane < nranks) cnt[warp][lane] = 0;
  __syncwarp();
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    for (int f = 0; f < nfam; ++f) {
      const int rk = i < hi ? rank_of(i, f) : -1;
      const unsigned mr = __match_any_sync(0xffffffffu, rk);
      if (rk >= 0 && (mr & lt) == 0) cnt[warp][rk] += __popc(mr);
      __syncwarp();
    }
  }
  __syncthreads();
  if (threadIdx.x < nranks) {
    int run = 0;
    for (int w = 0; w < 32; ++w) {
      const int c = cnt[w][threadIdx.x];
      cnt[w][threadIdx.x] = run;
      run += c;
    }
    cnt[32][threadIdx.x] = run;  // the rank's total
  }
  __syncthreads();
}

template <class RankFn, class PlaceFn>
__device__ void place_ranks(int n, int nfam, const RankFn& rank_of,
                            int (*cnt)[kMaxRanks], const int* base,
                            const PlaceFn& place) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int per = (n + 31) / 32;
  const int lo = warp * per, hi = min(lo + per, n);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    for (int f = 0; f < nfam; ++f) {
      const int rk = i < hi ? rank_of(i, f) : -1;
      const unsigned mr = __match_any_sync(0xffffffffu, rk);
      if (rk >= 0) place(f, base[rk] + cnt[warp][rk] + __popc(mr & lt), i);
      __syncwarp();
      if (rk >= 0 && (mr & lt) == 0) cnt[warp][rk] += __popc(mr);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// B16 order: ranks of the remainder family (k = 0..nk-1, the all-zero
// class last: nk + 1 ranks) and of the unary family (word-count class,
// all-zero last: 8 ranks, numbered after the remainder ranks) -> each
// segment's place in the stable (rank, index) order of both families.
// nk = 10 for 8- and 10-bit samples (zero code 15), 16 for 16-bit ones
// (zero code 31).
// ---------------------------------------------------------------------------

struct RicePads {
  int rem[16];  // pow2-padded rows of each remainder bucket (k < nk)
  int un[7];    // ... of each unary class
};

template <int NK>
__global__ void __launch_bounds__(1024)
order_kernel(const uint8_t* __restrict__ kmap,
             const uint8_t* __restrict__ uwmap, int nseg,
             int32_t* __restrict__ sidx_rem, int32_t* __restrict__ sidx_un,
             int32_t* offs, uint32_t* head, int med, RicePads pads,
             uint8_t* pad_bytes, int npad_bytes) {
  __shared__ int cnt[33][kMaxRanks];
  __shared__ int base[kMaxRanks];
  constexpr int nk = NK;
  constexpr int zero_code = nk == 16 ? 31 : kZero;
  constexpr int nrem = nk + 1, nranks = nk + 9;
  auto rank_of = [&](int i, int fam) {
    const int kc = kmap[i];
    if (fam == 0) return kc == zero_code ? nk : kc;
    if (kc == zero_code) return nrem + 7;
    const int uw = uwmap[i];
    int c = 0;
    while (c < 7 && kUcls[c] < uw) ++c;  // searchsorted, left side
    return nrem + c;
  };
  count_ranks(nseg, 2, rank_of, cnt, nranks);
  if (threadIdx.x == 0) {
    int b = 0;
    for (int r = 0; r < nrem; ++r) base[r] = b, b += cnt[32][r];
    b = 0;
    for (int r = nrem; r < nranks; ++r) base[r] = b, b += cnt[32][r];
    if (offs) {
      for (int r = 0; r < nk; ++r) offs[r] = base[r];
      for (int c = 0; c < 7; ++c) offs[nk + c] = base[nrem + c];
    }
    if (head) {
      bool fit = true;
      for (int r = 0; r < nk; ++r) fit = fit && cnt[32][r] <= pads.rem[r];
      for (int c = 0; c < 7; ++c)
        fit = fit && cnt[32][nrem + c] <= pads.un[c];
      head[0] = fit ? 1u : 0u;
      head[1] = (uint32_t)med;
      for (int r = 0; r < nranks; ++r) head[2 + r] = (uint32_t)cnt[32][r];
    }
    for (int e = 0; e < npad_bytes; ++e) pad_bytes[e] = 0;
  }
  __syncthreads();
  place_ranks(nseg, 2, rank_of, cnt, base, [&](int fam, int pos, int i) {
    (fam == 0 ? sidx_rem : sidx_un)[pos] = i;
  });
}

// ---------------------------------------------------------------------------
// B16 emit: one warp per output row. Bucket b < nk - 1 is the remainder
// bucket of k = b + 1 (sample j of the segment, masked to k bits, in word
// j % nw at shift (j / nw) * k); bucket b >= nk - 1 is unary class
// b - nk + 1 (bit p of the row for each terminator position p =
// cumsum(q + 1) - 1, q = z >> min(k code, nk - 1); positions past the
// class's words are dropped). Row r of bucket b packs the segment at
// place offs[...] + r of its family's order, segment 0 past the end
// (JAX's zero tail pad).
// ---------------------------------------------------------------------------

struct RiceRows {
  int start[23];        // first row of each bucket; start[nb] = all rows
  int nw[22];           // words per row
  long long woff[22];   // first word of each bucket in the blob
};

__global__ void __launch_bounds__(256)
emit_kernel(const uint16_t* __restrict__ zs, const uint8_t* __restrict__ kmap,
            const int32_t* __restrict__ sidx_rem,
            const int32_t* __restrict__ sidx_un,
            const int32_t* __restrict__ offs, int nseg, int nk, RiceRows rows,
            uint32_t* __restrict__ blob) {
  __shared__ uint32_t words[8][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = nk + 6;
  const int R = blockIdx.x * 8 + warp;
  if (R >= rows.start[nb]) return;
  int b = 0;
  while (R >= rows.start[b + 1]) ++b;
  const int r = R - rows.start[b];
  const int nw = rows.nw[b];
  uint32_t* sw = words[warp];
  for (int i = lane; i < nw; i += 32) sw[i] = 0u;
  const bool rem = b < nk - 1;
  // offs: remainder buckets k = 0..nk-1 at [0, nk), unary classes at
  // [nk, nk + 7); bucket b is entry k = b + 1, or nk + (b - nk + 1): b + 1
  // both.
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
    const int kk = min((int)kmap[idx], nk - 1);
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
// B17: the RCT fine-width readback of an (n, h, w) u32 RGBA1010102 batch.
// Pass 1 (rct_widths_kernel): one warp per 64-sample segment of the
// stacked (G, R-G, B-G) planes, two samples a lane: zigzag vertical
// deltas mod 1024 (32-row groups) into zs and the segment's width code,
// the least of {1,2,3,4,5,6,8,10} that holds its largest delta (0 for an
// all-zero segment). Order (rct_order_kernel): the stable (rank, index)
// order of the segments, rank = place of the width in {0,1,2,3,4,5,6,8,
// 10}. Pack (fine_pack_kernel): one warp per output row of the 8 width
// buckets, the row's segment at place offs[bucket] + row of the order
// (segment 0 past the end); sample j in word j % nw at shift
// (j / nw) * width, summed as JAX sums the slots (unmasked: a padding
// row's wider samples carry, as in JAX).
// ---------------------------------------------------------------------------

constexpr int kLF = 64;
__constant__ int kFine[8] = {1, 2, 3, 4, 5, 6, 8, 10};

__global__ void __launch_bounds__(256)
rct_widths_kernel(PixSrc src, int nsegw, long long nseg,
                  uint16_t* __restrict__ zs, uint8_t* __restrict__ bc) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (q >= nseg) return;
  const long long r = q / nsegw;
  const bool gstart = r % kG == 0;
  int zmax = 0;
  uint32_t pair = 0;
  for (int e = 0; e < 2; ++e) {
    const int x = min((int)(q % nsegw) * kLF + lane * 2 + e, src.w - 1);
    const int cur = pix_at<10>(src, r, x);
    const int up = gstart ? 0 : pix_at<10>(src, r - 1, x);
    const int z = zigzag_bits((cur - up) & 1023, 10);
    zmax = max(zmax, z);
    pair |= (uint32_t)z << (16 * e);
  }
  ((uint32_t*)zs)[q * (kLF / 2) + lane] = pair;
  zmax = __reduce_max_sync(0xffffffffu, zmax);
  if (lane == 0) {
    int code = 0;
    if (zmax > 0) {
      int c = 0;
      while (zmax > (1 << kFine[c]) - 1) ++c;
      code = kFine[c];
    }
    bc[q] = (uint8_t)code;
  }
}

// Width code {0,1,2,3,4,5,6,8,10} -> rank 0..8 (JAX: code - (code > 6)
// - (code > 8)).
__device__ __forceinline__ int fine_rank(int code) {
  return code - (code > 6) - (code > 8);
}

__global__ void __launch_bounds__(1024)
rct_order_kernel(const uint8_t* __restrict__ bc, int nseg,
                 int32_t* __restrict__ sidx) {
  __shared__ int cnt[33][kMaxRanks];
  __shared__ int base[kMaxRanks];
  auto rank_of = [&](int i, int) { return fine_rank(bc[i]); };
  count_ranks(nseg, 1, rank_of, cnt, 9);
  if (threadIdx.x == 0) {
    int b = 0;
    for (int r = 0; r < 9; ++r) base[r] = b, b += cnt[32][r];
  }
  __syncthreads();
  place_ranks(nseg, 1, rank_of, cnt, base,
              [&](int, int pos, int i) { sidx[pos] = i; });
}

struct FineRows {
  int start[9];         // first row of each bucket; start[8] = all rows
  int offs[8];          // first place of each bucket in the order
  long long woff[8];    // first word of each bucket in the blob
};

__global__ void __launch_bounds__(256)
fine_pack_kernel(const uint16_t* __restrict__ zs,
                 const int32_t* __restrict__ sidx, int nseg, FineRows rows,
                 uint32_t* __restrict__ blob) {
  __shared__ uint32_t words[8][22];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = blockIdx.x * 8 + warp;
  if (R >= rows.start[8]) return;
  int b = 0;
  while (R >= rows.start[b + 1]) ++b;
  const int r = R - rows.start[b];
  const int bw = kFine[b];
  const int nw = (kLF + 32 / bw - 1) / (32 / bw);
  uint32_t* sw = words[warp];
  if (lane < nw) sw[lane] = 0u;
  const int pos = rows.offs[b] + r;
  const int idx = pos < nseg ? sidx[pos] : 0;
  const uint32_t pair = ((const uint32_t*)zs)[(long long)idx * (kLF / 2) + lane];
  __syncwarp();
  for (int e = 0; e < 2; ++e) {
    const int j = lane * 2 + e;
    atomicAdd(&sw[j % nw], ((pair >> (16 * e)) & 0xFFFFu) << ((j / nw) * bw));
  }
  __syncwarp();
  if (lane < nw) blob[rows.woff[b] + (long long)r * nw + lane] = sw[lane];
}

// ---------------------------------------------------------------------------
// B21: the device pack of a 10-bit (H, W) plane for readback, the inverse
// of B14's layout. Widths (plane_widths_kernel): one CTA per 256-sample
// segment, one thread per sample: the zigzag vertical delta mod 1024
// (32-row groups) into zs, columns edge-padded, and the segment's width
// code in {0, 2, 5, 10}. Pack (plane_pack_kernel): one warp per output
// row of the three buckets; the host's gather index names the row's
// segment (JAX uploads the same); sample j in word j % nw at shift
// (j / nw) * width, the slots summed as JAX sums them.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
plane_widths_kernel(const uint16_t* __restrict__ arr, int w, int nsegw,
                    uint16_t* __restrict__ zs, uint8_t* __restrict__ bc) {
  __shared__ int wmax[8];
  const long long q = blockIdx.x;
  const long long r = q / nsegw;
  const int x = min((int)(q % nsegw) * kL + (int)threadIdx.x, w - 1);
  const int cur = arr[r * w + x];
  const int up = r % kG == 0 ? 0 : arr[(r - 1) * w + x];
  const int z = zigzag_bits((cur - up) & 1023, 10);
  zs[q * kL + threadIdx.x] = (uint16_t)z;
  const int m = __reduce_max_sync(0xffffffffu, z);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int zmax = 0;
    for (int i = 0; i < 8; ++i) zmax = max(zmax, wmax[i]);
    bc[q] = (uint8_t)(zmax > 31 ? 10 : zmax > 3 ? 5 : zmax > 0 ? 2 : 0);
  }
}

__global__ void __launch_bounds__(256)
plane_pack_kernel(const uint16_t* __restrict__ zs,
                  const int32_t* __restrict__ gidx, int n2, int n5, int n10,
                  uint32_t* __restrict__ blob) {
  __shared__ uint32_t words[8][86];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = blockIdx.x * 8 + warp;
  if (R >= n2 + n5 + n10) return;
  int bw, nw, r;
  long long woff;
  if (R < n2) {
    bw = 2, nw = 16, r = R, woff = 0;
  } else if (R < n2 + n5) {
    bw = 5, nw = 43, r = R - n2, woff = (long long)n2 * 16;
  } else {
    bw = 10, nw = 86, r = R - n2 - n5,
    woff = (long long)n2 * 16 + (long long)n5 * 43;
  }
  uint32_t* sw = words[warp];
  for (int i = lane; i < nw; i += 32) sw[i] = 0u;
  const uint4 raw =
      *(const uint4*)(zs + (long long)gidx[R] * kL + lane * 8);
  const uint32_t pair[4] = {raw.x, raw.y, raw.z, raw.w};
  __syncwarp();
  for (int e = 0; e < 8; ++e) {
    const int j = lane * 8 + e;
    const uint32_t z = (pair[e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
    atomicAdd(&sw[j % nw], z << ((j / nw) * bw));
  }
  __syncwarp();
  uint32_t* out = blob + woff + (long long)r * nw;
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

// B15. src: the u8 composite (bits 8, nh = rows / 3), the (n, h, w)
// u32 RGBA1010102 batch (bits 10) or the (n, h, w, 4) u16 F16 batch
// (bits 16), nh = n * h, rows = 3 * nh stacked rows of width w;
// zs0/zs1: (nseg, 256) int16 (zs1 only in mode 2); maps: (2 or 4, nseg)
// u8.
int uhdr_rice_stats(const void* src, long long rows, int w, int nsegw,
                    int mode, int bits, long long nh, void* zs0, void* zs1,
                    void* maps, void* stream) {
  const long long nseg = rows * nsegw;
  PixSrc s{src, nh, w};
  auto kernel = bits == 16 ? stats_kernel<16>
                           : (bits == 10 ? stats_kernel<10> : stats_kernel<8>);
  kernel<<<(unsigned)nseg, 256, 0, (cudaStream_t)stream>>>(
      s, nsegw, mode, nseg, (int16_t*)zs0, (int16_t*)zs1, (uint8_t*)maps);
  return (int)cudaGetLastError();
}

// B16 order. kmap/uwmap: nseg u8 each; nk: 10 or 16 remainder widths;
// sidx_rem/sidx_un: nseg int32 out; offs: nk + 7 int32 out or null;
// head: nk + 11 u32 out or null (with the pads, nk and 7 host ints, for
// its fit flag); pad: bytes to zero after the map (fused layout).
int uhdr_rice_order(const void* kmap, const void* uwmap, int nseg, int nk,
                    void* sidx_rem, void* sidx_un, void* offs, void* head,
                    int med, const int* rem_pads, const int* un_pads,
                    void* pad, int npad, void* stream) {
  RicePads pads;
  for (int j = 0; j < 16; ++j) pads.rem[j] = j < nk ? rem_pads[j] : 0;
  for (int c = 0; c < 7; ++c) pads.un[c] = un_pads[c];
  auto kernel = nk == 16 ? order_kernel<16> : order_kernel<10>;
  kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)kmap, (const uint8_t*)uwmap, nseg, (int32_t*)sidx_rem,
      (int32_t*)sidx_un, (int32_t*)offs, (uint32_t*)head, med, pads,
      (uint8_t*)pad, npad);
  return (int)cudaGetLastError();
}

// B16 emit. zs: (nseg, 256) int16; kmap: nseg u8; offs: nk + 7 int32 on
// the device; start (nk + 7), nw (nk + 6), woff (nk + 6): the bucket
// rows, host arrays.
int uhdr_rice_emit(const void* zs, const void* kmap, const void* sidx_rem,
                   const void* sidx_un, const void* offs, int nseg, int nk,
                   const int* start, const int* nw, const long long* woff,
                   void* blob, void* stream) {
  RiceRows rows;
  const int nb = nk + 6;
  for (int b = 0; b <= nb; ++b) rows.start[b] = start[b];
  for (int b = 0; b < nb; ++b) rows.nw[b] = nw[b], rows.woff[b] = woff[b];
  if (rows.start[nb] == 0) return 0;
  emit_kernel<<<blocks(rows.start[nb], 8), 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)zs, (const uint8_t*)kmap, (const int32_t*)sidx_rem,
      (const int32_t*)sidx_un, (const int32_t*)offs, nseg, nk, rows,
      (uint32_t*)blob);
  return (int)cudaGetLastError();
}

// B17 pass 1. src: (n, h, w) u32, nh = n * h; zs: (3 * nh * nsegw, 64)
// u16; bc: 3 * nh * nsegw u8.
int uhdr_rct_widths(const void* src, long long nh, int w, int nsegw,
                    void* zs, void* bc, void* stream) {
  const long long nseg = 3 * nh * nsegw;
  PixSrc s{src, nh, w};
  rct_widths_kernel<<<blocks(nseg, 8), 256, 0, (cudaStream_t)stream>>>(
      s, nsegw, nseg, (uint16_t*)zs, (uint8_t*)bc);
  return (int)cudaGetLastError();
}

// B17 pack. zs, bc: pass 1's; sidx: nseg int32 scratch; npads, offs (8
// each): the buckets' padded rows and first places (host ints); blob:
// the u32 words of the 8 buckets.
int uhdr_rct_pack(const void* zs, const void* bc, int nseg, void* sidx,
                  const int* npads, const int* offs, void* blob,
                  void* stream) {
  FineRows rows;
  rows.start[0] = 0;
  long long woff = 0;
  for (int b = 0; b < 8; ++b) {
    const int slots = 32 / (b < 6 ? b + 1 : (b == 6 ? 8 : 10));
    rows.start[b + 1] = rows.start[b] + npads[b];
    rows.offs[b] = offs[b];
    rows.woff[b] = woff;
    woff += (long long)npads[b] * ((kLF + slots - 1) / slots);
  }
  rct_order_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bc, nseg, (int32_t*)sidx);
  fine_pack_kernel<<<blocks(rows.start[8], 8), 256, 0,
                     (cudaStream_t)stream>>>(
      (const uint16_t*)zs, (const int32_t*)sidx, nseg, rows,
      (uint32_t*)blob);
  return (int)cudaGetLastError();
}

// B21 widths. arr: (h, w) u16 10-bit; zs: (h * nsegw, 256) u16; bc:
// h * nsegw u8.
int uhdr_plane_widths(const void* arr, int h, int w, int nsegw, void* zs,
                      void* bc, void* stream) {
  plane_widths_kernel<<<(unsigned)((long long)h * nsegw), 256, 0,
                        (cudaStream_t)stream>>>(
      (const uint16_t*)arr, w, nsegw, (uint16_t*)zs, (uint8_t*)bc);
  return (int)cudaGetLastError();
}

// B21 pack. gidx: n2 + n5 + n10 int32 segment indices (the host plan);
// blob: n2 * 16 + n5 * 43 + n10 * 86 u32.
int uhdr_plane_pack(const void* zs, const void* gidx, int n2, int n5,
                    int n10, void* blob, void* stream) {
  plane_pack_kernel<<<blocks((long long)n2 + n5 + n10, 8), 256, 0,
                      (cudaStream_t)stream>>>(
      (const uint16_t*)zs, (const int32_t*)gidx, n2, n5, n10,
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
