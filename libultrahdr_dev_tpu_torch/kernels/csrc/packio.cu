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
// - B0 is one streaming pass, one thread per 4 output samples, coalesced
//   reads and writes.
// - B18 gives a CTA one output row and a thread 16 bytes of it. Each
//   row's part (Y, U|V or gain map) and source row pointers are resolved
//   once a row, not once a byte; the loads are 16 bytes where the source
//   is 16-byte aligned (Y rows of a 4080-wide frame), two 8-byte loads
//   where it is 8-byte aligned (V, which starts at column cw = 2040 of
//   the U|V row), else aligned words joined by funnel shifts (a strided
//   view at any offset); the stores are 16 bytes where wc is a multiple
//   of 16. Only the chunk that crosses a part's last column or U|V's seam
//   takes a byte path; chunks past a part's last column repeat it.
// - B14 gives a warp one 256-column segment of one 32-row delta group.
//   Lane i reads row i's perm entry and resolves its bucket and first
//   word once; the warp stages the 32 rows' bucket words in shared memory
//   (coalesced, every load issued before the sums start, so no load
//   chain sits in the running sum), and each lane owns eight consecutive
//   columns whose word indices and shifts are computed once a thread: no
//   division a sample. The running sums stay in registers, so the tall
//   (n*h*3/2, w) plane is never stored: each row goes straight to the y
//   or uv output, << 6, one 16-byte store a lane. 32-bit blob offsets.
// - B15 gives a warp one 256-column span of a run of 32 source rows,
//   eight consecutive samples a lane (16-byte loads where the row is
//   aligned; 8-byte at bits 8). It walks down the rows keeping the row
//   above in registers, takes each left neighbour from the lane's own
//   previous sample or lane - 1's last by a shuffle, and reads no sample
//   twice but the one column left of the span. A pixel (10, 16 bits) is
//   decoded once into its three planes, whose rows the same warp
//   produces, each plane keeping its own place in its 32-row delta group;
//   no plane index is divided out. Per segment row, each lane sums its
//   z >> k serially (at bits 8 two samples a 32-bit word: the masked
//   sums of a segment stay below 2^15 a half), the warp adds the 8 or 16
//   sums by halving (16 or 9 shuffles a segment, against 50-80 a sample
//   in the CTA-per-segment form), and one __reduce_min_sync picks k.
//   Both schemes share the one read of the source.
// - B16 is the order, then the emit. The order is a counting sort over
//   tiles of 2048 segments in three launches: a CTA a tile counts its
//   ranks (__match_any_sync groups the lanes of one rank), one exclusive
//   scan over the 25 x tiles (rank, tile) counts (scan.cuh; a few
//   thousand values) gives each tile its first place per rank and writes
//   the offsets, the fused head and its pad bytes, and a CTA a tile
//   places each segment at its tile's base plus its stable place in the
//   tile: the stable (rank, index) order of both bucket families, which
//   is what JAX's jnp.sort of (rank << 22) | index computes.
//   uhdr_rice_emit gives a warp four output rows, their segments
//   resolved and their 16-byte loads issued together; a remainder row is
//   staged in shared memory and each lane builds whole words (no atomics),
//   a unary row takes its terminator positions from a warp scan of q + 1;
//   then a coalesced store of the row's words.
// - B17's widths pass is B15's walk over the RGBA1010102 pixels (a warp a
//   256-column span of a run of rows, each pixel loaded once a row and
//   decoded once into its three planes, the row above in registers, each
//   plane's own place in its group) with 64-sample segments: a lane's 8
//   residuals go out in one 16-byte store and a segment's maximum takes
//   three xor shuffles over its 8 lanes. Then B16's tiled order with one
//   family of 9 width ranks (FineRanks: 9 x tiles counts scanned; nothing
//   runs as one CTA over the segments), then a pack that gives a warp 16
//   rows of one bucket: their places and segments resolved by the lanes
//   together, their 128-byte rows loaded together and staged in shared
//   memory, and each lane building whole words (the slots summed, as JAX
//   sums them) that the warp stores coalesced; no atomics.
// - B21's widths pass is B17a's walk on one u16 plane: a warp owns one
//   256-column segment over one 32-row group, eight consecutive columns a
//   lane (one 16-byte load a row where the row is aligned, clamped
//   scalar loads otherwise), the row above in registers, and none loaded
//   for the group's first row, whose row above counts as 0. (32-row
//   runs beat 16-row runs on the H100; PERF.md keeps both times.) A lane's 8 residuals
//   go out in one 16-byte store and the segment's maximum is one
//   __reduce_max_sync; no shared memory, no barrier, no division a
//   sample. B21's pack keeps its first design (a warp an output row and
//   shared-memory atomics); the host's gather index replaces the order.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"
#include "scan.cuh"

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
  uint32_t off5, off10, offperm;  // the blob is < 2^31 words
};

constexpr int kSegWarps = 4;    // warps a B14 CTA
constexpr int kSegStage = 88;   // u32 words of a staged row (>= 86, even)
constexpr int kSegBatch = 8;    // rows whose words a lane loads together

// Unzigzag z, add it to the running sum, and return the MSB-aligned
// 10-bit sample of the sum.
__device__ __forceinline__ uint32_t seg_step(int& acc, uint32_t z) {
  acc += (int)(z >> 1) ^ -(int)(z & 1u);
  return (uint32_t)(acc & 1023) << 6;
}

// A warp per (32-row group, 256-column segment). Lane i reads the perm
// entry of the group's row i and resolves its bucket and first word once;
// the warp then stages the 32 rows' bucket words in shared memory with
// coalesced loads, all issued before the running sums start. Lane l owns
// the segment's columns j = 8 l .. 8 l + 7, whose word indices and
// shifts are computed once a thread (bucket 2: words 8 (l & 1) .. + 7,
// two 16-byte shared loads, at shift 2 (l >> 1)). Each row is then a
// warp-uniform branch on its bucket, at most eight shared loads, the
// sums and one 16-byte store a lane where the output row allows it.
__global__ void __launch_bounds__(kSegWarps * 32)
seg_kernel(const uint32_t* __restrict__ blob, SegPlan p,
           uint16_t* __restrict__ y, uint16_t* __restrict__ uv) {
  __shared__ __align__(16) uint32_t stage[kSegWarps][kG * kSegStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wid = blockIdx.x * kSegWarps + warp;
  if (wid >= (p.rows / kG) * p.nsegw) return;
  const int g = wid / p.nsegw, s = wid - g * p.nsegw;
  // Lane i: row i's bucket (0 zero, 1: 2 bits, 2: 5 bits, 3: 10 bits)
  // and its first word in the blob.
  const int32_t* perm = (const int32_t*)(blob + p.offperm);
  const int pr = perm[(g * kG + lane) * p.nsegw + s] - 1;
  int bk = 0;
  uint32_t base = 0;
  if (pr >= 0) {
    if (pr < p.n2) {
      bk = 1, base = (uint32_t)pr * 16u;
    } else if (pr - p.n2 < p.n5) {
      bk = 2, base = p.off5 + (uint32_t)(pr - p.n2) * 43u;
    } else {
      bk = 3, base = p.off10 + (uint32_t)(pr - p.n2 - p.n5) * 86u;
    }
  }
  const int nwl = bk == 1 ? 16 : (bk == 2 ? 43 : (bk == 3 ? 86 : 0));
  uint32_t* st = stage[warp];
  // Stage kSegBatch rows at a time: their (up to 3) words a lane loaded
  // together, then stored.
#pragma unroll
  for (int r0 = 0; r0 < kG; r0 += kSegBatch) {
    uint32_t v[kSegBatch][3];
    int nw[kSegBatch];
#pragma unroll
    for (int i = 0; i < kSegBatch; ++i) {
      nw[i] = __shfl_sync(0xffffffffu, nwl, r0 + i);
      const uint32_t o = __shfl_sync(0xffffffffu, base, r0 + i);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        v[i][t] = lane + 32 * t < nw[i] ? __ldg(blob + o + lane + 32 * t)
                                        : 0u;
    }
#pragma unroll
    for (int i = 0; i < kSegBatch; ++i)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (lane + 32 * t < nw[i])
          st[(r0 + i) * kSegStage + lane + 32 * t] = v[i][t];
  }
  __syncwarp();
  // The lane's word index and shift of each of its eight columns, per
  // bucket (bucket 2: eight consecutive words at one shift).
  const int w2 = 8 * (lane & 1), s2 = 2 * (lane >> 1);
  int w5[8], s5[8], w10[8], s10[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = 8 * lane + e;
    w5[e] = j % 43, s5[e] = j / 43 * 5;
    w10[e] = j % 86, s10[e] = j / 86 * 10;
  }
  const int x0 = s * kL + 8 * lane;
  const bool ypart = g * kG < p.yrows;
  uint16_t* out = ypart ? y + (size_t)g * kG * p.w
                        : uv + (size_t)(g * kG - p.yrows) * p.w;
  int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < kG; ++i, out += p.w) {
    const int b = __shfl_sync(0xffffffffu, bk, i);
    const uint32_t* row = st + i * kSegStage;
    uint32_t z[8];
    if (b == 1) {
      const uint4 t0 = *(const uint4*)(row + w2);
      const uint4 t1 = *(const uint4*)(row + w2 + 4);
      const uint32_t wd[8] = {t0.x, t0.y, t0.z, t0.w,
                              t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = (wd[e] >> s2) & 3u;
    } else if (b == 2) {
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = (row[w5[e]] >> s5[e]) & 31u;
    } else if (b == 3) {
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = (row[w10[e]] >> s10[e]) & 1023u;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = 0u;
    }
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = seg_step(acc[e], z[e]);
    if (((size_t)(out + x0) & 15) == 0 && x0 + 8 <= p.w) {
      *(uint4*)(out + x0) =
          make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                     v[4] | (v[5] << 16), v[6] | (v[7] << 16));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (x0 + e < p.w) out[x0 + e] = (uint16_t)v[e];
    }
  }
}

// ---------------------------------------------------------------------------
// B15: Rice pass 1. The source is a u8 composite (bits 8: the planar
// readback, whose three "planes" are the composite's thirds), an (n, h,
// w) u32 RGBA1010102 batch (bits 10) or an (n, h, w, 4) u16 F16-halves
// batch (bits 16); the two pixel formats are decorrelated on the load
// into the stacked planes (G, R-G, B-G mod 2^bits) of 3 * n * h rows.
// Columns are edge-padded to nsegw * 256. MODE 0: vertical deltas, 1:
// MED, 2: both (vertical into zs0 and map rows 0-1, MED into zs1 and rows
// 2-3). Map rows: [k code, unary words].
//
// A warp walks one 256-column span down a run of kRiceRun source rows
// (stacked rows at bits 8, frame rows at bits 10 and 16, where one load
// of a pixel gives the same row of all three planes), eight consecutive
// samples a lane. `up` is the register copy of the row before, `left`
// the lane's previous sample or, for its first, lane - 1's last through a
// shuffle (lane 0 loads the one column left of the span), `up-left` the
// same of the row before. Delta groups reset by stacked row, so each
// plane keeps its own place in its 32-row group.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int zigzag_bits(int d, int bits) {
  const int mask = (1 << bits) - 1, half = 1 << (bits - 1);
  const int ds = ((d + half) & mask) - half;
  return (ds << 1) ^ (ds >> 31);
}

constexpr int kRiceRun = 32;  // source rows a B15 warp walks

// A lane's eight samples of one source row as loaded: 8 bytes (bits 8),
// 8 RGBA1010102 words (bits 10) or 8 F16-halves quads (bits 16), and
// the pixel left of the span (read by lane 0 only).
template <int BITS>
struct RawRow {
  static constexpr int kWords = BITS == 8 ? 2 : (BITS == 10 ? 8 : 16);
  uint32_t v[kWords];
  uint32_t left[BITS == 16 ? 2 : 1];
};

// Source row `row` at columns x0..x0+7, clamped to w - 1: one or more
// 16-byte (8-byte at bits 8) loads where the row is aligned and the eight
// columns lie inside it, else one load a column.
template <int BITS>
__device__ __forceinline__ void load_row(const void* __restrict__ src,
                                         long long row, int w, int x0,
                                         bool left, RawRow<BITS>& rr) {
  const long long o = row * w;
  const bool inside = x0 + 8 <= w;
  if constexpr (BITS == 8) {
    const uint8_t* p = (const uint8_t*)src + o;
    if (inside && ((size_t)(p + x0) & 7) == 0) {
      const uint2 t = *(const uint2*)(p + x0);
      rr.v[0] = t.x, rr.v[1] = t.y;
    } else {
      rr.v[0] = rr.v[1] = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        rr.v[e >> 2] |= (uint32_t)p[min(x0 + e, w - 1)] << (8 * (e & 3));
    }
    if (left) rr.left[0] = p[x0 - 1];
  } else if constexpr (BITS == 10) {
    const uint32_t* p = (const uint32_t*)src + o;
    if (inside && ((size_t)(p + x0) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 t = ((const uint4*)(p + x0))[i];
        rr.v[4 * i] = t.x, rr.v[4 * i + 1] = t.y;
        rr.v[4 * i + 2] = t.z, rr.v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) rr.v[e] = p[min(x0 + e, w - 1)];
    }
    if (left) rr.left[0] = p[x0 - 1];
  } else {
    const uint2* p = (const uint2*)src + o;
    if (inside && ((size_t)(p + x0) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 t = ((const uint4*)(p + x0))[i];
        rr.v[4 * i] = t.x, rr.v[4 * i + 1] = t.y;
        rr.v[4 * i + 2] = t.z, rr.v[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint2 t = p[min(x0 + e, w - 1)];
        rr.v[2 * e] = t.x, rr.v[2 * e + 1] = t.y;
      }
    }
    if (left) {
      const uint2 t = p[x0 - 1];
      rr.left[0] = t.x, rr.left[1] = t.y;
    }
  }
}

// (G, R-G, B-G) mod 2^BITS of one RGBA1010102 word or F16-halves quad.
template <int BITS>
__device__ __forceinline__ void decor(uint32_t a, uint32_t b, int* g,
                                      int* rg, int* bg) {
  int r, gg, bb;
  if constexpr (BITS == 10) {
    r = a & 1023, gg = (a >> 10) & 1023, bb = (a >> 20) & 1023;
  } else {
    r = a & 0xFFFF, gg = a >> 16, bb = b & 0xFFFF;
  }
  constexpr int mask = (1 << BITS) - 1;
  *g = gg, *rg = (r - gg) & mask, *bg = (bb - gg) & mask;
}

// The row's planes (one at bits 8, three at 10 and 16): c[p][e], and the
// sample left of the span in l[p] (meaningful in lane 0 only).
template <int BITS, int NP>
__device__ __forceinline__ void decode_row(const RawRow<BITS>& rr,
                                           int (&c)[NP][8], int (&l)[NP]) {
  if constexpr (BITS == 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[0][e] = (rr.v[e >> 2] >> (8 * (e & 3))) & 255;
    l[0] = rr.left[0] & 255;
  } else {
    const int step = BITS == 10 ? 1 : 2;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      decor<BITS>(rr.v[step * e], rr.v[step * e + step - 1], &c[0][e],
                  &c[NP > 1 ? 1 : 0][e], &c[NP - 1][e]);
    decor<BITS>(rr.left[0], rr.left[BITS == 16 ? 1 : 0], &l[0],
                &l[NP > 1 ? 1 : 0], &l[NP - 1]);
  }
}

// A warp's start on source row r0 of nrows (B15, B17): each plane's place
// in its 32-row delta group (gpos; plane p of source row r is stacked
// row p * nrows + r) and, where a plane's first row does not start a
// group, the stacked row above it in up (its left neighbour in ucl, 0
// without a column left of the span): the source row before, or, at
// r0 = 0 (where plane 0 starts a group), the last row of the plane
// before.
template <int BITS, int NP>
__device__ __forceinline__ void rows_above(
    const void* __restrict__ src, long long r0, long long nrows, int w,
    int x0, bool left, bool has_left, int lane, int (&gpos)[NP],
    int (&up)[NP][8], int (&ucl)[NP]) {
  bool need_up = false;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    gpos[p] = (int)((p * nrows + r0) & (kG - 1));
    need_up = need_up || gpos[p] != 0;
  }
  if (need_up) {
    RawRow<BITS> pr;
    load_row<BITS>(src, r0 > 0 ? r0 - 1 : nrows - 1, w, x0, left, pr);
    int pc[NP][8], pl[NP];
    decode_row<BITS, NP>(pr, pc, pl);
    const bool same = r0 > 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = p > 0 ? p - 1 : 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) up[p][e] = same ? pc[p][e] : pc[q][e];
      const int cl = __shfl_up_sync(0xffffffffu, up[p][7], 1);
      ucl[p] = lane == 0 ? (has_left ? (same ? pl[p] : pl[q]) : 0) : cl;
    }
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int e = 0; e < 8; ++e) up[p][e] = 0;
      ucl[p] = 0;
    }
  }
}

// Sum over the warp of each of v[0..N) (N a power of 2, at most 32) by
// halving: each step keeps half the values, sending the other half to
// the lane across (N - 1 shuffles), then a butterfly over the lanes
// that hold the same index. Lane l returns the total of index
// (l >> (5 - log2 N)) & (N - 1). The steps are a template recursion so
// that every index into v is a constant and v stays in registers.
template <int N, int H>
__device__ __forceinline__ void transpose_halve(uint32_t (&v)[N], int lane) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / N;
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const uint32_t send = hi ? v[i] : v[i + H];
      const uint32_t keep = hi ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    transpose_halve<N, H / 2>(v, lane);
  }
}

template <int N>
__device__ __forceinline__ uint32_t warp_transpose_sum(uint32_t (&v)[N],
                                                       int lane) {
  transpose_halve<N, N / 2>(v, lane);
  uint32_t s = v[0];
#pragma unroll
  for (int o = 16 / N; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// JAX _rice_seg_stats over the warp's 256 residuals (z: the lane's 8):
// sq[k] = sum of z >> k; the k with the fewest bits sq[k] + 256 (1 + k)
// among those whose unary part (sq[k] + 256 + 31) >> 5 fits kUcap words,
// the smallest on a tie. Returned in every lane as (bits << 5) | k; an
// all-zero segment gives k = 0 and bits = 256, and only it does.
template <int BITS>
__device__ __forceinline__ uint32_t rice_seg_key(const int (&z)[8],
                                                 int lane) {
  int k, sq;
  bool valid = true;
  if constexpr (BITS == 8) {
    // z < 256, so the sum over a segment's 128 even (odd) samples of
    // z & ~(2^k - 1) is < 2^15: the two 16-bit halves of a packed word
    // never carry into each other, and that sum is 2^k sq[k] exactly.
    // k > 7 gives sq = 0 and is never strictly better than k = 7.
    uint32_t p[4], t[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = (uint32_t)z[2 * i] | ((uint32_t)z[2 * i + 1] << 16);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a = ((0xFFu << kk) & 0xFFu) * 0x10001u;
      t[kk] = (p[0] & a) + (p[1] & a) + (p[2] & a) + (p[3] & a);
    }
    const uint32_t tot = warp_transpose_sum<8>(t, lane);
    k = (lane >> 2) & 7;
    sq = (int)(((tot & 0xFFFFu) + (tot >> 16)) >> k);
  } else {
    constexpr int nk = BITS == 16 ? 16 : 10;
    uint32_t t[16];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      uint32_t s = 0;
      if (kk < nk)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += (uint32_t)z[e] >> kk;
      t[kk] = s;
    }
    sq = (int)warp_transpose_sum<16>(t, lane);
    k = (lane >> 1) & 15;
    valid = k < nk;
  }
  const bool fits = valid && ((sq + kL + 31) >> 5) <= kUcap;
  const uint32_t key =
      fits ? ((uint32_t)(sq + kL * (1 + k)) << 5) | (uint32_t)k : 0xFFFFFFFFu;
  return __reduce_min_sync(0xffffffffu, key);
}

// One plane's segment row: residuals of each scheme into zs (a 16-byte
// store a lane) and, with STATS, the segment's map bytes. c: the lane's
// samples, cl the one left of c[0] (0 at column 0); u, ucl: the same of
// the row above, read only when the row does not start a delta group.
template <int BITS, int MODE, bool STATS>
__device__ __forceinline__ void rice_plane_row(
    const int (&c)[8], int cl, const int (&u)[8], int ucl, bool gstart,
    long long q, long long nseg, int lane, int16_t* __restrict__ zs0,
    int16_t* __restrict__ zs1, uint8_t* __restrict__ maps) {
  constexpr int mask = (1 << BITS) - 1;
  constexpr int zero_code = BITS == 16 ? 31 : kZero;
#pragma unroll
  for (int m = 0; m < (MODE == 2 ? 2 : 1); ++m) {
    const bool med = MODE == 1 || m == 1;
    int z[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int up = gstart ? 0 : u[e];
      int pred = up;
      if (med) {
        const int left = e ? c[e - 1] : cl;
        const int ul = gstart ? 0 : (e ? u[e - 1] : ucl);
        const int mx = max(left, up), mn = min(left, up);
        pred = ul >= mx ? mn : (ul <= mn ? mx : left + up - ul);
      }
      z[e] = zigzag_bits((c[e] - pred) & mask, BITS);
    }
    uint4 st;
    st.x = (uint32_t)z[0] | ((uint32_t)z[1] << 16);
    st.y = (uint32_t)z[2] | ((uint32_t)z[3] << 16);
    st.z = (uint32_t)z[4] | ((uint32_t)z[5] << 16);
    st.w = (uint32_t)z[6] | ((uint32_t)z[7] << 16);
    *(uint4*)((m ? zs1 : zs0) + q * kL + lane * 8) = st;
    if (!STATS) continue;
    const uint32_t key = rice_seg_key<BITS>(z, lane);
    if (lane == 0) {
      const int k = (int)(key & 31u), bits = (int)(key >> 5);
      const bool zero = key == ((uint32_t)kL << 5);
      const int uw = (bits - kL * (1 + k) + kL + 31) >> 5;
      maps[2 * m * nseg + q] = (uint8_t)(zero ? zero_code : k);
      maps[(2 * m + 1) * nseg + q] = (uint8_t)(zero ? 0 : uw);
    }
  }
}

// nrows: source rows (stacked rows at bits 8, frame rows n * h at 10 and
// 16); plane p of source row r is stacked row p * nrows + r. Without
// STATS only the residuals (chip_smoke.py times the load and residuals
// apart from the reduction that way). Two CTAs an SM (at most 128
// registers): unbounded, ptxas gave the 16-bit arm of both schemes 162
// and it ran 6% slower on the H100 (0.168 against 0.159 ms a frame).
template <int BITS, int MODE, bool STATS = true>
__global__ void __launch_bounds__(256, 2)
stats_kernel(const void* __restrict__ src, int w, int nsegw, long long nrows,
             long long nseg, int16_t* __restrict__ zs0,
             int16_t* __restrict__ zs1, uint8_t* __restrict__ maps) {
  constexpr int NP = BITS == 8 ? 1 : 3;
  const int lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int s = (int)(wid % nsegw);
  const long long r0 = wid / nsegw * kRiceRun;
  if (r0 >= nrows) return;
  const long long r1 = min(r0 + kRiceRun, nrows);
  const int x0 = s * kL + lane * 8;
  const bool left = lane == 0 && s > 0;  // column x0 - 1 < w
  // Every loop over planes is unrolled, so these stay in registers.
  int gpos[NP], up[NP][8], ucl[NP];
  rows_above<BITS, NP>(src, r0, nrows, w, x0, left, s > 0, lane, gpos, up,
                       ucl);
  RawRow<BITS> nx;
  load_row<BITS>(src, r0, w, x0, left, nx);
  for (long long r = r0; r < r1; ++r) {
    int c[NP][8], cl[NP];
    decode_row<BITS, NP>(nx, c, cl);
    if (r + 1 < r1) load_row<BITS>(src, r + 1, w, x0, left, nx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int sh = __shfl_up_sync(0xffffffffu, c[p][7], 1);
      const int l = lane == 0 ? (s > 0 ? cl[p] : 0) : sh;
      rice_plane_row<BITS, MODE, STATS>(c[p], l, up[p], ucl[p], gpos[p] == 0,
                                 (p * nrows + r) * nsegw + s, nseg, lane,
                                 zs0, zs1, maps);
#pragma unroll
      for (int e = 0; e < 8; ++e) up[p][e] = c[p][e];
      ucl[p] = l;
      gpos[p] = (gpos[p] + 1) & (kG - 1);
    }
  }
}

// ---------------------------------------------------------------------------
// The stable (rank, index) order of B16 and B17: each segment's place when
// the segments of each rank family are sorted by (rank, index), which is
// what JAX's jnp.sort of (rank << 22) | index computes. A rank set R
// gives R::kFams families, family f holding ranks [R::first(f),
// R::first(f + 1)), and R(i, f), segment i's rank in family f:
//
// - RiceRanks<NK> (B16): the remainder family (k = 0..nk-1, the all-zero
//   class last: nk + 1 ranks) and the unary family (word-count class,
//   all-zero last: 8 ranks, numbered after the remainder ranks). nk = 10
//   for 8- and 10-bit samples (zero code 15), 16 for 16-bit ones (zero
//   code 31).
// - FineRanks (B17): one family of 9 width ranks.
//
// A counting sort over tiles of kOrderTile segments, in three launches:
// order_count_kernel counts each tile's ranks (a CTA a tile, a warp per
// 256 segments, __match_any_sync groups the lanes of one rank) into
// tcnt[rank][tile]; order_scan_kernel turns those counts into each
// tile's first place per rank by one exclusive scan over (rank, tile)
// per family (scan.cuh's block_scan_array over at most 25 x tiles
// counts), then hands each rank's first place and total to R::finish
// (B16: the offsets, the fused head and its pad bytes; B17: the totals);
// order_place_kernel counts its tile again per warp and puts each segment
// at its tile's base + its stable place inside the tile.
// ---------------------------------------------------------------------------

constexpr int kMaxRanks = 25;     // 17 remainder ranks + 8 unary ranks
constexpr int kOrderTile = 2048;  // segments a CTA: 8 warps x 256

struct RicePads {
  int rem[16];  // pow2-padded rows of each remainder bucket (k < nk)
  int un[7];    // ... of each unary class
};

template <int NK>
struct RiceRanks {
  static constexpr int kFams = 2, kRanks = NK + 9;
  __device__ static constexpr int first(int f) {
    return f == 0 ? 0 : (f == 1 ? NK + 1 : NK + 9);
  }
  // What the scan writes: offs (nk + 7, or null), the fused head (nk +
  // 11 words, or null: fit flag against pads, med, the rank totals) and
  // npad_bytes zero bytes at pad_bytes.
  struct Out {
    int32_t* offs;
    uint32_t* head;
    int med;
    RicePads pads;
    uint8_t* pad_bytes;
    int npad_bytes;
  };
  const uint8_t* kmap;
  const uint8_t* uwmap;

  __device__ __forceinline__ int operator()(int i, int fam) const {
    constexpr int zero_code = NK == 16 ? 31 : kZero;
    constexpr int nrem = NK + 1;
    const int kc = kmap[i];
    if (fam == 0) return kc == zero_code ? NK : kc;
    if (kc == zero_code) return nrem + 7;
    const int uw = uwmap[i];
    int c = 0;
    while (c < 7 && kUcls[c] < uw) ++c;  // searchsorted, left side
    return nrem + c;
  }

  // Every thread of the scan's CTA; base[r] / tot[r]: rank r's first
  // place in its family's order and its count.
  __device__ static void finish(const Out& o, const int* base,
                                const int* tot) {
    constexpr int nrem = NK + 1;
    const int r = threadIdx.x;
    if (o.offs && r < NK) o.offs[r] = base[r];
    if (o.offs && r >= nrem && r < nrem + 7) o.offs[NK + r - nrem] = base[r];
    if (o.head && threadIdx.x == 0) {
      bool fit = true;
      for (int k = 0; k < NK; ++k) fit = fit && tot[k] <= o.pads.rem[k];
      for (int c = 0; c < 7; ++c) fit = fit && tot[nrem + c] <= o.pads.un[c];
      o.head[0] = fit ? 1u : 0u;
      o.head[1] = (uint32_t)o.med;
      for (int k = 0; k < kRanks; ++k) o.head[2 + k] = (uint32_t)tot[k];
    }
    for (int e = threadIdx.x; e < o.npad_bytes; e += blockDim.x)
      o.pad_bytes[e] = 0;
  }
};

struct FineRanks {
  static constexpr int kFams = 1, kRanks = 9;
  __device__ static constexpr int first(int f) { return f ? kRanks : 0; }
  struct Out {
    int32_t* totals;  // each rank's count (9), or null
  };
  const uint8_t* bc;

  // Width code {0,1,2,3,4,5,6,8,10} -> rank 0..8 (JAX: code - (code > 6)
  // - (code > 8)).
  __device__ __forceinline__ int operator()(int i, int) const {
    const int code = bc[i];
    return code - (code > 6) - (code > 8);
  }

  __device__ static void finish(const Out& o, const int*, const int* tot) {
    if (o.totals && threadIdx.x < kRanks)
      o.totals[threadIdx.x] = tot[threadIdx.x];
  }
};

// The calling warp's rank counts over segments [lo, min(lo + 256, nseg))
// of every family, added into cnt[rank] (the warp's own row).
template <class R>
__device__ __forceinline__ void warp_rank_counts(const R& rank_of, int lo,
                                                 int nseg, int* cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int hi = min(lo + 256, nseg);
  for (int i0 = lo; i0 < lo + 256; i0 += 32) {
    const int i = i0 + lane;
    for (int f = 0; f < R::kFams; ++f) {
      const int rk = i < hi ? rank_of(i, f) : -1;
      const unsigned mr = __match_any_sync(0xffffffffu, rk);
      if (rk >= 0 && (mr & lt) == 0) cnt[rk] += __popc(mr);
      __syncwarp();
    }
  }
}

template <class R>
__global__ void __launch_bounds__(256)
order_count_kernel(R rank_of, int nseg, int* __restrict__ tcnt, int ntiles) {
  __shared__ int cnt[8][kMaxRanks];
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 8 * kMaxRanks; i += blockDim.x)
    cnt[i / kMaxRanks][i % kMaxRanks] = 0;
  __syncthreads();
  warp_rank_counts(rank_of, blockIdx.x * kOrderTile + warp * 256, nseg,
                   cnt[warp]);
  __syncthreads();
  if (threadIdx.x < R::kRanks) {
    int c = 0;
    for (int w = 0; w < 8; ++w) c += cnt[w][threadIdx.x];
    tcnt[threadIdx.x * ntiles + blockIdx.x] = c;
  }
}

template <class R>
__global__ void __launch_bounds__(1024)
order_scan_kernel(int* __restrict__ tcnt, int ntiles, typename R::Out out) {
  __shared__ int warp_sums[32];
  __shared__ int base[kMaxRanks], tot[kMaxRanks];
  int ftot[R::kFams];
#pragma unroll
  for (int f = 0; f < R::kFams; ++f) {
    int* t = tcnt + R::first(f) * ntiles;
    ftot[f] = uhdr_scan::block_scan_array(
        (R::first(f + 1) - R::first(f)) * ntiles, 0, 0, warp_sums,
        [&](int i) { return t[i]; }, [&](int i, int v) { t[i] = v; });
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < R::kRanks) {
    int f = 0, ft = ftot[0];
#pragma unroll
    for (int g = 1; g < R::kFams; ++g)
      if (r >= R::first(g)) f = g, ft = ftot[g];
    base[r] = tcnt[r * ntiles];
    tot[r] = (r + 1 == R::first(f + 1) ? ft : tcnt[(r + 1) * ntiles]) -
             base[r];
  }
  __syncthreads();
  R::finish(out, base, tot);
}

template <class R>
__global__ void __launch_bounds__(256)
order_place_kernel(R rank_of, int nseg, const int* __restrict__ tcnt,
                   int ntiles, int32_t* __restrict__ sidx0,
                   int32_t* __restrict__ sidx1) {
  __shared__ int cnt[8][kMaxRanks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < 8 * kMaxRanks; i += blockDim.x)
    cnt[i / kMaxRanks][i % kMaxRanks] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kOrderTile + warp * 256;
  warp_rank_counts(rank_of, lo, nseg, cnt[warp]);
  __syncthreads();
  if (threadIdx.x < R::kRanks) {
    int run = tcnt[threadIdx.x * ntiles + blockIdx.x];
    for (int w = 0; w < 8; ++w) {
      const int c = cnt[w][threadIdx.x];
      cnt[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  const int hi = min(lo + 256, nseg);
  int* mine = cnt[warp];
  for (int i0 = lo; i0 < lo + 256; i0 += 32) {
    const int i = i0 + lane;
    for (int f = 0; f < R::kFams; ++f) {
      const int rk = i < hi ? rank_of(i, f) : -1;
      const unsigned mr = __match_any_sync(0xffffffffu, rk);
      if (rk >= 0) (f ? sidx1 : sidx0)[mine[rk] + __popc(mr & lt)] = i;
      __syncwarp();
      if (rk >= 0 && (mr & lt) == 0) mine[rk] += __popc(mr);
      __syncwarp();
    }
  }
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

constexpr int kEmitRows = 4;  // output rows a B16 emit warp

__global__ void __launch_bounds__(256)
emit_kernel(const uint16_t* __restrict__ zs, const uint8_t* __restrict__ kmap,
            const int32_t* __restrict__ sidx_rem,
            const int32_t* __restrict__ sidx_un,
            const int32_t* __restrict__ offs, int nseg, int nk, RiceRows rows,
            uint32_t* __restrict__ blob) {
  __shared__ __align__(16) uint16_t zsh[8][kL];
  __shared__ uint32_t words[8][kUcap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = nk + 6, total = rows.start[nb];
  const int R0 = (blockIdx.x * 8 + warp) * kEmitRows;
  if (R0 >= total) return;
  // Lane j < kEmitRows resolves row R0 + j (its bucket, its place in the
  // bucket's family order, the segment there and its k code) so that the
  // rows' dependent loads overlap; past the end, row `total - 1` stands in.
  int b = 0, kc = 0, idx = 0;
  if (lane < kEmitRows) {
    const int R = min(R0 + lane, total - 1);
    while (R >= rows.start[b + 1]) ++b;
    // offs: remainder buckets k = 0..nk-1 at [0, nk), unary classes at
    // [nk, nk + 7); bucket b is entry k = b + 1, or nk + (b - nk + 1):
    // b + 1 both.
    const int pos = offs[b + 1] + R - rows.start[b];
    const bool rem = b < nk - 1;
    idx = pos < nseg ? (rem ? sidx_rem[pos] : sidx_un[pos]) : 0;
    kc = rem ? 0 : kmap[idx];
  }
  uint4 raw[kEmitRows];
#pragma unroll
  for (int j = 0; j < kEmitRows; ++j) {
    const int ij = __shfl_sync(0xffffffffu, idx, j);
    raw[j] = *(const uint4*)(zs + (long long)ij * kL + lane * 8);
  }
#pragma unroll
  for (int j = 0; j < kEmitRows; ++j) {
    const int bj = __shfl_sync(0xffffffffu, b, j);
    const int kj = __shfl_sync(0xffffffffu, kc, j);
    if (R0 + j >= total) break;
    const int nw = rows.nw[bj];
    uint32_t* out =
        blob + rows.woff[bj] + (long long)(R0 + j - rows.start[bj]) * nw;
    if (bj < nk - 1) {
      // Each word whole from the staged row: word i holds samples i + m
      // nw at shift m k. Below 32 words (k = 1, 2) g = 32 / nw lanes
      // share a word, lane part p taking m = p, p + g, ..., and OR them
      // together.
      *(uint4*)&zsh[warp][lane * 8] = raw[j];
      __syncwarp();
      const int k = bj + 1, slots = 32 / k;
      const uint32_t mask = (1u << k) - 1u;
      const int g = nw < 32 ? 32 / nw : 1;
      const int part = lane / nw;  // < g for every lane when g > 1
      for (int i = g > 1 ? lane % nw : lane; i < nw; i += 32) {
        uint32_t word = 0;
        for (int m = g > 1 ? part : 0; m < slots; m += g) {
          const int jj = i + m * nw;
          if (jj < kL) word |= ((uint32_t)zsh[warp][jj] & mask) << (m * k);
        }
        for (int o = nw; o < 32 && g > 1; o <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, o);
        if (g == 1 || part == 0) out[i] = word;
      }
    } else {
      uint32_t* sw = words[warp];
      for (int i = lane; i < nw; i += 32) sw[i] = 0u;
      const uint32_t pair[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
      int z[8];
      for (int e = 0; e < 8; ++e)
        z[e] = (pair[e >> 1] >> (16 * (e & 1))) & 0xFFFF;
      __syncwarp();
      const int kk = min(kj, nk - 1);
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
      __syncwarp();
      for (int i = lane; i < nw; i += 32) out[i] = sw[i];
    }
    __syncwarp();  // zsh and words are free for the next row
  }
}

// ---------------------------------------------------------------------------
// B17: the RCT fine-width readback of an (n, h, w) u32 RGBA1010102 batch.
// Pass 1 (rct_widths_kernel): zigzag vertical deltas mod 1024 of the
// stacked (G, R-G, B-G) planes (32-row groups, columns edge-padded to
// nsegw * 64) into zs and each 64-sample segment's width code, the least
// of {1,2,3,4,5,6,8,10} that holds its largest delta (0 for an all-zero
// segment). Order: B16's tiled count / scan / place with
// FineRanks (rank = place of the width in {0,1,2,3,4,5,6,8,10}). Pack
// (fine_pack_kernel): the 8 width buckets, row r of bucket b packing the
// segment at place offs[b] + r of the order (segment 0 past the end);
// sample j in word j % nw at shift (j / nw) * width, summed as JAX sums
// the slots (unmasked: a padding row's wider samples carry, as in JAX).
// ---------------------------------------------------------------------------

constexpr int kLF = 64;
__constant__ int kFine[8] = {1, 2, 3, 4, 5, 6, 8, 10};

// Source rows a B17 widths warp walks: at 16, twice the warps of 32 fill
// the card's last wave better, for 1/16 more loads of the row above.
constexpr int kFineRun = 16;

// Pass 1 as B15's walk (stats_kernel) without the left neighbour: a warp
// per 256-column span (four segments, 8 lanes each, 8 samples a lane) of
// a run of kFineRun source rows; each pixel loaded once a row and decoded
// once into its three planes, the row above kept in registers.
__global__ void __launch_bounds__(256)
rct_widths_kernel(const uint32_t* __restrict__ src, int w, int nsegw,
                  int nspan, long long nrows, uint16_t* __restrict__ zs,
                  uint8_t* __restrict__ bc) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int run = wid / nspan, s = wid - run * nspan;
  const long long r0 = (long long)run * kFineRun;
  if (r0 >= nrows) return;
  const long long r1 = min(r0 + kFineRun, nrows);
  const int x0 = s * kL + lane * 8;
  const int seg = s * 4 + (lane >> 3);
  // Lanes past the last segment only join the shuffles.
  const bool live = seg < nsegw;
  int gpos[3], up[3][8], ucl[3];
  rows_above<10, 3>(src, r0, nrows, w, x0, false, false, lane, gpos, up,
                    ucl);
  RawRow<10> nx;
  load_row<10>(src, r0, w, x0, false, nx);
  for (long long r = r0; r < r1; ++r) {
    int c[3][8], cl[3];
    decode_row<10, 3>(nx, c, cl);
    if (r + 1 < r1) load_row<10>(src, r + 1, w, x0, false, nx);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      int z[8], zmax = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        z[e] = zigzag_bits((c[p][e] - (gpos[p] ? up[p][e] : 0)) & 1023, 10);
        zmax = max(zmax, z[e]);
        up[p][e] = c[p][e];
      }
      gpos[p] = (gpos[p] + 1) & (kG - 1);
      const long long q = (p * nrows + r) * nsegw + seg;
      if (live)
        *(uint4*)(zs + q * kLF + (lane & 7) * 8) = make_uint4(
            (uint32_t)z[0] | ((uint32_t)z[1] << 16),
            (uint32_t)z[2] | ((uint32_t)z[3] << 16),
            (uint32_t)z[4] | ((uint32_t)z[5] << 16),
            (uint32_t)z[6] | ((uint32_t)z[7] << 16));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        zmax = max(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
      // The least of {1,2,3,4,5,6,8,10} bits that holds zmax, 0 for 0.
      const int code = (zmax > 0) + (zmax > 1) + (zmax > 3) + (zmax > 7) +
                       (zmax > 15) + (zmax > 31) + 2 * (zmax > 63) +
                       2 * (zmax > 255);
      if (live && (lane & 7) == 0) bc[q] = (uint8_t)code;
    }
  }
}

// The pack: a warp per kPackRows output rows of one bucket (every
// bucket's pow2 padding is a multiple of kPackRows; a shorter last tile
// is masked). Lane j resolves row j (its place offs[b] + r, the segment
// there: sidx, or segment 0 past nseg) with one coalesced load of sidx;
// the warp then issues the rows' 128-byte loads together (8 lanes a row,
// 16 bytes a lane) and stages them in shared memory, 33 words a row so
// that rows start in different banks. Each lane then builds whole output
// words from the staged rows, one (row, word) pair at a time, and the
// warp stores the tile's words, which are contiguous in the blob,
// coalesced. No atomics: a word is one lane's sum.
constexpr int kPackRows = 16;          // output rows a pack warp
constexpr int kStage = kLF / 2 + 1;    // u32 words of a staged row

struct FineRows {
  int tile[9];          // first warp tile of each bucket; tile[8] = all
  int rows[8];          // padded rows of each bucket
  int offs[8];          // first place of each bucket in the order
  long long woff[8];    // first word of each bucket in the blob
};

// Words of rows [0, nrows) of a tile at width BW: word i of a row is the
// sum over slots m of z[i + m nw] << (m BW), mod 2^32 (JAX sums the
// slots; a padding row's wider samples carry into the next slot, as in
// JAX, so no mask and no OR).
template <int BW>
__device__ __forceinline__ void fine_words(const uint32_t* __restrict__ st,
                                           int nrows, int lane,
                                           uint32_t* __restrict__ out) {
  constexpr int slots = 32 / BW, nw = (kLF + slots - 1) / slots;
  for (int p = lane; p < nrows * nw; p += 32) {
    const int r = p / nw, i = p - r * nw;
    const uint16_t* z = (const uint16_t*)(st + r * kStage);
    uint32_t word = 0;
#pragma unroll
    for (int m = 0; m < slots; ++m)
      if (i + m * nw < kLF) word += (uint32_t)z[i + m * nw] << (m * BW);
    out[p] = word;
  }
}

__global__ void __launch_bounds__(256)
fine_pack_kernel(const uint16_t* __restrict__ zs,
                 const int32_t* __restrict__ sidx, int nseg, FineRows rows,
                 uint32_t* __restrict__ blob) {
  __shared__ uint32_t stage[8][kPackRows * kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * 8 + warp;
  if (t >= rows.tile[8]) return;
  int b = 0;
  while (t >= rows.tile[b + 1]) ++b;
  const int r0 = (t - rows.tile[b]) * kPackRows;
  const int nrows = min(kPackRows, rows.rows[b] - r0);
  const int pos = rows.offs[b] + r0 + lane;
  const int idx = lane < nrows && pos < nseg ? sidx[pos] : 0;
  uint4 raw[kPackRows / 4];
#pragma unroll
  for (int k = 0; k < kPackRows / 4; ++k) {
    const int ik = __shfl_sync(0xffffffffu, idx, 4 * k + (lane >> 3));
    raw[k] = ((const uint4*)(zs + (long long)ik * kLF))[lane & 7];
  }
  uint32_t* st = stage[warp];
#pragma unroll
  for (int k = 0; k < kPackRows / 4; ++k) {
    uint32_t* d = st + (4 * k + (lane >> 3)) * kStage + 4 * (lane & 7);
    d[0] = raw[k].x, d[1] = raw[k].y, d[2] = raw[k].z, d[3] = raw[k].w;
  }
  __syncwarp();
  const int slots = 32 / kFine[b];
  uint32_t* out = blob + rows.woff[b] +
                  (long long)r0 * ((kLF + slots - 1) / slots);
  switch (b) {
    case 0: fine_words<1>(st, nrows, lane, out); break;
    case 1: fine_words<2>(st, nrows, lane, out); break;
    case 2: fine_words<3>(st, nrows, lane, out); break;
    case 3: fine_words<4>(st, nrows, lane, out); break;
    case 4: fine_words<5>(st, nrows, lane, out); break;
    case 5: fine_words<6>(st, nrows, lane, out); break;
    case 6: fine_words<8>(st, nrows, lane, out); break;
    default: fine_words<10>(st, nrows, lane, out); break;
  }
}

// ---------------------------------------------------------------------------
// B21: the device pack of a 10-bit (H, W) plane for readback, the inverse
// of B14's layout. Widths (plane_widths_kernel): a warp per (32-row
// group, 256-column segment), lane i owning columns 8i..8i+7 of the
// segment: each row's zigzag vertical delta mod 1024 (the group's first
// row against 0, so no warp loads a row above; columns at or past w
// repeat column w - 1) into zs with one 16-byte store a lane, and the
// segment's width code in {0, 2, 5, 10} from one __reduce_max_sync. Pack (plane_pack_kernel): one warp per output row of
// the three buckets; the host's gather index names the row's segment
// (JAX uploads the same); sample j in word j % nw at shift (j / nw) *
// width, the slots summed as JAX sums them.
// ---------------------------------------------------------------------------

// Columns x0..x0+7 of a u16 row, clamped to w - 1: one 16-byte load where
// the eight columns lie inside an aligned row, else one load a column.
__device__ __forceinline__ void load_plane8(const uint16_t* __restrict__ p,
                                            int w, int x0, int (&v)[8]) {
  if (x0 + 8 <= w && ((size_t)(p + x0) & 15) == 0) {
    const uint4 t = __ldg((const uint4*)(p + x0));
    const uint32_t q[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (q[e >> 1] >> (16 * (e & 1))) & 0xFFFF;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __ldg(p + min(x0 + e, w - 1));
  }
}

__global__ void __launch_bounds__(256)
plane_widths_kernel(const uint16_t* __restrict__ arr, int h, int w,
                    int nsegw, uint16_t* __restrict__ zs,
                    uint8_t* __restrict__ bc) {
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int grp = wid / nsegw, seg = wid - grp * nsegw;
  const int r0 = grp * kG;
  if (r0 >= h) return;
  const int r1 = min(r0 + kG, h);
  const int x0 = seg * kL + lane * 8;
  int up[8], nx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) up[e] = 0;
  load_plane8(arr + (long long)r0 * w, w, x0, nx);
  for (int r = r0; r < r1; ++r) {
    int c[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = nx[e];
    if (r + 1 < r1) load_plane8(arr + (long long)(r + 1) * w, w, x0, nx);
    uint32_t z[8], zmax = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      z[e] = (uint32_t)zigzag_bits((c[e] - up[e]) & 1023, 10);
      zmax = max(zmax, z[e]);
      up[e] = c[e];
    }
    const long long q = (long long)r * nsegw + seg;
    *(uint4*)(zs + q * kL + lane * 8) =
        make_uint4(z[0] | (z[1] << 16), z[2] | (z[3] << 16),
                   z[4] | (z[5] << 16), z[6] | (z[7] << 16));
    const uint32_t m = __reduce_max_sync(0xffffffffu, zmax);
    if (lane == 0)
      bc[q] = (uint8_t)(m > 31 ? 10 : m > 3 ? 5 : m > 0 ? 2 : 0);
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
// A CTA per output row, a thread per 16-byte chunk of it: the row's part
// and source rows are resolved once (the same for the whole CTA), then
// each thread loads its 16 bytes (one 16-byte load where the source is
// 16-byte aligned, two 8-byte loads where it is 8-byte aligned, else five
// aligned words and funnel shifts; a byte path only for the chunk that
// crosses the part's last column or U|V's seam) and stores them with one
// 16-byte store where the output row is aligned (wc a multiple of 16),
// else four words or single bytes.
// ---------------------------------------------------------------------------

// 16 bytes of source row p from column c, columns past `last` repeating
// column `last` (edge padding): byte e of the chunk in bits 8 (e & 3) of
// v[e >> 2].
__device__ __forceinline__ void load_chunk(const uint8_t* p, int c, int last,
                                           uint32_t (&v)[4]) {
  if (c + 15 <= last) {
    const size_t a = (size_t)(p + c);
    if ((a & 15) == 0) {
      const uint4 t = __ldg((const uint4*)a);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if ((a & 7) == 0) {
      const uint2 t0 = __ldg((const uint2*)a), t1 = __ldg((const uint2*)a + 1);
      v[0] = t0.x, v[1] = t0.y, v[2] = t1.x, v[3] = t1.y;
    } else {
      // The aligned words that hold the chunk; the fifth only when the
      // chunk starts mid-word (it then holds a byte of the chunk).
      const uint32_t* wp = (const uint32_t*)(a & ~(size_t)3);
      const int sh = 8 * (int)(a & 3);
      uint32_t x[5];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = __ldg(wp + k);
      x[4] = sh ? __ldg(wp + 4) : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(x[k], x[k + 1], sh);
    }
  } else if (c >= last) {
    const uint32_t e = (uint32_t)__ldg(p + last) * 0x01010101u;
    v[0] = v[1] = v[2] = v[3] = e;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e >> 2] |= (uint32_t)__ldg(p + min(c + e, last)) << (8 * (e & 3));
  }
}

// n (<= 16) bytes of v at d: one 16-byte store where d is aligned, four
// words where it is word-aligned, else single bytes.
__device__ __forceinline__ void store_chunk(uint8_t* d, const uint32_t (&v)[4],
                                            int n) {
  if (n == 16 && ((size_t)d & 15) == 0) {
    *(uint4*)d = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (n == 16 && ((size_t)d & 3) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) ((uint32_t*)d)[q] = v[q];
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (e < n) d[e] = (uint8_t)(v[e >> 2] >> (8 * (e & 3)));
  }
}

__global__ void __launch_bounds__(256)
composite_kernel(Plane yp, Plane up, Plane vp, Plane gp, int h, int w,
                 int ch, int cw, int gh, int gw, int rows, int wc,
                 uint8_t* __restrict__ out) {
  const int R = blockIdx.x, b = R / rows, r = R - b * rows;
  const uint8_t* s0;            // Y, U or the gain map row
  const uint8_t* s1 = nullptr;  // V, beside U
  int last;                     // the last column of each
  if (r < h) {
    s0 = yp.row(b, r), last = w - 1;
  } else if (r < h + ch) {
    s0 = up.row(b, r - h), s1 = vp.row(b, r - h), last = cw - 1;
  } else {
    s0 = gp.row(b, min(r - h - ch, gh - 1)), last = gw - 1;
  }
  uint8_t* o = out + (long long)R * wc;
  for (int x0 = 16 * threadIdx.x; x0 < wc; x0 += 16 * blockDim.x) {
    uint32_t v[4];
    if (!s1 || x0 + 16 <= cw) {
      load_chunk(s0, x0, last, v);
    } else if (x0 >= cw) {
      load_chunk(s1, x0 - cw, last, v);
    } else {  // U's last columns, then V's first
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int x = x0 + e;
        const uint32_t t = x < cw ? s0[x] : s1[min(x - cw, last)];
        v[e >> 2] |= t << (8 * (e & 3));
      }
    }
    store_chunk(o + x0, v, min(16, wc - x0));
  }
}

inline int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

// The tiled order of B16 and B17: count, scan, place (tcnt: kMaxRanks x
// ntiles scratch; sidx1 only for a second family).
template <class R>
void launch_order(const R& rank_of, const typename R::Out& out, int nseg,
                  int* tcnt, int32_t* sidx0, int32_t* sidx1,
                  cudaStream_t st) {
  const int ntiles = (nseg + kOrderTile - 1) / kOrderTile;
  order_count_kernel<R><<<ntiles, 256, 0, st>>>(rank_of, nseg, tcnt, ntiles);
  order_scan_kernel<R><<<1, 1024, 0, st>>>(tcnt, ntiles, out);
  order_place_kernel<R><<<ntiles, 256, 0, st>>>(rank_of, nseg, tcnt, ntiles,
                                                sidx0, sidx1);
}

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
  const long long off5 = (long long)n2 * 16;
  const long long off10 = off5 + (long long)n5 * 43;
  const long long offperm = off10 + (long long)n10 * 86;
  if (offperm + (long long)rows * nsegw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // word offsets are 32-bit
  if (rows == 0 || w == 0) return 0;
  SegPlan p{rows, w, nsegw, yrows, n2, n5, (uint32_t)off5, (uint32_t)off10,
            (uint32_t)offperm};
  seg_kernel<<<blocks((long long)rows / kG * nsegw, kSegWarps),
               kSegWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blob, p, (uint16_t*)y, (uint16_t*)uv);
  return (int)cudaGetLastError();
}

// B15. src: the u8 composite (bits 8, nh = rows / 3), the (n, h, w)
// u32 RGBA1010102 batch (bits 10) or the (n, h, w, 4) u16 F16 batch
// (bits 16), nh = n * h, rows = 3 * nh stacked rows of width w;
// zs0/zs1: (nseg, 256) int16 (zs1 only in mode 2); maps: (2 or 4, nseg)
// u8, or null for the residuals alone.
int uhdr_rice_stats(const void* src, long long rows, int w, int nsegw,
                    int mode, int bits, long long nh, void* zs0, void* zs1,
                    void* maps, void* stream) {
  const long long nseg = rows * nsegw;
  const long long nrows = bits == 8 ? rows : nh;
  const long long warps = (nrows + kRiceRun - 1) / kRiceRun * nsegw;
  using Kernel = void (*)(const void*, int, int, long long, long long,
                          int16_t*, int16_t*, uint8_t*);
  // Without maps, the load and residuals alone (chip_smoke.py times
  // B15's two parts apart so).
  static const Kernel kernels[2][3][3] = {
      {{stats_kernel<8, 0>, stats_kernel<8, 1>, stats_kernel<8, 2>},
       {stats_kernel<10, 0>, stats_kernel<10, 1>, stats_kernel<10, 2>},
       {stats_kernel<16, 0>, stats_kernel<16, 1>, stats_kernel<16, 2>}},
      {{stats_kernel<8, 0, false>, stats_kernel<8, 1, false>,
        stats_kernel<8, 2, false>},
       {stats_kernel<10, 0, false>, stats_kernel<10, 1, false>,
        stats_kernel<10, 2, false>},
       {stats_kernel<16, 0, false>, stats_kernel<16, 1, false>,
        stats_kernel<16, 2, false>}}};
  const Kernel kernel =
      kernels[maps ? 0 : 1][bits == 16 ? 2 : (bits == 10 ? 1 : 0)][mode];
  kernel<<<blocks(warps, 8), 256, 0, (cudaStream_t)stream>>>(
      src, w, nsegw, nrows, nseg, (int16_t*)zs0, (int16_t*)zs1,
      (uint8_t*)maps);
  return (int)cudaGetLastError();
}


// B16 order. kmap/uwmap: nseg u8 each; nk: 10 or 16 remainder widths;
// sidx_rem/sidx_un: nseg int32 out; offs: nk + 7 int32 out or null;
// head: nk + 11 u32 out or null (with the pads, nk and 7 host ints, for
// its fit flag); pad: bytes to zero after the map (fused layout);
// scratch: uhdr_rice_order_scratch(nseg) int32.
int uhdr_rice_order(const void* kmap, const void* uwmap, int nseg, int nk,
                    void* sidx_rem, void* sidx_un, void* offs, void* head,
                    int med, const int* rem_pads, const int* un_pads,
                    void* pad, int npad, void* scratch, void* stream) {
  RicePads pads;
  for (int j = 0; j < 16; ++j) pads.rem[j] = j < nk ? rem_pads[j] : 0;
  for (int c = 0; c < 7; ++c) pads.un[c] = un_pads[c];
  const cudaStream_t st = (cudaStream_t)stream;
  if (nk == 16)
    launch_order(RiceRanks<16>{(const uint8_t*)kmap, (const uint8_t*)uwmap},
                 RiceRanks<16>::Out{(int32_t*)offs, (uint32_t*)head, med,
                                    pads, (uint8_t*)pad, npad},
                 nseg, (int*)scratch, (int32_t*)sidx_rem, (int32_t*)sidx_un,
                 st);
  else
    launch_order(RiceRanks<10>{(const uint8_t*)kmap, (const uint8_t*)uwmap},
                 RiceRanks<10>::Out{(int32_t*)offs, (uint32_t*)head, med,
                                    pads, (uint8_t*)pad, npad},
                 nseg, (int*)scratch, (int32_t*)sidx_rem, (int32_t*)sidx_un,
                 st);
  return (int)cudaGetLastError();
}

// int32 scratch of the tiled order (uhdr_rice_order, uhdr_rct_order,
// uhdr_rct_pack) for nseg segments: tile rank counts.
int uhdr_rice_order_scratch(int nseg) {
  return kMaxRanks * ((nseg + kOrderTile - 1) / kOrderTile);
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
  emit_kernel<<<blocks(rows.start[nb], 8 * kEmitRows), 256, 0,
                (cudaStream_t)stream>>>(
      (const uint16_t*)zs, (const uint8_t*)kmap, (const int32_t*)sidx_rem,
      (const int32_t*)sidx_un, (const int32_t*)offs, nseg, nk, rows,
      (uint32_t*)blob);
  return (int)cudaGetLastError();
}

// B17 pass 1. src: (n, h, w) u32, nh = n * h; zs: (3 * nh * nsegw, 64)
// u16; bc: 3 * nh * nsegw u8.
int uhdr_rct_widths(const void* src, long long nh, int w, int nsegw,
                    void* zs, void* bc, void* stream) {
  const int nspan = (nsegw + 3) / 4;
  const long long warps = (nh + kFineRun - 1) / kFineRun * nspan;
  if (warps == 0) return 0;
  if (warps >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  rct_widths_kernel<<<blocks(warps, 8), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, w, nsegw, nspan, nh, (uint16_t*)zs,
      (uint8_t*)bc);
  return (int)cudaGetLastError();
}

// B17 order. bc: nseg u8 width codes; sidx: nseg int32 out (each
// segment's place in the stable width-rank order); totals: 9 int32 out
// (each rank's count), or null; scratch: uhdr_rice_order_scratch(nseg)
// int32.
int uhdr_rct_order(const void* bc, int nseg, void* sidx, void* totals,
                   void* scratch, void* stream) {
  launch_order(FineRanks{(const uint8_t*)bc}, FineRanks::Out{(int32_t*)totals},
               nseg, (int*)scratch, (int32_t*)sidx, nullptr,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// B17 pack: the order, then the buckets. zs, bc: pass 1's; sidx: nseg
// int32 scratch; scratch: uhdr_rice_order_scratch(nseg) int32; npads,
// offs (8 each): the buckets' padded rows and first places (host ints);
// blob: the u32 words of the 8 buckets.
int uhdr_rct_pack(const void* zs, const void* bc, int nseg, void* sidx,
                  void* scratch, const int* npads, const int* offs,
                  void* blob, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  FineRows rows;
  rows.tile[0] = 0;
  long long woff = 0;
  for (int b = 0; b < 8; ++b) {
    const int slots = 32 / (b < 6 ? b + 1 : (b == 6 ? 8 : 10));
    rows.tile[b + 1] = rows.tile[b] + (npads[b] + kPackRows - 1) / kPackRows;
    rows.rows[b] = npads[b];
    rows.offs[b] = offs[b];
    rows.woff[b] = woff;
    woff += (long long)npads[b] * ((kLF + slots - 1) / slots);
  }
  launch_order(FineRanks{(const uint8_t*)bc}, FineRanks::Out{nullptr}, nseg,
               (int*)scratch, (int32_t*)sidx, nullptr, st);
  if (rows.tile[8] > 0)
    fine_pack_kernel<<<blocks(rows.tile[8], 8), 256, 0, st>>>(
        (const uint16_t*)zs, (const int32_t*)sidx, nseg, rows,
        (uint32_t*)blob);
  return (int)cudaGetLastError();
}

// B21 widths. arr: (h, w) u16 10-bit; zs: (h * nsegw, 256) u16; bc:
// h * nsegw u8.
int uhdr_plane_widths(const void* arr, int h, int w, int nsegw, void* zs,
                      void* bc, void* stream) {
  const long long warps = (long long)((h + kG - 1) / kG) * nsegw;
  if (warps == 0) return 0;
  if (warps >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  plane_widths_kernel<<<blocks(warps, 8), 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)arr, h, w, nsegw, (uint16_t*)zs, (uint8_t*)bc);
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
  const long long total = (long long)n * rows;
  const int chunks = (wc + 15) / 16;
  const int threads = chunks < 256 ? (chunks + 31) / 32 * 32 : 256;
  if (total == 0 || wc == 0) return 0;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  composite_kernel<<<(unsigned)total, threads, 0, (cudaStream_t)stream>>>(
      yp, up, vp, gp, h, w, ch, cw, gh, gw, rows, wc, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
