// Native host halves of the packed transfers: the port's copy of
// libultrahdr_dev_tpu/jpeg/native/packio.cpp (built alone by
// jpeg/native.py with the JAX package's compiler flags). Changed from
// the JAX file: the unary position scratch `posb` is sized from
// kRiceUcls instead of a literal. The port calls uhdr_seg_widths /
// uhdr_seg_fill (the upload pack, parallel/packio.py pack_plane_host),
// the planar-u8 Rice unpacks uhdr_rice8_unpack(_mt) /
// uhdr_med8_unpack(_mt) (the planes readback, fetch_planes_u8), the
// RCT (10-bit) and F16 Rice unpacks uhdr_{rice,med}{,16}_unpack(_mt)
// (the pixel readbacks, fetch_rgba1010102_* / fetch_rgba_f16_*) and
// uhdr_rctseg_unpack (the fine-width readback,
// fetch_rgba1010102_batch).
//
// First family, the RCT + fine-width segment readback: the device packs
// a decoded RGBA1010102 batch as zigzagged vertical deltas of the
// decorrelated (G, R-G, B-G) planes, bucketed per 64-sample segment by
// bit width; uhdr_rctseg_unpack reverses all of it — word unpack,
// un-zigzag, 32-row grouped prefix sum, channel recorrelation and the
// final u32 pack — in one cache-friendly sweep.
//
// Layout contract (must match parallel/packio.py):
//   FINE_WIDTHS = {1,2,3,4,5,6,8,10}; LF = 64 samples/segment; G = 32
//   rows per delta group (row 0 of each group is a raw delta vs 0).
//   bmap: (3*n*h * ceil(w/64)) u8 width codes in original segment
//   order (0 = all-zero segment). blob: per-width buckets of u32
//   words, each bucket's rows ordered by original segment index
//   (the device's stable (rank, index) sort); sample j of a segment
//   lives in word j % nw at shift (j / nw) * width.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr int kWidths[8] = {1, 2, 3, 4, 5, 6, 8, 10};
constexpr int LF = 64;
constexpr int GROUP = 32;

inline int words_per_seg(int bw) {
  int k = 32 / bw;
  return (LF + k - 1) / k;
}

}  // namespace

extern "C" {

// Returns 0 on success, negative on malformed inputs. `scratch` is a
// caller-allocated u16 buffer of n*h*w (holds the decoded G plane
// until the difference planes re-correlate against it); `out` is the
// (n, h, w) RGBA1010102 result.
long uhdr_rctseg_unpack(const uint8_t* bmap, const uint32_t* blob,
                        const int64_t* bucket_word_offs,  // 8 entries
                        int64_t n, int64_t h, int64_t w,
                        uint16_t* scratch, uint32_t* out) {
  // Any row count works: groups reset at global row % GROUP == 0
  // positions and the tail group may be partial (matches the
  // device preamble and the numpy tails).
  if (n <= 0 || h <= 0 || w <= 0)
    return -1;
  const int64_t nsegw = (w + LF - 1) / LF;
  const int64_t plane_rows = n * h;

  // Per-bucket fill counters: segments are visited in original order,
  // matching the device sort's within-bucket ordering.
  int64_t fill[8] = {0};
  int rank_of[11];
  for (int i = 0; i < 11; ++i) rank_of[i] = -1;
  for (int j = 0; j < 8; ++j) rank_of[kWidths[j]] = j;

  int32_t acc[8192 + LF];  // running column sums for one row stripe
  const uint8_t* bm = bmap;
  if (w > 8192) return -2;

  for (int plane = 0; plane < 3; ++plane) {
    for (int64_t r = 0; r < plane_rows; ++r) {
      const int64_t grow = plane * plane_rows + r;
      if (grow % GROUP == 0) std::memset(acc, 0, sizeof(int32_t) * ((nsegw * LF)));
      for (int64_t s = 0; s < nsegw; ++s, ++bm) {
        const int bw = *bm;
        if (bw == 0) continue;  // all-zero deltas: acc unchanged
        // The width map crossed an untrusted link: reject any byte
        // outside {0} + FINE_WIDTHS instead of indexing out of
        // bounds below.
        if (bw > 10 || rank_of[bw] < 0) return -3;
        const int j = rank_of[bw];
        const int nw = words_per_seg(bw);
        const uint32_t* words = blob + bucket_word_offs[j] + fill[j]++ * nw;
        const uint32_t mask = (1u << bw) - 1;
        int32_t* a = acc + s * LF;
        const int k = 32 / bw;
        int idx = 0;
        for (int slot = 0; slot < k && idx < LF; ++slot) {
          const int shift = slot * bw;
          for (int wi = 0; wi < nw && idx < LF; ++wi, ++idx) {
            const uint32_t v = (words[wi] >> shift) & mask;
            const int32_t d = (int32_t)(v >> 1) ^ -(int32_t)(v & 1);
            a[idx] += d;
          }
        }
      }
      // Emit the row: recorrelate against the G plane and pack.
      const int64_t rowbase = r * w;  // index inside the (n*h, w) plane
      if (plane == 0) {
        uint32_t* o = out + rowbase;
        uint16_t* gb = scratch + rowbase;
        for (int64_t x = 0; x < w; ++x) {
          const uint16_t g = (uint16_t)(acc[x] & 1023);
          gb[x] = g;
          o[x] = ((uint32_t)g << 10) | 0xC0000000u;
        }
      } else if (plane == 1) {
        uint32_t* o = out + rowbase;
        const uint16_t* gb = scratch + rowbase;
        for (int64_t x = 0; x < w; ++x)
          o[x] |= (uint32_t)((acc[x] + gb[x]) & 1023);
      } else {
        uint32_t* o = out + rowbase;
        const uint16_t* gb = scratch + rowbase;
        for (int64_t x = 0; x < w; ++x)
          o[x] |= (uint32_t)((acc[x] + gb[x]) & 1023) << 20;
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Rice readback unpack (10-bit RGBA1010102 and F16-halves variants).
//
// Layout contract (must match packio.py): RL = 256 samples/segment.
// 10-bit: k in 0..9, k-code 15 = all-zero segment, mod-1024 RCT tail,
// (n, h, w) u32 output. F16: k in 0..15, k-code 31, mod-2^16 tail,
// (n, h, w, 4) u16 output with constant alpha 0x3C00. Unary classes
// {8,10,12,14,16,20,24} words. Walking segments in original order
// with per-bucket fill counters reproduces the device's stable
// (rank, index) sort for BOTH bucket families at once.
//
// The walker below decodes an arbitrary GROUP-aligned global-row
// range given that range's starting fill counters, which makes the
// multi-threaded entry points (uhdr_rice_unpack_mt /
// uhdr_rice16_unpack_mt) possible: a prescan of the per-segment maps
// yields each chunk's fill counters, and chunks decode in parallel.
// Planes run as three barriered phases — the 1010102 emit ORs the
// R/G/B fields into one u32, so plane-1 and plane-2 rows of the same
// r must never run concurrently.

namespace {

constexpr int kRiceUcls[7] = {8, 10, 12, 14, 16, 20, 24};
constexpr int kRiceRL = 256;

// Decode global rows [g0, g1) of the 3-plane delta stack. g0 must be
// GROUP-aligned (or 0). fill_rem[kcap+1] / fill_un[7] are the
// starting per-bucket fill counters for this range. emit(plane, r,
// acc) writes one recorrelated row. Returns 0 or a negative error.
// Decode global rows [g0, g1), emitting only rows >= emit_from. g0
// must be GROUP-aligned (or 0); rows in [g0, emit_from) are warm-up —
// they rebuild the running column sums so a chunk boundary can sit
// anywhere, at a cost of at most GROUP-1 re-decoded rows per chunk.
// MED=false: acc accumulates vertical deltas per column (reset per
// GROUP). MED=true: acc is re-zeroed every row, so after the segment
// loop it holds THIS row's un-zigzagged residuals; the (stateful)
// emit then runs the sequential MED predictor reconstruction. Emits
// are called for every row with `live` false during warm-up (a MED
// emit must still reconstruct to maintain its previous-row state).
template <bool MED, typename Emit>
long rice_walk_rows(const uint8_t* kmap, const uint8_t* uwmap,
                    const uint32_t* blob,
                    const int64_t* rem_word_offs,
                    const int64_t* un_word_offs,
                    int kzero, int kcap,
                    int64_t nsegw, int64_t plane_rows, int64_t w,
                    int64_t g0, int64_t g1, int64_t emit_from,
                    int64_t* fill_rem, int64_t* fill_un,
                    Emit&& emit) {
  int32_t acc[8192 + kRiceRL];
  // Segment scratch, sized for the structure the loops want to keep
  // vectorizable: remainders widened to i32, and set-bit positions
  // over the widest unary class (kRiceUcls[6] words, 768 possible bits on
  // corrupt input; valid segments carry exactly RL).
  alignas(64) int32_t rem32[kRiceRL];
  alignas(64) int32_t posb[kRiceUcls[6] * 32 + 16];
  constexpr int RL = kRiceRL;
  if (g0 != 0 && g0 % GROUP != 0) return -6;
  const uint8_t* km = kmap + g0 * nsegw;
  const uint8_t* um = uwmap + g0 * nsegw;
  for (int64_t grow = g0; grow < g1; ++grow) {
    // Vertical mode accumulates column sums across the GROUP, so the
    // stripe resets at group starts. MED mode writes (not adds) each
    // segment's residuals, so only all-zero segments need clearing —
    // this skips a full-width memset per row (~16 KB/row at 4K).
    if (!MED && grow % GROUP == 0)
      std::memset(acc, 0, sizeof(int32_t) * (nsegw * RL));
    for (int64_t s = 0; s < nsegw; ++s, ++km, ++um) {
      const int k = *km;
      if (k == kzero) {  // all-zero segment
        if (MED) std::memset(acc + s * RL, 0, sizeof(int32_t) * RL);
        continue;
      }
      if (k > kcap) return -3;  // map crossed an untrusted link
      // 1. Remainders, slot-major: sample j of the segment sits in
      // word j % nw at shift (j / nw) * k, so each slot's nw samples
      // are contiguous in both the words and rem32 — a vector shift
      // and mask per stripe instead of the scalar per-sample walk.
      if (k > 0) {
        const int ks = 32 / k;
        const int nw = (RL + ks - 1) / ks;
        const uint32_t* words =
            blob + rem_word_offs[k] + fill_rem[k]++ * nw;
        const uint32_t mask = (1u << k) - 1;
        for (int slot = 0; slot < ks; ++slot) {
          const int base = slot * nw;
          if (base >= RL) break;
          const int cnt = (base + nw <= RL) ? nw : RL - base;
          const int shift = slot * k;
          for (int wi = 0; wi < cnt; ++wi)
            rem32[base + wi] =
                (int32_t)((words[wi] >> shift) & mask);
        }
      } else {
        std::memset(rem32, 0, sizeof(rem32));
      }
      // 2. Unary terminator positions. AVX-512 compress-store turns
      // each 16-bit half word into one masked iota store (~8 ops per
      // word) vs the ~3-ops-per-BIT scalar ctz walk.
      const int uw = *um;
      int c = 0;
      while (c < 7 && kRiceUcls[c] < uw) ++c;
      if (c >= 7) return -4;
      const int wc = kRiceUcls[c];
      const uint32_t* uwords =
          blob + un_word_offs[c] + fill_un[c]++ * (int64_t)wc;
      int idx = 0;
#if defined(__AVX512F__)
      {
        const __m512i iota = _mm512_setr_epi32(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
        const __m512i hi16 = _mm512_set1_epi32(16);
        for (int wi = 0; wi < wc; ++wi) {
          const uint32_t bits = uwords[wi];
          __m512i v = _mm512_add_epi32(iota,
                                       _mm512_set1_epi32(wi * 32));
          _mm512_mask_compressstoreu_epi32(
              posb + idx, (__mmask16)(bits & 0xFFFF), v);
          idx += __builtin_popcount(bits & 0xFFFF);
          v = _mm512_add_epi32(v, hi16);
          _mm512_mask_compressstoreu_epi32(
              posb + idx, (__mmask16)(bits >> 16), v);
          idx += __builtin_popcount(bits >> 16);
        }
      }
#else
      for (int wi = 0; wi < wc; ++wi) {
        uint32_t bits = uwords[wi];
        const int32_t base = wi * 32;
        while (bits) {
          posb[idx++] = base + __builtin_ctz(bits);
          bits &= bits - 1;
        }
      }
#endif
      // Exactly RL terminators are expected; extra set bits past the
      // RL-th (possible only on corrupt input) are ignored, matching
      // the incremental walk this replaced.
      if (idx < RL) return -5;  // corrupt unary bitmap
      // 3. Gaps + remainders -> un-zigzagged deltas, elementwise.
      int32_t* a = acc + s * RL;
      {
        const uint32_t z0 =
            ((uint32_t)posb[0] << k) | (uint32_t)rem32[0];
        const int32_t d0 = (int32_t)(z0 >> 1) ^ -(int32_t)(z0 & 1);
        if (MED) a[0] = d0; else a[0] += d0;
      }
      for (int i = 1; i < RL; ++i) {
        const uint32_t z =
            ((uint32_t)(posb[i] - posb[i - 1] - 1) << k)
            | (uint32_t)rem32[i];
        const int32_t d = (int32_t)(z >> 1) ^ -(int32_t)(z & 1);
        if (MED) a[i] = d; else a[i] += d;
      }
    }
    emit((int)(grow / plane_rows), grow % plane_rows, acc,
         grow >= emit_from);
  }
  return 0;
}

// Emit one row of the (n, h, w) u32 RGBA1010102 result.
struct Emit1010102 {
  int64_t w;
  uint16_t* scratch;
  uint32_t* out;
  inline void operator()(int plane, int64_t r, const int32_t* acc,
                         bool live) const {
    if (!live) return;
    const int64_t rowbase = r * w;
    if (plane == 0) {
      uint32_t* o = out + rowbase;
      uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x) {
        const uint16_t g = (uint16_t)(acc[x] & 1023);
        gb[x] = g;
        o[x] = ((uint32_t)g << 10) | 0xC0000000u;
      }
    } else if (plane == 1) {
      uint32_t* o = out + rowbase;
      const uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x)
        o[x] |= (uint32_t)((acc[x] + gb[x]) & 1023);
    } else {
      uint32_t* o = out + rowbase;
      const uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x)
        o[x] |= (uint32_t)((acc[x] + gb[x]) & 1023) << 20;
    }
  }
};

// Emit one row of the (n, h, w, 4) u16 RGBA-halves result.
struct EmitF16 {
  int64_t w;
  uint16_t* scratch;
  uint16_t* out;
  inline void operator()(int plane, int64_t r, const int32_t* acc,
                         bool live) const {
    if (!live) return;
    const int64_t rowbase = r * w;
    uint16_t* o = out + rowbase * 4;
    if (plane == 0) {
      uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x) {
        const uint16_t g = (uint16_t)(acc[x] & 0xFFFF);
        gb[x] = g;
        o[x * 4 + 1] = g;
        o[x * 4 + 3] = 0x3C00;  // alpha = f16(1.0)
      }
    } else if (plane == 1) {
      const uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x)
        o[x * 4 + 0] = (uint16_t)((acc[x] + gb[x]) & 0xFFFF);
    } else {
      const uint16_t* gb = scratch + rowbase;
      for (int64_t x = 0; x < w; ++x)
        o[x * 4 + 2] = (uint16_t)((acc[x] + gb[x]) & 0xFFFF);
    }
  }
};

// Emit one row of an (n, 3h, w) u8 planar composite (the decode
// intermediates readback): the three "planes" are just the
// composite's thirds — no recorrelation, value = acc mod 256.
struct EmitPlanar8 {
  int64_t w;
  int64_t plane_rows;
  uint8_t* out;
  inline void operator()(int plane, int64_t r, const int32_t* acc,
                         bool live) const {
    if (!live) return;
    uint8_t* o = out + (plane * plane_rows + r) * w;
    for (int64_t x = 0; x < w; ++x)
      o[x] = (uint8_t)(acc[x] & 255);
  }
};

// Planar-u8 MED emit: LOCO-I reconstruction mod 256, written straight
// to the composite row (no recorrelation). Stateful like EmitMed.
struct EmitPlanarMed8 {
  int64_t w;
  int64_t plane_rows;
  uint8_t* out;
  std::vector<int32_t> prev, cur;
  EmitPlanarMed8(int64_t w_, int64_t pr, uint8_t* o)
      : w(w_), plane_rows(pr), out(o), prev(w_), cur(w_) {}
  inline void operator()(int plane, int64_t r, const int32_t* res,
                         bool live) {
    const bool gstart = (plane * plane_rows + r) % GROUP == 0;
    int32_t left = 0;
    for (int64_t x = 0; x < w; ++x) {
      const int32_t up = gstart ? 0 : prev[x];
      const int32_t ul = (gstart || x == 0) ? 0 : prev[x - 1];
      const int32_t mx = left > up ? left : up;
      const int32_t mn = left < up ? left : up;
      const int32_t pred =
          ul >= mx ? mn : (ul <= mn ? mx : left + up - ul);
      left = (pred + res[x]) & 255;
      cur[x] = left;
    }
    if (live) {
      uint8_t* o = out + (plane * plane_rows + r) * w;
      for (int64_t x = 0; x < w; ++x) o[x] = (uint8_t)cur[x];
    }
    prev.swap(cur);
  }
};

// MED reconstruction emit: residuals (already un-zigzagged) arrive
// per row in `acc`; reconstruct cur[x] = MED(left, up, upleft) + res
// mod 2^BITS in the decorrelated plane domain, then recorrelate and
// write when live. Stateful (previous-row buffer) — each thread gets
// its own instance via the emit factory; warm-up rows reconstruct
// without writing, so chunk starts only need GROUP alignment (group-
// start rows predict from left alone: up = upleft = 0).
template <int BITS, typename OutT>
struct EmitMed {
  int64_t w;
  int64_t plane_rows;
  uint16_t* scratch;
  OutT* out;
  std::vector<int32_t> prev, cur;
  EmitMed(int64_t w_, int64_t pr, uint16_t* sc, OutT* o)
      : w(w_), plane_rows(pr), scratch(sc), out(o),
        prev(w_), cur(w_) {}
  inline void operator()(int plane, int64_t r, const int32_t* res,
                         bool live) {
    constexpr int32_t mask = (1 << BITS) - 1;
    const bool gstart = (plane * plane_rows + r) % GROUP == 0;
    int32_t left = 0;
    for (int64_t x = 0; x < w; ++x) {
      const int32_t up = gstart ? 0 : prev[x];
      const int32_t ul = (gstart || x == 0) ? 0 : prev[x - 1];
      const int32_t mx = left > up ? left : up;
      const int32_t mn = left < up ? left : up;
      const int32_t pred =
          ul >= mx ? mn : (ul <= mn ? mx : left + up - ul);
      left = (pred + res[x]) & mask;
      cur[x] = left;
    }
    if (live) {
      const int64_t rowbase = r * w;
      if (BITS == 10) {
        uint32_t* o = (uint32_t*)out + rowbase;
        if (plane == 0) {
          uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x) {
            const uint16_t g = (uint16_t)cur[x];
            gb[x] = g;
            o[x] = ((uint32_t)g << 10) | 0xC0000000u;
          }
        } else if (plane == 1) {
          const uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x)
            o[x] |= (uint32_t)((cur[x] + gb[x]) & mask);
        } else {
          const uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x)
            o[x] |= (uint32_t)((cur[x] + gb[x]) & mask) << 20;
        }
      } else {
        uint16_t* o = (uint16_t*)out + rowbase * 4;
        if (plane == 0) {
          uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x) {
            const uint16_t g = (uint16_t)cur[x];
            gb[x] = g;
            o[x * 4 + 1] = g;
            o[x * 4 + 3] = 0x3C00;
          }
        } else if (plane == 1) {
          const uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x)
            o[x * 4 + 0] = (uint16_t)((cur[x] + gb[x]) & mask);
        } else {
          const uint16_t* gb = scratch + rowbase;
          for (int64_t x = 0; x < w; ++x)
            o[x * 4 + 2] = (uint16_t)((cur[x] + gb[x]) & mask);
        }
      }
    }
    prev.swap(cur);
  }
};

template <bool MED, typename EmitFactory>
long rice_unpack_serial(const uint8_t* kmap, const uint8_t* uwmap,
                        const uint32_t* blob,
                        const int64_t* rem_word_offs,
                        const int64_t* un_word_offs,
                        int kzero, int kcap,
                        int64_t n, int64_t h, int64_t w,
                        EmitFactory&& make_emit) {
  if (n <= 0 || h <= 0 || w <= 0) return -1;
  if (w > 8192) return -2;
  const int64_t nsegw = (w + kRiceRL - 1) / kRiceRL;
  const int64_t plane_rows = n * h;
  int64_t fill_rem[16] = {0};
  int64_t fill_un[7] = {0};
  auto emit = make_emit();
  return rice_walk_rows<MED>(kmap, uwmap, blob, rem_word_offs,
                             un_word_offs, kzero, kcap, nsegw,
                             plane_rows, w, 0, 3 * plane_rows, 0,
                             fill_rem, fill_un, emit);
}

// Multi-threaded unpack: three barriered plane phases (plane 0 first
// — it writes the G scratch the others recorrelate against; planes
// 1/2 separately because the 1010102 emit ORs into shared words),
// each phase split into GROUP-aligned row chunks whose starting fill
// counters come from one linear prescan of the maps.
template <bool MED, typename EmitFactory>
long rice_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                    const uint32_t* blob,
                    const int64_t* rem_word_offs,
                    const int64_t* un_word_offs,
                    int kzero, int kcap,
                    int64_t n, int64_t h, int64_t w, long nthreads,
                    EmitFactory&& make_emit) {
  if (n <= 0 || h <= 0 || w <= 0) return -1;
  if (w > 8192) return -2;
  const int64_t plane_rows = n * h;
  long T = nthreads;
  if (T > 8) T = 8;
  if (T <= 1 || plane_rows < T * GROUP)
    return rice_unpack_serial<MED>(kmap, uwmap, blob, rem_word_offs,
                                   un_word_offs, kzero, kcap, n, h, w,
                                   make_emit);
  const int64_t nsegw = (w + kRiceRL - 1) / kRiceRL;

  // Per phase, T emit splits at arbitrary rows; each chunk DECODES
  // from the preceding GROUP boundary (warm-up rebuilds the running
  // column sums) so no height alignment is required — a single 2160-
  // row frame threads just as well as a 32-aligned batch.
  std::vector<int64_t> emits;   // emit-range starts, sorted
  std::vector<int64_t> starts;  // GROUP-aligned decode starts
  for (int phase = 0; phase < 3; ++phase) {
    const int64_t lo = phase * plane_rows;
    for (long t = 0; t < T; ++t) {
      int64_t e = lo + plane_rows * t / T;
      if (!emits.empty() && e <= emits.back()) continue;
      emits.push_back(e);
      starts.push_back(e / GROUP * GROUP);
    }
  }
  // Prescan: per-bucket segment counts before each aligned decode
  // start (several chunks may share one when emits land in the same
  // group).
  const size_t nb = starts.size();
  std::vector<int64_t> pre_rem(nb * 16, 0), pre_un(nb * 7, 0);
  {
    int64_t cr[16] = {0};
    int64_t cu[7] = {0};
    size_t bi = 0;
    const int64_t total_rows = 3 * plane_rows;
    for (int64_t g = 0; g < total_rows && bi < nb; ++g) {
      while (bi < nb && g == starts[bi]) {
        std::memcpy(&pre_rem[bi * 16], cr, sizeof(cr));
        std::memcpy(&pre_un[bi * 7], cu, sizeof(cu));
        ++bi;
      }
      if (bi >= nb) break;
      const uint8_t* km = kmap + g * nsegw;
      const uint8_t* um = uwmap + g * nsegw;
      for (int64_t s = 0; s < nsegw; ++s) {
        const int k = km[s];
        if (k == kzero) continue;
        if (k > kcap) return -3;
        ++cr[k];
        const int uw = um[s];
        int c = 0;
        while (c < 7 && kRiceUcls[c] < uw) ++c;
        if (c >= 7) return -4;
        ++cu[c];
      }
    }
  }

  std::atomic<long> rc{0};
  size_t bi = 0;
  for (int phase = 0; phase < 3; ++phase) {
    const int64_t hi = (phase + 1) * plane_rows;
    // Boundaries belonging to this phase.
    std::vector<size_t> mine;
    while (bi < nb && emits[bi] < hi) mine.push_back(bi++);
    std::vector<std::thread> pool;
    for (size_t mi = 0; mi < mine.size(); ++mi) {
      const size_t b = mine[mi];
      const int64_t e0 = emits[b];
      const int64_t e1 = (mi + 1 < mine.size()) ? emits[mine[mi + 1]]
                                                : hi;
      const int64_t g0 = starts[b];
      pool.emplace_back([&, b, g0, e0, e1]() {
        int64_t fr[16], fu[7];
        std::memcpy(fr, &pre_rem[b * 16], sizeof(fr));
        std::memcpy(fu, &pre_un[b * 7], sizeof(fu));
        auto emit = make_emit();  // per-thread (MED emits are stateful)
        long r = rice_walk_rows<MED>(kmap, uwmap, blob, rem_word_offs,
                                     un_word_offs, kzero, kcap, nsegw,
                                     plane_rows, w, g0, e1, e0, fr, fu,
                                     emit);
        if (r != 0) rc.store(r);
      });
    }
    for (auto& th : pool) th.join();
    if (rc.load() != 0) return rc.load();
  }
  return 0;
}

}  // namespace

extern "C" {

long uhdr_rice_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                      const uint32_t* blob,
                      const int64_t* rem_word_offs,
                      const int64_t* un_word_offs,
                      int64_t n, int64_t h, int64_t w,
                      uint16_t* scratch, uint32_t* out) {
  auto mk = [&]() { return Emit1010102{w, scratch, out}; };
  return rice_unpack_serial<false>(kmap, uwmap, blob, rem_word_offs,
                                   un_word_offs, 15, 9, n, h, w, mk);
}

long uhdr_rice_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                         const uint32_t* blob,
                         const int64_t* rem_word_offs,
                         const int64_t* un_word_offs,
                         int64_t n, int64_t h, int64_t w,
                         uint16_t* scratch, uint32_t* out,
                         long nthreads) {
  auto mk = [&]() { return Emit1010102{w, scratch, out}; };
  return rice_unpack_mt<false>(kmap, uwmap, blob, rem_word_offs,
                               un_word_offs, 15, 9, n, h, w, nthreads,
                               mk);
}

long uhdr_rice16_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                        const uint32_t* blob,
                        const int64_t* rem_word_offs,
                        const int64_t* un_word_offs,
                        int64_t n, int64_t h, int64_t w,
                        uint16_t* scratch, uint16_t* out) {
  auto mk = [&]() { return EmitF16{w, scratch, out}; };
  return rice_unpack_serial<false>(kmap, uwmap, blob, rem_word_offs,
                                   un_word_offs, 31, 15, n, h, w, mk);
}

long uhdr_rice16_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                           const uint32_t* blob,
                           const int64_t* rem_word_offs,
                           const int64_t* un_word_offs,
                           int64_t n, int64_t h, int64_t w,
                           uint16_t* scratch, uint16_t* out,
                           long nthreads) {
  auto mk = [&]() { return EmitF16{w, scratch, out}; };
  return rice_unpack_mt<false>(kmap, uwmap, blob, rem_word_offs,
                               un_word_offs, 31, 15, n, h, w, nthreads,
                               mk);
}

// MED-predicted variants: same bucket/unary blob layout, residuals
// are MED(left, up, upleft) prediction errors instead of vertical
// deltas (parallel/packio.py fetch_rgba1010102_med / fetch_rgba_f16_med;
// ~9-14% fewer bytes than the vertical scheme on decoded content).
long uhdr_med_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                     const uint32_t* blob,
                     const int64_t* rem_word_offs,
                     const int64_t* un_word_offs,
                     int64_t n, int64_t h, int64_t w,
                     uint16_t* scratch, uint32_t* out) {
  auto mk = [&]() {
    return EmitMed<10, uint32_t>(w, n * h, scratch, out);
  };
  return rice_unpack_serial<true>(kmap, uwmap, blob, rem_word_offs,
                                  un_word_offs, 15, 9, n, h, w, mk);
}

long uhdr_med_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                        const uint32_t* blob,
                        const int64_t* rem_word_offs,
                        const int64_t* un_word_offs,
                        int64_t n, int64_t h, int64_t w,
                        uint16_t* scratch, uint32_t* out,
                        long nthreads) {
  auto mk = [&]() {
    return EmitMed<10, uint32_t>(w, n * h, scratch, out);
  };
  return rice_unpack_mt<true>(kmap, uwmap, blob, rem_word_offs,
                              un_word_offs, 15, 9, n, h, w, nthreads,
                              mk);
}

long uhdr_med16_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                       const uint32_t* blob,
                       const int64_t* rem_word_offs,
                       const int64_t* un_word_offs,
                       int64_t n, int64_t h, int64_t w,
                       uint16_t* scratch, uint16_t* out) {
  auto mk = [&]() {
    return EmitMed<16, uint16_t>(w, n * h, scratch, out);
  };
  return rice_unpack_serial<true>(kmap, uwmap, blob, rem_word_offs,
                                  un_word_offs, 31, 15, n, h, w, mk);
}

long uhdr_med16_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                          const uint32_t* blob,
                          const int64_t* rem_word_offs,
                          const int64_t* un_word_offs,
                          int64_t n, int64_t h, int64_t w,
                          uint16_t* scratch, uint16_t* out,
                          long nthreads) {
  auto mk = [&]() {
    return EmitMed<16, uint16_t>(w, n * h, scratch, out);
  };
  return rice_unpack_mt<true>(kmap, uwmap, blob, rem_word_offs,
                              un_word_offs, 31, 15, n, h, w, nthreads,
                              mk);
}

// Planar-u8 composite variants (bits=8 in parallel/packio.py): same
// blob layout and 3*(n*h)-row geometry, but the planes are the
// composite's thirds written straight to u8 — no recorrelation, no
// scratch (passed for signature uniformity, unused).
long uhdr_rice8_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                       const uint32_t* blob,
                       const int64_t* rem_word_offs,
                       const int64_t* un_word_offs,
                       int64_t n, int64_t h, int64_t w,
                       uint16_t* scratch, uint8_t* out) {
  (void)scratch;
  auto mk = [&]() { return EmitPlanar8{w, n * h, out}; };
  return rice_unpack_serial<false>(kmap, uwmap, blob, rem_word_offs,
                                   un_word_offs, 15, 9, n, h, w, mk);
}

long uhdr_rice8_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                          const uint32_t* blob,
                          const int64_t* rem_word_offs,
                          const int64_t* un_word_offs,
                          int64_t n, int64_t h, int64_t w,
                          uint16_t* scratch, uint8_t* out,
                          long nthreads) {
  (void)scratch;
  auto mk = [&]() { return EmitPlanar8{w, n * h, out}; };
  return rice_unpack_mt<false>(kmap, uwmap, blob, rem_word_offs,
                               un_word_offs, 15, 9, n, h, w, nthreads,
                               mk);
}

long uhdr_med8_unpack(const uint8_t* kmap, const uint8_t* uwmap,
                      const uint32_t* blob,
                      const int64_t* rem_word_offs,
                      const int64_t* un_word_offs,
                      int64_t n, int64_t h, int64_t w,
                      uint16_t* scratch, uint8_t* out) {
  (void)scratch;
  auto mk = [&]() { return EmitPlanarMed8(w, n * h, out); };
  return rice_unpack_serial<true>(kmap, uwmap, blob, rem_word_offs,
                                  un_word_offs, 15, 9, n, h, w, mk);
}

long uhdr_med8_unpack_mt(const uint8_t* kmap, const uint8_t* uwmap,
                         const uint32_t* blob,
                         const int64_t* rem_word_offs,
                         const int64_t* un_word_offs,
                         int64_t n, int64_t h, int64_t w,
                         uint16_t* scratch, uint8_t* out,
                         long nthreads) {
  (void)scratch;
  auto mk = [&]() { return EmitPlanarMed8(w, n * h, out); };
  return rice_unpack_mt<true>(kmap, uwmap, blob, rem_word_offs,
                              un_word_offs, 15, 9, n, h, w, nthreads,
                              mk);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Forward (upload) direction: host pack of a 10-bit plane into the
// generic {0,2,5,10}/L=256 bucket blob that kernel B14
// (kernels/csrc/packio.cu, packio.unpack_plane_device) expands on the
// device. Replaces the multi-pass numpy pack (packio.pack_plane_host_numpy)
// with one counting sweep + one filling sweep.
//
// Layout contract (must match packio.pack_plane_host/unpack_plane_device):
//   L = 256 samples/segment, G = 32 rows/group, widths {2,5,10};
//   blob = [bucket2 words][bucket5][bucket10][perm i32], buckets
//   pow2-padded by the CALLER-provided npads; perm[seg] = 0 for
//   all-zero segments else 1-based row in width order.

namespace {
constexpr int kGenWidths[3] = {2, 5, 10};
constexpr int LGEN = 256;

inline int gen_words_per_seg(int bw) {
  int k = 32 / bw;
  return (LGEN + k - 1) / k;
}
}  // namespace

extern "C" {

// Pass 1: per-segment width codes (0/2/5/10) into bmap, and bucket
// counts into counts[3]. arr is (h, w) u16 10-bit values; w need not
// be a multiple of LGEN (the tail is edge-padded virtually).
long uhdr_seg_widths(const uint16_t* arr, int64_t h, int64_t w,
                     uint8_t* bmap, int64_t* counts) {
  if (h % GROUP != 0 || h <= 0 || w <= 0) return -1;
  const int64_t nsegw = (w + LGEN - 1) / LGEN;
  counts[0] = counts[1] = counts[2] = 0;
  for (int64_t r = 0; r < h; ++r) {
    const uint16_t* row = arr + r * w;
    const uint16_t* prev = (r % GROUP == 0) ? nullptr : row - w;
    for (int64_t s = 0; s < nsegw; ++s) {
      const int64_t x0 = s * LGEN;
      const int64_t x1 = (x0 + LGEN < w) ? x0 + LGEN : w;
      uint32_t mx = 0;
      for (int64_t x = x0; x < x1; ++x) {
        const int32_t p = prev ? prev[x] : 0;
        const int32_t d = ((row[x] - p) & 1023);
        const int32_t ds = ((d + 512) & 1023) - 512;
        const uint32_t z = (uint32_t)((ds << 1) ^ (ds >> 31));
        if (z > mx) mx = z;
      }
      // virtual edge padding: repeated last column -> delta equals the
      // last real column's delta, already covered by mx.
      uint8_t bw = 0;
      if (mx > 31) bw = 10;
      else if (mx > 3) bw = 5;
      else if (mx > 0) bw = 2;
      bmap[r * nsegw + s] = bw;
      if (bw == 2) ++counts[0];
      else if (bw == 5) ++counts[1];
      else if (bw == 10) ++counts[2];
    }
  }
  return 0;
}

// Pass 2: fill the fused blob (buckets + perm). npads are the pow2-
// padded bucket sizes the caller computed from counts; the padded
// rows are zero. blob must be zero-initialized by the caller.
long uhdr_seg_fill(const uint16_t* arr, int64_t h, int64_t w,
                   const uint8_t* bmap, const int64_t* npads,
                   uint32_t* blob, int32_t* perm) {
  if (h % GROUP != 0 || h <= 0 || w <= 0) return -1;
  const int64_t nsegw = (w + LGEN - 1) / LGEN;
  int64_t bucket_off[3];
  bucket_off[0] = 0;
  bucket_off[1] = bucket_off[0] + npads[0] * gen_words_per_seg(2);
  bucket_off[2] = bucket_off[1] + npads[1] * gen_words_per_seg(5);
  int64_t fill[3] = {0, 0, 0};
  int64_t perm_base[3];
  perm_base[0] = 1;
  perm_base[1] = perm_base[0] + npads[0];
  perm_base[2] = perm_base[1] + npads[1];
  uint16_t seg[LGEN];
  for (int64_t r = 0; r < h; ++r) {
    const uint16_t* row = arr + r * w;
    const uint16_t* prev = (r % GROUP == 0) ? nullptr : row - w;
    for (int64_t s = 0; s < nsegw; ++s) {
      const uint8_t bw = bmap[r * nsegw + s];
      if (bw == 0) { perm[r * nsegw + s] = 0; continue; }
      const int j = (bw == 2) ? 0 : (bw == 5) ? 1 : 2;
      const int64_t x0 = s * LGEN;
      const int64_t x1 = (x0 + LGEN < w) ? x0 + LGEN : w;
      int64_t i = 0;
      for (int64_t x = x0; x < x1; ++x, ++i) {
        const int32_t p = prev ? prev[x] : 0;
        const int32_t d = ((row[x] - p) & 1023);
        const int32_t ds = ((d + 512) & 1023) - 512;
        seg[i] = (uint16_t)((ds << 1) ^ (ds >> 31));
      }
      for (; i < LGEN; ++i) seg[i] = seg[x1 - x0 - 1];
      const int nw = gen_words_per_seg(bw);
      const int k = 32 / bw;
      uint32_t* words = blob + bucket_off[j] + fill[j] * nw;
      for (int wi = 0; wi < nw; ++wi) {
        uint32_t acc = 0;
        for (int slot = 0; slot < k; ++slot) {
          const int64_t idx = (int64_t)slot * nw + wi;
          if (idx < LGEN) acc |= (uint32_t)seg[idx] << (slot * bw);
        }
        words[wi] = acc;
      }
      perm[r * nsegw + s] = (int32_t)(perm_base[j] + fill[j]);
      ++fill[j];
    }
  }
  return 0;
}

}  // extern "C"
