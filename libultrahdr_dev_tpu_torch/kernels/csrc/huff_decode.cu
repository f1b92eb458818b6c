// B4 and B22: parallel restart-interval Huffman decode (with the B4h
// handoff read), dense and log emission, for the port's
// jpeg/device_decode.py.
//
// B4 replaces libultrahdr_dev_tpu/jpeg/device_decode.py:decode_rst_chunks
// in its dense form (body, with _window_table, the select-chain decode
// and deinterleave_ycbcr_device) as jpegr.py:_fused_decode_kernel_dev
// runs it, and parallel/sharding.py:_handoff_decode_kernel (B4h), which
// expands the encoder's big-endian words to bytes for it. B3 stores its
// words in JPEG byte order, so the handoff is this same kernel reading
// the encoder's chunk buffer in place at word-aligned lane starts. B22
// replaces the same function's log form (body_log, emit_mode="log",
// with its lower-bound rebuild), which every device decode of the JAX
// package runs under UHDR_DECODE_EMIT=log; it takes B4's inputs,
// handoff included, and gives B4's grids bit for bit on any input.
//
// What both compute, per lane (a restart interval, or a synthesized
// segment of a restart-less stream): canonical Huffman decode of one
// unit (codeword + extra bits) at a time with the frame's own tables,
// DC prediction per component, the coefficients written into the
// per-plane zigzag grids B5 reads (zeros where nothing was emitted);
// with DC carry, each lane's DC sums are summed over the frame's
// earlier lanes and added to every DC of the lane (int16 wrap). A lane
// reads the win bytes of its stream from its start byte, zero past the
// window or the stream's end. Termination on any input, as the JAX
// loop: a unit is decoded and emitted first, then the lane is done
// once its block count reaches its target, its bit position passes the
// window (win * 8), or it has decoded its unit cap (win * 8 / min code
// length + 1, which a correct minimum never reaches; nor does JAX's
// cb * 65 cap of the log form). No read leaves the window and no lane
// loops forever on garbage.
//
// Layout: a CTA holds kThreads lanes of ONE frame (grid: lane tiles x
// frames). unit_step is the one __device__ function both kernels call,
// so their decodes cannot drift apart.
//
// The lookup. A table is the sorted (16-bit left-aligned boundary,
// symbol << 5 | length) entries of the JAX select chain; a unit decodes
// to the last entry whose boundary <= the next 16 bits (the first entry
// when none is), which equals the chain for any DHT. A first launch
// (table_kernel, a CTA per frame) builds a fast table of 512 entries a
// table, indexed by the top 9 bits of the peek: for prefix p it runs
// that binary search for p's lowest peek (p << 7) and its highest
// (p << 7 | 127); if both land on the same entry it stores the entry's
// packed value, else a marker. The search's entry index never falls as
// the peek rises, so equal ends mean every peek of the prefix decodes
// to that entry: the fast table equals the search on every peek,
// canonical DHT or not (device_decode.py:fast_lookup_table is its plain
// model, held against the search on all 65,536 peeks). A marked prefix
// gets a second-level table of its 128 peeks' entries (the search's
// results), kMaxSub a frame (Annex K needs 11); past those, a marked
// peek runs the search itself over the frame's tables in global memory.
// Each decode CTA copies its frame's tables into shared memory, so a
// unit costs one or two shared loads.
//
// The bit reader. A lane keeps a 64-bit buffer of the stream bits from
// its position, MSB first, refilled from aligned 4-byte words of its
// window (one word held ahead). The CTA first copies the words its
// lanes' windows span into shared memory when they fit in kStageWords
// (they do for this codec's intervals and the synthesized restart-less
// lanes); else the lanes read global memory. Bytes before the lane's
// start byte and at or past `avail` (the window, cut at the stream's
// end) read as zero, exactly as the byte reads they replace defined
// them, so each unit's peek and extra bits are the same 32 bits: also
// past the window, where the lane then stops. A word with no byte in
// the window is not loaded, so no load leaves the stream. A unit longer
// than the buffer (garbage DC sizes) re-seeks. Lanes start at any byte
// and bit.
//
// B4: a lane zeroes each of its blocks in the output grid as it starts
// it (8 16-byte stores) and stores each emitted coefficient there (one
// 2-byte store); a lane cut short leaves its remaining blocks zeroed.
// No array is indexed at run time, so nothing is on the stack. B22:
// pass 1 runs the same unit steps and appends each emitted coefficient,
// as one int32 (its zigzag index << 16 | its int16 value), to the
// lane's own segment of a log sized for every coefficient of the frame
// (a lane's segment starts at its first block * 64); it writes no
// zeros. Pass 1 also writes each block's first log index into `start`
// (an int32 per block, in the frame's block order m * bpm + slot): the
// lane's count as it enters the block, and for the blocks it never
// enters (a lane cut short) its final count, so they hold no entry.
// Pass 2, a quarter-warp per output block in the grids' own order
// (consecutive groups write consecutive blocks): the block's entries
// are [start[b], start[b + 1]), or up to the lane's count for its last
// block; no search. The 8 threads zero a 128 B tile in shared memory,
// scatter the block's entries into it (most blocks hold 0 or 1), add
// the DC carry and write the block with one 16-byte store each. (An
// earlier form found each block's first entry by a binary search
// through the lane's positions in global memory, a warp a block.)
//
// The DC carry: a CTA per carrying frame scans its lanes' DC sums
// (int32 wrap, scan.cuh) into their exclusive prefixes, in place; B4
// then runs an add pass of a thread per output block, adding its lane's
// prefix to the block's DC (int16 wrap), and B22's pass 2 adds it as it
// writes the block: the one add a block the one-CTA walk it replaces
// made, so the grids are the same bits.
//
// Bound: memory traffic. Per 4080x3072 frame B4 reads ~1-2 MB of
// stream and writes 39.2 MB of coefficients, ~12 us at 3.35 TB/s, and
// B22, the same function, has the same floor: its log (4 B per emitted
// coefficient) and `start` (4 B a block), each written and read back,
// are its own intermediates. What holds the kernels above it is each
// lane's serial unit chain (a unit's length sets where the next
// starts): ~100-130 units a lane, each a dependent chain of some 150
// instructions issued in order, with only ~12-15k lanes a frame (1-2
// warps a scheduler) to hide it (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 64;       // lanes a decode CTA, all of one frame
constexpr int kScanThreads = 1024;
constexpr int kAddThreads = 256;
constexpr int kTableWords = 1 + 2 * 256;
constexpr int kFastBits = 9;
constexpr int kFastSize = 1 << kFastBits;
constexpr int kSubBits = 16 - kFastBits;
constexpr int kSubSize = 1 << kSubBits;
constexpr int kMaxSub = 32;            // second-level tables a CTA holds
constexpr uint32_t kSub = 0x8000u;     // fast entry: kSub | subtable
constexpr uint32_t kSearch = 0xFFFFu;  // fast or sub entry: search
constexpr int kTableThreads = 512;     // threads of a table_kernel CTA
constexpr int kStageWords = 6144;      // a CTA's stream words in shared

// Per-frame descriptor fields (jpeg/device_decode.py F_*).
enum { F_OFF, F_LEN, F_WIN, F_R, F_LANE0, F_NLANES, F_CARRY, F_MAXU,
       kFrameFields };

struct Geometry {
  int n;        // frames
  int gray;     // 1: one block per MCU
  int hs, vs;   // luma sampling factors (color)
  int mcus_x, mcus_y;
};

// A frame's lookup tables (table_kernel writes one per frame into the
// launch's scratch; each decode CTA copies its frame's into shared
// memory): the fast tables of the four decode tables, the second-level
// tables of the fast entries that straddle entries, and their count.
struct Lookup {
  uint16_t fast[4 * kFastSize];
  uint16_t sub[kMaxSub * kSubSize];
  int32_t nsub;
  int32_t pad[3];
};
static_assert(sizeof(Lookup) % 16 == 0, "Lookup rows stay 16-byte aligned");

// Index of the last entry whose boundary <= peek (0 when none is).
__device__ __forceinline__ int search(const int32_t* t, uint32_t peek) {
  int cnt = t[0];
  const int32_t* bnd = t + 1;
  int i = 0;
#pragma unroll
  for (int step = 128; step > 0; step >>= 1) {
    int j = i + step;
    if (j < cnt && (uint32_t)bnd[j] <= peek) i = j;
  }
  return i;
}

// Frame f's Lookup (one CTA of kTableThreads a frame): the packed entry
// of each 9-bit prefix whose lowest and highest peeks search to one
// entry (kSearch for an entry that does not fit below kSub, which no DHT
// makes); the first kMaxSub other prefixes (in table, then prefix
// order) kSub | their second-level table, holding the entries of their
// 128 peeks; the rest kSearch.
__global__ void __launch_bounds__(kTableThreads)
table_kernel(const int32_t* __restrict__ tables, Lookup* __restrict__ out) {
  __shared__ int32_t tab[4 * kTableWords];
  __shared__ uint16_t sub_of[kMaxSub];
  __shared__ int warp_sums[32];
  const int32_t* src = tables + (size_t)blockIdx.x * 4 * kTableWords;
  for (int i = threadIdx.x; i < 4 * kTableWords; i += kTableThreads)
    tab[i] = src[i];
  __syncthreads();
  Lookup& lk = out[blockIdx.x];
  constexpr int kPer = 4 * kFastSize / kTableThreads;
  int e0 = threadIdx.x * kPer;
  const int32_t* t = tab + (e0 >> kFastBits) * kTableWords;
  uint32_t fe[kPer];
  uint32_t straddle = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    uint32_t lo = (uint32_t)((e0 + q) & (kFastSize - 1)) << kSubBits;
    int a = search(t, lo), b = search(t, lo | (kSubSize - 1));
    uint32_t pk = (uint32_t)t[257 + a];
    fe[q] = pk < kSub ? pk : kSearch;
    if (a != b) straddle |= 1u << q;
  }
  int total;
  int k = uhdr_scan::block_exclusive_scan(__popc(straddle), 0, warp_sums,
                                          total);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (straddle >> q & 1) {
      fe[q] = k < kMaxSub ? kSub | k : kSearch;
      if (k < kMaxSub) sub_of[k] = (uint16_t)(e0 + q);
      ++k;
    }
    lk.fast[e0 + q] = (uint16_t)fe[q];
  }
  __syncthreads();
  int nsub = min(total, kMaxSub);
  for (int x = threadIdx.x; x < nsub * kSubSize; x += kTableThreads) {
    int e = sub_of[x >> kSubBits];
    uint32_t peek = (uint32_t)((e & (kFastSize - 1)) << kSubBits) |
                    (x & (kSubSize - 1));
    const int32_t* te = tab + (e >> kFastBits) * kTableWords;
    uint32_t pk = (uint32_t)te[257 + search(te, peek)];
    lk.sub[x] = (uint16_t)(pk < kSub ? pk : kSearch);
  }
  if (threadIdx.x == 0) lk.nsub = nsub;
}

// A decode CTA's copy of its frame's Lookup (the used second-level
// tables only), with 16-byte loads; ends with the CTA synchronized.
__device__ __forceinline__ void load_lookup(const Lookup& g, Lookup& s) {
  constexpr int kFast4 = 4 * kFastSize * 2 / 16;
  int n4 = kFast4 + __ldg(&g.nsub) * (kSubSize * 2 / 16);
  const uint4* src = reinterpret_cast<const uint4*>(&g);
  uint4* dst = reinterpret_cast<uint4*>(&s);
  for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = __ldg(src + i);
  __syncthreads();
}

// The packed entry (symbol << 5 | length) of `peek` in table tsel: the
// fast entry, else its second-level entry, else (beyond kMaxSub) the
// binary search over the frame's table `tab` in global memory.
__device__ __forceinline__ uint32_t lookup(const Lookup& s,
                                          const int32_t* __restrict__ tab,
                                          int tsel, uint32_t peek) {
  uint32_t pk = s.fast[tsel * kFastSize + (peek >> kSubBits)];
  if (pk >= kSub && pk != kSearch)
    pk = s.sub[(pk & (kSub - 1)) * kSubSize + (peek & (kSubSize - 1))];
  if (pk == kSearch) {
    const int32_t* t = tab + tsel * kTableWords;
    pk = (uint32_t)__ldg(t + 257 + search(t, peek));
  }
  return pk;
}

// A lane's stream bits. `words` is the aligned word holding the lane's
// first byte (in the CTA's shared copy of its lanes' bytes, or in global
// memory when they do not fit); bytes [lo, hi) from its first byte are
// the window.
struct Bits {
  const uint32_t* words;
  int lo, hi;
  int next;                // index of the word held in `ahead`
  uint32_t ahead;          // that word, big-endian, masked
  unsigned long long buf;  // stream bits from the position, MSB first
  int have;                // valid bits at the top of buf (zeros below)
};

// Word i of the lane's stream, big-endian, its bytes outside [lo, hi)
// zero; loaded only when `want` and one of its bytes is inside.
__device__ __forceinline__ uint32_t load_word(const Bits& r, int i,
                                              bool want = true) {
  int b = 4 * i;
  int s = max(r.lo - b, 0), e = min(r.hi - b, 4);
  uint32_t w = 0;
  if (want && s < e) w = __byte_perm(r.words[i], 0, 0x0123);
  unsigned long long m = (0xFFFFFFFFull >> (8 * min(s, 4))) &
                         ~(0xFFFFFFFFull >> (8 * max(e, 0)));
  return w & (uint32_t)m;
}

// At least 32 valid bits: one word from `ahead`, the next one loaded.
__device__ __forceinline__ void refill(Bits& r) {
  bool need = r.have < 32;
  int sh = need ? 32 - r.have : 0;
  r.buf |= need ? (unsigned long long)r.ahead << sh : 0ull;
  r.have += need ? 32 : 0;
  r.next += need ? 1 : 0;
  uint32_t nw = load_word(r, r.next, need);
  r.ahead = need ? nw : r.ahead;
}

// Position the reader at bit `rel` counted from the first byte of words.
__device__ __forceinline__ void seek(Bits& r, int rel) {
  int wi = rel >> 5, drop = rel & 31;
  uint32_t w0 = load_word(r, wi);
  r.next = wi + 1;
  r.ahead = load_word(r, r.next);
  r.buf = ((unsigned long long)w0 << 32) << drop;
  r.have = 32 - drop;
  refill(r);
}

// Where a lane's blocks go, stepped one block at a time with no
// division: MCU m at column mx, its top-left luma block at `ymcu` and
// its chroma (or gray) block at `cmcu`, block offsets from the frame's
// first.
struct Out {
  int m, mx;
  long long ymcu, cmcu;
};

__device__ __forceinline__ void out_init(Out& o, const Geometry& g, int f,
                                         int m) {
  long long n_mcus = (long long)g.mcus_x * g.mcus_y;
  int my = m / g.mcus_x;
  o.m = m;
  o.mx = m - my * g.mcus_x;
  o.cmcu = f * n_mcus + m;
  o.ymcu = g.gray ? o.cmcu
                  : f * n_mcus * g.hs * g.vs +
                        ((long long)my * g.vs * g.mcus_x + o.mx) * g.hs;
}

// Block `slot` of the current MCU; nullptr past the frame's MCUs.
__device__ __forceinline__ int16_t* out_ptr(const Out& o, const Geometry& g,
                                            int ypm, int slot, int16_t* y,
                                            int16_t* u, int16_t* v) {
  if (o.m >= g.mcus_x * g.mcus_y) return nullptr;
  if (g.gray) return y + o.cmcu * 64;
  int dy = g.hs == 1 ? slot : g.hs == 2 ? slot >> 1 : slot / g.hs;
  long long off = o.ymcu + (long long)dy * g.mcus_x * g.hs + slot -
                  dy * g.hs;
  return slot < ypm ? y + off * 64
                    : (slot == ypm ? u : v) + o.cmcu * 64;
}

// The next MCU.
__device__ __forceinline__ void out_mcu(Out& o, const Geometry& g) {
  ++o.m;
  ++o.cmcu;
  bool wrap = ++o.mx == g.mcus_x;
  o.mx = wrap ? 0 : o.mx;
  o.ymcu += g.gray ? 1
                   : g.hs + (wrap ? (long long)(g.vs - 1) * g.mcus_x * g.hs
                                  : 0);
}

// Zigzag block (MCU m, slot) of frame f in the output grids; nullptr
// for pad blocks past the frame's MCUs.
__device__ __forceinline__ int16_t* block_ptr(int16_t* y, int16_t* u,
                                              int16_t* v, const Geometry& g,
                                              int f, int m, int slot) {
  Out o;
  out_init(o, g, f, m);
  return out_ptr(o, g, g.gray ? 1 : g.hs * g.vs, slot, y, u, v);
}

__device__ __forceinline__ void zero_block(int16_t* b) {
  if (b == nullptr) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    reinterpret_cast<uint4*>(b)[i] = make_uint4(0, 0, 0, 0);
}

// One lane's inputs and decode state. The DC predictors are three
// scalars, not an array a component indexes: an indexed member would put
// the whole struct in local memory.
struct Lane {
  Bits in;
  int idx, r;            // lane within the frame, MCUs per lane
  int target;            // blocks the lane decodes
  int max_bits;          // win * 8 (at most INT_MAX: bit never passes it)
  int max_units;
  int bit, blk, slot, k, units;  // slot = blk % blocks per MCU
  int dc0, dc1, dc2;     // DC predictors of Y (or gray), U, V
};

// Lane idx of frame f (descriptor fr), global lane `lane`.
__device__ __forceinline__ void lane_init(Lane& L,
                                          const uint8_t* __restrict__ src,
                                          const int32_t* __restrict__ fr,
                                          const int32_t* __restrict__ lanes,
                                          int idx, int lane,
                                          const Geometry& g, int bpm,
                                          const uint32_t* staged,
                                          uintptr_t stage_base) {
  L.idx = idx;
  L.r = fr[F_R];
  int n_mcus = g.mcus_x * g.mcus_y;
  L.target = idx < fr[F_NLANES] - 1
                 ? bpm * L.r : bpm * (n_mcus - L.r * (fr[F_NLANES] - 1));
  int win = fr[F_WIN];
  int start = lanes[2 * lane];
  const uint8_t* p = src + fr[F_OFF] + start;
  uintptr_t a = (uintptr_t)p & ~(uintptr_t)3;
  L.in.words = reinterpret_cast<const uint32_t*>(a);
  L.in.lo = (int)((uintptr_t)p - a);
  L.in.hi = L.in.lo + min(win, fr[F_LEN] - start);
  if (staged != nullptr)
    L.in.words = staged + (a - stage_base) / 4;
  L.max_bits = (int)min((long long)win * 8, 0x7FFFFFFFLL);
  L.max_units = fr[F_MAXU];
  L.bit = lanes[2 * lane + 1];
  L.blk = L.slot = L.k = L.units = 0;
  L.dc0 = L.dc1 = L.dc2 = 0;
  seek(L.in, L.in.lo * 8 + L.bit);
}

// Decode one unit (a codeword and its extra bits) of lane L and advance
// it, with selects rather than branches on the common path. Returns
// true when the unit emits a coefficient: `at` is its zigzag index in
// the block the unit was decoded in (L.blk before the step) and `val`
// its value (for a DC unit the component's running DC, int32 wrap).
// `ended`: the unit ended that block.
__device__ __forceinline__ bool unit_step(Lane& L, const Lookup& s,
                                          const int32_t* __restrict__ tab,
                                          const Geometry& g, int ypm,
                                          int bpm, int& at, int& val,
                                          bool& ended) {
  uint32_t w = (uint32_t)(L.in.buf >> 32);
  int slot = L.slot;
  int comp = g.gray || slot < ypm ? 0 : slot - ypm + 1;
  bool is_dc = L.k == 0;
  uint32_t pk = lookup(s, tab, (is_dc ? 0 : 1) + (comp ? 2 : 0), w >> 16);
  int sym = (int)(pk >> 5), clen = (int)(pk & 31);
  int nextra = is_dc ? sym : (sym & 15);
  uint32_t extra =
      nextra > 0 ? (w << clen) >> ((unsigned)(32 - nextra) & 31u) : 0u;
  // T.81 F.2.2.1 EXTEND with the JAX version's int32 wrap-around (no
  // extra bits: extra 0, half 1, full 0, so 0).
  int half = (int)(1u << min(max(nextra - 1, 0), 31));
  int full = (int)((1u << min(nextra, 31)) - 1u);
  int e = (int)extra;
  int v = e < half ? (int)((unsigned)e - (unsigned)full) : e;
  int pred = comp == 0 ? L.dc0 : comp == 1 ? L.dc1 : L.dc2;
  int dc = (int)((unsigned)pred + (unsigned)v);
  L.dc0 = is_dc && comp == 0 ? dc : L.dc0;
  L.dc1 = is_dc && comp == 1 ? dc : L.dc1;
  L.dc2 = is_dc && comp == 2 ? dc : L.dc2;
  bool eob = sym == 0, zrl = sym == 0xF0;
  int kk = min(L.k + (sym >> 4), 63);
  ended = !is_dc && (eob || kk >= 63);
  at = is_dc ? 0 : kk;
  val = is_dc ? dc : v;
  L.k = is_dc ? 1 : ended ? 0 : zrl ? L.k + 16 : kk + 1;
  L.blk += ended ? 1 : 0;
  L.slot = !ended ? slot : slot + 1 == bpm ? 0 : slot + 1;
  int used = clen + nextra;
  L.bit += used;
  if (used < L.in.have) {
    L.in.buf <<= used;
    L.in.have -= used;
    refill(L.in);
  } else {
    seek(L.in, L.in.lo * 8 + L.bit);
  }
  ++L.units;
  return is_dc || !(eob || zrl);
}

__device__ __forceinline__ bool lane_done(const Lane& L) {
  return L.blk >= L.target || L.bit > L.max_bits || L.units >= L.max_units;
}

// The CTA's shared copy of the words its lanes' windows span, when they
// fit in kStageWords (else every lane reads global memory): returns the
// copy (or nullptr) and sets *base to the global address of its first
// word. A lane that reads nothing (an empty window) spans nothing. Ends
// with the CTA synchronized.
__device__ __forceinline__ const uint32_t* stage_stream(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ fr,
    const int32_t* __restrict__ lanes, int lane, bool live,
    uint32_t* stage, unsigned long long* range, uintptr_t* base) {
  if (threadIdx.x == 0) {
    range[0] = ~0ull;
    range[1] = 0ull;
  }
  __syncthreads();
  if (live) {
    int start = lanes[2 * lane];
    int avail = min(fr[F_WIN], fr[F_LEN] - start);
    uintptr_t p = (uintptr_t)(src + fr[F_OFF] + start);
    if (avail > 0) {
      atomicMin(range, (unsigned long long)(p & ~(uintptr_t)3));
      atomicMax(range + 1, (unsigned long long)((p + avail + 3) &
                                                ~(uintptr_t)3));
    }
  }
  __syncthreads();
  unsigned long long lo = range[0], hi = range[1];
  *base = (uintptr_t)lo;
  if (lo >= hi || hi - lo > 4ull * kStageWords) return nullptr;
  int n = (int)((hi - lo) / 4);
  const uint32_t* w = reinterpret_cast<const uint32_t*>((uintptr_t)lo);
  for (int i = threadIdx.x; i < n; i += kThreads) stage[i] = __ldg(w + i);
  __syncthreads();
  return stage;
}

// B4. Grid (lane tiles, frames): CTA (x, f) decodes lanes x * kThreads
// ... of frame f. A lane zeroes each of its blocks as it starts it and
// stores each coefficient it emits into it.
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ src,
              const int32_t* __restrict__ frames,
              const int32_t* __restrict__ lanes,
              const int32_t* __restrict__ tables,
              const Lookup* __restrict__ lookups, int16_t* __restrict__ y,
              int16_t* __restrict__ u, int16_t* __restrict__ v,
              int32_t* __restrict__ dcsum, int n_lanes, Geometry g) {
  __shared__ Lookup s;
  __shared__ uint32_t stage[kStageWords];
  __shared__ unsigned long long range[2];
  int f = blockIdx.y;
  const int32_t* fr = frames + f * kFrameFields;
  int nl = fr[F_NLANES];
  if ((int)blockIdx.x * kThreads >= nl) return;
  load_lookup(lookups[f], s);
  int idx = blockIdx.x * kThreads + threadIdx.x;
  int lane = fr[F_LANE0] + idx;
  bool live = idx < nl && lane < n_lanes;
  uintptr_t base;
  const uint32_t* staged =
      stage_stream(src, fr, lanes, lane, live, stage, range, &base);
  if (!live) return;
  const int32_t* tab = tables + (size_t)f * 4 * kTableWords;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  Lane L;
  lane_init(L, src, fr, lanes, idx, lane, g, bpm, staged, base);
  Out o;
  out_init(o, g, f, idx * L.r);
  int16_t* cur = out_ptr(o, g, ypm, 0, y, u, v);
  if (L.target > 0) zero_block(cur);
  do {
    int at, val;
    bool ended;
    bool emit = unit_step(L, s, tab, g, ypm, bpm, at, val, ended);
    if (emit && cur != nullptr) cur[at] = (int16_t)val;
    if (ended) {
      if (L.slot == 0) out_mcu(o, g);
      cur = out_ptr(o, g, ypm, L.slot, y, u, v);
      if (L.blk < L.target) zero_block(cur);
    }
  } while (!lane_done(L));
  // A lane cut short (garbage, truncation): zeros for the rest of its
  // blocks after the one it stopped in.
  for (int b = L.blk + 1, slot = L.slot; b < L.target; ++b) {
    slot = slot + 1 == bpm ? 0 : slot + 1;
    if (slot == 0) out_mcu(o, g);
    zero_block(out_ptr(o, g, ypm, slot, y, u, v));
  }
  dcsum[3 * lane] = L.dc0;
  dcsum[3 * lane + 1] = L.dc1;
  dcsum[3 * lane + 2] = L.dc2;
}

// B22 pass 1: the lane's emitted coefficients, in decode order, into
// its segment of the log (ent: zigzag index << 16 | the value's 16
// bits), their count into cnt, and each of its blocks' first log index
// into start. The segment of lane idx starts at its first block, first
// = idx * bpm * r, in its frame's part of the log (frame f at f * blocks
// * 64 entries) and holds the coefficients of its blocks below nblk =
// min(target, the frame's blocks from there): all of them on consistent
// descriptors, where a lane emits only into its blocks below target, at
// most 64 a block. start[f * blocks + first + b] for b < nblk is the
// count as the lane enters block b, or its final count for a block it
// never enters. Grid as decode_kernel's.
__global__ void __launch_bounds__(kThreads)
log_kernel(const uint8_t* __restrict__ src,
           const int32_t* __restrict__ frames,
           const int32_t* __restrict__ lanes,
           const int32_t* __restrict__ tables,
           const Lookup* __restrict__ lookups, uint32_t* __restrict__ ent,
           int32_t* __restrict__ start, int32_t* __restrict__ cnt,
           int32_t* __restrict__ dcsum, int n_lanes, Geometry g) {
  __shared__ Lookup s;
  __shared__ uint32_t stage[kStageWords];
  __shared__ unsigned long long range[2];
  int f = blockIdx.y;
  const int32_t* fr = frames + f * kFrameFields;
  int nl = fr[F_NLANES];
  if ((int)blockIdx.x * kThreads >= nl) return;
  load_lookup(lookups[f], s);
  int idx = blockIdx.x * kThreads + threadIdx.x;
  int lane = fr[F_LANE0] + idx;
  bool live = idx < nl && lane < n_lanes;
  uintptr_t base;
  const uint32_t* staged =
      stage_stream(src, fr, lanes, lane, live, stage, range, &base);
  if (!live) return;
  const int32_t* tab = tables + (size_t)f * 4 * kTableWords;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  Lane L;
  lane_init(L, src, fr, lanes, idx, lane, g, bpm, staged, base);
  long long fb = (long long)g.mcus_x * g.mcus_y * bpm;
  long long first = min((long long)idx * bpm * L.r, fb);
  int nblk = (int)max(0LL, min((long long)L.target, fb - first));
  uint32_t* seg = ent + ((size_t)f * fb + first) * 64;
  int32_t* st = start + (size_t)f * fb + first;
  int c = 0;
  if (nblk > 0) st[0] = 0;
  do {
    int blk = L.blk, at, v;
    bool ended;
    if (unit_step(L, s, tab, g, ypm, bpm, at, v, ended) && blk < nblk)
      seg[c++] = (uint32_t)at << 16 | (uint16_t)v;
    if (ended && L.blk < nblk) st[L.blk] = c;
  } while (!lane_done(L));
  for (int b = L.blk + 1; b < nblk; ++b) st[b] = c;
  cnt[lane] = c;
  dcsum[3 * lane] = L.dc0;
  dcsum[3 * lane + 1] = L.dc1;
  dcsum[3 * lane + 2] = L.dc2;
}

constexpr int kRebuildThreads = 256;  // 32 blocks a CTA, 8 threads each
constexpr int kRebuildBlocks = kRebuildThreads / 8;

// B22 pass 2, after the carry scan: 8 threads per output block, every
// block of the grids once, in the grids' order (the batch's Y blocks
// row by row, then U's, then V's; gray: its one grid). The block is MCU
// m, slot `slot` of frame f, lane m / r's block b; its entries are
// [start[b], start[b + 1]) of the lane's segment, or [start[b], cnt)
// for the lane's last block. The 8 threads zero a tile in shared
// memory, scatter the entries into it, and write the block, thread t
// its bytes [16 t, 16 t + 16), the DC with its lane's carry prefix
// added (int16 wrap). A block of no lane (descriptors that do not
// cover the frame) is written as zeros, with no carry.
__global__ void __launch_bounds__(kRebuildThreads)
rebuild_kernel(const int32_t* __restrict__ frames,
               const uint32_t* __restrict__ ent,
               const int32_t* __restrict__ start,
               const int32_t* __restrict__ cnt,
               const int32_t* __restrict__ prefix, int16_t* __restrict__ y,
               int16_t* __restrict__ u, int16_t* __restrict__ v, Geometry g,
               int n_lanes) {
  __shared__ __align__(16) int16_t tile[kRebuildBlocks][64];
  int t = threadIdx.x & 7, grp = threadIdx.x >> 3;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  // Block counts in 32 bits (the launcher checks the batch's blocks fit).
  unsigned mcus = (unsigned)g.mcus_x * g.mcus_y;
  unsigned ny = mcus * ypm;            // Y (or gray) blocks a frame
  unsigned nc = g.gray ? 0u : mcus;    // U or V blocks a frame
  unsigned q = blockIdx.x * kRebuildBlocks + grp;
  bool valid = q < g.n * (ny + 2 * nc);
  int f = 0, m = 0, slot = 0;
  int16_t* out = y;
  if (valid && q < g.n * ny) {
    f = (int)(q / ny);
    unsigned rem = q - f * ny;
    out = y + (size_t)q * 64;
    if (g.gray) {
      m = (int)rem;
    } else {
      unsigned bw = g.mcus_x * g.hs;
      int by = (int)(rem / bw), bx = (int)(rem - by * bw);
      int my = by / g.vs, mx = bx / g.hs;
      m = my * g.mcus_x + mx;
      slot = (by - my * g.vs) * g.hs + bx - mx * g.hs;
    }
  } else if (valid) {
    unsigned qc = q - g.n * ny;
    int plane = (int)(qc / (g.n * nc));
    qc -= plane * g.n * nc;
    f = (int)(qc / nc);
    m = (int)(qc - f * nc);
    slot = ypm + plane;
    out = (plane ? v : u) + (size_t)qc * 64;
  }
  reinterpret_cast<uint4*>(tile[grp])[t] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  const int32_t* fr = frames + f * kFrameFields;
  int r = fr[F_R], idx = m / r, nl = fr[F_NLANES];
  int lane = fr[F_LANE0] + idx;
  bool owned = valid && idx < nl && lane < n_lanes;
  if (owned) {
    long long fb = (long long)mcus * bpm;
    long long first = (long long)idx * bpm * r;
    int target = idx < nl - 1
                     ? bpm * r : bpm * (int)(mcus - (long long)r * (nl - 1));
    int nblk = (int)min((long long)target, fb - first);
    int b = (int)((long long)m * bpm + slot - first);
    size_t sb = (size_t)f * fb + first + b;
    int s0 = start[sb];
    int s1 = b + 1 < nblk ? start[sb + 1] : cnt[lane];
    const uint32_t* seg = ent + ((size_t)f * fb + first) * 64;
    for (int e = s0 + t; e < s1; e += 8) {
      uint32_t x = seg[e];
      tile[grp][x >> 16] = (int16_t)(x & 0xFFFFu);
    }
  }
  __syncwarp();
  uint4 w = reinterpret_cast<const uint4*>(tile[grp])[t];
  if (owned && t == 0 && fr[F_CARRY]) {
    int comp = g.gray || slot < ypm ? 0 : slot - (ypm - 1);
    int16_t dc = (int16_t)(w.x & 0xFFFFu);
    dc = (int16_t)(dc + (int16_t)prefix[3 * lane + comp]);
    w.x = (w.x & 0xFFFF0000u) | (uint16_t)dc;
  }
  if (valid) reinterpret_cast<uint4*>(out)[t] = w;
}

// DC carry, pass 1: one CTA per frame; a frame that carries (F_CARRY)
// gets its lanes' DC sums replaced, in place, by their exclusive prefix
// over the frame's earlier lanes (three int32 sums, each wrapping).
__global__ void carry_scan_kernel(const int32_t* __restrict__ frames,
                                  int32_t* __restrict__ dcsum) {
  using uhdr_scan::U3;
  __shared__ U3 warp_sums[32];
  const int32_t* fr = frames + blockIdx.x * kFrameFields;
  if (!fr[F_CARRY]) return;
  int32_t* d = dcsum + 3 * (size_t)fr[F_LANE0];
  U3 zero{0u, 0u, 0u};
  uhdr_scan::block_scan_array<U3>(
      fr[F_NLANES], zero, zero, warp_sums,
      [&](int i) {
        return U3{(unsigned)d[3 * i], (unsigned)d[3 * i + 1],
                  (unsigned)d[3 * i + 2]};
      },
      [&](int i, U3 p) {
        d[3 * i] = (int32_t)p.x;
        d[3 * i + 1] = (int32_t)p.y;
        d[3 * i + 2] = (int32_t)p.z;
      });
}

// DC carry, pass 2: a thread per output block (MCU m, slot) of a
// carrying frame (grid: block tiles x frames). The block belongs to
// lane m / r; its DC gains that lane's prefix of its component (int16
// wrap), once. Blocks of no lane (descriptors that do not cover the
// frame) are left as they are.
__global__ void carry_add_kernel(const int32_t* __restrict__ frames,
                                 const int32_t* __restrict__ prefix,
                                 int16_t* __restrict__ y,
                                 int16_t* __restrict__ u,
                                 int16_t* __restrict__ v, Geometry g) {
  int f = blockIdx.y;
  const int32_t* fr = frames + f * kFrameFields;
  if (!fr[F_CARRY]) return;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.mcus_x * g.mcus_y * bpm) return;
  int m = b / bpm, slot = b - m * bpm;
  int idx = m / fr[F_R];
  if (idx >= fr[F_NLANES]) return;
  int comp = g.gray || slot < ypm ? 0 : slot - (ypm - 1);
  int16_t* blk = block_ptr(y, u, v, g, f, m, slot);
  int32_t add = prefix[3 * (fr[F_LANE0] + idx) + comp];
  blk[0] = (int16_t)(blk[0] + (int16_t)add);
}

Geometry make_geometry(int n, int gray, int hs, int vs, int mcus_x,
                       int mcus_y) {
  Geometry g;
  g.n = n;
  g.gray = gray;
  g.hs = hs;
  g.vs = vs;
  g.mcus_x = mcus_x;
  g.mcus_y = mcus_y;
  return g;
}

// The decode grid: lane tiles x frames. A frame has at most n_lanes
// lanes; the tiles past a frame's own lanes return at once.
dim3 decode_grid(int n, int n_lanes) {
  return dim3((unsigned)((n_lanes + kThreads - 1) / kThreads),
              (unsigned)n);
}

int launch_tables(const void* tables, void* lookups, int n,
                  cudaStream_t s) {
  table_kernel<<<n, kTableThreads, 0, s>>>((const int32_t*)tables,
                                           (Lookup*)lookups);
  return (int)cudaGetLastError();
}

int launch_carry(const void* frames, void* dcsum, void* y, void* u,
                 void* v, const Geometry& g, cudaStream_t s) {
  carry_scan_kernel<<<g.n, kScanThreads, 0, s>>>((const int32_t*)frames,
                                                 (int32_t*)dcsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long fb =
      (long long)g.mcus_x * g.mcus_y * (g.gray ? 1 : g.hs * g.vs + 2);
  dim3 grid((unsigned)((fb + kAddThreads - 1) / kAddThreads),
            (unsigned)g.n);
  carry_add_kernel<<<grid, kAddThreads, 0, s>>>(
      (const int32_t*)frames, (const int32_t*)dcsum, (int16_t*)y,
      (int16_t*)u, (int16_t*)v, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4. src: uint8 streams; frames: int32 (n, 8) descriptors; lanes: int32
// (n_lanes, 2) (start byte, start bit); tables: int32 (n, 4, 513);
// lookups: n * uhdr_huff_lookup_bytes() bytes of scratch (16-byte
// aligned); y, u, v: int16 zigzag grids (gray: pass the one grid three
// times); dcsum: int32 (n_lanes, 3) scratch (the lanes' DC sums, then,
// for carrying frames, their prefixes).
int uhdr_huff_decode(const void* src, const void* frames, const void* lanes,
                     const void* tables, void* lookups, void* y, void* u,
                     void* v, void* dcsum, int n, int n_lanes, int gray,
                     int hs, int vs, int mcus_x, int mcus_y, void* stream) {
  Geometry g = make_geometry(n, gray, hs, vs, mcus_x, mcus_y);
  cudaStream_t s = (cudaStream_t)stream;
  int e = launch_tables(tables, lookups, n, s);
  if (e != 0) return e;
  decode_kernel<<<decode_grid(n, n_lanes), kThreads, 0, s>>>(
      (const uint8_t*)src, (const int32_t*)frames, (const int32_t*)lanes,
      (const int32_t*)tables, (const Lookup*)lookups, (int16_t*)y,
      (int16_t*)u, (int16_t*)v, (int32_t*)dcsum, n_lanes, g);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return launch_carry(frames, dcsum, y, u, v, g, s);
}

// B22, on B4's inputs and outputs, with its log: ent int32 of n *
// blocks * 64 entries and start int32 of n * blocks (blocks: the grids'
// blocks of one frame, summed over the planes), cnt int32 (n_lanes)
// scratch. Runs the tables, pass 1, the carry scan, then pass 2 (which
// adds the carry).
int uhdr_huff_decode_log(const void* src, const void* frames,
                         const void* lanes, const void* tables,
                         void* lookups, void* ent, void* start, void* cnt,
                         void* y, void* u, void* v, void* dcsum, int n,
                         int n_lanes, int gray, int hs, int vs, int mcus_x,
                         int mcus_y, void* stream) {
  Geometry g = make_geometry(n, gray, hs, vs, mcus_x, mcus_y);
  cudaStream_t s = (cudaStream_t)stream;
  int e = launch_tables(tables, lookups, n, s);
  if (e != 0) return e;
  log_kernel<<<decode_grid(n, n_lanes), kThreads, 0, s>>>(
      (const uint8_t*)src, (const int32_t*)frames, (const int32_t*)lanes,
      (const int32_t*)tables, (const Lookup*)lookups, (uint32_t*)ent,
      (int32_t*)start, (int32_t*)cnt, (int32_t*)dcsum, n_lanes, g);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  carry_scan_kernel<<<n, kScanThreads, 0, s>>>((const int32_t*)frames,
                                               (int32_t*)dcsum);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  long long blocks =
      (long long)n * mcus_x * mcus_y * (gray ? 1 : hs * vs + 2);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  rebuild_kernel<<<(unsigned)((blocks + kRebuildBlocks - 1) /
                              kRebuildBlocks),
                   kRebuildThreads, 0, s>>>(
      (const int32_t*)frames, (const uint32_t*)ent, (const int32_t*)start,
      (const int32_t*)cnt, (const int32_t*)dcsum, (int16_t*)y, (int16_t*)u,
      (int16_t*)v, g, n_lanes);
  return (int)cudaGetLastError();
}

// Bytes of one frame's lookup scratch.
int uhdr_huff_lookup_bytes() { return (int)sizeof(Lookup); }

}  // extern "C"
