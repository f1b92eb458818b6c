// Huffman encode of baseline JPEG scans, for the port's
// jpeg/device_entropy.py: B3 / B12-enc (restart intervals) and B19
// (restart-less). Both work in tiles of blocks read into shared
// memory, code each block with the same encode_block_mask and read B2's
// per-plane zigzag grids; the MCU interleave is index arithmetic
// (block_at).
//
// B3 replaces libultrahdr_dev_tpu/jpeg/device_entropy.py:
// encode_ycbcr_rst_stream / encode_gray_rst_stream (with
// interleave_blocks_device, _units_for_blocks, _block_word_buffers and
// _rst_assemble) as parallel/sharding.py:_batched_encode_to_streams_rst
// runs them, with cap_per_block=None, and, as B12-enc, as
// jpeg/codec.py:_device_rst_entropy runs them (_rst_kernel_ycbcr,
// _rst_kernel_gray) for encode_jpeg.
//
// What B3 computes: one chunk per restart interval of r MCUs (YCbCr:
// [Y x hs*vs, U, V] per MCU, luma in raster order inside the MCU; gray:
// one block per MCU), DC prediction reset at each interval, the Huffman
// code and extra bits of every DC / AC / ZRL / EOB unit packed
// MSB-first, the chunk 1-filled to the next 32-bit boundary and its bit
// count recorded; the chunks of all frames follow one another by word
// offset. Words are stored in JPEG byte order, so the output is a byte
// stream. The count pass also records the longest block in bits: the
// JAX encoder's per-block buffer holds 608 (_BLOCK_BIT_CAP), and its
// callers leave the restart route for a block longer than that.
//
// B3 design: B19's tiles (below), cut at restart intervals, in three
// launches. A tile holds K whole chunks (cb = r x blocks an MCU <= 256
// blocks: K = 256 / cb) or, for longer chunks, one of the P parts of
// 256 blocks of a chunk. (1) Count: a CTA per tile reads its blocks
// with 16-byte loads and a thread codes its block (encode_block_mask,
// DC predicted from the previous block of its component inside the
// chunk, 0 at the chunk's first block): each block's bits, the chunks'
// bits (whole chunks by the CTA's scan; a part adds its sum to its
// chunk), the tile's bits (whole chunks: rounded up to words each) and
// the longest block. (2) Scan, one CTA over the tiles of all frames
// (scan.cuh): each tile's global bit offset, a chunk's word rounding
// counted at its last part; the total words and the largest tile in
// words go to `meta`, which the wrapper reads with the longest block in
// its one sync. (3) Write: a CTA per tile places each block at the
// tile's offset plus the CTA's exclusive scan of its blocks' bits (the
// chunk's last block also 1-fills the chunk to a word), assembles the
// tile's words in shared memory and stores them coalesced; a tile of
// whole chunks owns its words, so the output needs no zero fill and no
// global atomic; only the words parts of a chunk share are ORed into a
// zeroed buffer.
//
// B19 replaces libultrahdr_dev_tpu/jpeg/device_entropy.py:
// encode_yuv420_stream / encode_gray_stream (_dc_prev_interleaved,
// _units_for_blocks, _assemble_bits) as parallel/sharding.py:
// _batched_encode_to_streams runs them. What it computes: each frame's
// whole scan as one MSB-first bit stream, DC predicted across the scan
// with no reset (each block from the previous block of its component),
// the frame's last word 1-filled, each frame starting on a word
// boundary, and the frame's bit count.
//
// B19 design, in three launches over tiles of 256 consecutive blocks
// (scan order) of one frame; a tile never straddles frames and a
// frame's last tile may be partial. A tile's CTA reads its blocks into
// a 32 KB shared tile, 8 threads a block with 16-byte loads (each
// block's 128 bytes coalesced); then a thread codes its block from
// there. Its DC predictor (the previous block of its component) comes
// from the tile when that block is in it, else one load. The coding
// (encode_block_mask) builds the block's 64-bit nonzero AC mask and
// walks its set bits: the DC unit, a ZRL per full 16 zeros before a
// nonzero and the nonzero's AC unit, an EOB when the last nonzero is
// before 63, T.81's unit sequence with no branch per zero. (1) Count:
// each block's bits and the tile's sum. (2) Scan, a CTA per frame (scan.cuh): the exclusive scan of the
// frame's tile sums in int64, from the frame's word-aligned base (the
// frames before it, each rounded up to whole words); each frame's bits
// and the total words go to `meta`, which the wrapper reads (its one
// sync) to size the output. (3) Write: each block from its tile's
// offset plus the CTA's exclusive scan of its blocks' bits, into the
// zeroed buffer: the words it may share with its neighbours (its first
// and its last) by atomicOr, the words inside it by plain stores (OR
// commutes with the byte swap).
//
// Bound: memory traffic. B3 per 4080x3072 frame reads 306,048 blocks x
// 128 B = 39.2 MB of coefficients and writes ~1-2 MB, ~12 us at
// 3.35 TB/s; B19 per 4000x3000 frame reads 282,000 blocks (36.1 MB),
// ~11 us, twice (count and write).
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

struct Geometry {
  int n;       // frames
  int nc;      // chunks (restart intervals) per frame (B3)
  int r;       // MCUs per interval (B3)
  int color;   // 1: YCbCr MCUs of hs*vs + 2 blocks; 0: one block per MCU
  int hs, vs;  // luma sampling factors (color)
  int mcus_x;  // MCUs per row (color)
  int n_mcus;  // MCUs per frame
  int ny;      // blocks per frame of the first grid (luma or gray)
  int nuv;     // blocks per frame of each chroma grid

  __host__ __device__ __forceinline__ int per_mcu() const {
    return color ? hs * vs + 2 : 1;
  }
};

// JPEG size category of |v|, saturated at 15 like the JAX _bitlen.
__device__ __forceinline__ int bitlen15(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  return min(32 - __clz(a), 15);
}

__device__ __forceinline__ uint32_t magnitude_bits(int v, int s) {
  return (uint32_t)(v >= 0 ? v : v + (1 << s) - 1) & ((1u << s) - 1);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// Block `s` of MCU `m` of frame `f`, and its component (0 Y, 1 U, 2 V).
__device__ __forceinline__ const int16_t* block_at(
    const int16_t* __restrict__ y, const int16_t* __restrict__ u,
    const int16_t* __restrict__ v, const Geometry& g, int f, int m, int s,
    int* comp) {
  if (!g.color) {
    *comp = 0;
    return y + ((size_t)f * g.ny + m) * 64;
  }
  int ypm = g.hs * g.vs;
  if (s >= ypm) {
    *comp = s - ypm + 1;
    return (s == ypm ? u : v) + ((size_t)f * g.nuv + m) * 64;
  }
  *comp = 0;
  int my = m / g.mcus_x, mx = m - my * g.mcus_x;
  int by = my * g.vs + s / g.hs, bx = mx * g.hs + s % g.hs;
  return y + ((size_t)f * g.ny + (size_t)by * g.mcus_x * g.hs + bx) * 64;
}

struct CountSink {
  long long bits = 0;
  long long mark = 0;
  int max_block = 0;  // longest block so far, in bits
  __device__ __forceinline__ void put(uint32_t, int len) { bits += len; }
  __device__ __forceinline__ void end_block() {
    max_block = max(max_block, (int)(bits - mark));
    mark = bits;
  }
};

// A block's writer: starts `bit` bits into a zeroed word buffer (global
// for B19, shared for B3); the first and the last word a block touches
// may hold a neighbour's bits too.
struct SharedWordSink {
  uint32_t* out;
  long long w;                 // word the pending bits go to
  unsigned long long acc = 0;  // pending bits in the low `n` bits
  int n;
  bool first = true;

  __device__ __forceinline__ SharedWordSink(uint32_t* o, long long bit)
      : out(o), w(bit >> 5), n((int)(bit & 31)) {}

  __device__ __forceinline__ void put(uint32_t v, int len) {
    if (len == 0) return;
    acc = (acc << len) | (v & (uint32_t)((1ull << len) - 1));
    n += len;
    if (n >= 32) {
      n -= 32;
      uint32_t word = bswap32((uint32_t)(acc >> n));
      if (first) {
        atomicOr(out + w, word);
        first = false;
      } else {
        out[w] = word;
      }
      ++w;
    }
  }

  __device__ __forceinline__ void end_block() {}

  // The partial last word; the last block of a frame (B19) or of a chunk
  // (B3) 1-fills it (pad bits before RSTn or EOI, T.81 B.1.1.2, F.1.2.3).
  __device__ __forceinline__ void finish(bool fill) {
    if (n > 0) {
      uint32_t word = (uint32_t)(acc << (32 - n));
      if (fill) word |= (1u << (32 - n)) - 1;
      atomicOr(out + w, bswap32(word));
    }
  }
};

// tab: [DC luma, AC luma, DC chroma, AC chroma] x 256 of (code << 5) |
// size, in shared memory.
__device__ void load_tables(const int32_t* __restrict__ tables,
                            uint32_t* tab) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
    tab[i] = (uint32_t)tables[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B19: restart-less scans, a CTA per tile of kTile blocks of one frame.
// ---------------------------------------------------------------------------

constexpr int kTile = 256;        // blocks (and threads) a B19 CTA
constexpr int kSlot = 72;         // int16s a block's slot in the tile
constexpr int kRlScanThreads = 1024;

// Component of block i (in scan order) and the scan index of its DC
// predictor: the previous block of the same component (luma: the
// previous luma block, across MCUs; chroma: its slot in the previous
// MCU), -1 for the first block of its component.
__device__ __forceinline__ int scan_pred(const Geometry& g, int i,
                                         int* comp) {
  int bpm = g.per_mcu();
  int m = i / bpm, s = i - m * bpm;
  int ypm = g.color ? g.hs * g.vs : 1;
  *comp = g.color && s >= ypm ? s - ypm + 1 : 0;
  if (*comp == 0 && s > 0) return i - 1;
  if (m == 0) return -1;
  return (m - 1) * bpm + (*comp ? s : ypm - 1);
}

// The tile of frame f from block tile0: up to kTile blocks, those
// before `end`, into 144-byte slots of `tile`, each block's 128 bytes
// read by 8 threads with 16-byte loads. Ends synchronized.
__device__ __forceinline__ void load_tile(const int16_t* __restrict__ y,
                                          const int16_t* __restrict__ u,
                                          const int16_t* __restrict__ v,
                                          const Geometry& g, int f,
                                          int tile0, int end,
                                          int16_t* tile) {
  int bpm = g.per_mcu();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int q = r * kTile + threadIdx.x;
    int b = q >> 3, part = q & 7;
    int i = tile0 + b;
    if (i < end) {
      int m = i / bpm, comp;
      const int16_t* src = block_at(y, u, v, g, f, m, i - m * bpm, &comp);
      reinterpret_cast<uint4*>(tile + b * kSlot)[part] =
          __ldg(reinterpret_cast<const uint4*>(src) + part);
    }
  }
  __syncthreads();
}

// Block i's DC predictor: from the tile when its block is there, else
// one load.
__device__ __forceinline__ int tile_pred(const int16_t* __restrict__ y,
                                         const int16_t* __restrict__ u,
                                         const int16_t* __restrict__ v,
                                         const Geometry& g, int f, int pi,
                                         int tile0, const int16_t* tile) {
  if (pi < 0) return 0;
  if (pi >= tile0) return tile[(pi - tile0) * kSlot];
  int bpm = g.per_mcu(), m = pi / bpm, comp;
  return block_at(y, u, v, g, f, m, pi - m * bpm, &comp)[0];
}

// The units of encode_block, from a block in shared memory by its
// nonzero AC mask: the DC unit, then for each nonzero (in zigzag order)
// a ZRL per full 16 zeros before it and its AC unit, then an EOB when
// the last nonzero is before 63 (T.81 F.1.2.2).
template <class Sink>
__device__ __forceinline__ void encode_block_mask(const int16_t* blk,
                                                  int pred,
                                                  const uint32_t* dc_t,
                                                  const uint32_t* ac_t,
                                                  Sink& sink) {
  unsigned long long mask = 0;
  const uint4* b4 = reinterpret_cast<const uint4*>(blk);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint4 q = b4[j];
    unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      unsigned long long two = ((w[h] & 0xFFFFu) ? 1ull : 0ull) |
                               ((w[h] >> 16) ? 2ull : 0ull);
      mask |= two << (8 * j + 2 * h);
    }
  }
  mask &= ~1ull;  // AC only
  int diff = (int)blk[0] - pred;
  int s = bitlen15(diff);
  uint32_t e = dc_t[s];
  sink.put(((e >> 5) << s) | magnitude_bits(diff, s), (int)(e & 31) + s);
  int last = 0;
  while (mask) {
    int k = __ffsll((long long)mask) - 1;
    mask &= mask - 1;
    for (int run = k - last - 1; run >= 16; run -= 16) {  // ZRL
      uint32_t z = ac_t[0xF0];
      sink.put(z >> 5, (int)(z & 31));
    }
    int val = blk[k];
    int sa = bitlen15(val);
    uint32_t a = ac_t[(((k - last - 1) & 15) << 4) | sa];
    sink.put(((a >> 5) << sa) | magnitude_bits(val, sa), (int)(a & 31) + sa);
    last = k;
  }
  if (last < 63) {  // EOB
    uint32_t z = ac_t[0];
    sink.put(z >> 5, (int)(z & 31));
  }
  sink.end_block();
}

// Count pass: blen[f * nb + i] = block i's bits; tsum[f * ntiles + t] =
// tile t's. Grid (tiles, frames).
__global__ void __launch_bounds__(kTile)
rl_count_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ u,
                const int16_t* __restrict__ v,
                const int32_t* __restrict__ tables,
                int32_t* __restrict__ blen, int32_t* __restrict__ tsum,
                Geometry g) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ __align__(16) int16_t tile[kTile * kSlot];
  __shared__ int warp_sums[32];
  load_tables(tables, tab);
  int f = blockIdx.y, nb = g.n_mcus * g.per_mcu();
  int tile0 = blockIdx.x * kTile, i = tile0 + threadIdx.x;
  load_tile(y, u, v, g, f, tile0, nb, tile);
  int bits = 0;
  if (i < nb) {
    int comp, pi = scan_pred(g, i, &comp);
    int pred = tile_pred(y, u, v, g, f, pi, tile0, tile);
    const uint32_t* t = comp ? tab + 512 : tab;
    CountSink sink;
    encode_block_mask(tile + threadIdx.x * kSlot, pred, t, t + 256, sink);
    bits = (int)sink.bits;
    blen[(size_t)f * nb + i] = bits;
  }
  int total;
  uhdr_scan::block_exclusive_scan(bits, 0, warp_sums, total);
  if (threadIdx.x == 0) tsum[(size_t)f * gridDim.x + blockIdx.x] = total;
}

// Scan pass, a CTA per frame: toff[f * ntiles + t] = the global bit
// offset of frame f's tile t (frame f from a word boundary: the frames
// before it each rounded up to whole words), meta[f] = frame f's bits,
// meta[n] = the total words.
__global__ void rl_scan_kernel(const int32_t* __restrict__ tsum,
                               long long* __restrict__ toff,
                               long long* __restrict__ meta, int n,
                               int ntiles) {
  __shared__ long long warp_sums[32];
  int f = blockIdx.x;
  auto sums = [&](int h) {
    return [=](int t) { return (long long)tsum[(size_t)h * ntiles + t]; };
  };
  long long base = 0;
  for (int h = 0; h < f; ++h)
    base += (uhdr_scan::block_scan_array<long long>(
                 ntiles, 0LL, 0LL, warp_sums, sums(h),
                 [](int, long long) {}) + 31) & ~31ll;
  long long end = uhdr_scan::block_scan_array<long long>(
      ntiles, base, 0LL, warp_sums, sums(f),
      [&](int t, long long off) { toff[(size_t)f * ntiles + t] = off; });
  if (threadIdx.x == 0) {
    meta[f] = end - base;
    if (f == n - 1) meta[n] = ((end + 31) & ~31ll) >> 5;
  }
}

// Write pass: each block from its tile's offset plus the exclusive scan
// of the tile's block lengths, into the zeroed word buffer.
__global__ void __launch_bounds__(kTile)
rl_write_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ u,
                const int16_t* __restrict__ v,
                const int32_t* __restrict__ tables,
                const int32_t* __restrict__ blen,
                const long long* __restrict__ toff,
                uint32_t* __restrict__ out, Geometry g) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ __align__(16) int16_t tile[kTile * kSlot];
  __shared__ int warp_sums[32];
  load_tables(tables, tab);
  int f = blockIdx.y, nb = g.n_mcus * g.per_mcu();
  int tile0 = blockIdx.x * kTile, i = tile0 + threadIdx.x;
  load_tile(y, u, v, g, f, tile0, nb, tile);
  int len = i < nb ? blen[(size_t)f * nb + i] : 0;
  int total;
  int pre = uhdr_scan::block_exclusive_scan(len, 0, warp_sums, total);
  if (i >= nb) return;
  int comp, pi = scan_pred(g, i, &comp);
  int pred = tile_pred(y, u, v, g, f, pi, tile0, tile);
  const uint32_t* t = comp ? tab + 512 : tab;
  SharedWordSink sink(out, toff[(size_t)f * gridDim.x + blockIdx.x] + pre);
  encode_block_mask(tile + threadIdx.x * kSlot, pred, t, t + 256, sink);
  sink.finish(i == nb - 1);
}

// ---------------------------------------------------------------------------
// B3 / B12-enc: restart intervals, a CTA per tile of whole chunks or of a
// part of one chunk.
// ---------------------------------------------------------------------------

constexpr int kRstScanThreads = 1024;

// How a frame's chunks (cb blocks each, the last may be short) fall
// into tiles: K whole chunks a tile (P = 1), or, for cb > kTile, P
// parts of kTile blocks a chunk (K = 1). T tiles a frame.
struct Tiling {
  int cb, K, P, T;
};

// Blocks [t0, t1) of tile t of a frame of nb blocks (t1 <= t0 when a
// short last chunk leaves the tile empty), and the chunk of the first.
__device__ __forceinline__ void tile_span(const Tiling& k, int t, int nb,
                                          int* t0, int* t1, int* c0) {
  if (k.P == 1) {
    *c0 = t * k.K;
    *t0 = *c0 * k.cb;
    *t1 = min(*t0 + k.K * k.cb, nb);
  } else {
    int c = t / k.P, p = t - c * k.P;
    *c0 = c;
    *t0 = c * k.cb + p * kTile;
    *t1 = min(c * k.cb + min((p + 1) * kTile, k.cb), nb);
  }
}

// Block i's DC predictor inside its chunk (from cs on): the previous
// block of its component there, or 0.
__device__ __forceinline__ int chunk_pred(const int16_t* __restrict__ y,
                                          const int16_t* __restrict__ u,
                                          const int16_t* __restrict__ v,
                                          const Geometry& g, int f, int i,
                                          int cs, int tile0,
                                          const int16_t* tile, int* comp) {
  int pi = scan_pred(g, i, comp);
  return tile_pred(y, u, v, g, f, pi < cs ? -1 : pi, tile0, tile);
}

// Count pass, grid (T, n): blen[f * nb + i] = block i's bits; for tiles
// of whole chunks, bits[f * nc + c] = each chunk's bits and tval = the
// tile's bits with each chunk rounded up to words; for parts, tval = the
// part's bits, added into its chunk's bits (zeroed by the caller);
// meta[1] = the longest block (zeroed by the caller).
__global__ void __launch_bounds__(kTile)
rst_count_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ u,
                 const int16_t* __restrict__ v,
                 const int32_t* __restrict__ tables, int32_t* __restrict__ bits,
                 int32_t* __restrict__ blen, int32_t* __restrict__ tval,
                 long long* __restrict__ meta, Geometry g, Tiling k) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ __align__(16) int16_t tile[kTile * kSlot];
  __shared__ int warp_sums[32];
  __shared__ int first[kTile];  // block scan at each chunk's first block
  __shared__ int tile_words;
  load_tables(tables, tab);
  int f = blockIdx.y, nb = g.n_mcus * g.per_mcu();
  int t0, t1, c0;
  tile_span(k, blockIdx.x, nb, &t0, &t1, &c0);
  if (threadIdx.x == 0) tile_words = 0;
  load_tile(y, u, v, g, f, t0, t1, tile);
  int i = t0 + threadIdx.x, nbits = 0, c = 0, cs = 0;
  bool live = i < t1;
  if (live) {
    c = i / k.cb;
    cs = c * k.cb;
    int comp;
    int pred = chunk_pred(y, u, v, g, f, i, cs, t0, tile, &comp);
    const uint32_t* t = comp ? tab + 512 : tab;
    CountSink sink;
    encode_block_mask(tile + threadIdx.x * kSlot, pred, t, t + 256, sink);
    nbits = (int)sink.bits;
    blen[(size_t)f * nb + i] = nbits;
  }
  int longest = nbits;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, d));
  if ((threadIdx.x & 31) == 0 && longest > 0)
    atomicMax((unsigned long long*)(meta + 1), (unsigned long long)longest);
  int total;
  int pre = uhdr_scan::block_exclusive_scan(nbits, 0, warp_sums, total);
  if (k.P > 1) {  // a part of one chunk
    if (threadIdx.x == 0 && t1 > t0) {
      tval[(size_t)f * gridDim.x + blockIdx.x] = total;
      atomicAdd(bits + (size_t)f * g.nc + c0, total);
    } else if (threadIdx.x == 0) {
      tval[(size_t)f * gridDim.x + blockIdx.x] = 0;
    }
    return;
  }
  if (live && i == cs) first[c - c0] = pre;
  __syncthreads();
  if (live && i == min(cs + k.cb, nb) - 1) {  // the chunk's last block
    int cbits = pre + nbits - first[c - c0];
    bits[(size_t)f * g.nc + c] = cbits;
    atomicAdd(&tile_words, (cbits + 31) >> 5);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    tval[(size_t)f * gridDim.x + blockIdx.x] = 32 * tile_words;
}

// Scan pass, one CTA over the n * T tiles in order: tbit[u] = tile u's
// global bit offset (a part's tval, plus the chunk's word padding at
// its last part); meta[0] = the total words, meta[2] = an upper bound
// of any tile's words in the write pass.
__global__ void __launch_bounds__(kRstScanThreads)
rst_scan_kernel(const int32_t* __restrict__ bits,
                const int32_t* __restrict__ tval, long long* __restrict__ tbit,
                long long* __restrict__ meta, Geometry g, Tiling k) {
  __shared__ long long warp_sums[32];
  __shared__ int widest;
  if (threadIdx.x == 0) widest = 0;
  __syncthreads();
  int nt = g.n * k.T;
  auto value = [&](int u) {
    long long vb = tval[u];
    int w = (int)((vb + 93) >> 5);  // + a part's padding and two edges
    if (w > widest) atomicMax(&widest, w);
    if (k.P > 1) {
      int f = u / k.T, t = u - f * k.T, c = t / k.P;
      if (t - c * k.P == k.P - 1) vb += (-bits[(size_t)f * g.nc + c]) & 31;
    }
    return vb;
  };
  long long end = uhdr_scan::block_scan_array<long long>(
      nt, 0LL, 0LL, warp_sums, value,
      [&](int u, long long off) { tbit[u] = off; });
  __syncthreads();
  if (threadIdx.x == 0) {
    meta[0] = end >> 5;
    meta[2] = widest;
  }
}

// Write pass, grid (T, n): each block at its tile's offset plus the
// CTA's exclusive scan of its blocks' bits (a chunk's last block with
// its 1-fill to the word), assembled in `words` (dynamic shared memory,
// max_words of them) and stored coalesced; the first and last words of
// a part that starts or ends inside a word are ORed into the output
// (zeroed by the caller for parts).
__global__ void __launch_bounds__(kTile)
rst_write_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ u,
                 const int16_t* __restrict__ v,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ bits,
                 const int32_t* __restrict__ blen,
                 const long long* __restrict__ tbit,
                 uint32_t* __restrict__ out, Geometry g, Tiling k) {
  __shared__ uint32_t tab[4 * 256];
  __shared__ __align__(16) int16_t tile[kTile * kSlot];
  __shared__ int warp_sums[32];
  extern __shared__ uint32_t words[];
  int f = blockIdx.y, nb = g.n_mcus * g.per_mcu();
  int t0, t1, c0;
  tile_span(k, blockIdx.x, nb, &t0, &t1, &c0);
  if (t1 <= t0) return;  // an empty part (the whole CTA)
  load_tables(tables, tab);
  load_tile(y, u, v, g, f, t0, t1, tile);
  int i = t0 + threadIdx.x;
  bool live = i < t1, last = false;
  int len = 0, c = 0, cs = 0;
  if (live) {
    c = i / k.cb;
    cs = c * k.cb;
    len = blen[(size_t)f * nb + i];
    last = i == min(cs + k.cb, nb) - 1;
    if (last) len += (-bits[(size_t)f * g.nc + c]) & 31;
  }
  int total;
  int pre = uhdr_scan::block_exclusive_scan(len, 0, warp_sums, total);
  long long base = tbit[(size_t)f * gridDim.x + blockIdx.x];
  int lead = (int)(base & 31);
  int nw = (lead + total + 31) >> 5;
  for (int w = threadIdx.x; w < nw; w += kTile) words[w] = 0;
  __syncthreads();
  if (live) {
    int comp;
    int pred = chunk_pred(y, u, v, g, f, i, cs, t0, tile, &comp);
    const uint32_t* t = comp ? tab + 512 : tab;
    SharedWordSink sink(words, lead + pre);
    encode_block_mask(tile + threadIdx.x * kSlot, pred, t, t + 256, sink);
    sink.finish(last);
  }
  __syncthreads();
  uint32_t* dst = out + (base >> 5);
  bool open_lo = lead != 0, open_hi = ((lead + total) & 31) != 0;
  for (int w = threadIdx.x; w < nw; w += kTile) {
    if ((w == 0 && open_lo) || (w == nw - 1 && open_hi))
      atomicOr(dst + w, words[w]);
    else
      dst[w] = words[w];
  }
}

Geometry make_geometry(int n, int nc, int r, int color, int hs, int vs,
                       int mcus_x, int n_mcus, int ny, int nuv) {
  Geometry g;
  g.n = n;
  g.nc = nc;
  g.r = r;
  g.color = color;
  g.hs = hs;
  g.vs = vs;
  g.mcus_x = mcus_x;
  g.n_mcus = n_mcus;
  g.ny = ny;
  g.nuv = nuv;
  return g;
}

}  // namespace

extern "C" {

// y, u, v: int16 zigzag grids (n, ny, 64) / (n, nuv, 64) (gray: pass the
// one grid three times); tables: int32 [4][256] (code << 5) | size;
// bits: int32 (n * nc) chunk bit counts; blen: int32 (n * nb) block
// bits; tval: int32 (n * T) and tbit: int64 (n * T) tile scratch; meta:
// int64 (3): the total words, the longest block in bits and the write
// pass's shared words. K, P, T: the tiling (jpeg/device_entropy.py:
// rst_tiling). Counts and scans; the caller reads meta to size the
// output.
int uhdr_huff_encode_count(const void* y, const void* u, const void* v,
                           const void* tables, void* bits, void* blen,
                           void* tval, void* tbit, void* meta, int n, int nc,
                           int r, int color, int hs, int vs, int mcus_x,
                           int n_mcus, int ny, int nuv, int K, int P, int T,
                           void* stream) {
  Geometry g = make_geometry(n, nc, r, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  Tiling k{r * g.per_mcu(), K, P, T};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(meta, 0, 3 * sizeof(long long), s);
  if (e == cudaSuccess && P > 1)
    e = cudaMemsetAsync(bits, 0, (size_t)n * nc * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  rst_count_kernel<<<dim3(T, n), kTile, 0, s>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (int32_t*)bits, (int32_t*)blen,
      (int32_t*)tval, (long long*)meta, g, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rst_scan_kernel<<<1, kRstScanThreads, 0, s>>>(
      (const int32_t*)bits, (const int32_t*)tval, (long long*)tbit,
      (long long*)meta, g, k);
  return (int)cudaGetLastError();
}

// out: uint32 words (meta[0] of them), JPEG byte order, zeroed when
// P > 1; bits, blen and tbit from uhdr_huff_encode_count, max_words =
// its meta[2].
int uhdr_huff_encode_write(const void* y, const void* u, const void* v,
                           const void* tables, const void* bits,
                           const void* blen, const void* tbit, void* out,
                           int n, int nc, int r, int color, int hs, int vs,
                           int mcus_x, int n_mcus, int ny, int nuv, int K,
                           int P, int T, int max_words, void* stream) {
  Geometry g = make_geometry(n, nc, r, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  Tiling k{r * g.per_mcu(), K, P, T};
  size_t smem = (size_t)max(max_words, 1) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      rst_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rst_write_kernel<<<dim3(T, n), kTile, smem, (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (const int32_t*)bits, (const int32_t*)blen,
      (const long long*)tbit, (uint32_t*)out, g, k);
  return (int)cudaGetLastError();
}

// B19. y, u, v, tables as above; blen: int32 (n * nb) block bits, nb =
// n_mcus * blocks per MCU; tsum: int32 (n * ntiles) tile bits and toff:
// int64 (n * ntiles) tile bit offsets, ntiles = ceil(nb / 256); meta:
// int64 (n + 1), each frame's bits then the total words. Counts and
// scans; the caller reads meta to size the output.
int uhdr_huff_encode_rl_count(const void* y, const void* u, const void* v,
                              const void* tables, void* blen, void* tsum,
                              void* toff, void* meta, int n, int color,
                              int hs, int vs, int mcus_x, int n_mcus,
                              int ny, int nuv, void* stream) {
  Geometry g = make_geometry(n, 0, 0, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  cudaStream_t s = (cudaStream_t)stream;
  int ntiles = (n_mcus * g.per_mcu() + kTile - 1) / kTile;
  rl_count_kernel<<<dim3(ntiles, n), kTile, 0, s>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (int32_t*)blen, (int32_t*)tsum, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rl_scan_kernel<<<n, kRlScanThreads, 0, s>>>(
      (const int32_t*)tsum, (long long*)toff, (long long*)meta, n, ntiles);
  return (int)cudaGetLastError();
}

// out: uint32 words (meta[n] of them), zeroed, JPEG byte order; blen and
// toff from uhdr_huff_encode_rl_count.
int uhdr_huff_encode_rl_write(const void* y, const void* u, const void* v,
                              const void* tables, const void* blen,
                              const void* toff, void* out, int n, int color,
                              int hs, int vs, int mcus_x, int n_mcus, int ny,
                              int nuv, void* stream) {
  Geometry g = make_geometry(n, 0, 0, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  int ntiles = (n_mcus * g.per_mcu() + kTile - 1) / kTile;
  rl_write_kernel<<<dim3(ntiles, n), kTile, 0, (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (const int32_t*)blen, (const long long*)toff,
      (uint32_t*)out, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
