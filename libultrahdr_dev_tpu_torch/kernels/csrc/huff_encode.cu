// Huffman encode of baseline JPEG scans, for the port's
// jpeg/device_entropy.py: B3 / B12-enc (restart intervals) and B19
// (restart-less). Both code each block with the same encode_block and
// read B2's per-plane zigzag grids; the MCU interleave is index
// arithmetic (block_at).
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
// B3 design: one thread per interval, in three launches: a counting
// pass (bits per chunk), an exclusive scan of the chunk word counts (one
// CTA), and a write pass that re-encodes each chunk into its words.
// There is no cap and no overflow: a chunk's words are written wherever
// the scan puts them, for any int16 content.
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
// before 63, the same unit sequence as encode_block (which B3 keeps),
// with no branch per zero. (1) Count: each block's bits and the tile's
// sum. (2) Scan, a CTA per frame (scan.cuh): the exclusive scan of the
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
// ~11 us, twice (count and write). B3 is latency-bound on each
// thread's serial bit loop over ~15k threads per frame, and its one-CTA
// scan is serial per thread; scan.cuh's helpers are there for it.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;

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

// MSB-first bit writer into 32-bit words in JPEG byte order.
struct WriteSink {
  uint32_t* out;
  unsigned long long acc = 0;  // pending bits in the low `n` bits
  int n = 0;

  __device__ __forceinline__ void put(uint32_t v, int len) {
    if (len == 0) return;
    acc = (acc << len) | (v & (uint32_t)((1ull << len) - 1));
    n += len;
    if (n >= 32) {
      n -= 32;
      *out++ = bswap32((uint32_t)(acc >> n));
    }
  }

  __device__ __forceinline__ void end_block() {}

  // 1-fill the last partial word (pad bits before RSTn, T.81 B.1.1.2).
  __device__ __forceinline__ void finish() {
    if (n > 0) {
      uint32_t w = (uint32_t)(acc << (32 - n)) | ((1u << (32 - n)) - 1);
      *out++ = bswap32(w);
    }
  }
};

// B19's writer: starts `bit` bits into a zeroed word buffer; the first
// and the last word a block touches may hold a neighbour's bits too.
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

  // The partial last word; the frame's last block 1-fills it.
  __device__ __forceinline__ void finish(bool fill) {
    if (n > 0) {
      uint32_t word = (uint32_t)(acc << (32 - n));
      if (fill) word |= (1u << (32 - n)) - 1;
      atomicOr(out + w, bswap32(word));
    }
  }
};

// tab: (code << 5) | size for 256 symbols.
template <class Sink>
__device__ void encode_block(const int16_t* __restrict__ blk, int pred,
                             const uint32_t* dc_t, const uint32_t* ac_t,
                             Sink& sink) {
  int diff = (int)blk[0] - pred;
  int s = bitlen15(diff);
  uint32_t e = dc_t[s];
  sink.put(((e >> 5) << s) | magnitude_bits(diff, s), (int)(e & 31) + s);
  int run = 0, last = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[k];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run >= 16; run -= 16) {  // ZRL
      uint32_t z = ac_t[0xF0];
      sink.put(z >> 5, (int)(z & 31));
    }
    int sa = bitlen15(v);
    uint32_t a = ac_t[(run << 4) | sa];
    sink.put(((a >> 5) << sa) | magnitude_bits(v, sa), (int)(a & 31) + sa);
    run = 0;
    last = k;
  }
  if (last < 63) {  // EOB
    uint32_t z = ac_t[0];
    sink.put(z >> 5, (int)(z & 31));
  }
  sink.end_block();
}

// Encodes chunk c of frame f. tab: [DC luma, AC luma, DC chroma,
// AC chroma] x 256 in shared memory.
template <class Sink>
__device__ void encode_chunk(const int16_t* __restrict__ y,
                             const int16_t* __restrict__ u,
                             const int16_t* __restrict__ v,
                             const uint32_t* tab, const Geometry& g, int f,
                             int c, Sink& sink) {
  int m0 = c * g.r;
  int m1 = min(m0 + g.r, g.n_mcus);
  int bpm = g.per_mcu();
  int pred[3] = {0, 0, 0};
  for (int m = m0; m < m1; ++m) {
    for (int s = 0; s < bpm; ++s) {
      int comp;
      const int16_t* b = block_at(y, u, v, g, f, m, s, &comp);
      const uint32_t* t = comp ? tab + 512 : tab;
      encode_block(b, pred[comp], t, t + 256, sink);
      pred[comp] = b[0];
    }
  }
}

__device__ void load_tables(const int32_t* __restrict__ tables,
                            uint32_t* tab) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
    tab[i] = (uint32_t)tables[i];
  __syncthreads();
}

// offs[n * nc + 1] (zeroed by the caller) receives the longest block.
__global__ void count_kernel(const int16_t* __restrict__ y,
                             const int16_t* __restrict__ u,
                             const int16_t* __restrict__ v,
                             const int32_t* __restrict__ tables,
                             int32_t* __restrict__ bits,
                             int32_t* __restrict__ words,
                             long long* __restrict__ offs, Geometry g) {
  __shared__ uint32_t tab[4 * 256];
  load_tables(tables, tab);
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= g.n * g.nc) return;
  CountSink sink;
  encode_chunk(y, u, v, tab, g, lane / g.nc, lane % g.nc, sink);
  bits[lane] = (int32_t)sink.bits;
  words[lane] = (int32_t)((sink.bits + 31) >> 5);
  atomicMax((unsigned long long*)(offs + g.n * g.nc + 1),
            (unsigned long long)sink.max_block);
}

// Exclusive scan of words[0..n) into offs[0..n], offs[n] = total, in one
// CTA: each thread sums a contiguous run, the CTA scans the run sums in
// shared memory, each thread writes its run's offsets.
__global__ void scan_kernel(const int32_t* __restrict__ words,
                            long long* __restrict__ offs, int n) {
  __shared__ long long part[kScanThreads];
  int t = threadIdx.x;
  int per = (n + kScanThreads - 1) / kScanThreads;
  int lo = min(t * per, n), hi = min(lo + per, n);
  long long s = 0;
  for (int i = lo; i < hi; ++i) s += words[i];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    long long add = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  long long run = part[t] - s;
  for (int i = lo; i < hi; ++i) {
    offs[i] = run;
    run += words[i];
  }
  if (t == kScanThreads - 1) offs[n] = part[t];
}

__global__ void write_kernel(const int16_t* __restrict__ y,
                             const int16_t* __restrict__ u,
                             const int16_t* __restrict__ v,
                             const int32_t* __restrict__ tables,
                             const long long* __restrict__ offs,
                             uint32_t* __restrict__ out, Geometry g) {
  __shared__ uint32_t tab[4 * 256];
  load_tables(tables, tab);
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= g.n * g.nc) return;
  WriteSink sink;
  sink.out = out + offs[lane];
  encode_chunk(y, u, v, tab, g, lane / g.nc, lane % g.nc, sink);
  sink.finish();
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

// The tile of frame f from block tile0: kTile blocks (fewer at the
// frame's end) into 144-byte slots of `tile`, each block's 128 bytes
// read by 8 threads with 16-byte loads. Ends synchronized.
__device__ __forceinline__ void load_tile(const int16_t* __restrict__ y,
                                          const int16_t* __restrict__ u,
                                          const int16_t* __restrict__ v,
                                          const Geometry& g, int f,
                                          int tile0, int nb,
                                          int16_t* tile) {
  int bpm = g.per_mcu();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int q = r * kTile + threadIdx.x;
    int b = q >> 3, part = q & 7;
    int i = tile0 + b;
    if (i < nb) {
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
// the last nonzero is before 63. The same unit sequence as encode_block
// (which B3 keeps).
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
// bits: int32 (n * nc) chunk bit counts; words: int32 (n * nc) scratch;
// offs: int64 (n * nc + 2), zeroed: word offsets, offs[n * nc] the total
// words, offs[n * nc + 1] the longest block in bits. Counts and scans;
// the caller reads the last two to size the output.
int uhdr_huff_encode_count(const void* y, const void* u, const void* v,
                           const void* tables, void* bits, void* words,
                           void* offs, int n, int nc, int r, int color,
                           int hs, int vs, int mcus_x, int n_mcus, int ny,
                           int nuv, void* stream) {
  Geometry g = make_geometry(n, nc, r, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  cudaStream_t s = (cudaStream_t)stream;
  int lanes = n * nc;
  count_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (int32_t*)bits, (int32_t*)words,
      (long long*)offs, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)words,
                                         (long long*)offs, lanes);
  return (int)cudaGetLastError();
}

// out: uint32 words (offs[n * nc] of them), JPEG byte order.
int uhdr_huff_encode_write(const void* y, const void* u, const void* v,
                           const void* tables, const void* offs, void* out,
                           int n, int nc, int r, int color, int hs, int vs,
                           int mcus_x, int n_mcus, int ny, int nuv,
                           void* stream) {
  Geometry g = make_geometry(n, nc, r, color, hs, vs, mcus_x, n_mcus, ny,
                             nuv);
  int lanes = n * nc;
  write_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (const long long*)offs, (uint32_t*)out, g);
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
