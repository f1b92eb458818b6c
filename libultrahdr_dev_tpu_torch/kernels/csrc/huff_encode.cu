// B3: restart-interval Huffman encode, for the port's
// jpeg/device_entropy.py.
//
// Replaces libultrahdr_dev_tpu/jpeg/device_entropy.py:
// encode_ycbcr_rst_stream / encode_gray_rst_stream (with
// interleave_blocks_device, _units_for_blocks, _block_word_buffers and
// _rst_assemble) as parallel/sharding.py:_batched_encode_to_streams_rst
// runs them, with cap_per_block=None.
//
// What it computes: one chunk per restart interval of r MCUs (4:2:0:
// [Y0 Y1 Y2 Y3 U V] per MCU, luma in 2x2 raster order; gray: one block
// per MCU), DC prediction reset at each interval, the Huffman code and
// extra bits of every DC / AC / ZRL / EOB unit packed MSB-first, the
// chunk 1-filled to the next 32-bit boundary and its bit count
// recorded; the chunks of all frames follow one another by word offset.
// Words are stored in JPEG byte order, so the output is a byte stream.
//
// Design: one thread per interval, in three launches: a counting pass
// (bits per chunk), an exclusive scan of the chunk word counts (one
// CTA), and a write pass that re-encodes each chunk into its words. The
// MCU interleave is index arithmetic on B2's per-plane zigzag grids.
// There is no per-block cap and no overflow: a chunk's words are
// written wherever the scan puts them, for any int16 content.
//
// Bound: memory traffic. Per 4080x3072 frame it reads 306,048 blocks x
// 128 B = 39.2 MB of coefficients and writes ~1-2 MB, ~12 us at
// 3.35 TB/s. A thread-serial coder with ~15k threads per frame is far
// from that: it is latency-bound on each thread's serial bit loop and
// reads its blocks with strided, uncoalesced loads. Making it fast
// (a warp per interval, coalesced block loads) is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;

struct Geometry {
  int n;       // frames
  int nc;      // chunks (restart intervals) per frame
  int r;       // MCUs per interval
  int color;   // 1: 4:2:0 MCUs of six blocks; 0: one block per MCU
  int mcus_x;  // MCUs per row (color)
  int n_mcus;  // MCUs per frame
  int ny;      // blocks per frame of the first grid (luma or gray)
  int nuv;     // blocks per frame of each chroma grid
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

struct CountSink {
  long long bits = 0;
  __device__ __forceinline__ void put(uint32_t, int len) { bits += len; }
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

  // 1-fill the last partial word (pad bits before RSTn, T.81 B.1.1.2).
  __device__ __forceinline__ void finish() {
    if (n > 0) {
      uint32_t w = (uint32_t)(acc << (32 - n)) | ((1u << (32 - n)) - 1);
      *out++ = bswap32(w);
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
  if (!g.color) {
    const int16_t* base = y + (size_t)f * g.ny * 64;
    int pred = 0;
    for (int m = m0; m < m1; ++m) {
      const int16_t* b = base + (size_t)m * 64;
      encode_block(b, pred, tab, tab + 256, sink);
      pred = b[0];
    }
    return;
  }
  const int16_t* yb = y + (size_t)f * g.ny * 64;
  const int16_t* ub = u + (size_t)f * g.nuv * 64;
  const int16_t* vb = v + (size_t)f * g.nuv * 64;
  int bw = 2 * g.mcus_x;
  int py = 0, pu = 0, pv = 0;
  for (int m = m0; m < m1; ++m) {
    int my = m / g.mcus_x, mx = m - my * g.mcus_x;
    for (int slot = 0; slot < 4; ++slot) {
      int by = 2 * my + (slot >> 1), bx = 2 * mx + (slot & 1);
      const int16_t* b = yb + ((size_t)by * bw + bx) * 64;
      encode_block(b, py, tab, tab + 256, sink);
      py = b[0];
    }
    const int16_t* bu = ub + (size_t)m * 64;
    encode_block(bu, pu, tab + 512, tab + 768, sink);
    pu = bu[0];
    const int16_t* bv = vb + (size_t)m * 64;
    encode_block(bv, pv, tab + 512, tab + 768, sink);
    pv = bv[0];
  }
}

__device__ void load_tables(const int32_t* __restrict__ tables,
                            uint32_t* tab) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
    tab[i] = (uint32_t)tables[i];
  __syncthreads();
}

__global__ void count_kernel(const int16_t* __restrict__ y,
                             const int16_t* __restrict__ u,
                             const int16_t* __restrict__ v,
                             const int32_t* __restrict__ tables,
                             int32_t* __restrict__ bits,
                             int32_t* __restrict__ words, Geometry g) {
  __shared__ uint32_t tab[4 * 256];
  load_tables(tables, tab);
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= g.n * g.nc) return;
  CountSink sink;
  encode_chunk(y, u, v, tab, g, lane / g.nc, lane % g.nc, sink);
  bits[lane] = (int32_t)sink.bits;
  words[lane] = (int32_t)((sink.bits + 31) >> 5);
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

Geometry make_geometry(int n, int nc, int r, int color, int mcus_x,
                       int n_mcus, int ny, int nuv) {
  Geometry g;
  g.n = n;
  g.nc = nc;
  g.r = r;
  g.color = color;
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
// offs: int64 (n * nc + 1) word offsets, the last one the total. Counts
// and scans; the caller reads offs[n * nc] to size the output.
int uhdr_huff_encode_count(const void* y, const void* u, const void* v,
                           const void* tables, void* bits, void* words,
                           void* offs, int n, int nc, int r, int color,
                           int mcus_x, int n_mcus, int ny, int nuv,
                           void* stream) {
  Geometry g = make_geometry(n, nc, r, color, mcus_x, n_mcus, ny, nuv);
  cudaStream_t s = (cudaStream_t)stream;
  int lanes = n * nc;
  count_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (int32_t*)bits, (int32_t*)words, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)words,
                                         (long long*)offs, lanes);
  return (int)cudaGetLastError();
}

// out: uint32 words (offs[n * nc] of them), JPEG byte order.
int uhdr_huff_encode_write(const void* y, const void* u, const void* v,
                           const void* tables, const void* offs, void* out,
                           int n, int nc, int r, int color, int mcus_x,
                           int n_mcus, int ny, int nuv, void* stream) {
  Geometry g = make_geometry(n, nc, r, color, mcus_x, n_mcus, ny, nuv);
  int lanes = n * nc;
  write_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const int16_t*)y, (const int16_t*)u, (const int16_t*)v,
      (const int32_t*)tables, (const long long*)offs, (uint32_t*)out, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
