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
// The unit step (unit_step) is one __device__ function that both
// kernels call, so their decodes cannot drift apart. A table is the
// sorted (16-bit left-aligned boundary, symbol << 5 | length) entries
// of the JAX select chain; the unit's symbol is the last entry whose
// boundary <= the next 16 bits, found by binary search, which equals
// the chain for any DHT.
//
// B4: one thread per lane, the 64 coefficients of the block being
// decoded in a local array that is written out (128 B from one thread)
// when the block ends. B22: pass 1, one thread per lane, runs the same
// unit steps and appends each emitted coefficient (its int32 position
// in the lane, block * 64 + zigzag index, and its int16 value) to the
// lane's own segment of a log sized for every coefficient of the frame
// (a lane's segment starts at its first block * 64); it keeps no block
// array and writes no zeros. Positions rise strictly within a lane.
// Pass 2, one warp per output block: a lower bound of block * 64 in
// the lane's positions finds the block's first entry, the warp
// scatters the block's entries into a zeroed 64-entry tile in shared
// memory and writes the 128 B of the block coalesced. Both then run
// the DC carry as a third launch, one CTA per frame, scanning the
// lanes' DC sums.
//
// Bound: memory traffic. Per 4080x3072 frame B4 reads ~1-2 MB of
// stream and writes 39.2 MB of coefficients, ~12 us at 3.35 TB/s, and
// B22, the same function, has the same floor: its log (6 B per emitted
// coefficient, written and read back) is its own intermediate. With one
// thread per lane, ~15k threads per frame (~31k for a batch of two)
// sit far below the card's ~270k resident threads, and each runs a
// serial chain of dependent loads per unit: the decode is bound by
// that latency, not by bytes. B22 takes the stores out of that loop
// (B4 stores 128 B per block from one thread; B22 6 B per emitted
// coefficient) and writes the grids from a parallel pass. Making
// either faster is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kTableWords = 1 + 2 * 256;

// Per-frame descriptor fields (jpeg/device_decode.py F_*).
enum { F_OFF, F_LEN, F_WIN, F_R, F_LANE0, F_NLANES, F_CARRY, F_MAXU,
       kFrameFields };

struct Geometry {
  int n;        // frames
  int gray;     // 1: one block per MCU
  int hs, vs;   // luma sampling factors (color)
  int mcus_x, mcus_y;
};

// The 32 stream bits from bit `bit` of a lane's window, MSB first; bytes
// at or past `avail` read as zero.
__device__ __forceinline__ uint32_t window32(const uint8_t* __restrict__ p,
                                             int avail, int bit) {
  int byte = bit >> 3;
  unsigned long long v = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    int j = byte + i;
    v = (v << 8) | (j < avail ? p[j] : 0u);
  }
  return (uint32_t)(v >> (8 - (bit & 7)));
}

// Packed (symbol << 5 | length) of the last entry whose boundary <= peek
// (the first entry when none is).
__device__ __forceinline__ uint32_t lookup(const int32_t* __restrict__ t,
                                           uint32_t peek) {
  int cnt = t[0];
  const int32_t* bnd = t + 1;
  int i = 0;
#pragma unroll
  for (int step = 128; step > 0; step >>= 1) {
    int j = i + step;
    if (j < cnt && (uint32_t)bnd[j] <= peek) i = j;
  }
  return (uint32_t)t[257 + i];
}

__device__ __forceinline__ int frame_of(const int32_t* __restrict__ frames,
                                        int n, int lane) {
  int f = 0;
  while (f + 1 < n && frames[(f + 1) * kFrameFields + F_LANE0] <= lane) ++f;
  return f;
}

// Zigzag block of lane block b (MCU idx * r + b / bpm, slot b % bpm) in
// the output grids; nullptr for pad blocks past the frame's MCUs.
__device__ __forceinline__ int16_t* block_ptr(int16_t* y, int16_t* u,
                                              int16_t* v, const Geometry& g,
                                              int f, int m, int slot) {
  int n_mcus = g.mcus_x * g.mcus_y;
  if (m >= n_mcus) return nullptr;
  if (g.gray) return y + ((size_t)f * n_mcus + m) * 64;
  int ypm = g.hs * g.vs;
  if (slot < ypm) {
    int my = m / g.mcus_x, mx = m - my * g.mcus_x;
    int bw = g.mcus_x * g.hs;
    int row = my * g.vs + slot / g.hs, col = mx * g.hs + slot % g.hs;
    return y + ((size_t)f * n_mcus * ypm + (size_t)row * bw + col) * 64;
  }
  return (slot == ypm ? u : v) + ((size_t)f * n_mcus + m) * 64;
}

__device__ __forceinline__ void store_block(int16_t* dst, const uint4* c) {
  if (dst == nullptr) return;
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = c[i];
}

// One lane's inputs and decode state. The DC predictors are three
// scalars, not an array a component indexes: an indexed member would put
// the whole struct in local memory.
struct Lane {
  const uint8_t* p;      // the lane's first byte
  const int32_t* tab;    // its frame's four decode tables
  int avail;             // window bytes inside the stream
  int f, idx, r;         // frame, lane within the frame, MCUs per lane
  int target;            // blocks the lane decodes
  long long max_bits;
  int max_units;
  int bit, blk, k, units;
  int dc0, dc1, dc2;     // DC predictors of Y (or gray), U, V
};

__device__ __forceinline__ void lane_init(Lane& L,
                                          const uint8_t* __restrict__ src,
                                          const int32_t* __restrict__ frames,
                                          const int32_t* __restrict__ lanes,
                                          const int32_t* __restrict__ tables,
                                          int lane, const Geometry& g,
                                          int bpm) {
  L.f = frame_of(frames, g.n, lane);
  const int32_t* fr = frames + L.f * kFrameFields;
  L.idx = lane - fr[F_LANE0];
  L.r = fr[F_R];
  int n_mcus = g.mcus_x * g.mcus_y;
  L.target = L.idx < fr[F_NLANES] - 1
                 ? bpm * L.r : bpm * (n_mcus - L.r * (fr[F_NLANES] - 1));
  int win = fr[F_WIN];
  int start = lanes[2 * lane];
  L.avail = min(win, fr[F_LEN] - start);
  L.p = src + fr[F_OFF] + start;
  L.tab = tables + (size_t)L.f * 4 * kTableWords;
  L.max_bits = (long long)win * 8;
  L.max_units = fr[F_MAXU];
  L.bit = lanes[2 * lane + 1];
  L.blk = L.k = L.units = 0;
  L.dc0 = L.dc1 = L.dc2 = 0;
}

// Decode one unit (a codeword and its extra bits) of lane L and advance
// it. Returns true when the unit emits a coefficient: `at` is its
// zigzag index in the block the unit was decoded in (L.blk before the
// step) and `val` its value (for a DC unit the component's running DC,
// int32 wrap). `ended`: the unit ended that block.
__device__ __forceinline__ bool unit_step(Lane& L, const Geometry& g,
                                          int ypm, int bpm, int& at,
                                          int& val, bool& ended) {
  uint32_t w = window32(L.p, L.avail, L.bit);
  int slot = L.blk % bpm;
  bool luma = g.gray || slot < ypm;
  bool is_dc = L.k == 0;
  uint32_t pk = lookup(L.tab + ((is_dc ? 0 : 1) + (luma ? 0 : 2)) *
                                   kTableWords, w >> 16);
  int sym = (int)(pk >> 5), clen = (int)(pk & 31);
  int nextra = is_dc ? sym : (sym & 15);
  uint32_t extra =
      nextra > 0 ? (w << clen) >> ((unsigned)(32 - nextra) & 31u) : 0u;
  // T.81 F.2.2.1 EXTEND with the JAX version's int32 wrap-around.
  val = 0;
  if (nextra > 0) {
    int half = (int)(1u << min(nextra - 1, 31));
    int full = (int)((1u << min(nextra, 31)) - 1u);
    int e = (int)extra;
    val = e < half ? (int)((unsigned)e - (unsigned)full) : e;
  }
  bool emit = true;
  ended = false;
  if (is_dc) {
    bool u = !luma && slot == ypm;
    val = (int)((unsigned)(luma ? L.dc0 : u ? L.dc1 : L.dc2) +
                (unsigned)val);
    if (luma) L.dc0 = val; else if (u) L.dc1 = val; else L.dc2 = val;
    at = 0;
    L.k = 1;
  } else {
    bool eob = sym == 0, zrl = sym == 0xF0;
    int kk = min(L.k + (sym >> 4), 63);
    emit = !(eob || zrl);
    at = kk;
    if (eob || kk >= 63) {
      ++L.blk;
      L.k = 0;
      ended = true;
    } else {
      L.k = zrl ? L.k + 16 : kk + 1;
    }
  }
  L.bit += clen + nextra;
  ++L.units;
  return emit;
}

__device__ __forceinline__ bool lane_done(const Lane& L) {
  return L.blk >= L.target || L.bit > L.max_bits || L.units >= L.max_units;
}

// B4.
__global__ void decode_kernel(const uint8_t* __restrict__ src,
                              const int32_t* __restrict__ frames,
                              const int32_t* __restrict__ lanes,
                              const int32_t* __restrict__ tables,
                              int16_t* __restrict__ y,
                              int16_t* __restrict__ u,
                              int16_t* __restrict__ v,
                              int32_t* __restrict__ dcsum, int n_lanes,
                              Geometry g) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  Lane L;
  lane_init(L, src, frames, lanes, tables, lane, g, bpm);

  uint4 coef4[8];
  int16_t* coef = reinterpret_cast<int16_t*>(coef4);
#pragma unroll
  for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);

  do {
    int blk = L.blk, at, val;
    bool ended;
    if (unit_step(L, g, ypm, bpm, at, val, ended)) coef[at] = (int16_t)val;
    if (ended) {
      store_block(block_ptr(y, u, v, g, L.f, L.idx * L.r + blk / bpm,
                            blk % bpm), coef4);
#pragma unroll
      for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);
    }
  } while (!lane_done(L));
  // A lane cut short (garbage, truncation): its current block as far as
  // it got, zeros for the rest up to its target.
  for (int b = L.blk; b < L.target; ++b) {
    store_block(block_ptr(y, u, v, g, L.f, L.idx * L.r + b / bpm, b % bpm),
                coef4);
    if (b == L.blk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);
    }
  }
  dcsum[3 * lane] = L.dc0;
  dcsum[3 * lane + 1] = L.dc1;
  dcsum[3 * lane + 2] = L.dc2;
}

// B22 pass 1: the lane's emitted coefficients, in decode order, into
// its segment of the log (pos: position in the lane, block * 64 +
// zigzag index; val: the value), their count into cnt. The segment of
// lane idx starts at its first block, idx * bpm * r, in its frame's
// part of the log (frame f at f * blocks * 64 entries) and holds the
// positions below min(target, the frame's blocks from there) * 64: all
// of them on consistent descriptors, where a lane emits only into its
// blocks below target, at most 64 a block.
__global__ void log_kernel(const uint8_t* __restrict__ src,
                           const int32_t* __restrict__ frames,
                           const int32_t* __restrict__ lanes,
                           const int32_t* __restrict__ tables,
                           int32_t* __restrict__ pos,
                           int16_t* __restrict__ val,
                           int32_t* __restrict__ cnt,
                           int32_t* __restrict__ dcsum, int n_lanes,
                           Geometry g) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  Lane L;
  lane_init(L, src, frames, lanes, tables, lane, g, bpm);
  long long fb = (long long)g.mcus_x * g.mcus_y * bpm;
  long long first = min((long long)L.idx * bpm * L.r, fb);
  int limit = (int)max(0LL, min((long long)L.target, fb - first)) * 64;
  size_t seg = ((size_t)L.f * fb + first) * 64;
  int c = 0;
  do {
    int blk = L.blk, at, v;
    bool ended;
    if (unit_step(L, g, ypm, bpm, at, v, ended)) {
      int p = blk * 64 + at;
      if (p < limit) {
        pos[seg + c] = p;
        val[seg + c] = (int16_t)v;
        ++c;
      }
    }
  } while (!lane_done(L));
  cnt[lane] = c;
  dcsum[3 * lane] = L.dc0;
  dcsum[3 * lane + 1] = L.dc1;
  dcsum[3 * lane + 2] = L.dc2;
}

constexpr int kRebuildWarps = 8;

// B22 pass 2: one warp per output block (frame f, MCU m, slot), every
// block of the grids once. The block is lane m / r's block b; a lower
// bound of b * 64 in the lane's (rising) positions finds its first
// entry, the warp scatters the block's entries into a zeroed tile and
// writes its 128 B coalesced. A block of no lane (descriptors that do
// not cover the frame) is written as zeros.
__global__ void rebuild_kernel(const int32_t* __restrict__ frames,
                               const int32_t* __restrict__ pos,
                               const int16_t* __restrict__ val,
                               const int32_t* __restrict__ cnt,
                               int16_t* __restrict__ y,
                               int16_t* __restrict__ u,
                               int16_t* __restrict__ v, Geometry g) {
  __shared__ __align__(16) int16_t tile[kRebuildWarps][64];
  int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  long long fb = (long long)g.mcus_x * g.mcus_y * bpm;
  long long w = (long long)blockIdx.x * kRebuildWarps + warp;
  if (w >= fb * g.n) return;
  int f = (int)(w / fb);
  int rem = (int)(w - f * fb);
  int m = rem / bpm, slot = rem - m * bpm;
  const int32_t* fr = frames + f * kFrameFields;
  int r = fr[F_R], idx = m / r;
  uint32_t* tw = reinterpret_cast<uint32_t*>(tile[warp]);
  tw[t] = 0u;
  __syncwarp();
  if (idx < fr[F_NLANES]) {
    size_t seg = ((size_t)f * fb + (size_t)idx * bpm * r) * 64;
    const int32_t* lp = pos + seg;
    int nent = cnt[fr[F_LANE0] + idx];
    int key = ((m - idx * r) * bpm + slot) * 64;
    int lo = 0, hi = nent;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (lp[mid] < key) lo = mid + 1; else hi = mid;
    }
    int end = min(lo + 64, nent);
    for (int e = lo + t; e < end; e += 32) {
      int p = lp[e] - key;
      if (p < 64) tile[warp][p] = val[seg + e];
    }
  }
  __syncwarp();
  reinterpret_cast<uint32_t*>(block_ptr(y, u, v, g, f, m, slot))[t] = tw[t];
}

// DC carry of restart-less frames: one CTA per frame. The exclusive
// prefix over the frame's lanes of their DC sums (int32 wrap) is added
// to every DC of each lane (int16 wrap).
__global__ void carry_kernel(const int32_t* __restrict__ frames,
                             const int32_t* __restrict__ dcsum,
                             int16_t* __restrict__ y,
                             int16_t* __restrict__ u,
                             int16_t* __restrict__ v, Geometry g) {
  __shared__ unsigned part[3][kScanThreads];
  int f = blockIdx.x;
  const int32_t* fr = frames + f * kFrameFields;
  if (!fr[F_CARRY]) return;
  int lane0 = fr[F_LANE0], nl = fr[F_NLANES], r = fr[F_R];
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  int t = threadIdx.x;
  int per = (nl + kScanThreads - 1) / kScanThreads;
  int lo = min(t * per, nl), hi = min(lo + per, nl);
  unsigned s[3] = {0, 0, 0};
  for (int i = lo; i < hi; ++i)
    for (int c = 0; c < 3; ++c) s[c] += (unsigned)dcsum[3 * (lane0 + i) + c];
  for (int c = 0; c < 3; ++c) part[c][t] = s[c];
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    unsigned add[3];
    for (int c = 0; c < 3; ++c) add[c] = t >= d ? part[c][t - d] : 0u;
    __syncthreads();
    for (int c = 0; c < 3; ++c) part[c][t] += add[c];
    __syncthreads();
  }
  unsigned run[3];
  for (int c = 0; c < 3; ++c) run[c] = part[c][t] - s[c];
  for (int i = lo; i < hi; ++i) {
    for (int b = 0; b < bpm * r; ++b) {
      int slot = b % bpm;
      int16_t* blk = block_ptr(y, u, v, g, f, i * r + b / bpm, slot);
      if (blk == nullptr) continue;
      int comp = g.gray || slot < ypm ? 0 : slot - (ypm - 1);
      blk[0] = (int16_t)(blk[0] + (int16_t)run[comp]);
    }
    for (int c = 0; c < 3; ++c)
      run[c] += (unsigned)dcsum[3 * (lane0 + i) + c];
  }
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

int launch_carry(const void* frames, const void* dcsum, void* y, void* u,
                 void* v, const Geometry& g, cudaStream_t s) {
  carry_kernel<<<g.n, kScanThreads, 0, s>>>(
      (const int32_t*)frames, (const int32_t*)dcsum, (int16_t*)y,
      (int16_t*)u, (int16_t*)v, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4. src: uint8 streams; frames: int32 (n, 8) descriptors; lanes: int32
// (n_lanes, 2) (start byte, start bit); tables: int32 (n, 4, 513);
// y, u, v: int16 zigzag grids (gray: pass the one grid three times);
// dcsum: int32 (n_lanes, 3) scratch.
int uhdr_huff_decode(const void* src, const void* frames, const void* lanes,
                     const void* tables, void* y, void* u, void* v,
                     void* dcsum, int n, int n_lanes, int gray, int hs,
                     int vs, int mcus_x, int mcus_y, void* stream) {
  Geometry g = make_geometry(n, gray, hs, vs, mcus_x, mcus_y);
  cudaStream_t s = (cudaStream_t)stream;
  decode_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const uint8_t*)src, (const int32_t*)frames, (const int32_t*)lanes,
      (const int32_t*)tables, (int16_t*)y, (int16_t*)u, (int16_t*)v,
      (int32_t*)dcsum, n_lanes, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_carry(frames, dcsum, y, u, v, g, s);
}

// B22, on B4's inputs and outputs, with its log: pos int32 and val
// int16 of n * blocks * 64 entries (blocks: the grids' blocks of one
// frame, summed over the planes), cnt int32 (n_lanes) scratch.
int uhdr_huff_decode_log(const void* src, const void* frames,
                         const void* lanes, const void* tables, void* pos,
                         void* val, void* cnt, void* y, void* u, void* v,
                         void* dcsum, int n, int n_lanes, int gray, int hs,
                         int vs, int mcus_x, int mcus_y, void* stream) {
  Geometry g = make_geometry(n, gray, hs, vs, mcus_x, mcus_y);
  cudaStream_t s = (cudaStream_t)stream;
  log_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const uint8_t*)src, (const int32_t*)frames, (const int32_t*)lanes,
      (const int32_t*)tables, (int32_t*)pos, (int16_t*)val, (int32_t*)cnt,
      (int32_t*)dcsum, n_lanes, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long bpm = gray ? 1 : hs * vs + 2;
  long long warps = (long long)n * mcus_x * mcus_y * bpm;
  rebuild_kernel<<<(unsigned)((warps + kRebuildWarps - 1) / kRebuildWarps),
                   kRebuildWarps * 32, 0, s>>>(
      (const int32_t*)frames, (const int32_t*)pos, (const int16_t*)val,
      (const int32_t*)cnt, (int16_t*)y, (int16_t*)u, (int16_t*)v, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_carry(frames, dcsum, y, u, v, g, s);
}

}  // extern "C"
