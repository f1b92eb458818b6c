// B4: parallel restart-interval Huffman decode (with the B4h handoff
// read), for the port's jpeg/device_decode.py.
//
// Replaces libultrahdr_dev_tpu/jpeg/device_decode.py:decode_rst_chunks
// (with _window_table, the select-chain decode and
// deinterleave_ycbcr_device) as jpegr.py:_fused_decode_kernel_dev runs
// it, and parallel/sharding.py:_handoff_decode_kernel (B4h), which
// expands the encoder's big-endian words to bytes for it. B3 stores its
// words in JPEG byte order, so the handoff is this same kernel reading
// the encoder's chunk buffer in place at word-aligned lane starts.
//
// What it computes, per lane (a restart interval, or a synthesized
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
// length + 1, which a correct minimum never reaches). No read leaves
// the window and no lane loops forever on garbage.
//
// Design: one thread per lane, the 64 coefficients of the block being
// decoded in a local array that is written out (128 B) when the block
// ends. A table is the sorted (16-bit left-aligned boundary, symbol << 5
// | length) entries of the JAX select chain; the unit's symbol is the
// last entry whose boundary <= the next 16 bits, found by binary
// search, which equals the chain for any DHT. The carry is a second
// launch, one CTA per frame, scanning the lanes' DC sums.
//
// Bound: memory traffic. Per 4080x3072 frame it reads ~1-2 MB of
// stream and writes 39.2 MB of coefficients, ~12 us at 3.35 TB/s. With
// one thread per lane, ~15k threads per frame (~31k for a batch of two)
// sit far below the card's ~270k resident threads, and each runs a
// serial chain of dependent loads per unit: the kernel is bound by
// that latency, not by bytes. Making it faster is later work.
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
  int f = frame_of(frames, g.n, lane);
  const int32_t* fr = frames + f * kFrameFields;
  int idx = lane - fr[F_LANE0];
  int r = fr[F_R];
  int ypm = g.gray ? 1 : g.hs * g.vs;
  int bpm = g.gray ? 1 : ypm + 2;
  int n_mcus = g.mcus_x * g.mcus_y;
  int cb = bpm * r;
  int target = idx < fr[F_NLANES] - 1
                   ? cb : bpm * (n_mcus - r * (fr[F_NLANES] - 1));
  int win = fr[F_WIN];
  int start = lanes[2 * lane];
  int avail = min(win, fr[F_LEN] - start);
  const uint8_t* p = src + fr[F_OFF] + start;
  const int32_t* tab = tables + (size_t)f * 4 * kTableWords;
  long long max_bits = (long long)win * 8;
  int max_units = fr[F_MAXU];

  uint4 coef4[8];
  int16_t* coef = reinterpret_cast<int16_t*>(coef4);
#pragma unroll
  for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);

  int bit = lanes[2 * lane + 1];
  int blk = 0, k = 0, units = 0;
  int dcp[3] = {0, 0, 0};
  bool done = false;
  while (!done) {
    uint32_t w = window32(p, avail, bit);
    int slot = blk % bpm;
    bool luma = g.gray || slot < ypm;
    bool is_dc = k == 0;
    uint32_t pk = lookup(tab + ((is_dc ? 0 : 1) + (luma ? 0 : 2)) *
                                   kTableWords, w >> 16);
    int sym = (int)(pk >> 5), clen = (int)(pk & 31);
    int nextra = is_dc ? sym : (sym & 15);
    uint32_t extra =
        nextra > 0 ? (w << clen) >> ((unsigned)(32 - nextra) & 31u) : 0u;
    // T.81 F.2.2.1 EXTEND with the JAX version's int32 wrap-around.
    int val = 0;
    if (nextra > 0) {
      int half = (int)(1u << min(nextra - 1, 31));
      int full = (int)((1u << min(nextra, 31)) - 1u);
      int e = (int)extra;
      val = e < half ? (int)((unsigned)e - (unsigned)full) : e;
    }
    int comp = g.gray || slot < ypm ? 0 : slot - (ypm - 1);
    if (is_dc) {
      int dc = (int)((unsigned)dcp[comp] + (unsigned)val);
      dcp[comp] = dc;
      coef[0] = (int16_t)dc;
      k = 1;
    } else {
      bool eob = sym == 0, zrl = sym == 0xF0;
      int kk = min(k + (sym >> 4), 63);
      if (!(eob || zrl)) coef[kk] = (int16_t)val;
      if (eob || kk >= 63) {
        store_block(block_ptr(y, u, v, g, f, idx * r + blk / bpm, slot),
                    coef4);
#pragma unroll
        for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);
        ++blk;
        k = 0;
      } else {
        k = zrl ? k + 16 : kk + 1;
      }
    }
    bit += clen + nextra;
    ++units;
    done = blk >= target || bit > max_bits || units >= max_units;
  }
  // A lane cut short (garbage, truncation): its current block as far as
  // it got, zeros for the rest up to its target.
  for (int b = blk; b < target; ++b) {
    store_block(block_ptr(y, u, v, g, f, idx * r + b / bpm, b % bpm),
                coef4);
    if (b == blk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) coef4[i] = make_uint4(0, 0, 0, 0);
    }
  }
  dcsum[3 * lane] = dcp[0];
  dcsum[3 * lane + 1] = dcp[1];
  dcsum[3 * lane + 2] = dcp[2];
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

}  // namespace

extern "C" {

// src: uint8 streams; frames: int32 (n, 8) descriptors; lanes: int32
// (n_lanes, 2) (start byte, start bit); tables: int32 (n, 4, 513);
// y, u, v: int16 zigzag grids (gray: pass the one grid three times);
// dcsum: int32 (n_lanes, 3) scratch.
int uhdr_huff_decode(const void* src, const void* frames, const void* lanes,
                     const void* tables, void* y, void* u, void* v,
                     void* dcsum, int n, int n_lanes, int gray, int hs,
                     int vs, int mcus_x, int mcus_y, void* stream) {
  Geometry g;
  g.n = n;
  g.gray = gray;
  g.hs = hs;
  g.vs = vs;
  g.mcus_x = mcus_x;
  g.mcus_y = mcus_y;
  cudaStream_t s = (cudaStream_t)stream;
  decode_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const uint8_t*)src, (const int32_t*)frames, (const int32_t*)lanes,
      (const int32_t*)tables, (int16_t*)y, (int16_t*)u, (int16_t*)v,
      (int32_t*)dcsum, n_lanes, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  carry_kernel<<<n, kScanThreads, 0, s>>>(
      (const int32_t*)frames, (const int32_t*)dcsum, (int16_t*)y,
      (int16_t*)u, (int16_t*)v, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
