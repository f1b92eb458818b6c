// B1, B9 and B10a-c: the encode front ends for the port's ops/gainmap.py.
//
// B1 (uhdr_encode_front, API-0) replaces
// libultrahdr_dev_tpu/parallel/sharding.py:_gainmap_and_coefs (the part
// before the fDCT) with _encode_one_image_coefs' tonemap, and the
// ops/gainmap.py helpers it runs: p010_to_float, yuv420_to_float,
// _box_mean, _convert_yuv_kernel, and ops/color.py:encode_gain. B9
// (uhdr_encode_front_api1, API-1) replaces the same _gainmap_and_coefs
// as sharding.py:_batched_encode_api1_kernel runs it: the SDR comes in
// as its own u8 planes, the SDR and HDR signals each have their gamut's
// YUV matrix, the linear HDR RGB is converted into the SDR gamut
// (ops/color.py:hdr_gamut_conversion_matrix) before its luminance, both
// luminances take the SDR gamut's weights, and the base is the SDR
// re-encoded from its gamut's YUV to BT.601.
//
// B10a-c are the general encode routes' three programs, one launch
// each, for any even frame size (the JAX package runs them apart for
// frames B1 / B9 do not take): B10a (uhdr_tonemap_p010) replaces
// ops/gainmap.py:tonemap_p010; B10b (uhdr_generate_gainmap) replaces
// ops/gainmap.py:_generate_kernel, as gain_kernel's SDR-planes variant
// with an sdr_is_601 arm (a BT.601 SDR matrix, a parameter) and a table
// arm (kLut, use_luts); B10c (uhdr_convert_yuv) replaces
// ops/gainmap.py:_convert_yuv_kernel, as front_kernel's re-encode over
// u8 planes (convert_kernel).
//
// Bound: B1 reads the P010 frame (37.6 MB for 4080x3072) and writes 19.6
// MB of u8 output (57.2 MB, 17 us at 3.35 TB/s); API-1 also reads the 18.8
// MB SDR frame. On the H100 the pass is bound by its instructions rather
// than its bytes: cut to its loads and stores it takes ~20 us a frame, its
// arithmetic and stores without the loads ~29 us (the box sums in their
// fixed order, the re-encode and the transfer functions; PERF.md). B1 and
// B9 are one launch and one pass over the frame (front_kernel): a thread
// owns an 8 x 4 luma tile, exactly two 4x4 gain-map boxes and their 2x2
// chroma boxes (a 4-column tile, one box, halves the registers and was
// slower with HLG). It loads the tile's four luma rows and two interleaved
// CbCr rows with one 16-byte load each (API-1 also the SDR tile: four
// 8-byte luma rows, two 4-byte U and V rows), and from the same registers
// writes the two gain codes (one 2-byte store), the 8 x 4 BT.601 luma (a
// 8-byte store a row) and the 4 + 4 chroma bytes of each chroma row
// (4-byte stores); consecutive threads take consecutive tiles of a row, so
// every load and store is coalesced. Frames are 16-aligned, so a row holds
// w / 8 whole tiles; the grid is flat over (frame, tile row, tile) and
// needs no tile count of a CTA to divide a row. (An earlier form ran two
// launches, a thread per gain sample with 24 scalar 2-byte loads and a
// thread per chroma sample with single-byte stores, and read the frame
// twice.) B10b (gain_kernel) keeps a thread per gain sample over u8 SDR
// planes of any even size (box remainders cropped), B10c (convert_kernel)
// a thread per chroma sample, and B10a is a copy that narrows 8-byte loads
// of P010 to bytes; apart, the three read the SDR planes twice and write
// and re-read the tonemapped frame, which B1 does not.
//
// The transfer functions. The sRGB inverse OETF (three a sample) and
// the PQ inverse OETF (two powers a channel, six a sample) are float
// pow()s rounded as a double pow; every one is pow_exact (color.cuh),
// pow_rn's bits from a short table-driven log2 / exp2 in double, with
// the tables (2.5 KB) staged in each CTA's shared memory. The HLG
// inverse OETF is an expf. With PQ, a sample's nine pows (~7 M a
// 4080x3072 frame, ~0.04 ms at pow_exact's measured rate) hold the pass
// well above its byte floor.
//
// Numerics: the box means are summed as the plain version and the JAX
// _box_mean sum them (each sample normalized, float32, row-major from
// 0), so they are bit-exact (integer box sums scaled once differ from
// them in the last bits, enough to move 1.4e-4 of B10b's gain codes by
// 1 on a 4000x3000 frame on an H100). What remains apart is CUDA's
// exp / log2 against PyTorch's in the plain version; the chip check
// allows a code of 1 on <= 1e-4 of samples. The boundary codes of
// encode_gain (saturate at 254) come in from the host, computed in
// float64 as ops/color.py does. The base planes and the tonemap round
// as the plain versions do and are bit-exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

struct GainParams {
  uhdr::YuvToRgb sdr_rgb, hdr_rgb;  // each signal's gamut's YUV matrix
  float lum_r, lum_g, lum_b;        // the SDR gamut's weights
  int tf;
  float hdr_white;
  float min_b, max_b, log2_min, inv_denom;
  int sat_code, floor_code;
  int gamut;    // 1: gm takes linear HDR RGB into the SDR gamut
  float gm[9];  // row-major 3x3
};

struct ConvertParams {
  int enabled;
  float m01, m02, m11, m12, m21, m22;
};

// The SDR input of the kPlanes variant (API-1) and of B10b / B10c: its
// own u8 planes. Without kPlanes (API-0) the SDR is the top 8 bits of
// the P010 samples, API-0's tonemap, and these pointers are unused.
struct SdrPlanes {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
};

// Table sizes of the kLut arm (ops/color.py SRGB_INV_OETF_NUM_ENTRIES,
// HLG_INV_OETF_NUM_ENTRIES = PQ_INV_OETF_NUM_ENTRIES).
constexpr int kSrgbLutN = 1 << 10;
constexpr int kInvLutN = 1 << 12;
constexpr int kFrontThreads = 256;

// A gain-map sample's box means of the normalized signals
// (yuv420_to_float, p010_to_float, _box_mean): SDR and HDR Y, U, V.
struct Boxes {
  float sy, su, sv, hy, hu, hv;
};

constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kInv876 = (float)(1.0 / 876.0);
constexpr float kInv896 = (float)(1.0 / 896.0);

// (uint8_t)fminf(fmaxf(v, 0), 255) for any v (NaN: 0), truncating: one
// saturating conversion on the card in place of two clamps and a
// conversion. (The host compiler's pass sees the clamps.)
__device__ __forceinline__ int sat_u8(float v) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm("cvt.rzi.sat.u8.f32 %0, %1;" : "=r"(r) : "f"(v));
  return (int)(r & 0xFFu);
#else
  return (int)(uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
#endif
}

// Luma sample terms of the box sums: the SDR byte and the 10-bit HDR
// code, each normalized.
__device__ __forceinline__ void add_luma(Boxes& x, int s8, int y16) {
  x.sy = x.sy + (float)s8 * kInv255;
  x.hy = x.hy + (float)((y16 >> 6) - 64) * kInv876;
}

// Chroma sample terms: the SDR bytes and the 10-bit HDR codes.
__device__ __forceinline__ void add_chroma(Boxes& x, int u8, int v8,
                                           int u16, int v16) {
  x.su = x.su + ((float)u8 - 128.0f) * kInv255;
  x.sv = x.sv + ((float)v8 - 128.0f) * kInv255;
  x.hu = x.hu + fmaf((float)((u16 >> 6) - 64), kInv896, -0.5f);
  x.hv = x.hv + fmaf((float)((v16 >> 6) - 64), kInv896, -0.5f);
}

// The u8 gain code of one sample from its box sums (scaled here by 1/16
// and 1/4, as the plain version scales them): the colour chain and
// encode_gain. kLut reads the sRGB and HDR inverse OETFs from tables
// (srgb in shared memory, inv_lut through the read-only path), else they
// are computed with pow_exact on the CTA's tables `pt`.
template <bool kLut>
__device__ __forceinline__ int gain_code(Boxes x, const GainParams& p,
                                         const float* srgb,
                                         const float* __restrict__ inv_lut,
                                         const uhdr::PowTables& pt) {
  x.sy *= 0.0625f;
  x.hy *= 0.0625f;
  x.su *= 0.25f;
  x.sv *= 0.25f;
  x.hu *= 0.25f;
  x.hv *= 0.25f;
  auto srgb_inv = [&](float e) -> float {
    if constexpr (kLut) return srgb[uhdr::lut_index(e, kSrgbLutN)];
    return uhdr::srgb_inv_oetf_exact(e, pt);
  };
  auto hdr_inv = [&](float e) -> float {
    if constexpr (kLut)
      if (p.tf != uhdr::kLinear)
        return __ldg(inv_lut + uhdr::lut_index(e, kInvLutN));
    return uhdr::hdr_inv_oetf(e, p.tf, pt);
  };
  float r, g, bl;
  p.sdr_rgb(x.sy, x.su, x.sv, &r, &g, &bl);
  float sdr_nits = uhdr::luminance(p.lum_r, p.lum_g, p.lum_b, srgb_inv(r),
                                   srgb_inv(g), srgb_inv(bl)) *
                   203.0f;
  p.hdr_rgb(x.hy, x.hu, x.hv, &r, &g, &bl);
  r = hdr_inv(r);
  g = hdr_inv(g);
  bl = hdr_inv(bl);
  if (p.gamut) {  // ops/color.py:apply_matrix3
    float r2 = uhdr::dot3(p.gm, r, g, bl);
    float g2 = uhdr::dot3(p.gm + 3, r, g, bl);
    bl = uhdr::dot3(p.gm + 6, r, g, bl);
    r = r2;
    g = g2;
  }
  float hdr_nits =
      uhdr::luminance(p.lum_r, p.lum_g, p.lum_b, r, g, bl) * p.hdr_white;

  // encode_gain (gainmapmath.cpp:529-541).
  float gain = sdr_nits > 0.0f ? hdr_nits / fmaxf(sdr_nits, (float)1e-30)
                               : 1.0f;
  float clipped = fminf(fmaxf(gain, p.min_b), p.max_b);
  float scaled = (log2f(clipped) - p.log2_min) * p.inv_denom * 255.0f;
  int code = sat_u8(scaled);
  if (gain >= p.max_b) code = p.sat_code;
  if (gain <= p.min_b) code = p.floor_code;
  return code;
}

__device__ __forceinline__ uint8_t to_u8(float x, float bias) {
  return (uint8_t)sat_u8(fmaf(x, 255.0f, bias));
}

// The BT.601 re-encode of one chroma sample and its 2x2 luma quad
// (transformYuv420, gainmapmath.cpp:483-520): the luma shift comes from
// the shared chroma, chroma from chroma alone; the identity when the
// re-encode is off (a P3 SDR). `luma` holds the quad's four bytes
// (row-major), rewritten in place.
__device__ __forceinline__ void reencode(const ConvertParams& m, int u8,
                                         int v8, int (&luma)[4],
                                         uint8_t& uo, uint8_t& vo) {
  if (!m.enabled) {
    uo = (uint8_t)u8;
    vo = (uint8_t)v8;
    return;
  }
  float u = ((float)u8 - 128.0f) * kInv255;
  float v = ((float)v8 - 128.0f) * kInv255;
  float y_shift = uhdr::dot2(m.m01, u, m.m02, v);
  uo = to_u8(uhdr::dot2(m.m11, u, m.m12, v), 128.5f);
  vo = to_u8(uhdr::dot2(m.m21, u, m.m22, v), 128.5f);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    luma[k] = to_u8((float)luma[k] * kInv255 + y_shift, 0.5f);
}

// Halfword k of a row held two u16 samples a word.
template <int N>
__device__ __forceinline__ int u16_of(const unsigned (&r)[N], int k) {
  return (int)((r[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
}

// Byte k of a row held four bytes a word.
template <int N>
__device__ __forceinline__ int u8_of(const unsigned (&r)[N], int k) {
  return (int)((r[k >> 2] >> (8 * (k & 3))) & 0xFFu);
}

// kBytes (4, 8 or 16) bytes from p into words, one vector load.
template <int kBytes>
__device__ __forceinline__ void load_row(unsigned (&r)[kBytes / 4],
                                         const void* p) {
  if constexpr (kBytes == 16) {
    uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else if constexpr (kBytes == 8) {
    uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = q.x, r[1] = q.y;
  } else {
    r[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// kBytes (2, 4 or 8) bytes, lo's first, to p, one store.
template <int kBytes>
__device__ __forceinline__ void store_row(uint8_t* p, unsigned lo,
                                          unsigned hi = 0u) {
  if constexpr (kBytes == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  else if constexpr (kBytes == 4)
    *reinterpret_cast<unsigned*>(p) = lo;
  else
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)lo;
}

// B1 (API-0) and B9 (kPlanes, API-1): one thread per 8 x 4 luma tile of
// a 16-aligned frame (two gain-map boxes and their 4 x 2 chroma
// samples), flat over (frame, tile row, tile column): the tile's gain
// codes, its BT.601 luma and its chroma.
template <bool kPlanes>
__global__ void __launch_bounds__(kFrontThreads)
front_kernel(const uint16_t* __restrict__ y, const uint16_t* __restrict__ uv,
             const SdrPlanes sdr, uint8_t* __restrict__ gmap,
             uint8_t* __restrict__ y601, uint8_t* __restrict__ u601,
             uint8_t* __restrict__ v601, int n, int h, int w,
             const GainParams p, const ConvertParams m) {
  constexpr int kCols = 8, kBoxes = 2, kC = 4;  // luma, boxes, chroma
  __shared__ uhdr::PowTables pt;
  uhdr::load_pow_tables(&pt);
  __syncthreads();
  int tw = w / kCols, th = h / 4;
  long long i = (long long)blockIdx.x * kFrontThreads + threadIdx.x;
  if (i >= (long long)n * th * tw) return;
  int tx = (int)(i % tw);
  long long rest = i / tw;
  int ty = (int)(rest % th), b = (int)(rest / th);
  size_t lrow = ((size_t)b * h + 4 * ty) * w + kCols * tx;  // luma
  size_t crow = ((size_t)b * (h / 2) + 2 * ty) * w + kCols * tx;  // CbCr
  size_t prow = ((size_t)b * (h / 2) + 2 * ty) * (w / 2) + kC * tx;  // U, V

  // Rows of u16 samples two a word, of SDR bytes four a word.
  unsigned yq[4][kC], cq[2][kC], sq[4][kCols / 4], su8[2][1], sv8[2][1];
#pragma unroll
  for (int r = 0; r < 4; ++r) load_row<2 * kCols>(yq[r], y + lrow + r * w);
#pragma unroll
  for (int r = 0; r < 2; ++r) load_row<2 * kCols>(cq[r], uv + crow + r * w);
  if (kPlanes) {
#pragma unroll
    for (int r = 0; r < 4; ++r) load_row<kCols>(sq[r], sdr.y + lrow + r * w);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      load_row<kC>(su8[r], sdr.u + prow + (size_t)r * (w / 2));
      load_row<kC>(sv8[r], sdr.v + prow + (size_t)r * (w / 2));
    }
  }
  // The SDR bytes: the SDR planes, or the top 8 bits of the samples.
  auto sdr_y = [&](int r, int c) -> int {
    return kPlanes ? u8_of(sq[r], c) : u16_of(yq[r], c) >> 8;
  };
  auto sdr_u = [&](int r, int c) -> int {
    return kPlanes ? u8_of(su8[r], c) : u16_of(cq[r], 2 * c) >> 8;
  };
  auto sdr_v = [&](int r, int c) -> int {
    return kPlanes ? u8_of(sv8[r], c) : u16_of(cq[r], 2 * c + 1) >> 8;
  };

  unsigned codes = 0u;
#pragma unroll
  for (int s = 0; s < kBoxes; ++s) {
    Boxes x{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 4 * s; c < 4 * s + 4; ++c)
        add_luma(x, sdr_y(r, c), u16_of(yq[r], c));
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 2 * s; c < 2 * s + 2; ++c)
        add_chroma(x, sdr_u(r, c), sdr_v(r, c), u16_of(cq[r], 2 * c),
                   u16_of(cq[r], 2 * c + 1));
    codes |= (unsigned)gain_code<false>(x, p, nullptr, nullptr, pt)
             << (8 * s);
  }
  store_row<kBoxes>(gmap + ((size_t)b * th + ty) * (w / 4) + kBoxes * tx,
                    codes);

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // chroma row r: luma rows 2r, 2r + 1
    unsigned lo[2] = {0u, 0u}, hi[2] = {0u, 0u}, uo = 0u, vo = 0u;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      int q[4] = {sdr_y(2 * r, 2 * c), sdr_y(2 * r, 2 * c + 1),
                  sdr_y(2 * r + 1, 2 * c), sdr_y(2 * r + 1, 2 * c + 1)};
      uint8_t ub, vb;
      reencode(m, sdr_u(r, c), sdr_v(r, c), q, ub, vb);
      uo |= (unsigned)ub << (8 * c);
      vo |= (unsigned)vb << (8 * c);
      int sh = 16 * (c & 1);
      lo[c >> 1] |= (unsigned)(q[0] | q[1] << 8) << sh;
      hi[c >> 1] |= (unsigned)(q[2] | q[3] << 8) << sh;
    }
    size_t o = lrow + (size_t)(2 * r) * w;
    store_row<kCols>(y601 + o, lo[0], lo[1]);
    store_row<kCols>(y601 + o + w, hi[0], hi[1]);
    store_row<kC>(u601 + prow + (size_t)r * (w / 2), uo);
    store_row<kC>(v601 + prow + (size_t)r * (w / 2), vo);
  }
}

// B10b: one thread per gain-map sample of SDR u8 planes against P010
// samples, for any even frame size (box remainders cropped). kLut
// (use_luts, gainmap.py:107-112): the sRGB inverse OETF and the HLG /
// PQ inverse OETF are read from ops/color.py's tables, as B11 reads its
// tables: the 4 KB sRGB table is copied into each CTA's shared memory;
// the 16 KB inverse-OETF table (unused for a linear HDR) is read
// through the read-only path (__ldg) and stays in L1 / L2. Without
// kLut, the CTA stages pow_exact's tables instead.
template <bool kLut>
__global__ void gain_kernel(const uint16_t* __restrict__ y,
                            const uint16_t* __restrict__ uv,
                            const SdrPlanes sdr, uint8_t* __restrict__ gmap,
                            int h, int w, const GainParams p,
                            const float* __restrict__ srgb_lut,
                            const float* __restrict__ inv_lut) {
  int mw = w / 4, mh = h / 4;
  int mx = blockIdx.x * blockDim.x + threadIdx.x;
  int my = blockIdx.y;
  int b = blockIdx.z;
  __shared__ float srgb[kLut ? kSrgbLutN : 1];
  __shared__ uhdr::PowTables pt;
  if (kLut) {
    for (int i = threadIdx.x; i < kSrgbLutN; i += blockDim.x)
      srgb[i] = srgb_lut[i];
  } else {
    uhdr::load_pow_tables(&pt);
  }
  __syncthreads();
  if (mx >= mw) return;
  const uint16_t* yb = y + (size_t)b * h * w;
  const uint16_t* uvb = uv + (size_t)b * (h / 2) * w;

  Boxes x{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    size_t i = (size_t)(my * 4 + dy) * w + mx * 4;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx)
      add_luma(x, sdr.y[(size_t)b * h * w + i + dx], yb[i + dx]);
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    // Interleaved CbCr: chroma samples 2mx, 2mx+1 are u16 pairs at
    // columns 4mx .. 4mx+3 of the uv plane.
    const uint16_t* row = uvb + (size_t)(my * 2 + dy) * w + mx * 4;
    size_t ci = ((size_t)b * (h / 2) + my * 2 + dy) * (w / 2) + mx * 2;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
      add_chroma(x, sdr.u[ci + dx], sdr.v[ci + dx], row[2 * dx],
                 row[2 * dx + 1]);
  }
  gmap[((size_t)b * mh + my) * mw + mx] =
      (uint8_t)gain_code<kLut>(x, p, srgb, inv_lut, pt);
}

// B10c: one thread per chroma sample of u8 planes of an even-sized
// frame: the sample and its 2x2 luma quad re-encoded (reencode).
__global__ void convert_kernel(const SdrPlanes in, uint8_t* __restrict__ yo,
                               uint8_t* __restrict__ uo,
                               uint8_t* __restrict__ vo, int h, int w,
                               const ConvertParams m) {
  int cw = w / 2, ch = h / 2;
  int cx = blockIdx.x * blockDim.x + threadIdx.x;
  int cy = blockIdx.y;
  int b = blockIdx.z;
  if (cx >= cw) return;
  size_t ci = ((size_t)b * ch + cy) * cw + cx;
  size_t i0 = ((size_t)b * h + 2 * cy) * w + 2 * cx;
  int q[4] = {in.y[i0], in.y[i0 + 1], in.y[i0 + w], in.y[i0 + w + 1]};
  reencode(m, in.u[ci], in.v[ci], q, uo[ci], vo[ci]);
  yo[i0] = (uint8_t)q[0];
  yo[i0 + 1] = (uint8_t)q[1];
  yo[i0 + w] = (uint8_t)q[2];
  yo[i0 + w + 1] = (uint8_t)q[3];
}

template <bool kPlanes>
int launch(const void* y, const void* uv, SdrPlanes sdr, void* gmap,
           void* y601, void* u601, void* v601, int n, int h, int w,
           const GainParams& p, const ConvertParams& m, void* stream) {
  long long tiles = (long long)n * (h / 4) * (w / 8);
  front_kernel<kPlanes>
      <<<(unsigned)((tiles + kFrontThreads - 1) / kFrontThreads),
         kFrontThreads, 0, (cudaStream_t)stream>>>(
          (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap,
          (uint8_t*)y601, (uint8_t*)u601, (uint8_t*)v601, n, h, w, p, m);
  return (int)cudaGetLastError();
}

// B10a: the tonemap alone, one streaming pass. Threads [0, ny4) each
// turn four luma samples (one 8-byte load) into four bytes; the next nc
// threads each split one interleaved CbCr pair (one 4-byte load).
__global__ void tonemap_kernel(const ushort4* __restrict__ y,
                               const ushort2* __restrict__ uv,
                               uchar4* __restrict__ y8,
                               uint8_t* __restrict__ u8,
                               uint8_t* __restrict__ v8, long long ny4,
                               long long nc) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ny4) {
    ushort4 s = y[i];
    y8[i] = make_uchar4(s.x >> 8, s.y >> 8, s.z >> 8, s.w >> 8);
  } else if ((i -= ny4) < nc) {
    ushort2 c = uv[i];
    u8[i] = (uint8_t)(c.x >> 8);
    v8[i] = (uint8_t)(c.y >> 8);
  }
}

// The float and int parameter arrays of the API-1 and generate entry
// points: fp[0:4] SDR and fp[4:8] HDR (cr, cb, gcb, gcr), fp[8:11]
// luminance weights, fp[11] HDR white, fp[12:16] (min_b, max_b,
// log2_min, inv_denom), fp[16:25] the gamut matrix, fp[25:31] (m01,
// m02, m11, m12, m21, m22); ip = (tf, gamut, convert, sat_code,
// floor_code).
GainParams unpack_gain(const float* fp, const int* ip) {
  GainParams p{{fp[0], fp[1], fp[2], fp[3]}, {fp[4], fp[5], fp[6], fp[7]},
               fp[8], fp[9], fp[10], ip[0], fp[11], fp[12], fp[13], fp[14],
               fp[15], ip[3], ip[4], ip[1], {}};
  for (int i = 0; i < 9; ++i) p.gm[i] = fp[16 + i];
  return p;
}

ConvertParams unpack_convert(int enabled, const float* m) {
  return ConvertParams{enabled, m[0], m[1], m[2], m[3], m[4], m[5]};
}

}  // namespace

extern "C" {

// y: (n, h, w) and uv: (n, h/2, w) u16 P010 samples (16-aligned h, w);
// gmap: (n, h/4, w/4), y601: (n, h, w), u601/v601: (n, h/2, w/2) u8.
int uhdr_encode_front(const void* y, const void* uv, void* gmap,
                      void* y601, void* u601, void* v601, int n, int h,
                      int w, float cr, float cb, float gcb, float gcr,
                      float lum_r, float lum_g, float lum_b, float hdr_white,
                      int tf, int convert, float min_b, float max_b,
                      float log2_min, float inv_denom, float m01, float m02,
                      float m11, float m12, float m21, float m22,
                      int sat_code, int floor_code, void* stream) {
  GainParams p{{cr, cb, gcb, gcr}, {cr, cb, gcb, gcr}, lum_r, lum_g, lum_b,
               tf, hdr_white, min_b, max_b, log2_min, inv_denom, sat_code,
               floor_code, 0, {}};
  ConvertParams m{convert, m01, m02, m11, m12, m21, m22};
  return launch<false>(y, uv, SdrPlanes{nullptr, nullptr, nullptr}, gmap,
                       y601, u601, v601, n, h, w, p, m, stream);
}

// As uhdr_encode_front, with the SDR frame as u8 planes sy (n, h, w),
// su/sv (n, h/2, w/2). The parameters come in host arrays (unpack_gain).
int uhdr_encode_front_api1(const void* y, const void* uv, const void* sy,
                           const void* su, const void* sv, void* gmap,
                           void* y601, void* u601, void* v601, int n, int h,
                           int w, const float* fp, const int* ip,
                           void* stream) {
  SdrPlanes sdr{(const uint8_t*)sy, (const uint8_t*)su, (const uint8_t*)sv};
  return launch<true>(y, uv, sdr, gmap, y601, u601, v601, n, h, w,
                      unpack_gain(fp, ip), unpack_convert(ip[2], fp + 25),
                      stream);
}

// B10a: y (n, h, w) and uv (n, h/2, w) u16 P010 samples of an even-sized
// frame -> y8 (n, h, w), u8/v8 (n, h/2, w/2).
int uhdr_tonemap_p010(const void* y, const void* uv, void* y8, void* u8,
                      void* v8, int n, int h, int w, void* stream) {
  long long ny4 = (long long)n * h * w / 4;
  long long nc = (long long)n * (h / 2) * (w / 2);
  long long blocks = (ny4 + nc + 255) / 256;
  tonemap_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const ushort4*)y, (const ushort2*)uv, (uchar4*)y8, (uint8_t*)u8,
      (uint8_t*)v8, ny4, nc);
  return (int)cudaGetLastError();
}

// B10b: the gain map (n, h/4, w/4) of SDR u8 planes sy (n, h, w), su/sv
// (n, h/2, w/2) against P010 y, uv, for any even h, w (box remainders
// cropped). fp/ip as unpack_gain reads them (the convert fields unused);
// the SDR matrix is BT.601's for sdr_is_601, which is a choice of
// fp[0:4]. With srgb_lut (1,024 f32 entries) the kLut arm runs, reading
// inv_lut (4,096 entries) for an HLG or PQ HDR.
int uhdr_generate_gainmap(const void* sy, const void* su, const void* sv,
                          const void* y, const void* uv, void* gmap, int n,
                          int h, int w, const float* fp, const int* ip,
                          const void* srgb_lut, const void* inv_lut,
                          void* stream) {
  SdrPlanes sdr{(const uint8_t*)sy, (const uint8_t*)su, (const uint8_t*)sv};
  GainParams p = unpack_gain(fp, ip);
  dim3 grid((w / 4 + 127) / 128, h / 4, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (srgb_lut)
    gain_kernel<true><<<grid, 128, 0, s>>>(
        (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap, h, w,
        p, (const float*)srgb_lut, (const float*)inv_lut);
  else
    gain_kernel<false><<<grid, 128, 0, s>>>(
        (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap, h, w,
        p, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// B10c: u8 planes y (n, h, w), u/v (n, h/2, w/2) of an even-sized frame
// re-encoded with the matrix m (host, m01, m02, m11, m12, m21, m22) into
// yo, uo, vo: front_kernel's re-encode as a launch of its own.
int uhdr_convert_yuv(const void* y, const void* u, const void* v, void* yo,
                     void* uo, void* vo, int n, int h, int w,
                     const float* m, void* stream) {
  SdrPlanes in{(const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v};
  dim3 grid((w / 2 + 127) / 128, h / 2, n);
  convert_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      in, (uint8_t*)yo, (uint8_t*)uo, (uint8_t*)vo, h, w,
      unpack_convert(1, m));
  return (int)cudaGetLastError();
}

}  // extern "C"
