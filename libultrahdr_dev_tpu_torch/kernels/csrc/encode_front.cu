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
// ops/gainmap.py:_convert_yuv_kernel, as base_kernel's re-encode over
// u8 planes.
//
// Bound: DRAM traffic; every launch is one streaming pass. B1 reads the
// P010 frame (24 MB for 4080x3072) and writes 19 MB of u8 output; API-1
// also reads the 19 MB SDR frame. B1 and B9 are two launches per call:
//  (a) one thread per gain-map sample sums its 4x4 luma box and 2x2
//      chroma box, of SDR codes (u16 >> 8, or the SDR planes) and of
//      10-bit HDR codes (u16 >> 6), each normalized to float, then runs
//      the colour chain and writes one u8 gain code;
//  (b) one thread per 2x2 luma quad (one chroma sample) writes the SDR
//      re-encoded to BT.601 YUV (gainmap.py:434-448); for a P3 SDR the
//      re-encode is the identity.
// The (a) threads re-read luma that (b) also reads; both passes stay
// within L2-friendly row bands, and a fused single pass is later work.
// B10b is (a) alone, B10c is (b) alone, and B10a is a copy that narrows
// 8-byte loads of P010 to bytes; apart, the three read the SDR planes
// twice and write and re-read the tonemapped frame, which B1 does not.
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

// The SDR input of the kernels' kPlanes variant (API-1): its own u8
// planes. Without kPlanes (API-0) the SDR is the top 8 bits of the P010
// samples, API-0's tonemap, and these pointers are unused.
struct SdrPlanes {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
};

// Table sizes of the kLut arm (ops/color.py SRGB_INV_OETF_NUM_ENTRIES,
// HLG_INV_OETF_NUM_ENTRIES = PQ_INV_OETF_NUM_ENTRIES).
constexpr int kSrgbLutN = 1 << 10;
constexpr int kInvLutN = 1 << 12;

// kLut (B10b's use_luts arm, gainmap.py:107-112): the sRGB inverse OETF
// and the HLG / PQ inverse OETF are read from ops/color.py's tables, as
// B11 reads its tables: the 4 KB sRGB table is copied into each CTA's
// shared memory; the 16 KB inverse-OETF table (unused for a linear HDR)
// is read through the read-only path (__ldg) and stays in L1 / L2.
template <bool kPlanes, bool kLut>
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
  if (kLut) {
    for (int i = threadIdx.x; i < kSrgbLutN; i += blockDim.x)
      srgb[i] = srgb_lut[i];
    __syncthreads();
  }
  if (mx >= mw) return;
  const uint16_t* yb = y + (size_t)b * h * w;
  const uint16_t* uvb = uv + (size_t)b * (h / 2) * w;

  // Box means of the normalized signals (yuv420_to_float,
  // p010_to_float, _box_mean): each sample normalized, the box summed
  // in float32 row-major from 0, then scaled by 1/16 or 1/4, as the
  // plain version (and XLA's reduce_window) sums it.
  const float inv255 = (float)(1.0 / 255.0);
  const float inv876 = (float)(1.0 / 876.0);
  const float inv896 = (float)(1.0 / 896.0);
  float sy = 0.0f, hy = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    size_t i = (size_t)(my * 4 + dy) * w + mx * 4;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      int s8 = kPlanes ? sdr.y[(size_t)b * h * w + i + dx] : yb[i + dx] >> 8;
      sy = sy + (float)s8 * inv255;
      hy = hy + (float)((yb[i + dx] >> 6) - 64) * inv876;
    }
  }
  float su = 0.0f, sv = 0.0f, hu = 0.0f, hv = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    // Interleaved CbCr: chroma samples 2mx, 2mx+1 are u16 pairs at
    // columns 4mx .. 4mx+3 of the uv plane.
    const uint16_t* row = uvb + (size_t)(my * 2 + dy) * w + mx * 4;
    size_t ci = ((size_t)b * (h / 2) + my * 2 + dy) * (w / 2) + mx * 2;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int u8 = kPlanes ? sdr.u[ci + dx] : row[2 * dx] >> 8;
      int v8 = kPlanes ? sdr.v[ci + dx] : row[2 * dx + 1] >> 8;
      su = su + ((float)u8 - 128.0f) * inv255;
      sv = sv + ((float)v8 - 128.0f) * inv255;
      hu = hu + fmaf((float)((row[2 * dx] >> 6) - 64), inv896, -0.5f);
      hv = hv + fmaf((float)((row[2 * dx + 1] >> 6) - 64), inv896, -0.5f);
    }
  }
  sy *= 0.0625f;
  hy *= 0.0625f;
  su *= 0.25f;
  sv *= 0.25f;
  hu *= 0.25f;
  hv *= 0.25f;

  auto srgb_inv = [&](float e) -> float {
    if constexpr (kLut) return srgb[uhdr::lut_index(e, kSrgbLutN)];
    return uhdr::srgb_inv_oetf(e);
  };
  auto hdr_inv = [&](float e) -> float {
    if constexpr (kLut)
      if (p.tf != uhdr::kLinear)
        return __ldg(inv_lut + uhdr::lut_index(e, kInvLutN));
    return uhdr::hdr_inv_oetf(e, p.tf);
  };
  float r, g, bl;
  p.sdr_rgb(sy, su, sv, &r, &g, &bl);
  float sdr_nits = uhdr::luminance(p.lum_r, p.lum_g, p.lum_b, srgb_inv(r),
                                   srgb_inv(g), srgb_inv(bl)) *
                   203.0f;
  p.hdr_rgb(hy, hu, hv, &r, &g, &bl);
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
  int code = (int)fminf(fmaxf(scaled, 0.0f), 255.0f);
  if (gain >= p.max_b) code = p.sat_code;
  if (gain <= p.min_b) code = p.floor_code;
  gmap[((size_t)b * mh + my) * mw + mx] = (uint8_t)code;
}

__device__ __forceinline__ uint8_t to_u8(float x, float bias) {
  return (uint8_t)fminf(fmaxf(fmaf(x, 255.0f, bias), 0.0f), 255.0f);
}

template <bool kPlanes>
__global__ void base_kernel(const uint16_t* __restrict__ y,
                            const uint16_t* __restrict__ uv,
                            const SdrPlanes sdr, uint8_t* __restrict__ y601,
                            uint8_t* __restrict__ u601,
                            uint8_t* __restrict__ v601, int h, int w,
                            const ConvertParams m) {
  int cw = w / 2, ch = h / 2;
  int cx = blockIdx.x * blockDim.x + threadIdx.x;
  int cy = blockIdx.y;
  int b = blockIdx.z;
  if (cx >= cw) return;
  size_t ci = ((size_t)b * ch + cy) * cw + cx;
  const uint16_t* uvrow = uv + ((size_t)b * ch + cy) * w;
  int u8 = kPlanes ? sdr.u[ci] : uvrow[2 * cx] >> 8;
  int v8 = kPlanes ? sdr.v[ci] : uvrow[2 * cx + 1] >> 8;
  size_t base = (size_t)b * h * w;
  uint8_t* yo = y601 + base;
  auto luma = [&](size_t i) -> int {
    return kPlanes ? sdr.y[base + i] : y[base + i] >> 8;
  };
  if (!m.enabled) {
    u601[ci] = (uint8_t)u8;
    v601[ci] = (uint8_t)v8;
    for (int dy = 0; dy < 2; ++dy)
      for (int dx = 0; dx < 2; ++dx) {
        size_t i = (size_t)(2 * cy + dy) * w + 2 * cx + dx;
        yo[i] = (uint8_t)luma(i);
      }
    return;
  }
  // transformYuv420 (gainmapmath.cpp:483-520): the luma shift comes
  // from the shared chroma; chroma from chroma alone.
  const float inv255 = (float)(1.0 / 255.0);
  float u = ((float)u8 - 128.0f) * inv255;
  float v = ((float)v8 - 128.0f) * inv255;
  float y_shift = uhdr::dot2(m.m01, u, m.m02, v);
  u601[ci] = to_u8(uhdr::dot2(m.m11, u, m.m12, v), 128.5f);
  v601[ci] = to_u8(uhdr::dot2(m.m21, u, m.m22, v), 128.5f);
  for (int dy = 0; dy < 2; ++dy)
    for (int dx = 0; dx < 2; ++dx) {
      size_t i = (size_t)(2 * cy + dy) * w + 2 * cx + dx;
      float yf = (float)luma(i) * inv255;
      yo[i] = to_u8(yf + y_shift, 0.5f);
    }
}

template <bool kPlanes>
int launch(const void* y, const void* uv, SdrPlanes sdr, void* gmap,
           void* y601, void* u601, void* v601, int n, int h, int w,
           const GainParams& p, const ConvertParams& m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 ggrid((w / 4 + 127) / 128, h / 4, n);
  gain_kernel<kPlanes, false><<<ggrid, 128, 0, s>>>(
      (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap, h, w,
      p, nullptr, nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 bgrid((w / 2 + 127) / 128, h / 2, n);
  base_kernel<kPlanes><<<bgrid, 128, 0, s>>>(
      (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)y601,
      (uint8_t*)u601, (uint8_t*)v601, h, w, m);
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
    gain_kernel<true, true><<<grid, 128, 0, s>>>(
        (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap, h, w,
        p, (const float*)srgb_lut, (const float*)inv_lut);
  else
    gain_kernel<true, false><<<grid, 128, 0, s>>>(
        (const uint16_t*)y, (const uint16_t*)uv, sdr, (uint8_t*)gmap, h, w,
        p, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// B10c: u8 planes y (n, h, w), u/v (n, h/2, w/2) of an even-sized frame
// re-encoded with the matrix m (host, m01, m02, m11, m12, m21, m22) into
// yo, uo, vo: base_kernel's re-encode as a launch of its own.
int uhdr_convert_yuv(const void* y, const void* u, const void* v, void* yo,
                     void* uo, void* vo, int n, int h, int w,
                     const float* m, void* stream) {
  SdrPlanes in{(const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v};
  dim3 grid((w / 2 + 127) / 128, h / 2, n);
  base_kernel<true><<<grid, 128, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, in, (uint8_t*)yo, (uint8_t*)uo, (uint8_t*)vo, h, w,
      unpack_convert(1, m));
  return (int)cudaGetLastError();
}

}  // extern "C"
