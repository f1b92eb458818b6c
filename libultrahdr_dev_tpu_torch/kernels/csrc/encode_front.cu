// B1: API-0 encode front end for the port's ops/gainmap.py.
//
// Replaces libultrahdr_dev_tpu/parallel/sharding.py:_gainmap_and_coefs
// (the part before the fDCT) with _encode_one_image_coefs' tonemap, and
// the ops/gainmap.py helpers it runs: p010_to_float, yuv420_to_float,
// _box_mean, _convert_yuv_kernel, and ops/color.py:encode_gain.
//
// Bound: DRAM reads of the P010 frame (24 MB for 4080x3072, plus 19 MB
// of u8 output). Two launches, each one streaming pass:
//  (a) one thread per gain-map sample sums its 4x4 luma box and 2x2
//      chroma box of the u16 input, as SDR codes (u16 >> 8) and as
//      10-bit HDR codes (u16 >> 6), in integers, then runs the colour
//      chain and writes one u8 gain code;
//  (b) one thread per 2x2 luma quad (one chroma sample) writes the
//      tonemapped base re-encoded to BT.601 YUV (gainmap.py:434-448);
//      for the P3 gamut the re-encode is the identity.
// The (a) threads re-read luma that (b) also reads; both passes stay
// within L2-friendly row bands, and a fused single pass is later work.
//
// Numerics: the box sums are exact integers scaled once, where the JAX
// version converts each sample to float and sums the floats
// (_box_mean). The two differ by float32 rounding in the last bits of
// the box means, which can move a gain code by 1 where the log-ratio
// sits on a code boundary; the chip check allows that on <= 1e-4 of
// samples. The boundary codes of encode_gain (saturate at 254) come in
// from the host, computed in float64 as ops/color.py does.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

struct GainParams {
  uhdr::YuvToRgb to_rgb;  // the gamut's own YUV matrix (SDR and HDR)
  float lum_r, lum_g, lum_b;
  int tf;
  float hdr_white;
  float min_b, max_b, log2_min, inv_denom;
  int sat_code, floor_code;
};

struct ConvertParams {
  int enabled;
  float m01, m02, m11, m12, m21, m22;
};

__device__ __forceinline__ float luminance(const GainParams& p, float r,
                                           float g, float b) {
  return uhdr::luminance(p.lum_r, p.lum_g, p.lum_b, r, g, b);
}

__global__ void gain_kernel(const uint16_t* __restrict__ y,
                            const uint16_t* __restrict__ uv,
                            uint8_t* __restrict__ gmap, int h, int w,
                            const GainParams p) {
  int mw = w / 4, mh = h / 4;
  int mx = blockIdx.x * blockDim.x + threadIdx.x;
  int my = blockIdx.y;
  int b = blockIdx.z;
  if (mx >= mw) return;
  const uint16_t* yb = y + (size_t)b * h * w;
  const uint16_t* uvb = uv + (size_t)b * (h / 2) * w;

  int sy8 = 0, sy10 = 0;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const uint16_t* row = yb + (size_t)(my * 4 + dy) * w + mx * 4;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      sy8 += row[dx] >> 8;
      sy10 += row[dx] >> 6;
    }
  }
  int su8 = 0, sv8 = 0, su10 = 0, sv10 = 0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    // Interleaved CbCr: chroma samples 2mx, 2mx+1 are u16 pairs at
    // columns 4mx .. 4mx+3 of the uv plane.
    const uint16_t* row = uvb + (size_t)(my * 2 + dy) * w + mx * 4;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      su8 += row[2 * dx] >> 8;
      sv8 += row[2 * dx + 1] >> 8;
      su10 += row[2 * dx] >> 6;
      sv10 += row[2 * dx + 1] >> 6;
    }
  }

  // Box means of the normalized signals (yuv420_to_float,
  // p010_to_float).
  const float inv255 = (float)(1.0 / 255.0);
  float sy = ((float)sy8 * inv255) * 0.0625f;
  float su = ((float)(su8 - 4 * 128) * inv255) * 0.25f;
  float sv = ((float)(sv8 - 4 * 128) * inv255) * 0.25f;
  float hy = ((float)(sy10 - 16 * 64) * (float)(1.0 / 876.0)) * 0.0625f;
  const float inv896 = (float)(1.0 / 896.0);
  float hu = fmaf((float)(su10 - 4 * 64) * inv896, 0.25f, -0.5f);
  float hv = fmaf((float)(sv10 - 4 * 64) * inv896, 0.25f, -0.5f);

  float r, g, bl;
  p.to_rgb(sy, su, sv, &r, &g, &bl);
  float sdr_nits = luminance(p, uhdr::srgb_inv_oetf(r),
                             uhdr::srgb_inv_oetf(g),
                             uhdr::srgb_inv_oetf(bl)) *
                   203.0f;
  p.to_rgb(hy, hu, hv, &r, &g, &bl);
  float hdr_nits = luminance(p, uhdr::hdr_inv_oetf(r, p.tf),
                             uhdr::hdr_inv_oetf(g, p.tf),
                             uhdr::hdr_inv_oetf(bl, p.tf)) *
                   p.hdr_white;

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

__global__ void base_kernel(const uint16_t* __restrict__ y,
                            const uint16_t* __restrict__ uv,
                            uint8_t* __restrict__ y601,
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
  int u8 = uvrow[2 * cx] >> 8, v8 = uvrow[2 * cx + 1] >> 8;
  const uint16_t* yb = y + (size_t)b * h * w;
  uint8_t* yo = y601 + (size_t)b * h * w;
  if (!m.enabled) {
    u601[ci] = (uint8_t)u8;
    v601[ci] = (uint8_t)v8;
    for (int dy = 0; dy < 2; ++dy)
      for (int dx = 0; dx < 2; ++dx) {
        size_t i = (size_t)(2 * cy + dy) * w + 2 * cx + dx;
        yo[i] = (uint8_t)(yb[i] >> 8);
      }
    return;
  }
  // transformYuv420 (gainmapmath.cpp:483-520): the luma shift comes
  // from the shared chroma; chroma from chroma alone.
  const float inv255 = (float)(1.0 / 255.0);
  float u = ((float)u8 - 128.0f) * inv255;
  float v = ((float)v8 - 128.0f) * inv255;
  float y_shift = fmaf(m.m01, u, m.m02 * v);
  u601[ci] = to_u8(fmaf(m.m11, u, m.m12 * v), 128.5f);
  v601[ci] = to_u8(fmaf(m.m21, u, m.m22 * v), 128.5f);
  for (int dy = 0; dy < 2; ++dy)
    for (int dx = 0; dx < 2; ++dx) {
      size_t i = (size_t)(2 * cy + dy) * w + 2 * cx + dx;
      float yf = (float)(yb[i] >> 8) * inv255;
      yo[i] = to_u8(yf + y_shift, 0.5f);
    }
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
  GainParams p{{cr, cb, gcb, gcr}, lum_r, lum_g, lum_b, tf, hdr_white,
               min_b, max_b, log2_min, inv_denom, sat_code, floor_code};
  ConvertParams m{convert, m01, m02, m11, m12, m21, m22};
  cudaStream_t s = (cudaStream_t)stream;
  dim3 ggrid((w / 4 + 127) / 128, h / 4, n);
  gain_kernel<<<ggrid, 128, 0, s>>>((const uint16_t*)y,
                                    (const uint16_t*)uv, (uint8_t*)gmap, h,
                                    w, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 bgrid((w / 2 + 127) / 128, h / 2, n);
  base_kernel<<<bgrid, 128, 0, s>>>((const uint16_t*)y, (const uint16_t*)uv,
                                    (uint8_t*)y601, (uint8_t*)u601,
                                    (uint8_t*)v601, h, w, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
