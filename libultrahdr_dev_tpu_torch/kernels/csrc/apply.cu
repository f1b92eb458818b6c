// B6 and B11: gain-map apply for the port's ops/gainmap.py.
//
// B6 replaces libultrahdr_dev_tpu/ops/gainmap.py:_apply_kernel (with
// _upsample2, _idw_upsample and ops/color.py srgb_inv_oetf, hlg_oetf,
// pq_oetf, pack_rgba1010102, pack_rgba_f16). B11 is the same kernel
// compiled with kLut: the use_luts=True arms of _apply_kernel
// (gainmap.py:297,323,326), which read the sRGB inverse OETF and the
// HLG / PQ OETF from ops/color.py's tables (_lut_lookup) instead of
// computing them; exp2 stays computed, as in the JAX apply. The 10-bit
// planar arm (kRgb10, gainmap.py:318-321) writes linear RGB as three
// (h, w) planes of clip(c, 0, 1) * 1023 truncated; it has no OETF, so in
// the kLut variant the tables change only the sRGB inverse.
//
// Bound: the output write. A 4080x3072 frame writes 100 MB of RGBA F16
// or 50 MB of RGBA1010102 and reads about 16 MB of u8 planes, so the
// kernel is one streaming pass: one thread per output pixel, a row of
// 256 pixels per CTA, so a warp reads 32 consecutive luma bytes and
// writes 256 (F16, one 8-byte store per thread) or 128 consecutive
// bytes. The 4:2:0 chroma sample, the four gain-map neighbours and their
// Shepard inverse-distance weights are computed in place from (x, y):
// no upsampled plane or weight table ever reaches device memory. The
// computed transfer functions (a double pow per channel for sRGB and
// PQ) make B6 bound by operations; B11 trades them for table reads. Its
// 4 KB sRGB table is copied into each CTA's shared memory; the 256 KB
// HLG / PQ tables exceed what an SM holds, so they are read through the
// read-only path (__ldg) and stay resident in L2.
//
// Numerics follow ops/gainmap.py:apply_gainmap_plain operation by
// operation, with its roundings (color.cuh): the edge cells take
// inc_r = inc_b = 0, the d1 == 0 cell takes the map sample itself,
// F16 rounds to nearest even (__float2half_rn), the table index is
// trunc(fma(x, n - 1, 0.5)) clamped to the table, and the 10-bit pack
// truncates after clamping, with alpha bits 0xC0000000.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

using uhdr::clamp01;
using uhdr::Plane;

enum Fmt : int { kF16 = 0, kHlgOut = 1, kPqOut = 2, kRgb10 = 3 };

// Table sizes (ops/color.py SRGB_INV_OETF_NUM_ENTRIES,
// HLG_OETF_NUM_ENTRIES = PQ_OETF_NUM_ENTRIES).
constexpr int kSrgbLutN = 1 << 10;
constexpr int kOetfLutN = 1 << 16;

__device__ __forceinline__ uint32_t pack10(float c) {
  return (uint32_t)(clamp01(c) * 1023.0f) & 0x3FFu;
}

template <bool kLut>
__global__ void apply_kernel(Plane yp, Plane up, Plane vp, Plane gp,
                             const float* __restrict__ scalars,
                             void* __restrict__ out, int h, int w, int mh,
                             int mw, int scale, int fmt,
                             const float* __restrict__ srgb_lut,
                             const float* __restrict__ oetf_lut) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  __shared__ float srgb[kLut ? kSrgbLutN : 1];
  if (kLut) {
    for (int i = threadIdx.x; i < kSrgbLutN; i += blockDim.x)
      srgb[i] = srgb_lut[i];
    __syncthreads();
  }
  if (x >= w) return;

  // BT.601 YUV -> RGB of the decoded base, sRGB linearized
  // (ultrahdr.cpp:437-445). Chroma: nearest 2x upsample.
  const float inv255 = (float)(1.0 / 255.0);
  float yf = (float)yp.at(b, y, x) * inv255;
  float uf = ((float)up.at(b, y >> 1, x >> 1) - 128.0f) * inv255;
  float vf = ((float)vp.at(b, y >> 1, x >> 1) - 128.0f) * inv255;
  const uhdr::YuvToRgb to_rgb{
      (float)1.402, (float)1.772, (float)(0.114 * 1.772 / 0.587),
      (float)(0.299 * 1.402 / 0.587)};
  float r, g, bl;
  to_rgb(yf, uf, vf, &r, &g, &bl);
  if (kLut) {
    r = srgb[uhdr::lut_index(r, kSrgbLutN)];
    g = srgb[uhdr::lut_index(g, kSrgbLutN)];
    bl = srgb[uhdr::lut_index(bl, kSrgbLutN)];
  } else {
    r = uhdr::srgb_inv_oetf(r);
    g = uhdr::srgb_inv_oetf(g);
    bl = uhdr::srgb_inv_oetf(bl);
  }

  // Shepard IDW over the 4 surrounding map samples
  // (gainmapmath.cpp:66-110, 686-720).
  int mx = x / scale, my = y / scale;
  int mx2 = min(mx + 1, mw - 1), my2 = min(my + 1, mh - 1);
  const float rcp255 = 1.0f / 255.0f, rcp_scale = 1.0f / (float)scale;
  float e1 = (float)gp.at(b, my, mx) * rcp255;
  float e2 = (float)gp.at(b, my2, mx) * rcp255;
  float e3 = (float)gp.at(b, my, mx2) * rcp255;
  float e4 = (float)gp.at(b, my2, mx2) * rcp255;
  float px = (float)(x % scale) * rcp_scale;
  float py = (float)(y % scale) * rcp_scale;
  float inc_r = mx >= mw - 1 ? 0.0f : 1.0f;
  float inc_b = my >= mh - 1 ? 0.0f : 1.0f;
  float dyb = py - inc_b, dxr = px - inc_r;
  float d1 = sqrtf(fmaf(px, px, py * py));
  float d2 = sqrtf(fmaf(px, px, dyb * dyb));
  float d3 = sqrtf(fmaf(dxr, dxr, py * py));
  float d4 = sqrtf(fmaf(dxr, dxr, dyb * dyb));
  const float eps = (float)1e-12;
  float w1 = 1.0f / fmaxf(d1, eps), w2 = 1.0f / fmaxf(d2, eps);
  float w3 = 1.0f / fmaxf(d3, eps), w4 = 1.0f / fmaxf(d4, eps);
  float total = w1 + w2 + w3 + w4;
  float gain =
      d1 <= 0.0f
          ? e1
          : fmaf(e4, w4, fmaf(e3, w3, fmaf(e1, w1, e2 * w2))) / total;

  const float* s = scalars + 4 * b;  // log2_min, log2_max, factor, disp
  float log_boost = fmaf(s[0], 1.0f - gain, s[1] * gain);
  float factor = exp2f(log_boost * s[2]) / s[3];
  r = r * factor;
  g = g * factor;
  bl = bl * factor;

  size_t pix = ((size_t)b * h + y) * w + x;
  if (fmt == kF16) {
    ushort4 v;
    v.x = __half_as_ushort(__float2half_rn(r));
    v.y = __half_as_ushort(__float2half_rn(g));
    v.z = __half_as_ushort(__float2half_rn(bl));
    v.w = 0x3C00;  // 1.0
    reinterpret_cast<ushort4*>(out)[pix] = v;
    return;
  }
  if (fmt == kRgb10) {  // (n, 3, h, w) planes, the three at h * w apart
    uint16_t* o = reinterpret_cast<uint16_t*>(out) +
                  ((size_t)b * 3 * h + y) * w + x;
    size_t plane = (size_t)h * w;
    o[0] = (uint16_t)(clamp01(r) * 1023.0f);
    o[plane] = (uint16_t)(clamp01(g) * 1023.0f);
    o[2 * plane] = (uint16_t)(clamp01(bl) * 1023.0f);
    return;
  }
  if (kLut) {  // the HLG or PQ OETF table, as fmt says
    r = __ldg(oetf_lut + uhdr::lut_index(r, kOetfLutN));
    g = __ldg(oetf_lut + uhdr::lut_index(g, kOetfLutN));
    bl = __ldg(oetf_lut + uhdr::lut_index(bl, kOetfLutN));
  } else if (fmt == kHlgOut) {
    r = uhdr::hlg_oetf(r);
    g = uhdr::hlg_oetf(g);
    bl = uhdr::hlg_oetf(bl);
  } else {
    r = uhdr::pq_oetf(r);
    g = uhdr::pq_oetf(g);
    bl = uhdr::pq_oetf(bl);
  }
  reinterpret_cast<uint32_t*>(out)[pix] =
      pack10(r) | (pack10(g) << 10) | (pack10(bl) << 20) | 0xC0000000u;
}

template <bool kLut>
int launch(const void* y, const void* u, const void* v, const void* g,
           long long ysb, long long ysr, long long usb, long long usr,
           long long vsb, long long vsr, long long gsb, long long gsr,
           const void* scalars, void* out, int n, int h, int w, int mh,
           int mw, int scale, int fmt, const void* srgb_lut,
           const void* oetf_lut, void* stream) {
  Plane yp{(const uint8_t*)y, ysb, ysr}, up{(const uint8_t*)u, usb, usr};
  Plane vp{(const uint8_t*)v, vsb, vsr}, gp{(const uint8_t*)g, gsb, gsr};
  dim3 grid((w + 255) / 256, h, n);
  apply_kernel<kLut><<<grid, 256, 0, (cudaStream_t)stream>>>(
      yp, up, vp, gp, (const float*)scalars, out, h, w, mh, mw, scale, fmt,
      (const float*)srgb_lut, (const float*)oetf_lut);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y: (n, h, w), u/v: (n, ceil(h/2), ceil(w/2)), g: (n, mh, mw) u8
// planes, each with its own (batch, row) strides in bytes and unit
// column stride; scalars: (n, 4) f32 on the device; out: (n, h, w, 4)
// u16 halves (fmt 0), (n, h, w) u32 words (fmt 1 HLG, 2 PQ) or
// (n, 3, h, w) u16 10-bit linear RGB planes (fmt 3).
int uhdr_apply_gainmap(const void* y, const void* u, const void* v,
                       const void* g, long long ysb, long long ysr,
                       long long usb, long long usr, long long vsb,
                       long long vsr, long long gsb, long long gsr,
                       const void* scalars, void* out, int n, int h, int w,
                       int mh, int mw, int scale, int fmt, void* stream) {
  return launch<false>(y, u, v, g, ysb, ysr, usb, usr, vsb, vsr, gsb, gsr,
                       scalars, out, n, h, w, mh, mw, scale, fmt, nullptr,
                       nullptr, stream);
}

// B11: as uhdr_apply_gainmap, with the float32 sRGB inverse OETF table
// (1,024 entries) and, for fmt 1 / 2, the HLG / PQ OETF table (65,536
// entries) on the device; oetf_lut is unused for fmt 0 and 3.
int uhdr_apply_gainmap_lut(const void* y, const void* u, const void* v,
                           const void* g, long long ysb, long long ysr,
                           long long usb, long long usr, long long vsb,
                           long long vsr, long long gsb, long long gsr,
                           const void* scalars, void* out, int n, int h,
                           int w, int mh, int mw, int scale, int fmt,
                           const void* srgb_lut, const void* oetf_lut,
                           void* stream) {
  return launch<true>(y, u, v, g, ysb, ysr, usb, usr, vsb, vsr, gsb, gsr,
                      scalars, out, n, h, w, mh, mw, scale, fmt, srgb_lut,
                      oetf_lut, stream);
}

}  // extern "C"
