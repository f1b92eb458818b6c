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
// Design. A thread takes a 2 x 2 quad of output pixels, which share
// one chroma pair (the nearest 2x upsample), and a CTA of kThreads
// threads takes kRows chroma rows of kThreads quads, so that its
// prologue (the tables below, into shared memory) is paid once per
// 4,096 pixels. Each output row of a quad is one store (16 bytes of F16,
// 8 of RGBA1010102, 4 a plane of the 10-bit planes); luma comes in as
// one 2-byte load a row where the address allows it. The odd last
// column and row, and rows whose address is not aligned, take
// per-pixel stores.
//
// The costly part is the sRGB inverse OETF: a float pow() a channel,
// exactly rounded (pow_rn: a double pow of ~100 float64 instructions;
// three a pixel, nine with the PQ OETF). Red depends only on the luma
// and V bytes, blue only on the luma and U bytes, so both come from two
// 65,536-entry tables (uhdr_srgb_rb_tables, built once per device by the
// same arithmetic: the wrapper's srgb_rb_tables) read through L1/L2;
// green and the PQ OETF's powers use pow_exact (color.cuh), pow_rn's
// bits from a ~25-operation table-driven log2 / exp2 in double, with
// pow_rn itself only where a float rounding boundary lies within its
// error (about 1 call in 4,000). The Shepard inverse-distance weights of
// the four gain-map samples depend only on the pixel's phase in its map
// cell and on whether the cell is on the right / bottom edge, so for
// scale <= kTableScale each CTA builds them once (scale^2 x 4 cells,
// the same float operations as the per-pixel form) in shared memory;
// the blend's division stays per pixel. No runtime division by scale is
// left on the per-pixel path: a thread divides once and steps phases.
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

constexpr int kThreads = 128;
constexpr int kMinCtas = 8;     // CTAs an SM holds: at most 64 registers
constexpr int kRows = 8;        // chroma rows a CTA
constexpr int kTableScale = 8;  // largest scale with a weight table

// BT.601 YUV -> RGB of the decoded base (ultrahdr.cpp:437-445).
__device__ __forceinline__ uhdr::YuvToRgb bt601() {
  return uhdr::YuvToRgb{(float)1.402, (float)1.772,
                        (float)(0.114 * 1.772 / 0.587),
                        (float)(0.299 * 1.402 / 0.587)};
}

// The u8 samples normalized as the plain version does it: luma
// byte / 255, chroma (byte - 128) / 255.
__device__ __forceinline__ float luma01(int v) {
  return (float)v * (float)(1.0 / 255.0);
}

__device__ __forceinline__ float chroma01(int v) {
  return ((float)v - 128.0f) * (float)(1.0 / 255.0);
}

// Shepard weights of one cell phase (gainmapmath.cpp:66-110, 686-720),
// d1 kept for its d1 <= 0 test; 32 bytes, two 16-byte shared loads.
struct Idw {
  float w1, w2, w3, w4, total, d1, pad0, pad1;
};

__device__ __forceinline__ Idw idw_weights(int phx, int phy, bool edge_r,
                                           bool edge_b, float rcp_scale) {
  float px = (float)phx * rcp_scale;
  float py = (float)phy * rcp_scale;
  float inc_r = edge_r ? 0.0f : 1.0f;
  float inc_b = edge_b ? 0.0f : 1.0f;
  float dyb = py - inc_b, dxr = px - inc_r;
  float d1 = sqrtf(fmaf(px, px, py * py));
  float d2 = sqrtf(fmaf(px, px, dyb * dyb));
  float d3 = sqrtf(fmaf(dxr, dxr, py * py));
  float d4 = sqrtf(fmaf(dxr, dxr, dyb * dyb));
  const float eps = (float)1e-12;
  Idw c;
  c.w1 = 1.0f / fmaxf(d1, eps);
  c.w2 = 1.0f / fmaxf(d2, eps);
  c.w3 = 1.0f / fmaxf(d3, eps);
  c.w4 = 1.0f / fmaxf(d4, eps);
  c.total = c.w1 + c.w2 + c.w3 + c.w4;
  c.d1 = d1;
  c.pad0 = c.pad1 = 0.0f;
  return c;
}

__device__ __forceinline__ uint32_t pack10(float c) {
  return (uint32_t)(clamp01(c) * 1023.0f) & 0x3FFu;
}

// The two luma bytes of a quad row: one 2-byte load when both are in
// the row and the address is even.
__device__ __forceinline__ void load_pair(const uint8_t* p, int n,
                                          int (&v)[2]) {
  if (n == 2 && ((uintptr_t)p & 1) == 0) {
    uint16_t q = __ldg(reinterpret_cast<const uint16_t*>(p));
    v[0] = q & 0xFF;
    v[1] = q >> 8;
  } else {
    v[0] = __ldg(p);
    v[1] = n == 2 ? __ldg(p + 1) : 0;
  }
}

// One output row of a quad, its n pixels of kSize bytes in v (F16: x, y
// the first pixel, z, w the second; else x, y or the halves of x): one
// store when the row is whole and aligned, else one a pixel.
template <int kSize>
__device__ __forceinline__ void store_pair(uint8_t* dst, const uint4& v,
                                           int n) {
  const bool whole = n == 2 && ((uintptr_t)dst & (2 * kSize - 1)) == 0;
  if (kSize == 8) {
    if (whole) {
      *reinterpret_cast<uint4*>(dst) = v;
      return;
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
    if (n == 2) *reinterpret_cast<uint2*>(dst + 8) = make_uint2(v.z, v.w);
  } else if (kSize == 4) {
    if (whole) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
      return;
    }
    *reinterpret_cast<uint32_t*>(dst) = v.x;
    if (n == 2) *reinterpret_cast<uint32_t*>(dst + 4) = v.y;
  } else {
    if (whole) {
      *reinterpret_cast<uint32_t*>(dst) = v.x;
      return;
    }
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)v.x;
    if (n == 2)
      *reinterpret_cast<uint16_t*>(dst + 2) = (uint16_t)(v.x >> 16);
  }
}

template <bool kLut, int kFmt>
__global__ void __launch_bounds__(kThreads, kMinCtas)
apply_kernel(Plane yp, Plane up, Plane vp, Plane gp,
             const float* __restrict__ scalars, void* __restrict__ out,
             int h, int w, int mh, int mw, int scale,
             const float* __restrict__ srgb_rb,
             const float* __restrict__ srgb_lut,
             const float* __restrict__ oetf_lut) {
  __shared__ float srgb[kLut ? kSrgbLutN : 1];
  __shared__ uhdr::PowTables ptab;
  __shared__ Idw cells[4 * kTableScale * kTableScale];
  const bool table = scale <= kTableScale;
  const float rcp_scale = 1.0f / (float)scale;
  if (kLut) {
    for (int i = threadIdx.x; i < kSrgbLutN; i += kThreads)
      srgb[i] = srgb_lut[i];
  } else {
    uhdr::load_pow_tables(&ptab);
  }
  if (table) {  // (row phase, bottom edge) x (column phase, right edge)
    for (int i = threadIdx.x; i < 4 * scale * scale; i += kThreads) {
      int col = i % (2 * scale), row = i / (2 * scale);
      cells[i] = idw_weights(col >> 1, row >> 1, col & 1, row & 1,
                             rcp_scale);
    }
  }
  __syncthreads();

  const int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
  const int cx = blockIdx.x * kThreads + threadIdx.x;
  if (cx >= cw) return;
  const int b = blockIdx.z;
  const int x0 = 2 * cx;
  const int nx = min(2, w - x0);
  const uhdr::YuvToRgb to_rgb = bt601();

  // The quad's map columns and phases, from one division.
  int mx[2], phx[2];
  mx[0] = x0 / scale;
  phx[0] = x0 - mx[0] * scale;
  phx[1] = phx[0] + 1 == scale ? 0 : phx[0] + 1;
  mx[1] = mx[0] + (int)(phx[1] == 0);

  const float* s = scalars + 4 * b;  // log2_min, log2_max, factor, disp
  const float s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3];
  const int cy0 = blockIdx.y * kRows, cy1 = min(ch, cy0 + kRows);
  int my0 = 2 * cy0 / scale;  // map row and phase of luma row 2 cy
  int phy0 = 2 * cy0 - my0 * scale;
  for (int cy = cy0; cy < cy1; ++cy) {
    const int y0 = 2 * cy, ny = min(2, h - y0);
    const int uc = __ldg(up.row(b, cy) + cx);
    const int vc = __ldg(vp.row(b, cy) + cx);
    const float uf = chroma01(uc), vf = chroma01(vc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= ny) break;
      const int y = y0 + r;
      int my = my0, phy = phy0;
      if (r == 1 && ++phy == scale) {
        phy = 0;
        ++my;
      }
      const int my2 = min(my + 1, mh - 1);
      const bool edge_b = my >= mh - 1;
      const uint8_t* grow = gp.row(b, my);
      const uint8_t* grow2 = gp.row(b, my2);
      int yv[2];
      load_pair(yp.row(b, y) + x0, nx, yv);
      uint32_t o[4] = {0u, 0u, 0u, 0u};  // the row's output words
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c >= nx) break;
        float red, green, blue;
        to_rgb(luma01(yv[c]), uf, vf, &red, &green, &blue);
        if (kLut) {
          red = srgb[uhdr::lut_index(red, kSrgbLutN)];
          green = srgb[uhdr::lut_index(green, kSrgbLutN)];
          blue = srgb[uhdr::lut_index(blue, kSrgbLutN)];
        } else {
          red = __ldg(srgb_rb + (yv[c] << 8 | vc));
          green = uhdr::srgb_inv_oetf_exact(green, ptab);
          blue = __ldg(srgb_rb + 65536 + (yv[c] << 8 | uc));
        }

        // Shepard IDW over the 4 surrounding map samples.
        const int m1 = mx[c], m2 = min(m1 + 1, mw - 1);
        const bool edge_r = m1 >= mw - 1;
        const float rcp255 = 1.0f / 255.0f;
        float e1 = (float)__ldg(grow + m1) * rcp255;
        float e2 = (float)__ldg(grow2 + m1) * rcp255;
        float e3 = (float)__ldg(grow + m2) * rcp255;
        float e4 = (float)__ldg(grow2 + m2) * rcp255;
        const Idw cell =
            table ? cells[(2 * phy + (int)edge_b) * 2 * scale + 2 * phx[c] +
                          (int)edge_r]
                  : idw_weights(phx[c], phy, edge_r, edge_b, rcp_scale);
        float gain = cell.d1 <= 0.0f
                         ? e1
                         : fmaf(e4, cell.w4,
                                fmaf(e3, cell.w3,
                                     fmaf(e1, cell.w1, e2 * cell.w2))) /
                               cell.total;

        float log_boost = fmaf(s0, 1.0f - gain, s1 * gain);
        float factor = exp2f(log_boost * s2) / s3;
        red = red * factor;
        green = green * factor;
        blue = blue * factor;

        if (kFmt == kF16) {
          o[2 * c] =
              (uint32_t)__half_as_ushort(__float2half_rn(red)) |
              ((uint32_t)__half_as_ushort(__float2half_rn(green)) << 16);
          o[2 * c + 1] = (uint32_t)__half_as_ushort(__float2half_rn(blue)) |
                         (0x3C00u << 16);  // alpha 1.0
        } else if (kFmt == kRgb10) {  // a 16-bit pair a plane
          const int sh = 16 * c;
          o[0] |= (uint32_t)(uint16_t)(clamp01(red) * 1023.0f) << sh;
          o[1] |= (uint32_t)(uint16_t)(clamp01(green) * 1023.0f) << sh;
          o[2] |= (uint32_t)(uint16_t)(clamp01(blue) * 1023.0f) << sh;
        } else {
          if (kLut) {  // the HLG or PQ OETF table, as fmt says
            red = __ldg(oetf_lut + uhdr::lut_index(red, kOetfLutN));
            green = __ldg(oetf_lut + uhdr::lut_index(green, kOetfLutN));
            blue = __ldg(oetf_lut + uhdr::lut_index(blue, kOetfLutN));
          } else if (kFmt == kHlgOut) {
            red = uhdr::hlg_oetf(red);
            green = uhdr::hlg_oetf(green);
            blue = uhdr::hlg_oetf(blue);
          } else {
            red = uhdr::pq_oetf(red, ptab);
            green = uhdr::pq_oetf(green, ptab);
            blue = uhdr::pq_oetf(blue, ptab);
          }
          o[c] = pack10(red) | (pack10(green) << 10) | (pack10(blue) << 20) |
                 0xC0000000u;
        }
      }
      if (kFmt == kRgb10) {  // (n, 3, h, w) planes, the three h * w apart
        uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          store_pair<2>(reinterpret_cast<uint8_t*>(
                            o16 + (((size_t)b * 3 + k) * h + y) * w + x0),
                        make_uint4(o[k], 0u, 0u, 0u), nx);
      } else {
        constexpr int kBytes = kFmt == kF16 ? 8 : 4;  // a pixel
        store_pair<kBytes>(reinterpret_cast<uint8_t*>(out) +
                               (((size_t)b * h + y) * w + x0) * kBytes,
                           make_uint4(o[0], o[1], o[2], o[3]), nx);
      }
    }
    for (phy0 += 2; phy0 >= scale; phy0 -= scale) ++my0;
  }
}

// B6's sRGB tables: t[i] = the linearized red of luma i >> 8 and V
// i & 255, t[65536 + i] the blue of luma i >> 8 and U i & 255, by
// apply_kernel's own arithmetic.
__global__ void __launch_bounds__(256) srgb_rb_kernel(float* __restrict__ t) {
  __shared__ uhdr::PowTables ptab;
  uhdr::load_pow_tables(&ptab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // < 65,536
  const uhdr::YuvToRgb to_rgb = bt601();
  const float yf = luma01(i >> 8), cf = chroma01(i & 255);
  float red, green, blue;
  to_rgb(yf, 0.0f, cf, &red, &green, &blue);
  t[i] = uhdr::srgb_inv_oetf_exact(red, ptab);
  to_rgb(yf, cf, 0.0f, &red, &green, &blue);
  t[65536 + i] = uhdr::srgb_inv_oetf_exact(blue, ptab);
}

// The check of pow_exact (on no path): every float32 whose bits lie in
// [lo, hi) through pow_exact and pow_rn; counts[0] += the results that
// differ in any bit, counts[1] += the inputs that took the double path.
__global__ void __launch_bounds__(256)
pow_check_kernel(float p, unsigned lo, unsigned hi,
                 unsigned long long* __restrict__ counts) {
  __shared__ uhdr::PowTables ptab;
  uhdr::load_pow_tables(&ptab);
  __syncthreads();
  unsigned long long bad = 0, slow = 0;
  for (unsigned long long b = lo + blockIdx.x * blockDim.x + threadIdx.x;
       b < hi; b += (unsigned long long)gridDim.x * blockDim.x) {
    float x = __uint_as_float((unsigned)b);
    bool s = false;
    float f = uhdr::pow_exact(x, p, ptab, &s);
    bad += __float_as_uint(f) != __float_as_uint(uhdr::pow_rn(x, p));
    slow += s;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, d);
    slow += __shfl_xor_sync(0xffffffffu, slow, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(counts, bad);
    atomicAdd(counts + 1, slow);
  }
}

// y[i] = x[i]^p by pow_exact (kExact) or pow_rn: each pow alone, for
// its time and its SASS.
template <bool kExact>
__global__ void __launch_bounds__(256)
pow_probe_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                 float p) {
  __shared__ uhdr::PowTables ptab;
  if (kExact) {
    uhdr::load_pow_tables(&ptab);
    __syncthreads();
  }
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    y[i] = kExact ? uhdr::pow_exact(x[i], p, ptab) : uhdr::pow_rn(x[i], p);
}

template <bool kLut>
int launch(const void* y, const void* u, const void* v, const void* g,
           long long ysb, long long ysr, long long usb, long long usr,
           long long vsb, long long vsr, long long gsb, long long gsr,
           const void* scalars, void* out, int n, int h, int w, int mh,
           int mw, int scale, int fmt, const void* srgb_rb,
           const void* srgb_lut, const void* oetf_lut, void* stream) {
  Plane yp{(const uint8_t*)y, ysb, ysr}, up{(const uint8_t*)u, usb, usr};
  Plane vp{(const uint8_t*)v, vsb, vsr}, gp{(const uint8_t*)g, gsb, gsr};
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  dim3 grid((cw + kThreads - 1) / kThreads, (ch + kRows - 1) / kRows, n);
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        yp, up, vp, gp, (const float*)scalars, out, h, w, mh, mw, scale,
        (const float*)srgb_rb, (const float*)srgb_lut,
        (const float*)oetf_lut);
  };
  switch (fmt) {
    case kF16:
      run(apply_kernel<kLut, kF16>);
      break;
    case kHlgOut:
      run(apply_kernel<kLut, kHlgOut>);
      break;
    case kPqOut:
      run(apply_kernel<kLut, kPqOut>);
      break;
    default:
      run(apply_kernel<kLut, kRgb10>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y: (n, h, w), u/v: (n, ceil(h/2), ceil(w/2)), g: (n, mh, mw) u8
// planes, each with its own (batch, row) strides in bytes and unit
// column stride; scalars: (n, 4) f32 on the device; out: (n, h, w, 4)
// u16 halves (fmt 0), (n, h, w) u32 words (fmt 1 HLG, 2 PQ) or
// (n, 3, h, w) u16 10-bit linear RGB planes (fmt 3); srgb_rb: the
// (2, 65536) f32 tables of uhdr_srgb_rb_tables.
int uhdr_apply_gainmap(const void* y, const void* u, const void* v,
                       const void* g, long long ysb, long long ysr,
                       long long usb, long long usr, long long vsb,
                       long long vsr, long long gsb, long long gsr,
                       const void* scalars, void* out, int n, int h, int w,
                       int mh, int mw, int scale, int fmt,
                       const void* srgb_rb, void* stream) {
  return launch<false>(y, u, v, g, ysb, ysr, usb, usr, vsb, vsr, gsb, gsr,
                       scalars, out, n, h, w, mh, mw, scale, fmt, srgb_rb,
                       nullptr, nullptr, stream);
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
                      scalars, out, n, h, w, mh, mw, scale, fmt, nullptr,
                      srgb_lut, oetf_lut, stream);
}

// B6's sRGB tables into t, (2, 65536) f32: the linearized red of the
// BT.601 decode at luma << 8 | V, then its blue at luma << 8 | U.
int uhdr_srgb_rb_tables(void* t, void* stream) {
  srgb_rb_kernel<<<256, 256, 0, (cudaStream_t)stream>>>((float*)t);
  return (int)cudaGetLastError();
}

// Checks of B6's pow_exact, on no path: uhdr_pow_check counts, into
// counts (int64 (2), zeroed), the float32s with bits in [lo, hi) whose
// pow_exact(x, p) differs from pow_rn(x, p), and those that took its
// double path; uhdr_pow_probe writes y = x^p by pow_exact (exact != 0)
// or pow_rn, n float32s.
int uhdr_pow_check(float p, unsigned lo, unsigned hi, void* counts,
                   void* stream) {
  pow_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      p, lo, hi, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

int uhdr_pow_probe(const void* x, void* y, int n, float p, int exact,
                   void* stream) {
  int grid = (n + 255) / 256;
  if (exact)
    pow_probe_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, n, p);
  else
    pow_probe_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)y, n, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
