// Device copies of the transfer functions in ops/color.py, rounding the
// same way. The build passes -fmad=false, so a multiply and an add fuse
// only where fmaf() says so: exactly where ops/color.py:fma fuses them,
// following the JAX reference as XLA compiles it. A division by a
// constant is a multiplication by the constant's float32 reciprocal,
// and pow() is evaluated in double, as in ops/color.py. Shared by
// encode_front.cu (B1, B9), apply.cu (B6, B11) and sdr_out.cu (B7).
// Constants are written (float)<double> so that they round the way the
// Python constants do (decimal -> double -> float32).
#pragma once

#include <cstdint>

namespace uhdr {

constexpr float kHlgA = (float)0.17883277;
constexpr float kHlgB = (float)0.28466892;
constexpr float kHlgC = (float)0.55991073;

constexpr float kPqM1 = (float)(2610.0 / 16384.0);
constexpr float kPqM2 = (float)(2523.0 / 4096.0 * 128.0);
constexpr float kPqC1 = (float)(3424.0 / 4096.0);
constexpr float kPqC2 = (float)(2413.0 / 4096.0 * 32.0);
constexpr float kPqC3 = (float)(2392.0 / 4096.0 * 32.0);

constexpr float kPqInvA = 128.0f;
constexpr float kPqInvB = 107.0f;
constexpr float kPqInvC = 2413.0f;
constexpr float kPqInvD = 2392.0f;
constexpr float kPqInvE = (float)6.2773946361;
constexpr float kPqInvF = (float)0.0126833;

// float32 reciprocals of constant divisors (ops/color.py:recip).
constexpr float kRcp1292 = 1.0f / (float)12.92;
constexpr float kRcp1055 = 1.0f / (float)1.055;
constexpr float kRcp3 = 1.0f / 3.0f;
constexpr float kRcp12 = 1.0f / 12.0f;
constexpr float kRcpHlgA = 1.0f / kHlgA;

// Transfer function ids, as ops/gainmap.py numbers them.
enum Tf : int { kLinear = 0, kHlg = 1, kPq = 2 };

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow_rn(float x, float p) {
  return (float)pow((double)x, (double)p);
}

__device__ __forceinline__ float srgb_inv_oetf(float e) {
  if (e <= (float)0.04045) return e * kRcp1292;
  return pow_rn((e + (float)0.055) * kRcp1055, (float)2.4);
}

__device__ __forceinline__ float hlg_oetf(float e) {
  if (e <= (float)(1.0 / 12.0)) return sqrtf(fmaxf(3.0f * e, 0.0f));
  return fmaf(kHlgA, logf(fmaxf(fmaf(12.0f, e, -kHlgB), (float)1e-12)),
              kHlgC);
}

__device__ __forceinline__ float hlg_inv_oetf(float e) {
  if (e <= 0.5f) return (e * e) * kRcp3;
  return (expf((e - kHlgC) * kRcpHlgA) + kHlgB) * kRcp12;
}

__device__ __forceinline__ float pq_oetf(float e) {
  if (e <= 0.0f) return 0.0f;
  float ep = pow_rn(fmaxf(e, 0.0f), kPqM1);
  return pow_rn(fmaf(kPqC2, ep, kPqC1) / fmaf(kPqC3, ep, 1.0f), kPqM2);
}

__device__ __forceinline__ float pq_inv_oetf(float e) {
  if (e <= (float)0.0001) return 0.0f;
  float ef = pow_rn(fmaxf(e, (float)1e-5), kPqInvF);
  float num = fmaf(kPqInvA, ef, -kPqInvB);
  float den = fmaf(-kPqInvD, ef, kPqInvC);
  return pow_rn(fmaxf(num / den, 0.0f), kPqInvE);
}

__device__ __forceinline__ float hdr_inv_oetf(float e, int tf) {
  return tf == kHlg ? hlg_inv_oetf(e) : tf == kPq ? pq_inv_oetf(e) : e;
}

// YUV -> RGB with the reference's clamping; cr, cb and the green
// weights gcb = kb*cb/kg, gcr = kr*cr/kg come from ops/color.py.
struct YuvToRgb {
  float cr, cb, gcb, gcr;
  __device__ __forceinline__ void operator()(float y, float u, float v,
                                             float* r, float* g,
                                             float* b) const {
    *r = clamp01(fmaf(cr, v, y));
    *g = clamp01(fmaf(-gcr, v, fmaf(-gcb, u, y)));
    *b = clamp01(fmaf(cb, u, y));
  }
};

// m0*x0 + m1*x1 as ops/color.py:dot2 rounds it: XLA on the CPU fuses
// the first product of the sum into the add, unless m0 < 0 <= m1, where
// it rewrites the sum as a difference led by the second term.
__device__ __forceinline__ float dot2(float m0, float x0, float m1,
                                      float x1) {
  if (m0 < 0.0f && m1 >= 0.0f) return fmaf(m1, x1, m0 * x0);
  return fmaf(m0, x0, m1 * x1);
}

// m0*x0 + m1*x1 + m2*x2 (ops/color.py:dot3).
__device__ __forceinline__ float dot3(const float* m, float x0, float x1,
                                      float x2) {
  return fmaf(m[2], x2, dot2(m[0], x0, m[1], x1));
}

// kr*r + kg*g + kb*b, fused as ops/color.py:luminance fuses it.
__device__ __forceinline__ float luminance(float kr, float kg, float kb,
                                           float r, float g, float b) {
  return fmaf(kb, b, fmaf(kr, r, kg * g));
}

// Index of x in an n-entry transfer table (ops/color.py:lut_index):
// trunc(x * (n - 1) + 0.5) with the multiply-add fused, clamped.
__device__ __forceinline__ int lut_index(float x, int n) {
  int i = (int)fmaf(x, (float)(n - 1), 0.5f);
  return min(max(i, 0), n - 1);
}

// A u8 plane of a batch with its own (batch, row) strides in bytes and
// unit column stride: B5's crops of padded IDCT output, read in place.
struct Plane {
  const uint8_t* p;
  long long batch_stride, row_stride;
  __device__ __forceinline__ uint8_t at(int b, int y, int x) const {
    return p[b * batch_stride + y * row_stride + x];
  }
};

}  // namespace uhdr
