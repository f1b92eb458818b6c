// B7: SDR output for the port's ops/gainmap.py.
//
// Replaces libultrahdr_dev_tpu/ops/gainmap.py:383-419 (_fancy_upsample2
// and yuv420_to_rgba8888): libjpeg's h2v2 "fancy" (triangle) chroma
// upsample in integer arithmetic (jdsample.c h2v2_fancy_upsample),
// full-range BT.601 YCbCr -> RGB, round half to even, clip, and the
// RGBA8888 pack with alpha 0xFF (jpegr.cpp:779-786).
//
// Bound: bytes. A 4080x3072 frame reads 12.5 MB of luma and 6.3 MB of
// chroma and writes 50 MB of RGBA words, with a few dozen operations a
// pixel. One streaming pass, by 2x8 pixel blocks: a thread owns one
// chroma row cy and 4 chroma columns, i.e. output rows 2cy and 2cy + 1
// by 8 output columns. Per chroma plane it loads the 3 x 6 samples
// around them once (rows cy - 1..cy + 1, columns -1..+4, replicated at
// the edges), a 4-byte word and two bytes a row where the row allows,
// and forms each column's two vertical sums once per output-row parity,
// then the 8 horizontal triangle values: each chroma sample a thread
// needs is read once for its 16 pixels, not once per pixel as a pixel a
// thread reads it. Luma comes as one 8-byte word a row where the stride
// and base allow, bytes otherwise (B5's padded crops and the editor's
// outputs of any width reach B7); each output row goes out as two
// 16-byte stores where aligned, guarded word stores at odd sizes and the
// right edge. The batch offset is formed once a thread in 64 bits, the
// offsets within a plane in 32 (the wrapper checks that they fit). A
// warp spans 256 output columns of one row pair: 256 luma bytes a load
// and 1 KB of output a row.
//
// Numerics: the upsample is exact integer arithmetic. The colour
// matrix rounds as XLA on the CPU rounds the JAX expression (checked
// against it, ops/gainmap.py:yuv420_to_rgba8888_plain): r and b are one
// fused multiply-add each, g two, the Cb term first; rintf rounds half
// to even like jnp.round. Bit-exact with the plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

namespace {

using uhdr::Plane;

constexpr int kBX = 32;  // threads across (4 chroma columns each)
constexpr int kBY = 8;   // threads down (one chroma row each)

__device__ __forceinline__ uint32_t to8(float x) {
  return (uint32_t)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// Columns cx0 - 1 .. cx0 + 4 of one chroma row, clamped to [0, cw).
__device__ __forceinline__ void load_row6(const uint8_t* row, int cx0, int cw,
                                          int* s) {
  s[0] = row[cx0 > 0 ? cx0 - 1 : 0];
  if (cx0 + 4 <= cw && ((uintptr_t)(row + cx0) & 3) == 0) {
    uint32_t w = *(const uint32_t*)(row + cx0);
    s[1] = w & 0xFF;
    s[2] = (w >> 8) & 0xFF;
    s[3] = (w >> 16) & 0xFF;
    s[4] = w >> 24;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[1 + k] = row[min(cx0 + k, cw - 1)];
  }
  s[5] = row[min(cx0 + 4, cw - 1)];
}

// The 8 upsampled chroma values of output row parity `odd` from the 3 x
// 6 neighbourhood n (rows cy - 1, cy, cy + 1): column sums 3 * C[cy] +
// C[cy -+ 1], then (3 * sum(c) + sum(c -+ 1) + 8 or 7) >> 4.
__device__ __forceinline__ void fancy8(const int (*n)[6], int odd, float* o) {
  int cs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) cs[i] = 3 * n[1][i] + n[odd ? 2 : 0][i];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = (float)((3 * cs[k + 1] + cs[k] + 8) >> 4) - 128.0f;
    o[2 * k + 1] = (float)((3 * cs[k + 1] + cs[k + 2] + 7) >> 4) - 128.0f;
  }
}

__global__ void __launch_bounds__(kBX * kBY)
    sdr_kernel(Plane yp, Plane up, Plane vp, uint32_t* __restrict__ out,
               int h, int w) {
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  const int cx0 = 4 * (blockIdx.x * kBX + threadIdx.x);
  const int cy = blockIdx.y * kBY + threadIdx.y;
  if (cx0 >= cw || cy >= ch) return;
  const long long b = blockIdx.z;
  const int rows[3] = {max(cy - 1, 0), cy, min(cy + 1, ch - 1)};
  int nu[3][6], nv[3][6];
  const uint8_t* ub = up.p + b * up.batch_stride;
  const uint8_t* vb = vp.p + b * vp.batch_stride;
  const int usr = (int)up.row_stride, vsr = (int)vp.row_stride;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    load_row6(ub + rows[r] * usr, cx0, cw, nu[r]);
    load_row6(vb + rows[r] * vsr, cx0, cw, nv[r]);
  }
  const uint8_t* yb = yp.p + b * yp.batch_stride;
  uint32_t* ob = out + b * h * w;
  const int ysr = (int)yp.row_stride, x0 = 2 * cx0;
#pragma unroll
  for (int odd = 0; odd < 2; ++odd) {
    const int y = 2 * cy + odd;
    if (y >= h) break;
    float cb[8], cr[8], yf[8];
    fancy8(nu, odd, cb);
    fancy8(nv, odd, cr);
    const uint8_t* yr = yb + y * ysr + x0;
    if (x0 + 8 <= w && ((uintptr_t)yr & 7) == 0) {
      uint2 l = *(const uint2*)yr;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        yf[k] = (float)((l.x >> (8 * k)) & 0xFF);
        yf[4 + k] = (float)((l.y >> (8 * k)) & 0xFF);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) yf[k] = (float)yr[min(k, w - 1 - x0)];
    }
    uint32_t px[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float r = fmaf((float)1.40200, cr[k], yf[k]);
      float g = fmaf(-(float)0.71414, cr[k],
                     fmaf(-(float)0.34414, cb[k], yf[k]));
      float bl = fmaf((float)1.77200, cb[k], yf[k]);
      px[k] = to8(r) | (to8(g) << 8) | (to8(bl) << 16) | 0xFF000000u;
    }
    uint32_t* o = ob + y * w + x0;
    if (x0 + 8 <= w && ((uintptr_t)o & 15) == 0) {
      ((uint4*)o)[0] = make_uint4(px[0], px[1], px[2], px[3]);
      ((uint4*)o)[1] = make_uint4(px[4], px[5], px[6], px[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (x0 + k < w) o[k] = px[k];
    }
  }
}

}  // namespace

extern "C" {

// y: (n, h, w), u/v: (n, ceil(h/2), ceil(w/2)) u8 planes, each with its
// own (batch, row) strides in bytes and unit column stride; out:
// (n, h, w) u32 RGBA8888 words, 16-byte aligned.
int uhdr_yuv420_to_rgba8888(const void* y, const void* u, const void* v,
                            long long ysb, long long ysr, long long usb,
                            long long usr, long long vsb, long long vsr,
                            void* out, int n, int h, int w, void* stream) {
  Plane yp{(const uint8_t*)y, ysb, ysr}, up{(const uint8_t*)u, usb, usr};
  Plane vp{(const uint8_t*)v, vsb, vsr};
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  dim3 block(kBX, kBY);
  dim3 grid(((cw + 3) / 4 + kBX - 1) / kBX, (ch + kBY - 1) / kBY, n);
  sdr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(yp, up, vp,
                                                       (uint32_t*)out, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
