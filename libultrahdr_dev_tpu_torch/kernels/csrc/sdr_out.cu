// B7: SDR output for the port's ops/gainmap.py.
//
// Replaces libultrahdr_dev_tpu/ops/gainmap.py:yuv420_to_rgba8888 (with
// _fancy_upsample2): libjpeg's h2v2 "fancy" (triangle) chroma upsample
// in integer arithmetic (jdsample.c h2v2_fancy_upsample), full-range
// BT.601 YCbCr -> RGB, round half to even, clip, and the RGBA8888 pack
// with alpha 0xFF (jpegr.cpp:779-786).
//
// Bound: bytes. A 4080x3072 frame reads 12.5 MB of luma and 6.3 MB of
// chroma and writes 50 MB of RGBA words, with a few dozen operations a
// pixel. One streaming pass: one thread per output pixel, a row of 256
// pixels per CTA, so a warp reads 32 consecutive luma bytes and writes
// 128 consecutive bytes. Each thread forms its own upsampled chroma from
// the 2x2 chroma samples around it (its row and the nearer neighbour
// row, its column and the nearer neighbour column, replicated at the
// edges), read in place from B5's row-strided crops: no upsampled plane
// reaches device memory.
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

// Fancy-upsampled chroma at output pixel (x, y) of a (ch, cw) plane:
// (3 * colsum(cx) + colsum(nx) + 8 or 7) >> 4, with colsum(c) =
// 3 * C[cy][c] + C[ny][c].
__device__ __forceinline__ int fancy(const Plane& p, int b, int cy, int ny,
                                     int cx, int nx, int odd_x) {
  int c0 = 3 * p.at(b, cy, cx) + p.at(b, ny, cx);
  int c1 = 3 * p.at(b, cy, nx) + p.at(b, ny, nx);
  return (3 * c0 + c1 + (odd_x ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint32_t to8(float x) {
  return (uint32_t)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__global__ void sdr_kernel(Plane yp, Plane up, Plane vp,
                           uint32_t* __restrict__ out, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int b = blockIdx.z;
  if (x >= w) return;
  int ch = (h + 1) / 2, cw = (w + 1) / 2;
  int cy = y >> 1, cx = x >> 1;
  int ny = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  int nx = (x & 1) ? min(cx + 1, cw - 1) : max(cx - 1, 0);
  float cb = (float)fancy(up, b, cy, ny, cx, nx, x & 1) - 128.0f;
  float cr = (float)fancy(vp, b, cy, ny, cx, nx, x & 1) - 128.0f;
  float yf = (float)yp.at(b, y, x);
  float r = fmaf((float)1.40200, cr, yf);
  float g = fmaf(-(float)0.71414, cr, fmaf(-(float)0.34414, cb, yf));
  float bl = fmaf((float)1.77200, cb, yf);
  out[((size_t)b * h + y) * w + x] =
      to8(r) | (to8(g) << 8) | (to8(bl) << 16) | 0xFF000000u;
}

}  // namespace

extern "C" {

// y: (n, h, w), u/v: (n, ceil(h/2), ceil(w/2)) u8 planes, each with its
// own (batch, row) strides in bytes and unit column stride; out:
// (n, h, w) u32 RGBA8888 words.
int uhdr_yuv420_to_rgba8888(const void* y, const void* u, const void* v,
                            long long ysb, long long ysr, long long usb,
                            long long usr, long long vsb, long long vsr,
                            void* out, int n, int h, int w, void* stream) {
  Plane yp{(const uint8_t*)y, ysb, ysr}, up{(const uint8_t*)u, usb, usr};
  Plane vp{(const uint8_t*)v, vsb, vsr};
  dim3 grid((w + 255) / 256, h, n);
  sdr_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(yp, up, vp,
                                                     (uint32_t*)out, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
