// B13: the effect chain of the port's ops/editor.py (crop, mirror,
// rotate, resize of one u8 plane).
//
// Replaces libultrahdr_dev_tpu/ops/editor.py:71-131 (crop, mirror,
// rotate, resize: one jnp slice, flip, rot90 or gather per effect and
// plane, each materializing its plane).
//
// Bound: bytes. The work is pure data movement, one byte read and one
// written per output pixel, so the kernel's floor is the output plane
// plus the source bytes it touches at 3.35 TB/s. The design moves each
// byte once for a whole chain: the host plans the chain per plane
// (ops/editor.py:plan_effects) into at most kMaxSteps step descriptors
// passed by value, and one thread per output byte runs the steps in
// reverse to find its source byte. No intermediate plane exists. A CTA
// covers 256 consecutive output bytes of a row, so writes coalesce;
// reads coalesce for crop, mirror, resize and a 180-degree turn and are
// strided for a 90 / 270-degree turn (a shared-memory tiled transpose is
// later work). Rows beyond the grid's 65,535 are walked by a stride loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSteps = 16;  // ops/editor.py:MAX_STEPS
enum Kind : int { kCrop = 0, kMirror = 1, kRotate = 2, kResize = 3 };

// One step: kind, the plane's (h, w) before it, then its parameters:
// crop (top, left, out h, out w), mirror (horizontal, -, -, -), rotate
// (clockwise degrees, -, -, -), resize (-, -, out h, out w).
struct Chain {
  int n;
  int s[kMaxSteps][7];
};

__global__ void edit_kernel(const uint8_t* __restrict__ src,
                            long long src_stride, uint8_t* __restrict__ dst,
                            int oh, int ow, Chain c) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= ow) return;
  for (int y = blockIdx.y; y < oh; y += gridDim.y) {
    long long sy = y, sx = x;
    for (int i = c.n - 1; i >= 0; --i) {
      const int* s = c.s[i];
      long long h = s[1], w = s[2];
      long long ty = sy, tx = sx;
      switch (s[0]) {
        case kCrop:
          sy = ty + s[3];
          sx = tx + s[4];
          break;
        case kMirror:
          if (s[3]) sx = w - 1 - tx;
          else sy = h - 1 - ty;
          break;
        case kRotate:  // out (i, j) of the clockwise turn of in (h, w)
          if (s[3] == 90) {
            sy = h - 1 - tx;
            sx = ty;
          } else if (s[3] == 180) {
            sy = h - 1 - ty;
            sx = w - 1 - tx;
          } else {
            sy = tx;
            sx = w - 1 - ty;
          }
          break;
        default:  // nearest neighbour, (i * ih) // oh as the JAX resize
          sy = ty * h / s[5];
          sx = tx * w / s[6];
          break;
      }
    }
    dst[(long long)y * ow + x] = src[sy * src_stride + sx];
  }
}

}  // namespace

extern "C" {

// src: the input plane (unit column stride, `src_stride` bytes between
// rows); dst: the (oh, ow) output, contiguous; steps: n (<= kMaxSteps)
// descriptors of 7 int32 each, in host memory, first step first.
int uhdr_edit_plane(const void* src, long long src_stride, void* dst, int oh,
                    int ow, const int* steps, int n, void* stream) {
  if (n < 1 || n > kMaxSteps) return (int)cudaErrorInvalidValue;
  Chain c;
  c.n = n;
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 7; ++k) c.s[i][k] = steps[7 * i + k];
  dim3 grid((ow + 255) / 256, oh < 65535 ? oh : 65535);
  edit_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, src_stride, (uint8_t*)dst, oh, ow, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
