// Block-wide exclusive scans for the port's kernels: warp shuffles, then
// one shared slot per warp. B4's and B22's DC carry (huff_decode.cu)
// scans a frame's lane DC sums with them, B19 (huff_encode.cu) its tile
// bit counts and each tile's block lengths, and the tiled order of B16
// and B17 (packio.cu) its (rank, tile) counts.
//
// Requirements: blockDim.x a multiple of 32 (at most 1024), and every
// thread of the block calls each helper (they hold __syncthreads).
// The value type needs operator+ and a shfl_up overload below.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace uhdr_scan {

// Three uint32 sums carried side by side (the Y, U, V DC sums), each
// wrapping mod 2^32.
struct U3 {
  unsigned x, y, z;
};

__device__ __forceinline__ U3 operator+(U3 a, U3 b) {
  return U3{a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ U3 shfl_up(U3 v, int d) {
  return U3{__shfl_up_sync(0xffffffffu, v.x, d),
            __shfl_up_sync(0xffffffffu, v.y, d),
            __shfl_up_sync(0xffffffffu, v.z, d)};
}

__device__ __forceinline__ long long shfl_up(long long v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

// Exclusive scan of one value a thread over the block, in thread order.
// Returns the thread's prefix and sets `total` (in every thread) to the
// block's sum. `warp_sums`: shared scratch of 32 values. `zero`: the
// identity.
template <class T>
__device__ __forceinline__ T block_exclusive_scan(T v, T zero, T* warp_sums,
                                                  T& total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = (blockDim.x + 31) >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = shfl_up(inc, d);
    if (lane >= d) inc = inc + o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sums[lane] : zero;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T o = shfl_up(w, d);
      if (lane >= d) w = w + o;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  T before = warp > 0 ? warp_sums[warp - 1] : zero;
  total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is free for the next call
  T exc = shfl_up(inc, 1);
  if (lane == 0) exc = zero;
  return before + exc;
}

// Exclusive scan of n values by one block, blockDim.x at a time with
// coalesced loads: store(i, carry + (load(0) + ... + load(i - 1))) for
// every i < n. Returns carry + the sum of all n.
template <class T, class Load, class Store>
__device__ T block_scan_array(int n, T carry, T zero, T* warp_sums,
                              Load load, Store store) {
  for (int base = 0; base < n; base += blockDim.x) {
    int i = base + threadIdx.x;
    T v = i < n ? load(i) : zero;
    T total;
    T p = block_exclusive_scan(v, zero, warp_sums, total);
    if (i < n) store(i, carry + p);
    carry = carry + total;
  }
  return carry;
}

}  // namespace uhdr_scan
