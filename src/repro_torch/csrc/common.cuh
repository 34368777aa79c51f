// Shared by every kernel library of the port: the C-side error string and
// the block-wide exclusive scan that the row scan (K1) and the fused
// push-back (K3) both use.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Exclusive prefix sum of one int per thread across a block of NT threads
// (NT a multiple of 32, at most 1024).  Writes the block total to *total.
// Warp scans by __shfl_up_sync, then the warp totals are scanned by warp 0
// through `smem` (32 ints).  Every thread of the block must call it; it
// ends with a barrier so `smem` may be reused by the next call.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem, int* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "NT must be a multiple of 32, <= 1024");
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? smem[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) smem[lane] = w;
  }
  __syncthreads();
  const int warp_prefix = warp > 0 ? smem[warp - 1] : 0;
  *total = smem[kWarps - 1];
  __syncthreads();
  return warp_prefix + x - v;
}
