// Shared by every kernel library of the port: the C-side error string, the
// block-wide exclusive scan that the row scan (K1) and the fused push-back
// (K3) both use, the extent-table lookup of the paged kernels (K8, K9,
// K10, K11, K12), the 16-byte asynchronous copies of the attention kernels
// (K13, K14), and the device counter plane (K15, ctr_accum).
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

// 16-byte asynchronous copy global → shared (cp.async.cg: through L2 only).
// With full = false nothing is read and the 16 bytes are zero-filled, so a
// ragged edge needs no second path.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Base address of slab s (0 <= s < start_E) through the extent table
// [ptr_0 .. ptr_{E-1}, start_0 .. start_E] of `next` extents
// (kernels/common.py::extent_table): the last e with start_e <= s, found by
// binary search, then ptr_e + (s - start_e) * slab_bytes.
__device__ __forceinline__ char* slab_address(const int64_t* __restrict__ tbl, int next,
                                              int64_t s, int64_t slab_bytes) {
  const int64_t* start = tbl + next;
  int lo = 0, hi = next - 1;  // last e with start[e] <= s
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return reinterpret_cast<char*>(tbl[lo]) + (s - start[lo]) * slab_bytes;
}

// K15 — the device counter plane.
//
// Replaces: src/repro/kernels/common.py::GridPlan.pallas_call with
// instrument=True (_with_counters) and src/repro/obs/device.py::ctr_accum.
// On the TPU the counters are one extra (8, 128) int32 output that grid
// step 0 overwrites and later steps add to, in order.  Here thread blocks
// run in no order, so each instrumented kernel takes a pointer to a
// (kCtrSlots,) int32 block that the wrapper zeroed on the stream
// (obs/device.py::new_block); a null pointer means off.  Each kernel is a
// template <bool kCount>: the kCount = false instantiation, the one
// launched with counters off, holds none of this code.
//
// Bound: none of its own — 76 bytes a launch, one atomic per slot per
// thread block.  ctr_accum reduces every thread's contributions to one
// value per slot (__reduce_add_sync within each warp, then the warps'
// sums through shared memory) and thread k of the block adds slot k's sum
// with one atomicAdd, so the atomics grow with the grid, never with the
// threads.  A kernel whose blocks loop (a grid-stride loop) keeps its
// contributions in registers and calls ctr_accum once, after the loop.

// Slot order of obs/device.py::SLOTS.
enum CtrSlot : int {
  kPushBackWaves = 0, kPushBackLanes, kPushBackActiveLanes, kPushBackPaddedLanes,
  kPushBackLevelWrites,
  kGatherLaunches, kGatherTiles, kGatherMaskedTiles,
  kAttendLaunches, kAttendTiles, kAttendTilesSkipped, kAttendLanes, kAttendMaskedLanes,
  kFlattenLaunches, kFlattenRowsTouched, kFlattenSpanRows,
  kAppendWaves, kAppendLanes, kAppendActiveLanes,
  kCtrSlots
};

// Add this block's contributions to the counter block `ctr`: thread t
// contributes val[k] to slot slot[k], k < N.  Every thread of the block
// (NT threads, blockDim.x == NT) must call it, once, with the same `slot`.
template <int NT, int N>
__device__ __forceinline__ void ctr_accum(int* __restrict__ ctr, const int (&slot)[N],
                                          const int (&val)[N]) {
  static_assert(NT % 32 == 0 && NT <= 1024, "NT must be a multiple of 32, <= 1024");
  static_assert(N >= 1 && N <= 32, "one warp adds the slots");
  constexpr int kWarps = NT / 32;
  __shared__ int part[kWarps][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int sum = __reduce_add_sync(0xffffffffu, val[k]);
    if (lane == 0) part[warp][k] = sum;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
    int target = 0;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k == static_cast<int>(threadIdx.x)) target = slot[k];
    if (sum != 0) atomicAdd(ctr + target, sum);
  }
}
