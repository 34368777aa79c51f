// Shared by every kernel library of the port: the C-side error string, the
// block-wide exclusive scan (the row scan K1, K12's copy), the
// tile-parallel row scan of the two append kernels (the fused push-back K3
// and the slab append K12), the extent-table lookup of the paged kernels
// (K8, K9, K10, K11, K12), the 16-byte asynchronous copies of the attention
// kernels (K13, K14), and the device counter plane (K15, ctr_accum).
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

// The tile-parallel row scan of the append kernels (K3, K12).
//
// A wave's mask is (rows, m) bytes.  Each row is cut into tiles of NT *
// kScanPer lanes (NT = 64, 128 or 256 threads, kScanPer = 16), and the grid
// is rows x tiles, so a long row no longer waits on one block.  A tile's
// first rank is the sum of the live counts of its row's earlier tiles.
// Where a row has more than one tile, a count pass (row_tile_count_kernel)
// writes those counts, (rows, tiles) int32, first; the write pass's warp 0
// sums its row's earlier counts (at most 63 at the main shape) while the
// block scans its own lanes.  Where a row is one tile, the host skips the
// count pass and the write pass is the only launch.  No look-back and no
// atomics: the result is deterministic.
//
// In the write pass thread t holds lanes t, t + NT, ..., t + 15 NT of its
// tile, so every mask read, position write and one-unit item copy is
// coalesced across a warp.  A lane's rank comes from warp ballots: row i
// of the tile (NT lanes) gives each warp a 32-bit ballot; warp 0 scans the
// 16 x NT/32 warp counts in lane order through shared memory, from the
// earlier tiles' sum, and a lane adds the live lanes below it in its
// warp's ballot.
// kernels/common.py::scan_threads, row_tiles, tile_counts and tile_ranks
// are the plan and its arithmetic in Python.
constexpr int kScanPer = 16;     // lanes a thread
constexpr int kSegLanes = 1024;  // K12's rank-search segments: 64 threads' lanes

// The live lanes among [lane0, lane0 + 16) of a mask row, as bits (bit i:
// lane lane0 + i is nonzero); lanes at or past m read as masked.  lane0 is
// a multiple of 16, so the 16-byte load is aligned wherever the row is.
__device__ __forceinline__ uint32_t live_bits16(const unsigned char* __restrict__ row,
                                                int64_t lane0, int64_t m) {
  uint32_t bits = 0;
  if (lane0 + kScanPer <= m && (reinterpret_cast<uintptr_t>(row + lane0) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + lane0));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t nz = __vcmpne4(words[k], 0u);  // 0xff in each nonzero byte
      bits |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) | ((nz >> 21) & 8u)) << (4 * k);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      if (lane0 + i < m && row[lane0 + i] != 0) bits |= 1u << i;
  }
  return bits;
}

// Sum of one int per thread across a block of NT threads, through `smem`
// (32 ints); every thread gets it.  Ends with a barrier.
template <int NT>
__device__ __forceinline__ int block_sum(int v, int* smem) {
  constexpr int kWarps = NT / 32;
  const int s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = s;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += smem[w];
  __syncthreads();
  return total;
}

// The count pass: grid (rows * tiles); block (row, tile) writes its tile's
// live lanes to counts[row * tiles + tile].  (It reads 16 consecutive lanes
// a thread: a count does not depend on which thread holds a lane.)
template <int NT>
__global__ void __launch_bounds__(NT)
row_tile_count_kernel(const unsigned char* __restrict__ mask, int64_t m, int tiles,
                      int* __restrict__ counts) {
  __shared__ int smem[32];
  const int64_t row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const int64_t lane0 = static_cast<int64_t>(tile) * NT * kScanPer + threadIdx.x * kScanPer;
  const int total = block_sum<NT>(__popc(live_bits16(mask + row * m, lane0, m)), smem);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One thread's share of a tile of the write pass: the lanes at tile
// offsets i * NT + threadIdx.x, i < 16 (32-bit offsets from the tile's first
// lane, so the kernels address them from one base pointer).
struct TileScan {
  int64_t tile_lane0;    // the tile's first lane in the row
  int lanes;             // lanes in the tile: min(NT * 16, m - tile_lane0)
  uint32_t live;         // bit i: lane i is live
  int rank[kScanPer];    // row rank of lane i: the live lanes before it in the row
  int tile_first;        // row rank of the tile's first live lane
  int tile_total;        // live lanes in the tile
};

// The write pass's scan of tile `tile` of a row: `counts_row` is the row's
// count-pass output, or null where the row is one tile.  Every thread of
// the block must call it, once; it ends with a barrier.
template <int NT>
__device__ __forceinline__ TileScan tile_scan(const unsigned char* __restrict__ mask_row, int64_t m,
                                              int tile, const int* __restrict__ counts_row) {
  constexpr int kWarps = NT / 32;
  constexpr int kEntries = kScanPer * kWarps;  // 32, 64 or 128 warp counts
  static_assert(kEntries % 32 == 0 && kEntries <= 128, "warp 0 scans the counts, 4 a lane at most");
  __shared__ int s_pre[kEntries + 2];  // + the tile's first rank and total
  TileScan s;
  s.tile_lane0 = static_cast<int64_t>(tile) * NT * kScanPer;
  const int64_t left = m - s.tile_lane0;
  s.lanes = left < NT * kScanPer ? static_cast<int>(left) : NT * kScanPer;
  const unsigned char* mt = mask_row + s.tile_lane0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char byte[kScanPer];
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {  // every load first
    const int o = i * NT + threadIdx.x;
    byte[i] = o < s.lanes ? __ldg(mt + o) : 0;
  }
  uint32_t ballot[kScanPer];
  s.live = 0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    ballot[i] = __ballot_sync(0xffffffffu, byte[i] != 0);
    s.live |= (byte[i] != 0 ? 1u : 0u) << i;
    if (lane == 0) s_pre[i * kWarps + warp] = __popc(ballot[i]);
  }
  __syncthreads();
  if (warp == 0) {
    int pre = 0;  // the earlier tiles' counts
    if (counts_row != nullptr)
      for (int t = lane; t < tile; t += 32) pre += counts_row[t];
    pre = __reduce_add_sync(0xffffffffu, pre);
    constexpr int kPer = kEntries / 32;  // consecutive entries a lane
    int v[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = s_pre[lane * kPer + k];
      sum += v[k];
    }
    int x = sum;  // inclusive scan of the lanes' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    int run = pre + x - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      s_pre[lane * kPer + k] = run;
      run += v[k];
    }
    if (lane == 31) {
      s_pre[kEntries] = pre;
      s_pre[kEntries + 1] = x;
    }
  }
  __syncthreads();
  s.tile_first = s_pre[kEntries];
  s.tile_total = s_pre[kEntries + 1];
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i)
    s.rank[i] = s_pre[i * kWarps + warp] + __popc(ballot[i] & below);
  return s;
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
