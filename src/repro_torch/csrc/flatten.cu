// K6 and K7 — the freeze: bucket levels → per-block rows → one contiguous
// array in block-major global order.
//
// K6 replaces src/repro/kernels/flatten/kernel.py::compact_blocks_pallas:
// level b of every block lands in columns [B0 (2^b - 1), B0 (2^(b+1) - 1))
// of that block's row of a (nblocks, cap) plane.
// K7 replaces src/repro/kernels/flatten/kernel.py::segmented_gather_pallas:
// out[i] = compact[o, i - starts[o]] for the block o that owns i, 0 where
// i >= ends[o].
//
// Bound on the card: bytes, for both.  K6 reads every level slot once and
// writes every plane slot once.  K7 writes every output slot once and
// needs to read only the live slots of the plane (plus the two tables).
//
// K6 design: a 1-D grid over (block row, chunk of columns).  Each thread
// copies whole units: 16 bytes where B0 and every pointer allow it, else
// 4 or 2 bytes.  Level boundaries are multiples of B0, so a unit never
// straddles two levels, and its level is floor(log2(u / B0u + 1)) with B0u
// the level-0 width in units.  Loads and stores are both coalesced.
//
// K7 design: a grid-stride loop over output elements.  Every thread block
// first stages the starts/ends tables in shared memory (2 x 4 bytes per
// block row); each element then finds its owner by an upper-bound binary
// search — owner = (the number of starts <= i) - 1, so an empty block,
// whose start equals the next block's, never owns an element.  Reads of the
// plane are contiguous within a block's segment, so they coalesce too.
//
// K7 counters (K15, kCount = true): one iteration of a thread block is one
// 256-element tile of the output, the reference's DEFAULT_SEG_TILE, and its
// thread 0 holds the tile's first index t0.  Thread 0 sums the tiles' block
// spans hi - lo, with lo = max(#{starts <= t0} - 1, 0) (t0's owner) and
// hi = #{starts <= t0 + 255}, as _seg_ctr_oracle (flatten/ops.py:36)
// defines them — empty blocks and the ragged tail tile included — in a
// register across the grid-stride loop; block 0 adds the launch; one
// ctr_accum after the loop.  flatten.span_rows is added by the wrapper.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kCompactThreads = 256;
constexpr int kCompactUnitsPerBlock = kCompactThreads * 4;
constexpr int kGatherThreads = 256;
constexpr int kGatherMaxGrid = 4096;

struct LevelPtrs {
  const char* p[kMaxLevels];
};

template <typename U>
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(LevelPtrs lv, U* __restrict__ out, int64_t cap_units, int64_t b0_units,
               int64_t chunks) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t u0 = (blockIdx.x % chunks) * kCompactUnitsPerBlock;
  const int64_t u_end = u0 + kCompactUnitsPerBlock;
  const int64_t u1 = u_end < cap_units ? u_end : cap_units;
  for (int64_t u = u0 + threadIdx.x; u < u1; u += kCompactThreads) {
    const int level = 63 - __clzll(u / b0_units + 1);
    const int64_t width = b0_units << level;
    const int64_t li = u - b0_units * ((int64_t{1} << level) - 1);
    out[row * cap_units + u] = reinterpret_cast<const U*>(lv.p[level])[row * width + li];
  }
}

static_assert(kGatherThreads == 256, "K7's counters take one block iteration as one 256-wide tile");

// The number of k < nblocks with tables[k] <= i (tables sorted ascending).
__device__ __forceinline__ int count_le(const int* tables, int nblocks, int64_t i) {
  int lo = 0, hi = nblocks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(tables[mid]) <= i) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, bool kCount>
__global__ void __launch_bounds__(kGatherThreads)
segmented_gather_kernel(const T* __restrict__ compact, const int* __restrict__ starts,
                        const int* __restrict__ ends, T* __restrict__ out,
                        int nblocks, int64_t cap, int64_t n_out, int* __restrict__ ctr) {
  extern __shared__ int tables[];  // starts[0, nblocks) then ends[0, nblocks)
  for (int k = threadIdx.x; k < nblocks; k += kGatherThreads) {
    tables[k] = starts[k];
    tables[nblocks + k] = ends[k];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGatherThreads;
  int64_t rows_touched = 0;  // kCount: thread 0's sum over this block's tiles
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x;
       i < n_out; i += stride) {
    const int lo = count_le(tables, nblocks, i);  // first k with starts[k] > i
    const int owner = lo > 0 ? lo - 1 : 0;
    if constexpr (kCount) {
      if (threadIdx.x == 0)
        rows_touched += count_le(tables, nblocks, i + kGatherThreads - 1) - owner;
    }
    T v = T(0);
    if (i < static_cast<int64_t>(tables[nblocks + owner])) {
      const int64_t off = i - static_cast<int64_t>(tables[owner]);
      const int64_t pos = off < cap - 1 ? off : cap - 1;
      v = compact[static_cast<int64_t>(owner) * cap + pos];
    }
    out[i] = v;
  }
  if constexpr (kCount) {
    const int v[2] = {threadIdx.x == 0 && blockIdx.x == 0 ? 1 : 0,
                      static_cast<int>(rows_touched)};
    constexpr int slots[2] = {kFlattenLaunches, kFlattenRowsTouched};
    ctr_accum<kGatherThreads>(ctr, slots, v);
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename U>
int launch_compact(const LevelPtrs& lv, void* out, int64_t nblocks, int64_t b0_bytes,
                   int64_t cap_bytes, cudaStream_t stream) {
  const int64_t cap_units = cap_bytes / static_cast<int64_t>(sizeof(U));
  const int64_t chunks = (cap_units + kCompactUnitsPerBlock - 1) / kCompactUnitsPerBlock;
  compact_kernel<U><<<static_cast<unsigned>(nblocks * chunks), kCompactThreads, 0, stream>>>(
      lv, static_cast<U*>(out), cap_units, b0_bytes / static_cast<int64_t>(sizeof(U)), chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* compact, const void* starts, const void* ends, void* out,
                  int64_t nblocks, int64_t cap, int* ctr, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(nblocks);
  auto kernel = ctr != nullptr ? segmented_gather_kernel<T, true> : segmented_gather_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t n_out = nblocks * cap;
  const int64_t want = (n_out + kGatherThreads - 1) / kGatherThreads;
  const unsigned grid = static_cast<unsigned>(want < kGatherMaxGrid ? want : kGatherMaxGrid);
  kernel<<<grid, kGatherThreads, smem, stream>>>(
      static_cast<const T*>(compact), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<T*>(out), static_cast<int>(nblocks), cap,
      n_out, ctr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// level_ptrs: nlevels device pointers, level b shaped (nblocks, b0 * 2^b).
// out: (nblocks, cap) with cap = b0 (2^nlevels - 1).  esize: 2 or 4 bytes.
extern "C" int rt_compact_blocks(void* const* level_ptrs, int nlevels, void* out,
                                 int64_t nblocks, int64_t b0, int esize, void* stream) {
  if (nlevels < 1 || nlevels > kMaxLevels || b0 < 1 || (esize != 2 && esize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cap = b0 * ((int64_t{1} << nlevels) - 1);
  if (nblocks <= 0) return 0;
  LevelPtrs lv{};
  bool all16 = aligned(out, 16), all4 = aligned(out, 4);
  for (int l = 0; l < nlevels; ++l) {
    lv.p[l] = static_cast<const char*>(level_ptrs[l]);
    all16 = all16 && aligned(lv.p[l], 16);
    all4 = all4 && aligned(lv.p[l], 4);
  }
  const int64_t b0_bytes = b0 * esize, cap_bytes = cap * esize;
  auto s = static_cast<cudaStream_t>(stream);
  if (all16 && b0_bytes % 16 == 0) return launch_compact<uint4>(lv, out, nblocks, b0_bytes, cap_bytes, s);
  if (all4 && b0_bytes % 4 == 0) return launch_compact<uint32_t>(lv, out, nblocks, b0_bytes, cap_bytes, s);
  return launch_compact<uint16_t>(lv, out, nblocks, b0_bytes, cap_bytes, s);
}

// compact: (nblocks, cap); starts, ends: (nblocks,) int32; out: (nblocks * cap,).
// ctr: a zeroed (kCtrSlots,) int32 counter block, or null for no counters.
extern "C" int rt_segmented_gather(const void* compact, const void* starts, const void* ends,
                                   void* out, int64_t nblocks, int64_t cap, int esize,
                                   void* ctr, void* stream) {
  if (nblocks <= 0 || cap <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(ctr);
  if (esize == 4) return launch_gather<uint32_t>(compact, starts, ends, out, nblocks, cap, c, s);
  if (esize == 2) return launch_gather<uint16_t>(compact, starts, ends, out, nblocks, cap, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
