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
// K7 design: a thread block per output range of kRangeBytes (4096 f32 or
// 8192 bf16 items), the grid covering the whole output.  A block finds the
// owners of its first and last element by two upper-bound searches over
// `starts` (owner = (the number of starts <= i) - 1, so an empty block,
// whose start equals the next block's, never owns an element), then walks
// those owners in order.  Owner o's region [starts[o], next) (next = the
// following start, or the output's end) cut to the range gives at most
// three pieces: the live items [starts[o], min(ends[o], next)), copied from
// o's row with coalesced loads and stores; live items past cap (which a
// consistent table never has) filled with o's last item, as the reference
// clamps; and the gap up to next, zeros.  Only the owners' table entries
// are read; nothing is staged in shared memory.  Copies are 4-byte (or
// 2-byte) loads and stores on consecutive threads, 8 loads a thread in
// flight: on the H100, 16-byte stores fed by aligned 16-byte loads and a
// funnel shift by the owner's misalignment measured 12 % slower, and
// ranges of 8, 32 or 64 KB 3 to 9 % slower (tools/freeze_variants.py).
//
// Two source forms of one kernel (a template over the source): the
// (nblocks, cap) plane (PlaneSrc: the arena's freeze, after the paged
// gather) and the bucket levels themselves (LevelSrc: the GGArray freeze,
// kernels/flatten/ops.py::flatten_segmented).  In the levels, offset off of
// a row lies in level b = floor(log2(off / B0 + 1)) at li = off - B0 (2^b -
// 1), as in compact_kernel, so a live piece splits at the level boundaries
// into runs contiguous in both source and output, and the freeze neither
// writes nor reads a plane.
//
// K7 counters (K15, kCount = true): _seg_ctr_oracle (flatten/ops.py:36)
// sums over the 256-element tiles of the output (the ragged tail tile too)
// hi - lo, with lo = max(#{starts <= t0} - 1, 0) and hi = #{starts <= t0 +
// 255}.  A range is a whole number of tiles, so a block's share is its
// tiles, minus the tiles that lie before starts[0] (none for a prefix
// table), plus its walked owners o >= #{starts <= r0} whose start is not
// the first element of a tile: hi - lo - 1 of a tile counts the starts in
// (t0, t0 + 255].  Thread 0 holds that sum from its walk, block 0 adds the
// launch, one ctr_accum a block.  flatten.span_rows is added by the
// wrapper.  kernels/flatten/kernel.py::gather_pieces, range_rows and
// level_runs are the plan in Python (tests/test_torch_freeze_plan.py).
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kCompactThreads = 256;
constexpr int kCompactUnitsPerBlock = kCompactThreads * 4;
constexpr int kGatherThreads = 256;
constexpr int kRangeBytes = 16384;  // output bytes per block of K7
constexpr int kGatherUnroll = 8;    // loads a thread issues before its stores
constexpr int kSegTile = 256;       // the counters' tile (the reference's DEFAULT_SEG_TILE)

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

// K7's sources: row o's items from offset `off` (< cap) on, as a pointer
// and the number of items contiguous there.
template <typename T>
struct PlaneSrc {  // the (nblocks, cap) plane
  const T* plane;
  int64_t cap;
  __device__ __forceinline__ const T* run(int o, int64_t off, int64_t* len) const {
    *len = cap - off;
    return plane + static_cast<int64_t>(o) * cap + off;
  }
};

template <typename T>
struct LevelSrc {  // the bucket levels, level b shaped (nblocks, B0 2^b)
  LevelPtrs lv;
  int64_t b0;
  int64_t cap;
  __device__ __forceinline__ const T* run(int o, int64_t off, int64_t* len) const {
    const int b = 63 - __clzll(off / b0 + 1);
    const int64_t first = b0 * ((int64_t{1} << b) - 1), width = b0 << b;
    *len = first + width - off;
    return reinterpret_cast<const T*>(lv.p[b]) + static_cast<int64_t>(o) * width + (off - first);
  }
};

// The number of k < nblocks with starts[k] <= i (starts sorted ascending).
__device__ __forceinline__ int count_le(const int* __restrict__ starts, int nblocks, int64_t i) {
  int lo = 0, hi = nblocks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(__ldg(starts + mid)) <= i) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out[a, b) = src[0, b - a): the block's threads on consecutive items,
// kGatherUnroll loads issued before their stores.
template <typename T>
__device__ __forceinline__ void copy_piece(T* __restrict__ out, int64_t a, int64_t b,
                                           const T* __restrict__ src) {
  constexpr int64_t kStep = static_cast<int64_t>(kGatherThreads) * kGatherUnroll;
  const int64_t n = b - a;
  int64_t j = threadIdx.x;
  for (; j + kStep - kGatherThreads < n; j += kStep) {
    T v[kGatherUnroll];
#pragma unroll
    for (int k = 0; k < kGatherUnroll; ++k) v[k] = __ldcs(src + j + k * kGatherThreads);
#pragma unroll
    for (int k = 0; k < kGatherUnroll; ++k) __stcs(out + a + j + k * kGatherThreads, v[k]);
  }
  for (; j < n; j += kGatherThreads) __stcs(out + a + j, __ldcs(src + j));
}

template <typename T>
__device__ __forceinline__ void fill_piece(T* __restrict__ out, int64_t a, int64_t b, T v) {
  for (int64_t i = a + threadIdx.x; i < b; i += kGatherThreads) __stcs(out + i, v);
}

template <typename T, bool kCount, typename Src>
__global__ void __launch_bounds__(kGatherThreads)
segmented_gather_kernel(Src src, const int* __restrict__ starts, const int* __restrict__ ends,
                        T* __restrict__ out, int nblocks, int64_t n_out, int* __restrict__ ctr) {
  constexpr int64_t kRange = kRangeBytes / static_cast<int64_t>(sizeof(T));
  static_assert(kRange % kSegTile == 0, "a range is a whole number of counter tiles");
  __shared__ int s_u[2];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRange;
  const int64_t r1 = r0 + kRange < n_out ? r0 + kRange : n_out;
  const int64_t ntiles = (r1 - r0 + kSegTile - 1) / kSegTile;
  const int64_t r_end = r0 + ntiles * kSegTile - 1;  // the last tile's last index
  if (threadIdx.x == 0) s_u[0] = count_le(starts, nblocks, r0);
  if (threadIdx.x == 32) s_u[1] = count_le(starts, nblocks, r_end);
  __syncthreads();
  const int u0 = s_u[0], u_end = s_u[1];
  const int64_t s_first = __ldg(starts);
  if (u0 == 0) fill_piece(out, r0, s_first < r1 ? s_first : r1, T(0));  // before starts[0]
  int rows_touched = 0;  // kCount: thread 0's
  for (int o = u0 > 0 ? u0 - 1 : 0; o < (u_end > 1 ? u_end : 1); ++o) {
    const int64_t s = __ldg(starts + o);
    const int64_t next = o + 1 < nblocks ? static_cast<int64_t>(__ldg(starts + o + 1)) : n_out;
    const int64_t e = __ldg(ends + o);
    if (kCount && o >= u0 && s % kSegTile != 0) ++rows_touched;
    const int64_t live_end = e < s ? s : e < next ? e : next;
    const int64_t copy_end = live_end < s + src.cap ? live_end : s + src.cap;
    int64_t i = s > r0 ? s : r0;
    const int64_t i_copy = copy_end < r1 ? copy_end : r1;
    while (i < i_copy) {  // the live items, one contiguous source run at a time
      int64_t len;
      const T* p = src.run(o, i - s, &len);
      const int64_t j = i + len < i_copy ? i + len : i_copy;
      copy_piece(out, i, j, p);
      i = j;
    }
    const int64_t i_live = live_end < r1 ? live_end : r1;
    if (i < i_live) {
      int64_t len;
      fill_piece(out, i, i_live, *src.run(o, src.cap - 1, &len));
      i = i_live;
    }
    fill_piece(out, i, next < r1 ? next : r1, T(0));
  }
  if constexpr (kCount) {
    if (threadIdx.x == 0) {
      const int64_t before = s_first > r0 ? (s_first - r0 + kSegTile - 1) / kSegTile : 0;
      rows_touched += static_cast<int>(ntiles - (before < ntiles ? before : ntiles));
    }
    const int v[2] = {threadIdx.x == 0 && blockIdx.x == 0 ? 1 : 0,
                      threadIdx.x == 0 ? rows_touched : 0};
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

template <typename T, typename Src>
int launch_gather(const Src& src, const void* starts, const void* ends, void* out,
                  int64_t nblocks, int* ctr, cudaStream_t stream) {
  const int64_t n_out = nblocks * src.cap;
  const int64_t range = kRangeBytes / static_cast<int64_t>(sizeof(T));
  const int64_t grid = (n_out + range - 1) / range;
  if (grid > 0x7fffffffLL || nblocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = ctr != nullptr ? segmented_gather_kernel<T, true, Src>
                               : segmented_gather_kernel<T, false, Src>;
  kernel<<<static_cast<unsigned>(grid), kGatherThreads, 0, stream>>>(
      src, static_cast<const int*>(starts), static_cast<const int*>(ends), static_cast<T*>(out),
      static_cast<int>(nblocks), n_out, ctr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_gather_range_bytes() { return kRangeBytes; }

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

// compact: (nblocks, cap); starts, ends: (nblocks,) int32, starts sorted
// from 0; out: (nblocks * cap,).  ctr: a zeroed (kCtrSlots,) int32 counter
// block, or null for no counters.
extern "C" int rt_segmented_gather(const void* compact, const void* starts, const void* ends,
                                   void* out, int64_t nblocks, int64_t cap, int esize,
                                   void* ctr, void* stream) {
  if (nblocks <= 0 || cap <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(ctr);
  if (esize == 4)
    return launch_gather<uint32_t>(PlaneSrc<uint32_t>{static_cast<const uint32_t*>(compact), cap},
                                   starts, ends, out, nblocks, c, s);
  if (esize == 2)
    return launch_gather<uint16_t>(PlaneSrc<uint16_t>{static_cast<const uint16_t*>(compact), cap},
                                   starts, ends, out, nblocks, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same gather straight from the bucket levels: level_ptrs as for
// rt_compact_blocks, out (nblocks * cap,) with cap = b0 (2^nlevels - 1).
extern "C" int rt_segmented_gather_levels(void* const* level_ptrs, int nlevels, int64_t b0,
                                          const void* starts, const void* ends, void* out,
                                          int64_t nblocks, int esize, void* ctr, void* stream) {
  if (nlevels < 1 || nlevels > kMaxLevels || b0 < 1 || (esize != 2 && esize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0) return 0;
  LevelPtrs lv{};
  for (int l = 0; l < nlevels; ++l) lv.p[l] = static_cast<const char*>(level_ptrs[l]);
  const int64_t cap = b0 * ((int64_t{1} << nlevels) - 1);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(ctr);
  if (esize == 4)
    return launch_gather<uint32_t>(LevelSrc<uint32_t>{lv, b0, cap}, starts, ends, out, nblocks, c, s);
  return launch_gather<uint16_t>(LevelSrc<uint16_t>{lv, b0, cap}, starts, ends, out, nblocks, c, s);
}
