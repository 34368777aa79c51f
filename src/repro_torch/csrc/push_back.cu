// K3 — fused push-back: per-block insertion offsets and the scatter into
// the geometric bucket levels.
//
// Replaces: src/repro/kernels/push_back/kernel.py::push_back_pallas.  The
// TPU kernel computes the offsets with a VPU cumsum, builds the insert
// permutation as a one-hot reduction or an MXU matmul, and writes each
// level as a shifted-window gather, because TPU Pallas has no dynamic
// scatter.  None of that is needed here: the GPU scatters directly.
//
// Bound on the card: bytes.  Per lane it reads the mask byte and writes the
// position; per live lane it reads the item and writes it into its level
// (plus the sizes in and out).  There is no arithmetic to speak of.
//
// What it computes: a live lane lands at in-block position p = size +
// offset (offset: the exclusive scan of the row's mask); its level is L =
// 63 - clz(p / B0 + 1), its slot in the level p - B0 (2^L - 1).  Writes
// past the last level are dropped, as the reference's mode="drop" scatter
// drops them, but the lane still reports p and the new size still counts
// it.  Items are copied as bits, so every payload type comes out exact.
// All addressing is 64-bit.  The level table is a kernel parameter of
// [group][level] pointers: a payload group sharing the mask (the KV
// cache's k and v) is one more row of it, with its own item size and copy
// unit.
//
// Design: the tile-parallel row scan of common.cuh.  The grid is (rows x
// tiles) of NT * 16 lanes; where a row has more than one tile a count pass
// runs first, else the write pass is the only launch (the Engine's decode
// append, m = 1).  A write block scans its tile (thread t holds lanes t, t
// + NT, ...), writes the positions coalesced, and copies the live items
// straight into their level slots: the destination is arithmetic.  Two
// copies, chosen on the host from the items:
//   - direct, where every group's item is one copy unit of at most 4 bytes
//     (a wave of f32 or bf16 scalars): each thread loads its own live
//     lanes' items, sixteen in flight, then stores them; consecutive live
//     lanes of a warp land in consecutive slots, so loads and stores
//     coalesce;
//   - the unit loop, for wider items: the block lists its live lanes in
//     rank order in shared memory, then runs over (group, item, unit) with
//     consecutive threads on consecutive units of the widest copy unit (16
//     bytes where sizes and pointers allow), four units a thread per round,
//     every load issued before its stores.  A row's k and v at m = 1, (2,
//     128) bf16, are 64 16-byte units for a block of 64 threads.
// The host sizes the block from m and the item size
// (kernels/push_back/kernel.py::push_back_plan).
//
// Counters (K15, kCount = true), each block once through ctr_accum: its
// tile's lanes and live lanes; the row's last tile, which knows size and
// total, the level writes — the write interval [size, size + count)
// clipped to each level, as the reference's _ctr_pairs
// (push_back/kernel.py:63); block 0 the wave.  No lane is padded here, so
// push_back.padded_lanes stays 0 (obs/device.py).
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxGroups = 4;
constexpr int kUnroll = 4;  // copy units a thread has in flight

struct PushBackTable {
  char* levels[kMaxGroups][kMaxLevels];
  const char* elems[kMaxGroups];
  int64_t item_bytes[kMaxGroups];
  int64_t units[kMaxGroups];  // copy units an item: item_bytes / unit
  int unit[kMaxGroups];       // copy unit in bytes: 16, 4, 2 or 1
  int shift[kMaxGroups];      // log2(units), or -1
  int ngroups;
  int nlevels;
};

// One copy unit of `unit` bytes (16, 4, 2 or 1; kernels/common.py::copy_unit
// picks the widest that the item size and every pointer allow), carried in
// a uint4.  Loads go through the read-only path: the kernel never reads what
// it writes.
__device__ __forceinline__ uint4 load_unit(const char* p, int unit) {
  uint4 v = {0u, 0u, 0u, 0u};
  switch (unit) {
    case 16: v = __ldg(reinterpret_cast<const uint4*>(p)); break;
    case 4: v.x = __ldg(reinterpret_cast<const unsigned int*>(p)); break;
    case 2: v.x = __ldg(reinterpret_cast<const unsigned short*>(p)); break;
    default: v.x = __ldg(reinterpret_cast<const unsigned char*>(p)); break;
  }
  return v;
}
__device__ __forceinline__ void store_unit(char* p, uint4 v, int unit) {
  switch (unit) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.x); break;
    default: *reinterpret_cast<unsigned char*>(p) = static_cast<unsigned char>(v.x); break;
  }
}

// The level of in-block position p >= 0, cached over the level's range
// [lo, hi): a thread's positions rise, so the division runs once a level.
struct LevelCache {
  int64_t lo = 1, hi = 0;
  int level = 0;
};

__device__ __forceinline__ int level_of(int64_t p, int64_t b0, LevelCache& c) {
  if (p < c.lo || p >= c.hi) {
    c.level = 63 - __clzll(p / b0 + 1);
    c.lo = b0 * ((int64_t{1} << c.level) - 1);
    c.hi = c.lo + (b0 << c.level);
  }
  return c.level;
}

// U: the copy unit of the direct copy (every group's item is one U), or
// void for the unit loop.
template <int NT, typename U, bool kCount>
__global__ void __launch_bounds__(NT)
push_back_kernel(PushBackTable t, const unsigned char* __restrict__ mask,
                 const int* __restrict__ sizes, const int* __restrict__ counts,
                 int* __restrict__ pos_out, int* __restrict__ new_sizes, int64_t m, int tiles,
                 int64_t b0, int* __restrict__ ctr) {
  constexpr bool kDirect = !std::is_void_v<U>;
  constexpr int kTile = NT * kScanPer;
  __shared__ int lane_of[kDirect ? 1 : kTile];  // the unit loop: live lane of tile rank k
  const int64_t row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const int size = sizes[row];
  const TileScan s = tile_scan<NT>(mask + row * m, m, tile,
                                  counts != nullptr ? counts + row * tiles : nullptr);
  const int tid = threadIdx.x;
  const int64_t tile_base = row * m + s.tile_lane0;  // the tile's first lane in the wave

  // positions, -1 where masked
  int* pt = pos_out + tile_base;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const int o = i * NT + tid;
    if (o < s.lanes) {
      const bool live = (s.live >> i) & 1u;
      pt[o] = live ? size + s.rank[i] : -1;
      if constexpr (!kDirect) {
        if (live) lane_of[s.rank[i] - s.tile_first] = o;
      }
    }
  }
  const bool last_tile = tile == tiles - 1;
  if (last_tile && tid == 0) new_sizes[row] = size + s.tile_first + s.tile_total;

  LevelCache lc;
  if constexpr (kDirect) {
    for (int g = 0; g < t.ngroups; ++g) {
      const U* src = reinterpret_cast<const U*>(t.elems[g]) + tile_base;
      U val[kScanPer];
#pragma unroll
      for (int i = 0; i < kScanPer; ++i)  // every load first ...
        if ((s.live >> i) & 1u) val[i] = __ldg(src + i * NT + tid);
#pragma unroll
      for (int i = 0; i < kScanPer; ++i) {  // ... then the stores
        const int pk = size + s.rank[i];
        if (((s.live >> i) & 1u) && pk >= 0) {
          const int level = level_of(pk, b0, lc);
          if (level < t.nlevels)
            reinterpret_cast<U*>(t.levels[g][level])[row * (b0 << level) + (pk - lc.lo)] = val[i];
        }
      }
    }
  } else {
    __syncthreads();  // lane_of
    // work index w over (group, tile rank, unit), group-major
    const int n = s.tile_total;
    const int p0 = size + s.tile_first;  // position of tile rank 0
    int64_t end[kMaxGroups];
    int64_t w_total = 0;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < t.ngroups) w_total += static_cast<int64_t>(n) * t.units[g];
      end[g] = g < t.ngroups ? w_total : INT64_MAX;
    }
    for (int64_t w0 = tid; w0 < w_total; w0 += static_cast<int64_t>(NT) * kUnroll) {
      uint4 val[kUnroll];
      char* dst[kUnroll];
      int unit[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // every load first ...
        const int64_t w = w0 + static_cast<int64_t>(j) * NT;
        dst[j] = nullptr;
        unit[j] = 1;
        if (w < w_total) {
          const int g = (w >= end[0]) + (w >= end[1]) + (w >= end[2]);
          const int64_t q = w - (g == 0 ? 0 : g == 1 ? end[0] : g == 2 ? end[1] : end[2]);
          const int64_t units = t.units[g];
          const int64_t kk = t.shift[g] >= 0 ? q >> t.shift[g] : q / units;
          const int64_t u = q - kk * units;
          const int pk = p0 + static_cast<int>(kk);
          if (pk >= 0) {
            const int level = level_of(pk, b0, lc);
            if (level < t.nlevels) {
              const int64_t ib = t.item_bytes[g];
              const int64_t slot = row * (b0 << level) + (pk - lc.lo);
              unit[j] = t.unit[g];
              dst[j] = t.levels[g][level] + slot * ib + u * unit[j];
              val[j] = load_unit(t.elems[g] + (tile_base + lane_of[kk]) * ib + u * unit[j], unit[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)  // ... then the stores
        if (dst[j] != nullptr) store_unit(dst[j], val[j], unit[j]);
    }
  }

  if constexpr (kCount) {
    int c[4] = {0, 0, 0, 0};
    if (tid == 0) {
      c[0] = blockIdx.x == 0 ? 1 : 0;
      c[1] = s.lanes;
      c[2] = s.tile_total;
      if (last_tile) {
        const int64_t lo = size;
        const int64_t hi = lo + s.tile_first + s.tile_total;
        int64_t writes = 0;
        for (int l = 0; l < t.nlevels; ++l) {
          const int64_t start = b0 * ((int64_t{1} << l) - 1);
          const int64_t stop = start + (b0 << l);
          const int64_t wl = (hi < stop ? hi : stop) - (lo > start ? lo : start);
          if (wl > 0) writes += wl;
        }
        c[3] = static_cast<int>(writes);
      }
    }
    constexpr int slots[4] = {kPushBackWaves, kPushBackLanes, kPushBackActiveLanes,
                              kPushBackLevelWrites};
    ctr_accum<NT>(ctr, slots, c);
  }
}

// The write pass for copy unit U (void: the unit loop), with or without counters.
template <int NT, typename U>
void write_pass(const PushBackTable& t, unsigned grid, const unsigned char* mask, const int* sizes,
                const int* counts, int* pos_out, int* new_sizes, int64_t m, int tiles, int64_t b0,
                int* ctr, cudaStream_t stream) {
  auto kernel = ctr != nullptr ? push_back_kernel<NT, U, true> : push_back_kernel<NT, U, false>;
  kernel<<<grid, NT, 0, stream>>>(t, mask, sizes, counts, pos_out, new_sizes, m, tiles, b0, ctr);
}

template <int NT>
int launch(const PushBackTable& t, const unsigned char* mask, const int* sizes, int* counts,
           int* pos_out, int* new_sizes, int64_t nblocks, int64_t m, int64_t b0, int* ctr,
           cudaStream_t stream) {
  const int64_t tiles = (m + NT * kScanPer - 1) / (NT * kScanPer);
  if (nblocks * tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto grid = static_cast<unsigned>(nblocks * tiles);
  const int nt = static_cast<int>(tiles);
  if (tiles > 1) {
    if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    row_tile_count_kernel<NT><<<grid, NT, 0, stream>>>(mask, m, nt, counts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int* cn = tiles > 1 ? counts : nullptr;
  // the direct copy where every group's item is one unit of at most 4
  // bytes, all of one width
  bool direct = true;
  for (int g = 0; g < t.ngroups; ++g) direct = direct && t.units[g] == 1 && t.unit[g] == t.unit[0];
  switch (direct ? t.unit[0] : 0) {
    case 4: write_pass<NT, uint32_t>(t, grid, mask, sizes, cn, pos_out, new_sizes, m, nt, b0, ctr, stream); break;
    case 2: write_pass<NT, uint16_t>(t, grid, mask, sizes, cn, pos_out, new_sizes, m, nt, b0, ctr, stream); break;
    case 1: write_pass<NT, unsigned char>(t, grid, mask, sizes, cn, pos_out, new_sizes, m, nt, b0, ctr, stream); break;
    default: write_pass<NT, void>(t, grid, mask, sizes, cn, pos_out, new_sizes, m, nt, b0, ctr, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// level_ptrs: ngroups x nlevels device pointers, group-major.
// elem_ptrs, item_bytes, unit_bytes: one per group; unit_bytes[g] (16, 4,
// 2 or 1) divides item_bytes[g] and every pointer of group g.  Every
// pointer is device memory; the tables themselves are host arrays copied
// into the kernel parameter.  threads: 64, 128 or 256 and tiles: ceil(m /
// (16 threads)), as kernel.py::push_back_plan makes them (a plan that
// differs is refused); where tiles > 1, counts is (nblocks * tiles) int32
// scratch.
// ctr: a zeroed (kCtrSlots,) int32 counter block, or null for no counters.
extern "C" int rt_push_back(void* const* level_ptrs, void* const* elem_ptrs,
                            const int64_t* item_bytes, const int* unit_bytes, int ngroups,
                            int nlevels, const void* mask, const void* sizes, void* counts,
                            void* pos_out, void* new_sizes, int64_t nblocks, int64_t m, int64_t b0,
                            int threads, int64_t tiles, void* ctr, void* stream) {
  if (ngroups < 1 || ngroups > kMaxGroups || nlevels < 1 || nlevels > kMaxLevels || b0 < 1 ||
      threads < 1 || tiles != (m + int64_t{threads} * kScanPer - 1) / (int64_t{threads} * kScanPer))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0 || m <= 0) return 0;
  PushBackTable t{};
  t.ngroups = ngroups;
  t.nlevels = nlevels;
  for (int g = 0; g < ngroups; ++g) {
    for (int l = 0; l < nlevels; ++l) t.levels[g][l] = static_cast<char*>(level_ptrs[g * nlevels + l]);
    const int64_t ib = item_bytes[g];
    const int u = unit_bytes[g];
    if (ib <= 0 || (u != 16 && u != 4 && u != 2 && u != 1) || ib % u != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    t.elems[g] = static_cast<const char*>(elem_ptrs[g]);
    t.item_bytes[g] = ib;
    t.unit[g] = u;
    t.units[g] = ib / u;
    t.shift[g] = (t.units[g] & (t.units[g] - 1)) == 0 ? __builtin_ctzll(t.units[g]) : -1;
  }
  const auto* mk = static_cast<const unsigned char*>(mask);
  const auto* sz = static_cast<const int*>(sizes);
  auto* cn = static_cast<int*>(counts);
  auto* pos = static_cast<int*>(pos_out);
  auto* ns = static_cast<int*>(new_sizes);
  auto* c = static_cast<int*>(ctr);
  auto s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 64: return launch<64>(t, mk, sz, cn, pos, ns, nblocks, m, b0, c, s);
    case 128: return launch<128>(t, mk, sz, cn, pos, ns, nblocks, m, b0, c, s);
    case 256: return launch<256>(t, mk, sz, cn, pos, ns, nblocks, m, b0, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// An empty kernel on `blocks` blocks of `threads`: the launch floor that
// chip_smoke.py times beside K3's decode append.
extern "C" int rt_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
