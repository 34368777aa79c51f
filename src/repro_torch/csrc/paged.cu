// K8/K9 and K12 — the slab arena's paged gather and slab append.
//
// Both kernels address the pool through an extent table: a device int64
// array [ptr_0 .. ptr_{E-1}, start_0 .. start_E] holding each extent's base
// pointer and the global id of its first slab (start_E = n_slabs), built on
// the host by kernels/common.py::extent_table and cached per extent
// geometry.  A slab id s resolves by an upper-bound search over the starts
// (about ten steps at 700 extents): the last e with start_e <= s, then
// ptr_e + (s - start_e) * slab_bytes.  One flat pool is the case E = 1.
// This replaces the reference's per-extent operand list and its parked
// per-extent DMA (src/repro/kernels/common.py::extent_row).
//
// K8/K9 replace src/repro/kernels/paged/kernel.py::paged_gather_pallas and
// ::paged_gather_pallas_extents: (N, P) page table -> (N, P*T, item) views,
// page p of row n being slab pages[n, p], or zeros under page -1 and under
// ids past the pool (with one flat pool the reference clips ids past the
// pool to the last slab instead; clip_high selects that).  Bound: bytes —
// every output page written once, every live page read once.  Items are
// copied as bits in pieces of 16 bytes where the slab size and every
// pointer allow it (else 4, 2 or 1 bytes), so f32, int32 and bf16 come out
// exact.  All addressing is 64-bit.
//
// Design: a block per kGatherBlockPieces pieces of the output (a range of
// 8 KB of 16-byte pieces, whatever the slab size), one block per range
// (kernels/paged/kernel.py::gather_plan), so each block is short-lived and
// the block scheduler balances the card.  (A persistent grid of a few
// blocks a SM walking the ranges measured 5.5 % slower on the H100:
// PERF.md.)  A block first resolves the pages its range touches — the page
// id, the extent search (common.cuh::slab_address) — one thread a page,
// into shared memory; then each thread copies kGatherPer pieces
// (consecutive threads on consecutive pieces), every load issued before its
// stores.  Counters (K15, kCount = true): the thread that resolves a page
// whose first piece lies in the range counts it as a live tile if it
// resolved to a slab, else as a masked tile, and block 0 counts the launch;
// each block adds its sums with ctr_accum once, so the atomics grow with
// the blocks, not with the pages.  That is the reference's count for K8 (pages >= 0, ids past one
// flat pool clipped) and its oracle's for K9 (_gather_ctr over the resolved
// extent table), without its vmem row padding.  The tests replay the
// plan's arithmetic (tests/test_torch_paged_split.py).
//
// K12 replaces src/repro/kernels/paged/kernel.py::slab_append_pallas: a
// wave (N, m, item) with its mask lands at positions sizes[n] + exclusive
// scan of the mask, through slab ownership — slot j of slab s holds
// logical position bases[s] + j of array owners[s].  Slabs with owner -1
// are never written; owners past N are clamped to N - 1, as the reference
// clamps them; two slabs with one window both get it; live lanes that land
// past every claimed slab are written nowhere, yet keep their position and
// count.  Bound: bytes — the mask and the wave read once, the live items
// and the positions written once.  Up to three launches on one stream,
// with no scratch the size of the wave:
//   1. the count pass of common.cuh's tile-parallel row scan, where a row
//      has more than one tile of NT * 16 lanes;
//   2. slab_scan — grid (N x tiles): each block scans its tile, writes the
//      positions (-1 where masked), and publishes the row's rank at every
//      1024-lane segment's first lane (segpre, (N, nseg + 1) int32, the
//      last entry the row's count); the row's last tile writes its new size;
//   3. slab_copy — slab-major, no scratch: a block of 128 threads per
//      chunk of a slab's slots (the whole slab for 4-byte items and
//      2048-slot slabs; 16 slots of a 2 KB KV item).  Owner o and base b
//      give the chunk its ranks [max(0, b - size_o), min(count_o, b -
//      size_o + T)) cut to the chunk; the block counts over o's segment
//      prefix for the segments holding those ranks (two or three at 0.9
//      density; many where the mask is sparse), re-scans their mask bytes
//      in windows of 2048 lanes to list rank -> lane in shared memory, then
//      copies the items from the wave into the slab in the widest unit,
//      reads in lane order and writes contiguous.  Each step waits on the
//      one before (owner -> size and count -> segments -> mask -> items),
//      so small blocks, sixteen a SM, hide that chain better than large
//      ones (PERF.md).
// This keeps the reference's semantics for any owners/bases table, also
// ones the arena never builds, by construction: each slab copies its own
// window.  Against the bound it re-reads the mask bytes of the segments
// each slab covers (about 1.3 bytes a lane at the main shape) in place of
// a scratch round trip of every live item (8 bytes a live f32 lane).
// kernels/paged/kernel.py::append_plan and the rank search's twin
// (rank_segments) are the plan in Python (tests/test_torch_append_plan.py).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherPer = 2;                                    // pieces a thread
constexpr int kGatherBlockPieces = kGatherThreads * kGatherPer;  // pieces a block
constexpr int kGatherMaxPages = kGatherBlockPieces + 1;          // pages a block touches, at most
constexpr int kCopyThreads = 128;  // 16 blocks a SM to hide the copy block's chain of loads
constexpr int kMaxChunk = 2048;  // slots a copy block, at most (kernel.py::APPEND_MAX_CHUNK)
constexpr int kCopyUnroll = 4;   // units a thread has in flight

// grid (nranges); block r copies pieces [r * kGatherBlockPieces, (r + 1) *
// kGatherBlockPieces) of the output.
template <typename U, bool kCount>
__global__ void __launch_bounds__(kGatherThreads)
paged_gather_kernel(const int64_t* __restrict__ tbl, int next, int64_t n_slabs, int clip_high,
                    const int* __restrict__ pages, U* __restrict__ out, int64_t npages,
                    int64_t slab_units, int shift, int* __restrict__ ctr) {
  __shared__ const U* s_src[kGatherMaxPages];  // null: the page reads zeros
  const int tid = threadIdx.x;
  const int64_t total = npages * slab_units;
  const int64_t slab_bytes = slab_units * static_cast<int64_t>(sizeof(U));
  int tiles = 0, masked = 0;  // counters (kCount)
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGatherBlockPieces;
  const int64_t last = (first + kGatherBlockPieces < total ? first + kGatherBlockPieces : total) - 1;
  const int64_t p0 = shift >= 0 ? first >> shift : first / slab_units;
  const int64_t p1 = shift >= 0 ? last >> shift : last / slab_units;
  for (int64_t p = p0 + tid; p <= p1; p += kGatherThreads) {
    int64_t s = pages[p];
    if (clip_high && s >= n_slabs) s = n_slabs - 1;
    const bool live = s >= 0 && s < n_slabs;
    s_src[p - p0] = live ? reinterpret_cast<const U*>(slab_address(tbl, next, s, slab_bytes)) : nullptr;
    if (kCount && p * slab_units >= first) {  // the page's first piece is in this range
      tiles += live ? 1 : 0;
      masked += live ? 0 : 1;
    }
  }
  __syncthreads();
  const int64_t base = p0 * slab_units;  // the first page's first piece
  U v[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {  // every load first ...
    const int64_t i = first + j * kGatherThreads + tid;
    if (i <= last) {
      const uint32_t local = static_cast<uint32_t>(i - base);  // < kGatherBlockPieces + slab_units
      const uint32_t lp = shift >= 0 ? local >> shift : local / static_cast<uint32_t>(slab_units);
      const U* src = s_src[lp];
      v[j] = src != nullptr ? __ldg(src + (local - lp * static_cast<uint32_t>(slab_units))) : U{};
    }
  }
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {  // ... then the stores
    const int64_t i = first + j * kGatherThreads + tid;
    if (i <= last) out[i] = v[j];
  }
  if constexpr (kCount) {
    int c[3] = {blockIdx.x == 0 && tid == 0 ? 1 : 0, tiles, masked};
    constexpr int slots[3] = {kGatherLaunches, kGatherTiles, kGatherMaskedTiles};
    ctr_accum<kGatherThreads>(ctr, slots, c);
  }
}

// grid (N * tiles); block (row, tile): positions, new sizes, segment prefixes.
template <int NT>
__global__ void __launch_bounds__(NT, 1536 / NT)  // 40 registers: six 256-thread blocks a SM
slab_scan_kernel(const unsigned char* __restrict__ mask, const int* __restrict__ sizes,
                 const int* __restrict__ counts, int* __restrict__ pos_out,
                 int* __restrict__ new_sizes, int* __restrict__ segpre, int64_t m, int tiles,
                 int nseg) {
  const int64_t row = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - row * tiles);
  const int size = sizes[row];
  const TileScan s = tile_scan<NT>(mask + row * m, m, tile,
                                  counts != nullptr ? counts + row * tiles : nullptr);
  int* pt = pos_out + row * m + s.tile_lane0;
  int* seg = segpre + row * (nseg + 1);
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const int o = i * NT + threadIdx.x;
    if (o < s.lanes) {
      pt[o] = (s.live >> i) & 1u ? size + s.rank[i] : -1;
      if (o % kSegLanes == 0) seg[(s.tile_lane0 + o) / kSegLanes] = s.rank[i];  // thread 0
    }
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    seg[nseg] = s.tile_first + s.tile_total;
    new_sizes[row] = size + s.tile_first + s.tile_total;
  }
}

// grid (n_slabs * chunks); block (s, c) fills slots [c * chunk, (c + 1) *
// chunk) of slab s where its owner's wave reaches them.
template <typename U>
__global__ void __launch_bounds__(kCopyThreads)
slab_copy_kernel(const int64_t* __restrict__ tbl, int next, const int* __restrict__ owners,
                 const int* __restrict__ bases, const int* __restrict__ sizes,
                 const int* __restrict__ segpre, const unsigned char* __restrict__ mask,
                 const U* __restrict__ elems, int64_t narrays, int64_t m, int nseg, int64_t slab_size,
                 int64_t item_units, int shift, int chunk, int chunks) {
  constexpr int kWindow = kCopyThreads * kScanPer;  // lanes re-scanned a round
  __shared__ int scan_smem[32];
  __shared__ int lane_of[kMaxChunk];  // the chunk's k-th rank -> its lane in the row
  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x / chunks;
  const int c = static_cast<int>(blockIdx.x - s * chunks);
  const int owner = owners[s];
  // the slab's address, its search overlapping the owner's load
  U* const slab = reinterpret_cast<U*>(
      slab_address(tbl, next, s, slab_size * item_units * static_cast<int64_t>(sizeof(U))));
  if (owner < 0) return;
  const int64_t own = owner < narrays ? owner : narrays - 1;
  const int* seg = segpre + own * (nseg + 1);
  const int64_t size = sizes[own];
  const int64_t count = seg[nseg];
  const int64_t base = bases[s];
  // slot j <-> rank r = base + j - size, live where 0 <= r < count
  int64_t j_lo = static_cast<int64_t>(c) * chunk, j_hi = j_lo + chunk;
  if (j_hi > slab_size) j_hi = slab_size;
  if (size - base > j_lo) j_lo = size - base;
  if (size + count - base < j_hi) j_hi = size + count - base;
  if (j_lo >= j_hi) return;  // the same for every thread of the block
  const int64_t r_lo = base + j_lo - size, r_hi = base + j_hi - size;
  // The segments holding ranks [r_lo, r_hi), counted over the prefix by
  // the whole block (one round of loads, not a chain of them): g0, the last
  // segment starting at or before r_lo, is the number of segments that do,
  // less one; g1, the first starting at or past r_hi (nseg if none), the
  // number of entries below r_hi.  seg is non-decreasing from seg[0] = 0.
  int at_or_before = 0, below = 0;
  for (int g = tid; g <= nseg; g += kCopyThreads) {
    const int v = seg[g];
    at_or_before += g < nseg && v <= r_lo ? 1 : 0;
    below += v < r_hi ? 1 : 0;
  }
  const int g0 = block_sum<kCopyThreads>(at_or_before, scan_smem) - 1;
  const int g1 = block_sum<kCopyThreads>(below, scan_smem);
  const int64_t lane_end = static_cast<int64_t>(g1) * kSegLanes < m ? static_cast<int64_t>(g1) * kSegLanes : m;
  const unsigned char* mrow = mask + own * m;
  int64_t rank = seg[g0];
  for (int64_t w0 = static_cast<int64_t>(g0) * kSegLanes; w0 < lane_end && rank < r_hi; w0 += kWindow) {
    const int64_t lane0 = w0 + static_cast<int64_t>(tid) * kScanPer;
    const uint32_t bits = lane0 < lane_end ? live_bits16(mrow, lane0, lane_end) : 0u;
    int total;
    int64_t r = rank + block_exclusive_scan<kCopyThreads>(__popc(bits), scan_smem, &total);
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      if ((bits >> i) & 1u) {
        if (r >= r_lo && r < r_hi) lane_of[r - r_lo] = static_cast<int>(lane0 + i);
        ++r;
      }
    }
    rank += total;
  }
  __syncthreads();
  U* dst = slab + j_lo * item_units;
  const U* src = elems + own * m * item_units;
  const int64_t n_units = (j_hi - j_lo) * item_units;
  for (int64_t q0 = tid; q0 < n_units; q0 += static_cast<int64_t>(kCopyThreads) * kCopyUnroll) {
    U v[kCopyUnroll];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) {  // every load first ...
      const int64_t q = q0 + static_cast<int64_t>(j) * kCopyThreads;
      if (q < n_units) {
        const int64_t k = shift >= 0 ? q >> shift : q / item_units;
        v[j] = __ldg(src + lane_of[k] * item_units + (q - k * item_units));
      }
    }
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) {  // ... then the stores
      const int64_t q = q0 + static_cast<int64_t>(j) * kCopyThreads;
      if (q < n_units) dst[q] = v[j];
    }
  }
}

template <typename U>
int launch_gather(const int64_t* tbl, int next, int64_t n_slabs, int clip_high,
                  const int* pages, void* out, int64_t npages, int64_t slab_bytes, int* ctr,
                  cudaStream_t stream) {
  const int64_t slab_units = slab_bytes / static_cast<int64_t>(sizeof(U));
  const int64_t nranges = (npages * slab_units + kGatherBlockPieces - 1) / kGatherBlockPieces;
  if (slab_units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (nranges > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int shift = (slab_units & (slab_units - 1)) == 0 ? __builtin_ctzll(slab_units) : -1;
  auto kernel = ctr != nullptr ? paged_gather_kernel<U, true> : paged_gather_kernel<U, false>;
  kernel<<<static_cast<unsigned>(nranges), kGatherThreads, 0, stream>>>(
      tbl, next, n_slabs, clip_high, pages, static_cast<U*>(out), npages, slab_units, shift, ctr);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_scan(const unsigned char* mask, const int* sizes, int* counts, int* pos_out,
                int* new_sizes, int* segpre, int64_t narrays, int64_t m, int nseg,
                cudaStream_t stream) {
  const int64_t tiles = (m + NT * kScanPer - 1) / (NT * kScanPer);
  if (narrays * tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto grid = static_cast<unsigned>(narrays * tiles);
  if (tiles > 1) {
    if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    row_tile_count_kernel<NT><<<grid, NT, 0, stream>>>(mask, m, static_cast<int>(tiles), counts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  slab_scan_kernel<NT><<<grid, NT, 0, stream>>>(mask, sizes, tiles > 1 ? counts : nullptr, pos_out,
                                                new_sizes, segpre, m, static_cast<int>(tiles), nseg);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch_copy(const int64_t* tbl, int next, int64_t n_slabs, const int* owners, const int* bases,
                const int* sizes, const int* segpre, const unsigned char* mask, const void* elems,
                int64_t narrays, int64_t m, int nseg, int64_t slab_size, int64_t item_bytes,
                int chunk, cudaStream_t stream) {
  const int64_t item_units = item_bytes / static_cast<int64_t>(sizeof(U));
  const int shift = (item_units & (item_units - 1)) == 0 ? __builtin_ctzll(item_units) : -1;
  const int64_t chunks = (slab_size + chunk - 1) / chunk;
  if (n_slabs * chunks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  slab_copy_kernel<U><<<static_cast<unsigned>(n_slabs * chunks), kCopyThreads, 0, stream>>>(
      tbl, next, owners, bases, sizes, segpre, mask, static_cast<const U*>(elems), narrays, m, nseg,
      slab_size, item_units, shift, chunk, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_gather_block_pieces() { return kGatherBlockPieces; }

// table: the device extent table of next extents (see above); n_slabs =
// start_E.  pages: (npages,) int32.  out: (npages, slab_bytes).  unit: the
// copy width in bytes (16, 4, 2 or 1), dividing slab_bytes and every
// pointer; the grid is a block per rt_gather_block_pieces() pieces
// (kernel.py::gather_plan).  ctr: a zeroed (kCtrSlots,) int32 counter
// block, or null.
extern "C" int rt_paged_gather(const void* table, int next, int64_t n_slabs, int clip_high,
                               const void* pages, void* out, int64_t npages,
                               int64_t slab_bytes, int unit, void* ctr, void* stream) {
  if (next < 1 || slab_bytes < 1 || n_slabs < 1 || unit < 1 || slab_bytes % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npages <= 0) return 0;
  const auto* tbl = static_cast<const int64_t*>(table);
  const auto* pg = static_cast<const int*>(pages);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(ctr);
  switch (unit) {
    case 16: return launch_gather<uint4>(tbl, next, n_slabs, clip_high, pg, out, npages, slab_bytes, c, s);
    case 4: return launch_gather<uint32_t>(tbl, next, n_slabs, clip_high, pg, out, npages, slab_bytes, c, s);
    case 2: return launch_gather<uint16_t>(tbl, next, n_slabs, clip_high, pg, out, npages, slab_bytes, c, s);
    case 1: return launch_gather<unsigned char>(tbl, next, n_slabs, clip_high, pg, out, npages, slab_bytes, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// table, next, n_slabs: as above.  owners, bases: (n_slabs,) int32.
// sizes: (narrays,) int32.  elems: (narrays, m, item_bytes).  mask:
// (narrays, m) bool.  pos_out: (narrays, m) int32.  new_sizes: (narrays,)
// int32.  threads, tiles, nseg64 and chunk: kernel.py::append_plan's (a
// plan that differs from the kernel's own arithmetic is refused): the
// scan pass's block, 64, 128 or 256; tiles = ceil(m / (16 threads)), and
// where that is more than one, counts is (narrays * tiles) int32 scratch;
// segpre is (narrays, nseg + 1) int32 scratch, nseg = ceil(m / 1024);
// chunk, the slots a copy block, 1 .. kMaxChunk.  unit: the copy width in bytes (16,
// 4, 2 or 1), dividing item_bytes and every pointer.  The pool is written
// in place.
extern "C" int rt_slab_append(const void* table, int next, int64_t n_slabs, const void* owners,
                              const void* bases, const void* sizes, const void* elems,
                              const void* mask, void* counts, void* segpre, void* pos_out,
                              void* new_sizes, int64_t narrays, int64_t m, int64_t slab_size,
                              int64_t item_bytes, int unit, int threads, int64_t tiles,
                              int64_t nseg64, int chunk, void* stream) {
  if (next < 1 || slab_size < 1 || item_bytes < 1 || unit < 1 || item_bytes % unit != 0 ||
      chunk < 1 || chunk > kMaxChunk || threads < 1 ||
      tiles != (m + int64_t{threads} * kScanPer - 1) / (int64_t{threads} * kScanPer) ||
      nseg64 != (m + kSegLanes - 1) / kSegLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (narrays <= 0 || m <= 0) return 0;
  if (nseg64 >= INT_MAX || narrays > INT_MAX || n_slabs > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nseg = static_cast<int>(nseg64);
  const auto* tbl = static_cast<const int64_t*>(table);
  const auto* own = static_cast<const int*>(owners);
  const auto* bas = static_cast<const int*>(bases);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* cn = static_cast<int*>(counts);
  auto* seg = static_cast<int*>(segpre);
  auto* pos = static_cast<int*>(pos_out);
  auto* ns = static_cast<int*>(new_sizes);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (threads) {
    case 64: rc = launch_scan<64>(mk, sz, cn, pos, ns, seg, narrays, m, nseg, s); break;
    case 128: rc = launch_scan<128>(mk, sz, cn, pos, ns, seg, narrays, m, nseg, s); break;
    case 256: rc = launch_scan<256>(mk, sz, cn, pos, ns, seg, narrays, m, nseg, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0 || n_slabs == 0) return rc;
  switch (unit) {
    case 16: return launch_copy<uint4>(tbl, next, n_slabs, own, bas, sz, seg, mk, elems, narrays, m, nseg, slab_size, item_bytes, chunk, s);
    case 4: return launch_copy<uint32_t>(tbl, next, n_slabs, own, bas, sz, seg, mk, elems, narrays, m, nseg, slab_size, item_bytes, chunk, s);
    case 2: return launch_copy<uint16_t>(tbl, next, n_slabs, own, bas, sz, seg, mk, elems, narrays, m, nseg, slab_size, item_bytes, chunk, s);
    case 1: return launch_copy<unsigned char>(tbl, next, n_slabs, own, bas, sz, seg, mk, elems, narrays, m, nseg, slab_size, item_bytes, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
