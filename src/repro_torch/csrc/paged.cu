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
// logical position bases[s] + j of array owners[s].  Two kernels, launched
// back to back on one stream:
//   1. slab_compact — one block per array: the exclusive scan of the mask
//      row in chunks of 1024 lanes (block_exclusive_scan, as in K3) writes
//      the positions (-1 where masked) and the new sizes, and the block
//      copies each chunk's live items, in order, into a scratch row
//      (N, m, item) — coalesced, one unit per thread.
//   2. slab_scatter — one block per slab of the whole pool (all extents in
//      one launch): a slab owned by o copies the window
//      [max(0, sizes[o] - bases[s]), min(T, sizes[o] + count[o] - bases[s]))
//      of o's scratch row into its slots, a contiguous copy.  Slabs with
//      owner -1 are never written; owners past N are clamped to N - 1, as
//      the reference clamps them.  Live lanes that land past every claimed
//      slab are written nowhere, yet keep their position and count.
// This keeps the reference's semantics for any owners/bases table, also
// ones the arena never builds (two slabs with one window both get it).
// Bound: bytes — the mask and the wave read once, the live items and the
// positions written once; the scratch round trip is above that bound.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherPer = 2;                                    // pieces a thread
constexpr int kGatherBlockPieces = kGatherThreads * kGatherPer;  // pieces a block
constexpr int kGatherMaxPages = kGatherBlockPieces + 1;          // pages a block touches, at most
constexpr int kCompactThreads = 1024;
constexpr int kScatterThreads = 512;

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

template <typename U>
__global__ void __launch_bounds__(kCompactThreads)
slab_compact_kernel(const unsigned char* __restrict__ mask, const int* __restrict__ sizes,
                    const U* __restrict__ elems, U* __restrict__ scratch,
                    int* __restrict__ pos_out, int* __restrict__ new_sizes, int64_t m,
                    int64_t item_units) {
  __shared__ int scan_smem[32];
  __shared__ int lane_of[kCompactThreads];  // live item k of the chunk -> its lane
  const int64_t row = blockIdx.x;
  const int size = sizes[row];
  const U* src_row = elems + row * m * item_units;
  U* dst_row = scratch + row * m * item_units;
  int carry = 0;
  for (int64_t j0 = 0; j0 < m; j0 += kCompactThreads) {
    const int64_t j = j0 + threadIdx.x;
    const int live = (j < m && mask[row * m + j] != 0) ? 1 : 0;
    int total;
    const int off = block_exclusive_scan<kCompactThreads>(live, scan_smem, &total);
    if (j < m) pos_out[row * m + j] = live ? size + carry + off : -1;
    if (live) lane_of[off] = static_cast<int>(j - j0);
    __syncthreads();
    const int64_t n_units = static_cast<int64_t>(total) * item_units;
    U* dst = dst_row + static_cast<int64_t>(carry) * item_units;
    for (int64_t q = threadIdx.x; q < n_units; q += kCompactThreads) {
      const int64_t k = q / item_units;
      const int64_t u = q - k * item_units;
      dst[q] = src_row[(j0 + lane_of[k]) * item_units + u];
    }
    __syncthreads();  // lane_of is rewritten by the next chunk
    carry += total;
  }
  if (threadIdx.x == 0) new_sizes[row] = size + carry;
}

template <typename U>
__global__ void __launch_bounds__(kScatterThreads)
slab_scatter_kernel(const int64_t* __restrict__ tbl, int next, const int* __restrict__ owners,
                    const int* __restrict__ bases, const int* __restrict__ sizes,
                    const int* __restrict__ new_sizes, const U* __restrict__ scratch,
                    int64_t narrays, int64_t m, int64_t slab_size, int64_t item_units) {
  const int64_t s = blockIdx.x;
  const int owner = owners[s];
  if (owner < 0) return;
  const int64_t own = owner < narrays ? owner : narrays - 1;
  const int64_t size = sizes[own];
  const int64_t count = static_cast<int64_t>(new_sizes[own]) - size;
  const int64_t base = bases[s];
  const int64_t lo = size - base > 0 ? size - base : 0;
  const int64_t hi_raw = size + count - base;
  const int64_t hi = hi_raw < slab_size ? hi_raw : slab_size;
  if (lo >= hi) return;
  U* dst = reinterpret_cast<U*>(
      slab_address(tbl, next, s, slab_size * item_units * static_cast<int64_t>(sizeof(U))));
  dst += lo * item_units;
  const U* src = scratch + (own * m + base + lo - size) * item_units;
  const int64_t n_units = (hi - lo) * item_units;
  for (int64_t q = threadIdx.x; q < n_units; q += kScatterThreads) dst[q] = src[q];
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

template <typename U>
int launch_append(const int64_t* tbl, int next, int64_t n_slabs, const int* owners,
                  const int* bases, const int* sizes, const void* elems,
                  const unsigned char* mask, void* scratch, int* pos_out, int* new_sizes,
                  int64_t narrays, int64_t m, int64_t slab_size, int64_t item_bytes,
                  cudaStream_t stream) {
  const int64_t item_units = item_bytes / static_cast<int64_t>(sizeof(U));
  if (narrays > INT_MAX || n_slabs > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  slab_compact_kernel<U><<<static_cast<unsigned>(narrays), kCompactThreads, 0, stream>>>(
      mask, sizes, static_cast<const U*>(elems), static_cast<U*>(scratch), pos_out, new_sizes,
      m, item_units);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_slabs == 0) return 0;
  slab_scatter_kernel<U><<<static_cast<unsigned>(n_slabs), kScatterThreads, 0, stream>>>(
      tbl, next, owners, bases, sizes, new_sizes, static_cast<const U*>(scratch), narrays, m,
      slab_size, item_units);
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
// sizes: (narrays,) int32.  elems, scratch: (narrays, m, item_bytes).
// mask: (narrays, m) bool.  pos_out: (narrays, m) int32.  new_sizes:
// (narrays,) int32.  The pool is written in place.
extern "C" int rt_slab_append(const void* table, int next, int64_t n_slabs, const void* owners,
                              const void* bases, const void* sizes, const void* elems,
                              const void* mask, void* scratch, void* pos_out, void* new_sizes,
                              int64_t narrays, int64_t m, int64_t slab_size,
                              int64_t item_bytes, int unit, void* stream) {
  if (next < 1 || slab_size < 1 || item_bytes < 1 || item_bytes % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (narrays <= 0 || m <= 0) return 0;
  const auto* tbl = static_cast<const int64_t*>(table);
  const auto* own = static_cast<const int*>(owners);
  const auto* bas = static_cast<const int*>(bases);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* pos = static_cast<int*>(pos_out);
  auto* ns = static_cast<int*>(new_sizes);
  auto s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch_append<uint4>(tbl, next, n_slabs, own, bas, sz, elems, mk, scratch, pos, ns, narrays, m, slab_size, item_bytes, s);
    case 4: return launch_append<uint32_t>(tbl, next, n_slabs, own, bas, sz, elems, mk, scratch, pos, ns, narrays, m, slab_size, item_bytes, s);
    case 2: return launch_append<uint16_t>(tbl, next, n_slabs, own, bas, sz, elems, mk, scratch, pos, ns, narrays, m, slab_size, item_bytes, s);
    case 1: return launch_append<unsigned char>(tbl, next, n_slabs, own, bas, sz, elems, mk, scratch, pos, ns, narrays, m, slab_size, item_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
