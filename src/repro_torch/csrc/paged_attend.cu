// K10/K11 — paged decode attention: one query token per sequence against
// its K/V cache, read through a page table of slab ids.
//
// Replaces: src/repro/kernels/paged/kernel.py::paged_attend_pallas (K10, one
// pool) and ::paged_attend_pallas_extents (K11, a tuple of extents).  The
// TPU kernels take head-major pools (KH, S, T, D) — the reference transposes
// the whole token-major pool on every call to get them — and walk the pages
// of one (sequence, head) sequentially, carrying the online-softmax state in
// VMEM.  Here the kernel reads the token-major (S, T, KH, D) slabs the cache
// holds, with the head as a stride, and resolves slab ids through the device
// extent table that K8/K9/K12 use (common.cuh), so one kernel serves one
// extent (K10) and any number of extents (K11) alike.
//
// Inputs: q (B, KH, G, D) f32, already scaled; pages (B, P) int32 global slab
// ids; lengths (B,) int32.  Output (B, KH, G, D) f32.  A page that is -1 is
// skipped (the reference's pl.when); ids past the pool are clipped to the
// last slab for one flat pool (as the reference's K10 clips) and skipped
// through extents; keys at or past the length are left out (the reference
// masks them with -1e30 inside a live page, which weighs nothing); the
// result is acc / max(l, 1e-30), so a sequence of length 0, or one whose
// live pages are all holes, reads zeros.
//
// Bound on the card: bytes — every live K and V row is read once; the
// queries, tables and outputs are small.
//
// Design: csrc/decode_attention.cu's (K14) flash-decoding split by the live
// length, one launch, over a paged cache.  B * KH is 16 at the serving
// shape, so one block per (sequence, head) would fill 16 of 132 SMs.  The
// host picks nsplit from P * T, B * KH and the SM count alone
// (kernels/paged/kernel.py::attend_splits: one wave of about four blocks a
// SM) and never reads the lengths; block i of (b, h) takes the logical keys
// [len * i / nsplit, len * (i + 1) / nsplit), len clamped to [0, P * T].
//
// A block of two warps first copies the page-table row of its sequence and
// the extent table into shared memory, beside the length (one round trip),
// then streams its keys in chunks of at most 8 KB of K and 8 KB of V
// through a two-stage ring in shared memory: 16-byte cp.async, consecutive
// threads on consecutive 16 bytes of one key's row (a row is KH * D
// elements from the next key's in a slab, so the copy goes row by row).
// The thread that copies a row finds its page once per page it meets (each
// thread remembers its last page), for K and V at once; a row on a skipped
// page is zero-filled and flagged, and the flag keeps it out of the softmax.
//
// bf16 and f16 pools run on the tensor cores (mma.sync m16n8k16, keys in the
// rows so that no row is padding): a warp takes 16-key tiles, S^T = K q^T
// with q split into hi + lo 16-bit halves (hi + lo carry about 16
// significant bits in bf16, 22 in f16, where one 16-bit pass keeps 8 or
// 11), an online softmax per query row on the accumulator layout,
// rescaling only when a row's max moves, then O^T += V^T P^T with P split
// into hi + lo halves too and transposed in registers (movmatrix); K and V
// fragments by ldmatrix from the XOR-swizzled ring.  (The CUDA-core walk on
// 16-bit pools, converting K and V on load, measured 1.6x slower at the
// serving shape; without the lo halves the output moves by 4e-3:
// tools/paged_attend_variants.py, PERF.md.)  f32 pools run on the CUDA
// cores, one key at a time per warp, a lane holding some dims of one or two
// query rows.
//
// The two warps merge in shared memory, in warp order, into the block's (m,
// l, acc), written to scratch.  The splits then merge as a tree: the last
// block of each group of kGroup splits (a ticket per group) merges the
// group's states in split order, and the last of those (a ticket per (b,
// h)) merges the groups in group order into acc / max(l, 1e-30); with one
// group, straight into the output.  The order is fixed, so the result does
// not depend on which block finished last; each merge stages its states
// through shared memory by cp.async, one round trip for up to eight states.
// The last block resets its tickets to 0.  The wrapper keeps the scratch and
// the tickets per device (the tickets zeroed once, both grown, never inside
// a CUDA-graph capture), so launches on one device run in stream order.  A
// split with no live key writes m = -inf and a zero acc, which weigh nothing
// in the merge.  Offsets are 64-bit: a full-width pool passes 2^31 elements.
//
// Counters (K15, kCount = true): they count the reference's walk over
// (sequence, head, page), whatever the splits: split i of (b, h) counts the
// pages p = i (mod nsplit) — a page is a visited tile if its id resolves and
// p * T < length (the reference's compute gate), with T score lanes of which
// those at or past the length are masked, or else a skipped tile — and
// block 0 counts the launch (_attend_ctr, paged/kernel.py:63).  Each block
// adds its sums once (ctr_accum) before the ticket.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;     // two warps
constexpr int kBlocksPerSm = 4;  // the wave attend_splits fills (shared memory allows five)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kStageBytes = 8192;  // one chunk of K (or V) rows
constexpr int kMaxKeys = 64;       // keys a chunk
constexpr int kMaxSplits = 128;
constexpr int kGroup = 8;  // splits a first-level merge takes
constexpr int kMaxMerge = kMaxSplits / kGroup;  // states a merge takes, at most (>= kGroup)
constexpr int kRowPages = 256;   // page-table rows up to this long go to shared memory
constexpr int kMaxExtents = 32;  // extent tables up to this long too
constexpr int kStages = 2;                          // chunks in flight a block
constexpr int kBufBytes = 2 * kStages * kStageBytes;  // K and V, two stages each

// Take a ticket: add 1 to *t at device scope with acquire-release order (the
// release publishes the block's writes that a barrier ordered before it;
// the acquire makes the other blocks' published writes visible) → the old
// value.
__device__ __forceinline__ int ticket_add(int* t) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// One level of partial softmax states: per state G rows of m and l, and
// G * D of acc.
struct States {
  float* m;
  float* l;
  float* acc;
};

struct AttendParams {
  const int64_t* ktbl;
  const int64_t* vtbl;
  int next;
  int64_t n_slabs;
  int clip_high;
  const int* pages;
  const int* lengths;
  int* tickets;  // per (b, h): ngroups group counters, then the final one
  float* part;   // the scratch: split states, then group states (see states)
  int64_t BKH, KH, G, D, P, T, nsplit, ngroups;
  int64_t slab_bytes;

  // level 0: the B*KH*nsplit split states; level 1: the B*KH*ngroups group
  // states.  Both levels' acc first (16-byte aligned, read 16 bytes at a
  // time), then their m and l.
  __device__ __forceinline__ States states(int level) const {
    const int64_t ns = BKH * nsplit * G, ng = BKH * ngroups * G;
    float* ml = part + (ns + ng) * D;
    return level == 0 ? States{ml, ml + ns, part} : States{ml + 2 * ns, ml + 2 * ns + ng, part + ns * D};
  }
};

// N consecutive floats at p (N * 4 a multiple of 8, p aligned to the
// piece), in 16- or 8-byte pieces.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = u.x;
      out[4 * i + 1] = u.y;
      out[4 * i + 2] = u.z;
      out[4 * i + 3] = u.w;
    }
  } else {
    static_assert(N % 2 == 0, "8-byte pieces");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 u = reinterpret_cast<const float2*>(p)[i];
      out[2 * i] = u.x;
      out[2 * i + 1] = u.y;
    }
  }
}

template <typename T, int D>
struct Chunk {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kKeys = kStageBytes / kRowBytes < kMaxKeys ? kStageBytes / kRowBytes : kMaxKeys;
  static constexpr int kPerWarp = kKeys / kWarps;
  static constexpr int kCopies = kKeys * kRowBytes / 16;  // 16-byte copies per chunk
};

// Where a block looks its pages up: the page-table row of its sequence and
// the extent table's K and V bases and starts, copied into shared memory at
// the block's start when they fit (rows of at most kRowPages pages, at most
// kMaxExtents extents), else read in device memory.
struct Lookup {
  const int* row;
  const int64_t* kbase;
  const int64_t* vbase;
  const int64_t* start;
};

// The page a thread last resolved: positions [start, start + T), its K and
// V slab bases, and whether it is live (a resolved id).
struct PageMemo {
  int64_t start;
  const char* k;
  const char* v;
  bool live;
};

__device__ __forceinline__ void resolve_page(const AttendParams& a, const Lookup& lk,
                                             int64_t page, PageMemo& pm) {
  pm.start = page * a.T;
  int64_t s = lk.row[page];
  if (a.clip_high && s >= a.n_slabs) s = a.n_slabs - 1;
  pm.live = s >= 0 && s < a.n_slabs;
  if (!pm.live) return;
  int lo = 0, hi = a.next - 1;  // last e with start[e] <= s
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lk.start[mid] <= s) lo = mid; else hi = mid - 1;
  }
  const int64_t off = (s - lk.start[lo]) * a.slab_bytes;
  pm.k = reinterpret_cast<const char*>(lk.kbase[lo]) + off;
  pm.v = reinterpret_cast<const char*>(lk.vbase[lo]) + off;
}

// 16-byte chunk c of row r of a stage (rows of D elements of T) -> its
// place, in chunks.  f32 rows (the CUDA-core path) lie as they are; 16-bit
// rows are XOR-swizzled so that the eight rows an ldmatrix reads at one
// chunk fall in distinct banks: by row within a row of 128 bytes or more,
// by 128-byte line below that.
template <typename T, int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = D * static_cast<int>(sizeof(T)) / 16;
  if constexpr (sizeof(T) == 4) {
    return r * C + c;
  } else if constexpr (C >= 8) {
    return r * C + (c ^ (r & 7));
  } else {
    const int L = r * C + c;
    return (L & ~7) | ((L & 7) ^ ((L >> 3) & 7));
  }
}

// The K and V rows of keys [pos0, pos0 + kKeys) of (b, h) into a stage;
// rows at or past `n` keys from pos0, or on a skipped page, are zero-filled,
// not read, and flagged 0 in ok[].
template <typename T, int D>
__device__ __forceinline__ void load_chunk(uint32_t kdst, uint32_t vdst, unsigned char* ok,
                                           const AttendParams& a, const Lookup& lk, int64_t h,
                                           int64_t pos0, int64_t n, PageMemo& pm, int tid) {
  constexpr int C = Chunk<T, D>::kRowBytes / 16;
  for (int idx = tid; idx < Chunk<T, D>::kCopies; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    bool in = r < n;
    const char* krow = reinterpret_cast<const char*>(a.ktbl);  // not read when !in
    const char* vrow = krow;
    if (in) {
      const int64_t pos = pos0 + r;
      if (pos < pm.start || pos >= pm.start + a.T) resolve_page(a, lk, pos / a.T, pm);
      in = pm.live;
      if (in) {
        const int64_t off = ((pos - pm.start) * a.KH + h) * Chunk<T, D>::kRowBytes + c * 16;
        krow = pm.k + off;
        vrow = pm.v + off;
      }
    }
    const uint32_t at = swz<T, D>(r, c) * 16;
    cp_async16(kdst + at, krow, in);
    cp_async16(vdst + at, vrow, in);
    if (c == 0) ok[r] = in ? 1 : 0;
  }
}

// Everything a warp's walk over its split needs (the two compute paths
// share the copies, the ring and the hand-over to the block merge).
struct Walk {
  const AttendParams* a;
  const Lookup* lk;
  int64_t h, lo, n_keys;
  const unsigned char* ring;  // K stages 0 .. kStages - 1, then V's
  uint32_t s_buf;             // the ring's shared-memory address
  unsigned char (*row_ok)[kMaxKeys];  // [kStages][kMaxKeys]
  float* wacc;                // [kWarps][GP][D] warp states, in the ring once it is done
  float* red_m;               // [kWarps][GP]
  float* red_l;
};

// Issue the copies of the first kStages chunks (every stage in flight from
// the start).
template <typename T, int D>
__device__ __forceinline__ int64_t start_ring(const Walk& w, PageMemo& pm, int tid) {
  using Ch = Chunk<T, D>;
  const int64_t n_chunks = (w.n_keys + Ch::kKeys - 1) / Ch::kKeys;
  for (int c = 0; c < kStages && c < n_chunks; ++c) {
    const int64_t first = c * Ch::kKeys;
    load_chunk<T, D>(w.s_buf + c * kStageBytes, w.s_buf + (kStages + c) * kStageBytes,
                     w.row_ok[c], *w.a, *w.lk, w.h, w.lo + first, w.n_keys - first, pm, tid);
    cp_async_commit();
  }
  return n_chunks;
}

// Wait for chunk c, flag this warp's live keys (bit i: key j0 + i is in
// range and on a live page; warp-uniform).
template <typename T, int D>
__device__ __forceinline__ uint32_t wait_chunk(const Walk& w, int64_t c, int64_t n_chunks, int warp) {
  using Ch = Chunk<T, D>;
  const int st = static_cast<int>(c % kStages);
  static_assert(kStages == 2, "the wait below");
  if (c + 1 < n_chunks) cp_async_wait_one(); else cp_async_wait_all();  // chunk c has landed ...
  __syncthreads();  // ... for every thread, with its row flags
  const int64_t left = w.n_keys - c * Ch::kKeys - warp * Ch::kPerWarp;  // this warp's keys
  const int nk = left <= 0 ? 0 : (left < Ch::kPerWarp ? static_cast<int>(left) : Ch::kPerWarp);
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < Ch::kPerWarp; ++i)
    if (i < nk && w.row_ok[st][warp * Ch::kPerWarp + i]) live |= 1u << i;
  return live;
}

// Refill the stage of chunk c with chunk c + kStages.
template <typename T, int D>
__device__ __forceinline__ void refill(const Walk& w, int64_t c, int64_t n_chunks, PageMemo& pm,
                                       int tid) {
  using Ch = Chunk<T, D>;
  if (c + kStages >= n_chunks) return;
  const int st = static_cast<int>(c % kStages);
  __syncthreads();
  const int64_t first = (c + kStages) * Ch::kKeys;
  load_chunk<T, D>(w.s_buf + st * kStageBytes, w.s_buf + (kStages + st) * kStageBytes,
                   w.row_ok[st], *w.a, *w.lk, w.h, w.lo + first, w.n_keys - first, pm, tid);
  cp_async_commit();
}

// The CUDA-core walk (f32 pools).  GP: G rounded up to 4, 8 or 16.  Lane
// (j, s) holds dims [s * D/L, (s + 1) * D/L) of query rows j and j + G/2 in
// registers (one row j when GP = 4; L lanes a row group) and scores one key
// at a time: each K element feeds both rows' fmas, then log2(L) shuffles a
// row.
template <int D, int GP>
__device__ __forceinline__ void fma_walk(const float* __restrict__ q, const Walk& w, int64_t bh,
                                         int G) {
  using T = float;
  using Ch = Chunk<T, D>;
  constexpr int R = GP >= 8 ? 2 : 1;  // query rows a lane
  constexpr int RG = GP / R;          // row groups a warp: lane group j holds rows j + r * RG
  constexpr int LPR = 32 / RG;        // lanes a row group
  constexpr int DPL = D / LPR;        // dims a lane
  constexpr int kVec = DPL % 4 == 0 ? 4 : 2;  // floats a load
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, sl = lane % LPR;
  PageMemo pm{-w.a->T - 1, nullptr, nullptr, false};  // no page yet
  const int64_t n_chunks = start_ring<T, D>(w, pm, tid);

  float qr[R][DPL], acc[R][DPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = rg + r * RG;
    if (g < G) {
      load_f32<DPL>(q + (bh * G + g) * D + sl * DPL, qr[r]);
    } else {
#pragma unroll
      for (int x = 0; x < DPL; ++x) qr[r][x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[r][x] = 0.f;
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }

  for (int64_t c = 0; c < n_chunks; ++c) {
    const uint32_t live = wait_chunk<T, D>(w, c, n_chunks, warp);
    const int st = static_cast<int>(c % kStages);
    const T* ks = reinterpret_cast<const T*>(w.ring + st * kStageBytes);
    const T* vs = reinterpret_cast<const T*>(w.ring + (kStages + st) * kStageBytes);
    const int j0 = warp * Ch::kPerWarp;

    float sc[R][Ch::kPerWarp], mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = m[r];
#pragma unroll
    for (int i = 0; i < Ch::kPerWarp; ++i) {
      if (live >> i & 1u) {
        const T* krow = ks + (j0 + i) * D + sl * DPL;
        float d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = 0.f;
#pragma unroll
        for (int x0 = 0; x0 < DPL; x0 += kVec) {
          float kv[kVec];
          load_f32<kVec>(krow + x0, kv);
#pragma unroll
          for (int x = 0; x < kVec; ++x)
#pragma unroll
            for (int r = 0; r < R; ++r) d[r] = fmaf(qr[r][x0 + x], kv[x], d[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int o = LPR / 2; o >= 1; o >>= 1) d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
          sc[r][i] = d[r];
          mx[r] = fmaxf(mx[r], sc[r][i]);
        }
      }
    }
    if (live != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float alpha = expf(m[r] - mx[r]);  // m = -inf before the first key: 0
        l[r] *= alpha;
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[r][x] *= alpha;
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < Ch::kPerWarp; ++i) {
        if (live >> i & 1u) {
          float p[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            p[r] = expf(sc[r][i] - m[r]);
            l[r] += p[r];
          }
          const T* vrow = vs + (j0 + i) * D + sl * DPL;
#pragma unroll
          for (int x0 = 0; x0 < DPL; x0 += kVec) {
            float vv[kVec];
            load_f32<kVec>(vrow + x0, vv);
#pragma unroll
            for (int x = 0; x < kVec; ++x)
#pragma unroll
              for (int r = 0; r < R; ++r) acc[r][x0 + x] = fmaf(p[r], vv[x], acc[r][x0 + x]);
          }
        }
      }
    }
    refill<T, D>(w, c, n_chunks, pm, tid);
  }

  __syncthreads();  // every warp is done with the ring: it holds the warp states now
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = rg + r * RG;
    if (g < G) {
#pragma unroll
      for (int x = 0; x < DPL; ++x) w.wacc[(warp * GP + g) * D + sl * DPL + x] = acc[r][x];
      if (sl == 0) {
        w.red_m[warp * GP + g] = m[r];
        w.red_l[warp * GP + g] = l[r];
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b on the tensor cores, m16n8k16, f32 accumulators, bf16 or f16
// inputs (a: 4 registers, b: 2).
template <typename T>
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
// x as the sum of two 16-bit values: hi = x rounded, lo = (x - hi) rounded.
template <typename T>
__device__ __forceinline__ void split16(float x, T& hi, T& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    hi = __float2bfloat16_rn(x);
    lo = __float2bfloat16_rn(x - __bfloat162float(hi));
  } else {
    hi = __float2half_rn(x);
    lo = __float2half_rn(x - __half2float(hi));
  }
}
// (x0, x1) split into packed (hi, lo) pairs, x0 in the low half.
template <typename T>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  T h0, l0, h1, l1;
  split16<T>(x0, h0, l0);
  split16<T>(x1, h1, l1);
  hi = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&h0)) |
       static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&h1)) << 16;
  lo = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&l0)) |
       static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&l1)) << 16;
}

__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {  // movmatrix: an 8x8 b16 tile
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The tensor-core walk (bf16 and f16 pools), keys in the rows of the
// products so that no row is padding: a warp takes 16-key tiles of each
// chunk, S^T = K q^T as m16n8k16 (16 keys x 8 query rows a tile, GP / 8
// row tiles; q split into hi + lo 16-bit halves held in shared memory,
// about 16 significant bits in bf16; K fragments by ldmatrix from the
// swizzled ring), an online softmax per query row on the accumulator
// layout (a row's keys lie in the lanes of one lane % 4), then O^T += V^T
// P^T as m16n8k16 with V^T by ldmatrix.trans and P^T from S^T's
// accumulators (split into hi + lo halves too) transposed in registers by
// movmatrix.  Lane l holds query rows 2 (l % 4) and 2 (l % 4) + 1 of each
// row tile, for keys (dims) l / 4 and l / 4 + 8.
template <typename T, int D, int GP>
__device__ __forceinline__ void mma_walk(const float* __restrict__ q, const Walk& w, int64_t bh,
                                         int G, uint16_t* q_s) {
  using Ch = Chunk<T, D>;
  constexpr int NT = Ch::kPerWarp / 16;  // 16-key tiles a warp takes of a chunk
  constexpr int RT = GP / 8;             // 8-row tiles of the queries
  constexpr int KS = D / 16;             // k-steps of S^T
  constexpr int MD = D / 16;             // 16-dim tiles of O^T
  static_assert(Ch::kPerWarp % 16 == 0 && GP % 8 == 0, "shapes");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // q (G, D) f32, GP rows (zeros past G): every load issued before the ring's
  constexpr int kQ4 = (GP * D / 4 + kThreads - 1) / kThreads;  // float4s a thread
  float4 qv[kQ4];
#pragma unroll
  for (int j = 0; j < kQ4; ++j) {
    const int e = (tid + j * kThreads) * 4, g = e / D;
    qv[j] = e < GP * D && g < G ? *reinterpret_cast<const float4*>(q + (bh * G + g) * D + e % D)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  PageMemo pm{-w.a->T - 1, nullptr, nullptr, false};  // no page yet
  const int64_t n_chunks = start_ring<T, D>(w, pm, tid);
  // ... then split into hi and lo halves, swizzled as the ring's rows; the
  // first wait_chunk's barrier publishes them
#pragma unroll
  for (int j = 0; j < kQ4; ++j) {
    const int e = (tid + j * kThreads) * 4, g = e / D, d = e % D;
    if (e < GP * D) {
      uint32_t h01, l01, h23, l23;
      split_pair<T>(qv[j].x, qv[j].y, h01, l01);
      split_pair<T>(qv[j].z, qv[j].w, h23, l23);
      const int at = swz<T, D>(g, d / 8) * 8 + d % 8;  // 4 elements: 8 bytes
      *reinterpret_cast<uint2*>(q_s + at) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(q_s + GP * D + at) = make_uint2(l01, l23);
    }
  }
  const uint32_t q_hi = smem_u32(q_s), q_lo = q_hi + GP * D * 2;

  float acc[MD][RT][4], m[RT][2], l[RT][2];
#pragma unroll
  for (int md = 0; md < MD; ++md)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[md][rt][e] = 0.f;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) m[rt][0] = m[rt][1] = -CUDART_INF_F, l[rt][0] = l[rt][1] = 0.f;

  for (int64_t c = 0; c < n_chunks; ++c) {
    const uint32_t live = wait_chunk<T, D>(w, c, n_chunks, warp);
    const int st = static_cast<int>(c % kStages);
    const uint32_t kst = w.s_buf + st * kStageBytes, vst = w.s_buf + (kStages + st) * kStageBytes;
    const int j0 = warp * Ch::kPerWarp;
    if (live != 0) {
      float sc[NT][RT][4], sl[NT][RT][4];  // q's hi and lo halves in two chains, summed after
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[t][rt][e] = sl[t][rt][e] = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        uint32_t bh_[RT][2], bl_[RT][2];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const int qc = swz<T, D>(rt * 8 + (lane & 7), 2 * k + ((lane >> 3) & 1));
          ldsm_x2(q_hi + qc * 16, bh_[rt]);
          ldsm_x2(q_lo + qc * 16, bl_[rt]);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t ak[4];
          ldsm_x4(kst + swz<T, D>(j0 + t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  2 * k + (lane >> 4)) * 16, ak);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            mma_k16<T>(sc[t][rt], ak, bh_[rt][0], bh_[rt][1]);
            mma_k16<T>(sl[t][rt], ak, bl_[rt][0], bl_[rt][1]);
          }
        }
      }
      // keys out of range or on a skipped page weigh nothing; a row's max
      // over the lanes of its lane % 4
      float mx[RT][2];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        mx[rt][0] = m[rt][0];
        mx[rt][1] = m[rt][1];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& v = sc[t][rt][e];
            v += sl[t][rt][e];
            if (!(live >> (t * 16 + (lane >> 2) + (e >> 1) * 8) & 1u)) v = -CUDART_INF_F;
            mx[rt][e & 1] = fmaxf(mx[rt][e & 1], v);
          }
#pragma unroll
        for (int o = 4; o <= 16; o <<= 1) {
          mx[rt][0] = fmaxf(mx[rt][0], __shfl_xor_sync(0xffffffffu, mx[rt][0], o));
          mx[rt][1] = fmaxf(mx[rt][1], __shfl_xor_sync(0xffffffffu, mx[rt][1], o));
        }
      }
      bool moved = false;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) moved |= mx[rt][0] != m[rt][0] || mx[rt][1] != m[rt][1];
      if (__any_sync(0xffffffffu, moved)) {  // rescale only on a new max
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const float a0 = expf(m[rt][0] - mx[rt][0]), a1 = expf(m[rt][1] - mx[rt][1]);  // -inf: 0
          m[rt][0] = mx[rt][0];
          m[rt][1] = mx[rt][1];
          l[rt][0] *= a0;
          l[rt][1] *= a1;
#pragma unroll
          for (int md = 0; md < MD; ++md) {
            acc[md][rt][0] *= a0;
            acc[md][rt][1] *= a1;
            acc[md][rt][2] *= a0;
            acc[md][rt][3] *= a1;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bph[RT][2], bpl[RT][2];  // P^T fragments: keys 0-7, 8-15 of the tile
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = expf(sc[t][rt][e] - m[rt][e & 1]);
            l[rt][e & 1] += p[e];
          }
          uint32_t h01, l01, h23, l23;
          split_pair<T>(p[0], p[1], h01, l01);
          split_pair<T>(p[2], p[3], h23, l23);
          bph[rt][0] = transpose8x8(h01);
          bph[rt][1] = transpose8x8(h23);
          bpl[rt][0] = transpose8x8(l01);
          bpl[rt][1] = transpose8x8(l23);
        }
#pragma unroll
        for (int md = 0; md < MD; ++md) {
          uint32_t av[4];
          ldsm_x4_t(vst + swz<T, D>(j0 + t * 16 + (lane & 7) + (lane >> 4) * 8,
                                    2 * md + ((lane >> 3) & 1)) * 16, av);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            mma_k16<T>(acc[md][rt], av, bph[rt][0], bph[rt][1]);
            mma_k16<T>(acc[md][rt], av, bpl[rt][0], bpl[rt][1]);
          }
        }
      }
    }
    refill<T, D>(w, c, n_chunks, pm, tid);
  }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {  // a row's sum over the lanes of its lane % 4
      l[rt][0] += __shfl_xor_sync(0xffffffffu, l[rt][0], o);
      l[rt][1] += __shfl_xor_sync(0xffffffffu, l[rt][1], o);
    }

  __syncthreads();  // every warp is done with the ring: it holds the warp states now
  const int r0 = 2 * (lane & 3), d0 = lane >> 2;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int g = rt * 8 + r0 + e;
      if (g < G) {
#pragma unroll
        for (int md = 0; md < MD; ++md) {
          w.wacc[(warp * GP + g) * D + md * 16 + d0] = acc[md][rt][e];
          w.wacc[(warp * GP + g) * D + md * 16 + d0 + 8] = acc[md][rt][2 + e];
        }
        if (d0 == 0) {
          w.red_m[warp * GP + g] = m[rt][e];
          w.red_l[warp * GP + g] = l[rt][e];
        }
      }
    }
}

// Merge states [first, first + n) of one level (n <= kMaxMerge; each G rows
// of m and l, G * D of acc) in their order: M = max m_i, weights
// exp(m_i - M) (0 for a state with no live key), L = sum l_i w_i, A = sum
// acc_i w_i.  Into state `dst_slot` of `dst` (unnormalised), or
// acc / max(L, 1e-30) into `out`.  The acc goes through `stage` (32 KB of
// shared memory, free once the block's own state is written) by cp.async,
// eight states of eight rows a round; the first round is issued with the m
// and l loads (through L2, into `wl`: 2 * kMaxMerge * GP floats, row-major),
// so a merge of up to eight states of up to eight rows is one round trip.  A
// thread takes a row's weights.  Every thread of the block calls it.  Not
// inlined: the group and the final merge share one copy of the code.
template <int D, int GP>
__device__ __noinline__ void merge_states(const States& src, int64_t first, int n, int G,
                                             uint32_t stage, const float4* stage_f4, float* wl,
                                             float* row_l, const States* dst, float* out,
                                             int64_t dst_slot = 0) {
  constexpr int kS = 8;                                       // states a round
  constexpr int kRowsPass = 8;                                // rows a round
  constexpr int kP4 = kRowsPass * D / 4;                      // float4s of a state's rows
  constexpr int kE4 = (kP4 + kThreads - 1) / kThreads;        // ... a thread
  static_assert(kS * kP4 * 16 <= kBufBytes, "a round fits the stage");
  const int tid = threadIdx.x;
  const float* pm = src.m + first * G;
  const float* pl = src.l + first * G;
  const float* pa = src.acc + first * G * D;
  float* wts = wl;                    // [GP][n] states' m, then weights
  float* ls = wl + kMaxMerge * GP;    // [GP][n] states' l
  auto issue = [&](int i0, int pass) {  // acc of states [i0, i0 + kS), rows of the pass
    const int m4 = (G - kRowsPass * pass < kRowsPass ? G - kRowsPass * pass : kRowsPass) * D / 4;
    for (int e = tid; e < kS * kP4; e += kThreads) {
      const int st = e / kP4, e4 = e % kP4;
      const bool in = i0 + st < n && e4 < m4;
      cp_async16(stage + e * 16, in ? pa + ((i0 + st) * G + kRowsPass * pass) * D + e4 * 4 : pa, in);
    }
    cp_async_commit();
  };
  issue(0, 0);
  constexpr int kML = (kMaxMerge * GP + kThreads - 1) / kThreads;  // m and l a thread
  float mv[kML], lv[kML];
#pragma unroll
  for (int j = 0; j < kML; ++j) {
    const int e = tid + j * kThreads;
    if (e < n * G) {
      mv[j] = __ldcg(pm + e);
      lv[j] = __ldcg(pl + e);
    }
  }
#pragma unroll
  for (int j = 0; j < kML; ++j) {  // state i's row r -> [r][i]
    const int e = tid + j * kThreads;
    if (e < n * G) {
      wts[(e % G) * n + e / G] = mv[j];
      ls[(e % G) * n + e / G] = lv[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int gg = tid; gg < G; gg += kThreads) {  // a thread a row, the states in order
    float M = -CUDART_INF_F;
    for (int i = 0; i < n; ++i) M = fmaxf(M, wts[gg * n + i]);
    float Lt = 0.f;
    for (int i = 0; i < n; ++i) {
      const float mi = wts[gg * n + i];
      const float wt = mi == -CUDART_INF_F ? 0.f : expf(mi - M);  // 0: no live key
      wts[gg * n + i] = wt;
      Lt = fmaf(ls[gg * n + i], wt, Lt);
    }
    if (dst != nullptr) {
      dst->m[dst_slot * G + gg] = M;
      dst->l[dst_slot * G + gg] = Lt;
    } else {
      row_l[gg] = fmaxf(Lt, 1e-30f);
    }
  }
  __syncthreads();
  // each thread sums 4 consecutive elements over the states, in order
  float* ob = dst != nullptr ? dst->acc + dst_slot * G * D : out;
  for (int pass = 0; kRowsPass * pass < G; ++pass) {
    float4 A[kE4];
#pragma unroll
    for (int j = 0; j < kE4; ++j) A[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < n; i0 += kS) {
      if (pass > 0 || i0 > 0) {
        __syncthreads();  // the stage's last round is read
        issue(i0, pass);
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int st = 0; st < kS; ++st)
#pragma unroll
        for (int j = 0; j < kE4; ++j) {
          const int e4 = tid + j * kThreads;
          const int row = kRowsPass * pass + e4 * 4 / D;
          if (i0 + st < n && e4 < kP4 && row < G) {
            const float wt = wts[row * n + i0 + st];
            const float4 x = stage_f4[st * kP4 + e4];
            A[j].x = fmaf(x.x, wt, A[j].x);
            A[j].y = fmaf(x.y, wt, A[j].y);
            A[j].z = fmaf(x.z, wt, A[j].z);
            A[j].w = fmaf(x.w, wt, A[j].w);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < kE4; ++j) {
      const int e4 = tid + j * kThreads;
      const int row = kRowsPass * pass + e4 * 4 / D;
      if (e4 < kP4 && row < G) {
        const float den = dst != nullptr ? 1.f : row_l[row];
        reinterpret_cast<float4*>(ob)[pass * kP4 + e4] =
            make_float4(A[j].x / den, A[j].y / den, A[j].z / den, A[j].w / den);
      }
    }
  }
}

// grid (B * KH * nsplit); block (b, h, split).  GP: G rounded up to 4, 8 or
// 16 (8 or 16 on the tensor cores).
template <typename T, int D, int GP, bool kCount>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
paged_split_kernel(const float* __restrict__ q, AttendParams a, float* __restrict__ out,
                   int* __restrict__ ctr) {
  constexpr bool kMma = sizeof(T) == 2;
  static_assert(GP * D * kWarps * 4 <= kBufBytes, "the warp states fit the ring");
  static_assert(Chunk<T, D>::kPerWarp <= 32, "a warp's keys of a chunk fit a bit mask");
  __shared__ __align__(16) unsigned char buf[kBufBytes];  // the ring
  __shared__ __align__(16) uint16_t q_s[kMma ? 2 * GP * D : 8];  // q's hi and lo halves
  __shared__ unsigned char row_ok[kStages][kMaxKeys];
  __shared__ float red_m[kWarps][GP], red_l[kWarps][GP], red_w[kWarps][GP], row_l[GP];
  __shared__ int s_last;
  __shared__ int s_row[kRowPages];
  __shared__ int64_t s_kbase[kMaxExtents], s_vbase[kMaxExtents], s_start[kMaxExtents];
  __shared__ float s_wl[2 * kMaxMerge * GP];  // a merge's m and l, then its weights

  const int64_t split = blockIdx.x % a.nsplit;
  const int64_t bh = blockIdx.x / a.nsplit;
  const int64_t b = bh / a.KH, h = bh % a.KH;
  const int G = static_cast<int>(a.G);
  const int tid = threadIdx.x;

  // the page-table row and the extent table into shared memory, loaded
  // beside the length: one round trip before the first copy, not three
  Lookup lk{a.pages + b * a.P, a.ktbl, a.vtbl, a.ktbl + a.next};
  if (a.P <= kRowPages) {
    for (int64_t p = tid; p < a.P; p += kThreads) s_row[p] = lk.row[p];
    lk.row = s_row;
  }
  if (a.next <= kMaxExtents) {
    for (int e = tid; e < a.next; e += kThreads) {
      s_kbase[e] = a.ktbl[e];
      s_vbase[e] = a.vtbl[e];
      s_start[e] = a.ktbl[a.next + e];
    }
    lk.kbase = s_kbase;
    lk.vbase = s_vbase;
    lk.start = s_start;
  }
  const int64_t len_raw = a.lengths[b];
  __syncthreads();
  const int64_t cap = a.P * a.T;
  const int64_t len = len_raw < 0 ? 0 : (len_raw > cap ? cap : len_raw);
  const int64_t lo = len * split / a.nsplit, hi = len * (split + 1) / a.nsplit;

  float* wacc = reinterpret_cast<float*>(buf);  // [kWarps][GP][D]
  const Walk w{&a, &lk, h, lo, hi - lo, buf, smem_u32(buf), row_ok, wacc, &red_m[0][0],
               &red_l[0][0]};
  if constexpr (kMma) {
    mma_walk<T, D, GP>(q, w, bh, G, q_s);
  } else {
    fma_walk<D, GP>(q, w, bh, G);
  }

  if constexpr (kCount) {  // pages p = split (mod nsplit) of (b, h)
    int v[5] = {blockIdx.x == 0 && tid == 0 ? 1 : 0, 0, 0, 0, 0};
    for (int64_t p = split + a.nsplit * tid; p < a.P; p += a.nsplit * kThreads) {
      int64_t s = lk.row[p];
      if (a.clip_high && s >= a.n_slabs) s = a.n_slabs - 1;
      const int visit = s >= 0 && s < a.n_slabs && p * a.T < len_raw ? 1 : 0;
      const int64_t in_page = len_raw - p * a.T;
      const int64_t kept = in_page < 0 ? 0 : (in_page > a.T ? a.T : in_page);
      v[1] += visit;
      v[2] += 1 - visit;
      v[3] += visit * static_cast<int>(a.T);
      v[4] += visit * static_cast<int>(a.T - kept);
    }
    constexpr int slots[5] = {kAttendLaunches, kAttendTiles, kAttendTilesSkipped, kAttendLanes,
                              kAttendMaskedLanes};
    ctr_accum<kThreads>(ctr, slots, v);
  }

  // the warps' states (in the ring) -> the block's, in warp order
  __syncthreads();
  const States split_st = a.states(0), group_st = a.states(1);
  const int64_t slot = bh * a.nsplit + split;
  if (tid < G) {
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w][tid]);
    float Lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w][tid];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - M);
      red_w[w][tid] = wt;
      Lb = fmaf(red_l[w][tid], wt, Lb);
    }
    split_st.m[slot * a.G + tid] = M;  // -inf: no live key in this split
    split_st.l[slot * a.G + tid] = Lb;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {  // an empty split writes zeros
    const int gg = e / D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A = fmaf(red_w[w][gg], wacc[w * GP * D + e], A);
    split_st.acc[slot * a.G * D + e] = A;
  }

  // tickets: the last block of a group of kGroup splits merges the group's
  // states in split order; the last of those merges the groups in group
  // order (one group: straight into the output).  The order is fixed, so
  // the result does not depend on which block finished last.
  const int ns = static_cast<int>(a.nsplit), ng = static_cast<int>(a.ngroups);
  const int gi = static_cast<int>(split) / kGroup;
  const int gn = ns - gi * kGroup < kGroup ? ns - gi * kGroup : kGroup;
  int* tix = a.tickets + bh * (ng + 1);
  const uint32_t stage = smem_u32(buf);  // the ring, free now: a merge's staging
  const float4* stage_f4 = reinterpret_cast<const float4*>(buf);
  // the barrier orders every thread's state writes before thread 0's
  // release; its acquire orders the merge's reads after the other blocks'
  __syncthreads();
  if (tid == 0) s_last = ticket_add(tix + gi) == gn - 1;
  __syncthreads();
  if (!s_last) return;
  const int64_t first = bh * ns + gi * kGroup;
  if (ng == 1) {
    merge_states<D, GP>(split_st, first, gn, G, stage, stage_f4, s_wl, row_l, nullptr,
                        out + bh * a.G * D);
    if (tid == 0) tix[gi] = 0;
    return;
  }
  merge_states<D, GP>(split_st, first, gn, G, stage, stage_f4, s_wl, row_l, &group_st, nullptr,
                      bh * ng + gi);
  if (tid == 0) tix[gi] = 0;
  __syncthreads();
  if (tid == 0) s_last = ticket_add(tix + ng) == ng - 1;
  __syncthreads();
  if (!s_last) return;
  merge_states<D, GP>(group_st, bh * ng, ng, G, stage, stage_f4, s_wl, row_l, nullptr,
                      out + bh * a.G * D);
  if (tid == 0) tix[ng] = 0;
}

template <typename T, int D, int GP>
int launch(const float* q, const AttendParams& a, float* out, int* ctr, cudaStream_t s) {
  const int64_t grid = a.BKH * a.nsplit;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = ctr != nullptr ? paged_split_kernel<T, D, GP, true>
                               : paged_split_kernel<T, D, GP, false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(q, a, out, ctr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const float* q, const AttendParams& a, float* out, int* ctr, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {  // the tensor-core walk: one or two 8-row tiles
    if (a.G <= 8) return launch<T, D, 8>(q, a, out, ctr, s);
    return launch<T, D, 16>(q, a, out, ctr, s);
  } else {
    if (a.G <= 4) return launch<T, D, 4>(q, a, out, ctr, s);
    if (a.G <= 8) return launch<T, D, 8>(q, a, out, ctr, s);
    return launch<T, D, 16>(q, a, out, ctr, s);
  }
}

template <typename T>
int launch_d(const float* q, const AttendParams& a, float* out, int* ctr, cudaStream_t s) {
  switch (a.D) {
    case 16: return launch_g<T, 16>(q, a, out, ctr, s);
    case 32: return launch_g<T, 32>(q, a, out, ctr, s);
    case 64: return launch_g<T, 64>(q, a, out, ctr, s);
    case 128: return launch_g<T, 128>(q, a, out, ctr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_paged_attend_max_splits() { return kMaxSplits; }
extern "C" int rt_paged_attend_group() { return kGroup; }

// ktable, vtable: device extent tables of the K and V pools (same geometry,
// next extents, n_slabs slabs of T tokens; every extent 16-byte aligned).
// q, out: (B, KH, G, D) f32, 16-byte aligned.  pages: (B, P) int32;
// lengths: (B,) int32.  With ng = ceil(nsplit / rt_paged_attend_group()):
// part: (D + 2) * B*KH*(nsplit + ng)*G f32 scratch, 16-byte aligned;
// tickets: at least B*KH*(ng + 1) int32, all 0 (the kernel leaves them 0).
// dtype: 0 = f32, 1 = bf16, 2 = f16 (the pools).  G <= 16, D in {16, 32,
// 64, 128}, 1 <= nsplit <= rt_paged_attend_max_splits().  ctr: a zeroed
// (kCtrSlots,) int32 counter block, or null for no counters.
extern "C" int rt_paged_attend(const void* ktable, const void* vtable, int next,
                               int64_t n_slabs, int clip_high, const void* q, const void* pages,
                               const void* lengths, void* part, void* tickets, void* out,
                               int dtype, int64_t B, int64_t KH, int64_t G, int64_t D, int64_t P,
                               int64_t T, int64_t nsplit, void* ctr, void* stream) {
  if (next < 1 || n_slabs < 1 || B < 0 || KH < 1 || G < 1 || G > kMaxG || P < 0 || T < 1 ||
      nsplit < 1 || nsplit > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  AttendParams a{};
  a.ktbl = static_cast<const int64_t*>(ktable);
  a.vtbl = static_cast<const int64_t*>(vtable);
  a.next = next;
  a.n_slabs = n_slabs;
  a.clip_high = clip_high;
  a.pages = static_cast<const int*>(pages);
  a.lengths = static_cast<const int*>(lengths);
  a.tickets = static_cast<int*>(tickets);
  a.part = static_cast<float*>(part);
  a.BKH = B * KH; a.KH = KH; a.G = G; a.D = D; a.P = P; a.T = T; a.nsplit = nsplit;
  a.ngroups = (nsplit + kGroup - 1) / kGroup;
  const int64_t elem = dtype == 0 ? 4 : 2;
  a.slab_bytes = T * KH * D * elem;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<int*>(ctr);
  switch (dtype) {
    case 0: return launch_d<float>(qf, a, o, c, s);
    case 1: return launch_d<__nv_bfloat16>(qf, a, o, c, s);
    case 2: return launch_d<__half>(qf, a, o, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
