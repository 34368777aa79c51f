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
// extent table that K8/K9/K12 use (common.cuh::slab_address), so one kernel
// serves one extent (K10) and any number of extents (K11) alike.
//
// Inputs: q (B, KH, G, D) f32, already scaled; pages (B, P) int32 global slab
// ids; lengths (B,) int32.  Output (B, KH, G, D) f32.  A page that is -1 or
// lies at or past the sequence's length is skipped (the reference's
// pl.when); ids past the pool are clipped to the last slab for one flat
// pool (as the reference's K10 clips) and skipped through extents; keys at
// or past the length inside a live page are masked with -1e30; the result is
// acc / max(l, 1e-30), so a sequence of length 0 reads zeros.
//
// Bound on the card: bytes — every live K and V row is read once; the
// queries, tables and outputs are small.
//
// Design: at decode batch 8 with 2 KV heads, one block per (sequence, head)
// would fill 16 of 132 SMs, so the walk is split.  Pass 1 runs one block of
// 256 threads per (sequence, head, page, segment of up to 256 tokens): each
// thread scores one token against the G query rows (its K row read from the
// slab at (slot * KH + head) * D), the block takes the segment's max and
// sum per row, and threads split (dimension, token parity) to accumulate
// P V with coalesced V reads, combined through shared memory.  It writes the
// segment's (m, l, acc), or m = -inf for a segment with no live token.
// Pass 2 runs one block per (sequence, head) and merges the segments in
// page order with the usual rescaling.  All offsets are 64-bit: a full-width
// pool passes 2^31 elements.
//
// Counters (K15, kCount = true, pass 1 only): they count the reference's
// walk over (sequence, head, page), whatever the segments.  Thread 0 of a
// page's first segment block adds the page as a visited tile (a live slab
// id and page * T < length, the reference's compute gate) with its T score
// lanes and the lanes past the length, or else as a skipped tile; block 0
// adds the launch (_attend_ctr, paged/kernel.py:63).  The count is taken
// before a dead block returns, so every block reaches ctr_accum.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 256;
constexpr int kMaxG = 16;
constexpr float kMaskValue = -1e30f;

struct AttendParams {
  const int64_t* tbl;
  int next;
  int64_t n_slabs;
  int clip_high;
  const int* pages;
  const int* lengths;
  int64_t KH, G, P, T, seg, nseg;
  int64_t slab_bytes;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Eight consecutive elements (16-byte aligned) as f32, in one or two
// 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
template <typename H>
__device__ __forceinline__ void load8(const H* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = to_f32(h[j]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Pass 1: grid (B * KH * P * nseg); block (seq b, head h, page p, segment).
template <typename T, int D, bool kCount>
__global__ void __launch_bounds__(kThreads)
attend_segments_kernel(const float* __restrict__ q, const int64_t* __restrict__ vtbl,
                       AttendParams a,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int* __restrict__ ctr) {
  __shared__ float qs[kMaxG * D];
  __shared__ float sc[kMaxG * kMaxSeg];
  __shared__ float red[kThreads / D > 0 ? (kThreads / D) * kMaxG * D : kMaxG * D];
  __shared__ float row_m[kMaxG], row_l[kMaxG];

  const int64_t part = blockIdx.x % (a.P * a.nseg);
  const int64_t bh = blockIdx.x / (a.P * a.nseg);
  const int64_t b = bh / a.KH, h = bh % a.KH;
  const int64_t page = part / a.nseg, seg = part % a.nseg;
  const int tid = threadIdx.x;
  const int G = static_cast<int>(a.G);
  float* out_m = part_m + (bh * a.P * a.nseg + part) * a.G;
  float* out_l = part_l + (bh * a.P * a.nseg + part) * a.G;
  float* out_acc = part_acc + (bh * a.P * a.nseg + part) * a.G * D;

  const int64_t len = a.lengths[b];
  int64_t slab = a.pages[b * a.P + page];
  if (a.clip_high && slab >= a.n_slabs) slab = a.n_slabs - 1;
  const int64_t t0 = page * a.T + seg * a.seg;  // first key position of the segment
  const bool live = slab >= 0 && slab < a.n_slabs && page * a.T < len && t0 < len;
  if constexpr (kCount) {
    int v[5] = {0, 0, 0, 0, 0};
    if (tid == 0) {
      v[0] = blockIdx.x == 0 ? 1 : 0;
      if (seg == 0) {
        const int visit = slab >= 0 && slab < a.n_slabs && page * a.T < len ? 1 : 0;
        const int64_t in_page = len - page * a.T;
        const int64_t kept = in_page < 0 ? 0 : (in_page > a.T ? a.T : in_page);
        v[1] = visit;
        v[2] = 1 - visit;
        v[3] = visit * static_cast<int>(a.T);
        v[4] = visit * static_cast<int>(a.T - kept);
      }
    }
    constexpr int slots[5] = {kAttendLaunches, kAttendTiles, kAttendTilesSkipped, kAttendLanes,
                              kAttendMaskedLanes};
    ctr_accum<kThreads>(ctr, slots, v);
  }
  if (!live) {
    for (int g = tid; g < G; g += kThreads) {
      out_m[g] = -CUDART_INF_F;
      out_l[g] = 0.f;
    }
    return;
  }
  const T* kslab = reinterpret_cast<const T*>(slab_address(a.tbl, a.next, slab, a.slab_bytes));
  const T* vslab = reinterpret_cast<const T*>(slab_address(vtbl, a.next, slab, a.slab_bytes));
  const int64_t rest = a.T - seg * a.seg;
  const int64_t n_tok = rest < a.seg ? rest : a.seg;  // tokens of this segment

  for (int idx = tid; idx < G * D; idx += kThreads) qs[idx] = q[bh * a.G * D + idx];
  __syncthreads();

  // scores: thread t <-> token seg*seg + t of the page
  for (int t = tid; t < n_tok; t += kThreads) {
    const int64_t slot = seg * a.seg + t;
    const T* krow = kslab + (slot * a.KH + h) * D;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kd[8];
      load8(krow + d0, kd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[g] = fmaf(qs[g * D + d0 + j], kd[j], s[g]);
      }
    }
    const bool in = page * a.T + slot < len;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)  // constant indices keep s[] in registers
      if (g < G) sc[g * kMaxSeg + t] = in ? s[g] : kMaskValue;
  }
  __syncthreads();

  // per-row max and sum over the segment: warp w takes rows w, w + 8, ...
  const int lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = -CUDART_INF_F;
    for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sc[g * kMaxSeg + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float pw = expf(sc[g * kMaxSeg + t] - mx);
      sc[g * kMaxSeg + t] = pw;
      sum += pw;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      row_m[g] = mx;
      row_l[g] = sum;
    }
  }
  __syncthreads();

  // P V: thread (d, part r) sums tokens r, r + R, ... for every row
  constexpr int R = kThreads / D > 0 ? kThreads / D : 1;
  const int d = tid % D, r = tid / D;
  if (r < R) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int64_t t = r; t < n_tok; t += R) {
      const float vd = to_f32(vslab[((seg * a.seg + t) * a.KH + h) * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(sc[g * kMaxSeg + t], vd, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) red[(r * kMaxG + g) * D + d] = acc[g];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, dd = idx - g * D;
    float sum = 0.f;
    for (int rr = 0; rr < R; ++rr) sum += red[(rr * kMaxG + g) * D + dd];
    out_acc[idx] = sum;
  }
  for (int g = tid; g < G; g += kThreads) {
    out_m[g] = row_m[g];
    out_l[g] = row_l[g];
  }
}

// Pass 2: grid (B * KH); merge the P * nseg segment states in page order.
template <int D>
__global__ void __launch_bounds__(kThreads)
attend_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, float* __restrict__ out, int64_t G,
                      int64_t nparts) {
  const int64_t bh = blockIdx.x;
  const float* pm = part_m + bh * nparts * G;
  const float* pl = part_l + bh * nparts * G;
  const float* pa = part_acc + bh * nparts * G * D;
  for (int64_t idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int64_t g = idx / D;
    float M = -CUDART_INF_F;
    for (int64_t i = 0; i < nparts; ++i) M = fmaxf(M, pm[i * G + g]);
    float L = 0.f, A = 0.f;
    if (M != -CUDART_INF_F) {
      for (int64_t i = 0; i < nparts; ++i) {
        const float mi = pm[i * G + g];
        if (mi == -CUDART_INF_F) continue;
        const float w = expf(mi - M);
        L = fmaf(pl[i * G + g], w, L);
        A = fmaf(pa[i * G * D + idx], w, A);
      }
    }
    out[bh * G * D + idx] = A / fmaxf(L, 1e-30f);
  }
}

template <typename T, int D>
int launch(const float* q, const AttendParams& a, const int64_t* vtbl, float* part_m,
           float* part_l, float* part_acc, float* out, int64_t B, int* ctr, cudaStream_t s) {
  const int64_t nparts = a.P * a.nseg;
  const int64_t grid = B * a.KH * nparts;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > 0) {
    auto kernel = ctr != nullptr ? attend_segments_kernel<T, D, true>
                                 : attend_segments_kernel<T, D, false>;
    kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(q, vtbl, a, part_m, part_l,
                                                            part_acc, ctr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attend_combine_kernel<D><<<static_cast<unsigned>(B * a.KH), kThreads, 0, s>>>(
      part_m, part_l, part_acc, out, a.G, nparts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int64_t D, const float* q, const AttendParams& a, const int64_t* vtbl,
             float* pm, float* pl, float* pa, float* out, int64_t B, int* ctr, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, a, vtbl, pm, pl, pa, out, B, ctr, s);
    case 32: return launch<T, 32>(q, a, vtbl, pm, pl, pa, out, B, ctr, s);
    case 64: return launch<T, 64>(q, a, vtbl, pm, pl, pa, out, B, ctr, s);
    case 128: return launch<T, 128>(q, a, vtbl, pm, pl, pa, out, B, ctr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ktable, vtable: device extent tables of the K and V pools (same geometry,
// next extents, n_slabs slabs of T tokens).  q, out: (B, KH, G, D) f32.
// pages: (B, P) int32; lengths: (B,) int32.  part_m, part_l: (B*KH*P*nseg*G)
// f32 scratch; part_acc: that times D.  seg: tokens per segment (<= 256).
// dtype: 0 = f32, 1 = bf16, 2 = f16 (the pools).  G <= 16.  ctr: a zeroed
// (kCtrSlots,) int32 counter block, or null for no counters.
extern "C" int rt_paged_attend(const void* ktable, const void* vtable, int next,
                               int64_t n_slabs, int clip_high, const void* q, const void* pages,
                               const void* lengths, void* part_m, void* part_l, void* part_acc,
                               void* out, int dtype, int64_t B, int64_t KH, int64_t G,
                               int64_t D, int64_t P, int64_t T, int64_t seg, void* ctr,
                               void* stream) {
  if (next < 1 || n_slabs < 1 || B < 0 || KH < 1 || G < 1 || G > kMaxG || P < 0 || T < 1 ||
      seg < 1 || seg > kMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  AttendParams a{};
  a.tbl = static_cast<const int64_t*>(ktable);
  a.next = next;
  a.n_slabs = n_slabs;
  a.clip_high = clip_high;
  a.pages = static_cast<const int*>(pages);
  a.lengths = static_cast<const int*>(lengths);
  a.KH = KH; a.G = G; a.P = P; a.T = T; a.seg = seg;
  a.nseg = (T + seg - 1) / seg;
  const int64_t elem = dtype == 0 ? 4 : 2;
  a.slab_bytes = T * KH * D * elem;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vt = static_cast<const int64_t*>(vtable);
  const auto* qf = static_cast<const float*>(q);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<int*>(ctr);
  switch (dtype) {
    case 0: return launch_d<float>(D, qf, a, vt, pm, pl, pa, o, B, c, s);
    case 1: return launch_d<__nv_bfloat16>(D, qf, a, vt, pm, pl, pa, o, B, c, s);
    case 2: return launch_d<__half>(D, qf, a, vt, pm, pl, pa, o, B, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
