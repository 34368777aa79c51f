// K14 — flash-decode: one query token per sequence against a contiguous K/V
// cache with a live length per sequence.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (body _decode_kernel), which packs the G query
// heads of a KV head into one (G, D) tile, walks the cache in blocks of bk
// keys on a sequential grid axis with the online-softmax state in VMEM,
// masks keys at or past the length with -1e30, skips blocks wholly past it,
// and divides by max(l, 1e-30), so a sequence of length 0 reads zeros.
//
// Inputs: q (B, KH, G, D) contiguous; k, v (B, KH, S, D) through element
// strides (batch, head, token) with D contiguous, so the op's head-major
// (B, KH, S, D) and the static cache's token-major (B, S, KH, D) both go
// in without a transpose; lengths (B,) int32.  q, k, v share one dtype (f32
// or bf16); the output (B, KH, G, D) has it too.  Scores are
// (q . k) * scale in f32 on the CUDA cores, as the reference; the output
// is held to a few ulps of its scale, which a bf16 P would not meet.
//
// Bound on the card: bytes — every live K and V row is read once.
//
// Design (flash-decoding split by the live length, one launch).  B * KH is
// 8 at the serving shape, so one block per (sequence, head) would fill 8
// of 132 SMs.  The host picks nsplit from S, B * KH and the SM count alone
// (kernels/decode_attention/kernel.py::num_splits, about two blocks a SM)
// and never reads the lengths; block i of (b, h) takes keys
// [len * i / nsplit, len * (i + 1) / nsplit), so every split of a long
// sequence has live work and no block walks a dead tail.  A block of 4
// warps streams its keys in chunks of at most 8 KB of K and 8 KB of V
// through a two-stage ring in shared memory (16-byte cp.async, consecutive
// threads on consecutive 16 bytes of a row; both stages are filled at the
// start).  Lane (j, s) of a warp holds dims [s * D/L, (s + 1) * D/L) of
// query rows j and j + G/2 in registers (G rounded up to 8 or 16; one row
// j when G <= 4, rounded up to 4; L lanes a row group); each warp scores
// its share of a chunk's keys one row of K at a time (each K element it
// converts feeds both rows' fmas, then log2(L) shuffles a row), keeps an
// online softmax per row and accumulates P V on the same dims, reading V
// rows the same way (bank-conflict free: the lanes of a group read
// distinct 16-byte pieces of a row, the groups broadcast).  The four warps
// merge in shared memory, in warp order, into the block's (m, l, acc),
// written to scratch; the block then takes a ticket from an int32 counter
// per (b, h), and the last block merges the nsplit states in split order
// (so the result does not depend on which block finished last), writes
// acc / max(l, 1e-30) in the output dtype and resets the counter to 0.  The
// wrapper keeps the counters per device (zeroed once, grown with B * KH),
// so launches on one device run in stream order.  In the merge a warp
// takes each row's max and denominator over the splits by shuffles, and
// each thread sums 4 consecutive elements, eight splits' loads in flight.
// Keys past the length are never read; a split with no keys writes
// m = -inf and a zero acc, which weigh nothing in the merge.  Offsets are
// 64-bit.
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kStageBytes = 8192;  // one chunk of K (or V) rows
constexpr int kMaxSplits = 128;
constexpr int kBufBytes = 4 * kStageBytes;  // K and V, two stages each

struct DecodeParams {
  const int* lengths;
  int* tickets;
  int64_t S, KH, G, nsplit;
  int64_t kb, kh, ks;  // K strides in elements: batch, head, token
  int64_t vb, vh, vs;  // V strides
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// N elements at p (N * sizeof(T) a multiple of 8, p aligned to it) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / E; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < E; ++j) out[i * E + j] = to_f32(e[j]);
    }
  } else {
    static_assert(kBytes % 8 == 0, "8-byte pieces");
    constexpr int E = 8 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / E; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < E; ++j) out[i * E + j] = to_f32(e[j]);
    }
  }
}

template <typename T, int D>
struct Chunk {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kKeys = kStageBytes / kRowBytes < 64 ? kStageBytes / kRowBytes : 64;
  static constexpr int kPerWarp = kKeys / kWarps;
  static constexpr int kCopies = kKeys * kRowBytes / 16;  // 16-byte copies per chunk
};

// Keys [first, first + kKeys) of one (b, h) into a stage; rows at or past
// `n` keys from `first` are zero-filled, not read.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(uint32_t dst, const T* __restrict__ base, int64_t stride,
                                           int64_t first, int64_t n, int tid) {
  constexpr int C = Chunk<T, D>::kRowBytes / 16;
  for (int idx = tid; idx < Chunk<T, D>::kCopies; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const bool in = r < n;
    const T* row = base + (first + (in ? r : 0)) * stride;
    cp_async16(dst + idx * 16, reinterpret_cast<const char*>(row) + c * 16, in);
  }
}

// grid (B * KH * nsplit); block (b, h, split).  GP: G rounded up to 4, 8 or
// 16.  A lane holds R query rows (R = 2 from GP = 8: each K or V element it
// converts feeds two rows' fmas).
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    DecodeParams a, float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, T* __restrict__ out) {
  using Ch = Chunk<T, D>;
  constexpr int R = GP >= 8 ? 2 : 1;  // query rows a lane
  constexpr int RG = GP / R;          // row groups a warp: lane group j holds rows j + r * RG
  constexpr int LPR = 32 / RG;        // lanes a row group
  constexpr int DPL = D / LPR;        // dims a lane
  constexpr int kVec = (DPL * sizeof(T)) % 16 == 0 ? 16 / sizeof(T) : 8 / sizeof(T);
  static_assert(DPL % kVec == 0 && GP * D * kWarps * 4 <= kBufBytes, "shapes");
  static_assert(2 * kMaxSplits * GP * 4 <= kBufBytes, "the merge's m and l fit the buffer");
  __shared__ __align__(16) unsigned char buf[kBufBytes];
  __shared__ float red_m[kWarps][GP], red_l[kWarps][GP], red_w[kWarps][GP], row_l[GP];
  __shared__ int s_last;

  const int64_t split = blockIdx.x % a.nsplit;
  const int64_t bh = blockIdx.x / a.nsplit;
  const int64_t b = bh / a.KH, h = bh % a.KH;
  const int G = static_cast<int>(a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, sl = lane % LPR;

  int64_t len = a.lengths[b];
  len = len < 0 ? 0 : (len > a.S ? a.S : len);
  const int64_t lo = len * split / a.nsplit, hi = len * (split + 1) / a.nsplit;
  const T* kbase = k + b * a.kb + h * a.kh + lo * a.ks;
  const T* vbase = v + b * a.vb + h * a.vh + lo * a.vs;
  const uint32_t s_buf = smem_u32(buf);

  const int64_t n_keys = hi - lo;
  const int64_t n_chunks = (n_keys + Ch::kKeys - 1) / Ch::kKeys;
  // chunk c goes to stage c & 1; both stages are in flight from the start
  for (int c = 0; c < 2 && c < n_chunks; ++c) {
    const int64_t first = c * Ch::kKeys;
    load_chunk<T, D>(s_buf + c * kStageBytes, kbase, a.ks, first, n_keys - first, tid);
    load_chunk<T, D>(s_buf + (2 + c) * kStageBytes, vbase, a.vs, first, n_keys - first, tid);
    cp_async_commit();
  }

  float qr[R][DPL], acc[R][DPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = rg + r * RG;
    if (g < G) {
      load_vec<T, DPL>(q + (bh * a.G + g) * D + sl * DPL, qr[r]);
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
    const int st = static_cast<int>(c & 1);
    if (c + 1 < n_chunks) cp_async_wait_one(); else cp_async_wait_all();  // chunk c has landed ...
    __syncthreads();  // ... for every thread
    const T* ks = reinterpret_cast<const T*>(buf + st * kStageBytes);
    const T* vs = reinterpret_cast<const T*>(buf + (2 + st) * kStageBytes);
    const int64_t left = n_keys - c * Ch::kKeys - warp * Ch::kPerWarp;  // this warp's keys
    const int nk = left <= 0 ? 0 : (left < Ch::kPerWarp ? static_cast<int>(left) : Ch::kPerWarp);
    const int j0 = warp * Ch::kPerWarp;

    float sc[R][Ch::kPerWarp], mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = m[r];
#pragma unroll
    for (int i = 0; i < Ch::kPerWarp; ++i) {
      if (i < nk) {
        const T* krow = ks + (j0 + i) * D + sl * DPL;
        float d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = 0.f;
#pragma unroll
        for (int x0 = 0; x0 < DPL; x0 += kVec) {
          float kv[kVec];
          load_vec<T, kVec>(krow + x0, kv);
#pragma unroll
          for (int x = 0; x < kVec; ++x)
#pragma unroll
            for (int r = 0; r < R; ++r) d[r] = fmaf(qr[r][x0 + x], kv[x], d[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int o = LPR / 2; o >= 1; o >>= 1) d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
          sc[r][i] = d[r] * a.scale;
          mx[r] = fmaxf(mx[r], sc[r][i]);
        }
      }
    }
    if (nk > 0) {
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
        if (i < nk) {
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
            load_vec<T, kVec>(vrow + x0, vv);
#pragma unroll
            for (int x = 0; x < kVec; ++x)
#pragma unroll
              for (int r = 0; r < R; ++r) acc[r][x0 + x] = fmaf(p[r], vv[x], acc[r][x0 + x]);
          }
        }
      }
    }
    if (c + 2 < n_chunks) {  // refill this stage with chunk c + 2
      __syncthreads();
      const int64_t first = (c + 2) * Ch::kKeys;
      load_chunk<T, D>(s_buf + st * kStageBytes, kbase, a.ks, first, n_keys - first, tid);
      load_chunk<T, D>(s_buf + (2 + st) * kStageBytes, vbase, a.vs, first, n_keys - first, tid);
      cp_async_commit();
    }
  }

  // the four warps' states → the block's, in warp order
  __syncthreads();  // every warp is done with the ring: reuse it
  float* wacc = reinterpret_cast<float*>(buf);  // [kWarps][GP][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = rg + r * RG;
    if (g < G) {
#pragma unroll
      for (int x = 0; x < DPL; ++x) wacc[(warp * GP + g) * D + sl * DPL + x] = acc[r][x];
      if (sl == 0) {
        red_m[warp][g] = m[r];
        red_l[warp][g] = l[r];
      }
    }
  }
  __syncthreads();
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
    part_m[slot * a.G + tid] = M;  // -inf: no key in this split
    part_l[slot * a.G + tid] = Lb;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {  // an empty split writes zeros
    const int gg = e / D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A = fmaf(red_w[w][gg], wacc[w * GP * D + e], A);
    part_acc[slot * a.G * D + e] = A;
  }

  // ticket: the last block of (b, h) merges the splits in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.tickets + bh, 1) == a.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* pm = part_m + bh * a.nsplit * a.G;
  const float* pl = part_l + bh * a.nsplit * a.G;
  const float* pa = part_acc + bh * a.nsplit * a.G * D;
  float* wts = reinterpret_cast<float*>(buf);  // [GP][nsplit] states' m, then weights
  float* ls = wts + kMaxSplits * GP;           // [GP][nsplit] states' l
  const int ns = static_cast<int>(a.nsplit);
  for (int e = tid; e < ns * G; e += kThreads) {
    const int i = e / G, gg = e % G;
    wts[gg * ns + i] = __ldcg(pm + e);
    ls[gg * ns + i] = __ldcg(pl + e);
  }
  __syncthreads();
  // warp w takes rows w, w + 4, ...; lane j the splits j, j + 32, ... (a
  // fixed tree: the sums do not depend on timing)
  for (int gg = warp; gg < G; gg += kWarps) {
    float M = -CUDART_INF_F;
    for (int i = lane; i < ns; i += 32) M = fmaxf(M, wts[gg * ns + i]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float Lt = 0.f;
    for (int i = lane; i < ns; i += 32) {
      const float mi = wts[gg * ns + i];
      const float wt = mi == -CUDART_INF_F ? 0.f : expf(mi - M);  // 0: no key, or all -inf
      wts[gg * ns + i] = wt;
      Lt = fmaf(ls[gg * ns + i], wt, Lt);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) Lt += __shfl_xor_sync(0xffffffffu, Lt, o);
    if (lane == 0) row_l[gg] = fmaxf(Lt, 1e-30f);
  }
  __syncthreads();
  // each thread sums 4 consecutive elements over the splits, in split order
  constexpr int kE4 = (GP * D / 4 + kThreads - 1) / kThreads;
  const int n4 = G * D / 4;
  float4 A[kE4];
#pragma unroll
  for (int j = 0; j < kE4; ++j) A[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < ns; ++i) {
    const float4* pai = reinterpret_cast<const float4*>(pa + i * a.G * D);
#pragma unroll
    for (int j = 0; j < kE4; ++j) {
      const int e4 = tid + j * kThreads;
      if (e4 < n4) {
        const float wt = wts[(e4 * 4 / D) * ns + i];
        const float4 x = __ldcg(pai + e4);
        A[j].x = fmaf(x.x, wt, A[j].x);
        A[j].y = fmaf(x.y, wt, A[j].y);
        A[j].z = fmaf(x.z, wt, A[j].z);
        A[j].w = fmaf(x.w, wt, A[j].w);
      }
    }
  }
  T* ob = out + bh * a.G * D;
#pragma unroll
  for (int j = 0; j < kE4; ++j) {
    const int e4 = tid + j * kThreads;
    if (e4 < n4) {
      const float den = row_l[e4 * 4 / D];
      from_f32(A[j].x / den, ob + 4 * e4);
      from_f32(A[j].y / den, ob + 4 * e4 + 1);
      from_f32(A[j].z / den, ob + 4 * e4 + 2);
      from_f32(A[j].w / den, ob + 4 * e4 + 3);
    }
  }
  if (tid == 0) a.tickets[bh] = 0;
}

template <typename T, int D, int GP>
int launch(const void* q, const void* k, const void* v, const DecodeParams& a, float* pm,
           float* pl, float* pa, void* out, int64_t B, cudaStream_t s) {
  const int64_t grid = B * a.KH * a.nsplit;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_split_kernel<T, D, GP><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), a, pm, pl, pa,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const DecodeParams& a, float* pm,
             float* pl, float* pa, void* out, int64_t B, cudaStream_t s) {
  if (a.G <= 4) return launch<T, D, 4>(q, k, v, a, pm, pl, pa, out, B, s);
  if (a.G <= 8) return launch<T, D, 8>(q, k, v, a, pm, pl, pa, out, B, s);
  return launch<T, D, 16>(q, k, v, a, pm, pl, pa, out, B, s);
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* k, const void* v, const DecodeParams& a,
             float* pm, float* pl, float* pa, void* out, int64_t B, cudaStream_t s) {
  switch (D) {
    case 32: return launch_g<T, 32>(q, k, v, a, pm, pl, pa, out, B, s);
    case 64: return launch_g<T, 64>(q, k, v, a, pm, pl, pa, out, B, s);
    case 128: return launch_g<T, 128>(q, k, v, a, pm, pl, pa, out, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_decode_max_splits() { return kMaxSplits; }

// q, out: (B, KH, G, D) contiguous, 16-byte aligned; k, v: strided (see
// above), 16-byte aligned rows; lengths: (B,) int32.  part_m, part_l:
// B*KH*nsplit*G f32 scratch, part_acc that times D, 16-byte aligned.  tickets: at least
// B*KH int32, all 0 (the kernel leaves them 0).  dtype: 0 = f32, 1 = bf16.
// G <= 16, D in {32, 64, 128}, 1 <= nsplit <= rt_decode_max_splits().
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* part_m, void* part_l,
                                   void* part_acc, void* tickets, void* out, int dtype, int64_t B,
                                   int64_t KH, int64_t G, int64_t D, int64_t S, int64_t nsplit,
                                   int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh,
                                   int64_t vs, float scale, void* stream) {
  if (B < 0 || KH < 1 || G < 1 || G > kMaxG || S < 0 || nsplit < 1 || nsplit > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  DecodeParams a{};
  a.lengths = static_cast<const int*>(lengths);
  a.tickets = static_cast<int*>(tickets);
  a.S = S; a.KH = KH; a.G = G; a.nsplit = nsplit;
  a.kb = kb; a.kh = kh; a.ks = ks;
  a.vb = vb; a.vh = vh; a.vs = vs;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, a, pm, pl, pa, out, B, s);
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, a, pm, pl, pa, out, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
