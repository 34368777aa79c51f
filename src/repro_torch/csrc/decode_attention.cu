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
// (q . k) * scale in f32, as the reference.
//
// Bound on the card: bytes — every live K and V row is read once.
//
// Design (split-K, the flash-decoding scheme of K10 in paged_attend.cu over
// a contiguous cache).  B * KH is 8 at the serving shape, so one block per
// (sequence, head) would fill 8 of 132 SMs.  Pass 1 runs one block of 256
// threads per (sequence, head, segment of 256 keys); a segment wholly at or
// past the length writes m = -inf and returns (the reference's skipped
// blocks).  Each thread scores one live key against the G rows held in
// shared memory (its K row read in 16-byte loads), the block takes each
// row's max and sum, and threads split (dimension, key parity) to
// accumulate P V with coalesced V reads.  Keys past the length inside a
// segment are not visited: their masked weights are exactly 0 in the
// reference.  Pass 2 runs one block per (sequence, head), merges the
// segment states in order and writes acc / max(l, 1e-30) in the output
// dtype.  Offsets are 64-bit.
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 256;  // keys per pass-1 block
constexpr int kMaxG = 16;

struct DecodeParams {
  const int* lengths;
  int64_t S, KH, G, nseg;
  int64_t kb, kh, ks;  // K strides in elements: batch, head, token
  int64_t vb, vh, vs;  // V strides
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

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

__device__ __forceinline__ int64_t live_length(const DecodeParams& a, int64_t b) {
  const int64_t len = a.lengths[b];
  return len < 0 ? 0 : (len > a.S ? a.S : len);
}

// Pass 1: grid (B * KH * nseg); block (sequence b, head h, segment).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_segments_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, DecodeParams a, float* __restrict__ part_m,
                       float* __restrict__ part_l, float* __restrict__ part_acc) {
  __shared__ float qs[kMaxG * D];
  __shared__ float sc[kMaxG * kSeg];
  __shared__ float red[kThreads / D > 0 ? (kThreads / D) * kMaxG * D : kMaxG * D];
  __shared__ float row_m[kMaxG], row_l[kMaxG];

  const int64_t seg = blockIdx.x % a.nseg;
  const int64_t bh = blockIdx.x / a.nseg;
  const int64_t b = bh / a.KH, h = bh % a.KH;
  const int tid = threadIdx.x;
  const int G = static_cast<int>(a.G);
  float* out_m = part_m + (bh * a.nseg + seg) * a.G;
  float* out_l = part_l + (bh * a.nseg + seg) * a.G;
  float* out_acc = part_acc + (bh * a.nseg + seg) * a.G * D;

  const int64_t len = live_length(a, b);
  const int64_t t0 = seg * kSeg;
  if (t0 >= len) {
    for (int g = tid; g < G; g += kThreads) {
      out_m[g] = -CUDART_INF_F;
      out_l[g] = 0.f;
    }
    return;
  }
  const int64_t n_tok = len - t0 < kSeg ? len - t0 : kSeg;
  const T* kbase = k + b * a.kb + h * a.kh + t0 * a.ks;
  const T* vbase = v + b * a.vb + h * a.vh + t0 * a.vs;

  for (int idx = tid; idx < G * D; idx += kThreads) qs[idx] = to_f32(q[bh * a.G * D + idx]);
  __syncthreads();

  for (int t = tid; t < n_tok; t += kThreads) {
    const T* krow = kbase + t * a.ks;
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
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) sc[g * kSeg + t] = s[g] * a.scale;
  }
  __syncthreads();

  // per-row max and sum over the segment: warp w takes rows w, w + 8, ...
  const int lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = -CUDART_INF_F;
    for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sc[g * kSeg + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float pw = expf(sc[g * kSeg + t] - mx);
      sc[g * kSeg + t] = pw;
      sum += pw;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      row_m[g] = mx;
      row_l[g] = sum;
    }
  }
  __syncthreads();

  // P V: thread (d, part r) sums keys r, r + R, ... for every row
  constexpr int R = kThreads / D > 0 ? kThreads / D : 1;
  const int d = tid % D, r = tid / D;
  if (r < R) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int64_t t = r; t < n_tok; t += R) {
      const float vd = to_f32(vbase[t * a.vs + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(sc[g * kSeg + t], vd, acc[g]);
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

// Pass 2: grid (B * KH); merge the nseg segment states in order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out, int64_t G,
                      int64_t nseg) {
  const int64_t bh = blockIdx.x;
  const float* pm = part_m + bh * nseg * G;
  const float* pl = part_l + bh * nseg * G;
  const float* pa = part_acc + bh * nseg * G * D;
  for (int64_t idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int64_t g = idx / D;
    float M = -CUDART_INF_F;
    for (int64_t i = 0; i < nseg; ++i) M = fmaxf(M, pm[i * G + g]);
    float L = 0.f, A = 0.f;
    if (M != -CUDART_INF_F) {
      for (int64_t i = 0; i < nseg; ++i) {
        const float mi = pm[i * G + g];
        if (mi == -CUDART_INF_F) continue;
        const float w = expf(mi - M);
        L = fmaf(pl[i * G + g], w, L);
        A = fmaf(pa[i * G * D + idx], w, A);
      }
    }
    from_f32(A / fmaxf(L, 1e-30f), out + bh * G * D + idx);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const DecodeParams& a, float* pm,
           float* pl, float* pa, void* out, int64_t B, cudaStream_t s) {
  const int64_t grid = B * a.KH * a.nseg;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > 0) {
    decode_segments_kernel<T, D><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), a, pm, pl,
        pa);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_combine_kernel<T, D><<<static_cast<unsigned>(B * a.KH), kThreads, 0, s>>>(
      pm, pl, pa, static_cast<T*>(out), a.G, a.nseg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* k, const void* v, const DecodeParams& a,
             float* pm, float* pl, float* pa, void* out, int64_t B, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, a, pm, pl, pa, out, B, s);
    case 64: return launch<T, 64>(q, k, v, a, pm, pl, pa, out, B, s);
    case 128: return launch<T, 128>(q, k, v, a, pm, pl, pa, out, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int64_t rt_decode_segments(int64_t S) { return S > 0 ? (S + kSeg - 1) / kSeg : 1; }

// q, out: (B, KH, G, D) contiguous; k, v: strided (see above), 16-byte
// aligned rows; lengths: (B,) int32.  part_m, part_l: B*KH*nseg*G f32
// scratch, part_acc that times D, nseg = rt_decode_segments(S).  dtype:
// 0 = f32, 1 = bf16.  G <= 16, D in {32, 64, 128}.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* part_m, void* part_l,
                                   void* part_acc, void* out, int dtype, int64_t B, int64_t KH,
                                   int64_t G, int64_t D, int64_t S, int64_t kb, int64_t kh,
                                   int64_t ks, int64_t vb, int64_t vh, int64_t vs, float scale,
                                   void* stream) {
  if (B < 0 || KH < 1 || G < 1 || G > kMaxG || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  DecodeParams a{};
  a.lengths = static_cast<const int*>(lengths);
  a.S = S; a.KH = KH; a.G = G;
  a.nseg = rt_decode_segments(S);
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
