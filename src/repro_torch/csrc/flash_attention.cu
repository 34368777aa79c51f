// K13 — flash attention for prefill: softmax(q k^T * scale) v with an
// online softmax over KV tiles, GQA by head index, causal or not.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
// The TPU kernel runs a grid (BH, Sq/256, Skv/256) whose last axis is
// sequential, carrying the running max, denominator and accumulator in VMEM
// scratch from one KV step to the next.  Blocks on a GPU run in no order, so
// the KV walk is a loop inside one block, and the softmax state lives in
// registers.
//
// Layout: q, o are (B, H, Sq, D) and k, v are (B, KH, Skv, D), each given by
// three element strides (batch, head, position) with the last dimension
// contiguous.  The reference transposes the model's (B, S, H, D) tensors into
// (B*H, S, D) copies; here the wrapper hands over strided views, so nothing
// is copied on either side of the kernel.  Query head h of batch b reads KV
// head h / group of batch b directly (no repeated K/V in memory).
//
// Bound on the card: operations for long sequences (4*S^2*D flops per head,
// halved when causal, against S*D bytes per head).  This first version
// computes in f32 on the CUDA cores — the reference computes in f32, and a
// bf16 tensor-core product would round the probabilities — so it runs far
// from the bf16 tensor-core peak; the tensor-core version is later work.
//
// Design: one block of 128 threads (4 warps) per (b, h, tile of 64 query
// rows); each warp owns 16 rows.  KV tiles of 32 keys are staged in shared
// memory as f32 (K rows padded to D+1 floats, so lane j reading key j is
// conflict-free); lane j scores key j against the warp's 16 rows, a warp
// reduction gives each row's tile max and sum, and for the product with V
// lane l accumulates dimensions l, l+32, ... of all 16 rows, taking each
// probability from its owner lane by shuffle.  Causal blocks stop at the
// diagonal (tiles fully above it are never loaded), masked scores are
// -1e30 as in the reference, keys past Skv (a ragged last tile) are -inf,
// and the output is acc / max(l, 1e-30).  Shared memory: the 64-row Q tile
// plus one K and one V tile, 64.5 KB at D = 128 — above the 48 KB static
// limit, so it is dynamic shared memory, raised once per instantiation with
// cudaFuncSetAttribute.  All offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBK = 32;                     // keys per KV tile
constexpr float kMaskValue = -1e30f;

struct FlashParams {
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t H, group, Sq, Skv, n_qtiles;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * D + kBK * (D + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, FlashParams p) {
  constexpr int DC = (D + 31) / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                // [kBQ][D]
  float* ks = qs + kBQ * D;        // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);  // [kBK][D]

  const int64_t bh = blockIdx.x / p.n_qtiles;
  const int64_t q0 = (blockIdx.x % p.n_qtiles) * kBQ;
  const int64_t b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int64_t row = q0 + r;
    qs[idx] = row < p.Sq ? to_f32(qb[row * p.q_ss + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int64_t row0 = q0 + warp * kRowsPerWarp;
  const int64_t kv_end = (p.causal && q0 + kBQ < p.Skv) ? q0 + kBQ : p.Skv;

  for (int64_t kt = 0; kt < kv_end; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      const int64_t key = kt + j;
      const bool in = key < p.Skv;
      ks[j * (D + 1) + d] = in ? to_f32(kb[key * p.k_ss + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vb[key * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's 16 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qw = qs + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(qw + i * D + d);
        s[i] = fmaf(q4.x, k0, fmaf(q4.y, k1, fmaf(q4.z, k2, fmaf(q4.w, k3, s[i]))));
      }
    }
    const int64_t key = kt + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float si = s[i] * p.scale;
      if (p.causal && key > row0 + i) si = kMaskValue;
      if (key >= p.Skv) si = -CUDART_INF_F;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float pw = expf(si - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pw);
      m[i] = m_new;
      s[i] = pw;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pij = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pij, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t row = row0 + i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[row * p.o_ss + d] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const FlashParams& p,
           int64_t B, cudaStream_t stream) {
  static bool attr_set = false;  // per instantiation
  constexpr size_t smem = smem_bytes<D>();
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t grid = B * p.H * p.n_qtiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_kernel<T, D><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* k, const void* v, void* o,
             const FlashParams& p, int64_t B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, p, B, s);
    case 32: return launch<T, 32>(q, k, v, o, p, B, s);
    case 64: return launch<T, 64>(q, k, v, o, p, B, s);
    case 128: return launch<T, 128>(q, k, v, o, p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o alike).  strides: 12
// element strides, (batch, head, position) for q, k, v, o in that order.
// D must be 16, 32, 64 or 128; H a multiple of group.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int64_t B, int64_t H, int64_t group, int64_t Sq,
                                  int64_t Skv, int64_t D, const int64_t* strides, float scale,
                                  int causal, void* stream) {
  if (B < 0 || H < 1 || group < 1 || H % group || Sq < 0 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  FlashParams p{};
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.H = H; p.group = group; p.Sq = Sq; p.Skv = Skv;
  p.n_qtiles = (Sq + kBQ - 1) / kBQ;
  p.scale = scale;
  p.causal = causal;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, o, p, B, s);
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, o, p, B, s);
    case 2: return launch_d<__half>(D, q, k, v, o, p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
