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
// head h / group of batch b directly (no repeated K/V in memory).  Causal
// masks key > query row (absolute indices), as the reference.
//
// Bound on the card: operations for long sequences (4*S^2*D flops per head,
// halved when causal, against S*D bytes per head), at the bf16 tensor-core
// peak.
//
// bf16 and f16 inputs: the tensor-core kernel (flash_fwd_wgmma_kernel), the
// FlashAttention-2 scheme on Hopper's warpgroup products.  One block of two
// warpgroups takes 128 query rows of one (b, h), 64 a warpgroup.  Q stays in
// shared memory for the whole walk; K and V stream in tiles of 64 keys
// through a two-stage ring, filled by 16-byte cp.async (a row past Sq or
// Skv and the columns of D padded to 64 are zero-filled), in the layout
// wgmma reads with the 128-byte swizzle.  S = Q K^T is
// wgmma.m64n64k16 with both operands in shared memory (K-major), f32
// accumulators; the online softmax runs on the accumulator's own layout
// (row max and row sum by two quad shuffles), in base 2 with the scale and
// log2(e) folded into the scores (ex2.approx); P is rounded to the input
// type in registers (S's accumulator layout is the A-fragment layout of the
// next product, no shared-memory pass) and O += P V is wgmma.m64nDk16 with
// A from registers and V from shared memory read MN-major (transposed by
// the instruction).  The denominator l sums the f32 probabilities before
// that rounding.  One barrier per KV tile: after it, the next tile's copies
// are issued into the stage the previous tile used and overlap this tile's
// products; two blocks a SM (at most 128 registers a thread), so one
// block's softmax runs under the other's products.  Causal: tiles wholly
// above the diagonal are never loaded, a warpgroup skips a tile wholly
// above its rows, only tiles that cross the diagonal (or the ragged end of
// Skv) are masked, and the block index is reversed over query tiles so
// that the longest walks start first.  No atomics and no split over keys:
// two launches on the same inputs are bitwise equal.  Needs 16-byte-aligned
// base pointers and strides (the wrapper checks and raises).  Shared memory
// (128 + 4 x 64) * DP * 2 bytes + 1 KB, 97 KB at D = 128.
//
// f32 inputs: the CUDA-core kernel (flash_fwd_kernel), exact f32 products.
// One block of 128 threads (4 warps) per (b, h, tile of 64 query rows);
// each warp owns 16 rows.  KV tiles of 32 keys are staged in shared memory
// as f32 (K rows padded to D+1 floats, so lane j reading key j is
// conflict-free); lane j scores key j against the warp's 16 rows, a warp
// reduction gives each row's tile max and sum, and for the product with V
// lane l accumulates dimensions l, l+32, ... of all 16 rows, taking each
// probability from its owner lane by shuffle.  Causal blocks stop at the
// diagonal, masked scores are -1e30 as in the reference, keys past Skv (a
// ragged last tile) are -inf.  Shared memory: the 64-row Q tile plus one K
// and one V tile, 64.5 KB at D = 128.
//
// Both write acc / max(l, 1e-30) in the input type; dynamic shared memory
// above 48 KB is raised once per instantiation with cudaFuncSetAttribute.
// All offsets are 64-bit.
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
  int64_t H, group, Sq, Skv, n_qtiles, BH;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16 / f16: the tensor-core kernel.
namespace wg {

constexpr int kGroups = 2;               // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * kGroups;
constexpr int kBQ = 64 * kGroups;        // query rows per block
constexpr int kBK = 64;                  // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// Tiles of 128-byte rows in the layout wgmma reads with the 128-byte
// swizzle: columns in blocks of 64 elements; in block cb, row r's 16-byte
// chunk c sits at cb * rows * 128 + r * 128 + ((c ^ (r & 7)) << 4).  Tile
// bases are 1024-byte aligned.  DP = D rounded up to 64 (the padding is
// zero-filled, so it adds nothing to Q K^T and its output columns are
// dropped).
template <int DP>
struct Tile {
  static constexpr uint32_t kQBytes = kBQ * DP * 2;
  static constexpr uint32_t kKVBytes = kBK * DP * 2;
  // Q, K x2, V x2, and room to align the base to 1024 bytes
  static constexpr size_t kSmem = kQBytes + 4 * static_cast<size_t>(kKVBytes) + 1024;
};

__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return static_cast<uint32_t>((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Rows [row0, row0 + kRows) of a strided (rows, D) matrix into a tile by
// cp.async; rows at or past `limit` and chunks past D are zero-filled.
template <int DP, int kRows, typename T>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* __restrict__ src, int64_t stride,
                                          int64_t row0, int64_t limit, int D, int tid) {
  constexpr int C = DP / 8;
  static_assert(kRows * C % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < kRows * C / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / C, c = idx % C;
    const int64_t row = row0 + r;
    const bool in = row < limit && c * 8 < D;
    cp_async16(dst + sw128(kRows, r, c), src + (in ? row * stride + c * 8 : 0), in);
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// after wait_all: the accumulators are read only from here on
template <int N>
__device__ __forceinline__ void settle(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16, shared) * B (16 x 64, shared, K-major)
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d);
// d (64 x N) += A (64 x 16, registers) * B (16 x N, shared, MN-major)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

#define K13_WGMMA_SS(CT, PT) \
template <> \
__device__ __forceinline__ void wgmma_ss<CT>(float (&d)[32], uint64_t a, uint64_t b, \
                                             int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d)); \
}

#define K13_WGMMA_RS64(CT, PT) \
template <> \
__device__ __forceinline__ void wgmma_rs<CT, 64>(float (&d)[32], const uint32_t (&a)[4], \
                                                 uint64_t b) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
}

#define K13_WGMMA_RS128(CT, PT) \
template <> \
__device__ __forceinline__ void wgmma_rs<CT, 128>(float (&d)[64], const uint32_t (&a)[4], \
                                                 uint64_t b) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." PT "." PT " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
        "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
}

K13_WGMMA_SS(__nv_bfloat16, "bf16")
K13_WGMMA_SS(__half, "f16")
K13_WGMMA_RS64(__nv_bfloat16, "bf16")
K13_WGMMA_RS64(__half, "f16")
K13_WGMMA_RS128(__nv_bfloat16, "bf16")
K13_WGMMA_RS128(__half, "f16")
#undef K13_WGMMA_SS
#undef K13_WGMMA_RS64
#undef K13_WGMMA_RS128

// Two floats rounded to the input type, `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x by the SFU (ex2.approx: relative error about 2^-22, far below the
// bf16 rounding P gets next; -inf gives 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks a SM
flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, FlashParams p, int D) {
  using L = Tile<DP>;
  constexpr int KS = DP / 16;  // k-steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + L::kQBytes;  // stage st at + st * kKVBytes
  const uint32_t s_v = s_k + 2 * L::kKVBytes;

  const int64_t bh = blockIdx.x % p.BH;
  const int64_t q0 = (p.n_qtiles - 1 - blockIdx.x / p.BH) * kBQ;  // longest walks first
  const int64_t b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int gr = lane >> 2, tq = lane & 3;
  const int64_t grow = q0 + grp * 64;      // this warpgroup's first row
  const int64_t wrow = grow + wq * 16;     // this warp's first row
  const int64_t kv_end = (p.causal && q0 + kBQ < p.Skv) ? q0 + kBQ : p.Skv;
  const int ntiles = static_cast<int>((kv_end + kBK - 1) / kBK);
  const float sl = p.scale * kLog2e;

  load_rows<DP, kBQ>(s_q, qb, p.q_ss, q0, p.Sq, D, tid);
  load_rows<DP, kBK>(s_k, kb, p.k_ss, 0, p.Skv, D, tid);
  load_rows<DP, kBK>(s_v, vb, p.v_ss, 0, p.Skv, D, tid);
  cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    cp_async_wait_all();  // tile it has landed ...
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma's reads
    __syncthreads();      // ... for every thread, and tile it - 1 is consumed
    if (it + 1 < ntiles) {
      const int64_t kn = static_cast<int64_t>(it + 1) * kBK;
      load_rows<DP, kBK>(s_k + (st ^ 1) * L::kKVBytes, kb, p.k_ss, kn, p.Skv, D, tid);
      load_rows<DP, kBK>(s_v + (st ^ 1) * L::kKVBytes, vb, p.v_ss, kn, p.Skv, D, tid);
      cp_async_commit();
    }
    const int64_t kt = static_cast<int64_t>(it) * kBK;
    if (p.causal && kt > grow + 63) continue;  // every key above this warpgroup's rows
    const uint32_t sk = s_k + st * L::kKVBytes, sv = s_v + st * L::kKVBytes;

    // S = Q K^T: 64 rows x 64 keys a warpgroup
    float s[32];
    fence();
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const uint32_t off = (j & 3) * 32;  // 16 columns of a 64-column block
      wgmma_ss<T>(s, desc(s_q + (j >> 2) * kBQ * 128 + grp * 64 * 128 + off, 0, 1024),
                  desc(sk + (j >> 2) * kBK * 128 + off, 0, 1024), j > 0);
    }
    commit();
    wait_all();
    settle(s);

    // base-2 scores; mask only a tile that crosses the diagonal or Skv
    const bool edge = (p.causal && kt + kBK - 1 > wrow) || kt + kBK > p.Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl;
      if (edge) {
        const int64_t key = kt + (i >> 2) * 8 + 2 * tq + (i & 1);
        const int64_t row = wrow + gr + ((i >> 1) & 1) * 8;
        if (key >= p.Skv || (p.causal && key > row)) x = -CUDART_INF_F;
      }
      s[i] = x;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];
      alpha[r] = exp2_fast(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2_fast(s[i] - base[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P's A fragments are S's accumulators, rounded to T
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack2<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        asm volatile("" : "+r"(pa[kk][e])::"memory");
      }
    }
    settle(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<T, DP>(acc, pa[kk], desc(sv + kk * 16 * 128, kBK * 128, 1024));
    commit();
    wait_all();
    settle(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = wrow + gr + 8 * r;
    if (row >= p.Sq) continue;
    T* orow = ob + row * p.o_ss + 2 * tq;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack2<T>(acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, const FlashParams& p, int D,
           cudaStream_t stream) {
  static bool attr_set = false;  // per instantiation
  constexpr size_t smem = Tile<DP>::kSmem;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, DP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t grid = p.BH * p.n_qtiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd_wgmma_kernel<T, DP><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// f32: the CUDA-core kernel.
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

// bf16 / f16: D in {16, 32, 64} runs padded to 64 columns, 128 as it is.
template <typename T>
int launch_wg(int64_t D, const void* q, const void* k, const void* v, void* o,
              const FlashParams& p, cudaStream_t s) {
  if (D == 128) return wg::launch<T, 128>(q, k, v, o, p, 128, s);
  if (D == 16 || D == 32 || D == 64)
    return wg::launch<T, 64>(q, k, v, o, p, static_cast<int>(D), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o alike).  strides: 12
// element strides, (batch, head, position) for q, k, v, o in that order.
// D must be 16, 32, 64 or 128; H a multiple of group.  bf16 / f16: every
// base pointer and stride 16-byte aligned (the wrapper checks).
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
  p.BH = B * H;
  const int64_t bq = dtype == 0 ? kBQ : wg::kBQ;  // query rows a block
  p.n_qtiles = (Sq + bq - 1) / bq;
  p.scale = scale;
  p.causal = causal;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(D, q, k, v, o, p, B, s);
    case 1: return launch_wg<__nv_bfloat16>(D, q, k, v, o, p, s);
    case 2: return launch_wg<__half>(D, q, k, v, o, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
