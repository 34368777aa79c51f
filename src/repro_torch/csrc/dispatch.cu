// K5a dispatch and K5b combine — the scatter and the gather that the
// reference writes as one-hot matrix products.
//
// Replaces: src/repro/kernels/dispatch_mxu/kernel.py::dispatch_pallas (K5a:
// out = P^T X, the one-hot matrix P[t, s] = (pos[t] == s) built tile by
// tile, accumulated in f32 over the sequential source-tile axis) and
// ::combine_pallas (K5b: out = P B).  Both are O(T S D) products on the MXU
// for what is a scatter and a gather; and the f32 product rounds int
// payloads above 2^24.
//
// Bound on the card: bytes.  Dispatch reads x (T D) and pos (T) once and
// writes out (S D) once; combine reads pos and the T gathered rows of buf
// and writes out (T D).
//
// Design.  K5a: the output is zero-filled by the first kernel (16-byte
// stores), then one thread per element of x adds it into its row with
// atomicAdd (f32 and bf16 natively on sm_90, int32 in two's
// complement): out[pos[t]] += x[t] where 0 <= pos[t] < S, other lanes
// dropped.  With unique positions every slot receives at most one addend,
// 0 + x is exact, and the result is bitwise the plain version's; where
// positions repeat, float sums depend on the order the atomics land in
// (int32 stays exact).  K5b: one thread per copy unit (16, 8, 4 or 2 bytes,
// the widest that divides a row) copies buf[clip(pos[t], 0, S - 1)] or
// writes zeros where pos[t] < 0, the plain version's rule.  64-bit indices
// throughout: the freeze's dispatch covers 2.7e8 lanes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
zero_fill_kernel(uint4* __restrict__ out16, unsigned char* __restrict__ tail, int64_t n16,
                 int64_t ntail) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n16;
       i += stride)
    out16[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < ntail;
       i += stride)
    tail[i] = 0;
}

__device__ __forceinline__ void add_at(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_at(__nv_bfloat16* p, __nv_bfloat16 v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_at(int* p, int v) { atomicAdd(p, v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ pos, T* __restrict__ out,
                int64_t T_, int64_t D, int64_t S) {
  const int64_t n = T_ * D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t t = D == 1 ? i : i / D;
    const int64_t p = pos[t];
    if (p >= 0 && p < S) add_at(out + p * D + (i - t * D), x[i]);
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const U* __restrict__ buf, const int* __restrict__ pos, U* __restrict__ out,
               int64_t T_, int64_t row_units, int64_t S) {
  const int64_t n = T_ * row_units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t t = row_units == 1 ? i : i / row_units;
    const int64_t p = pos[t];
    U v{};
    if (p >= 0) v = buf[(p < S ? p : S - 1) * row_units + (i - t * row_units)];
    out[i] = v;
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // grid-stride beyond a few waves of blocks
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <typename T>
int launch_dispatch(const void* x, const void* pos, void* out, int64_t T_, int64_t D, int64_t S,
                    cudaStream_t st) {
  const int64_t bytes = S * D * static_cast<int64_t>(sizeof(T));
  const int64_t n16 = bytes / 16;
  zero_fill_kernel<<<grid_for(n16 > 0 ? n16 : 1), kThreads, 0, st>>>(
      static_cast<uint4*>(out), static_cast<unsigned char*>(out) + n16 * 16, n16, bytes - n16 * 16);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T_ * D > 0)
    dispatch_kernel<T><<<grid_for(T_ * D), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(pos), static_cast<T*>(out), T_, D, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (T, D); pos: (T,) int32; out: (S, D), 16-byte aligned, written whole.
// dtype: 0 = f32, 1 = bf16, 2 = int32.
extern "C" int rt_dispatch(const void* x, const void* pos, void* out, int dtype, int64_t T_,
                           int64_t D, int64_t S, void* stream) {
  if (T_ < 0 || D < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S * D == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dispatch<float>(x, pos, out, T_, D, S, st);
    case 1: return launch_dispatch<__nv_bfloat16>(x, pos, out, T_, D, S, st);
    case 2: return launch_dispatch<int>(x, pos, out, T_, D, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// buf: (S, row_bytes); pos: (T,) int32; out: (T, row_bytes).  unit: the copy
// unit in bytes (16, 8, 4, 2 or 1), dividing row_bytes and both addresses.
extern "C" int rt_combine(const void* buf, const void* pos, void* out, int64_t T_,
                          int64_t row_bytes, int64_t S, int unit, void* stream) {
  if (T_ < 0 || row_bytes < 0 || S < 1 || unit < 1 || row_bytes % unit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_ * row_bytes == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t ru = row_bytes / unit;
  const auto* p = static_cast<const int*>(pos);
  switch (unit) {
    case 16:
      combine_kernel<uint4><<<grid_for(T_ * ru), kThreads, 0, st>>>(
          static_cast<const uint4*>(buf), p, static_cast<uint4*>(out), T_, ru, S);
      break;
    case 8:
      combine_kernel<uint2><<<grid_for(T_ * ru), kThreads, 0, st>>>(
          static_cast<const uint2*>(buf), p, static_cast<uint2*>(out), T_, ru, S);
      break;
    case 4:
      combine_kernel<unsigned><<<grid_for(T_ * ru), kThreads, 0, st>>>(
          static_cast<const unsigned*>(buf), p, static_cast<unsigned*>(out), T_, ru, S);
      break;
    case 2:
      combine_kernel<unsigned short><<<grid_for(T_ * ru), kThreads, 0, st>>>(
          static_cast<const unsigned short*>(buf), p, static_cast<unsigned short*>(out), T_, ru,
          S);
      break;
    case 1:
      combine_kernel<unsigned char><<<grid_for(T_ * ru), kThreads, 0, st>>>(
          static_cast<const unsigned char*>(buf), p, static_cast<unsigned char*>(out), T_, ru, S);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
