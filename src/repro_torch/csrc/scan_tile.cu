// K1 — per-row inclusive prefix sum of an int32 (rows, cols) matrix.
//
// Replaces: src/repro/kernels/scan_tile/kernel.py::row_scan_pallas, which
// tiles 8x512 and carries the running total across column tiles in VMEM
// scratch, relying on the TPU's in-order grid.
//
// Bound on the card: bytes.  Each element is read once and written once
// (8 bytes per element); the adds are negligible next to that.
//
// Design: one thread block per row walks the row in chunks of 2048
// columns.  A chunk is loaded coalesced into shared memory, each thread
// scans 8 consecutive values in registers, the block scans the 256
// per-thread sums (block_exclusive_scan), and the chunk is stored back
// coalesced.  The running total of the row is carried from chunk to chunk
// in a register: this loop takes the place of the TPU's sequential grid
// carry.  Shared-memory indices are padded by one word every 32 so the
// per-thread 8-value runs fall in distinct banks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

__global__ void __launch_bounds__(kThreads)
row_scan_kernel(const int* __restrict__ x, int* __restrict__ out, int64_t cols) {
  __shared__ int tile[kChunk + kChunk / 32];
  __shared__ int scratch[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * cols;
  int carry = 0;
  for (int64_t c0 = 0; c0 < cols; c0 += kChunk) {
    for (int k = threadIdx.x; k < kChunk; k += kThreads) {
      const int64_t c = c0 + k;
      tile[padded(k)] = c < cols ? x[base + c] : 0;
    }
    __syncthreads();
    int run[kItems];
    int s = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      s += tile[padded(threadIdx.x * kItems + i)];
      run[i] = s;
    }
    int total;
    const int excl = block_exclusive_scan<kThreads>(s, scratch, &total) + carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i) tile[padded(threadIdx.x * kItems + i)] = run[i] + excl;
    __syncthreads();
    for (int k = threadIdx.x; k < kChunk; k += kThreads) {
      const int64_t c = c0 + k;
      if (c < cols) out[base + c] = tile[padded(k)];
    }
    carry += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int rt_row_scan_i32(const void* x, void* out, int64_t rows, int64_t cols,
                               void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  row_scan_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}
