// K3 — fused push-back: per-block insertion offsets and the scatter into
// the geometric bucket levels, in one pass.
//
// Replaces: src/repro/kernels/push_back/kernel.py::push_back_pallas.  The
// TPU kernel computes the offsets with a VPU cumsum, builds the insert
// permutation as a one-hot reduction or an MXU matmul, and writes each
// level as a shifted-window gather, because TPU Pallas has no dynamic
// scatter.  None of that is needed here: the GPU scatters directly.
//
// Bound on the card: bytes.  Per lane it reads the mask byte and the item,
// and writes the position; per live lane it writes the item into its level
// (plus the sizes in and out).  There is no arithmetic to speak of.
//
// Design: one thread block per GGArray block, the paper's own layout.  The
// block walks the m lanes of its row in chunks of 1024 (one lane per
// thread), takes the exclusive scan of the mask in each chunk
// (block_exclusive_scan) and carries the count from chunk to chunk.  A
// live lane lands at in-block position p = size + offset; its level is
// L = floor(log2(p / B0 + 1)) (an integer __clzll), its slot in the level
// p - B0 (2^L - 1).  Writes past the last level are dropped, as the
// reference's mode="drop" scatter drops them, but the lane still reports p
// and the new size still counts it.  Items are copied as bits, in 4-byte
// words where the item size allows and 2-byte words otherwise, so f32,
// int32 and bf16 payloads come out exact.  All addressing is 64-bit.
//
// The level table is a kernel parameter of [group][level] pointers: a
// payload group sharing the mask (the KV cache's k/v/scales) is one more
// row of it.  Consecutive live lanes of a row write consecutive slots, so
// the stores coalesce except where a row crosses into its next level.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLevels = 32;
constexpr int kMaxGroups = 4;

struct PushBackTable {
  char* levels[kMaxGroups][kMaxLevels];
  const char* elems[kMaxGroups];
  int64_t item_bytes[kMaxGroups];
  int ngroups;
  int nlevels;
};

__device__ __forceinline__ void copy_item(char* dst, const char* src, int64_t nbytes) {
  if ((nbytes & 3) == 0) {
    for (int64_t k = 0; k < nbytes; k += 4)
      *reinterpret_cast<uint32_t*>(dst + k) = *reinterpret_cast<const uint32_t*>(src + k);
  } else {
    for (int64_t k = 0; k < nbytes; k += 2)
      *reinterpret_cast<uint16_t*>(dst + k) = *reinterpret_cast<const uint16_t*>(src + k);
  }
}

__global__ void __launch_bounds__(kThreads)
push_back_kernel(PushBackTable t, const unsigned char* __restrict__ mask,
                 const int* __restrict__ sizes, int* __restrict__ pos_out,
                 int* __restrict__ new_sizes, int64_t m, int64_t b0) {
  __shared__ int scratch[32];
  const int64_t row = blockIdx.x;
  const int size = sizes[row];
  int carry = 0;
  for (int64_t j0 = 0; j0 < m; j0 += kThreads) {
    const int64_t j = j0 + threadIdx.x;
    const int64_t lane = row * m + j;
    const int live = (j < m && mask[lane] != 0) ? 1 : 0;
    int total;
    const int off = block_exclusive_scan<kThreads>(live, scratch, &total);
    if (j < m) {
      const int p = size + carry + off;
      pos_out[lane] = live ? p : -1;
      if (live && p >= 0) {
        const int64_t q = static_cast<int64_t>(p) / b0 + 1;
        const int level = 63 - __clzll(q);
        if (level < t.nlevels) {
          const int64_t width = b0 << level;
          const int64_t slot = row * width + (p - b0 * ((int64_t{1} << level) - 1));
          for (int g = 0; g < t.ngroups; ++g) {
            const int64_t ib = t.item_bytes[g];
            copy_item(t.levels[g][level] + slot * ib, t.elems[g] + lane * ib, ib);
          }
        }
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) new_sizes[row] = size + carry;
}

}  // namespace

// level_ptrs: ngroups x nlevels device pointers, group-major.
// elem_ptrs, item_bytes: one per group.  Every pointer is device memory;
// the tables themselves are host arrays copied into the kernel parameter.
extern "C" int rt_push_back(void* const* level_ptrs, void* const* elem_ptrs,
                            const int64_t* item_bytes, int ngroups, int nlevels,
                            const void* mask, const void* sizes, void* pos_out,
                            void* new_sizes, int64_t nblocks, int64_t m, int64_t b0,
                            void* stream) {
  if (ngroups < 1 || ngroups > kMaxGroups || nlevels < 1 || nlevels > kMaxLevels ||
      b0 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0) return 0;
  PushBackTable t{};
  t.ngroups = ngroups;
  t.nlevels = nlevels;
  for (int g = 0; g < ngroups; ++g) {
    for (int l = 0; l < nlevels; ++l) t.levels[g][l] = static_cast<char*>(level_ptrs[g * nlevels + l]);
    t.elems[g] = static_cast<const char*>(elem_ptrs[g]);
    t.item_bytes[g] = item_bytes[g];
    if (item_bytes[g] <= 0 || (item_bytes[g] & 1)) return static_cast<int>(cudaErrorInvalidValue);
  }
  push_back_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const unsigned char*>(mask), static_cast<const int*>(sizes),
      static_cast<int*>(pos_out), static_cast<int*>(new_sizes), m, b0);
  return static_cast<int>(cudaGetLastError());
}
