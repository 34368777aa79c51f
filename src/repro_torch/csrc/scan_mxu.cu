// K2 — per-row inclusive prefix sum on the tensor cores (the Dakkak et al.
// matmul scan the paper's §III.B cites), int32 or f32, (rows, cols).
//
// Replaces: src/repro/kernels/scan_mxu/kernel.py::row_scan_pallas (body
// _scan_kernel), which multiplies each (8, 128) tile by the 128 x 128
// upper-triangular ones matrix U in f32 on the MXU and carries the running
// row total across column tiles in VMEM scratch, relying on the TPU's
// in-order grid.  Its f32 product is exact only while a tile's partial sums
// stay below 2^24.
//
// Bound on the card: bytes.  Each element is read once and written once
// (8 bytes per element); the tensor-core work per element is a few
// operations.
//
// Exactness.  int32: x is split into four byte planes, x = sum_p 256^p b_p
// with b_p in [0, 255].  Each plane is scanned with
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 against U (partial sums at most
// 32 * 255, exact in s32), and the planes are recombined as sum_p (scan_p
// << 8p) in 32-bit unsigned arithmetic.  Every step is exact modulo 2^32,
// so the result equals torch.cumsum(x, dtype=int32) bit for bit, wrap-around
// included.  A chunk whose values all lie in [0, 255] (every insertion mask)
// has zero upper planes: the warp detects that with one vote and scans only
// the low plane.  f32: split TF32, x = hi + lo with hi = tf32(x), lo =
// tf32(x - hi), Y = hi U + lo U with two m16n8k8 products per tile.  The
// third product of the usual 3xTF32 split (hi times U's low part) is zero
// here, because U's ones are exact in TF32.  The result agrees with
// torch.cumsum within float rounding of another summation order.
//
// Design (reduce-then-scan).  The TPU carried the row total through its
// sequential grid; on the card a warp walking a whole row serially would use
// 32 warps at (512, 262144).  So each row is cut into segments of 1024
// columns and the scan runs in three launches:
//   1. segment totals: one warp per (row, segment) sums its 1024 columns;
//   2. carries: one thread per row takes the exclusive prefix of its
//      segment totals (a few hundred at most);
//   3. scan: one warp per (16 rows, segment) walks the segment in chunks of
//      32 columns.  Each chunk is the A operand of the tensor-core products
//      against the triangular U blocks (one product per 8 output columns for
//      int32; ten per split part for f32, whose k-depth is 8), which gives
//      the chunk's local inclusive scan; the warp adds its running row
//      carry, stores, and advances the carry by the chunk's last column
//      (one shuffle).
// Ragged rows and columns load zeros and store nothing.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 32;                 // columns per tensor-core chunk
constexpr int kSeg = 1024;                 // columns per segment
constexpr int kScanWarps = 4;              // warps per block in pass 3
constexpr int kTotalThreads = 256;         // threads per block in passes 1, 2
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOneF32 = 0x3f800000u;  // 1.0f, exact in TF32

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Byte p of each of the four words, packed low to high (an A fragment
// register of the u8 product: four consecutive k of one row).
__device__ __forceinline__ unsigned byte_plane(const unsigned (&w)[4], int p) {
  const unsigned sel = static_cast<unsigned>(p) | (static_cast<unsigned>(p + 4) << 4);
  const unsigned lo = __byte_perm(w[0], w[1], sel);
  const unsigned hi = __byte_perm(w[2], w[3], sel);
  return __byte_perm(lo, hi, 0x5410);
}

// Four consecutive 32-bit words of a row from column c (zeros past cols);
// one 16-byte load where the row allows it.
__device__ __forceinline__ void load4(const unsigned* row, int64_t c, int64_t cols, bool vec,
                                      unsigned (&w)[4]) {
  if (vec && c + 3 < cols) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = c + i < cols ? row[c + i] : 0u;
}

// Sums in the scan's own arithmetic: modulo 2^32 for int32, f32 for float.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

// Pass 1: totals[s * rows + r] = sum of row r's segment s.  One warp per
// (row, segment).
template <typename T>
__global__ void __launch_bounds__(kTotalThreads)
segment_totals_kernel(const T* __restrict__ x, T* __restrict__ totals, int64_t rows,
                      int64_t cols, int64_t nseg) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kTotalThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows * nseg) return;
  const int64_t r = w / nseg, s = w % nseg;
  const T* row = x + r * cols;
  const int64_t c1 = (s + 1) * kSeg < cols ? (s + 1) * kSeg : cols;
  T acc = T(0);
  for (int64_t c = s * kSeg + lane; c < c1; c += 32) acc = add_wrap(acc, row[c]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc = add_wrap(acc, __shfl_xor_sync(kFull, acc, d));
  if (lane == 0) totals[s * rows + r] = acc;
}

// Pass 2: carries[s * rows + r] = sum of totals[s' * rows + r] for s' < s.
template <typename T>
__global__ void __launch_bounds__(kTotalThreads)
segment_carries_kernel(const T* __restrict__ totals, T* __restrict__ carries, int64_t rows,
                       int64_t nseg) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kTotalThreads + threadIdx.x;
  if (r >= rows) return;
  T run = T(0);
  for (int64_t s = 0; s < nseg; ++s) {
    carries[s * rows + r] = run;
    run = add_wrap(run, totals[s * rows + r]);
  }
}

// Pass 3, int32: one warp per (16 rows, segment).  Lane = 4 g + t holds rows
// g and g + 8 of the chunk (the fragment layouts of m16n8k32).
__global__ void __launch_bounds__(kScanWarps * 32)
scan_i32_kernel(const unsigned* __restrict__ x, const unsigned* __restrict__ carries,
                unsigned* __restrict__ out, int64_t rows, int64_t cols, int64_t nseg, int vec) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  const int64_t ngroups = (rows + 15) / 16;
  if (w >= ngroups * nseg) return;
  const int64_t r0 = (w / nseg) * 16, s = w % nseg;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ra = r0 + g, rb = r0 + g + 8;
  const bool oka = ra < rows, okb = rb < rows;
  const unsigned* xa = x + (oka ? ra : 0) * cols;
  const unsigned* xb = x + (okb ? rb : 0) * cols;
  unsigned carry_a = oka ? carries[s * rows + ra] : 0u;
  unsigned carry_b = okb ? carries[s * rows + rb] : 0u;

  // U's 32 x 8 blocks for output columns 8n .. 8n + 7 of the chunk:
  // B[k][j] = (k <= 8n + j), k = 4t + i (+16 for the second register), j = g.
  unsigned bu[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * t + i + 16 * half <= 8 * n + g) word |= 1u << (8 * i);
      bu[n][half] = word;
    }
  }

  const int64_t c_end = (s + 1) * kSeg < cols ? (s + 1) * kSeg : cols;
  for (int64_t c0 = s * kSeg; c0 < c_end; c0 += kChunk) {
    unsigned a0[4], a1[4], b0w[4], b1w[4];  // rows g / g+8, columns 4t.. and 16+4t..
    if (oka) {
      load4(xa, c0 + 4 * t, c_end, vec, a0);
      load4(xa, c0 + 16 + 4 * t, c_end, vec, a1);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a0[i] = a1[i] = 0u;
    }
    if (okb) {
      load4(xb, c0 + 4 * t, c_end, vec, b0w);
      load4(xb, c0 + 16 + 4 * t, c_end, vec, b1w);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) b0w[i] = b1w[i] = 0u;
    }
    unsigned any_high = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) any_high |= a0[i] | a1[i] | b0w[i] | b1w[i];
    const int planes = __all_sync(kFull, (any_high & 0xffffff00u) == 0u) ? 1 : 4;

    unsigned res[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) res[n][i] = 0u;
    for (int p = 0; p < planes; ++p) {
      const unsigned a[4] = {byte_plane(a0, p), byte_plane(b0w, p), byte_plane(a1, p),
                             byte_plane(b1w, p)};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        int d[4] = {0, 0, 0, 0};
        mma_u8(d, a, bu[n][0], bu[n][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) res[n][i] += static_cast<unsigned>(d[i]) << (8 * p);
      }
    }
    // chunk totals: column 31 lives in lane 4g + 3, fragment n = 3, i = 1 / 3
    const unsigned tot_a = __shfl_sync(kFull, res[3][1], 4 * g + 3);
    const unsigned tot_b = __shfl_sync(kFull, res[3][3], 4 * g + 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int64_t c = c0 + 8 * n + 2 * t;
      if (oka) {
        if (c < c_end) out[ra * cols + c] = res[n][0] + carry_a;
        if (c + 1 < c_end) out[ra * cols + c + 1] = res[n][1] + carry_a;
      }
      if (okb) {
        if (c < c_end) out[rb * cols + c] = res[n][2] + carry_b;
        if (c + 1 < c_end) out[rb * cols + c + 1] = res[n][3] + carry_b;
      }
    }
    carry_a += tot_a;
    carry_b += tot_b;
  }
}

// Pass 3, f32: split TF32 with m16n8k8 (k-depth 8, so a chunk is four
// k-tiles; output tile n sums k-tiles 0 .. n, the last one triangular).
__global__ void __launch_bounds__(kScanWarps * 32)
scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ carries,
                float* __restrict__ out, int64_t rows, int64_t cols, int64_t nseg) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  const int64_t ngroups = (rows + 15) / 16;
  if (w >= ngroups * nseg) return;
  const int64_t r0 = (w / nseg) * 16, s = w % nseg;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t ra = r0 + g, rb = r0 + g + 8;
  const bool oka = ra < rows, okb = rb < rows;
  const float* xa = x + (oka ? ra : 0) * cols;
  const float* xb = x + (okb ? rb : 0) * cols;
  float carry_a = oka ? carries[s * rows + ra] : 0.f;
  float carry_b = okb ? carries[s * rows + rb] : 0.f;
  // triangular 8 x 8 block: B[k][j] = (k <= j), k = t (b0) or t + 4 (b1), j = g
  const unsigned tri0 = t <= g ? kOneF32 : 0u;
  const unsigned tri1 = t + 4 <= g ? kOneF32 : 0u;

  const int64_t c_end = (s + 1) * kSeg < cols ? (s + 1) * kSeg : cols;
  for (int64_t c0 = s * kSeg; c0 < c_end; c0 += kChunk) {
    unsigned hi[4][4], lo[4][4];  // [k-tile][a register]
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int64_t ca = c0 + 8 * kt + t, cb = ca + 4;
      const float v[4] = {oka && ca < c_end ? xa[ca] : 0.f, okb && ca < c_end ? xb[ca] : 0.f,
                          oka && cb < c_end ? xa[cb] : 0.f, okb && cb < c_end ? xb[cb] : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[kt][i] = to_tf32(v[i]);
        lo[kt][i] = to_tf32(v[i] - __uint_as_float(hi[kt][i]));
      }
    }
    float res[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) res[n][i] = 0.f;
#pragma unroll
      for (int kt = 0; kt <= n; ++kt) {
        const unsigned b0 = kt == n ? tri0 : kOneF32, b1 = kt == n ? tri1 : kOneF32;
        mma_tf32(res[n], lo[kt], b0, b1);
      }
#pragma unroll
      for (int kt = 0; kt <= n; ++kt) {
        const unsigned b0 = kt == n ? tri0 : kOneF32, b1 = kt == n ? tri1 : kOneF32;
        mma_tf32(res[n], hi[kt], b0, b1);
      }
    }
    const float tot_a = __shfl_sync(kFull, res[3][1], 4 * g + 3);
    const float tot_b = __shfl_sync(kFull, res[3][3], 4 * g + 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int64_t c = c0 + 8 * n + 2 * t;
      if (oka) {
        if (c < c_end) out[ra * cols + c] = res[n][0] + carry_a;
        if (c + 1 < c_end) out[ra * cols + c + 1] = res[n][1] + carry_a;
      }
      if (okb) {
        if (c < c_end) out[rb * cols + c] = res[n][2] + carry_b;
        if (c + 1 < c_end) out[rb * cols + c + 1] = res[n][3] + carry_b;
      }
    }
    carry_a += tot_a;
    carry_b += tot_b;
  }
}

int64_t blocks_for(int64_t threads, int64_t per_block) { return (threads + per_block - 1) / per_block; }

}  // namespace

extern "C" int64_t rt_scan_mxu_segments(int64_t cols) { return (cols + kSeg - 1) / kSeg; }

// x, out: (rows, cols) row-major; dtype 0 = int32, 1 = f32.  totals and
// carries: rows * rt_scan_mxu_segments(cols) words of scratch.
extern "C" int rt_row_scan_mxu(const void* x, void* out, void* totals, void* carries, int dtype,
                               int64_t rows, int64_t cols, void* stream) {
  if (rows < 0 || cols < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t nseg = (cols + kSeg - 1) / kSeg;
  const int64_t tot_blocks = blocks_for(rows * nseg * 32, kTotalThreads);
  const int64_t car_blocks = blocks_for(rows, kTotalThreads);
  const int64_t scan_blocks = blocks_for(((rows + 15) / 16) * nseg, kScanWarps);
  if (tot_blocks > 0x7fffffffLL || scan_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e;
  if (dtype == 0) {
    auto xi = static_cast<const int*>(x);
    segment_totals_kernel<int><<<static_cast<unsigned>(tot_blocks), kTotalThreads, 0, st>>>(
        xi, static_cast<int*>(totals), rows, cols, nseg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    segment_carries_kernel<int><<<static_cast<unsigned>(car_blocks), kTotalThreads, 0, st>>>(
        static_cast<const int*>(totals), static_cast<int*>(carries), rows, nseg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const int vec = (cols % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    scan_i32_kernel<<<static_cast<unsigned>(scan_blocks), kScanWarps * 32, 0, st>>>(
        static_cast<const unsigned*>(x), static_cast<const unsigned*>(carries),
        static_cast<unsigned*>(out), rows, cols, nseg, vec);
  } else {
    auto xf = static_cast<const float*>(x);
    segment_totals_kernel<float><<<static_cast<unsigned>(tot_blocks), kTotalThreads, 0, st>>>(
        xf, static_cast<float*>(totals), rows, cols, nseg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    segment_carries_kernel<float><<<static_cast<unsigned>(car_blocks), kTotalThreads, 0, st>>>(
        static_cast<const float*>(totals), static_cast<float*>(carries), rows, nseg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    scan_f32_kernel<<<static_cast<unsigned>(scan_blocks), kScanWarps * 32, 0, st>>>(
        xf, static_cast<const float*>(carries), static_cast<float*>(out), rows, cols, nseg);
  }
  return static_cast<int>(cudaGetLastError());
}
