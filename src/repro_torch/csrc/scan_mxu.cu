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
// tf32(x - hi), Y = hi U + lo U with m16n8k8 products.  The third product
// of the usual 3xTF32 split (hi times U's low part) is zero here, because
// U's ones are exact in TF32.  The result agrees with torch.cumsum within
// float rounding of another summation order, and is the same bits from
// launch to launch: every sum is taken in a fixed order.
//
// Design: one launch, a chained single pass, x read once.
//   * A tile is 16 rows x kTileCols = 1024 columns.  A block of kWarps = 8
//     warps scans one tile; warp w owns kChunks = 4 consecutive 32-column
//     chunks of it, held in registers from load to store (128 a thread),
//     and two blocks share a SM, so one's wait and stores overlap the
//     other's loads.  (16 warps on 16 x 2048 tiles, one block a SM, measured
//     2 to 4 % slower; tools/freeze_variants.py.)
//   * Blocks take tiles from a ticket counter (atomicAdd), not blockIdx:
//     ticket t is row group t mod ngroups, column tile t div ngroups, so a
//     tile's predecessor in its rows took an earlier ticket and is running
//     or done whenever the tile waits for it (no deadlock, whatever order
//     the blocks are scheduled in).
//   * Per tile: (1) every thread issues all its 16-byte loads; (2) each
//     chunk is scanned on the tensor cores (a chunk is the A operand of the
//     products against U's blocks) and the warp carries its row totals
//     across its chunks; (3) the warps' totals give the tile's row totals
//     and each warp's offset (shared memory, in warp order); (4) sixteen
//     threads wait for the predecessor tile's 16 status words (a ready flag
//     and a row's inclusive total in one 64-bit word), zero them, and
//     publish this tile's (carry + tile total); (5) every value gets its
//     carry and is stored, 16 bytes a lane (a shuffle pairs two lanes'
//     column pairs into four columns of one row).
//   * A tile waits only on its immediate predecessor (no look-back over
//     aggregates), so the f32 summation order is fixed.
//   * The status words and the ticket counter are per-device buffers the
//     wrapper keeps zeroed (kernels/scan_mxu/kernel.py): each status word is
//     read once, by its successor, which zeroes it; the last tile of a row
//     publishes nothing; the block that takes the last ticket resets the
//     counter.  Nothing is passed from the host per launch, so a captured
//     CUDA graph replays correctly.  Where cols <= kTileCols a row group is
//     one tile: no waiting and no status traffic.
// f32 loads the same 16-byte words as int32 and feeds the products with a
// permuted k: k-tile kt holds columns 16 (kt / 2) + 4 t + 2 (kt % 2) + {0,
// 1} of lane t, and U's blocks are built for that order (12 products a
// split part per chunk in place of 10).
// kernels/scan_mxu/kernel.py::scan_plan and chain_replay are the plan in
// Python (tests/test_torch_freeze_plan.py).  Ragged rows and columns load
// zeros and store nothing.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                   // warps per block
constexpr int kChunks = 4;                  // 32-column chunks per warp
constexpr int kMinBlocks = 2;               // blocks a SM the registers are budgeted for
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 16;               // rows per tile: the products' m
constexpr int kTileCols = kWarps * kChunks * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOneF32 = 0x3f800000u;   // 1.0f, exact in TF32
constexpr unsigned long long kReady = 1ull << 32;

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d: f32 accumulators as their bits
__device__ __forceinline__ void mma_tf32(unsigned (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  float f[4] = {__uint_as_float(d[0]), __uint_as_float(d[1]), __uint_as_float(d[2]),
                __uint_as_float(d[3])};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __float_as_uint(f[i]);
}

__device__ __forceinline__ unsigned to_tf32(unsigned x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(x)));
  return r;
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Byte p of each of the four words, packed low to high (an A fragment
// register of the u8 product: four consecutive k of one row).
__device__ __forceinline__ unsigned byte_plane(const uint4& w, int p) {
  const unsigned sel = static_cast<unsigned>(p) | (static_cast<unsigned>(p + 4) << 4);
  return __byte_perm(__byte_perm(w.x, w.y, sel), __byte_perm(w.z, w.w, sel), 0x5410);
}

// The scan's own addition on 32-bit patterns: modulo 2^32, or f32.
template <bool kF32>
__device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
  if constexpr (kF32) return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  return a + b;
}

// Four consecutive words of a row from column c, zeros at and past `cols`;
// one streaming 16-byte load where the row allows it.
__device__ __forceinline__ uint4 load4(const unsigned* row, int64_t c, int64_t cols, bool vec) {
  if (vec && c + 3 < cols) return __ldcs(reinterpret_cast<const uint4*>(row + c));
  uint4 u;
  u.x = c < cols ? row[c] : 0u;
  u.y = c + 1 < cols ? row[c + 1] : 0u;
  u.z = c + 2 < cols ? row[c + 2] : 0u;
  u.w = c + 3 < cols ? row[c + 3] : 0u;
  return u;
}

// U's blocks in a lane's B fragment registers.  int32 (m16n8k32): output
// columns 8n .. 8n + 7 of a chunk, B[k][j] = (k <= 8n + j) with k = 4t + i
// (+16 for the second register), j = g.  f32 (m16n8k8, permuted k):
// k-tile kt holds columns 16 (kt / 2) + 4t + 2 (kt % 2) + e in positions t
// (e = 0) and t + 4 (e = 1); a block (kt, n) is all ones where kt / 2 < n / 2,
// all zeros where kt / 2 > n / 2, and else depends on (kt % 2, n % 2) only.
struct Ublocks {
  unsigned u8[4][2];     // [n][register]
  unsigned tf[2][2][2];  // [kt % 2][n % 2][register]
};

__device__ __forceinline__ Ublocks make_ublocks(int g, int t) {
  Ublocks u;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * t + i + 16 * half <= 8 * n + g) w |= 1u << (8 * i);
      u.u8[n][half] = w;
    }
#pragma unroll
  for (int kp = 0; kp < 2; ++kp)
#pragma unroll
    for (int np = 0; np < 2; ++np)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        u.tf[kp][np][e] = 4 * t + 2 * kp + e <= 8 * np + g ? kOneF32 : 0u;
  return u;
}

// The local inclusive scan of one 16 x 32 chunk.  q: rows g / g + 8,
// columns 4t .. 4t + 3 (q[0], q[1]) and 16 + 4t .. (q[2], q[3]).  res[n]:
// the C fragment of output columns 8n .. 8n + 7 (rows g, g, g + 8, g + 8;
// columns 2t, 2t + 1).
template <bool kF32>
__device__ __forceinline__ void scan_chunk(const uint4 (&q)[4], const Ublocks& u,
                                           unsigned (&res)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) res[n][i] = 0u;
  if constexpr (kF32) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int h = kt >> 1, e0 = 2 * (kt & 1);
      const unsigned v[4] = {word(q[2 * h], e0), word(q[2 * h + 1], e0), word(q[2 * h], e0 + 1),
                             word(q[2 * h + 1], e0 + 1)};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = to_tf32(v[i]);
        lo[i] = to_tf32(__float_as_uint(__uint_as_float(v[i]) - __uint_as_float(hi[i])));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (h > (n >> 1)) continue;
        const bool ones = h < (n >> 1);
        const unsigned b0 = ones ? kOneF32 : u.tf[kt & 1][n & 1][0];
        const unsigned b1 = ones ? kOneF32 : u.tf[kt & 1][n & 1][1];
        mma_tf32(res[n], lo, b0, b1);
        mma_tf32(res[n], hi, b0, b1);
      }
    }
  } else {
    unsigned any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) any |= q[i].x | q[i].y | q[i].z | q[i].w;
    const int planes = __all_sync(kFull, (any & 0xffffff00u) == 0u) ? 1 : 4;
    for (int p = 0; p < planes; ++p) {
      const unsigned a[4] = {byte_plane(q[0], p), byte_plane(q[1], p), byte_plane(q[2], p),
                             byte_plane(q[3], p)};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        int d[4] = {0, 0, 0, 0};
        mma_u8(d, a, u.u8[n][0], u.u8[n][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) res[n][i] += static_cast<unsigned>(d[i]) << (8 * p);
      }
    }
  }
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
row_scan_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out, int64_t rows,
                int64_t cols, int64_t ngroups, int64_t ntiles, int vec,
                unsigned long long* __restrict__ status, int* __restrict__ ticket) {
  __shared__ int64_t s_ticket;
  __shared__ unsigned s_total[kWarps][kTileRows];  // each warp's row totals
  __shared__ unsigned s_carry[kTileRows];          // the rows' totals before this tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    const int tk = atomicAdd(ticket, 1);
    if (tk == ngroups * ntiles - 1) atomicExch(ticket, 0);  // the last ticket: every block has one
    s_ticket = tk;
  }
  __syncthreads();
  const int64_t group = s_ticket % ngroups, tile = s_ticket / ngroups;
  const int64_t ra = group * kTileRows + g, rb = ra + 8;
  const int64_t cols_a = ra < rows ? cols : 0, cols_b = rb < rows ? cols : 0;
  const unsigned* xa = x + (ra < rows ? ra : 0) * cols;
  const unsigned* xb = x + (rb < rows ? rb : 0) * cols;
  const int64_t c_warp = tile * kTileCols + static_cast<int64_t>(warp) * kChunks * 32;

  // (1) every load first
  uint4 q[kChunks][4];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t c = c_warp + 32 * k + 4 * t;
    q[k][0] = load4(xa, c, cols_a, vec);
    q[k][1] = load4(xb, c, cols_b, vec);
    q[k][2] = load4(xa, c + 16, cols_a, vec);
    q[k][3] = load4(xb, c + 16, cols_b, vec);
  }
  // (2) the chunks' scans, carried across the warp's chunks
  const Ublocks u = make_ublocks(g, t);
  unsigned res[kChunks][4][4];
  unsigned carry_a = 0u, carry_b = 0u;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    scan_chunk<kF32>(q[k], u, res[k]);
    // chunk totals: column 31 lives in lane 4g + 3, fragment n = 3, i = 1 / 3
    const unsigned tot_a = __shfl_sync(kFull, res[k][3][1], 4 * g + 3);
    const unsigned tot_b = __shfl_sync(kFull, res[k][3][3], 4 * g + 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      res[k][n][0] = add<kF32>(res[k][n][0], carry_a);
      res[k][n][1] = add<kF32>(res[k][n][1], carry_a);
      res[k][n][2] = add<kF32>(res[k][n][2], carry_b);
      res[k][n][3] = add<kF32>(res[k][n][3], carry_b);
    }
    carry_a = add<kF32>(carry_a, tot_a);
    carry_b = add<kF32>(carry_b, tot_b);
  }
  // (3) the warps' row totals
  if (t == 0) {
    s_total[warp][g] = carry_a;
    s_total[warp][g + 8] = carry_b;
  }
  __syncthreads();
  // (4) the chain: wait for the predecessor's row totals, pass ours on
  if (threadIdx.x < kTileRows) {
    const int r = threadIdx.x;
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = add<kF32>(total, s_total[w][r]);
    unsigned in = 0u;
    unsigned long long* words = status + group * (ntiles - 1) * kTileRows + r;
    if (tile > 0) {
      unsigned long long* p = words + (tile - 1) * kTileRows;
      unsigned long long v;
      // the predecessor is running or done; a wait of 2^26 polls (seconds)
      // is a fault, and traps rather than hangs the card
      for (unsigned polls = 0; ((v = ld_status(p)) & kReady) == 0;)
        if (++polls == 1u << 26) __trap();
      st_status(p, 0ull);
      in = static_cast<unsigned>(v);
    }
    if (tile + 1 < ntiles) st_status(words + tile * kTileRows, kReady | add<kF32>(in, total));
    s_carry[r] = in;
  }
  unsigned pre_a = 0u, pre_b = 0u;  // the earlier warps' totals
  for (int w = 0; w < warp; ++w) {
    pre_a = add<kF32>(pre_a, s_total[w][g]);
    pre_b = add<kF32>(pre_b, s_total[w][g + 8]);
  }
  __syncthreads();
  const unsigned off_a = add<kF32>(s_carry[g], pre_a), off_b = add<kF32>(s_carry[g + 8], pre_b);

  // (5) stores: lanes t and t ^ 1 trade column pairs, so the even lane holds
  // four columns of row g and the odd lane four of row g + 8
  const bool odd = t & 1;
  const int64_t r_out = odd ? rb : ra;
  const int64_t cols_out = r_out < rows ? cols : 0;  // every lane takes part in the shuffles
  unsigned* row = out + (r_out < rows ? r_out : 0) * cols;
  const unsigned off = odd ? off_b : off_a;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const unsigned sx = __shfl_xor_sync(kFull, odd ? res[k][n][0] : res[k][n][2], 1);
      const unsigned sy = __shfl_xor_sync(kFull, odd ? res[k][n][1] : res[k][n][3], 1);
      uint4 v;
      if (odd) {
        v = make_uint4(sx, sy, res[k][n][2], res[k][n][3]);
      } else {
        v = make_uint4(res[k][n][0], res[k][n][1], sx, sy);
      }
      v.x = add<kF32>(v.x, off);
      v.y = add<kF32>(v.y, off);
      v.z = add<kF32>(v.z, off);
      v.w = add<kF32>(v.w, off);
      const int64_t c = c_warp + 32 * k + 8 * n + 4 * (t >> 1);
      if (vec && c + 3 < cols_out) {
        __stcs(reinterpret_cast<uint4*>(row + c), v);
      } else {
        if (c < cols_out) row[c] = v.x;
        if (c + 1 < cols_out) row[c + 1] = v.y;
        if (c + 2 < cols_out) row[c + 2] = v.z;
        if (c + 3 < cols_out) row[c + 3] = v.w;
      }
    }
  }
}

}  // namespace

extern "C" int64_t rt_scan_mxu_tile_cols() { return kTileCols; }

// x, out: (rows, cols) row-major; dtype 0 = int32, 1 = f32.  status: at
// least ceil(rows / 16) * (ceil(cols / kTileCols) - 1) * 16 zeroed 64-bit
// words; ticket: one zeroed int.  Both are left zeroed.
extern "C" int rt_row_scan_mxu(const void* x, void* out, void* status, void* ticket, int dtype,
                               int64_t rows, int64_t cols, void* stream) {
  if (rows < 0 || cols < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return 0;
  const int64_t ngroups = (rows + kTileRows - 1) / kTileRows;
  const int64_t ntiles = (cols + kTileCols - 1) / kTileCols;
  if (ngroups * ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(ngroups * ntiles);
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = dtype == 0 ? row_scan_kernel<false> : row_scan_kernel<true>;
  kernel<<<grid, kThreads, 0, st>>>(static_cast<const unsigned*>(x), static_cast<unsigned*>(out),
                                    rows, cols, ngroups, ntiles, vec,
                                    static_cast<unsigned long long*>(status),
                                    static_cast<int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
