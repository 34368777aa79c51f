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
// Bound on the card: bytes.  Dispatch reads pos (T) once and x (T D) of
// the live lanes only (a dropped lane's x is never needed), and writes out
// (S D) once; combine reads pos and the T gathered rows of buf and writes
// out (T D).
//
// Design.  K5a, since its redesign for the H100: plain stores where the
// positions are unique, atomics only where they repeat, the choice made
// on the device.  One memset and four launches on the caller's stream:
//   0. the scratch (a header of two 64-bit counts, then an occupancy
//      bitmap of ceil(S / 32) words; from kernels/common.device_buffer) is
//      cleared;
//   1. the store pass: one thread per unit of x (16 bytes where D and the
//      addresses allow, else one element), a warp taking kUnroll
//      consecutive 32-unit runs at once; pos is loaded one iteration
//      ahead, so x is read for live lanes only and each iteration waits on
//      one round trip.  It stores x[t] + 0 into out[pos[t]] where
//      0 <= pos[t] < S (other lanes dropped) with a plain store: no live
//      line of out is read back.  Adding +0 keeps the reference's
//      scatter-add rule: -0.0 comes out +0.0.  The thread holding a row's
//      first unit marks slot pos[t] in the bitmap; a warp's marks are
//      merged by word (__match_any_sync, __reduce_or_sync) into one
//      atomicOr a word, whose old value nobody waits for; each warp adds
//      its marks to the first count;
//   2. the fill pass: a warp reads 32 bitmap words, writes zeros to the
//      unmarked slots only (on the freeze's shape a contiguous tail, full
//      sectors) and adds the words' set bits to the second count;
//   3. the zero pass and 4. the add pass read the header: with the two
//      counts equal (every mark set a bit of its own: the live positions
//      are unique) every thread returns at once; else pass 3 zero-fills
//      all of out (16-byte stores) and pass 4 adds each element of x into
//      its slot with atomicAdd (f32 and bf16 natively on sm_90, int32 in
//      two's complement), over those zeros, whatever pass 1 left.
// With unique positions every slot gets at most one value and the result
// is bitwise the plain version's; where positions repeat, float sums
// depend on the order the atomics land in (int32 stays exact).  No host
// sync and no switch: the path is read on the device.  Bytes moved on the
// freeze's shape: pos, x of the live lanes, the live stores, the tail's
// zeros and the bitmap (1/32 of a 4-byte slot's bytes, cleared, marked and
// read), about 3.2 GB, against the atomic design's zero fill of all of
// out followed by a read-modify-write of every live line in L2 (the fill
// long since evicted them), about 5.1 GB at 2.7e8 f32 lanes.
// rt_dispatch_atomic runs that earlier design alone (passes 3 and 4
// unconditionally), for timing comparisons; no path calls it.  It is a
// temporary yardstick: `chip_smoke.py --ab PARENT --what dispatch` times
// the same design from the parent checkout, so rt_dispatch_atomic, its
// wrapper and the scratch == nullptr branches of passes 3 and 4 can go.
// The scratch is one buffer per device, shared by every K5a launch there:
// launches must be ordered on one stream (two launches overlapping on two
// streams would clear each other's marks).
// K5b: one thread per copy unit (16, 8, 4 or 2 bytes, the widest that
// divides a row) copies buf[clip(pos[t], 0, S - 1)] or writes zeros where
// pos[t] < 0, the plain version's rule.  64-bit indices throughout: the
// freeze's dispatch covers 2.7e8 lanes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // store pass: 32-unit runs a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

// a store unit: V elements of T, V * sizeof(T) bytes aligned
template <typename T, int V>
struct alignas(sizeof(T) * V) Unit {
  T v[V];
};

// a unit's bytes as one integer type, for writing zeros
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float plus_zero(float v) { return v + 0.0f; }
__device__ __forceinline__ __nv_bfloat16 plus_zero(__nv_bfloat16 v) {
  return __hadd(v, __float2bfloat16(0.0f));
}
__device__ __forceinline__ int plus_zero(int v) { return v; }

template <typename T, int V>
__device__ __forceinline__ Unit<T, V> plus_zero(Unit<T, V> u) {
#pragma unroll
  for (int j = 0; j < V; ++j) u.v[j] = plus_zero(u.v[j]);
  return u;
}

// scratch, 32-bit words: [0, 2) the marks made (u64), [2, 4) the bitmap's
// set bits (u64), then from kHeader the bitmap, ceil(S / 32) words
constexpr int kHeader = 4;

struct Header {
  unsigned long long marks;
  unsigned long long bits;
};

// a slot was marked more than once: the collision path runs
__device__ __forceinline__ bool collided(const unsigned* scratch) {
  const Header* h = reinterpret_cast<const Header*>(scratch);
  return h->marks != h->bits;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
store_kernel(const Unit<T, V>* __restrict__ x, const int* __restrict__ pos,
             Unit<T, V>* __restrict__ out, unsigned* __restrict__ scratch, int64_t T_,
             int64_t row_units, int64_t S) {
  const int lane = threadIdx.x & 31;
  const int64_t n = T_ * row_units;
  unsigned* bitmap = scratch + kHeader;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  unsigned long long marked = 0;  // this warp's marks (lane 0 adds them)
  // warp-uniform: the warp's first unit; each run's pos is loaded one
  // iteration ahead, so x is read for live lanes only without a second
  // round trip
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane) * kUnroll;
  int p[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = base + k * 32 + lane;
    p[k] = i < n ? pos[row_units == 1 ? i : i / row_units] : -1;
  }
  for (; base < n; base += stride) {
    Unit<T, V> v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (p[k] >= 0 && p[k] < S) v[k] = x[base + k * 32 + lane];
    int next[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + stride + k * 32 + lane;
      next[k] = i < n ? pos[row_units == 1 ? i : i / row_units] : -1;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * 32 + lane;
      const int64_t c = row_units == 1 ? 0 : i % row_units;
      const bool live = p[k] >= 0 && p[k] < S;
      if (live) out[p[k] * row_units + c] = plus_zero(v[k]);
      const bool mark = live && c == 0;
      const unsigned marks = __ballot_sync(kFull, mark);
      marked += __popc(marks);
      if (mark) {
        const unsigned word = static_cast<unsigned>(p[k]) >> 5;
        const unsigned grp = __match_any_sync(marks, word);
        const unsigned bits = __reduce_or_sync(grp, 1u << (p[k] & 31));
        if (lane == __ffs(grp) - 1) atomicOr(bitmap + word, bits);  // the old value unread
      }
      p[k] = next[k];
    }
  }
  if (lane == 0 && marked) atomicAdd(&reinterpret_cast<Header*>(scratch)->marks, marked);
}

// every byte of out zero (16-byte stores, then the tail), grid-stride
__device__ __forceinline__ void zero_all(uint4* __restrict__ out16, unsigned char* __restrict__ tail,
                                         int64_t n16, int64_t ntail) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n16;
       i += stride)
    out16[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < ntail;
       i += stride)
    tail[i] = 0;
}

// the zero fill: the collision path's first pass (scratch given), or the
// atomic design's (scratch null)
__global__ void __launch_bounds__(kThreads)
zero_fill_kernel(uint4* __restrict__ out16, unsigned char* __restrict__ tail, int64_t n16,
                 int64_t ntail, const unsigned* __restrict__ scratch) {
  if (scratch != nullptr && !collided(scratch)) return;
  zero_all(out16, tail, n16, ntail);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fill_kernel(Unit<T, V>* __restrict__ out, unsigned* __restrict__ scratch, int64_t S,
            int64_t row_units) {
  using R = typename Raw<sizeof(Unit<T, V>)>::type;
  const unsigned* bitmap = scratch + kHeader;
  const int lane = threadIdx.x & 31;
  const int64_t nwords = (S + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t word_units = 32 * row_units;
  unsigned set = 0;  // this lane's words' set bits
  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane; w0 < nwords;
       w0 += stride) {
    const int64_t w = w0 + lane;
    unsigned word = w < nwords ? bitmap[w] : kFull;
    if (w < nwords) set += __popc(word);
    if (w == nwords - 1 && S % 32) word |= kFull << (S % 32);  // slots past S: nothing to write
    unsigned todo = __ballot_sync(kFull, word != kFull);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned marked = __shfl_sync(kFull, word, j);
      R* row = reinterpret_cast<R*>(out + (w0 + j) * word_units);
      for (int64_t u = lane; u < word_units; u += 32) {
        const int64_t s = row_units == 1 ? u : u / row_units;
        if (!((marked >> s) & 1u)) row[u] = R{};
      }
    }
  }
  set = __reduce_add_sync(kFull, set);
  if (lane == 0 && set)
    atomicAdd(&reinterpret_cast<Header*>(scratch)->bits, static_cast<unsigned long long>(set));
}

__device__ __forceinline__ void add_at(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_at(__nv_bfloat16* p, __nv_bfloat16 v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_at(int* p, int v) { atomicAdd(p, v); }

// the collision path's second pass (scratch given), or the atomic
// design's (scratch null)
template <typename T>
__global__ void __launch_bounds__(kThreads)
add_kernel(const T* __restrict__ x, const int* __restrict__ pos, T* __restrict__ out, int64_t T_,
           int64_t D, int64_t S, const unsigned* __restrict__ scratch) {
  if (scratch != nullptr && !collided(scratch)) return;
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

template <typename T, int V>
int launch_store_fill(const void* x, const void* pos, void* out, unsigned* scratch, int64_t T_,
                      int64_t D, int64_t S, cudaStream_t st) {
  using U = Unit<T, V>;
  const int64_t row_units = D / V;
  store_kernel<T, V><<<grid_for((T_ * row_units + kUnroll - 1) / kUnroll), kThreads, 0, st>>>(
      static_cast<const U*>(x), static_cast<const int*>(pos), static_cast<U*>(out), scratch, T_,
      row_units, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fill_kernel<T, V><<<grid_for((S + 31) / 32), kThreads, 0, st>>>(static_cast<U*>(out), scratch, S,
                                                                   row_units);
  return static_cast<int>(cudaGetLastError());
}

// passes 3 and 4: gated on the header where scratch is given, else always
template <typename T>
int launch_zero_add(const void* x, const void* pos, void* out, const unsigned* scratch, int64_t T_,
                    int64_t D, int64_t S, cudaStream_t st) {
  const int64_t bytes = S * D * static_cast<int64_t>(sizeof(T));
  const int64_t n16 = bytes / 16;
  zero_fill_kernel<<<grid_for(n16 > 0 ? n16 : 1), kThreads, 0, st>>>(
      static_cast<uint4*>(out), static_cast<unsigned char*>(out) + n16 * 16, n16, bytes - n16 * 16,
      scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (T_ * D > 0)
    add_kernel<T><<<grid_for(T_ * D), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(pos), static_cast<T*>(out), T_, D, S,
        scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dispatch(const void* x, const void* pos, void* out, unsigned* scratch, int64_t T_,
                    int64_t D, int64_t S, cudaStream_t st) {
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, (kHeader + (S + 31) / 32) * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kV = 16 / sizeof(T);
  const bool wide = D % kV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int rc = wide ? launch_store_fill<T, kV>(x, pos, out, scratch, T_, D, S, st)
                      : launch_store_fill<T, 1>(x, pos, out, scratch, T_, D, S, st);
  if (rc != 0) return rc;
  return launch_zero_add<T>(x, pos, out, scratch, T_, D, S, st);
}

}  // namespace

// x: (T, D); pos: (T,) int32; out: (S, D), 16-byte aligned, written whole;
// scratch: at least 4 + ceil(S / 32) 32-bit words of the device, cleared
// here and left holding the header (the collision path ran where its two
// u64 counts differ) and the bitmap.
// dtype: 0 = f32, 1 = bf16, 2 = int32.
extern "C" int rt_dispatch(const void* x, const void* pos, void* out, void* scratch, int dtype,
                           int64_t T_, int64_t D, int64_t S, void* stream) {
  if (T_ < 0 || D < 0 || S < 0 || S > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (S * D == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<unsigned*>(scratch);
  switch (dtype) {
    case 0: return launch_dispatch<float>(x, pos, out, sc, T_, D, S, st);
    case 1: return launch_dispatch<__nv_bfloat16>(x, pos, out, sc, T_, D, S, st);
    case 2: return launch_dispatch<int>(x, pos, out, sc, T_, D, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The atomic design alone (a zero fill of out, then atomicAdd over all of
// x): K5a before its redesign, for timing comparisons.  Arguments as
// rt_dispatch's, without the scratch.
extern "C" int rt_dispatch_atomic(const void* x, const void* pos, void* out, int dtype, int64_t T_,
                                  int64_t D, int64_t S, void* stream) {
  if (T_ < 0 || D < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S * D == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_zero_add<float>(x, pos, out, nullptr, T_, D, S, st);
    case 1: return launch_zero_add<__nv_bfloat16>(x, pos, out, nullptr, T_, D, S, st);
    case 2: return launch_zero_add<int>(x, pos, out, nullptr, T_, D, S, st);
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
