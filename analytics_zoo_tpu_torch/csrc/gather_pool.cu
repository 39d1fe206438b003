// Fused gather + bag pooling for embedding bags on Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_pool_kernel` in
// analytics_zoo_tpu/ops/embedding_kernels.py (pallas_call site
// `_gather_pool_call`): for ids [n, bag] int32 and a row-major table
// [rows, dim],
//
//   out[i, :] = combine_k table[ids[i, k], :]        k = 0 .. bag-1
//
// accumulated in f32 in bag order and written once in the table's dtype
// (f32, bf16 or fp16). combiner 0 = sum, 1 = mean, 2 = sqrtn, where mean and
// sqrtn divide by max(count, 1) and sqrt(max(count, 1)).
//
//   clip == 0  masks ids outside [0, rows): they add nothing and are left
//              out of the count (the TPU kernel's `ok` mask; negative ids
//              are padding)
//   clip != 0  clamps every id to [0, rows-1] and counts all `bag` of them
//              (gather_pool(..., mask_negative=False), which the TPU wrapper
//              clamps before the call)
//
// Bound: device memory. The kernel reads 4*n*bag bytes of ids, each
// distinct table row the ids reach once, and writes n*dim*elem bytes; it
// does bag adds per output element, far below the card's float rate. At the
// Wide&Deep wide table ([101016, 2] f32, n = 8192, bag 3) that is about
// 0.24 MB, 0.07 us at 3.35 TB/s: there one launch costs more than the bytes.
//
// Design: the TPU version walks its grid in order and double-buffers one
// DMA per gathered row into a VMEM accumulator. Here blocks run in parallel
// and in no order, so nothing carries between them, and the row gather's
// design (csrc/gather_rows.cu) carries over. A unit is the widest run of
// elements (16, 8 or 4 bytes, else one element) that divides the row's
// bytes and both base pointers; a thread sums its unit of every row of one
// bag. Blocks are 2 warps, and the lanes are packed to the row width
// (row_grid.cuh):
//
//   units <= 32  a warp pools 32 / units bags at once (the W&D wide table's
//                8-byte rows: one thread a bag, 32 bags a warp; a 64-wide
//                f32 row: 16 units of 16 bytes, 2 bags a warp): one bag a
//                thread's unit while the grid has a slot for every bag,
//                with no loop over bags; past the card's resident threads
//                the grid is capped and walks the bags in a grid-stride
//                loop;
//   units > 32   a warp pools a bag, its lanes walking the row's units.
//
// A bag's loads are in flight together: a thread reads a chunk of up to
// kChunk of its bag's ids (independent loads), then issues the row loads
// for all of them, and only then adds them, so a bag of up to kChunk ids
// costs two trips to memory, not two an id; a longer bag goes chunk by
// chunk. At W&D's call two warps an SM leave every instruction's latency
// exposed, so the code is kept short: ids are checked against the table as
// 32-bit ints, the mode (clip or mask) is compiled in, no 64-bit division
// comes before the first load (a lane's bag is a multiply by a reciprocal
// the host computes), and every loop with a runtime trip count carries
// `#pragma unroll 1` (an unrolled one computes its trip count with a
// division first).
//
// The sum runs in bag order with plain f32 adds, IEEE division and sqrtf
// (no fast-math flag), so the kernel equals its plain PyTorch version bit
// for bit in every dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_grid.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 32;  // 2048 threads: all an SM holds
// a bag's ids (and rows) a thread has in flight: 4 is as fast as 8 at
// 2^20 bags of 8 and 0.3 us faster at W&D's bags of 3, where two warps an
// SM leave every instruction's latency exposed
constexpr int kChunk = 4;
constexpr int kMaxUnit = 16;  // the widest unit, bytes
// registers a thread at most (launch bounds)
constexpr int kRegs = 80;

// the C entry's dtype codes
constexpr int kF32 = 0, kBf16 = 1, kF16 = 2;

// An element's f32 value from its bits (exact), and its bits from an f32
// (rounded to nearest even, as PyTorch's casts round)
template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static float f32(uint32_t b) { return __uint_as_float(b); }
  __device__ static uint32_t bits(float v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static float f32(uint32_t b) { return __uint_as_float(b << 16); }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<__half> {
  __device__ static float f32(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  __device__ static uint32_t bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// A unit's 32-bit words (a 2-byte unit in the low half of one)
template <typename Unit>
constexpr int kWords = sizeof(Unit) >= 4 ? sizeof(Unit) / 4 : 1;

__device__ __forceinline__ void to_words(uint4 v, uint32_t (&w)[4]) {
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void to_words(uint2 v, uint32_t (&w)[2]) {
  w[0] = v.x, w[1] = v.y;
}
__device__ __forceinline__ void to_words(uint32_t v, uint32_t (&w)[1]) {
  w[0] = v;
}
__device__ __forceinline__ void to_words(uint16_t v, uint32_t (&w)[1]) {
  w[0] = v;
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[4], uint4& v) {
  v = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[2], uint2& v) {
  v = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[1],
                                           uint32_t& v) {
  v = w[0];
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[1],
                                           uint16_t& v) {
  v = (uint16_t)w[0];
}

// acc[e] += element e of the unit v, in f32
template <typename T, typename Unit>
__device__ __forceinline__ void add_unit(float* acc, const Unit& v) {
  constexpr int E = sizeof(Unit) / sizeof(T);
  uint32_t w[kWords<Unit>];
  to_words(v, w);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr (sizeof(T) == 4)
      acc[e] += Elem<T>::f32(w[e]);
    else
      acc[e] += Elem<T>::f32((w[e >> 1] >> (16 * (e & 1))) & 0xffff);
  }
}

template <typename T, typename Unit>
__device__ __forceinline__ Unit pack_unit(const float* acc) {
  constexpr int E = sizeof(Unit) / sizeof(T);
  uint32_t w[kWords<Unit>] = {};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr (sizeof(T) == 4)
      w[e] = Elem<T>::bits(acc[e]);
    else
      w[e >> 1] |= Elem<T>::bits(acc[e]) << (16 * (e & 1));
  }
  Unit v;
  from_words(w, v);
  return v;
}

// The table row an id adds: clamped to [0, last] in clip mode, -1
// (nothing, and not counted) outside it in mask mode. `last` is rows - 1,
// at most INT32_MAX (no int32 id lies past a longer table), so 32-bit
// compares test the range.
template <bool kClip>
__device__ __forceinline__ int pool_row(int32_t id, int last) {
  if constexpr (kClip)
    return min(max(id, 0), last);
  else
    return (unsigned)id <= (unsigned)last ? id : -1;
}

// Unit u of bag `bag_ids` pooled: kChunk ids read, their kChunk row loads
// issued, then added in bag order, a chunk at a time. The id loads come
// first, in a loop of their own: an id loaded and range-checked under one
// branch made the next id's load wait for it, a trip to memory an id.
template <typename T, typename Unit, bool kClip>
__device__ __forceinline__ Unit pool_unit(const Unit* __restrict__ table,
                                          const int32_t* __restrict__ bag_ids,
                                          int bag, int last, int units, int u,
                                          int combiner) {
  constexpr int E = sizeof(Unit) / sizeof(T);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  float count = 0.0f;
  // not unrolled by the compiler: a trip count costs a division
#pragma unroll 1
  for (int k0 = 0; k0 < bag; k0 += kChunk) {
    int32_t id[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      id[k] = k0 + k < bag ? bag_ids[k0 + k] : -1;
    int src[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      src[k] = k0 + k < bag ? pool_row<kClip>(id[k], last) : -1;
    Unit v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      v[k] = src[k] >= 0 ? table[(long long)src[k] * units + u] : Unit{};
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (src[k] >= 0) {
        add_unit<T>(acc, v[k]);
        count += 1.0f;
      }
    }
  }
  if (combiner != 0) {  // mean: / max(count, 1); sqrtn: / its sqrt
    const float denom = fmaxf(count, 1.0f);
    const float d = combiner == 1 ? denom : sqrtf(denom);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] / d;
  }
  return pack_unit<T, Unit>(acc);
}

// One path and mode an instantiation: kWide (units > 32) pools a bag a
// warp, each lane walking its units; else each warp pools rows_per_warp
// bags of `lanes` lanes, one a thread while the grid has a slot for every
// bag (kLoop false), else in a grid-stride loop. Only that loop is a loop
// over bags: a slot for every bag is one straight pass, its index in 32
// bits. kClip clamps ids, else masks them (the mode is compiled in: both
// modes in one kernel made W&D's call 0.08 us slower).
template <typename T, typename Unit, bool kLoop, bool kWide, bool kClip>
__global__ void __launch_bounds__(kThreads, 65536 / (kRegs * kThreads))
gather_pool_kernel(const Unit* __restrict__ table,
                   const int32_t* __restrict__ ids, Unit* __restrict__ out,
                   long long n, int bag, int last, int units, int lanes,
                   int lane_div, int rows_per_warp, int combiner) {
  const int lane = threadIdx.x & 31;
  if constexpr (kWide) {
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (i >= n) return;
    const int32_t* bag_ids = ids + i * bag;
    // not unrolled by the compiler: a trip count costs a division
#pragma unroll 1
    for (int u = lane; u < units; u += 32)
      out[i * units + u] = pool_unit<T, Unit, kClip>(table, bag_ids, bag,
                                                     last, units, u, combiner);
  } else {
    const int sub = (lane * lane_div) >> 16;  // lane / lanes: its bag
    const int u0 = lane - sub * lanes;        // its unit of that bag's rows
    if (sub >= rows_per_warp) return;         // idle lanes
    const int warp_bag =
        (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp + sub;
    if constexpr (!kLoop) {
      if (warp_bag >= n) return;
      out[(long long)warp_bag * units + u0] = pool_unit<T, Unit, kClip>(
          table, ids + (long long)warp_bag * bag, bag, last, units, u0,
          combiner);
    } else {
      const long long step = (long long)gridDim.x * kWarps * rows_per_warp;
      // not unrolled by the compiler: a trip count costs a 64-bit division
#pragma unroll 1
      for (long long i = warp_bag; i < n; i += step)
        out[i * units + u0] = pool_unit<T, Unit, kClip>(
            table, ids + i * bag, bag, last, units, u0, combiner);
    }
  }
}

template <typename T, typename Unit, bool kClip>
int launch(const void* table, const void* ids, void* out, long long n,
           int bag, long long rows, long long dim, int combiner,
           cudaStream_t stream) {
  // one bag a slot (rows_per_warp a warp): small batches spread over as
  // many SMs as they can fill; past the card's resident threads the grid
  // is capped and walks the bags. Wide rows take a warp a bag, every bag
  // at once.
  azt_rows::RowGrid g;
  if (!azt_rows::row_grid(n, dim * (long long)sizeof(T) / sizeof(Unit),
                          kThreads, kBlocksPerSm, g))
    return (int)cudaErrorInvalidValue;
  auto kernel = g.path == azt_rows::RowPath::kWide
                    ? gather_pool_kernel<T, Unit, false, true, kClip>
                : g.path == azt_rows::RowPath::kStraight
                    ? gather_pool_kernel<T, Unit, false, false, kClip>
                    : gather_pool_kernel<T, Unit, true, false, kClip>;
  kernel<<<g.grid, kThreads, 0, stream>>>(
      static_cast<const Unit*>(table), static_cast<const int32_t*>(ids),
      static_cast<Unit*>(out), n, bag, azt_rows::last_row(rows), g.units,
      g.lanes, g.lane_div, g.rows_per_warp, combiner);
  return (int)cudaGetLastError();
}

template <typename T, bool kClip>
int launch_mode(const void* table, const void* ids, void* out, long long n,
                int bag, long long rows, long long dim, int combiner,
                cudaStream_t s) {
  switch (azt_rows::copy_unit(table, out, dim, (int)sizeof(T), kMaxUnit)) {
    case 16:
      return launch<T, uint4, kClip>(table, ids, out, n, bag, rows, dim,
                                     combiner, s);
    case 8:
      return launch<T, uint2, kClip>(table, ids, out, n, bag, rows, dim,
                                     combiner, s);
    case 4:
      return launch<T, uint32_t, kClip>(table, ids, out, n, bag, rows, dim,
                                        combiner, s);
    default:  // one 2-byte element
      if constexpr (sizeof(T) == 2)
        return launch<T, uint16_t, kClip>(table, ids, out, n, bag, rows,
                                          dim, combiner, s);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dtype(const void* table, const void* ids, void* out, long long n,
                 int bag, long long rows, long long dim, int combiner,
                 int clip, cudaStream_t s) {
  return clip ? launch_mode<T, true>(table, ids, out, n, bag, rows, dim,
                                     combiner, s)
              : launch_mode<T, false>(table, ids, out, n, bag, rows, dim,
                                      combiner, s);
}

}  // namespace

extern "C" {

// Launches the pooled gather on `stream` and returns cudaGetLastError() (0
// on success). dtype: 0 = f32, 1 = bf16, 2 = fp16. n == 0 launches nothing.
// The caller allocates `out` [n, dim] in the table's dtype.
int azt_gather_pool(const void* table, const void* ids, void* out,
                    long long n, int bag, long long rows, long long dim,
                    int dtype, int combiner, int clip, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || dim <= 0 || bag < 0 || combiner < 0 || combiner > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dtype<float>(table, ids, out, n, bag, rows, dim,
                                 combiner, clip, s);
    case kBf16:
      return launch_dtype<__nv_bfloat16>(table, ids, out, n, bag, rows, dim,
                                         combiner, clip, s);
    case kF16:
      return launch_dtype<__half>(table, ids, out, n, bag, rows, dim,
                                  combiner, clip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
