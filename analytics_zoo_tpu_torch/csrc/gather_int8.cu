// Int8 row gather with the dequantize in the kernel, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_int8_kernel` in
// analytics_zoo_tpu/ops/embedding_kernels.py (pallas_call site
// `_gather_int8_call`): out[i, :] = float(table[ids[i], :]) * scale for a
// 2-D row-major int8 table [rows, dim], flat int32 ids [n] and one f32
// scale, into an f32 out [n, dim]. An id outside [0, rows), negative ids
// included, writes a zero row: the TPU kernel's contract (off the TPU the
// JAX package reads through jnp.take, which fills ids >= rows with -128 and
// wraps negative ids).
//
// The scale is a 0-d f32 tensor on the card, read by every thread beside
// its first id: the host never reads it, so a call never waits for the
// device.
//
// Arithmetic: one exact int8 -> f32 conversion and one f32 multiply
// (round to nearest even; nothing to contract into an fma), so the output
// equals the plain PyTorch version bit for bit.
//
// Bound: a copy that widens 1 byte to 4, so device memory bounds it:
// d*dim (the distinct rows the ids reach, each read once) + 4*n*dim (f32
// out) + 4*n (ids) bytes at 3.35 TB/s on an H100 SXM. At the NCF serving
// batch (256 ids x 64) that is about 0.03 us, far below one launch, so
// there the kernel is bound by launch latency; at 2^20 distinct ids of 64
// it is about 0.1 ms.
//
// Design: the TPU version scalar-prefetches 256 ids per grid step and
// double-buffers one row DMA through VMEM. Here the row gather's design
// (csrc/gather_rows.cu) carries over to a copy that widens. A unit is 4
// int8 read as one 32-bit load and written as one float4 (the f32 out
// needs 16-byte alignment, which a fresh tensor has), where the row width
// and the table's base allow it, else one byte written as one float (odd
// widths, a misaligned table). Neighbouring lanes take neighbouring units,
// so a warp's loads are 128 contiguous bytes and its stores 512. Wider
// units (8 or 16 int8) would read fewer, wider loads but write two or four
// float4 a lane, 32 or 64 bytes apart across the warp, so no store of the
// warp is contiguous: 16-byte units ran 2.2x slower at 2^20 ids of 64 and
// slower at NCF's 256. Blocks are 2 warps, and the lanes are packed to the
// row width (row_grid.cuh):
//
//   units <= 32  a warp widens 32 / units whole rows at once (NCF's 64-wide
//                tables: 16 lanes a row, 2 rows a warp; its 32-wide ones: 8
//                lanes, 4 rows): one row a thread while the grid has a row
//                slot for every row, a straight copy with no loop and
//                32-bit row indices; past the card's resident threads the
//                grid is capped and walks the rows in a grid-stride loop,
//                each thread reading kUnroll ids, issuing their kUnroll
//                independent loads, then storing;
//   units > 32   (rows wider than 128 int8) a warp widens a row, every lane
//                busy, kUnroll units a lane in flight, a warp for every row.
//
// At NCF's 256 ids the copy is launch-bound, so the first load must come
// soon: no 64-bit division before it (a lane's row comes from a multiply by
// a reciprocal the host computes), and every loop with a runtime trip
// count carries `#pragma unroll 1` (an unrolled loop computes its trip
// count with a division first). A call is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_grid.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 32;  // 2048 threads: all an SM holds
constexpr int kUnroll = 4;        // rows (or units) a thread has in flight
// registers a thread at most (launch bounds), as in csrc/gather_rows.cu
constexpr int kWideRegs = 64, kNarrowRegs = 80;

// U int8 read as one load: 4 as a 32-bit word, or 1
template <int U> struct Int8Unit;
template <> struct Int8Unit<4> { using T = uint32_t; };
template <> struct Int8Unit<1> { using T = int8_t; };

// byte k of a little-endian word (element k of its unit), exactly
// converted and times s
__device__ __forceinline__ float widen(uint32_t w, int k, float s) {
  return (float)(int8_t)((w >> (8 * k)) & 0xff) * s;
}

// The U floats of one unit, v times s, or zeros where !ok, stored at `out`
// (16-byte aligned for U == 4).
template <int U>
__device__ __forceinline__ void store_widened(
    float* __restrict__ out, const typename Int8Unit<U>::T& v, float s,
    bool ok) {
  if constexpr (U == 1) {
    *out = ok ? (float)v * s : 0.f;
  } else {
    *reinterpret_cast<float4*>(out) =
        ok ? make_float4(widen(v, 0, s), widen(v, 1, s), widen(v, 2, s),
                         widen(v, 3, s))
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The table row an id reads, or -1 (a zero row) outside [0, last]. `last`
// is rows - 1, at most INT32_MAX (no int32 id lies past a longer table),
// so one 32-bit unsigned compare tests the range.
__device__ __forceinline__ int source_row(int32_t id, int last) {
  return (unsigned)id <= (unsigned)last ? id : -1;
}

// One path an instantiation, as in csrc/gather_rows.cu: kWide (units > 32)
// widens a row a warp, kUnroll units a lane in flight; else each warp
// widens rows_per_warp rows of `lanes` lanes, one a thread while the grid
// has a row slot for every row (kLoop false), else kUnroll rows a thread
// a pass of a grid-stride loop.
template <int U, bool kLoop, bool kWide>
__global__ void __launch_bounds__(
    kThreads, 65536 / ((kWide ? kWideRegs : kNarrowRegs) * kThreads))
gather_int8_kernel(const typename Int8Unit<U>::T* __restrict__ table,
                   const float* __restrict__ scale,
                   const int32_t* __restrict__ ids, float* __restrict__ out,
                   long long n, int last, int units, int lanes,
                   int lane_div, int rows_per_warp) {
  using T = typename Int8Unit<U>::T;
  const int lane = threadIdx.x & 31;
  if constexpr (kWide) {
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (i >= n) return;
    const int src = source_row(ids[i], last);
    const float s = *scale;
    const T* row = table + (long long)(src < 0 ? 0 : src) * units;
    float* d = out + i * units * U;
    // not unrolled by the compiler: a trip count costs a division
#pragma unroll 1
    for (int u = lane; u < units; u += kUnroll * 32) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int uk = u + 32 * k;
        v[k] = (src >= 0 && uk < units) ? row[uk] : T{};
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int uk = u + 32 * k;
        if (uk < units)
          store_widened<U>(d + (long long)uk * U, v[k], s, src >= 0);
      }
    }
  } else {
    const int sub = (lane * lane_div) >> 16;  // lane / lanes: its row
    const int u0 = lane - sub * lanes;        // its unit of that row
    if (sub >= rows_per_warp || u0 >= units) return;  // idle lanes
    const int warp_row =
        (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp + sub;
    if constexpr (!kLoop) {
      if (warp_row >= n) return;
      const int src = source_row(ids[warp_row], last);
      const float s = *scale;
      const T v = src >= 0 ? table[(long long)src * units + u0] : T{};
      store_widened<U>(out + ((long long)warp_row * units + u0) * U, v, s,
                       src >= 0);
    } else {
      const long long step = (long long)gridDim.x * kWarps * rows_per_warp;
      const float s = *scale;
      // not unrolled by the compiler: a trip count costs a 64-bit division
#pragma unroll 1
      for (long long i0 = warp_row; i0 < n; i0 += kUnroll * step) {
        int src[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long i = i0 + k * step;
          src[k] = i < n ? source_row(ids[i], last) : -1;
        }
        T v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          v[k] = src[k] >= 0 ? table[(long long)src[k] * units + u0] : T{};
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long i = i0 + k * step;
          if (i < n)
            store_widened<U>(out + (i * units + u0) * U, v[k], s,
                             src[k] >= 0);
        }
      }
    }
  }
}

template <int U>
int launch(const void* table, const void* scale, const void* ids, void* out,
           long long n, long long rows, long long dim, cudaStream_t stream) {
  // one row a row slot (rows_per_warp a warp): small batches spread over
  // as many SMs as they can fill; past the card's resident threads the
  // grid is capped and each thread takes kUnroll rows a pass. Wide rows
  // take a warp each, every row at once.
  azt_rows::RowGrid g;
  if (!azt_rows::row_grid(n, dim / U, kThreads, kBlocksPerSm, g))
    return (int)cudaErrorInvalidValue;
  auto kernel = g.path == azt_rows::RowPath::kWide
                    ? gather_int8_kernel<U, false, true>
                : g.path == azt_rows::RowPath::kStraight
                    ? gather_int8_kernel<U, false, false>
                    : gather_int8_kernel<U, true, false>;
  kernel<<<g.grid, kThreads, 0, stream>>>(
      static_cast<const typename Int8Unit<U>::T*>(table),
      static_cast<const float*>(scale), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), n, azt_rows::last_row(rows), g.units,
      g.lanes, g.lane_div, g.rows_per_warp);
  return (int)cudaGetLastError();
}

// 4 where the row width and the table's base allow 32-bit loads and the
// f32 out is 16-byte aligned for its float4 stores; else one byte.
int int8_unit(const void* table, const void* out, long long dim) {
  return dim % 4 == 0 && (uintptr_t)table % 4 == 0 &&
                 (uintptr_t)out % 16 == 0
             ? 4
             : 1;
}

}  // namespace

extern "C" {

// Launches the gather on `stream` and returns cudaGetLastError() (0 on
// success). n == 0 launches nothing. The caller allocates `out` [n, dim]
// f32; `scale` points at one f32 on the card.
int azt_gather_int8(const void* table, const void* scale, const void* ids,
                    void* out, long long n, long long rows, long long dim,
                    void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8_unit(table, out, dim) == 4
             ? launch<4>(table, scale, ids, out, n, rows, dim, s)
             : launch<1>(table, scale, ids, out, n, rows, dim, s);
}

}  // extern "C"
