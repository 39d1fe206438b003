// Row gather for embedding lookups on Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_kernel` in
// analytics_zoo_tpu/ops/embedding_kernels.py (pallas_call site
// `_gather_call`): out[i, :] = table[ids[i], :] for a 2-D row-major table
// [rows, dim] and flat int32 ids [n].
//
//   clip != 0  clamps each id to [0, rows-1]          (gather_rows_clip)
//   clip == 0  writes a zero row for ids outside [0, rows), negative ids
//              included                              (gather_rows)
//
// This is the TPU kernel's contract, not jnp.take's: off the TPU jnp.take
// wraps negative ids and fills NaN rows for ids >= rows.
//
// Bound: a pure copy, so device memory bounds it: (n + d)*dim*elem + 4*n
// bytes at 3.35 TB/s on an H100 SXM, where d <= n counts the distinct rows
// the ids reach (each is read once). At the NCF serving batch (256 ids x
// 64 f32) that is about 0.04 us, far below one launch, so there the kernel
// is bound by launch latency, not by bytes.
//
// Design: the TPU version scalar-prefetches 256 ids per grid step and
// double-buffers one DMA per row through VMEM. Here the copy moves in
// units of 16 bytes where the row width and both base pointers allow it,
// else 8, 4 or 2 (one element): the copy is bit-exact for any element type,
// so f32, bf16 and fp16 share one kernel keyed on the unit. Blocks are 2
// warps (small batches spread over as many SMs as they can fill), and the
// lanes are packed to the row width:
//
//   units <= 32  a warp copies 32 / units whole rows at once, neighbouring
//                lanes on neighbouring units of one row, then the next
//                row's (NCF's 64 f32: 2 rows a warp; W&D's width 8: 16; the
//                width-2 f32 wide table moves 8-byte units, 32 rows a
//                warp): one row a thread while the grid has a row slot for
//                every row; past the card's resident threads the grid is
//                capped and walks the rows in a grid-stride loop, each
//                thread reading kUnroll ids, issuing their kUnroll
//                independent loads, then storing;
//   units > 32   a warp copies a row, every lane busy, kUnroll units a lane
//                in flight (the LM's 8 KB rows: 512 units, 16 a lane), a
//                warp for every row.
//
// At NCF's 256 ids the copy is launch-bound, so the first load must come
// soon: a grid with a row slot for every row copies straight, with no
// loop (a loop the compiler unrolled computed its trip count with a
// 64-bit division first, 0.25 us), and a lane's row comes from a multiply
// by a reciprocal the host computes, not a division. A call is one launch
// (wide rows: for n up to 2^32, a grid of at most 2^31 - 1 blocks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_grid.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 32;  // 2048 threads: all an SM holds
constexpr int kUnroll = 4;        // rows (or units) a thread has in flight
// registers a thread at most (launch bounds): 64 keep the one-warp-a-row
// kernel at 16 blocks an SM; the unrolled narrow kernel fits 80, where
// ptxas left to itself took up to 128 and ran 20-30% slower at 2^20 ids
constexpr int kWideRegs = 64, kNarrowRegs = 80;

// The table row an id reads: clamped in clip mode, -1 (a zero row) for an
// id outside [0, rows) in fill mode.
__device__ __forceinline__ long long source_row(const int32_t* ids,
                                                long long i, long long rows,
                                                int clip) {
  long long r = ids[i];
  if (r < 0 || r >= rows) {
    if (!clip) return -1;
    r = r < 0 ? 0 : rows - 1;
  }
  return r;
}

// One path an instantiation: kWide (units > 32) copies a row a warp,
// kUnroll units a lane in flight, a warp for every row; else each warp
// copies rows_per_warp rows of `lanes` lanes, one a thread while the grid
// has a row slot for every row (kLoop false), else kUnroll rows a thread
// a pass of a grid-stride loop. Only that loop is a loop: a row slot for
// every row is one straight copy, its index in 32 bits (the grid holds at
// most a few hundred thousand row slots).
template <typename Unit, bool kLoop, bool kWide>
__global__ void __launch_bounds__(
    kThreads, 65536 / ((kWide ? kWideRegs : kNarrowRegs) * kThreads))
gather_rows_kernel(const Unit* __restrict__ table,
                   const int32_t* __restrict__ ids, Unit* __restrict__ out,
                   long long n, long long rows, int units, int lanes,
                   int lane_div, int rows_per_warp, int clip) {
  const int lane = threadIdx.x & 31;
  if constexpr (kWide) {
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (i >= n) return;
    const long long src = source_row(ids, i, rows, clip);
    const Unit* s = table + (src < 0 ? 0 : src) * units;
    Unit* d = out + i * units;
    // not unrolled by the compiler: a trip count costs a division
#pragma unroll 1
    for (int u = lane; u < units; u += kUnroll * 32) {
      Unit v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int uk = u + 32 * k;
        v[k] = (src >= 0 && uk < units) ? s[uk] : Unit{};
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int uk = u + 32 * k;
        if (uk < units) d[uk] = v[k];
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
      const long long src = source_row(ids, warp_row, rows, clip);
      out[(long long)warp_row * units + u0] =
          src >= 0 ? table[src * units + u0] : Unit{};
    } else {
      const long long step =
          (long long)gridDim.x * kWarps * rows_per_warp;
      // not unrolled by the compiler: a trip count costs a 64-bit division
#pragma unroll 1
      for (long long i0 = warp_row; i0 < n; i0 += kUnroll * step) {
        long long src[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long i = i0 + k * step;
          src[k] = i < n ? source_row(ids, i, rows, clip) : -1;
        }
        Unit v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          v[k] = src[k] >= 0 ? table[src[k] * units + u0] : Unit{};
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long i = i0 + k * step;
          if (i < n) out[i * units + u0] = v[k];
        }
      }
    }
  }
}

template <typename Unit>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, long long units, int clip, cudaStream_t stream) {
  // one row a row slot (rows_per_warp a warp): small batches spread over
  // as many SMs as they can fill; past the card's resident threads the
  // grid is capped and each thread takes kUnroll rows a pass. Wide rows
  // take a warp each, every row at once.
  azt_rows::RowGrid g;
  if (!azt_rows::row_grid(n, units, kThreads, kBlocksPerSm, g))
    return (int)cudaErrorInvalidValue;
  auto kernel = g.path == azt_rows::RowPath::kWide
                    ? gather_rows_kernel<Unit, false, true>
                : g.path == azt_rows::RowPath::kStraight
                    ? gather_rows_kernel<Unit, false, false>
                    : gather_rows_kernel<Unit, true, false>;
  kernel<<<g.grid, kThreads, 0, stream>>>(
      static_cast<const Unit*>(table), static_cast<const int32_t*>(ids),
      static_cast<Unit*>(out), n, rows, g.units, g.lanes, g.lane_div,
      g.rows_per_warp, clip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the gather on `stream` and returns cudaGetLastError() (0 on
// success). n == 0 launches nothing. The caller allocates `out` [n, dim].
int azt_gather_rows(const void* table, const void* ids, void* out,
                    long long n, long long rows, long long dim,
                    int elem_bytes, int clip, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int unit = azt_rows::copy_unit(table, out, dim, elem_bytes);
  const long long units = dim * elem_bytes / unit;
  switch (unit) {
    case 16:
      return launch<uint4>(table, ids, out, n, rows, units, clip, s);
    case 8:
      return launch<uint2>(table, ids, out, n, rows, units, clip, s);
    case 4:
      return launch<uint32_t>(table, ids, out, n, rows, units, clip, s);
    case 2:
      return launch<uint16_t>(table, ids, out, n, rows, units, clip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
