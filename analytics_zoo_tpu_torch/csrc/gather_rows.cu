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
// double-buffers one DMA per row through VMEM. Here blocks run in parallel
// and in no order, so there is nothing to carry between steps: each block
// reads its own ids, one warp copies one output row, and neighbouring lanes
// touch neighbouring 16-byte words (one uint4 per lane) when the row width
// and both base pointers allow it; otherwise each lane copies whole
// elements (2 or 4 bytes). The copy is bit-exact for any element type, so
// f32, bf16 and fp16 share one kernel keyed only on the element size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Unit* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   Unit* __restrict__ out,
                   long long n, long long rows, long long units_per_row,
                   int clip) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;
  long long row = ids[i];
  Unit* dst = out + i * units_per_row;
  if (row < 0 || row >= rows) {
    if (!clip) {
      for (long long j = lane; j < units_per_row; j += 32) dst[j] = Unit{};
      return;
    }
    row = row < 0 ? 0 : rows - 1;
  }
  const Unit* src = table + row * units_per_row;
  for (long long j = lane; j < units_per_row; j += 32) dst[j] = src[j];
}

template <typename Unit>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, long long units_per_row, int clip,
           cudaStream_t stream) {
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<Unit><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Unit*>(table), static_cast<const int32_t*>(ids),
      static_cast<Unit*>(out), n, rows, units_per_row, clip);
  return (int)cudaGetLastError();
}

// 16 when every row start is 16-byte aligned in both tensors (the uint4
// path), else the element size the copy falls back to.
int copy_unit(const void* table, const void* out, long long dim,
              int elem_bytes) {
  const long long row_bytes = dim * (long long)elem_bytes;
  if (row_bytes % 16 == 0 && (uintptr_t)table % 16 == 0 &&
      (uintptr_t)out % 16 == 0)
    return 16;
  return elem_bytes;
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
  if (n > (long long)0x7fffffff * kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_unit(table, out, dim, elem_bytes)) {
    case 16:
      return launch<uint4>(table, ids, out, n, rows,
                           dim * elem_bytes / 16, clip, s);
    case 4:
      return launch<uint32_t>(table, ids, out, n, rows, dim, clip, s);
    case 2:
      return launch<uint16_t>(table, ids, out, n, rows, dim, clip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
