// Row scatter-add into a zeroed shard block, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_scatter_add_kernel` in
// analytics_zoo_tpu/ops/embedding_kernels.py (pallas_call site
// `_scatter_call`): out = zeros([num_rows, dim]); then for every j with
// 0 <= rows[j] < num_rows, out[rows[j], :] += g[j, :]. Rows outside
// [0, num_rows) (negatives, the SENTINEL num_rows and past it) drop, as
// JAX's `.at[rows].add(mode="drop")` drops them. g is f32 [n, dim]
// row-major, rows int32 [n], out f32 [num_rows, dim] row-major.
//
// It is the last step of the vocab-sharded embedding backward
// (parallel/embedding.py `_lookup_bwd_body`): g holds the per-unique
// gradients every rank sent for this rank's rows, rows their local rows.
// Within one source rank's block the in-range rows are distinct (they are
// uniques), so a row repeats at most once per source rank.
//
// Bound: device memory. The zero fill writes num_rows*dim*4 bytes, and the
// adds read n*4 bytes of rows, n*dim*4 of g, and read and write
// n*dim*4 of out: num_rows*dim*4 + n*(4 + 3*dim*4) bytes at 3.35 TB/s on an
// H100 SXM. At the Wide&Deep shard (25,000,254 x 2, n = 4 x 6144) the fill
// is nearly all of it: 200 MB, about 60 us.
//
// Design: the TPU version keeps the whole output block in VMEM and walks
// the rows in order on one core. Blocks here run in parallel and in no
// order, so the fill is a cudaMemsetAsync on the caller's stream, and then
// one thread owns one element (j, d) of g over a grid-stride loop
// (neighbouring threads read neighbouring elements, so any dim coalesces,
// 2 as well as 64) and adds it with an f32 atomicAdd. Where rows do not
// repeat each element of out receives one add onto +0.0, so the result
// equals the plain version bit for bit; where a row repeats its adds land
// in no fixed order, so the sum may differ from the plain version's by
// rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // the rest is a grid-stride loop

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ g,
                    const int32_t* __restrict__ rows,
                    float* __restrict__ out, long long n,
                    long long num_rows, long long dim) {
  const long long total = n * dim;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const long long j = t / dim;
    const long long row = rows[j];
    if (row >= 0 && row < num_rows) {
      atomicAdd(out + row * dim + (t - j * dim), g[t]);
    }
  }
}

unsigned blocks_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// Zeroes `out` [num_rows, dim] and launches the scatter-add on `stream`;
// returns the first CUDA error (0 on success). The caller allocates `out`
// and handles n == 0 (a zero block, no launch).
int azt_scatter_rows(const void* g, const void* rows, void* out, long long n,
                     long long num_rows, long long dim, void* stream) {
  if (n <= 0 || num_rows <= 0 || dim <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)(num_rows * dim) * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  scatter_rows_kernel<<<blocks_for(n * dim), kThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(rows),
      static_cast<float*>(out), n, num_rows, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"
