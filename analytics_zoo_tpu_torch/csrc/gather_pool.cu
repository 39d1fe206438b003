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
// 0.36 MB, 0.1 us at 3.35 TB/s: there one launch costs more than the bytes.
//
// Design: the TPU version walks its grid in order and double-buffers one
// DMA per gathered row into a VMEM accumulator. Here blocks run in parallel
// and in no order, so nothing carries between them: a group of G threads
// owns one output row, G = dim for rows narrower than a warp (the wide
// table's rows are 8 bytes, so one warp pools 16 bags) and G = 32 otherwise,
// each thread walking its columns with stride G. Every thread loops over
// the bag itself, reading the bag's ids (the group's threads read the same
// id, one broadcast) and its own column of each row. The sum runs in bag
// order with plain f32 adds, IEEE division and sqrt, so the kernel equals
// its plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load_f32<__half>(const __half* p) {
  return __half2float(*p);
}

template <typename T>
__device__ __forceinline__ T store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half store_cast<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_pool_kernel(const T* __restrict__ table,
                   const int32_t* __restrict__ ids, T* __restrict__ out,
                   long long n, int bag, long long rows, long long dim,
                   int group, int combiner, int clip) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / group;
  const int g = (int)(t - i * group);
  if (i >= n || g >= dim) return;
  const int32_t* bag_ids = ids + i * bag;
  for (long long j = g; j < dim; j += group) {
    float acc = 0.0f;
    float count = 0.0f;
    for (int k = 0; k < bag; ++k) {
      long long row = bag_ids[k];
      if (clip) {
        row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
      } else if (row < 0 || row >= rows) {
        continue;
      }
      acc += load_f32(table + row * dim + j);
      count += 1.0f;
    }
    const float denom = fmaxf(count, 1.0f);
    if (combiner == 1) {
      acc = acc / denom;
    } else if (combiner == 2) {
      acc = acc / sqrtf(denom);
    }
    out[i * dim + j] = store_cast<T>(acc);
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, long long n,
           int bag, long long rows, long long dim, int combiner, int clip,
           cudaStream_t stream) {
  const int group = dim < 32 ? (int)dim : 32;
  const long long threads = n * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_pool_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<T*>(out), n, bag, rows, dim, group, combiner, clip);
  return (int)cudaGetLastError();
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
    case 0:
      return launch<float>(table, ids, out, n, bag, rows, dim, combiner,
                           clip, s);
    case 1:
      return launch<__nv_bfloat16>(table, ids, out, n, bag, rows, dim,
                                   combiner, clip, s);
    case 2:
      return launch<__half>(table, ids, out, n, bag, rows, dim, combiner,
                            clip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
