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
// The scale is a 0-d f32 tensor on the card, read here by every thread: the
// host never reads it, so a call never waits for the device.
//
// Arithmetic: one exact int8 -> f32 conversion and one f32 multiply
// (round to nearest even; nothing to contract into an fma), so the output
// equals the plain PyTorch version bit for bit.
//
// Bound: a copy that widens 1 byte to 4, so device memory bounds it:
// d*dim (the distinct rows the ids reach, each read once) + 4*n*dim (f32
// out) + 4*n (ids) bytes at 3.35 TB/s on an H100 SXM. At the NCF serving
// batch (256 ids x 64) that is about 0.03 us, far below one launch; at 2^20
// distinct ids of 64 it is about 0.1 ms.
//
// Design: the TPU version scalar-prefetches 256 ids per grid step and
// double-buffers one row DMA through VMEM. Blocks here run in parallel and
// in no order, so each thread owns one unit of one output row (the flat
// index over n x units): where dim % 4 == 0 and the table's base is 4-byte
// aligned (then every row is), a unit is 4 int8 read as one 32-bit word and
// written as one float4, and neighbouring threads touch neighbouring words;
// otherwise a unit is one byte, written as one float. Short rows therefore
// share a warp instead of leaving lanes idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // the rest is a grid-stride loop

__global__ void __launch_bounds__(kThreads)
gather_int8_word_kernel(const int32_t* __restrict__ table,
                        const float* __restrict__ scale,
                        const int32_t* __restrict__ ids,
                        float4* __restrict__ out, long long n,
                        long long rows, long long words) {
  const float s = *scale;
  const long long total = n * words;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const long long i = t / words;
    const long long w = t - i * words;
    const long long row = ids[i];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0 && row < rows) {
      const int32_t packed = table[row * words + w];
      // little-endian: byte k of the word is element 4w + k
      v.x = (float)(int8_t)(packed & 0xff) * s;
      v.y = (float)(int8_t)((packed >> 8) & 0xff) * s;
      v.z = (float)(int8_t)((packed >> 16) & 0xff) * s;
      v.w = (float)(int8_t)((packed >> 24) & 0xff) * s;
    }
    out[t] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_int8_byte_kernel(const int8_t* __restrict__ table,
                        const float* __restrict__ scale,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, long long n, long long rows,
                        long long dim) {
  const float s = *scale;
  const long long total = n * dim;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += (long long)gridDim.x * kThreads) {
    const long long i = t / dim;
    const long long j = t - i * dim;
    const long long row = ids[i];
    out[t] = (row >= 0 && row < rows) ? (float)table[row * dim + j] * s
                                      : 0.f;
  }
}

unsigned blocks_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
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
  if (dim % 4 == 0 && (uintptr_t)table % 4 == 0 && (uintptr_t)out % 16 == 0) {
    const long long words = dim / 4;
    gather_int8_word_kernel<<<blocks_for(n * words), kThreads, 0, s>>>(
        static_cast<const int32_t*>(table), static_cast<const float*>(scale),
        static_cast<const int32_t*>(ids), static_cast<float4*>(out), n, rows,
        words);
  } else {
    gather_int8_byte_kernel<<<blocks_for(n * dim), kThreads, 0, s>>>(
        static_cast<const int8_t*>(table), static_cast<const float*>(scale),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), n, rows,
        dim);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
