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
// Bound: device memory. Each input byte read once and each output byte
// written once: num_rows*dim*4 + n*(4 + dim*4) bytes at 3.35 TB/s on an
// H100 SXM. At the Wide&Deep shard (25,000,254 x 2, n = 4 x 6144) the
// output is nearly all of it: 200 MB, about 60 us; the adds are 49,152
// floats.
//
// Design: the TPU version keeps the whole output block in VMEM and walks
// the rows in order on one core. Here the block is too large for any
// on-chip memory, and the adds may land anywhere in it, so the fill must
// be complete before any add. The fill and the adds are one cooperative
// launch (cudaLaunchCooperativeKernel: every block resident at once, as
// many as kBlocksPerSm an SM):
//
//   1. the fill: each block zeroes chunks of kChunk 16-byte units with
//      streaming stores, its block index's first, then chunks drawn from
//      a counter (thread 0 draws the next while the block stores the
//      current one), so chunks go out in address order as a one-shot
//      grid's blocks would start, and no block can drift behind the others
//      and hold up the barrier (a fixed grid-stride split of the same fill
//      measured 2-3% slower in turns);
//   2. a grid-wide barrier (cooperative_groups' grid.sync());
//   3. the adds: every in-range g row with vector f32 atomics (float4,
//      float2 or float, as dim allows), lanes packed to the row width (one
//      lane a row at width 2), in a grid-stride loop over the rows. Each
//      thread reads its first row id and g vector before the fill and
//      prefetches the line they add to into L2 before the barrier, so at
//      the Wide&Deep shard (one row or none a thread) the adds after the
//      barrier are atomics on L2-resident lines and nothing else.
//
// The grid is as many blocks as the fill's chunks or the adds' rows can
// use, at most kBlocksPerSm an SM: at a small block with many rows (the
// Wide&Deep embed shards, 8192 rows of 8) as many as hold one row a
// thread's lanes.
//
// The counter (two u64, zero before the launch) is the caller's, one a
// stream so that launches on two streams never share one; the last block
// to finish drawing leaves it at zero for the next launch. A block of no
// more chunks than the grid has blocks (the Wide&Deep embed shards) needs
// no draws and leaves the counter alone: its two dependent atomics cost
// more than a microsecond at a launch that takes three. One launch
// replaces a cudaMemsetAsync and a second kernel that waited for it to
// drain.
//
// Timed against it (PERF.md): design (b), at commit 714f1b4 in
// scripts/scatter_rows_range_owner.cu, where each block owns a range of
// rows, zeroes it and adds only the rows landing there after a
// __syncthreads, with no grid barrier; its every-block scan of the row
// ids, starved by the fill's stores, made it slower at both timed shapes.
//
// Where rows do not repeat each element of out receives one add onto
// +0.0, so the result equals the plain version bit for bit; where a row
// repeats its adds land in no fixed order, so the sum may differ from the
// plain version's by rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kFillUnroll = 4;  // 16-byte stores a thread issues a chunk
constexpr long long kChunk = (long long)kThreads * kFillUnroll;  // 32 KB
constexpr int kMaxDevices = 64;

// W f32 as one value: float4, float2 or float.
template <int W> struct Vec { using T = float; };
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };

template <int W>
__device__ __forceinline__ typename Vec<W>::T load_vec(const float* src) {
  return *reinterpret_cast<const typename Vec<W>::T*>(src);
}

template <int W>
__device__ __forceinline__ void add_vec(float* dst, typename Vec<W>::T x) {
  atomicAdd(reinterpret_cast<typename Vec<W>::T*>(dst), x);
}

// W: floats an atomic adds (dim % W == 0).
template <int W>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ g,
                    const int32_t* __restrict__ rows,
                    float* __restrict__ out, long long n,
                    long long num_rows, long long dim,
                    unsigned long long* __restrict__ counter) {
  __shared__ unsigned long long ticket[2];
  const long long total = num_rows * dim;
  const long long n4 = total / 4;
  const unsigned long long chunks = (n4 + kChunk - 1) / kChunk;
  float4* v = reinterpret_cast<float4*>(out);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  // the adds' layout: lanes packed to the row width, per_warp rows a warp
  const long long vecs = dim / W;
  const int lanes = vecs < 32 ? (int)vecs : 32;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane / lanes;
  const int v0 = lane - sub * lanes;
  const long long slots = (long long)gridDim.x * (kThreads / 32) * per_warp;
  const bool adds = sub < per_warp;
  // this thread's first row and its first g vector, read while the grid
  // fills (the rest of its rows, if any, after the barrier)
  const long long j0 =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
          per_warp + sub;
  long long r0 = -1;
  typename Vec<W>::T g0{};
  if (adds && j0 < n) {
    r0 = rows[j0];
    if (r0 >= 0 && r0 < num_rows) g0 = load_vec<W>(g + j0 * dim + v0 * W);
  }

  // each block's first chunk is its own; the counter hands out the rest,
  // if any (a block of at most gridDim.x chunks never touches it)
  const bool draws = chunks > gridDim.x;
  if (threadIdx.x == 0) ticket[0] = blockIdx.x;
  __syncthreads();
  for (int it = 0;; it ^= 1) {
    const unsigned long long c = ticket[it];
    if (c >= chunks) break;
    if (threadIdx.x == 0)
      ticket[it ^ 1] = draws ? gridDim.x + atomicAdd(counter, 1ull) : chunks;
    const long long base = (long long)c * kChunk + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kFillUnroll; ++k) {
      const long long w = base + k * kThreads;
      if (w < n4) __stcs(v + w, z);
    }
    __syncthreads();
  }
  // no loop here is unrolled: a trip count costs a 64-bit division
  if (blockIdx.x == 0) {  // the floats past the last whole 16 bytes
#pragma unroll 1
    for (long long e = 4 * n4 + threadIdx.x; e < total; e += kThreads)
      __stcs(out + e, 0.f);
  }
  if (draws && threadIdx.x == 0) {  // the last block done drawing resets it
    __threadfence();
    if (atomicAdd(counter + 1, 1ull) == gridDim.x - 1) {
      counter[0] = 0;
      counter[1] = 0;
    }
  }
  const bool first = r0 >= 0 && r0 < num_rows;
  if (first)  // its target line into L2 while the other blocks finish
    asm volatile("prefetch.global.L2 [%0];" ::"l"(out + r0 * dim + v0 * W));
  cg::this_grid().sync();

  if (!adds) return;
  if (first) {
    add_vec<W>(out + r0 * dim + v0 * W, g0);
#pragma unroll 1
    for (long long k = v0 + lanes; k < vecs; k += lanes)
      add_vec<W>(out + r0 * dim + k * W, load_vec<W>(g + j0 * dim + k * W));
  }
#pragma unroll 1
  for (long long j = j0 + slots; j < n; j += slots) {
    const long long r = rows[j];
    if (r < 0 || r >= num_rows) continue;
#pragma unroll 1
    for (long long k = v0; k < vecs; k += lanes)
      add_vec<W>(out + r * dim + k * W, load_vec<W>(g + j * dim + k * W));
  }
}

// Blocks of the cooperative grid on the current device for kernel<W>,
// read once a device: at most kBlocksPerSm an SM, as many as fit at once.
template <int W>
int grid_blocks() {
  static int blocks[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_rows_kernel<W>, kThreads, 0);
    blocks[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  return blocks[dev];
}

template <int W>
int launch(const void* g, const void* rows, void* out, long long n,
           long long num_rows, long long dim, void* counter,
           cudaStream_t stream) {
  // no more blocks than the fill's chunks and the adds' rows can use
  const long long chunks = (num_rows * dim / 4 + kChunk - 1) / kChunk;
  const long long vecs = dim / W;
  const long long rows_a_block =
      (kThreads / 32) * (vecs < 32 ? 32 / vecs : 1);
  const long long add_blocks = (n + rows_a_block - 1) / rows_a_block;
  long long blocks = chunks > add_blocks ? chunks : add_blocks;
  if (blocks < 1) blocks = 1;
  const int cap = grid_blocks<W>();
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  if (blocks > cap) blocks = cap;
  const float* gp = static_cast<const float*>(g);
  const int32_t* rp = static_cast<const int32_t*>(rows);
  float* op = static_cast<float*>(out);
  unsigned long long* cp = static_cast<unsigned long long*>(counter);
  void* args[] = {&gp, &rp, &op, &n, &num_rows, &dim, &cp};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)scatter_rows_kernel<W>, dim3((unsigned)blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

extern "C" {

// Zeroes `out` [num_rows, dim] and adds the in-range rows of `g` in one
// launch on `stream`; returns the launch's CUDA error (0 on success).
// The caller allocates `out`, 16-byte aligned, as torch.empty does, and
// `counter`: two u64, zero, used by one stream only (the launch leaves
// them zero); it handles n == 0 (a zero block, no launch).
int azt_scatter_rows(const void* g, const void* rows, void* out, long long n,
                     long long num_rows, long long dim, void* counter,
                     void* stream) {
  if (n <= 0 || num_rows <= 0 || dim <= 0 || (uintptr_t)out % 16 != 0 ||
      counter == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim % 4 == 0 && (uintptr_t)g % 16 == 0)
    return launch<4>(g, rows, out, n, num_rows, dim, counter, s);
  if (dim % 2 == 0 && (uintptr_t)g % 8 == 0)
    return launch<2>(g, rows, out, n, num_rows, dim, counter, s);
  return launch<1>(g, rows, out, n, num_rows, dim, counter, s);
}

}  // extern "C"
