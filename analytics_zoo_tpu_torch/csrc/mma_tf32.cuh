// 3xTF32 tensor-core building blocks for Hopper (sm_90a), for products
// held to f32 accuracy: the f32 routes of the fused short attention
// (fused_short_attn.cu, B7/B8) and of the flash kernels (flash_attn_tf32.cu,
// B4, B5a, B5b, B6). mma.sync m16n8k8 TF32 -> f32, each f32
// operand split into two TF32 parts, fragment loads from f32 tiles in
// shared memory, an f32 accumulator fed back as an A fragment, staging
// tiles of f32 rows, and the walk both files share (below). cp.async and
// the quad reductions are mma_bf16.cuh's.
//
// 3xTF32: x = big + small + r, big = tf32(x) and small = tf32(x - big),
// both rounded to nearest (ties away, as cvt.rna); x - big is exact in f32,
// and |r| <= 2^-22 |x|. a.b is taken as small_a.big_b + big_a.small_b +
// big_a.big_b, small terms first, into the same f32 accumulators
// (CUTLASS's OpMultiplyAddFastF32 order); the small.small term, below
// 2^-22 of the product, is dropped. One TF32 product alone keeps about
// three digits, far from the f32 route's 2e-5 of the output's scale.
//
// Fragments (m16n8k8 TF32, g = lane / 4, t = lane % 4): A (16 x 8) {(g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)}; B (8 x 8) {(k t, n g), (k t + 4,
// n g)}; C (16 x 8 f32) {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t +
// 1)}. A C fragment becomes the A fragment of the next product with no
// shuffle when the reduction index inside each 8-step is permuted: k t is
// column 2t and k t + 4 column 2t + 1, so the B operand's rows are read in
// that order (load_b). The permutation reorders a sum, nothing else.
//
// A staged tile is f32 rows with a stride of 8 * kD + 4 floats, kD the
// number of 8-column chunks; columns [d, 8 * ceil(d / 8)) hold zeros. A
// stride of 4 (mod 8) words puts every fragment load on 32 banks: the A
// and K^T loads read rows g (stride * g covers the multiples of 4 mod 32
// once each) and columns t, the B loads rows 2t and 2t + 1 (2 * stride * t
// covers 0, 8, 16, 24) and columns g.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

// -- the split and the product ----------------------------------------------

// tf32 of x, rounded to nearest with ties away from zero, as cvt.rna.tf32
// rounds it: half a TF32 unit added to the magnitude, the 13 low mantissa
// bits cleared, so that it reads back as the f32 it stands for. Two integer
// ops: on the H100 cvt.rna gave every output bit-equal but took B7/B8
// 15-31% longer (scripts/fused_short_f32_variants.py).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an f32 operand's fragment as its big and small TF32 parts
template <int N>
struct Split {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = tf32_rna(x);
    small[i] = tf32_rna(__fsub_rn(x, __uint_as_float(big[i])));
  }
};
typedef Split<4> FragA;
typedef Split<2> FragB;

// c (16 x 8 f32) += a (16 x 8 TF32) . b (8 x 8 TF32)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32: small.big, big.small, then big.big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// c += a . b in 3xTF32 as two levels: the three products summed from zero,
// then added to c by one rounded f32 add an element. Summed straight into
// c, a long reduction drifts: on the H100, B5b's dk and dv over 4096
// queries missed the plain version by 4.7e-5 of scale, and by 3.2e-6 this
// way, at 3-4% more time (scripts/flash_f32_timing.py's variants): the
// mma's own accumulation loses bits relative to c, which grows, and here
// relative to one 8-step's sum.
__device__ __forceinline__ void mma3_add(float (&c)[4], const FragA& a,
                                         const FragB& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma3(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

// -- fragments from shared memory -------------------------------------------

// the A fragment of the warp's 16 rows at a (row stride ld), columns
// [8 kc, 8 kc + 8)
__device__ __forceinline__ void load_a(FragA& f, const float* a, int ld,
                                       int kc) {
  const int lane = threadIdx.x % 32;
  const float* p = a + (lane / 4) * ld + 8 * kc + lane % 4;
  f.set(0, p[0]);
  f.set(1, p[8 * ld]);
  f.set(2, p[4]);
  f.set(3, p[8 * ld + 4]);
}

// the B fragment of X^T for the 8 rows of X at x (row stride ld), whose
// rows are the product's columns (K in Q.K^T), columns [8 kc, 8 kc + 8)
// the reduction
__device__ __forceinline__ void load_bt(FragB& f, const float* x, int ld,
                                        int kc) {
  const int lane = threadIdx.x % 32;
  const float* p = x + (lane / 4) * ld + 8 * kc + lane % 4;
  f.set(0, p[0]);
  f.set(1, p[4]);
}

// the B fragment of the 8 rows of X at x (row stride ld), whose rows are
// the reduction in c_to_a's order (V in P.V), columns [8 n, 8 n + 8)
__device__ __forceinline__ void load_b(FragB& f, const float* x, int ld,
                                       int n) {
  const int lane = threadIdx.x % 32;
  const float* p = x + 2 * (lane % 4) * ld + 8 * n + lane / 4;
  f.set(0, p[0]);
  f.set(1, p[ld]);
}

// the A fragment of a 16 x 8 accumulator, its columns in the permuted
// order: P (or dS) feeds the next product from registers
__device__ __forceinline__ void c_to_a(FragA& f, const float (&c)[4]) {
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
}

// -- tiles ------------------------------------------------------------------

// dst[r][c] (row stride ld) = src[(row0 + r) * d + c] for kRows rows, zero
// for rows past s; columns [d, 8 * ceil(d / 8)) are zero too: the element
// path writes them, the 16-byte path leaves the zeros zero_pad_cols_f32
// wrote at the start. On the 16-byte path (d % 4 == 0, 16-byte aligned)
// 2 * kD threads share a row, thread x copying 4 columns from 4 * (x %
// (2 * kD)): no division by d in the loop.
template <int kRows, int kThreads, int kD>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* __restrict__ src,
                                              int row0, int s, int d,
                                              bool vec) {
  constexpr int kPer = 2 * kD;  // 16-byte pieces of a row
  static_assert(kThreads % kPer == 0, "whole rows a pass");
  if (vec) {
    const int c = (threadIdx.x % kPer) * 4;
    if (c < d) {
      for (int r = threadIdx.x / kPer; r < kRows; r += kThreads / kPer) {
        const int g = row0 + r;
        cp_async16(dst + r * ld + c, src + (long long)min(g, s - 1) * d + c,
                   g < s ? 16 : 0);
      }
    }
  } else {
    const int dp = (d + 7) / 8 * 8;
    for (int i = threadIdx.x; i < kRows * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const int g = row0 + r;
      dst[r * ld + c] = g < s && c < d ? src[(long long)g * d + c] : 0.0f;
    }
  }
}

// zeros in columns [d, 8 * ceil(d / 8)) of `rows` consecutive rows
template <int kThreads>
__device__ __forceinline__ void zero_pad_cols_f32(float* tiles, int rows,
                                                  int ld, int d) {
  const int w = (d + 7) / 8 * 8 - d;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int r = i / w;
    tiles[r * ld + d + (i - r * w)] = 0.0f;
  }
}

// acc (16 rows x 8 kD columns, fragments) times `mul` to out's rows row0 +
// r below s, columns below d
template <int kD>
__device__ __forceinline__ void store_acc(float* __restrict__ out,
                                          const float (&acc)[kD][4],
                                          float mul, int row0, int s,
                                          int d) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= s) continue;
    float* o = out + (long long)row * d;
#pragma unroll
    for (int n = 0; n < kD; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) o[c] = __fmul_rn(acc[n][2 * i], mul);
      if (c + 1 < d) o[c + 1] = __fmul_rn(acc[n][2 * i + 1], mul);
    }
  }
}

// -- the walk -----------------------------------------------------------------

// A block owns 64 rows (queries; keys in a dk/dv pass) in four groups of
// 16 and walks the other side in tiles of 32 * kSplit rows held in shared
// memory. Each row group has kSplit warps, warp (group, h) taking rows
// [32 h, 32 h + 32) of every walked tile; at the end the other warps hand
// their partial results to the first, which merges them in a fixed order
// (so still no atomics). kSplit 2 or 4 gives a grid too small to fill the
// card more warps a block and a shorter serial chain of products a warp;
// a large grid fills the SMs with four-warp blocks, whose registers leave
// room for more of them (see split_for). The flash kernels (B4, B5a, B5b,
// B6) walk with one warp a row group at every grid (flash_attn_tf32.cu).
constexpr int kPart = 32;            // a warp's rows of a walked tile
constexpr int kRows = 64;            // a block's own rows
constexpr int kGroupLanes = 4 * 32;  // a warp of each row group

// word i of this lane in the exchange between a row group's warps, [i][row
// group][lane]: a warp writes, and the first reads, 32 consecutive words
// at a time
__device__ __forceinline__ int xch_at(int i) {
  return i * kGroupLanes + threadIdx.x % kGroupLanes;
}

// the row group's other warps' accumulators added to the first's in turn,
// through xch; returns whether this warp is the first (and holds the sum)
template <int kD, int kSplit>
__device__ __forceinline__ bool merge_into_first(float* xch,
                                                 float (&acc)[kD][4], int h) {
  for (int from = 1; from < kSplit; ++from) {
    if (h == from) {
#pragma unroll
      for (int n = 0; n < kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[xch_at(4 * n + e)] = acc[n][e];
    }
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int n = 0; n < kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += xch[xch_at(4 * n + e)];
    }
    __syncthreads();  // read before the next warp writes
  }
  return h == 0;
}

// -- launches -----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// bytes of a staged tile of `rows` rows
inline size_t tile_bytes(int kD, int rows) {
  return sizeof(float) * rows * (8 * kD + 4);
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// the warps a row group for a grid of `blocks`, at most `most`: four
// while the grid is under two blocks an SM (B7 only: B8's passes take
// more registers or shared memory than a 512-thread block leaves), two
// while it is under eight, else one. On the H100 at d 128,
// two made B7 and B8 37% faster at the LM's prefill (128 blocks) and 13%
// at s 512 (512 blocks); at BERT-base's shape (3072 blocks, d 64) one made
// B8 17% faster, the four-warp blocks fitting more warps an SM
// (scripts/fused_short_f32_variants.py).
inline int split_for(long long blocks, int most) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 2;
  if (most >= 4 && blocks < 2LL * sms) return 4;
  return blocks < 8LL * sms ? 2 : 1;
}

// F's launch at head width kD (4, 8 or 16 chunks of 8) for the split
// split_for picks, up to kMost
template <template <int, int> class F, int kD, int kMost, typename... Args>
int launch_split(int split, Args... args) {
  if constexpr (kMost >= 4)
    if (split == 4) return F<kD, 4>::run(args...);
  return split == 2 ? F<kD, 2>::run(args...) : F<kD, 1>::run(args...);
}

// F<kD, split>::run(args...) for head width d and a grid of `blocks`
template <template <int, int> class F, int kMost, typename... Args>
int dispatch(long long blocks, int d, Args... args) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int split = split_for(blocks, kMost);
  if (d <= 32) return launch_split<F, 4, kMost>(split, args...);
  if (d <= 64) return launch_split<F, 8, kMost>(split, args...);
  return launch_split<F, 16, kMost>(split, args...);
}

}  // namespace
