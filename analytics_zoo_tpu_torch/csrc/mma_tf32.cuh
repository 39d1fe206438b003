// 3xTF32 tensor-core building blocks for Hopper (sm_90a), for products
// held to f32 accuracy: the fused short attention's f32 route
// (fused_short_attn.cu, B7/B8). mma.sync m16n8k8 TF32 -> f32, each f32
// operand split into two TF32 parts, fragment loads from f32 tiles in
// shared memory, an f32 accumulator fed back as an A fragment, and staging
// tiles of f32 rows. cp.async and the quad reductions are mma_bf16.cuh's.
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

}  // namespace
