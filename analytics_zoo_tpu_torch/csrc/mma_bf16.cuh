// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// fused short attention (fused_short_attn_bf16.cu, B7/B8) and the flash
// attention (flash_attn_bf16.cu, B4/B6): ldmatrix fragments, mma.sync
// m16n8k16 bf16 -> f32, 16-byte cp.async, packing an f32 accumulator into
// an A fragment, quad reductions, and staging tiles of bf16 rows.
//
// A staged tile is bf16 rows with a stride of 16 * kD + 8 elements, kD the
// number of 16-column chunks (the 16 extra bytes spread ldmatrix's eight
// rows over the banks); columns [d, 16 * ceil(d / 16)) hold zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// -- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives, of matrix j in register j, row lane / 4, columns
// 2 * (lane % 4) and + 1 (.trans: rows 2 * (lane % 4) and + 1, column
// lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16) . b (16 x 8 bf16). Fragments, g =
// lane / 4, t = lane % 4: a {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}; b {(k 2t.., n g), (k 2t + 8.., n g)}; c {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- tiles -----------------------------------------------------------------

// dst[r][c] (row stride ld) = src[(row0 + r) * d + c] for kRows rows,
// zero for rows past s; columns [d, 16 * ceil(d / 16)) are zero too: the
// element path writes them, the 16-byte path leaves the zeros
// zero_pad_cols wrote at the start. kThreads threads share the copy; on
// the 16-byte path thread x copies 8 columns from 8 * (x % 16) (so d <=
// 128) of rows x / 16, + kThreads / 16, ...: no division by d in the loop.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int row0, int s, int d, bool vec) {
  static_assert(kThreads % 16 == 0, "16 threads a row");
  if (vec) {
    const int c = (threadIdx.x % 16) * 8;
    if (c < d) {
      for (int r = threadIdx.x / 16; r < kRows; r += kThreads / 16) {
        const int g = row0 + r;
        cp_async16(dst + r * ld + c, src + (long long)min(g, s - 1) * d + c,
                   g < s ? 16 : 0);
      }
    }
  } else {
    const int dp = (d + 15) / 16 * 16;
    for (int i = threadIdx.x; i < kRows * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const int g = row0 + r;
      dst[r * ld + c] = g < s && c < d ? src[(long long)g * d + c]
                                       : __float2bfloat16(0.0f);
    }
  }
}

// zeros in columns [d, 16 * ceil(d / 16)) of `rows` consecutive rows
template <int kThreads>
__device__ __forceinline__ void zero_pad_cols(bf16* tiles, int rows, int ld,
                                              int d) {
  const int w = (d + 15) / 16 * 16 - d;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int r = i / w;
    tiles[r * ld + d + (i - r * w)] = __float2bfloat16(0.0f);
  }
}

// rows [16 * warp, + 16) of the staged tile xs to out rows row0 + 16 *
// warp + r below s, columns below d; one warp, no block barrier
__device__ __forceinline__ void store_warp_rows(bf16* __restrict__ out,
                                                const bf16* xs, int ld,
                                                int row0, int s, int d,
                                                bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  xs += warp * 16 * ld;
  row0 += warp * 16;
  if (vec) {
    const int chunks = d / 8;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      if (row0 + r < s)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(xs + r * ld + c);
    }
  } else {
    for (int i = lane; i < 16 * d; i += 32) {
      const int r = i / d, c = i - r * d;
      if (row0 + r < s) out[(long long)(row0 + r) * d + c] = xs[r * ld + c];
    }
  }
}

// acc (a warp's 16 rows x 16 * kD columns, fragments) times `mul`, as bf16
// into the warp's rows of the staged tile xs
template <int kD>
__device__ __forceinline__ void stage_acc(bf16* xs, int ld,
                                          const float (&acc)[2 * kD][4],
                                          float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  bf16* row = xs + (warp * 16 + g) * ld + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n) {
    *reinterpret_cast<uint32_t*>(row + n * 8) =
        pack_bf16(__fmul_rn(acc[n][0], mul), __fmul_rn(acc[n][1], mul));
    *reinterpret_cast<uint32_t*>(row + 8 * ld + n * 8) =
        pack_bf16(__fmul_rn(acc[n][2], mul), __fmul_rn(acc[n][3], mul));
  }
  __syncwarp();
}

// c[n] += A . B^T for the warp's 16 rows of `a` (row stride ld) against
// rows n * 8 .. of `b` (kN n-tiles), over kd chunks of 16 columns: B is
// stored with its rows as the product's columns (K for q.k^T)
template <int kN, int kD>
__device__ __forceinline__ void mma_abt(float (&c)[kN][4], const bf16* a,
                                        const bf16* b, int ld, int kd) {
  const int lane = threadIdx.x % 32;
  const bf16* pa = a + (lane % 16) * ld + (lane / 16) * 8;
  const bf16* pb = b + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kc = 0; kc < kD; ++kc) {
    if (kc < kd) {
      uint32_t af[4];
      ldsm_x4(af, pa + kc * 16);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, pb + np * 16 * ld + kc * 16);
        mma(c[2 * np], af, bf[0], bf[1]);
        mma(c[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc += P . X for one chunk of 16 reduction rows: `af` the A fragment
// (16 rows x 16), x the 16 staged rows of X (row stride ld) whose columns
// are the product's, over kd chunks of 16 columns
template <int kD>
__device__ __forceinline__ void mma_ax(float (&acc)[2 * kD][4],
                                       const uint32_t (&af)[4], const bf16* x,
                                       int ld, int kd) {
  const int lane = threadIdx.x % 32;
  const bf16* px = x + (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
#pragma unroll
  for (int np = 0; np < kD; ++np) {
    if (np < kd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, px + np * 16);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// the A fragment of columns [16 j, 16 j + 16) of a 16-row accumulator
template <int kN>
__device__ __forceinline__ void to_a(uint32_t (&af)[4], const float (&c)[kN][4],
                                     int j) {
  af[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  af[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  af[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  af[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

}  // namespace
