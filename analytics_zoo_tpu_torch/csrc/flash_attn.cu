// Flash attention for Hopper (sm_90a) on the CUDA cores, in f32: the
// two-pass backward's dq pass (B5a) and the one-pass backward (B6). The f32
// forward (B4) and dk/dv pass (B5b) run on the tensor cores as 3xTF32
// (flash_attn_tf32.cu); in bf16 all four run on the tensor cores, in
// flash_attn_bf16.cu.
//
// Replaces the TPU kernels in analytics_zoo_tpu/ops/attention.py:
//   B5a `_flash_bwd_dq_kernel`     (pallas_call in `_flash_bwd_pallas`)
//   B6  `_flash_bwd_fused_kernel`  (pallas_call in `_flash_bwd_fused`)
//
// q [bh, sq, d], k and v [bh, skv, d] (f32, contiguous, d <= 128, any
// lengths, sq and skv apart), the forward's row logsumexp, and an optional
// causal mask aligned top-left (key col visible to query row iff col <=
// row, absolute indices). In f32 throughout, as B7/B8:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e)
//   t[i, j] = -1e30 where causal and j > i
//   p = exp2(t - lse_i * log2(e)), dp = dO_i . v_j,
//   ds = p * (dp - D_i + glse_i) with D_i = sum dO_i * o_i (computed by the
//   caller) and glse the lse cotangent (NULL for 0);
//   dq_i = scale * sum_j ds k_j, dk_j = scale * sum_i ds q_i,
//   dv_j = sum_i p dO_i.
//
// Tiles are 64 query rows by 64 keys. A key tile wholly above the diagonal
// is skipped; a ragged tile is masked (columns past skv weigh exactly 0,
// rows past sq are computed from zeros and not stored). 256 threads, as
// 16 x 16: thread (ty, tx) owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of a 64 x 64 tile, and output rows ty + 16 i, columns
// 4 tx + e + 64 h (e < 4, h < d/64) of a 64 x d tile. Operands sit in
// shared memory as f32 rows padded to d + 4 floats, so a score reads both
// operands as float4 along d, and a product over keys reads its weights as
// float4 along the keys and the 64 x d operand as float4 along d; each
// float4 read feeds four or eight fmas and no read has a bank conflict.
//
//   B5a: a block per (bh, query tile) walking the key tiles: recompute p,
//        dp, ds; dq += ds k. No atomics (150 KB).
//   B6:  a block per (bh, key tile) walking the query tiles from the
//        diagonal down: dv += p^T dO, dk += ds^T q in registers, and each
//        p and ds tile computed once also feeds dq += ds k, added with
//        atomicAdd into an f32 buffer the caller zeroed, scaled before the
//        add. 5 tile products where the two passes take 7. dq then sums
//        its key tiles in no fixed order: at most skv / 64 f32 partial
//        sums, a relative error of order (skv / 64) * 2^-24 of the sum of
//        their magnitudes, and dq is not bit-equal from run to run (dk, dv
//        are). The TPU kernel instead keeps the whole K and V of a bh in
//        VMEM, which does not carry over: at skv 2048, d 128 they are 2 MB,
//        against 227 KB of shared memory (167 KB here).
//
// Bound. The work is 10 * bh * sq * skv * d operations for a backward
// (one-pass count), halved by the causal mask. At the LM's shape (bh 128,
// s 2048, d 128, f32, causal) that is 344 GFLOP, 5.1 ms at the H100 SXM's
// 67 TFLOP/s f32 rate (NVIDIA's data sheet, not a measurement): operations
// bound both. These kernels run f32 fmas on the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kTP = kTile + 4;   // padded row of a 64 x 64 tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // a masked score, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// dst[r][c] (row stride D + 4) = src[row0 + r][c] as f32 for r < 64; zero
// for rows at or past `limit` and columns at or past d. src is the [*, d]
// slice of one bh. D / 4 threads cover a row, four columns each.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int limit, int d, bool vec) {
  constexpr int kTpr = D / 4;
  constexpr int kRpp = kThreads / kTpr;
  const int c = 4 * (threadIdx.x % kTpr);
  for (int r = threadIdx.x / kTpr; r < kTile; r += kRpp) {
    const int g = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < limit && c < d) {
      const T* p = src + (long long)g * d + c;
      if (vec) {
        val = widen4(p);  // d % 4 == 0 and 16-byte aligned rows
      } else {
        val.x = to_f32(p[0]);
        if (c + 1 < d) val.y = to_f32(p[1]);
        if (c + 2 < d) val.z = to_f32(p[2]);
        if (c + 3 < d) val.w = to_f32(p[3]);
      }
    }
    store4(dst + r * (D + 4) + c, val);
  }
}

// per-row values of a 64-row tile into shared memory: dst[r] = src[row0 +
// r] * mul, or `fill` past `limit` (or where src is NULL)
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int limit, float mul,
                                           float fill) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int g = row0 + r;
    dst[r] = (src != nullptr && g < limit) ? src[g] * mul : fill;
  }
}

// acc[i][j] = sum_x a[ty + 16 i][x] * b[tx + 16 j][x] over x < D: one fma
// chain in x order per entry. a and b are [64][D + 4] tiles.
template <int D>
__device__ __forceinline__ void dots(float (&acc)[4][4], const float* a,
                                     const float* b) {
  constexpr int kLd = D + 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int x = 0; x < D; x += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = widen4(a + (ty + 16 * i) * kLd + x);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = widen4(b + (tx + 16 * j) * kLd + x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4 h + e] += sum_k w[ty + 16 i][k] * x[k][64 h + 4 tx + e] over the
// tile's 64 keys (w [64][kTP], x [64][D + 4]; zero past the valid ones)
template <int D>
__device__ __forceinline__ void apply(float (&acc)[4][D / 16], const float* w,
                                      const float* x) {
  constexpr int kLd = D + 4, kH = D / 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = widen4(w + (ty + 16 * i) * kTP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float4 xv = widen4(x + (k + kk) * kLd + 64 * h + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wk = comp(wv[i], kk);
          acc[i][4 * h + 0] = fmaf(wk, xv.x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(wk, xv.y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(wk, xv.z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(wk, xv.w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// acc[i][4 h + e] += sum_k wt[k][ty + 16 i] * x[k][64 h + 4 tx + e]: apply()
// with the weights transposed (wt [64][kTP], rows the keys)
template <int D>
__device__ __forceinline__ void apply_t(float (&acc)[4][D / 16],
                                        const float* wt, const float* x) {
  constexpr int kLd = D + 4, kH = D / 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float wk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wk[i] = wt[k * kTP + ty + 16 * i];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float4 xv = widen4(x + k * kLd + 64 * h + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * h + 0] = fmaf(wk[i], xv.x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(wk[i], xv.y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(wk[i], xv.z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(wk[i], xv.w, acc[i][4 * h + 3]);
      }
    }
  }
}

// out[row0 + ty + 16 i][64 h + 4 tx + e] = acc * mul for rows < limit and
// columns < d
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[4][D / 16],
                                           float mul, int row0, int limit,
                                           int d, bool vec) {
  constexpr int kH = D / 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= limit) continue;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int c = 64 * h + 4 * tx;
      if (c >= d) continue;
      const float4 v = make_float4(__fmul_rn(acc[i][4 * h + 0], mul),
                                   __fmul_rn(acc[i][4 * h + 1], mul),
                                   __fmul_rn(acc[i][4 * h + 2], mul),
                                   __fmul_rn(acc[i][4 * h + 3], mul));
      T* p = out + (long long)row * d + c;
      if (vec) {
        store4(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) p[e] = from_f32<T>(comp(v, e));
      }
    }
  }
}

// max and sum over the 16 threads (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// the key tiles a causal query tile reaches end before q0 + 64
__device__ __forceinline__ int key_end(int q0, int skv, int causal) {
  return causal ? min(skv, q0 + kTile) : skv;
}

// -- shared by the backward kernels ----------------------------------------

// p and ds of one (query tile, key tile) pair for this thread's entries,
// with s the scores and dp the dO.v dots as dots() lays them out: rows
// `r_base + 16 i`, columns `c_base + 16 j`. With keys_are_rows, rows are
// keys and columns queries (the dk/dv walk), else the other way round.
// Row statistics (lse * log2 e, D, glse) are per query, from shared memory.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      bool keys_are_rows, int q0, int k0,
                                      int sq, int skv, int causal,
                                      float scale_log2e, const float* lse2s,
                                      const float* dls, const float* gls) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = keys_are_rows ? tx + 16 * j : ty + 16 * i;
      const int ki = keys_are_rows ? ty + 16 * i : tx + 16 * j;
      const int row = q0 + qi, col = k0 + ki;
      float p = 0.0f;
      if (row < sq && col < skv && !(causal && col > row))
        p = exp2f(__fmul_rn(s[i][j], scale_log2e) - lse2s[qi]);
      s[i][j] = p;
      dp[i][j] = __fmul_rn(p, __fadd_rn(__fsub_rn(dp[i][j], dls[qi]),
                                        gls[qi]));
    }
}

// the first query tile a causal key tile reaches: rows at or past k0
__device__ __forceinline__ int query_begin(int k0, int causal) {
  return causal ? (k0 / kTile) * kTile : 0;
}

// -- B5a: backward, dq -----------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ glse, T* __restrict__ dq,
                    int sq, int skv, int d, float scale_log2e, float scale,
                    int causal, int vec) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = D + 4, kH = D / 64;
  float* qs = reinterpret_cast<float*>(smem4);  // [64][kLd]
  float* dos = qs + kTile * kLd;                // [64][kLd]
  float* ks = dos + kTile * kLd;                // [64][kLd]
  float* vs = ks + kTile * kLd;                 // [64][kLd]
  float* dss = vs + kTile * kLd;                // [64][kTP]: ds[q][k]
  float* lse2s = dss + kTile * kTP;             // [64] x 3
  float* dls = lse2s + kTile;
  float* gls = dls + kTile;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;

  stage<D>(qs, q + bh * sq * d, q0, sq, d, vec);
  stage<D>(dos, dout + bh * sq * d, q0, sq, d, vec);
  stage_rows(lse2s, lse + bh * sq, q0, sq, kLog2e, INFINITY);
  stage_rows(dls, delta + bh * sq, q0, sq, 1.0f, 0.0f);
  stage_rows(gls, glse != nullptr ? glse + bh * sq : nullptr, q0, sq, 1.0f,
             0.0f);
  float acc[4][4 * kH] = {};
  const int kend = key_end(q0, skv, causal);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    stage<D>(ks, kb, k0, skv, d, vec);
    stage<D>(vs, vb, k0, skv, d, vec);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, qs, ks);
    dots<D>(dp, dos, vs);
    probs(s, dp, false, q0, k0, sq, skv, causal, scale_log2e, lse2s, dls,
          gls);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kTP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    apply<D>(acc, dss, ks);
  }
  store_rows<D>(dq + bh * sq * d, acc, scale, q0, sq, d, vec);
}

// -- B6: backward over the queries of one key tile ------------------------

// dk, dv, and dq added into the f32 buffer dq_acc with atomics
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ glse,
                    float* __restrict__ dq_acc, T* __restrict__ dk,
                    T* __restrict__ dv, int sq, int skv, int d,
                    float scale_log2e, float scale, int causal, int vec) {
  extern __shared__ float4 smem4[];
  constexpr int kLd = D + 4, kH = D / 64;
  float* ks = reinterpret_cast<float*>(smem4);  // [64][kLd]
  float* vs = ks + kTile * kLd;                 // [64][kLd]
  float* qs = vs + kTile * kLd;                 // [64][kLd]
  float* dos = qs + kTile * kLd;                // [64][kLd]
  float* ps = dos + kTile * kLd;                // [64][kTP]: p[k][q]
  float* dss = ps + kTile * kTP;                // [64][kTP]: ds[k][q]
  float* lse2s = dss + kTile * kTP;             // [64] x 3
  float* dls = lse2s + kTile;
  float* gls = dls + kTile;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most rows
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + bh * sq * d;
  const T* dob = dout + bh * sq * d;

  stage<D>(ks, k + bh * skv * d, k0, skv, d, vec);
  stage<D>(vs, v + bh * skv * d, k0, skv, d, vec);
  float acc_k[4][4 * kH] = {}, acc_v[4][4 * kH] = {};
  for (int q0 = query_begin(k0, causal); q0 < sq; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    stage<D>(qs, qb, q0, sq, d, vec);
    stage<D>(dos, dob, q0, sq, d, vec);
    stage_rows(lse2s, lse + bh * sq, q0, sq, kLog2e, INFINITY);
    stage_rows(dls, delta + bh * sq, q0, sq, 1.0f, 0.0f);
    stage_rows(gls, glse != nullptr ? glse + bh * sq : nullptr, q0, sq,
               1.0f, 0.0f);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, ks, qs);
    dots<D>(dp, vs, dos);
    probs(s, dp, true, q0, k0, sq, skv, causal, scale_log2e, lse2s, dls,
          gls);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kTP + tx + 16 * j] = s[i][j];
        dss[(ty + 16 * i) * kTP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    apply<D>(acc_v, ps, dos);
    apply<D>(acc_k, dss, qs);
    // this key tile's share of dq for the query tile: ds^T k
    float acc_q[4][4 * kH] = {};
    apply_t<D>(acc_q, dss, ks);
    float* dqb = dq_acc + bh * sq * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= sq) continue;
#pragma unroll
      for (int c = 0; c < 4 * kH; ++c) {
        const int col = 64 * (c / 4) + 4 * tx + c % 4;
        if (col < d)
          atomicAdd(dqb + (long long)row * d + col,
                    __fmul_rn(acc_q[i][c], scale));
      }
    }
  }
  store_rows<D>(dk + bh * skv * d, acc_k, scale, k0, skv, d, vec);
  store_rows<D>(dv + bh * skv * d, acc_v, 1.0f, k0, skv, d, vec);
}

// -- launches --------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t tiles_bytes(int d_tpl, int rows_tiles, int score_tiles, int vecs) {
  return sizeof(float) * ((size_t)rows_tiles * kTile * (d_tpl + 4) +
                          (size_t)score_tiles * kTile * kTP +
                          (size_t)vecs * kTile);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* glse, void* dq,
              long long bh, int sq, int skv, int d, float scale_log2e,
              float scale, int causal, int vec, cudaStream_t stream) {
  const size_t smem = tiles_bytes(D, 4, 1, 3);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)bh, (unsigned)tiles(sq)), kThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<T*>(dq), sq, skv, d,
      scale_log2e, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* glse, void* dq_acc, void* dk, void* dv,
                 long long bh, int sq, int skv, int d, float scale_log2e,
                 float scale, int causal, int vec, cudaStream_t stream) {
  const size_t smem = tiles_bytes(D, 4, 2, 3);
  auto kernel = flash_bwd_fused_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)bh, (unsigned)tiles(skv)), kThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<float*>(dq_acc),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, d, scale_log2e,
      scale, causal, vec);
  return (int)cudaGetLastError();
}

bool bad_shape(long long bh, int sq, int skv, int d) {
  return bh < 0 || bh > 0x7fffffffLL || sq < 1 || skv < 1 ||
         tiles(sq) > 65535 || tiles(skv) > 65535 || d < 1 || d > kMaxD;
}

// rows may be read and written as float4 when d is a multiple of 4 and
// every tensor starts on 16 bytes
int vector_ok(int d, const void* a, const void* b, const void* c,
              const void* e, const void* f, const void* g) {
  return d % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) &&
         aligned16(e) && aligned16(f) && aligned16(g);
}

}  // namespace

extern "C" {

// B5a on `stream`; returns cudaGetLastError() (0 on success). dq [bh, sq,
// d] f32 (dtype 0; bf16 takes azt_flash_bwd_dq_bf16). lse, delta, glse:
// [bh, sq] f32 (glse may be NULL for zero).
int azt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* glse, void* dq, long long bh, int sq,
                     int skv, int d, int dtype, float scale_log2e,
                     float scale, int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = vector_ok(d, q, k, v, dout, dq, nullptr);
  const bool wide = d > 64;
  switch (dtype) {
    case 0:
      return wide ? launch_dq<float, 128>(q, k, v, dout, lse, delta, glse,
                                          dq, bh, sq, skv, d, scale_log2e,
                                          scale, causal, vec, st)
                  : launch_dq<float, 64>(q, k, v, dout, lse, delta, glse, dq,
                                         bh, sq, skv, d, scale_log2e, scale,
                                         causal, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B6 on `stream`; returns cudaGetLastError(). dk, dv [bh, skv, d] f32
// (dtype 0; bf16 takes azt_flash_bwd_fused_bf16), and dq added into dq_acc
// [bh, sq, d] f32, which the caller zeroes.
int azt_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse,
                        const void* delta, const void* glse, void* dq_acc,
                        void* dk, void* dv, long long bh, int sq, int skv,
                        int d, int dtype, float scale_log2e, float scale,
                        int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = vector_ok(d, q, k, v, dout, dk, dv);
  const bool wide = d > 64;
  switch (dtype) {
    case 0:
      return wide ? launch_fused<float, 128>(
                        q, k, v, dout, lse, delta, glse, dq_acc, dk, dv, bh,
                        sq, skv, d, scale_log2e, scale, causal, vec, st)
                  : launch_fused<float, 64>(
                        q, k, v, dout, lse, delta, glse, dq_acc, dk, dv, bh,
                        sq, skv, d, scale_log2e, scale, causal, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
