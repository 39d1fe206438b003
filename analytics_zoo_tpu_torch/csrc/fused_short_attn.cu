// Fused short-sequence attention, forward (B7) and backward (B8), f32
// route, on the CUDA cores of Hopper (sm_90a). bf16 inputs take the
// tensor-core route in fused_short_attn_bf16.cu; the dtype alone picks it.
//
// Replaces the TPU kernels `_fused_short_fwd_kernel` and
// `_fused_short_bwd_kernel` in analytics_zoo_tpu/ops/attention.py
// (pallas_call site `_fused_short_call`). For q, k, v [bh, s, d] (f32,
// contiguous, s <= 512, d <= 128), an optional per-key bias
// key_bias [bh / heads, s] f32 in natural-log units, and an optional
// causal mask, both compute exact softmax attention:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)   f32
//   t[i, j] = -1e30 where causal and j > i
//   p[i, j] = exp2(t[i, j] - max_j t[i, :]) / sum_j exp2(...)     IEEE div
//   pd      = keep ? p / (1 - rate) : 0                            dropout
//   o_i     = sum_j pd[i, j] v_j                                   f32 sums
//
// Scale and log2(e) fold into the f32 score, not into q: the TPU kernel
// pre-scales q and rounds it to q's dtype, which this kernel does not. The
// bias is applied in f32 (the TPU kernel rounds it to bf16 and broadcasts
// it to [bh, s, s], a Mosaic workaround not carried over). Every score is
// one f32 fma chain over d in index order, the same in the forward and both
// backward passes, so the backward recomputes the forward's p bit for bit.
// f32 stays off the tensor cores: TF32 keeps about three digits, and this
// route is held within 2e-5 of its plain version.
//
// Dropout bits: dropout_hash.cuh, read from the seed in device memory (so
// no host sync draws it).
//
// Backward: two passes, no atomics, so it is deterministic.
//   dq pass, one block per (bh, 32 query rows): recompute t and p, dp =
//     dO.v^T through the mask, D = rowsum(dp * p), ds = p * (dp - D),
//     dq = scale * ds.k; the rows' max, denominator and D go to `stats`.
//   dk/dv pass, one block per (bh, 32 keys): walk the queries in tiles of
//     64, recompute p from `stats` and the mask, dv += pd^T.dO and
//     dk += ds^T.q, then dk *= scale.
//
// Bound: at the LM's prefill (bh = 64, s = 128, d = 128, f32, causal) B7
// moves q, k, v and o, 16.8 MB: 0.0050 ms at 3.35 TB/s, against 0.27
// GFLOP (q.k^T and p.v on the causal half), 0.0040 ms at the f32
// CUDA-core rate of 67 TFLOP/s (H100 SXM data sheet, not measurements).
// The kernel is simple: f32 fma from the tiles in shared memory, 32 rows
// to a block, each thread two of them, so a value read from shared memory
// feeds two (or four) fmas.
//
// Shared memory: the forward holds a 32 x (d+1) q tile, a 64 x (d+1)
// k or v tile and the 32 x s block of scores (115 KB at s = 512, d = 128);
// the dq pass adds a dO tile and a second 32 x s block (195 KB, under the
// 227 KB a block may have); the dk/dv pass holds 32-row k and v tiles and
// 64-row q and dO tiles (116 KB). Hence s <= 512 and d <= 128; the caller
// raises on anything else and on non-contiguous inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // threads that share a pair of rows
constexpr int kPairs = kThreads / kGroup;  // 16 pairs of rows
constexpr int kR = 2;       // a thread's rows: p and p + kPairs
constexpr int kRows = kR * kPairs;  // 32 rows per block
constexpr int kKeyTile = 64;  // keys per staged k/v tile (fwd, dq pass)
constexpr int kQTile = kKeyTile;  // queries per staged tile (dk/dv pass)
constexpr int kPer = kKeyTile / kGroup;  // a thread's keys per row per tile
constexpr int kMaxD = 128;
constexpr int kMaxSeq = 512;
// Output columns per row and thread, a template parameter kC: 4 for
// d <= 64, 8 up to kMaxD. The forward and dq pass keep kR x kC accumulators
// a thread, the dk/dv pass twice that: sized to the head, so BERT's 64-wide
// heads do not pay for the registers of 128-wide ones (sized for 128, the
// dk/dv pass took 103 registers a thread and one block fewer on each SM).
constexpr float kNegInf = -1e30f;
constexpr float kFltMax = 3.402823466e38f;  // every score is above -kFltMax
constexpr float kLog2e = 1.4426950408889634f;

// -- shared pieces ---------------------------------------------------------

// dst[r][c] (row stride d + 1) = src[first + r][c] as f32 for first + r <
// limit, else 0; src is the [s, d] slice of one bh
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int first, int rows, int limit,
                                      int d) {
  // thread t copies column t % d of rows t / d, t / d + step, ...: one
  // division per thread, neighbouring threads on neighbouring addresses
  const int step = kThreads / d;  // >= 2, as d <= 128
  const int c = threadIdx.x % d;
  for (int r = threadIdx.x / d; step * d > (int)threadIdx.x && r < rows;
       r += step) {
    const int g = first + r;
    dst[r * (d + 1) + c] =
        g < limit ? src[(long long)g * d + c] : 0.0f;
  }
}

// out[i][j] = a_i . b_j for the rows a_i = a + i * a_stride (i < kR) and
// b_j = b + j * b_stride (j < kPer): each one fma chain over d in index
// order, the one order every pass sums a score or a dO.v in, so the
// backward recomputes the forward's scores bit for bit. A thread reads each
// a_i[x] once for kPer chains and each b_j[x] once for kR.
__device__ __forceinline__ void dots(float (&out)[kR][kPer], const float* a,
                                     int a_stride, const float* b,
                                     int b_stride, int d) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[i][j] = 0.0f;
  for (int x = 0; x < d; ++x) {
    float av[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[i * a_stride + x];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float bv = b[j * b_stride + x];
#pragma unroll
      for (int i = 0; i < kR; ++i) out[i][j] = fmaf(av[i], bv, out[i][j]);
    }
  }
}

// the score in exp2 units: no fma contraction, so the plain version's
// separate multiply and add round alike
__device__ __forceinline__ float score(float qk, float scale_log2e,
                                       const float* bias2, int bias_idx,
                                       int row, int col, int causal) {
  float t = __fmul_rn(qk, scale_log2e);
  if (bias2 != nullptr) t = __fadd_rn(t, bias2[bias_idx]);
  if (causal && col > row) t = kNegInf;
  return t;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// per-key bias in exp2 units for keys [first, first + n) of batch item b
__device__ __forceinline__ void stage_bias(float* bs,
                                           const float* __restrict__ key_bias,
                                           long long b, int first, int n,
                                           int s) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int key = first + c;
    bs[c] = key < s ? __fmul_rn(key_bias[b * s + key], kLog2e) : 0.0f;
  }
}

// x . y_j over every key into w (row stride sp + 1) for the block's rows
// x (row stride d + 1), y staged through ts, keys g, g + kGroup, ... of each
// tile to this thread; with `scores`, t from score(), else the bare dot
__device__ __forceinline__ void block_dots(float* w, int sp1, const float* xs,
                                           float* ts,
                                           const float* __restrict__ ybh,
                                           int s, int d, bool scores,
                                           float scale_log2e,
                                           const float* bs, int row0,
                                           int causal) {
  const int pr = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  float out[kR][kPer];
  for (int k0 = 0; k0 < s; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    stage(ts, ybh, k0, kKeyTile, s, d);
    __syncthreads();
    dots(out, xs + pr * (d + 1), kPairs * (d + 1), ts + g * (d + 1),
         kGroup * (d + 1), d);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = pr + i * kPairs;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = k0 + g + j * kGroup;
        if (col < s)
          w[r * sp1 + col] =
              scores ? score(out[i][j], scale_log2e, bs, col, row0 + r, col,
                             causal)
                     : out[i][j];
      }
    }
  }
}

// acc[i][j] (row p + i * kPairs, column g + j * kGroup) += sum_k w[row][k]
// * x[k][col] over all s keys, x staged through ts
template <int kC>
__device__ __forceinline__ void block_apply(float (&acc)[kR][kC],
                                            const float* ws, int sp1,
                                            float* ts,
                                            const float* __restrict__ xbh,
                                            int s, int d) {
  const int pr = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  for (int k0 = 0; k0 < s; k0 += kKeyTile) {
    __syncthreads();
    stage(ts, xbh, k0, kKeyTile, s, d);
    __syncthreads();
    const int kn = min(kKeyTile, s - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float w[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) w[i] = ws[(pr + i * kPairs) * sp1 + k0 + kk];
      const float* xrow = ts + kk * (d + 1);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = g + j * kGroup;
        if (c < d) {
          const float xv = xrow[c];
#pragma unroll
          for (int i = 0; i < kR; ++i) acc[i][j] = fmaf(w[i], xv, acc[i][j]);
        }
      }
    }
  }
}

// writes acc (times `mul`) to out's rows row0 + p + i * kPairs
template <int kC>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[kR][kC],
                                           float mul, int row0, int s,
                                           int d) {
  const int pr = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = row0 + pr + i * kPairs;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int c = g + j * kGroup;
      if (c < d)
        out[(long long)row * d + c] = __fmul_rn(acc[i][j], mul);
    }
  }
}

// -- B7: forward -----------------------------------------------------------

template <int kC>
__global__ void __launch_bounds__(kThreads)
fused_short_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ key_bias,
                       const int32_t* __restrict__ seed, float* __restrict__ o,
                       int heads, int s, int d, int row_tiles, int sp,
                       float scale_log2e, uint32_t thresh, float inv_keep,
                       int causal) {
  extern __shared__ float smem[];
  const int sp1 = sp + 1;
  float* qs = smem;                      // [kRows][d + 1]
  float* ts = qs + kRows * (d + 1);      // [kKeyTile][d + 1]
  float* ss = ts + kKeyTile * (d + 1);   // [kRows][sp + 1]
  float* bs = ss + kRows * sp1;          // [sp]
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kRows;
  const long long base = bh * s * d;
  const int t = threadIdx.x;

  stage(qs, q + base, row0, kRows, s, d);
  const float* bias2 = nullptr;
  if (key_bias != nullptr) {
    stage_bias(bs, key_bias, bh / heads, 0, s, s);
    bias2 = bs;
  }
  block_dots(ss, sp1, qs, ts, k + base, s, d, true, scale_log2e, bias2, row0,
             causal);
  __syncthreads();

  // softmax and dropout, one warp per row
  const int warp = t / 32, lane = t % 32;
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    if (row >= s) continue;
    float* srow = ss + rr * sp1;
    float m = -kFltMax;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < s; c += 32) {
      const float e = exp2f(srow[c] - m);
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    const uint32_t key = row_key(seed_u, (uint32_t)bh, (uint32_t)row);
    for (int c = lane; c < s; c += 32) {
      float p = srow[c] / l;
      if (seed != nullptr)
        p = kept(key, (uint32_t)c, thresh) ? __fmul_rn(p, inv_keep) : 0.0f;
      srow[c] = p;
    }
  }

  float acc[kR][kC] = {};
  block_apply<kC>(acc, ss, sp1, ts, v + base, s, d);
  store_rows<kC>(o + base, acc, 1.0f, row0, s, d);
}

// -- B8: backward, dq pass -------------------------------------------------

template <int kC>
__global__ void __launch_bounds__(kThreads)
fused_short_bwd_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ key_bias,
                          const int32_t* __restrict__ seed,
                          float* __restrict__ dq, float* __restrict__ stats,
                          long long bh_total, int heads, int s, int d,
                          int row_tiles, int sp, float scale_log2e,
                          float scale, uint32_t thresh, float inv_keep,
                          int causal) {
  extern __shared__ float smem[];
  const int sp1 = sp + 1;
  float* qs = smem;                      // [kRows][d + 1]
  float* dos = qs + kRows * (d + 1);     // [kRows][d + 1]
  float* ts = dos + kRows * (d + 1);     // [kKeyTile][d + 1]
  float* ss = ts + kKeyTile * (d + 1);   // [kRows][sp + 1]: t, then p
  float* ps = ss + kRows * sp1;          // [kRows][sp + 1]: dp, then ds
  float* bs = ps + kRows * sp1;          // [sp]
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kRows;
  const long long base = bh * s * d;
  const int t = threadIdx.x;

  stage(qs, q + base, row0, kRows, s, d);
  stage(dos, dout + base, row0, kRows, s, d);
  const float* bias2 = nullptr;
  if (key_bias != nullptr) {
    stage_bias(bs, key_bias, bh / heads, 0, s, s);
    bias2 = bs;
  }
  block_dots(ss, sp1, qs, ts, k + base, s, d, true, scale_log2e, bias2, row0,
             causal);
  // dp before the mask: dO . v_j, the same fma chain as the dk/dv pass's
  block_dots(ps, sp1, dos, ts, v + base, s, d, false, 0.0f, nullptr, row0,
             0);
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    if (row >= s) continue;
    float* srow = ss + rr * sp1;
    float* prow = ps + rr * sp1;
    float m = -kFltMax;
    for (int c = lane; c < s; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < s; c += 32) {
      const float e = exp2f(srow[c] - m);
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    const uint32_t key = row_key(seed_u, (uint32_t)bh, (uint32_t)row);
    float dsum = 0.0f;
    for (int c = lane; c < s; c += 32) {
      const float p = srow[c] / l;
      float dp = prow[c];
      if (seed != nullptr)
        dp = kept(key, (uint32_t)c, thresh) ? __fmul_rn(dp, inv_keep) : 0.0f;
      srow[c] = p;
      prow[c] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    dsum = warp_sum(dsum);
    for (int c = lane; c < s; c += 32)
      prow[c] = __fmul_rn(srow[c], __fsub_rn(prow[c], dsum));
    if (lane == 0) {
      const long long i = bh * s + row;
      stats[i] = m;
      stats[bh_total * s + i] = l;
      stats[2 * bh_total * s + i] = dsum;
    }
  }

  float acc[kR][kC] = {};
  block_apply<kC>(acc, ps, sp1, ts, k + base, s, d);
  store_rows<kC>(dq + base, acc, scale, row0, s, d);
}

// -- B8: backward, dk/dv pass ----------------------------------------------

template <int kC>
__global__ void __launch_bounds__(kThreads)
fused_short_bwd_dkv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ key_bias,
                           const int32_t* __restrict__ seed,
                           float* __restrict__ dk, float* __restrict__ dv,
                           const float* __restrict__ stats,
                           long long bh_total, int heads, int s, int d,
                           int key_tiles, float scale_log2e, float scale,
                           uint32_t thresh, float inv_keep, int causal) {
  extern __shared__ float smem[];
  constexpr int kW = kQTile + 1;
  float* ks = smem;                      // [kRows][d + 1]
  float* vs = ks + kRows * (d + 1);      // [kRows][d + 1]
  float* qs = vs + kRows * (d + 1);      // [kQTile][d + 1]
  float* dos = qs + kQTile * (d + 1);    // [kQTile][d + 1]
  float* pds = dos + kQTile * (d + 1);   // [kRows][kQTile + 1]
  float* dss = pds + kRows * kW;         // [kRows][kQTile + 1]
  float* mst = dss + kRows * kW;         // [kQTile] x 3: max, denom, D
  float* lst = mst + kQTile;
  float* dst = lst + kQTile;
  float* bs = dst + kQTile;              // [kRows]
  const long long bh = blockIdx.x / key_tiles;
  const int key0 = (int)(blockIdx.x - bh * key_tiles) * kRows;
  const long long base = bh * s * d;
  const int t = threadIdx.x, pr = t / kGroup, g = t % kGroup;

  stage(ks, k + base, key0, kRows, s, d);
  stage(vs, v + base, key0, kRows, s, d);
  const float* bias2 = nullptr;
  if (key_bias != nullptr) {
    stage_bias(bs, key_bias, bh / heads, key0, kRows, s);
    bias2 = bs;
  }
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;

  float acc_k[kR][kC] = {}, acc_v[kR][kC] = {};
  for (int q0 = 0; q0 < s; q0 += kQTile) {
    __syncthreads();  // the previous tile is consumed
    stage(qs, q + base, q0, kQTile, s, d);
    stage(dos, dout + base, q0, kQTile, s, d);
    for (int i = t; i < kQTile; i += kThreads) {
      const int row = q0 + i;
      const long long at = bh * s + row;
      mst[i] = row < s ? stats[at] : 0.0f;
      lst[i] = row < s ? stats[bh_total * s + at] : 1.0f;
      dst[i] = row < s ? stats[2 * bh_total * s + at] : 0.0f;
    }
    __syncthreads();
    // this thread's keys against queries g, g + kGroup, ... of the tile
    float qk[kR][kPer], dpi[kR][kPer];
    dots(qk, ks + pr * (d + 1), kPairs * (d + 1), qs + g * (d + 1),
         kGroup * (d + 1), d);
    dots(dpi, vs + pr * (d + 1), kPairs * (d + 1), dos + g * (d + 1),
         kGroup * (d + 1), d);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int kr = pr + i * kPairs;
      const int key = key0 + kr;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qi = g + j * kGroup;
        const int row = q0 + qi;
        float pd = 0.0f, ds = 0.0f;
        if (row < s && key < s) {
          const float tq = score(qk[i][j], scale_log2e, bias2, kr, row, key,
                                 causal);
          const float p = exp2f(tq - mst[qi]) / lst[qi];
          float dp = dpi[i][j];
          pd = p;
          if (seed != nullptr) {
            const bool keep =
                kept(row_key(seed_u, (uint32_t)bh, (uint32_t)row),
                     (uint32_t)key, thresh);
            pd = keep ? __fmul_rn(p, inv_keep) : 0.0f;
            dp = keep ? __fmul_rn(dp, inv_keep) : 0.0f;
          }
          ds = __fmul_rn(p, __fsub_rn(dp, dst[qi]));
        }
        pds[kr * kW + qi] = pd;
        dss[kr * kW + qi] = ds;
      }
    }
    __syncthreads();
    const int qn = min(kQTile, s - q0);
    for (int qi = 0; qi < qn; ++qi) {
      float a[kR], b[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        a[i] = pds[(pr + i * kPairs) * kW + qi];
        b[i] = dss[(pr + i * kPairs) * kW + qi];
      }
      const float* dorow = dos + qi * (d + 1);
      const float* qrow = qs + qi * (d + 1);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = g + j * kGroup;
        if (c < d) {
          const float dov = dorow[c], qv = qrow[c];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            acc_v[i][j] = fmaf(a[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(b[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }
  store_rows<kC>(dk + base, acc_k, scale, key0, s, d);
  store_rows<kC>(dv + base, acc_v, 1.0f, key0, s, d);
}

// -- launches --------------------------------------------------------------

int padded_seq(int s) { return (s + kKeyTile - 1) / kKeyTile * kKeyTile; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int launch_fwd(const void* q, const void* k, const void* v,
               const void* key_bias, const void* seed, void* o, long long bh,
               int heads, int s, int d, float scale_log2e, uint32_t thresh,
               float inv_keep, int causal, cudaStream_t stream) {
  const int row_tiles = (s + kRows - 1) / kRows;
  const int sp = padded_seq(s);
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kKeyTile) * (d + 1) +
                       (size_t)kRows * (sp + 1) + sp);
  const long long blocks = bh * row_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = d <= 64 ? fused_short_fwd_kernel<4>
                        : fused_short_fwd_kernel<8>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int32_t*>(seed), static_cast<float*>(o), heads, s, d,
      row_tiles, sp, scale_log2e, thresh, inv_keep, causal);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* key_bias, const void* seed, void* dq, void* dk,
               void* dv, void* stats, long long bh, int heads, int s, int d,
               float scale_log2e, float scale, uint32_t thresh,
               float inv_keep, int causal, cudaStream_t stream) {
  const int row_tiles = (s + kRows - 1) / kRows;
  const int sp = padded_seq(s);
  const size_t smem_dq =
      sizeof(float) * ((size_t)(2 * kRows + kKeyTile) * (d + 1) +
                       2 * (size_t)kRows * (sp + 1) + sp);
  const size_t smem_dkv =
      sizeof(float) * ((size_t)(2 * kRows + 2 * kQTile) * (d + 1) +
                       2 * (size_t)kRows * (kQTile + 1) + 3 * kQTile + kRows);
  const long long blocks = bh * row_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto dq_kernel = d <= 64 ? fused_short_bwd_dq_kernel<4>
                           : fused_short_bwd_dq_kernel<8>;
  auto dkv_kernel = d <= 64 ? fused_short_bwd_dkv_kernel<4>
                            : fused_short_bwd_dkv_kernel<8>;
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot_ = static_cast<const float*>(dout);
  const float* kb = static_cast<const float*>(key_bias);
  const int32_t* sd = static_cast<const int32_t*>(seed);
  float* st = static_cast<float*>(stats);
  dq_kernel<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot_, kb, sd, static_cast<float*>(dq), st, bh, heads, s, d,
      row_tiles, sp, scale_log2e, scale, thresh, inv_keep, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // key tiles are 32 rows, like the dq pass's query tiles
  dkv_kernel<<<(unsigned)blocks, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot_, kb, sd, static_cast<float*>(dk),
      static_cast<float*>(dv), st, bh, heads, s, d, row_tiles, scale_log2e,
      scale, thresh, inv_keep, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(long long bh, int heads, int s, int d) {
  return bh < 0 || heads < 1 || s < 1 || s > kMaxSeq || d < 1 || d > kMaxD;
}

}  // namespace

extern "C" {

// B7, f32 route, on `stream`; returns cudaGetLastError() (0 on success).
// q, k, v, o: [bh, s, d] f32. key_bias: [bh / heads, s] f32 or NULL. seed:
// one int32 on the device, or NULL for no dropout (then thresh and
// inv_keep are unused). The caller allocates o.
int azt_fused_short_fwd_f32(const void* q, const void* k, const void* v,
                            const void* key_bias, const void* seed, void* o,
                            long long bh, int heads, int s, int d,
                            float scale_log2e, unsigned int thresh,
                            float inv_keep, int causal, void* stream) {
  if (bad_shape(bh, heads, s, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return launch_fwd(q, k, v, key_bias, seed, o, bh, heads, s, d,
                    scale_log2e, thresh, inv_keep, causal,
                    static_cast<cudaStream_t>(stream));
}

// B8, f32 route, on `stream`: the dq pass, then the dk/dv pass; returns
// cudaGetLastError(). dout, dq, dk, dv: [bh, s, d] f32; stats: [3, bh, s]
// f32 scratch. The caller allocates the outputs and stats.
int azt_fused_short_bwd_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* key_bias,
                            const void* seed, void* dq, void* dk, void* dv,
                            void* stats, long long bh, int heads, int s,
                            int d, float scale_log2e, float scale,
                            unsigned int thresh, float inv_keep, int causal,
                            void* stream) {
  if (bad_shape(bh, heads, s, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return launch_bwd(q, k, v, dout, key_bias, seed, dq, dk, dv, stats, bh,
                    heads, s, d, scale_log2e, scale, thresh, inv_keep,
                    causal, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
