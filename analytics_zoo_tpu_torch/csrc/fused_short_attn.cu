// Fused short-sequence attention, forward (B7) and backward (B8), f32
// route, on the tensor cores of Hopper (sm_90a) as 3xTF32. bf16 inputs
// take fused_short_attn_bf16.cu; the dtype alone picks the route. The
// fragment and tile helpers are mma_tf32.cuh's.
//
// Replaces the TPU kernels `_fused_short_fwd_kernel` (:716) and
// `_fused_short_bwd_kernel` (:761) of analytics_zoo_tpu/ops/attention.py
// (pallas_call sites :870, :877). For q, k, v [bh, s, d] (f32, contiguous,
// s <= 512, d <= 256), an optional per-key bias key_bias [bh / heads, s]
// f32 in natural-log units, and an optional causal mask, both compute
// exact softmax attention:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)   f32
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past s
//   p[i, j] = exp2(t[i, j] - m_i) / l_i,  m_i = max_j t, l_i = sum_j exp2
//   pd      = keep ? p / (1 - rate) : 0        (dropout_hash.cuh's mask)
//   o_i     = sum_j pd[i, j] v_j                f32 sums
//
// Every product (q.k^T, p.v; in the backward also dO.v^T, ds.k, k.q^T,
// v.dO^T, pd^T.dO, ds^T.q) runs as mma.sync m16n8k8 3xTF32 with f32
// accumulators: each f32 operand is split into two TF32 parts at fragment
// load, not in shared memory, so the f32 tiles keep their size, and three
// TF32 products give f32 accuracy (mma_tf32.cuh). Scale and log2(e) fold
// into the f32 score, not into q: the TPU kernel pre-scales q and rounds it
// to q's dtype, which this kernel does not; the bias is added in f32 (the
// TPU kernel rounds it to bf16). The scores never leave registers.
//
// Blocks: each owns 64 rows (queries; keys in the dk/dv pass) in four
// groups of 16 and walks the other side in tiles held in shared memory,
// one buffer refilled by 16-byte cp.async after each tile. A row group has
// one warp walking 32-row tiles, or, for a grid under eight blocks an SM,
// two warps walking 64-row tiles, 32 rows each (B7 under two blocks an SM:
// four warps, 128-row tiles), merged at the end (split_for): more warps a
// block where the grid is too small to fill the card.
//
// Forward: an online softmax over the key tiles (running max and sum, the
// accumulator rescaled per tile), so no [rows, s] block is kept. Each
// accumulator element's (row, col) decides the bias, the causal mask, the
// keys past s and the dropout bits in registers; the max and sum reduce
// over a quad. p feeds p.V as an A fragment from registers (the permuted
// reduction order of mma_tf32.cuh). Under the causal mask a block walks
// only the tiles at or below its last row, and a warp skips keys that all
// lie past its rows. It writes each row's max (exp2 units) and sum to
// `stats`, as the bf16 route does.
//
// Backward: two passes, no atomics, so it is deterministic; p comes from
// the forward's max and sum, D = rowsum(dp * p) from the forward's output
// as rowsum(dO * o) (equal in exact arithmetic, dropout included; in f32
// o keeps the digits that bf16 rounding took from the bf16 route).
//   dq pass, a block per (bh, 64 query rows): D for its rows, written to
//     `delta`; then per key tile S = Q.K^T, p, dP = dO.V^T through the
//     mask, ds = p * (dP - D), dq += ds.K; dq *= scale.
//   dk/dv pass, a block per (bh, 64 keys): per query tile S^T = K.Q^T and
//     p^T, dP^T = V.dO^T, dv += pd^T.dO, dk += ds^T.Q; dk *= scale. Under
//     the causal mask it starts at the tile of its first key. Past d 128
//     it walks the queries twice, once for each 128-wide half of dk's and
//     dv's columns (S^T and dP^T again over all of d): both whole would be
//     256 accumulators a thread.
// S^T on the tensor cores is not S bit for bit: the two passes' p differ
// by rounding, within the route's 2e-5 of the output's scale.
//
// Ragged shapes: rows and keys past s load as zeros (cp.async's zero
// fill) and are neither stored nor counted; d is zero-padded in shared
// memory to a multiple of 8, and the register tiles are sized for d <= 32,
// 64, 128 or 256. 16-byte copies where d % 4 == 0 and q, k, v, dO are 16-byte
// aligned, else element by element.
//
// Bound (H100 SXM data sheet, not measurements): at the LM's prefill (bh
// 64, s 128, d 128, causal) B7 moves q, k, v and o, 16.8 MB: 0.0050 ms at
// 3.35 TB/s, against 0.27 GFLOP, 0.0016 ms at 3xTF32's 164.9 TFLOP/s
// (494.7 / 3); B8 moves 29.4 MB, 0.0088 ms, against 0.68 GFLOP, 0.0041
// ms. At BERT-base's shape (bh 1536, s 128, d 64) B7 is 0.060 ms of bytes
// against 0.039 of operations, B8 0.105 against 0.098. The row statistics
// and D this design passes between kernels are its own bytes, not the
// function's.
//
// Shared memory a block, with a row stride of 8 * kD + 4 floats, for one
// warp (two; four) a row group at d 128: the forward holds Q, a K and a V
// tile and the bias, 70 KiB (103; 170); the dq pass Q, dO, K, V, the bias
// and D, 101 KiB (137); the dk/dv pass K, V, Q, dO and every query's
// statistics, 107 KiB (141). At d 64 about half. At d 256 the rows are
// 1040 bytes, so B7 takes at most two warps a row group (197 KiB) and B8
// one (195 and 201 KiB at s 512). Registers: `nvcc -Xptxas -v`
// (chip_smoke.py's build line, PERF.md).
//
// The TPU kernel ran one program per bh (or a few) holding the whole
// [s, s] block in VMEM and emitted dq, dk and dv from one backward
// program. Here blocks run in parallel with no order, so no block can
// carry a sum into another: the backward is two passes, each owning its
// outputs, and the softmax is online over key tiles that fit in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "mma_tf32.cuh"

namespace {

// The walk is mma_tf32.cuh's (kRows own rows, kSplit warps a row group,
// walked tiles of kSplit * kPart rows), with one buffer of walked tiles
// refilled after each tile (two buffers fit half the blocks an SM at d 128:
// 22-33% slower at s 512, 2-3% faster elsewhere).
constexpr int kMaxD = 256;
// 8-column chunks of dk and dv one walk of the dk/dv pass holds
constexpr int kOutChunks = 16;
constexpr int kMaxSeq = 512;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the score in exp2 units: no fma contraction, so the plain version's
// separate multiply and add round alike
__device__ __forceinline__ float score(float qk, float scale_log2e,
                                       const float* bias2, int row, int col,
                                       int s, int causal) {
  if (col >= s) return -INFINITY;
  float x = __fmul_rn(qk, scale_log2e);
  if (bias2 != nullptr) x = __fadd_rn(x, bias2[col]);
  if (causal && col > row) x = kNegInf;
  return x;
}

// bias * log2(e) for the s keys of batch item b into bs (NULL if none)
__device__ __forceinline__ const float* stage_bias(
    float* bs, const float* __restrict__ key_bias, long long b, int s) {
  if (key_bias == nullptr) return nullptr;
  for (int c = threadIdx.x; c < s; c += blockDim.x)
    bs[c] = __fmul_rn(key_bias[b * s + c], kLog2e);
  return bs;
}

// dP (dP^T) += a . b over one 8-column step of d: past d 128 in two
// levels (mma3_add), since a reduction over 256 columns straight into dP
// drifts past the route's 2e-5 where ds = p (dP - D) cancels (one key:
// 2.9e-5 of scale on the H100); at the narrower widths as before
template <int kD>
__device__ __forceinline__ void dp_add(float (&c)[4], const FragA& a,
                                       const FragB& b) {
  if constexpr (kD > 16)
    mma3_add(c, a, b);
  else
    mma3(c, a, b);
}

// the key tiles the forward and the dq pass walk: all of them, or under the
// causal mask those at or below the block's last row
template <int kTile>
__device__ __forceinline__ int key_tiles(int row0, int s, int causal) {
  const int n = (s + kTile - 1) / kTile;
  return causal ? min(n, (row0 + kRows - 1) / kTile + 1) : n;
}

// walked tile `tile` of x and y (K and V, or Q and dO) into xs and ys, as
// one cp.async group
template <int kD, int kSplit>
__device__ __forceinline__ void load_walked(float* xs, float* ys,
                                            const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            int ld, int tile, int s, int d,
                                            bool vec) {
  constexpr int kTile = kSplit * kPart, kThreads = kSplit * 128;
  load_tile_f32<kTile, kThreads, kD>(xs, ld, x, tile * kTile, s, d, vec);
  load_tile_f32<kTile, kThreads, kD>(ys, ld, y, tile * kTile, s, d, vec);
  cp_commit();
}

// -- B7: forward -----------------------------------------------------------

template <int kD, int kSplit>
__global__ void __launch_bounds__(kSplit * 128)
fused_short_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ key_bias,
                       const int32_t* __restrict__ seed,
                       float* __restrict__ o, float* __restrict__ stats,
                       long long bh_total, int heads, int s, int d,
                       int row_tiles, float scale_log2e, uint32_t thresh,
                       float inv_keep, int causal, int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kPart / 8;  // 8-key steps of a warp's part
  constexpr int kTile = kSplit * kPart, kThreads = kSplit * 128;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [kRows][ld]
  float* ks = qs + kRows * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* bs = vs + kTile * ld;   // [s]
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kRows;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, h = warp / 4;  // row group, part
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  const int n_tiles = key_tiles<kTile>(row0, s, causal);

  if (vec) zero_pad_cols_f32<kThreads>(qs, kRows + 2 * kTile, ld, d);
  load_tile_f32<kRows, kThreads, kD>(qs, ld, q + base, row0, s, d, vec);
  load_walked<kD, kSplit>(ks, vs, k + base, v + base, ld, 0, s, d, vec);
  const float* bias2 = stage_bias(bs, key_bias, bh / heads, s);

  const float* qw = qs + rg * 16 * ld;
  const int rows[2] = {row0 + rg * 16 + g, row0 + rg * 16 + g + 8};
  const int last_row = row0 + rg * 16 + 15;
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t rkey[2] = {row_key(seed_u, (uint32_t)bh, rows[0]),
                            row_key(seed_u, (uint32_t)bh, rows[1])};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();
    const float* kst = ks + h * kPart * ld;
    const float* vst = vs + h * kPart * ld;
    const int key0 = kt * kTile + h * kPart;  // the warp's first key

    // the first part of tile 0 is never skipped, so there m is finite from
    // the first tile on
    if (key0 < s && !(causal && key0 > last_row)) {
      float sc[kN][4] = {};
#pragma unroll
      for (int kc = 0; kc < kD; ++kc) {
        if (kc < kd) {
          FragA a;
          load_a(a, qw, ld, kc);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            FragB b;
            load_bt(b, kst + n * 8 * ld, ld, kc);
            mma3(sc[n], a, b);
          }
        }
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = score(sc[n][e], scale_log2e, bias2, rows[e / 2],
                           key0 + n * 8 + 2 * t + (e & 1), s, causal);
          tmax[e / 2] = fmaxf(tmax[e / 2], sc[n][e]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // a walked part holds a key below s: its max is finite
        const float m_new = fmaxf(m[i], quad_max(tmax[i]));
        const float corr = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int n = 0; n < kD; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[n][e] - m[e / 2]);
          l[e / 2] += p;
          if (seed != nullptr)
            p = kept(rkey[e / 2], key0 + n * 8 + 2 * t + (e & 1), thresh)
                    ? __fmul_rn(p, inv_keep)
                    : 0.0f;
          sc[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (key0 + n * 8 < s) {
          FragA a;
          c_to_a(a, sc[n]);
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            if (j < kd) {
              FragB b;
              load_b(b, vst + n * 8 * ld, ld, j);
              mma3(acc[j], a, b);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
    if (kt + 1 < n_tiles)
      load_walked<kD, kSplit>(ks, vs, k + base, v + base, ld, kt + 1, s, d,
                              vec);
  }

  // the row group's other warps hand their max, sum and accumulator to
  // the first in turn, through the consumed K/V tiles: m = max(m0, m1), c
  // = exp2(m_w - m), l = l0 c0 + l1 c1, acc = acc0 c0 + acc1 c1 (a warp
  // that saw no key has m -inf)
  float* xch = ks;
  for (int from = 1; from < kSplit; ++from) {
    if (h == from) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xch[xch_at(i)] = m[i];
        xch[xch_at(2 + i)] = l[i];
      }
#pragma unroll
      for (int n = 0; n < kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[xch_at(4 + 4 * n + e)] = acc[n][e];
    }
    __syncthreads();
    if (h == 0) {
      float c0[2], c1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = xch[xch_at(i)];
        const float mm = fmaxf(m[i], m1);
        c0[i] = exp2f(m[i] - mm);
        c1[i] = exp2f(m1 - mm);
        m[i] = mm;
        l[i] = l[i] * c0[i] + xch[xch_at(2 + i)] * c1[i];
      }
#pragma unroll
      for (int n = 0; n < kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * c0[e / 2] +
                      xch[xch_at(4 + 4 * n + e)] * c1[e / 2];
    }
    __syncthreads();  // read before the next warp writes
  }
  if (h != 0) return;

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int n = 0; n < kD; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_acc<kD>(o + base, acc, 1.0f, row0 + rg * 16, s, d);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < s) {
        stats[bh * s + rows[i]] = m[i];
        stats[bh_total * s + bh * s + rows[i]] = l[i];
      }
  }
}

// -- B8: backward, dq pass -------------------------------------------------

template <int kD, int kSplit>
__global__ void __launch_bounds__(kSplit * 128)
fused_short_bwd_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ key_bias,
                          const int32_t* __restrict__ seed,
                          const float* __restrict__ stats,
                          float* __restrict__ delta, float* __restrict__ dq,
                          long long bh_total, int heads, int s, int d,
                          int row_tiles, float scale_log2e, float scale,
                          uint32_t thresh, float inv_keep, int causal,
                          int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kPart / 8;
  constexpr int kTile = kSplit * kPart, kThreads = kSplit * 128;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kRows][ld]
  float* dos = qs + kRows * ld;      // [kRows][ld]
  float* ks = dos + kRows * ld;      // [kTile][ld]
  float* vs = ks + kTile * ld;       // [kTile][ld]
  float* bs = vs + kTile * ld;       // [s]
  float* ds = bs + (s + 3) / 4 * 4;  // [kRows]: D
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kRows;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, h = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  const int n_tiles = key_tiles<kTile>(row0, s, causal);

  if (vec) zero_pad_cols_f32<kThreads>(qs, 2 * kRows + 2 * kTile, ld, d);
  load_tile_f32<kRows, kThreads, kD>(qs, ld, q + base, row0, s, d, vec);
  load_tile_f32<kRows, kThreads, kD>(dos, ld, dout + base, row0, s, d, vec);
  load_walked<kD, kSplit>(ks, vs, k + base, v + base, ld, 0, s, d, vec);
  const float* bias2 = stage_bias(bs, key_bias, bh / heads, s);

  // D = rowsum(dO * o), each row a warp's sum over the columns; a row
  // group's 16 rows split over its kSplit warps
  constexpr int kDRows = 16 / kSplit;
  for (int r = 0; r < kDRows; ++r) {
    const int i = rg * 16 + h * kDRows + r, row = row0 + i;
    float x = 0.0f;
    if (row < s)
      for (int c = lane; c < d; c += 32)
        x = fmaf(dout[base + (long long)row * d + c],
                 o[base + (long long)row * d + c], x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(~0u, x, off);
    if (lane == 0) {
      ds[i] = x;
      if (row < s) delta[bh * s + row] = x;
    }
  }
  __syncthreads();

  const int rows[2] = {row0 + rg * 16 + g, row0 + rg * 16 + g + 8};
  const int last_row = row0 + rg * 16 + 15;
  float mrow[2], inv_l[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < s;  // rows past s get p = 0
    mrow[i] = in ? stats[bh * s + rows[i]] : INFINITY;
    inv_l[i] = in ? 1.0f / stats[bh_total * s + bh * s + rows[i]] : 0.0f;
    dd[i] = ds[rows[i] - row0];
  }
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t rkey[2] = {row_key(seed_u, (uint32_t)bh, rows[0]),
                            row_key(seed_u, (uint32_t)bh, rows[1])};
  const float* qw = qs + rg * 16 * ld;
  const float* dow = dos + rg * 16 * ld;
  float acc[kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();
    const float* kst = ks + h * kPart * ld;
    const float* vst = vs + h * kPart * ld;
    const int key0 = kt * kTile + h * kPart;

    if (key0 < s && !(causal && key0 > last_row)) {
      float sc[kN][4] = {}, dp[kN][4] = {};
#pragma unroll
      for (int kc = 0; kc < kD; ++kc) {
        if (kc < kd) {
          FragA a, ad;
          load_a(a, qw, ld, kc);
          load_a(ad, dow, ld, kc);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            FragB b;
            load_bt(b, kst + n * 8 * ld, ld, kc);
            mma3(sc[n], a, b);
            load_bt(b, vst + n * 8 * ld, ld, kc);
            dp_add<kD>(dp[n], ad, b);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = key0 + n * 8 + 2 * t + (e & 1);
          const float x =
              score(sc[n][e], scale_log2e, bias2, rows[r], col, s, causal);
          const float p = exp2f(x - mrow[r]) * inv_l[r];
          float dpv = dp[n][e];
          if (seed != nullptr)
            dpv = kept(rkey[r], col, thresh) ? __fmul_rn(dpv, inv_keep)
                                             : 0.0f;
          sc[n][e] = __fmul_rn(p, __fsub_rn(dpv, dd[r]));  // ds
        }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (key0 + n * 8 < s) {
          FragA a;
          c_to_a(a, sc[n]);
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            if (j < kd) {
              FragB b;
              load_b(b, kst + n * 8 * ld, ld, j);
              mma3(acc[j], a, b);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
    if (kt + 1 < n_tiles)
      load_walked<kD, kSplit>(ks, vs, k + base, v + base, ld, kt + 1, s, d,
                              vec);
  }
  if (merge_into_first<kD, kSplit>(ks, acc, h))
    store_acc<kD>(dq + base, acc, scale, row0 + rg * 16, s, d);
}

// -- B8: backward, dk/dv pass ----------------------------------------------

template <int kD, int kSplit>
__global__ void __launch_bounds__(kSplit * 128)
fused_short_bwd_dkv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ key_bias,
                           const int32_t* __restrict__ seed,
                           const float* __restrict__ stats,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           long long bh_total, int heads, int s, int d,
                           int key_blocks, float scale_log2e, float scale,
                           uint32_t thresh, float inv_keep, int causal,
                           int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kPart / 8;
  constexpr int kTile = kSplit * kPart, kThreads = kSplit * 128;
  // dk's and dv's columns a walk holds: all of d up to 128, else a half
  constexpr int kDo = kD < kOutChunks ? kD : kOutChunks;
  constexpr int kPasses = kD / kDo;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [kRows][ld]
  float* vs = ks + kRows * ld;    // [kRows][ld]
  float* qs = vs + kRows * ld;    // [kTile][ld]
  float* dos = qs + kTile * ld;   // [kTile][ld]
  const int n_tiles = (s + kTile - 1) / kTile;
  const int sp = n_tiles * kTile;
  float* mst = dos + kTile * ld;  // [sp]
  float* ilst = mst + sp;         // [sp]
  float* dst = ilst + sp;         // [sp]
  const long long bh = blockIdx.x / key_blocks;
  const int key0 = (int)(blockIdx.x - bh * key_blocks) * kRows;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, h = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  // under the causal mask, queries before the block's first key see none
  // of its keys
  const int first = causal ? key0 / kTile : 0;

  if (vec) zero_pad_cols_f32<kThreads>(ks, 2 * kRows + 2 * kTile, ld, d);
  load_tile_f32<kRows, kThreads, kD>(ks, ld, k + base, key0, s, d, vec);
  load_tile_f32<kRows, kThreads, kD>(vs, ld, v + base, key0, s, d, vec);
  load_walked<kD, kSplit>(qs, dos, q + base, dout + base, ld, first, s, d,
                          vec);
  // every query's max, 1 / sum and D; queries past s get p = 0
  for (int i = threadIdx.x; i < sp; i += kThreads) {
    const bool in = i < s;
    mst[i] = in ? stats[bh * s + i] : INFINITY;
    ilst[i] = in ? 1.0f / stats[bh_total * s + bh * s + i] : 0.0f;
    dst[i] = in ? delta[bh * s + i] : 0.0f;
  }

  const int keys[2] = {key0 + rg * 16 + g, key0 + rg * 16 + g + 8};
  const int first_key = key0 + rg * 16;
  float kb[2] = {0.0f, 0.0f};
  if (key_bias != nullptr)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (keys[i] < s)
        kb[i] = __fmul_rn(key_bias[(bh / heads) * s + keys[i]], kLog2e);
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t bh_key = mix(seed_u, (uint32_t)bh);  // row_key = mix(., row)
  const float* kw = ks + rg * 16 * ld;
  const float* vw = vs + rg * 16 * ld;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int c0 = pass * kDo;  // the pass's first chunk of dk and dv
    if (pass > 0)  // the last walk's tiles are consumed (and merged)
      load_walked<kD, kSplit>(qs, dos, q + base, dout + base, ld, first, s,
                              d, vec);
    float acc_k[kDo][4] = {}, acc_v[kDo][4] = {};

    for (int qt = first; qt < n_tiles; ++qt) {
      cp_wait<0>();
      __syncthreads();
      const float* qst = qs + h * kPart * ld;
      const float* dost = dos + h * kPart * ld;
      const int qf = qt * kTile + h * kPart;  // the warp's first query

      // a warp whose keys all lie past its queries sees none of them
      if (qf < s && !(causal && qf + kPart - 1 < first_key)) {
        float st[kN][4] = {}, dpt[kN][4] = {};  // S^T, dP^T: keys x queries
#pragma unroll
        for (int kc = 0; kc < kD; ++kc) {
          if (kc < kd) {
            FragA a, av;
            load_a(a, kw, ld, kc);
            load_a(av, vw, ld, kc);
#pragma unroll
            for (int n = 0; n < kN; ++n) {
              FragB b;
              load_bt(b, qst + n * 8 * ld, ld, kc);
              mma3(st[n], a, b);
              load_bt(b, dost + n * 8 * ld, ld, kc);
              dp_add<kD>(dpt[n], av, b);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int query = qf + n * 8 + 2 * t + e;
            const float mq = mst[query], ilq = ilst[query], dd = dst[query];
            const uint32_t qkey = mix(bh_key, (uint32_t)query);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int idx = 2 * i + e;
              float x = __fmul_rn(st[n][idx], scale_log2e);
              if (key_bias != nullptr) x = __fadd_rn(x, kb[i]);
              if (causal && keys[i] > query) x = kNegInf;
              const float p = exp2f(x - mq) * ilq;
              float pd = p, dpv = dpt[n][idx];
              if (seed != nullptr) {
                const bool keep = kept(qkey, (uint32_t)keys[i], thresh);
                pd = keep ? __fmul_rn(p, inv_keep) : 0.0f;
                dpv = keep ? __fmul_rn(dpv, inv_keep) : 0.0f;
              }
              st[n][idx] = pd;
              dpt[n][idx] = __fmul_rn(p, __fsub_rn(dpv, dd));  // ds
            }
          }
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          if (qf + n * 8 < s) {
            FragA a, ads;
            c_to_a(a, st[n]);
            c_to_a(ads, dpt[n]);
#pragma unroll
            for (int j = 0; j < kDo; ++j) {
              if (c0 + j < kd) {
                FragB b;
                load_b(b, dost + n * 8 * ld, ld, c0 + j);
                mma3(acc_v[j], a, b);
                load_b(b, qst + n * 8 * ld, ld, c0 + j);
                mma3(acc_k[j], ads, b);
              }
            }
          }
        }
      }
      __syncthreads();  // the tile is consumed before it is refilled
      if (qt + 1 < n_tiles)
        load_walked<kD, kSplit>(qs, dos, q + base, dout + base, ld, qt + 1, s,
                                d, vec);
    }
    // dk through the consumed Q tile, dv through the dO tile
    const bool holds_sum = merge_into_first<kDo, kSplit>(qs, acc_k, h);
    merge_into_first<kDo, kSplit>(dos, acc_v, h);
    if (holds_sum) {
      store_acc<kDo>(dk + base, acc_k, scale, key0 + rg * 16, s, d, 8 * c0);
      store_acc<kDo>(dv + base, acc_v, 1.0f, key0 + rg * 16, s, d, 8 * c0);
    }
  }
}

// -- launches --------------------------------------------------------------

template <int kD, int kSplit>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* key_bias, const void* seed, void* o, void* stats,
               long long bh, int heads, int s, int d, float scale_log2e,
               uint32_t thresh, float inv_keep, int causal,
               cudaStream_t stream) {
  constexpr int kTile = kSplit * kPart;
  const int row_tiles = (s + kRows - 1) / kRows;
  const int sp = (s + kTile - 1) / kTile * kTile;
  const size_t smem = tile_bytes(kD, kRows) + 2 * tile_bytes(kD, kTile) +
                      sizeof(float) * sp;
  const int vec = d % 4 == 0 && aligned16({q, k, v});
  auto kernel = fused_short_fwd_kernel<kD, kSplit>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(bh * row_tiles), kSplit * 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int32_t*>(seed), static_cast<float*>(o),
      static_cast<float*>(stats), bh, heads, s, d, row_tiles, scale_log2e,
      thresh, inv_keep, causal, vec);
  return (int)cudaGetLastError();
}

template <int kD, int kSplit>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* key_bias, const void* seed,
               const void* stats, void* delta, void* dq, void* dk, void* dv,
               long long bh, int heads, int s, int d, float scale_log2e,
               float scale, uint32_t thresh, float inv_keep, int causal,
               cudaStream_t stream) {
  constexpr int kTile = kSplit * kPart;
  const int tiles = (s + kRows - 1) / kRows;
  const int sp = (s + kTile - 1) / kTile * kTile;
  const size_t own = 2 * tile_bytes(kD, kRows) + 2 * tile_bytes(kD, kTile);
  const size_t smem_dq = own + sizeof(float) * (sp + kRows);
  const size_t smem_dkv = own + sizeof(float) * 3 * sp;
  const int vec = d % 4 == 0 && aligned16({q, k, v, dout});
  auto dq_kernel = fused_short_bwd_dq_kernel<kD, kSplit>;
  auto dkv_kernel = fused_short_bwd_dkv_kernel<kD, kSplit>;
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
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  const unsigned blocks = (unsigned)(bh * tiles);
  dq_kernel<<<blocks, kSplit * 128, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dot_, kb, sd, st, dl,
      static_cast<float*>(dq), bh, heads, s, d, tiles, scale_log2e, scale,
      thresh, inv_keep, causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<blocks, kSplit * 128, smem_dkv, stream>>>(
      qt, kt, vt, dot_, kb, sd, st, dl, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, heads, s, d, tiles, scale_log2e, scale,
      thresh, inv_keep, causal, vec);
  return (int)cudaGetLastError();
}

template <int kD, int kSplit>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) {
    return launch_fwd<kD, kSplit>(args...);
  }
};

template <int kD, int kSplit>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) {
    return launch_bwd<kD, kSplit>(args...);
  }
};

bool bad_shape(long long bh, int heads, int s, int d) {
  return bh < 0 || heads < 1 || s < 1 || s > kMaxSeq || d < 1 || d > kMaxD;
}

}  // namespace

extern "C" {

// B7, f32 route, on `stream`; returns cudaGetLastError() (0 on success).
// q, k, v, o: [bh, s, d] f32. key_bias: [bh / heads, s] f32 or NULL. seed:
// one int32 on the device, or NULL for no dropout (then thresh and
// inv_keep are unused). stats: [2, bh, s] f32, each row's max in exp2
// units, then its sum. The caller allocates o and stats.
int azt_fused_short_fwd_f32(const void* q, const void* k, const void* v,
                            const void* key_bias, const void* seed, void* o,
                            void* stats, long long bh, int heads, int s,
                            int d, float scale_log2e, unsigned int thresh,
                            float inv_keep, int causal, void* stream) {
  if (bad_shape(bh, heads, s, d) || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return dispatch<Fwd, 4>(bh * ((s + kRows - 1) / kRows), d, q, k, v,
                          key_bias, seed, o, stats, bh, heads, s, d,
                          scale_log2e, thresh, inv_keep, causal,
                          static_cast<cudaStream_t>(stream));
}

// B8, f32 route, on `stream`: the dq pass, then the dk/dv pass; returns
// cudaGetLastError(). o and stats: the forward's output and [2, bh, s] row
// statistics; dout, dq, dk, dv: [bh, s, d] f32; delta: [bh, s] f32
// scratch. The caller allocates the outputs and delta.
int azt_fused_short_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const void* key_bias, const void* seed,
                            const void* stats, void* delta, void* dq,
                            void* dk, void* dv, long long bh, int heads,
                            int s, int d, float scale_log2e, float scale,
                            unsigned int thresh, float inv_keep, int causal,
                            void* stream) {
  if (bad_shape(bh, heads, s, d) || stats == nullptr || o == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return dispatch<Bwd, 2>(bh * ((s + kRows - 1) / kRows), d, q, k, v, o,
                          dout, key_bias, seed, stats, delta, dq, dk, dv, bh,
                          heads, s, d, scale_log2e, scale, thresh, inv_keep,
                          causal, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
