// Fused short-sequence attention, forward (B7) and backward (B8), bf16
// route, on the tensor cores of Hopper (sm_90a). f32 inputs take the
// CUDA-core route in fused_short_attn.cu; the dtype alone picks it. The
// fragment and tile helpers are mma_bf16.cuh's, shared with the flash
// kernels' bf16 route (flash_attn_bf16.cu).
//
// Replaces the TPU kernels `_fused_short_fwd_kernel` (:716) and
// `_fused_short_bwd_kernel` (:761) of analytics_zoo_tpu/ops/attention.py.
// For q, k, v [bh, s, d] bf16 (contiguous, s <= 512, d <= 256), an
// optional per-key bias key_bias [bh / heads, s] f32 in natural-log units,
// an optional causal mask and dropout, it computes what the f32 route does:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)   f32
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past s
//   p[i, j] = exp2(t[i, j] - m_i) / l_i,  m_i = max_j t, l_i = sum_j exp2
//   pd      = keep ? p / (1 - rate) : 0        (dropout_hash.cuh's mask)
//   o_i     = sum_j bf16(pd[i, j]) v_j          f32 sums
//
// and rounds to bf16 where the TPU kernel does: pd before p.v and before
// pd^T.dO, ds before ds.k and ds^T.q. The products run as
// mma.sync.m16n8k16 bf16 -> f32 with operands from shared memory through
// ldmatrix (.trans for the operand whose rows are the reduction); the
// scores never leave registers.
//
// Forward: one block per (bh, 64 query rows), four warps, each owning 16
// rows. It walks the keys in tiles of 64, K and V double-buffered by
// 16-byte cp.async, with an online softmax (running max and sum, the
// accumulator rescaled per tile), so s = 512 needs no [rows, s] block. The
// fragment layout gives each accumulator element its (row, col), from
// which the bias, the causal mask, the keys past s and the dropout bits
// are decided in registers; the max and sum reduce over the four threads
// of a quad. p becomes the A operand of p.V in registers. o = acc / l at
// the end. It writes each row's max (exp2 units) and sum to `stats` for
// the backward: not one log-sum-exp, because a row whose keys the
// padding bias masks entirely has its max near -1.44e9, where f32's
// spacing is 128 and m + log2(l) rounds back to m.
//
// Backward: two passes, no atomics, so it is deterministic; p comes from
// the forward's max and sum.
//   dq pass, one block per (bh, 64 query rows), two sweeps over the key
//     tiles: first D = rowsum(dp * p) in f32 (S = Q.K^T, p, dP = dO.V^T
//     through the mask), written to `delta`; then S, p and dP again, ds =
//     p * (dP - D), dq += bf16(ds).K; dq *= scale. D from the output,
//     rowsum(dO * o), would save the first sweep, but o is rounded to bf16,
//     a rounding the TPU kernel does not have: with one key, where ds is 0,
//     it left dq 0.03 off.
//   dk/dv pass, one block per (bh, 64 keys): per query tile, S^T = K.Q^T
//     and p^T, dP^T = V.dO^T, dv += bf16(pd)^T.dO, dk += bf16(ds)^T.Q;
//     dk *= scale. Past d 128 a warp's dk and dv would hold 256 floats a
//     thread, so the pass walks the queries twice, once for each 128-wide
//     half of the columns (S^T and dP^T computed again over all of d), and
//     stores each half from registers.
//
// Ragged shapes: rows and keys past s load as zeros (cp.async's zero
// fill) and are neither stored nor counted; d is zero-padded in shared
// memory to a multiple of 16, and the register tiles are sized for d <= 32,
// 64, 128 or 256. 16-byte copies where d % 8 == 0 and every pointer is
// 16-byte aligned, else element by element.
//
// Bound at BERT-base's shape (bh 1536, s 128, d 64, bf16): bytes. B7 reads
// q, k, v and the bias and writes o, 100.7 MB: 0.0301 ms at 3.35 TB/s,
// against 6.4 GFLOP, 0.0065 ms at 989 TFLOP/s; B8 reads q, k, v, dO and
// the bias and writes dq, dk, dv, 176.2 MB: 0.0526 ms, against 16.1
// GFLOP, 0.016 ms (H100 SXM data sheet, not measurements). The row
// statistics B7 writes and B8 reads (1.6 MB) are this design's own bytes,
// not the function's, and the bound leaves them out.
//
// Shared memory a block, with a row stride of 16 * kD + 8 bf16 (the 16
// extra bytes spread ldmatrix's eight rows over the banks): the forward
// holds Q and two stages of K and V (5 tiles) and the bias, 46 KiB at d 64
// and s 128 (4 blocks an SM) and 86 KiB at d 128 (2); the dq pass Q, dO
// and two stages of K and V (6 tiles) and the bias, 55 KiB at d 64; the
// dk/dv pass K, V and two stages of Q and dO and the rows' statistics, 56
// KiB at d 64 and 104 KiB at d 128. At d 256 (one block an SM): 167, 200
// and 204 KiB at s 512. Registers: `nvcc -Xptxas -v` (chip_smoke.py's
// build line, PERF.md).
//
// The TPU kernel ran one program per bh (or a few) holding the whole
// [s, s] block in VMEM and emitted dq, dk and dv from one backward
// program. Here blocks run in parallel with no order, so no block can
// carry a sum into another: the backward is two passes, each owning its
// outputs, and the softmax is online over key tiles that fit in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // a block's rows (keys), a staged tile's rows
constexpr int kMaxD = 256;
constexpr int kMaxSeq = 512;
constexpr int kPad = 8;        // bf16 of padding at the end of a smem row
constexpr int kQChunk = 32;    // queries per step of the dk/dv pass
constexpr int kOutChunks = 8;  // 16-column chunks of dk and dv a dk/dv walk
// the backward passes' blocks an SM for heads up to 64 wide (kD <= 4): 4
// caps them at 128 registers, for a few bytes of spill, where they would
// take 150-170 and fit 3 (8-11% faster at BERT-base's shape); at 128 wide
// the cap would spill kilobytes, so there it is left to the compiler
template <int kD>
constexpr int bwd_min_blocks() { return kD <= 4 ? 4 : 1; }
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the score in exp2 units, as the f32 route: no fma contraction
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
  for (int c = threadIdx.x; c < s; c += kThreads)
    bs[c] = __fmul_rn(key_bias[b * s + c], kLog2e);
  return bs;
}

// -- B7: forward -----------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads)
fused_short_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ key_bias,
    const int32_t* __restrict__ seed, bf16* __restrict__ o,
    float* __restrict__ stats, long long bh_total, int heads, int s, int d,
    int row_tiles, float scale_log2e, uint32_t thresh, float inv_keep,
    int causal, int vec) {
  constexpr int ld = 16 * kD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kTile][ld]
  bf16* ks = qs + kTile * ld;                 // [2][kTile][ld]
  bf16* vs = ks + 2 * kTile * ld;             // [2][kTile][ld]
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile * ld);  // [s]
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kTile;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 15) / 16;
  const int n_tiles = (s + kTile - 1) / kTile;

  if (vec) zero_pad_cols<kThreads>(qs, 5 * kTile, ld, d);
  load_tile<kTile, kThreads>(qs, ld, q + base, row0, s, d, vec);
  load_tile<kTile, kThreads>(ks, ld, k + base, 0, s, d, vec);
  load_tile<kTile, kThreads>(vs, ld, v + base, 0, s, d, vec);
  cp_commit();
  const float* bias2 = stage_bias(bs, key_bias, bh / heads, s);

  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t rkey[2] = {row_key(seed_u, (uint32_t)bh, rows[0]),
                            row_key(seed_u, (uint32_t)bh, rows[1])};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[2 * kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile<kTile, kThreads>(ks + (stage ^ 1) * kTile * ld, ld, k + base,
                                 (kt + 1) * kTile, s, d, vec);
      load_tile<kTile, kThreads>(vs + (stage ^ 1) * kTile * ld, ld, v + base,
                                 (kt + 1) * kTile, s, d, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + stage * kTile * ld;
    const bf16* vst = vs + stage * kTile * ld;
    const int key0 = kt * kTile;

    float sc[8][4] = {};
    mma_abt<8, kD>(sc, qs + warp * 16 * ld, kst, ld, kd);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = score(sc[n][e], scale_log2e, bias2, rows[e / 2],
                         key0 + n * 8 + 2 * t + (e & 1), s, causal);
        tmax[e / 2] = fmaxf(tmax[e / 2], sc[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every tile holds a key below s, so the max is finite
      const float m_new = fmaxf(m[i], quad_max(tmax[i]));
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < 2 * kD; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
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
    for (int j = 0; j < 4; ++j) {
      if (key0 + j * 16 < s) {
        uint32_t af[4];
        to_a<8>(af, sc, j);
        mma_ax<kD>(acc, af, vst + j * 16 * ld, ld, kd);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  stage_acc<kD>(qs, ld, acc, 1.0f);  // the warp's own Q rows
  store_warp_rows(o + base, qs, ld, row0, s, d, vec);
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

template <int kD>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<kD>())
fused_short_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ key_bias, const int32_t* __restrict__ seed,
    const float* __restrict__ stats, float* __restrict__ delta,
    bf16* __restrict__ dq, long long bh_total, int heads, int s, int d,
    int row_tiles, float scale_log2e, float scale, uint32_t thresh,
    float inv_keep, int causal, int vec) {
  constexpr int ld = 16 * kD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kTile][ld]
  bf16* dos = qs + kTile * ld;                // [kTile][ld]
  bf16* ks = dos + kTile * ld;                // [2][kTile][ld]
  bf16* vs = ks + 2 * kTile * ld;             // [2][kTile][ld]
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile * ld);  // [s]
  const long long bh = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x - bh * row_tiles) * kTile;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 15) / 16;
  const int n_tiles = (s + kTile - 1) / kTile;

  if (vec) zero_pad_cols<kThreads>(qs, 6 * kTile, ld, d);
  load_tile<kTile, kThreads>(qs, ld, q + base, row0, s, d, vec);
  load_tile<kTile, kThreads>(dos, ld, dout + base, row0, s, d, vec);
  load_tile<kTile, kThreads>(ks, ld, k + base, 0, s, d, vec);
  load_tile<kTile, kThreads>(vs, ld, v + base, 0, s, d, vec);
  cp_commit();
  const float* bias2 = stage_bias(bs, key_bias, bh / heads, s);

  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  float mrow[2], inv_l[2], dsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < s;  // rows past s get p = 0
    mrow[i] = in ? stats[bh * s + rows[i]] : INFINITY;
    inv_l[i] = in ? 1.0f / stats[bh_total * s + bh * s + rows[i]] : 0.0f;
  }
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t rkey[2] = {row_key(seed_u, (uint32_t)bh, rows[0]),
                            row_key(seed_u, (uint32_t)bh, rows[1])};
  float acc[2 * kD][4] = {};

  // two sweeps over the key tiles: D = rowsum(dp * p), then dq. One tile
  // is loaded once and read by both.
  const int steps = 2 * n_tiles;
  for (int i = 0; i < steps; ++i) {
    const int kt = i < n_tiles ? i : i - n_tiles;
    const int stage = n_tiles == 1 ? 0 : i & 1;
    if (n_tiles > 1 && i + 1 < steps) {
      const int next = (kt + 1) * kTile < s ? (kt + 1) * kTile : 0;
      load_tile<kTile, kThreads>(ks + (stage ^ 1) * kTile * ld, ld, k + base,
                                 next, s, d, vec);
      load_tile<kTile, kThreads>(vs + (stage ^ 1) * kTile * ld, ld, v + base,
                                 next, s, d, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + stage * kTile * ld;
    const bf16* vst = vs + stage * kTile * ld;
    const int key0 = kt * kTile;

    float sc[8][4] = {}, dp[8][4] = {};
    mma_abt<8, kD>(sc, qs + warp * 16 * ld, kst, ld, kd);
    mma_abt<8, kD>(dp, dos + warp * 16 * ld, vst, ld, kd);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = key0 + n * 8 + 2 * t + (e & 1);
        const float x =
            score(sc[n][e], scale_log2e, bias2, rows[r], col, s, causal);
        const float p = exp2f(x - mrow[r]) * inv_l[r];
        float dpv = dp[n][e];
        if (seed != nullptr)
          dpv = kept(rkey[r], col, thresh) ? __fmul_rn(dpv, inv_keep) : 0.0f;
        if (i < n_tiles)
          dsum[r] = fmaf(dpv, p, dsum[r]);
        else
          sc[n][e] = __fmul_rn(p, __fsub_rn(dpv, dsum[r]));  // ds
      }
    if (i == n_tiles - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] = quad_sum(dsum[r]);
        if (t == 0 && rows[r] < s) delta[bh * s + rows[r]] = dsum[r];
      }
    } else if (i >= n_tiles) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + j * 16 < s) {
          uint32_t af[4];
          to_a<8>(af, sc, j);
          mma_ax<kD>(acc, af, kst + j * 16 * ld, ld, kd);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  stage_acc<kD>(qs, ld, acc, scale);
  store_warp_rows(dq + base, qs, ld, row0, s, d, vec);
}

// -- B8: backward, dk/dv pass ----------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<kD>())
fused_short_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ key_bias, const int32_t* __restrict__ seed,
    const float* __restrict__ stats, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, long long bh_total,
    int heads, int s, int d, int key_tiles, float scale_log2e, float scale,
    uint32_t thresh, float inv_keep, int causal, int vec) {
  constexpr int ld = 16 * kD + kPad;
  // the columns of dk and dv one walk over the queries holds: all of d up
  // to 128, else a half, each with its own walk
  constexpr int kDo = kD < kOutChunks ? kD : kOutChunks;
  constexpr int kPasses = kD / kDo;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kTile][ld]
  bf16* vs = ks + kTile * ld;                 // [kTile][ld]
  bf16* qs = vs + kTile * ld;                 // [2][kTile][ld]
  bf16* dos = qs + 2 * kTile * ld;            // [2][kTile][ld]
  const int sp = (s + kTile - 1) / kTile * kTile;
  float* mst = reinterpret_cast<float*>(dos + 2 * kTile * ld);  // [sp]
  float* ilst = mst + sp;                                      // [sp]
  float* dst = ilst + sp;                                      // [sp]
  const long long bh = blockIdx.x / key_tiles;
  const int key0 = (int)(blockIdx.x - bh * key_tiles) * kTile;
  const long long base = bh * s * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 15) / 16;
  const int n_tiles = sp / kTile;

  if (vec) zero_pad_cols<kThreads>(ks, 6 * kTile, ld, d);
  load_tile<kTile, kThreads>(ks, ld, k + base, key0, s, d, vec);
  load_tile<kTile, kThreads>(vs, ld, v + base, key0, s, d, vec);
  load_tile<kTile, kThreads>(qs, ld, q + base, 0, s, d, vec);
  load_tile<kTile, kThreads>(dos, ld, dout + base, 0, s, d, vec);
  cp_commit();
  // every query's max, 1 / sum and D; queries past s get p = 0
  for (int i = threadIdx.x; i < sp; i += kThreads) {
    const bool in = i < s;
    mst[i] = in ? stats[bh * s + i] : INFINITY;
    ilst[i] = in ? 1.0f / stats[bh_total * s + bh * s + i] : 0.0f;
    dst[i] = in ? delta[bh * s + i] : 0.0f;
  }

  const int keys[2] = {key0 + warp * 16 + g, key0 + warp * 16 + g + 8};
  float kb[2] = {0.0f, 0.0f};
  if (key_bias != nullptr)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (keys[i] < s)
        kb[i] = __fmul_rn(key_bias[(bh / heads) * s + keys[i]], kLog2e);
  const uint32_t seed_u = seed != nullptr ? (uint32_t)(*seed) : 0u;
  const uint32_t bh_key = mix(seed_u, (uint32_t)bh);  // row_key = mix(., row)

  for (int pass = 0; pass < kPasses; ++pass) {
    const int c0 = pass * kDo, kdo = min(kDo, kd - c0);  // the pass's chunks
    if (pass > 0) {  // the last walk's tiles are consumed: Q and dO tile 0
      load_tile<kTile, kThreads>(qs, ld, q + base, 0, s, d, vec);
      load_tile<kTile, kThreads>(dos, ld, dout + base, 0, s, d, vec);
      cp_commit();
    }
    float acc_k[2 * kDo][4] = {}, acc_v[2 * kDo][4] = {};

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int stage = qt & 1;
      if (qt + 1 < n_tiles) {
        load_tile<kTile, kThreads>(qs + (stage ^ 1) * kTile * ld, ld,
                                   q + base, (qt + 1) * kTile, s, d, vec);
        load_tile<kTile, kThreads>(dos + (stage ^ 1) * kTile * ld, ld,
                                   dout + base, (qt + 1) * kTile, s, d, vec);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < kTile / kQChunk; ++h) {
        const int qf = qt * kTile + h * kQChunk;  // the chunk's first query
        if (qf >= s) break;
        const bf16* qst = qs + (stage * kTile + h * kQChunk) * ld;
        const bf16* dost = dos + (stage * kTile + h * kQChunk) * ld;
        float st[4][4] = {}, dpt[4][4] = {};  // S^T, dP^T: keys x queries
        mma_abt<4, kD>(st, ks + warp * 16 * ld, qst, ld, kd);
        mma_abt<4, kD>(dpt, vs + warp * 16 * ld, dost, ld, kd);
#pragma unroll
        for (int n = 0; n < 4; ++n)
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
        for (int j = 0; j < kQChunk / 16; ++j) {
          if (qf + j * 16 < s) {
            uint32_t af[4];
            to_a<4>(af, st, j);
            mma_ax<kDo>(acc_v, af, dost + j * 16 * ld + c0 * 16, ld, kdo);
            to_a<4>(af, dpt, j);
            mma_ax<kDo>(acc_k, af, qst + j * 16 * ld + c0 * 16, ld, kdo);
          }
        }
      }
      __syncthreads();
    }
    if constexpr (kPasses == 1) {
      stage_acc<kD>(ks, ld, acc_k, scale);  // the warp's own K and V rows
      stage_acc<kD>(vs, ld, acc_v, 1.0f);
      store_warp_rows(dk + base, ks, ld, key0, s, d, vec);
      store_warp_rows(dv + base, vs, ld, key0, s, d, vec);
    } else {  // K and V are read by the next walk: store from registers
      store_frag<2 * kDo>(dk + base, acc_k, key0 + warp * 16, c0 * 16, s, d,
                          scale);
      store_frag<2 * kDo>(dv + base, acc_v, key0 + warp * 16, c0 * 16, s, d,
                          1.0f);
    }
  }
}

// -- launches --------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t tile_bytes(int kD) { return sizeof(bf16) * kTile * (16 * kD + kPad); }

int padded_seq(int s) { return (s + kTile - 1) / kTile * kTile; }

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <int kD>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* key_bias, const void* seed, void* o, void* stats,
               long long bh, int heads, int s, int d, float scale_log2e,
               uint32_t thresh, float inv_keep, int causal,
               cudaStream_t stream) {
  const int row_tiles = (s + kTile - 1) / kTile;
  const size_t smem = 5 * tile_bytes(kD) + sizeof(float) * padded_seq(s);
  const long long blocks = bh * row_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16({q, k, v, o});
  cudaError_t err = allow_smem(fused_short_fwd_bf16_kernel<kD>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_short_fwd_bf16_kernel<kD>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(key_bias),
      static_cast<const int32_t*>(seed), static_cast<bf16*>(o),
      static_cast<float*>(stats), bh, heads, s, d, row_tiles, scale_log2e,
      thresh, inv_keep, causal, vec);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* key_bias, const void* seed, const void* stats,
               void* delta, void* dq, void* dk, void* dv, long long bh,
               int heads, int s, int d, float scale_log2e, float scale,
               uint32_t thresh, float inv_keep, int causal,
               cudaStream_t stream) {
  const int tiles = (s + kTile - 1) / kTile;
  const int sp = padded_seq(s);
  const size_t smem_dq = 6 * tile_bytes(kD) + sizeof(float) * sp;
  const size_t smem_dkv = 6 * tile_bytes(kD) + sizeof(float) * 3 * sp;
  const long long blocks = bh * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16({q, k, v, dout, dq, dk, dv});
  cudaError_t err = allow_smem(fused_short_bwd_dq_bf16_kernel<kD>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_short_bwd_dkv_bf16_kernel<kD>, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot_ = static_cast<const bf16*>(dout);
  const float* kb = static_cast<const float*>(key_bias);
  const int32_t* sd = static_cast<const int32_t*>(seed);
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  fused_short_bwd_dq_bf16_kernel<kD>
      <<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot_, kb, sd, st, dl, static_cast<bf16*>(dq), bh, heads, s,
      d, tiles, scale_log2e, scale, thresh, inv_keep, causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_short_bwd_dkv_bf16_kernel<kD>
      <<<(unsigned)blocks, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot_, kb, sd, st, dl, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), bh, heads, s, d, tiles, scale_log2e, scale,
      thresh, inv_keep, causal, vec);
  return (int)cudaGetLastError();
}

bool bad_shape(long long bh, int heads, int s, int d) {
  return bh < 0 || heads < 1 || s < 1 || s > kMaxSeq || d < 1 || d > kMaxD;
}

}  // namespace

extern "C" {

// B7, bf16 route, on `stream`; returns cudaGetLastError() (0 on success).
// q, k, v, o: [bh, s, d] bf16. key_bias: [bh / heads, s] f32 or NULL.
// seed: one int32 on the device, or NULL for no dropout (then thresh and
// inv_keep are unused). stats: [2, bh, s] f32, each row's max in exp2
// units, then its sum. The caller allocates o and stats.
int azt_fused_short_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* key_bias, const void* seed, void* o,
                             void* stats, long long bh, int heads, int s,
                             int d, float scale_log2e, unsigned int thresh,
                             float inv_keep, int causal, void* stream) {
  if (bad_shape(bh, heads, s, d) || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_fwd<2>(q, k, v, key_bias, seed, o, stats, bh, heads, s, d,
                         scale_log2e, thresh, inv_keep, causal, st);
  if (d <= 64)
    return launch_fwd<4>(q, k, v, key_bias, seed, o, stats, bh, heads, s, d,
                         scale_log2e, thresh, inv_keep, causal, st);
  if (d <= 128)
    return launch_fwd<8>(q, k, v, key_bias, seed, o, stats, bh, heads, s, d,
                         scale_log2e, thresh, inv_keep, causal, st);
  return launch_fwd<16>(q, k, v, key_bias, seed, o, stats, bh, heads, s, d,
                        scale_log2e, thresh, inv_keep, causal, st);
}

// B8, bf16 route, on `stream`: the dq pass, then the dk/dv pass; returns
// cudaGetLastError(). stats: the forward's [2, bh, s] row statistics;
// dout, dq, dk, dv: [bh, s, d] bf16; delta: [bh, s] f32 scratch. The
// caller allocates the outputs and delta.
int azt_fused_short_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* key_bias,
                             const void* seed, const void* stats,
                             void* delta, void* dq, void* dk, void* dv,
                             long long bh, int heads, int s, int d,
                             float scale_log2e, float scale,
                             unsigned int thresh, float inv_keep, int causal,
                             void* stream) {
  if (bad_shape(bh, heads, s, d) || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_bwd<2>(q, k, v, dout, key_bias, seed, stats, delta, dq, dk,
                         dv, bh, heads, s, d, scale_log2e, scale, thresh,
                         inv_keep, causal, st);
  if (d <= 64)
    return launch_bwd<4>(q, k, v, dout, key_bias, seed, stats, delta, dq, dk,
                         dv, bh, heads, s, d, scale_log2e, scale, thresh,
                         inv_keep, causal, st);
  if (d <= 128)
    return launch_bwd<8>(q, k, v, dout, key_bias, seed, stats, delta, dq, dk,
                         dv, bh, heads, s, d, scale_log2e, scale, thresh,
                         inv_keep, causal, st);
  return launch_bwd<16>(q, k, v, dout, key_bias, seed, stats, delta, dq, dk,
                        dv, bh, heads, s, d, scale_log2e, scale, thresh,
                        inv_keep, causal, st);
}

}  // extern "C"
