// Flash attention's f32 route on the tensor cores of Hopper (sm_90a) as
// 3xTF32: the forward (B4), the two-pass backward's dq pass (B5a) and dk/dv
// pass (B5b), and the one-pass backward (B6). bf16 takes flash_attn_bf16.cu.
//
// Replaces the TPU kernels in analytics_zoo_tpu/ops/attention.py:
//   B4  `_flash_fwd_kernel`        (:203, pallas_call in `_flash_fwd_pallas`)
//   B5a `_flash_bwd_dq_kernel`     (:379, pallas_call in `_flash_bwd_pallas`)
//   B5b `_flash_bwd_dkv_kernel`    (:428, pallas_call in `_flash_bwd_pallas`)
//   B6  `_flash_bwd_fused_kernel`  (:483, pallas_call in `_flash_bwd_fused`)
//
// q [bh, sq, d], k and v [bh, skv, d] (f32, contiguous, d <= 128, any
// lengths, sq and skv apart), an optional per-key bias key_bias [bh /
// heads, skv] f32 in natural-log units (B4 only), and an optional causal
// mask aligned top-left (key col visible to query row iff col <= row,
// absolute indices). In f32:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past skv
//   B4:  m_i = max_j t, l_i = sum_j exp2(t - m_i) by the online softmax
//        over key tiles, o_i = sum_j exp2(t - m_i) v_j / max(l_i, 1e-30),
//        lse_i = m_i * ln 2 + ln(max(l_i, 1e-30))
//   backward: p = exp2(t - lse_i * log2(e)), dp = dO_i . v_j,
//        ds = p * (dp - D_i + glse_i) with D_i = sum dO_i * o_i (computed
//        by the caller) and glse the lse cotangent (NULL for 0);
//        dq_i = scale * sum_j ds k_j (B5a, B6), dk_j = scale * sum_i ds q_i
//        and dv_j = sum_i p dO_i (B5b, B6).
//
// Every product (q.k^T and p.v; q.k^T, dO.v^T and ds.k; k.q^T, v.dO^T,
// p^T.dO, ds^T.q and ds.k) runs as mma.sync m16n8k8 3xTF32 with f32
// accumulators on mma_tf32.cuh's fragments: each f32 operand split into
// two TF32 parts at fragment load, three TF32 products for one f32-grade
// product, and an accumulator (p, ds) fed back as the next product's A
// fragment in the permuted reduction order. The walk is mma_tf32.cuh's and
// B7/B8's at one warp a row group: a block of four warps owns 64 rows in
// four row groups of 16 and walks the other side in 32-row tiles that
// cp.async stages into shared memory. B7/B8's two warps a row group under
// eight blocks an SM (split_for) made B4 28% and B5b 3% slower at 1024
// blocks (the LM's prefill at batch 2) on the H100; at 512 blocks B4 2%
// slower and B5b 2-4% faster; at the LM's grids of 2048-4096 blocks
// split_for picks one (PERF.md).
//
//   B4:  a block per (bh, 64 query rows), Q resident, K/V tiles walked
//        with the online softmax in registers; the blocks with the most
//        causal key tiles launch first. Under the causal mask a block
//        walks only the key tiles at or below its last row, and a warp
//        skips a tile whose keys all lie past its rows. The bias is staged
//        per key tile (bias * log2 e). Rows past sq are computed from zeros
//        and not stored; keys past skv score -inf and weigh exactly 0.
//   B5a: B4's walk with Q and dO resident and each row's lse * log2 e, D
//        and glse in registers. Per key tile S = Q.K^T, dP = dO.V^T, p and
//        ds, then dq += ds.K with ds fed back as the A fragment; dq is
//        stored once, times scale. No atomics: dq is bit-equal from run to
//        run. Rows past sq carry lse +inf (p = 0) and are not stored; keys
//        past skv weigh exactly 0.
//   B5b: a block per (bh, 64 keys), K and V resident, query tiles walked
//        from the first a causal key tile reaches (its first key's tile);
//        each tile's rows' lse * log2 e, D and glse staged beside it. Per
//        tile S^T = K.Q^T, dP^T = V.dO^T, dv += p^T.dO, dk += ds^T.Q; dk *=
//        scale at the end. No atomics: dk and dv are bit-equal from run to
//        run. Queries past sq carry lse +inf, so p = 0; keys past skv are
//        computed from zeros, weigh 0 and are not stored; keys no query
//        reaches get 0.
//   B6:  B5b's kernel (kDq) with the tile's share of dq: the warps write
//        ds^T to a shared [64 keys][32 queries] tile, and after the barrier
//        that frees Q and dO (the next tile's copy then overlaps) each warp
//        forms ds.K for the tile's 32 queries over the block's keys that
//        reach them, for its quarter of the columns, ds read transposed in
//        the permuted order and K resident. It adds that, times scale, into
//        the f32 buffer dq_acc that the caller zeroed with float4 atomics
//        (vector red.global.add) where d is a multiple of 4, two lanes
//        trading a pair first; float2 pairs, as bf16 B6 adds, made B6
//        1.5-2% slower on the H100. dq sums its key blocks in no fixed order, at
//        most skv / 64 partial sums, and is not bit-equal from run to run;
//        dk and dv are. B6's code is large: with both the dq step's loop
//        over the keys and the S^T, dP^T loop over d unrolled in full it
//        took 20-25% longer on the H100 than with either rolled up, so
//        the first is a loop and the second unrolled twice (PERF.md).
// B5a's S = Q.K^T and B5b's S^T = K.Q^T take the same three products in
// another order: the two passes' p differ by rounding, within the route's
// 2e-5 of the output's scale.
//
// The running sums over the walk (B4's o, B5a's dq, B5b's and B6's dk and
// dv) and dP take each 8-step's three products summed from zero, then one
// rounded f32 add (mma3_add). On the H100, summed straight into the
// running sums, dk and dv over 4096 queries missed 2e-5 of scale (4.7e-5);
// with dP^T summed straight, the grid's one query and one key with an lse
// cotangent came to 1.65e-5 (ds = p (dP - D + glse) cancels dP against the
// caller's D, leaving glse), and 4.5e-6 in two levels, at 0-2% more B5b
// time. B6's share of dq over a tile (64 keys at most) sums in one level;
// the atomics add the shares.
//
// One buffer of walked tiles each, refilled after the tile is consumed: a
// second (the next tile's copy overlapping this one's products) made B4
// 26-29% and B5b 57-62% slower at the LM's shapes on the H100, the blocks
// an SM falling from three to two and from two to one; B5a's K/V in two
// buffers of 16 keys (the same shared memory as one of 32) made it 10%
// slower, each tile re-splitting Q's and dO's fragments (PERF.md). Shared
// memory at d 128: B4 Q (64 rows), a K and a V tile of 32 keys and their
// bias, 67,712 bytes (three blocks an SM); B5a Q and dO (64 rows), a K and
// a V tile, 101,376 bytes; B5b K and V (64 rows), a Q and a dO tile of 32
// and their rows' statistics, 101,760 bytes; B6 also ds^T, 110,976 bytes
// (two blocks an SM each). Rows are 8 * ceil(d / 8) + 4 floats; at d 64
// about half.
//
// Bound (H100 SXM data sheet, not measurements), operations at 3xTF32's
// 164.9 TFLOP/s (494.7 / 3), counting the pairs the causal mask leaves: at
// the LM's shape (bh 128, s 2048, d 128) B4 137.5 GFLOP, 0.834 ms (2.052
// at the CUDA cores' 67), and B6 343.8 GFLOP, 2.085 ms (5.131), against
// 0.16-0.4 ms of bytes at 3.35 TB/s; at the LM's long context (bh 32, s
// 4096, d 128) B4 the same 137.5 GFLOP, B5a 206.3 GFLOP, 1.251 ms (3.078),
// and B5b 275 GFLOP, 1.667 ms (4.104): operations bound all four.
//
// The TPU kernels kept a whole K/V block in VMEM and carried the softmax
// state (and dk/dv, dq) in scratch across a sequential grid axis. Here
// blocks run in parallel in no order, so each block owns its outputs and
// walks the other side itself in tiles that fit in shared memory; B6's dq,
// which every key block adds to, goes through atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // a masked score, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = kPart;  // rows of a walked tile: a warp's
constexpr int kThreads = 128;  // a warp for each of the four row groups
// B6's ds^T tile [kRows keys][kTile queries]: a stride of 4 (mod 32) words,
// so that the dq step's transposed A loads (rows 2t and 2t + 1, columns g)
// fall on 32 banks, as mma_tf32.cuh's tiles
constexpr int kLdS = kTile + 4;

// -- B4: forward -----------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ key_bias,
                      float* __restrict__ o, float* __restrict__ lse,
                      int heads, int sq, int skv, int d, float scale_log2e,
                      int causal, int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kTile / 8;  // 8-key steps of a tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                             // [kRows][ld]
  float* kvs = qs + kRows * ld;                 // [K, V][kTile][ld]
  float* bs = kvs + 2 * kTile * ld;             // [kTile]
  const long long bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const long long qbase = bh * sq * d, kbase = bh * skv * d;
  const float* biasb =
      key_bias != nullptr ? key_bias + (bh / heads) * skv : nullptr;
  const int rg = threadIdx.x / 32, lane = threadIdx.x % 32;  // row group
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  const int kend = causal ? min(skv, row0 + kRows) : skv;
  const int n_tiles = (kend + kTile - 1) / kTile;

  // key tile `kt`: K and V by cp.async as one group, the bias (times
  // log2 e) by plain loads
  auto load_kv = [&](int kt) {
    load_tile_f32<kTile, kThreads, kD>(kvs, ld, k + kbase, kt * kTile, skv,
                                       d, vec);
    load_tile_f32<kTile, kThreads, kD>(kvs + kTile * ld, ld, v + kbase,
                                       kt * kTile, skv, d, vec);
    cp_commit();
    if (biasb != nullptr)
      for (int c = threadIdx.x; c < kTile; c += kThreads) {
        const int col = kt * kTile + c;
        bs[c] = col < skv ? __fmul_rn(biasb[col], kLog2e) : 0.0f;
      }
  };

  if (vec) zero_pad_cols_f32<kThreads>(qs, kRows + 2 * kTile, ld, d);
  load_tile_f32<kRows, kThreads, kD>(qs, ld, q + qbase, row0, sq, d, vec);
  load_kv(0);

  const float* qw = qs + rg * 16 * ld;
  const int rows[2] = {row0 + rg * 16 + g, row0 + rg * 16 + g + 8};
  const int last_row = row0 + rg * 16 + 15;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();
    const float* kst = kvs;
    const float* vst = kvs + kTile * ld;
    const int key0 = kt * kTile;  // the tile's first key

    // tile 0 is never skipped, so there m is finite from the first tile on
    if (key0 < skv && !(causal && key0 > last_row)) {
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
          // no fma contraction: the plain version's separate multiply and
          // add round alike
          const int c = n * 8 + 2 * t + (e & 1), col = key0 + c;
          float x = __fmul_rn(sc[n][e], scale_log2e);
          if (biasb != nullptr) x = __fadd_rn(x, bs[c]);
          if (col >= skv)
            x = -INFINITY;  // past the end: weighs exactly 0
          else if (causal && col > rows[e / 2])
            x = kNegInf;
          sc[n][e] = x;
          tmax[e / 2] = fmaxf(tmax[e / 2], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // a walked tile holds a key below skv: its max is finite
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
          const float p = exp2f(sc[n][e] - m[e / 2]);
          l[e / 2] += p;
          sc[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (key0 + n * 8 < skv) {
          FragA a;
          c_to_a(a, sc[n]);
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            if (j < kd) {
              FragB b;
              load_b(b, vst + n * 8 * ld, ld, j);
              mma3_add(acc[j], a, b);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
    if (kt + 1 < n_tiles) load_kv(kt + 1);
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int n = 0; n < kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fdiv_rn(acc[n][e], den[e / 2]);
  store_acc<kD>(o + qbase, acc, 1.0f, row0 + rg * 16, sq, d);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < sq)
        lse[bh * sq + rows[i]] =
            __fadd_rn(__fmul_rn(m[i], kLn2), logf(den[i]));
  }
}

// -- B5a: backward, dq -----------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ glse,
                         float* __restrict__ dq, int sq, int skv, int d,
                         float scale_log2e, float scale, int causal,
                         int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kTile / 8;  // 8-key steps of a tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kRows][ld]
  float* dos = qs + kRows * ld;        // [kRows][ld]
  float* kvs = dos + kRows * ld;       // [K, V][kTile][ld]
  const long long bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const long long qbase = bh * sq * d, kbase = bh * skv * d;
  const int rg = threadIdx.x / 32, lane = threadIdx.x % 32;  // row group
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  const int kend = causal ? min(skv, row0 + kRows) : skv;
  const int n_tiles = (kend + kTile - 1) / kTile;

  // key tile `kt`: K and V by cp.async as one group
  auto load_kv = [&](int kt) {
    load_tile_f32<kTile, kThreads, kD>(kvs, ld, k + kbase, kt * kTile, skv,
                                       d, vec);
    load_tile_f32<kTile, kThreads, kD>(kvs + kTile * ld, ld, v + kbase,
                                       kt * kTile, skv, d, vec);
    cp_commit();
  };

  if (vec) zero_pad_cols_f32<kThreads>(qs, 2 * kRows + 2 * kTile, ld, d);
  load_tile_f32<kRows, kThreads, kD>(qs, ld, q + qbase, row0, sq, d, vec);
  load_tile_f32<kRows, kThreads, kD>(dos, ld, dout + qbase, row0, sq, d,
                                     vec);
  load_kv(0);

  // the rows' lse * log2 e (+inf past sq, so p = 0 there), D and glse
  const int rows[2] = {row0 + rg * 16 + g, row0 + rg * 16 + g + 8};
  float lse2[2], dl[2], gl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < sq;
    const long long at = bh * sq + rows[i];
    lse2[i] = in ? __fmul_rn(lse[at], kLog2e) : INFINITY;
    dl[i] = in ? delta[at] : 0.0f;
    gl[i] = in && glse != nullptr ? glse[at] : 0.0f;
  }
  const float* qw = qs + rg * 16 * ld;
  const float* dow = dos + rg * 16 * ld;
  const int last_row = row0 + rg * 16 + 15;
  float acc[kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();
    const float* kst = kvs;
    const float* vst = kvs + kTile * ld;
    const int key0 = kt * kTile;  // the tile's first key, below skv

    // a warp whose rows all precede the tile's first key sees none of it
    if (!(causal && key0 > last_row)) {
      float sc[kN][4] = {}, dp[kN][4] = {};  // S, dP: queries x keys
#pragma unroll
      for (int kc = 0; kc < kD; ++kc) {
        if (kc < kd) {
          FragA a, ado;
          load_a(a, qw, ld, kc);
          load_a(ado, dow, ld, kc);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            FragB b;
            load_bt(b, kst + n * 8 * ld, ld, kc);
            mma3(sc[n], a, b);
            load_bt(b, vst + n * 8 * ld, ld, kc);
            mma3_add(dp[n], ado, b);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, col = key0 + n * 8 + 2 * t + (e & 1);
          float x = __fmul_rn(sc[n][e], scale_log2e);
          if (causal && col > rows[i]) x = kNegInf;
          // past the end: weighs exactly 0
          const float p = col < skv ? exp2f(x - lse2[i]) : 0.0f;
          sc[n][e] =
              __fmul_rn(p, __fadd_rn(__fsub_rn(dp[n][e], dl[i]), gl[i]));
        }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (key0 + n * 8 < skv) {
          FragA ads;
          c_to_a(ads, sc[n]);
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            if (j < kd) {
              FragB b;
              load_b(b, kst + n * 8 * ld, ld, j);
              mma3_add(acc[j], ads, b);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
    if (kt + 1 < n_tiles) load_kv(kt + 1);
  }
  store_acc<kD>(dq + qbase, acc, scale, row0 + rg * 16, sq, d);
}

// -- B6's share of dq ------------------------------------------------------

// dq_acc[qf + r][c] += scale * sum over the block's first `nk` keys of
// ds[r][key] k[key][c], for the tile's kTile queries r (those below sq)
// and this warp's quarter of the columns: ds read transposed from dst
// ([kRows keys][kLdS]) in the permuted order, k the resident K ([kRows]
// [ld]); float4 atomics where d is a multiple of 4, else scalar ones
template <int kD>
__device__ __forceinline__ void add_dq_share(float* __restrict__ dq_acc,
                                             const float* dst,
                                             const float* ks, int ld,
                                             int nk, int qf, int sq, int d,
                                             float scale) {
  constexpr int kQ = kD / 4;  // 8-column chunks a warp
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c0 = threadIdx.x / 32 * kQ;  // the warp's first chunk
  const int kd = (d + 7) / 8;
  if (c0 >= kd) return;
  float acc[2][kQ][4] = {};  // two 16-query halves of the tile
  // a loop, which keeps B6's code small (the file's header)
#pragma unroll 1
  for (int s = 0; 8 * s < nk; ++s) {
    // A (queries x keys) at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    // is ds at keys 2t, 2t, 2t + 1, 2t + 1 of the 8-step: c_to_a's order,
    // matching load_b's rows of K
    const float* p = dst + (8 * s + 2 * t) * kLdS + g;
    FragA a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h].set(0, p[16 * h]);
      a[h].set(1, p[16 * h + 8]);
      a[h].set(2, p[kLdS + 16 * h]);
      a[h].set(3, p[kLdS + 16 * h + 8]);
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (c0 + j < kd) {
        FragB b;
        load_b(b, ks + 8 * s * ld, ld, c0 + j);
        mma3(acc[0][j], a[0], b);
        mma3(acc[1][j], a[1], b);
      }
    }
  }
  if (d % 4 == 0) {
    // lanes t and t ^ 1 trade a pair, so that each adds four consecutive
    // columns of one row (the even lane row g, the odd row g + 8): half
    // the atomics of float2 pairs
    const bool odd = t & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        if (c0 + j < kd) {  // the same in every lane
          const float x0 = __fmul_rn(acc[h][j][0], scale);
          const float x1 = __fmul_rn(acc[h][j][1], scale);
          const float y0 = __fmul_rn(acc[h][j][2], scale);
          const float y1 = __fmul_rn(acc[h][j][3], scale);
          const float r0 = __shfl_xor_sync(~0u, odd ? x0 : y0, 1);
          const float r1 = __shfl_xor_sync(~0u, odd ? x1 : y1, 1);
          const int row = qf + 16 * h + g + (odd ? 8 : 0);
          const int col = 8 * (c0 + j) + 4 * (t / 2);
          if (row < sq && col < d)
            atomicAdd(reinterpret_cast<float4*>(dq_acc + (long long)row * d +
                                                col),
                      odd ? make_float4(r0, r1, y0, y1)
                          : make_float4(x0, x1, r0, r1));
        }
      }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qf + 16 * h + g + 8 * i;
      if (row >= sq) continue;
      float* out = dq_acc + (long long)row * d;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int col = 8 * (c0 + j) + 2 * t;
        if (col < d) atomicAdd(out + col, __fmul_rn(acc[h][j][2 * i], scale));
        if (col + 1 < d)
          atomicAdd(out + col + 1, __fmul_rn(acc[h][j][2 * i + 1], scale));
      }
    }
}

// -- B5b and B6: backward over the queries of a key block ------------------

// B5b (kDq false): dk and dv; B6 (kDq true): also dq added into dq_acc
template <int kD, bool kDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ glse,
                      float* __restrict__ dq_acc, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int skv, int d,
                      float scale_log2e, float scale, int causal, int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kTile / 8;  // 8-query steps of a tile
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                              // [kRows][ld]
  float* vs = ks + kRows * ld;                   // [kRows][ld]
  float* qds = vs + kRows * ld;                  // [Q, dO][kTile][ld]
  float* rs = qds + 2 * kTile * ld;              // [3][kTile]
  float* dst = rs + 3 * kTile;                   // B6: [kRows][kLdS] ds^T
  const long long bh = blockIdx.x;
  const int key0 = blockIdx.y * kRows;  // the first key tiles see the most rows
  const long long qbase = bh * sq * d, kbase = bh * skv * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;
  const float* glseb = glse != nullptr ? glse + bh * sq : nullptr;
  const int rg = threadIdx.x / 32, lane = threadIdx.x % 32;  // row group
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 7) / 8;
  const int n_tiles = (sq + kTile - 1) / kTile;
  // under the causal mask, queries before the block's first key see none
  // of its keys
  const int first = causal ? key0 / kTile : 0;

  // query tile `qt`: Q and dO by cp.async as one group, the rows' lse *
  // log2 e (+inf past sq, so p = 0 there), D and glse by plain loads
  auto load_qdo = [&](int qt) {
    load_tile_f32<kTile, kThreads, kD>(qds, ld, q + qbase, qt * kTile, sq, d,
                                       vec);
    load_tile_f32<kTile, kThreads, kD>(qds + kTile * ld, ld, dout + qbase,
                                       qt * kTile, sq, d, vec);
    cp_commit();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = qt * kTile + i;
      const bool in = row < sq;
      rs[i] = in ? __fmul_rn(lseb[row], kLog2e) : INFINITY;
      rs[kTile + i] = in ? deltab[row] : 0.0f;
      rs[2 * kTile + i] = in && glseb != nullptr ? glseb[row] : 0.0f;
    }
  };

  if (first < n_tiles) {  // else no query reaches these keys: dk = dv = 0
    if (vec) zero_pad_cols_f32<kThreads>(ks, 2 * kRows + 2 * kTile, ld, d);
    load_tile_f32<kRows, kThreads, kD>(ks, ld, k + kbase, key0, skv, d, vec);
    load_tile_f32<kRows, kThreads, kD>(vs, ld, v + kbase, key0, skv, d, vec);
    load_qdo(first);
  }

  const int keys[2] = {key0 + rg * 16 + g, key0 + rg * 16 + g + 8};
  const int first_key = key0 + rg * 16;
  const float* kw = ks + rg * 16 * ld;
  const float* vw = vs + rg * 16 * ld;
  float acc_k[kD][4] = {}, acc_v[kD][4] = {};

  for (int qt = first; qt < n_tiles; ++qt) {
    cp_wait<0>();
    __syncthreads();
    const float* qst = qds;
    const float* dost = qds + kTile * ld;
    const float* rst = rs;  // the tile's rows' statistics
    const int qf = qt * kTile;  // the tile's first query, below sq

    // a warp whose keys all lie past the tile's queries sees none of them
    if (!(causal && qf + kTile - 1 < first_key)) {
      float sT[kN][4] = {}, dpT[kN][4] = {};  // S^T, dP^T: keys x queries
      // unrolled twice, not in full: B6 0.3-2% and B5b 1-2% faster on the
      // H100 (the file's header)
#pragma unroll 2
      for (int kc = 0; kc < kD; ++kc) {
        if (kc < kd) {
          FragA a, av;
          load_a(a, kw, ld, kc);
          load_a(av, vw, ld, kc);
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            FragB b;
            load_bt(b, qst + n * 8 * ld, ld, kc);
            mma3(sT[n], a, b);
            load_bt(b, dost + n * 8 * ld, ld, kc);
            mma3_add(dpT[n], av, b);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = n * 8 + 2 * t + e, query = qf + r;
          const float lse2 = rst[r], dl = rst[kTile + r],
                      gl = rst[2 * kTile + r];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 2 * i + e;
            float x = __fmul_rn(sT[n][idx], scale_log2e);
            if (causal && keys[i] > query) x = kNegInf;
            // keys past skv weigh exactly 0: B6 reads their ds
            const float p = keys[i] < skv ? exp2f(x - lse2) : 0.0f;
            sT[n][idx] = p;
            dpT[n][idx] =
                __fmul_rn(p, __fadd_rn(__fsub_rn(dpT[n][idx], dl), gl));
          }
        }
      if constexpr (kDq) {
        // ds^T (this warp's 16 keys x the tile's queries) for the dq step
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(
                dst + (rg * 16 + g + 8 * i) * kLdS + n * 8 + 2 * t) =
                make_float2(dpT[n][2 * i], dpT[n][2 * i + 1]);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        if (qf + n * 8 < sq) {
          FragA a, ads;
          c_to_a(a, sT[n]);
          c_to_a(ads, dpT[n]);
#pragma unroll
          for (int j = 0; j < kD; ++j) {
            if (j < kd) {
              FragB b;
              load_b(b, dost + n * 8 * ld, ld, j);
              mma3_add(acc_v[j], a, b);
              load_b(b, qst + n * 8 * ld, ld, j);
              mma3_add(acc_k[j], ads, b);
            }
          }
        }
      }
    }
    // Q and dO are consumed (and B6's ds^T written) before they are
    // refilled; the copy overlaps B6's dq step
    __syncthreads();
    if (qt + 1 < n_tiles) load_qdo(qt + 1);
    if constexpr (kDq) {
      // the keys that reach the tile's queries: below skv, and under the
      // causal mask at or before its last query (a multiple of 8 past
      // key0, so a skipped warp's stale rows are never read)
      int nk = min(kRows, skv - key0);
      if (causal) nk = min(nk, qf + kTile - key0);
      add_dq_share<kD>(dq_acc + qbase, dst, ks, ld, nk, qf, sq, d, scale);
    }
  }
  store_acc<kD>(dk + kbase, acc_k, scale, key0 + rg * 16, skv, d);
  store_acc<kD>(dv + kbase, acc_v, 1.0f, key0 + rg * 16, skv, d);
}

// -- launches --------------------------------------------------------------

int tiles(int n) { return (n + kRows - 1) / kRows; }

template <int kD>
struct Fwd {
  static int run(const void* q, const void* k, const void* v,
                 const void* key_bias, void* o, void* lse, long long bh,
                 int heads, int sq, int skv, int d, float scale_log2e,
                 int causal, cudaStream_t stream) {
    const size_t smem = tile_bytes(kD, kRows) + 2 * tile_bytes(kD, kTile) +
                        sizeof(float) * kTile;
    const int vec = d % 4 == 0 && aligned16({q, k, v});
    auto kernel = flash_fwd_tf32_kernel<kD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)bh, (unsigned)tiles(sq)), kThreads, smem,
             stream>>>(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(key_bias),
                       static_cast<float*>(o), static_cast<float*>(lse),
                       heads, sq, skv, d, scale_log2e, causal, vec);
    return (int)cudaGetLastError();
  }
};

template <int kD>
struct Dq {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* glse, void* dq, long long bh, int sq, int skv,
                 int d, float scale_log2e, float scale, int causal,
                 cudaStream_t stream) {
    const size_t smem = 2 * tile_bytes(kD, kRows) + 2 * tile_bytes(kD, kTile);
    const int vec = d % 4 == 0 && aligned16({q, k, v, dout});
    auto kernel = flash_bwd_dq_tf32_kernel<kD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)bh, (unsigned)tiles(sq)), kThreads, smem,
             stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(glse), static_cast<float*>(dq), sq, skv, d,
        scale_log2e, scale, causal, vec);
    return (int)cudaGetLastError();
  }
};

// B5b (kDq false; dq_acc unused) and B6 (kDq true)
template <int kD, bool kDq>
struct Bwd {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* glse, void* dq_acc, void* dk, void* dv,
                 long long bh, int sq, int skv, int d, float scale_log2e,
                 float scale, int causal, cudaStream_t stream) {
    const size_t smem =
        2 * tile_bytes(kD, kRows) + 2 * tile_bytes(kD, kTile) +
        sizeof(float) * (3 * kTile + (kDq ? kRows * kLdS : 0));
    const int vec = d % 4 == 0 && aligned16({q, k, v, dout});
    auto kernel = flash_bwd_tf32_kernel<kD, kDq>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)bh, (unsigned)tiles(skv)), kThreads, smem,
             stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(glse), static_cast<float*>(dq_acc),
        static_cast<float*>(dk), static_cast<float*>(dv), sq, skv, d,
        scale_log2e, scale, causal, vec);
    return (int)cudaGetLastError();
  }
};
template <int kD>
struct Dkv : Bwd<kD, false> {};
template <int kD>
struct Fused : Bwd<kD, true> {};

// F<kD>::run(args...) at head width d, kD its chunks of 8 (4, 8 or 16)
template <template <int> class F, typename... Args>
int by_width(int d, Args... args) {
  if (d <= 32) return F<4>::run(args...);
  if (d <= 64) return F<8>::run(args...);
  return F<16>::run(args...);
}

bool bad_shape(long long bh, int sq, int skv, int d) {
  return bh < 0 || bh > 0x7fffffffLL || sq < 1 || skv < 1 ||
         tiles(sq) > 65535 || tiles(skv) > 65535 || d < 1 || d > kMaxD;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// f32 only: bf16 takes the *_bf16 entries of flash_attn_bf16.cu. q, dO:
// [bh, sq, d]; k, v: [bh, skv, d]; lse, delta, glse: [bh, sq] f32 (glse
// may be NULL for zero); the caller allocates every output.

// B4: o [bh, sq, d], lse [bh, sq]. key_bias: [bh / heads, skv] f32 or NULL.
int azt_flash_fwd(const void* q, const void* k, const void* v,
                  const void* key_bias, void* o, void* lse, long long bh,
                  int sq, int skv, int d, int heads, float scale_log2e,
                  int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d) || heads < 1)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Fwd>(d, q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                       scale_log2e, causal,
                       static_cast<cudaStream_t>(stream));
}

// B5a: dq [bh, sq, d].
int azt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* glse, void* dq, long long bh, int sq,
                     int skv, int d, float scale_log2e, float scale,
                     int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Dq>(d, q, k, v, dout, lse, delta, glse, dq, bh, sq, skv,
                      d, scale_log2e, scale, causal,
                      static_cast<cudaStream_t>(stream));
}

// B5b: dk, dv [bh, skv, d].
int azt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* glse, void* dk, void* dv, long long bh,
                      int sq, int skv, int d, float scale_log2e, float scale,
                      int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Dkv>(d, q, k, v, dout, lse, delta, glse, nullptr, dk, dv,
                       bh, sq, skv, d, scale_log2e, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

// B6: dk, dv [bh, skv, d], and dq added into dq_acc [bh, sq, d] f32,
// which the caller zeroes.
int azt_flash_bwd_fused(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse,
                        const void* delta, const void* glse, void* dq_acc,
                        void* dk, void* dv, long long bh, int sq, int skv,
                        int d, float scale_log2e, float scale, int causal,
                        void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Fused>(d, q, k, v, dout, lse, delta, glse, dq_acc, dk, dv,
                         bh, sq, skv, d, scale_log2e, scale, causal,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
