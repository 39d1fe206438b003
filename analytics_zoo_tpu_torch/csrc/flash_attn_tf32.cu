// Flash attention's f32 route on the tensor cores of Hopper (sm_90a) as
// 3xTF32: the forward (B4) and the two-pass backward's dk/dv pass (B5b).
// The two-pass dq pass (B5a) and the one-pass backward (B6) in f32 run on
// the CUDA cores (flash_attn.cu); bf16 takes flash_attn_bf16.cu.
//
// Replaces the TPU kernels in analytics_zoo_tpu/ops/attention.py:
//   B4  `_flash_fwd_kernel`      (:203, pallas_call in `_flash_fwd_pallas`)
//   B5b `_flash_bwd_dkv_kernel`  (:428, pallas_call in `_flash_bwd_pallas`)
//
// q [bh, sq, d], k and v [bh, skv, d] (f32, contiguous, d <= 128, any
// lengths, sq and skv apart), an optional per-key bias key_bias [bh /
// heads, skv] f32 in natural-log units (B4 only), and an optional causal
// mask aligned top-left (key col visible to query row iff col <= row,
// absolute indices). In f32, as flash_attn.cu:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past skv
//   B4:  m_i = max_j t, l_i = sum_j exp2(t - m_i) by the online softmax
//        over key tiles, o_i = sum_j exp2(t - m_i) v_j / max(l_i, 1e-30),
//        lse_i = m_i * ln 2 + ln(max(l_i, 1e-30))
//   B5b: p = exp2(t - lse_i * log2(e)), dp = dO_i . v_j,
//        ds = p * (dp - D_i + glse_i) with D_i = sum dO_i * o_i (computed
//        by the caller) and glse the lse cotangent (NULL for 0);
//        dk_j = scale * sum_i ds q_i, dv_j = sum_i p dO_i.
//
// Every product (q.k^T and p.v; k.q^T, v.dO^T, p^T.dO and ds^T.q) runs as
// mma.sync m16n8k8 3xTF32 with f32 accumulators on mma_tf32.cuh's
// fragments: each f32 operand split into two TF32 parts at fragment load,
// three TF32 products for one f32-grade product, and an accumulator (p, ds)
// fed back as the next product's A fragment in the permuted reduction
// order. The walk is mma_tf32.cuh's and B7/B8's at one warp a row group:
// a block of four warps owns 64 rows in four row groups of 16 and walks
// the other side in 32-row tiles that cp.async stages into shared memory.
// B7/B8's two warps a row group under eight blocks an SM (split_for) made
// B4 28% and B5b 3% slower at 1024 blocks (the LM's prefill at batch 2)
// on the H100; at 512 blocks B4 2% slower and B5b 2-4% faster; at the
// LM's grids of 2048-4096 blocks split_for picks one (PERF.md).
//
//   B4:  a block per (bh, 64 query rows), Q resident, K/V tiles walked
//        with the online softmax in registers; the blocks with the most
//        causal key tiles launch first. Under the causal mask a block
//        walks only the key tiles at or below its last row, and a warp
//        skips a tile whose keys all lie past its rows. The bias is staged
//        per key tile (bias * log2 e). Rows past sq are computed from zeros
//        and not stored; keys past skv score -inf and weigh exactly 0.
//   B5b: a block per (bh, 64 keys), K and V resident, query tiles walked
//        from the first a causal key tile reaches (its first key's tile);
//        each tile's rows' lse * log2 e, D and glse staged beside it. Per
//        tile S^T = K.Q^T, dP^T = V.dO^T, dv += p^T.dO, dk += ds^T.Q; dk *=
//        scale at the end. No atomics: dk and dv are bit-equal from run to
//        run. Queries past sq carry lse +inf, so p = 0; keys past skv are
//        computed from zeros and not stored; keys no query reaches get 0.
// S^T on the tensor cores is not B5a's S (flash_attn.cu, the CUDA cores)
// bit for bit: the two passes' p differ by rounding, within the route's
// 2e-5 of the output's scale.
//
// The running sums over the walk (B4's o, B5b's dk and dv) and B5b's dP^T
// take each 8-step's three products summed from zero, then one rounded f32
// add (mma3_add). On the H100, summed straight into the running sums, dk
// and dv over 4096 queries missed 2e-5 of scale (4.7e-5); with dP^T summed
// straight, the grid's one query and one key with an lse cotangent came
// to 1.65e-5 (ds = p (dP - D + glse) cancels dP against the caller's D,
// leaving glse), and 4.5e-6 in two levels, at 0-2% more B5b time.
//
// One buffer of walked tiles each, refilled after the tile is consumed: a
// second (the next tile's copy overlapping this one's products) made B4
// 26-29% and B5b 57-62% slower at the LM's shapes on the H100, the blocks
// an SM falling from three to two and from two to one (PERF.md). Shared
// memory at d 128: B4 Q (64 rows), a K and a V tile of 32 keys and their
// bias, 67,712 bytes (three blocks an SM); B5b K and V (64 rows), a Q and
// a dO tile of 32 and their rows' statistics, 101,760 bytes (two blocks
// an SM). Rows are 8 * ceil(d / 8) + 4 floats; at d 64 about half.
//
// Bound (H100 SXM data sheet, not measurements): at the LM's shape (bh 128,
// s 2048, d 128, causal) B4 does 137.5 GFLOP over the pairs the mask
// leaves, 0.834 ms at 3xTF32's 164.9 TFLOP/s (494.7 / 3; 2.052 ms at the
// CUDA cores' 67), against 0.16 ms of bytes at 3.35 TB/s; at the LM's long
// context (bh 32, s 4096, d 128) the same 137.5 GFLOP, and B5b 275 GFLOP,
// 1.667 ms (4.104 at 67): operations bound both.
//
// The TPU kernels kept a whole K/V block in VMEM and carried the softmax
// state (and dk/dv) in scratch across a sequential grid axis. Here blocks
// run in parallel in no order, so each block owns its outputs and walks the
// other side itself in tiles that fit in shared memory.

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

// -- B5b: backward, dk/dv --------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ glse,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int sq, int skv, int d, float scale_log2e,
                          float scale, int causal, int vec) {
  constexpr int ld = 8 * kD + 4;
  constexpr int kN = kTile / 8;  // 8-query steps of a tile
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                              // [kRows][ld]
  float* vs = ks + kRows * ld;                   // [kRows][ld]
  float* qds = vs + kRows * ld;                  // [Q, dO][kTile][ld]
  float* rs = qds + 2 * kTile * ld;              // [3][kTile]
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
    const int qf = qt * kTile;  // the tile's first query

    // a warp whose keys all lie past the tile's queries sees none of them
    if (qf < sq && !(causal && qf + kTile - 1 < first_key)) {
      float sT[kN][4] = {}, dpT[kN][4] = {};  // S^T, dP^T: keys x queries
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
            const float p = exp2f(x - lse2);
            sT[n][idx] = p;
            dpT[n][idx] =
                __fmul_rn(p, __fadd_rn(__fsub_rn(dpT[n][idx], dl), gl));
          }
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
    __syncthreads();  // the tile is consumed before it is refilled
    if (qt + 1 < n_tiles) load_qdo(qt + 1);
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
struct Dkv {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* glse, void* dk, void* dv, long long bh, int sq,
                 int skv, int d, float scale_log2e, float scale, int causal,
                 cudaStream_t stream) {
    const size_t smem = 2 * tile_bytes(kD, kRows) +
                        2 * tile_bytes(kD, kTile) + 3 * sizeof(float) * kTile;
    const int vec = d % 4 == 0 && aligned16({q, k, v, dout});
    auto kernel = flash_bwd_dkv_tf32_kernel<kD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)bh, (unsigned)tiles(skv)), kThreads, smem,
             stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(glse), static_cast<float*>(dk),
        static_cast<float*>(dv), sq, skv, d, scale_log2e, scale, causal,
        vec);
    return (int)cudaGetLastError();
  }
};

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

// B4, f32, on `stream`; returns cudaGetLastError() (0 on success). q, o:
// [bh, sq, d]; k, v: [bh, skv, d]; dtype 0 = f32 (bf16 takes
// azt_flash_fwd_bf16). key_bias: [bh / heads, skv] f32 or NULL. lse: [bh,
// sq] f32. The caller allocates o and lse.
int azt_flash_fwd(const void* q, const void* k, const void* v,
                  const void* key_bias, void* o, void* lse, long long bh,
                  int sq, int skv, int d, int dtype, int heads,
                  float scale_log2e, int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d) || heads < 1 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Fwd>(d, q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                       scale_log2e, causal,
                       static_cast<cudaStream_t>(stream));
}

// B5b, f32, on `stream`: dk, dv [bh, skv, d] f32 (dtype 0; bf16 takes
// azt_flash_bwd_dkv_bf16). lse, delta, glse: [bh, sq] f32 (glse may be
// NULL for zero).
int azt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* glse, void* dk, void* dv, long long bh,
                      int sq, int skv, int d, int dtype, float scale_log2e,
                      float scale, int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  return by_width<Dkv>(d, q, k, v, dout, lse, delta, glse, dk, dv, bh, sq,
                       skv, d, scale_log2e, scale, causal,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
