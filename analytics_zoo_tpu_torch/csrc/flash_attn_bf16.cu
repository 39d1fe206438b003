// Flash attention, bf16 route, on the tensor cores of Hopper (sm_90a): the
// forward (B4), the one-pass backward (B6) and the two-pass backward (B5a
// dq, B5b dk and dv). f32 inputs take the 3xTF32 kernels of
// flash_attn_tf32.cu; the dtype alone picks the route.
//
// Replaces the TPU kernels of analytics_zoo_tpu/ops/attention.py:
// `_flash_fwd_kernel` (pallas_call in `_flash_fwd_pallas`),
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (pallas_calls in
// `_flash_bwd_pallas`) and `_flash_bwd_fused_kernel` (pallas_call in
// `_flash_bwd_fused`). The contract is flash_attn_tf32.cu's: q [bh, sq,
// d], k and v [bh, skv, d] bf16 (contiguous, d <= 256, any lengths, sq and
// skv apart), an optional per-key bias key_bias [bh / heads, skv] f32 in
// natural-log units (B4), an optional causal mask aligned top-left (key
// col visible to query row iff col <= row). Scores, softmax and sums in
// f32:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past skv
//   B4: m_i = max_j t, l_i = sum_j exp2(t - m_i) by the online softmax,
//       o_i = sum_j bf16(exp2(t - m_i)) v_j / max(l_i, 1e-30) (bf16 out),
//       lse_i = m_i * ln 2 + ln(max(l_i, 1e-30)) (f32 out)
//   backward: p = exp2(t - lse_i * log2(e)), dp = dO_i . v_j,
//       ds = p * (dp - D_i + glse_i), D_i the caller's rowsum(dO * o) and
//       glse the lse cotangent (NULL for 0); dv_j = sum_i bf16(p) dO_i,
//       dk_j = scale * sum_i bf16(ds) q_i, dq_i = scale * sum_j bf16(ds) k_j
//       (B6 all three, B5a dq, B5b dk and dv; bf16 out)
//
// p is rounded to bf16 before p.V and p^T.dO, ds before ds.K and ds^T.Q,
// where the TPU kernel rounds them (its `astype` before each product). D
// comes from the caller, rowsum(dO * o) over the bf16 output, as the JAX
// package forms `dd`: B8's extra sweep for an exact D (fused_short_attn_
// bf16.cu) is not needed, since the TPU kernel and the plain version take
// the same D. Every product is mma.sync.m16n8k16 bf16 -> f32 with
// operands from shared memory through ldmatrix (mma_bf16.cuh); scores stay
// in registers, and the C fragment of S (of ds in B5a) packs straight into
// the A fragment of p.V (of ds.K).
//
// B4: a block per (bh, 128 query rows), eight warps of 16 rows each,
// heaviest causal tiles launched first. It walks the key tiles of 64 up to
// the diagonal, K, V and the bias double-buffered by 16-byte cp.async with
// one barrier a tile; a warp whose rows all precede a tile's first key
// skips the tile (its weights are exactly 0). An online softmax in
// registers, O in f32 registers. Shared memory: Q, two stages of K and V
// and of the bias, 102.5 KiB at d 128 (two blocks an SM), 54.5 KiB at d
// 64. Blocks of 256 rows, or two 16-row groups a warp (each K and V
// fragment feeding both, 251 registers), were no faster on the H100: the
// softmax and the staging, not ldmatrix or L2 traffic, hold B4 back
// (scripts/flash_bf16_variants.py times such variants).
//
// B5a: B4's walk. A block per (bh, 128 query rows), eight warps of 16 rows,
// heaviest causal tiles first; Q and dO resident in shared memory, the
// rows' lse, D and glse in registers; K and V tiles double-buffered by
// cp.async with one barrier a tile, a warp skipping keys wholly above its
// rows. Per tile a warp forms S = Q.K^T and dP = dO.V^T in registers, then
// p and ds, and adds bf16(ds).K to dq in f32 registers; dq is stored once,
// times scale. No atomics. At d > 64 a tile holds 32 keys: Q and dO 68
// KiB and K and V 34 KiB of shared memory, two blocks an SM, 96 floats of
// S, dP and dq a thread; 64-key tiles (136 KiB, one block an SM, 184
// registers) took 1.50 ms against 1.18, and walking them as two 32-key
// halves 1.74 (bench_longseq's [4, 8, 4096, 128] on the H100, timed by
// scripts/flash_bf16_variants.py). At d <= 64
// a tile holds 64 keys (72 KiB, two blocks an SM): 1.20 ms against 1.41
// for 32 ([8, 8, 4096, 64]).
//
// B6: a block per (bh, 64 keys), eight warps, K and V resident in shared
// memory; it walks the query tiles of 64 from the diagonal down. Per tile:
// (1) warp (kw, h) = (warp % 4, warp / 4) computes S^T and dP^T for keys
// [16 kw, + 16) and queries [32 h, + 32), p^T and ds^T in registers, and
// stores them in bf16 to shared memory; (2) it adds p^T.dO to dv and
// ds^T.Q to dk for its 16 keys and half h of the head's columns, in f32
// registers (64 a thread at d 128, where a warp holding all 128 columns
// of both would need 128 and B8's dk/dv pass reaches 246); (3) after
// the next Q and dO tiles are requested, warp (qr, cg) = (warp % 4, warp /
// 4) forms this key tile's share of dq for queries [16 qr, + 16) and
// column group cg, ds.K with ds read transposed from shared memory, and
// adds it, times scale, into the f32 buffer dq_acc that the caller
// zeroed: float2 atomics (vector red.global.add on sm_90) where d is even.
// dq therefore sums its key tiles in no fixed order, at most skv / 64
// partial sums; dk and dv are bit-equal from run to run. Each of the five
// products is computed once. Shared memory: K, V, Q, dO, p^T, ds^T and the
// rows' lse, D and glse, 86.75 KiB at d 128 (two blocks an SM), 50.75 KiB
// at d 64. kBwdKeys = 128 (sixteen warps, half the dq atomics and Q, dO
// reloads) was faster at d 128 and slower at d 64 on the H100, so a block
// holds 64.
//
// B5b: B6's kernel without step (3) (the template's kDq false). With no dq
// work to hide the next tile's copy behind, Q and dO take two buffers: the
// next tile's are requested right after the barrier that opens a tile and
// land during steps (1) and (2), two barriers a tile (one buffer: 1.38 ms
// against 1.36 at [4, 8, 4096, 128]). A block holds 128 keys (sixteen
// warps, one block an SM, 172.75 KiB) at d > 64 and 64 keys (eight warps,
// two blocks an SM, 72.75 KiB) at d <= 64: 64 keys at d 128 took 1.93 ms,
// 128 at d 64 1.91 against 1.71. No atomics: dq, dk and dv of B5a + B5b
// are bit-equal from run to run.
//
// Heads wider than 128 (up to 256, one instance of each kernel at 16
// chunks of 16 columns): one block an SM with up to 255 registers a
// thread, since B4's and B5a's output accumulators alone are 128 floats a
// thread. B4 keeps its tiles (198.5 KiB of shared memory), B5a its 32-key
// tiles (198 KiB), B6 and B5b hold 64 keys a block (eight warps; 150.75
// and 216.75 KiB, B5b with its two Q and dO buffers), and B6's dq step
// forms its 128 columns in two groups of 64 one after the other,
// re-reading ds from shared memory, so that its accumulators stay at 32
// floats beside dk's and dv's 128. Registers and spills: chip_smoke.py's
// build line.
//
// Ragged shapes: rows and keys past the lengths load as zeros (cp.async's
// zero fill) and are neither stored nor weighed; d is zero-padded in shared
// memory to a multiple of 16. 16-byte copies where d % 8 == 0 and every
// pointer is 16-byte aligned, else element by element.
//
// Bound at bench_longseq's shape ([4, 8, 4096, 128] causal bf16): the
// products' operations, 4 * d a (row, col) pair in B4 (137.5 GFLOP, 0.139
// ms at 989 TFLOP/s), 10 * d in the one-pass backward (344 GFLOP, 0.348
// ms), 6 * d in B5a (0.209 ms) and 8 * d in B5b (0.278 ms), against 0.02
// to 0.03 ms of bytes at 3.35 TB/s; at 8192 keys four times that (B5a
// 0.834, B5b 1.112 ms) (H100 SXM data sheet, not measurements). mma.sync
// reaches only part of the dense bf16 rate (wgmma, TMA and warp
// specialisation are later work), and the softmax, the masks and the
// staging run on the CUDA cores beside the products: without its two
// products B4 keeps much of its time. Registers and spills: `nvcc -Xptxas
// -v` (chip_smoke.py prints them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

constexpr int kPad = 8;        // bf16 of padding at the end of a smem row
constexpr int kMaxD = 256;
constexpr int kKeyTile = 64;   // keys a staged K or V tile holds
constexpr int kFwdRows = 128;  // B4's query rows a block
constexpr int kFwdThreads = 256;
constexpr int kDqRows = 128;   // B5a's query rows a block
constexpr int kDqThreads = 256;
constexpr int kDqKeysWide = 32;    // keys a staged K or V tile of B5a
constexpr int kDqKeysNarrow = 64;  // holds, at d > 64 and at d <= 64
constexpr int kDqPass = 64;  // the most keys whose scores a B5a warp holds
constexpr int kBwdKeys = 64;   // B6's keys a block
constexpr int kDkvKeysWide = 128;   // B5b's keys a block at 64 < d <= 128
constexpr int kDkvKeysNarrow = 64;  // and at d <= 64 and d > 128
constexpr int kDkvStages = 2;  // B5b's buffers of Q and dO tiles
constexpr int kBwdRows = 64;   // B5b's and B6's query rows a step
constexpr int kDqChunks = 4;   // B6's 16-column chunks of dq formed at once
constexpr float kNegInf = -1e30f;  // a masked score, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// shared memory of an SM, and what the runtime reserves for each block
constexpr int kSmemPerSM = 233472;
constexpr int kSmemReserved = 1024;

int ceil_div(int n, int m) { return (n + m - 1) / m; }

// B5a's keys a staged K or V tile at 16 * kD columns
__host__ __device__ constexpr int dq_keys(int kD) {
  return kD > 4 ? kDqKeysWide : kDqKeysNarrow;
}

// B5a's shared memory at 16 * kD columns: Q, dO, two stages of K and V
__host__ __device__ constexpr int dq_smem_bytes(int kD) {
  return 2 * (2 * kDqRows + 4 * dq_keys(kD)) * (16 * kD + kPad);
}

// B5a's blocks an SM: two where their shared memory fits (128 registers
// a thread), else one
__host__ __device__ constexpr int dq_blocks_per_sm(int kD) {
  return 2 * (dq_smem_bytes(kD) + kSmemReserved) <= kSmemPerSM ? 2 : 1;
}

// B5b's and B6's threads: warps (16 keys, half the query tile) each
__host__ __device__ constexpr int bwd_threads(int keys) {
  return 32 * 2 * keys / 16;
}

// B5b's keys a block at 16 * kD columns: at 16 chunks, 128 keys (512
// threads, at most 128 registers a thread) could not hold dk and dv
__host__ __device__ constexpr int dkv_keys(int kD) {
  return kD > 4 && kD <= 8 ? kDkvKeysWide : kDkvKeysNarrow;
}

// blocks an SM the launch bounds ask for: one (255 registers a thread)
// for heads past 128, whose accumulators need them
__host__ __device__ constexpr int wide_or(int kD, int blocks) {
  return kD > 8 ? 1 : blocks;
}

// 2^x by the special-function unit (ex2.approx: relative error below
// 2^-22, subnormal results flushed to 0); exp2f's range handling cost B4
// and B6 5-12% at bench_longseq's shapes
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- B4: forward -----------------------------------------------------------

// bias * log2(e) of keys [key0, + 64) into bst (0 past skv)
__device__ __forceinline__ void stage_bias(float* bst,
                                           const float* __restrict__ biasb,
                                           int key0, int skv) {
  for (int c = threadIdx.x; c < kKeyTile; c += kFwdThreads)
    bst[c] = key0 + c < skv ? __fmul_rn(biasb[key0 + c], kLog2e) : 0.0f;
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, wide_or(kD, 2))
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ key_bias,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int heads, int sq, int skv, int d, float scale_log2e,
                      int causal, int vec) {
  constexpr int ld = 16 * kD + kPad;
  constexpr int kStage = kKeyTile * ld;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kFwdRows][ld]
  bf16* ks = qs + kFwdRows * ld;              // [2][kKeyTile][ld]
  bf16* vs = ks + 2 * kStage;                 // [2][kKeyTile][ld]
  float* bs = reinterpret_cast<float*>(vs + 2 * kStage);  // [2][kKeyTile]
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;  // heaviest first
  const bf16* kb = k + bh * skv * d;
  const bf16* vb = v + bh * skv * d;
  const float* biasb =
      key_bias != nullptr ? key_bias + (bh / heads) * skv : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 15) / 16;
  const int kend = causal ? min(skv, q0 + kFwdRows) : skv;
  const int n_tiles = (kend + kKeyTile - 1) / kKeyTile;

  if (vec) zero_pad_cols<kFwdThreads>(qs, kFwdRows + 4 * kKeyTile, ld, d);
  load_tile<kFwdRows, kFwdThreads>(qs, ld, q + bh * sq * d, q0, sq, d, vec);
  load_tile<kKeyTile, kFwdThreads>(ks, ld, kb, 0, skv, d, vec);
  load_tile<kKeyTile, kFwdThreads>(vs, ld, vb, 0, skv, d, vec);
  cp_commit();
  if (biasb != nullptr) stage_bias(bs, biasb, 0, skv);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int last_row = q0 + warp * 16 + 15;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[2 * kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    cp_wait<0>();
    // one barrier a tile: tile kt has landed for every warp, and every
    // warp is done with tile kt - 1, whose stage the next tile refills
    // while this one is computed
    __syncthreads();
    if (kt + 1 < n_tiles) {
      const int next = (kt + 1) * kKeyTile;
      load_tile<kKeyTile, kFwdThreads>(ks + (stage ^ 1) * kStage, ld, kb,
                                       next, skv, d, vec);
      load_tile<kKeyTile, kFwdThreads>(vs + (stage ^ 1) * kStage, ld, vb,
                                       next, skv, d, vec);
      cp_commit();
      if (biasb != nullptr)
        stage_bias(bs + (stage ^ 1) * kKeyTile, biasb, next, skv);
    }
    const int key0 = kt * kKeyTile;
    // tile 0 is never skipped (key 0 is visible to every row), so m is
    // finite after it and a skipped tile's weights, exp2(-1e30 - m), are 0
    if (!(causal && key0 > last_row)) {
      const bf16* kst = ks + stage * kStage;
      const bf16* vst = vs + stage * kStage;
      const float* bst = bs + stage * kKeyTile;
      float sc[8][4] = {};
      mma_abt<8, kD>(sc, qs + warp * 16 * ld, kst, ld, kd);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), col = key0 + c;
          float x = __fmul_rn(sc[n][e], scale_log2e);
          if (biasb != nullptr) x = __fadd_rn(x, bst[c]);
          if (col >= skv)
            x = -INFINITY;  // past the end: weighs exactly 0
          else if (causal && col > rows[e / 2])
            x = kNegInf;
          sc[n][e] = x;
          tmax[e / 2] = fmaxf(tmax[e / 2], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // every tile holds a key below skv, so the max is finite
        const float m_new = fmaxf(m[i], quad_max(tmax[i]));
        const float corr = fast_exp2(m[i] - m_new);
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
          const float p = fast_exp2(sc[n][e] - m[e / 2]);
          l[e / 2] += p;
          sc[n][e] = p;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + j * 16 < skv) {
          uint32_t af[4];
          to_a<8>(af, sc, j);  // p rounded to bf16, as the TPU kernel
          mma_ax<kD>(acc, af, vst + j * 16 * ld, ld, kd);
        }
      }
    }
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n) {
    acc[n][0] = __fdiv_rn(acc[n][0], den[0]);
    acc[n][1] = __fdiv_rn(acc[n][1], den[0]);
    acc[n][2] = __fdiv_rn(acc[n][2], den[1]);
    acc[n][3] = __fdiv_rn(acc[n][3], den[1]);
  }
  stage_acc<kD>(qs, ld, acc, 1.0f);  // the warp's own Q rows
  store_warp_rows(o + bh * sq * d, qs, ld, q0, sq, d, vec);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < sq) lse[bh * sq + rows[i]] = m[i] * kLn2 + logf(den[i]);
  }
}

// -- B5a: two-pass backward, dq ---------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kDqThreads, dq_blocks_per_sm(kD))
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ glse,
                         bf16* __restrict__ dq, int sq, int skv, int d,
                         float scale_log2e, float scale, int causal,
                         int vec) {
  constexpr int kKeys = dq_keys(kD);
  constexpr int kPass = kKeys < kDqPass ? kKeys : kDqPass;
  constexpr int ld = 16 * kD + kPad;
  constexpr int kStage = kKeys * ld;
  constexpr int kN = kPass / 8;  // n-tiles of a pass's scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kDqRows][ld]
  bf16* dos = qs + kDqRows * ld;              // [kDqRows][ld]
  bf16* ks = dos + kDqRows * ld;              // [2][kKeys][ld]
  bf16* vs = ks + 2 * kStage;                 // [2][kKeys][ld]
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // heaviest first
  const bf16* kb = k + bh * skv * d;
  const bf16* vb = v + bh * skv * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kd = (d + 15) / 16;
  const int kend = causal ? min(skv, q0 + kDqRows) : skv;
  const int n_tiles = (kend + kKeys - 1) / kKeys;

  if (vec) zero_pad_cols<kDqThreads>(qs, 2 * kDqRows + 4 * kKeys, ld, d);
  load_tile<kDqRows, kDqThreads>(qs, ld, q + bh * sq * d, q0, sq, d, vec);
  load_tile<kDqRows, kDqThreads>(dos, ld, dout + bh * sq * d, q0, sq, d,
                                 vec);
  load_tile<kKeys, kDqThreads>(ks, ld, kb, 0, skv, d, vec);
  load_tile<kKeys, kDqThreads>(vs, ld, vb, 0, skv, d, vec);
  cp_commit();

  // the rows' statistics in registers: lse * log2(e), D and glse
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int last_row = q0 + warp * 16 + 15;
  const bool live = q0 + warp * 16 < sq;  // the warp holds a row below sq
  float lse2[2], dl[2], gl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < sq;
    const long long r = bh * sq + rows[i];
    lse2[i] = in ? __fmul_rn(lse[r], kLog2e) : INFINITY;
    dl[i] = in ? delta[r] : 0.0f;
    gl[i] = in && glse != nullptr ? glse[r] : 0.0f;
  }
  float acc[2 * kD][4] = {};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    cp_wait<0>();
    // one barrier a tile, as B4: tile kt has landed, and every warp is
    // done with tile kt - 1, whose stage the next tile refills
    __syncthreads();
    if (kt + 1 < n_tiles) {
      const int next = (kt + 1) * kKeys;
      load_tile<kKeys, kDqThreads>(ks + (stage ^ 1) * kStage, ld, kb, next,
                                   skv, d, vec);
      load_tile<kKeys, kDqThreads>(vs + (stage ^ 1) * kStage, ld, vb, next,
                                   skv, d, vec);
      cp_commit();
    }
    const bf16* kst = ks + stage * kStage;
    const bf16* vst = vs + stage * kStage;
#pragma unroll
    for (int ps = 0; ps < kKeys / kPass; ++ps) {
      const int key0 = kt * kKeys + ps * kPass;
      // keys past skv, or wholly above the warp's rows: ds is exactly 0
      if (!live || key0 >= skv || (causal && key0 > last_row)) continue;
      float sc[kN][4] = {}, dp[kN][4] = {};
      mma_abt<kN, kD>(sc, qs + warp * 16 * ld, kst + ps * kPass * ld, ld, kd);
      mma_abt<kN, kD>(dp, dos + warp * 16 * ld, vst + ps * kPass * ld, ld,
                      kd);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, col = key0 + n * 8 + 2 * t + (e & 1);
          float p = 0.0f;
          if (col < skv && rows[i] < sq && !(causal && col > rows[i]))
            p = fast_exp2(__fmul_rn(sc[n][e], scale_log2e) - lse2[i]);
          sc[n][e] = __fmul_rn(
              p, __fadd_rn(__fsub_rn(dp[n][e], dl[i]), gl[i]));  // ds
        }
#pragma unroll
      for (int j = 0; j < kPass / 16; ++j) {
        if (key0 + j * 16 < skv) {
          uint32_t af[4];
          to_a<kN>(af, sc, j);  // ds rounded to bf16, as the TPU kernel
          mma_ax<kD>(acc, af, kst + (ps * kPass + j * 16) * ld, ld, kd);
        }
      }
    }
  }

  stage_acc<kD>(qs, ld, acc, scale);  // the warp's own Q rows
  store_warp_rows(dq + bh * sq * d, qs, ld, q0, sq, d, vec);
}

// -- B5b and B6: backward over the queries of one key block ----------------

// acc (16 rows x 8 * kN columns, fragments) times `scale` added into the
// f32 rows [row0, + 16) below sq, columns [col0, ...) below d, of dqb
template <int kN>
__device__ __forceinline__ void add_dq(float* __restrict__ dqb,
                                       const float (&acc)[kN][4], int row0,
                                       int col0, int sq, int d, float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool pairs = d % 2 == 0;  // (col, col + 1) 8-byte aligned, in range
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= sq) continue;
    float* out = dqb + (long long)row * d;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int col = col0 + n * 8 + 2 * t;
      if (col >= d) continue;
      const float a = __fmul_rn(acc[n][2 * i], scale);
      const float b = __fmul_rn(acc[n][2 * i + 1], scale);
      if (pairs) {
        atomicAdd(reinterpret_cast<float2*>(out + col), make_float2(a, b));
      } else {
        atomicAdd(out + col, a);
        if (col + 1 < d) atomicAdd(out + col + 1, b);
      }
    }
  }
}

// acc (the warp's 16 rows x 8 * kN columns) times `mul`, as bf16 into
// rows [row0, + 16), columns [col0, ...) of the staged tile xs
template <int kN>
__device__ __forceinline__ void stage_frag(bf16* xs, int ld, int row0,
                                           int col0,
                                           const float (&acc)[kN][4],
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  bf16* row = xs + (row0 + g) * ld + col0 + 2 * t;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    *reinterpret_cast<uint32_t*>(row + n * 8) =
        pack_bf16(__fmul_rn(acc[n][0], mul), __fmul_rn(acc[n][1], mul));
    *reinterpret_cast<uint32_t*>(row + 8 * ld + n * 8) =
        pack_bf16(__fmul_rn(acc[n][2], mul), __fmul_rn(acc[n][3], mul));
  }
}

// the block's kKeys staged rows of xs to out rows row0 + r below s,
// columns below d
template <int kKeys>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const bf16* xs, int ld, int row0,
                                           int s, int d, bool vec) {
  constexpr int kThreads = bwd_threads(kKeys);
  if (vec) {
    const int chunks = d / 8;
    for (int i = threadIdx.x; i < kKeys * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      if (row0 + r < s)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(xs + r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      if (row0 + r < s) out[(long long)(row0 + r) * d + c] = xs[r * ld + c];
    }
  }
}

// B6 (kDq true): dk, dv, and dq added into dq_acc with atomics; one buffer
// of Q and dO, refilled during step (3). B5b (kDq false): dk and dv alone;
// kDkvStages buffers of Q and dO, the next tile's filled during steps (1)
// and (2).
template <int kD, int kKeys, bool kDq>
__global__ void __launch_bounds__(
    bwd_threads(kKeys),
    wide_or(kD, 512 / bwd_threads(kKeys)))  // 128 registers; 255 past d 128
flash_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ glse,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int sq, int skv, int d,
                      float scale_log2e, float scale, int causal, int vec) {
  constexpr int kThreads = bwd_threads(kKeys);
  constexpr int kWarps = kThreads / 32;
  constexpr int kStages = kDq ? 1 : kDkvStages;
  constexpr int ld = 16 * kD + kPad;
  constexpr int kDh = kD / 2;           // 16-column chunks of half of d
  constexpr int ldp = kBwdRows + kPad;  // p^T, ds^T: keys x queries
  constexpr int kKW = kKeys / 16;       // warps along the keys
  constexpr int kCG = kWarps / 4;       // dq's column groups
  constexpr int kDg = kD / kCG > 0 ? kD / kCG : 1;  // chunks of a group
  constexpr int kTile = kBwdRows * ld;  // a staged Q or dO tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kKeys][ld]
  bf16* vs = ks + kKeys * ld;                 // [kKeys][ld]
  bf16* qs = vs + kKeys * ld;                 // [kStages][kBwdRows][ld]
  bf16* dos = qs + kStages * kTile;           // [kStages][kBwdRows][ld]
  bf16* pts = dos + kStages * kTile;          // [kKeys][ldp]
  bf16* dsts = pts + kKeys * ldp;             // [kKeys][ldp]
  float* lse2s = reinterpret_cast<float*>(dsts + kKeys * ldp);  // [64]
  float* dls = lse2s + kBwdRows;                                // [64]
  float* gls = dls + kBwdRows;                                  // [64]
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;  // the first key tiles see the most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = warp % kKW, h = warp / kKW;
  const int kd = (d + 15) / 16;
  const int c0 = h * kDh, kdh = min(kDh, kd - c0);  // this warp's columns
  const bf16* qb = q + bh * sq * d;
  const bf16* dob = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;
  const float* glseb = glse != nullptr ? glse + bh * sq : nullptr;
  // the first query tile a causal key tile reaches: rows at or past k0
  const int qbeg = causal ? k0 / kBwdRows * kBwdRows : 0;

  if (vec)
    zero_pad_cols<kThreads>(ks, 2 * kKeys + 2 * kStages * kBwdRows, ld, d);
  load_tile<kKeys, kThreads>(ks, ld, k + bh * skv * d, k0, skv, d, vec);
  load_tile<kKeys, kThreads>(vs, ld, v + bh * skv * d, k0, skv, d, vec);
  if (qbeg < sq) {
    load_tile<kBwdRows, kThreads>(qs, ld, qb, qbeg, sq, d, vec);
    load_tile<kBwdRows, kThreads>(dos, ld, dob, qbeg, sq, d, vec);
  }
  cp_commit();

  const int keys[2] = {k0 + kw * 16 + g, k0 + kw * 16 + g + 8};
  float acc_k[2 * kDh][4] = {}, acc_v[2 * kDh][4] = {};
  int stage = 0;  // the buffer of this tile's Q and dO
  for (int q0 = qbeg; q0 < sq; q0 += kBwdRows) {
    // this tile's row statistics; phase 1 of the previous tile, their last
    // reader, is past a barrier
    if (threadIdx.x < kBwdRows) {
      const int r = q0 + threadIdx.x;
      const bool in = r < sq;
      lse2s[threadIdx.x] = in ? lseb[r] * kLog2e : INFINITY;
      dls[threadIdx.x] = in ? deltab[r] : 0.0f;
      gls[threadIdx.x] = in && glseb != nullptr ? glseb[r] : 0.0f;
    }
    cp_wait<0>();
    __syncthreads();
    const bf16* qst = qs + stage * kTile;
    const bf16* dost = dos + stage * kTile;
    if constexpr (kStages > 1) {
      // every warp is past the previous tile, whose buffer the next tile
      // fills while this one is computed
      if (q0 + kBwdRows < sq) {
        const int nxt = (stage + 1) % kStages;
        load_tile<kBwdRows, kThreads>(qs + nxt * kTile, ld, qb,
                                      q0 + kBwdRows, sq, d, vec);
        load_tile<kBwdRows, kThreads>(dos + nxt * kTile, ld, dob,
                                      q0 + kBwdRows, sq, d, vec);
        cp_commit();
      }
    }

    // (1) S^T and dP^T for keys [16 kw, + 16) x queries [32 h, + 32)
    {
      float st[4][4] = {}, dpt[4][4] = {};
      mma_abt<4, kD>(st, ks + kw * 16 * ld, qst + h * 32 * ld, ld, kd);
      mma_abt<4, kD>(dpt, vs + kw * 16 * ld, dost + h * 32 * ld, ld, kd);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e / 2];
          const int qi = h * 32 + n * 8 + 2 * t + (e & 1), row = q0 + qi;
          float p = 0.0f;
          if (key < skv && row < sq && !(causal && key > row))
            p = fast_exp2(__fmul_rn(st[n][e], scale_log2e) - lse2s[qi]);
          st[n][e] = p;
          dpt[n][e] = __fmul_rn(
              p, __fadd_rn(__fsub_rn(dpt[n][e], dls[qi]), gls[qi]));
        }
      bf16* pr = pts + (kw * 16 + g) * ldp + h * 32 + 2 * t;
      bf16* dr = dsts + (kw * 16 + g) * ldp + h * 32 + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(pr + n * 8) =
            pack_bf16(st[n][0], st[n][1]);
        *reinterpret_cast<uint32_t*>(pr + 8 * ldp + n * 8) =
            pack_bf16(st[n][2], st[n][3]);
        *reinterpret_cast<uint32_t*>(dr + n * 8) =
            pack_bf16(dpt[n][0], dpt[n][1]);
        *reinterpret_cast<uint32_t*>(dr + 8 * ldp + n * 8) =
            pack_bf16(dpt[n][2], dpt[n][3]);
      }
    }
    __syncthreads();

    // (2) dv += p^T dO, dk += ds^T Q: keys [16 kw, + 16), columns half h
    if (kdh > 0) {
      const bf16* pa = pts + (kw * 16 + lane % 16) * ldp + (lane / 16) * 8;
      const bf16* da = dsts + (kw * 16 + lane % 16) * ldp + (lane / 16) * 8;
#pragma unroll
      for (int j = 0; j < kBwdRows / 16; ++j) {
        if (q0 + j * 16 < sq) {
          uint32_t af[4];
          ldsm_x4(af, pa + j * 16);
          mma_ax<kDh>(acc_v, af, dost + j * 16 * ld + c0 * 16, ld, kdh);
          ldsm_x4(af, da + j * 16);
          mma_ax<kDh>(acc_k, af, qst + j * 16 * ld + c0 * 16, ld, kdh);
        }
      }
    }

    if constexpr (kStages == 1) {
      __syncthreads();  // Q and dO are consumed
      if (q0 + kBwdRows < sq) {  // the next tile's Q and dO load meanwhile
        load_tile<kBwdRows, kThreads>(qs, ld, qb, q0 + kBwdRows, sq, d, vec);
        load_tile<kBwdRows, kThreads>(dos, ld, dob, q0 + kBwdRows, sq, d,
                                      vec);
        cp_commit();
      }
    } else {
      stage = (stage + 1) % kStages;
    }

    if constexpr (kDq) {
      // (3) dq += ds K for queries [16 qr, + 16), column group cg; ds
      // (queries x keys) read transposed from ds^T
      // in groups of at most kDqChunks (two groups at d > 128)
      constexpr int kDs = kDg < kDqChunks ? kDg : kDqChunks;
      const int qr = warp % 4;
      const bf16* da = dsts + ((lane / 16) * 8 + lane % 8) * ldp + qr * 16 +
                       ((lane / 8) % 2) * 8;
#pragma unroll
      for (int sub = 0; sub < kDg / kDs; ++sub) {
        const int cq = warp / 4 * kDg + sub * kDs;
        const int kdq = min(kDs, kd - cq);
        if (kdq > 0) {
          float acc_q[2 * kDs][4] = {};
#pragma unroll
          for (int kc = 0; kc < kKeys / 16; ++kc) {
            if (k0 + kc * 16 < skv) {
              uint32_t af[4];
              ldsm_x4_t(af, da + kc * 16 * ldp);
              mma_ax<kDs>(acc_q, af, ks + kc * 16 * ld + cq * 16, ld, kdq);
            }
          }
          add_dq<2 * kDs>(dq_acc + bh * sq * d, acc_q, q0 + qr * 16, cq * 16,
                          sq, d, scale);
        }
      }
    }
  }

  cp_wait<0>();     // K and V have landed, also where no query tile ran
  __syncthreads();  // every warp is done reading K and V
  stage_frag<2 * kDh>(ks, ld, kw * 16, c0 * 16, acc_k, scale);
  stage_frag<2 * kDh>(vs, ld, kw * 16, c0 * 16, acc_v, 1.0f);
  __syncthreads();
  store_rows<kKeys>(dk + bh * skv * d, ks, ld, k0, skv, d, vec);
  store_rows<kKeys>(dv + bh * skv * d, vs, ld, k0, skv, d, vec);
}

// -- launches --------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

size_t rows_bytes(int kD, int rows) {
  return sizeof(bf16) * (size_t)rows * (16 * kD + kPad);
}

template <int kD>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* key_bias, void* o, void* lse, long long bh,
               int heads, int sq, int skv, int d, float scale_log2e,
               int causal, cudaStream_t stream) {
  const size_t smem = rows_bytes(kD, kFwdRows + 4 * kKeyTile) +
                      sizeof(float) * 2 * kKeyTile;
  const int vec = d % 8 == 0 && aligned16({q, k, v, o});
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<kD>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_bf16_kernel<kD><<<
      dim3((unsigned)bh, (unsigned)ceil_div(sq, kFwdRows)), kFwdThreads, smem,
      stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(key_bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, skv, d,
      scale_log2e, causal, vec);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* glse, void* dq,
              long long bh, int sq, int skv, int d, float scale_log2e,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(kD);
  const int vec = d % 8 == 0 && aligned16({q, k, v, dout, dq});
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<kD>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<kD><<<
      dim3((unsigned)bh, (unsigned)ceil_div(sq, kDqRows)), kDqThreads, smem,
      stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<bf16*>(dq), sq, skv, d,
      scale_log2e, scale, causal, vec);
  return (int)cudaGetLastError();
}

// B6 (kDq true, dq added into dq_acc) or B5b (kDq false, dq_acc unused)
template <int kD, int kKeys, bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* glse,
               void* dq_acc, void* dk, void* dv, long long bh, int sq,
               int skv, int d, float scale_log2e, float scale, int causal,
               cudaStream_t stream) {
  constexpr int kStages = kDq ? 1 : kDkvStages;
  const size_t smem = rows_bytes(kD, 2 * kKeys + 2 * kStages * kBwdRows) +
                      sizeof(bf16) * 2 * kKeys * (kBwdRows + kPad) +
                      sizeof(float) * 3 * kBwdRows;
  const int vec = d % 8 == 0 && aligned16({q, k, v, dout, dk, dv});
  auto kernel = flash_bwd_bf16_kernel<kD, kKeys, kDq>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)bh, (unsigned)ceil_div(skv, kKeys)),
           bwd_threads(kKeys), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(glse), static_cast<float*>(dq_acc),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv, d,
      scale_log2e, scale, causal, vec);
  return (int)cudaGetLastError();
}

bool bad_shape(long long bh, int sq, int skv, int d) {
  return bh < 0 || bh > 0x7fffffffLL || sq < 1 || skv < 1 ||
         ceil_div(sq, kFwdRows) > 65535 || ceil_div(skv, kKeyTile) > 65535 ||
         d < 1 || d > kMaxD;
}

}  // namespace

extern "C" {

// B4, bf16 route, on `stream`; returns cudaGetLastError() (0 on success).
// q, o: [bh, sq, d] bf16; k, v: [bh, skv, d] bf16; key_bias: [bh / heads,
// skv] f32 or NULL; lse: [bh, sq] f32. The caller allocates o and lse.
int azt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const void* key_bias, void* o, void* lse, long long bh,
                       int sq, int skv, int d, int heads, float scale_log2e,
                       int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d) || heads < 1)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_fwd<2>(q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                         scale_log2e, causal, st);
  if (d <= 64)
    return launch_fwd<4>(q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                         scale_log2e, causal, st);
  if (d <= 128)
    return launch_fwd<8>(q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                         scale_log2e, causal, st);
  return launch_fwd<16>(q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
                        scale_log2e, causal, st);
}

// B6, bf16 route, on `stream`: dk, dv [bh, skv, d] bf16, and dq added into
// dq_acc [bh, sq, d] f32, which the caller zeroes. lse, delta, glse: [bh,
// sq] f32 (glse may be NULL for zero).
int azt_flash_bwd_fused_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* glse,
                             void* dq_acc, void* dk, void* dv, long long bh,
                             int sq, int skv, int d, float scale_log2e,
                             float scale, int causal, void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_bwd<2, kBwdKeys, true>(q, k, v, dout, lse, delta, glse,
                                         dq_acc, dk, dv, bh, sq, skv, d,
                                         scale_log2e, scale, causal, st);
  if (d <= 64)
    return launch_bwd<4, kBwdKeys, true>(q, k, v, dout, lse, delta, glse,
                                         dq_acc, dk, dv, bh, sq, skv, d,
                                         scale_log2e, scale, causal, st);
  if (d <= 128)
    return launch_bwd<8, kBwdKeys, true>(q, k, v, dout, lse, delta, glse,
                                         dq_acc, dk, dv, bh, sq, skv, d,
                                         scale_log2e, scale, causal, st);
  return launch_bwd<16, kBwdKeys, true>(q, k, v, dout, lse, delta, glse,
                                        dq_acc, dk, dv, bh, sq, skv, d,
                                        scale_log2e, scale, causal, st);
}

// B5a, bf16 route, on `stream`: dq [bh, sq, d] bf16. lse, delta, glse:
// [bh, sq] f32 (glse may be NULL for zero).
int azt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* glse, void* dq,
                          long long bh, int sq, int skv, int d,
                          float scale_log2e, float scale, int causal,
                          void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_dq<2>(q, k, v, dout, lse, delta, glse, dq, bh, sq, skv, d,
                        scale_log2e, scale, causal, st);
  if (d <= 64)
    return launch_dq<4>(q, k, v, dout, lse, delta, glse, dq, bh, sq, skv, d,
                        scale_log2e, scale, causal, st);
  if (d <= 128)
    return launch_dq<8>(q, k, v, dout, lse, delta, glse, dq, bh, sq, skv, d,
                        scale_log2e, scale, causal, st);
  return launch_dq<16>(q, k, v, dout, lse, delta, glse, dq, bh, sq, skv, d,
                       scale_log2e, scale, causal, st);
}

// B5b, bf16 route, on `stream`: dk, dv [bh, skv, d] bf16.
int azt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* glse, void* dk,
                           void* dv, long long bh, int sq, int skv, int d,
                           float scale_log2e, float scale, int causal,
                           void* stream) {
  if (bad_shape(bh, sq, skv, d)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_bwd<2, dkv_keys(2), false>(
        q, k, v, dout, lse, delta, glse, nullptr, dk, dv, bh, sq, skv, d,
        scale_log2e, scale, causal, st);
  if (d <= 64)
    return launch_bwd<4, dkv_keys(4), false>(
        q, k, v, dout, lse, delta, glse, nullptr, dk, dv, bh, sq, skv, d,
        scale_log2e, scale, causal, st);
  if (d <= 128)
    return launch_bwd<8, dkv_keys(8), false>(
        q, k, v, dout, lse, delta, glse, nullptr, dk, dv, bh, sq, skv, d,
        scale_log2e, scale, causal, st);
  return launch_bwd<16, dkv_keys(16), false>(
      q, k, v, dout, lse, delta, glse, nullptr, dk, dv, bh, sq, skv, d,
      scale_log2e, scale, causal, st);
}

}  // extern "C"
