// Flash attention, bf16 route, on the tensor cores of Hopper (sm_90a): the
// forward (B4) and the one-pass backward (B6). f32 inputs, and the
// two-pass backward (B5a, B5b) in both dtypes, take the CUDA-core kernels
// of flash_attn.cu; the dtype alone picks the route.
//
// Replaces the TPU kernels `_flash_fwd_kernel` (pallas_call in
// `_flash_fwd_pallas`) and `_flash_bwd_fused_kernel` (pallas_call in
// `_flash_bwd_fused`) of analytics_zoo_tpu/ops/attention.py. The contract
// is flash_attn.cu's: q [bh, sq, d], k and v [bh, skv, d] bf16 (contiguous,
// d <= 128, any lengths, sq and skv apart), an optional per-key bias
// key_bias [bh / heads, skv] f32 in natural-log units (B4), an optional
// causal mask aligned top-left (key col visible to query row iff col <=
// row). Scores, softmax and sums in f32:
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)
//   t[i, j] = -1e30 where causal and j > i;  -inf for keys past skv
//   B4: m_i = max_j t, l_i = sum_j exp2(t - m_i) by the online softmax,
//       o_i = sum_j bf16(exp2(t - m_i)) v_j / max(l_i, 1e-30) (bf16 out),
//       lse_i = m_i * ln 2 + ln(max(l_i, 1e-30)) (f32 out)
//   B6: p = exp2(t - lse_i * log2(e)), dp = dO_i . v_j,
//       ds = p * (dp - D_i + glse_i), D_i the caller's rowsum(dO * o) and
//       glse the lse cotangent (NULL for 0); dv_j = sum_i bf16(p) dO_i,
//       dk_j = scale * sum_i bf16(ds) q_i, dq_i = scale * sum_j bf16(ds) k_j
//
// p is rounded to bf16 before p.V and p^T.dO, ds before ds.K and ds^T.Q,
// where the TPU kernel rounds them (its `astype` before each product). D
// comes from the caller, rowsum(dO * o) over the bf16 output, as the JAX
// package forms `dd`: B8's extra sweep for an exact D (fused_short_attn_
// bf16.cu) is not needed, since the TPU kernel and the plain version take
// the same D. Every product is mma.sync.m16n8k16 bf16 -> f32 with
// operands from shared memory through ldmatrix (mma_bf16.cuh); scores stay
// in registers, and the C fragment of S packs straight into the A fragment
// of p.V.
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
// adds it, times
// scale, into the f32 buffer dq_acc that the caller zeroed: float2
// atomics (vector red.global.add on sm_90) where d is even. dq therefore
// sums its key tiles in no fixed order, at most skv / 64 partial sums; dk
// and dv are bit-equal from run to run. Each of the five products is
// computed once. Shared memory: K, V, Q, dO, p^T, ds^T and the rows' lse,
// D and glse, 86.75 KiB at d 128 (two blocks an SM), 50.75 KiB at d 64.
// kBwdKeys = 128 (sixteen warps, half the dq atomics and Q, dO reloads)
// was faster at d 128 and slower at d 64 on the H100, so a block holds 64.
//
// Ragged shapes: rows and keys past the lengths load as zeros (cp.async's
// zero fill) and are neither stored nor weighed; d is zero-padded in shared
// memory to a multiple of 16. 16-byte copies where d % 8 == 0 and every
// pointer is 16-byte aligned, else element by element.
//
// Bound at bench_longseq's shape ([4, 8, 4096, 128] causal bf16): the
// products' operations, 4 * d a (row, col) pair in B4 (137.5 GFLOP, 0.139
// ms at 989 TFLOP/s) and 10 * d in the backward (344 GFLOP, 0.348 ms),
// against 0.02 and 0.03 ms of bytes at 3.35 TB/s (H100 SXM data sheet,
// not measurements). mma.sync reaches only part of the dense bf16 rate
// (wgmma, TMA and warp specialisation are later work), and the softmax,
// the masks and the staging run on the CUDA cores beside the products:
// without its two products B4 keeps much of its time. Registers and
// spills: `nvcc -Xptxas -v` (chip_smoke.py prints them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

constexpr int kPad = 8;        // bf16 of padding at the end of a smem row
constexpr int kMaxD = 128;
constexpr int kKeyTile = 64;   // keys a staged K or V tile holds
constexpr int kFwdRows = 128;  // B4's query rows a block
constexpr int kFwdThreads = 256;
constexpr int kBwdKeys = 64;   // B6's keys a block
constexpr int kBwdRows = 64;   // B6's query rows a step
constexpr int kBwdWarps = 2 * kBwdKeys / 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdBlocksPerSM = 512 / kBwdThreads;  // 128 registers
constexpr float kNegInf = -1e30f;  // a masked score, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

int ceil_div(int n, int m) { return (n + m - 1) / m; }

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
__global__ void __launch_bounds__(kFwdThreads, 2)
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

// -- B6: one-pass backward -------------------------------------------------

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

// the block's kBwdKeys staged rows of xs to out rows row0 + r below s,
// columns below d
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const bf16* xs, int ld, int row0,
                                           int s, int d, bool vec) {
  if (vec) {
    const int chunks = d / 8;
    for (int i = threadIdx.x; i < kBwdKeys * chunks; i += kBwdThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      if (row0 + r < s)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(xs + r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < kBwdKeys * d; i += kBwdThreads) {
      const int r = i / d, c = i - r * d;
      if (row0 + r < s) out[(long long)(row0 + r) * d + c] = xs[r * ld + c];
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
flash_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ glse,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int sq, int skv, int d,
                      float scale_log2e, float scale, int causal, int vec) {
  constexpr int ld = 16 * kD + kPad;
  constexpr int kDh = kD / 2;           // 16-column chunks of half of d
  constexpr int ldp = kBwdRows + kPad;  // p^T, ds^T: keys x queries
  constexpr int kKW = kBwdKeys / 16;    // warps along the keys
  constexpr int kCG = kBwdWarps / 4;    // dq's column groups
  constexpr int kDg = kD / kCG > 0 ? kD / kCG : 1;  // chunks of a group
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kBwdKeys][ld]
  bf16* vs = ks + kBwdKeys * ld;              // [kBwdKeys][ld]
  bf16* qs = vs + kBwdKeys * ld;              // [kBwdRows][ld]
  bf16* dos = qs + kBwdRows * ld;             // [kBwdRows][ld]
  bf16* pts = dos + kBwdRows * ld;            // [kBwdKeys][ldp]
  bf16* dsts = pts + kBwdKeys * ldp;          // [kBwdKeys][ldp]
  float* lse2s = reinterpret_cast<float*>(dsts + kBwdKeys * ldp);  // [64]
  float* dls = lse2s + kBwdRows;                                   // [64]
  float* gls = dls + kBwdRows;                                     // [64]
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdKeys;  // the first key tiles see the most
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

  if (vec) zero_pad_cols<kBwdThreads>(ks, 2 * kBwdKeys + 2 * kBwdRows, ld, d);
  load_tile<kBwdKeys, kBwdThreads>(ks, ld, k + bh * skv * d, k0, skv, d, vec);
  load_tile<kBwdKeys, kBwdThreads>(vs, ld, v + bh * skv * d, k0, skv, d, vec);
  if (qbeg < sq) {
    load_tile<kBwdRows, kBwdThreads>(qs, ld, qb, qbeg, sq, d, vec);
    load_tile<kBwdRows, kBwdThreads>(dos, ld, dob, qbeg, sq, d, vec);
  }
  cp_commit();

  const int keys[2] = {k0 + kw * 16 + g, k0 + kw * 16 + g + 8};
  float acc_k[2 * kDh][4] = {}, acc_v[2 * kDh][4] = {};
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

    // (1) S^T and dP^T for keys [16 kw, + 16) x queries [32 h, + 32)
    {
      float st[4][4] = {}, dpt[4][4] = {};
      mma_abt<4, kD>(st, ks + kw * 16 * ld, qs + h * 32 * ld, ld, kd);
      mma_abt<4, kD>(dpt, vs + kw * 16 * ld, dos + h * 32 * ld, ld, kd);
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
          mma_ax<kDh>(acc_v, af, dos + j * 16 * ld + c0 * 16, ld, kdh);
          ldsm_x4(af, da + j * 16);
          mma_ax<kDh>(acc_k, af, qs + j * 16 * ld + c0 * 16, ld, kdh);
        }
      }
    }
    __syncthreads();  // Q and dO are consumed

    if (q0 + kBwdRows < sq) {  // the next tile's Q and dO load meanwhile
      load_tile<kBwdRows, kBwdThreads>(qs, ld, qb, q0 + kBwdRows, sq, d,
                                       vec);
      load_tile<kBwdRows, kBwdThreads>(dos, ld, dob, q0 + kBwdRows, sq, d,
                                       vec);
      cp_commit();
    }

    // (3) dq += ds K for queries [16 qr, + 16), column group cg; ds
    // (queries x keys) read transposed from ds^T
    const int qr = warp % 4, cq = warp / 4 * kDg;
    const int kdq = min(kDg, kd - cq);
    if (kdq > 0) {
      float acc_q[2 * kDg][4] = {};
      const bf16* da = dsts + ((lane / 16) * 8 + lane % 8) * ldp + qr * 16 +
                       ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kc = 0; kc < kBwdKeys / 16; ++kc) {
        if (k0 + kc * 16 < skv) {
          uint32_t af[4];
          ldsm_x4_t(af, da + kc * 16 * ldp);
          mma_ax<kDg>(acc_q, af, ks + kc * 16 * ld + cq * 16, ld, kdq);
        }
      }
      add_dq<2 * kDg>(dq_acc + bh * sq * d, acc_q, q0 + qr * 16, cq * 16,
                      sq, d, scale);
    }
  }

  cp_wait<0>();     // K and V have landed, also where no query tile ran
  __syncthreads();  // every warp is done reading K and V
  stage_frag<2 * kDh>(ks, ld, kw * 16, c0 * 16, acc_k, scale);
  stage_frag<2 * kDh>(vs, ld, kw * 16, c0 * 16, acc_v, 1.0f);
  __syncthreads();
  store_rows(dk + bh * skv * d, ks, ld, k0, skv, d, vec);
  store_rows(dv + bh * skv * d, vs, ld, k0, skv, d, vec);
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
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* glse,
               void* dq_acc, void* dk, void* dv, long long bh, int sq,
               int skv, int d, float scale_log2e, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = rows_bytes(kD, 2 * kBwdKeys + 2 * kBwdRows) +
                      sizeof(bf16) * 2 * kBwdKeys * (kBwdRows + kPad) +
                      sizeof(float) * 3 * kBwdRows;
  const int vec = d % 8 == 0 && aligned16({q, k, v, dout, dk, dv});
  cudaError_t err = allow_smem(flash_bwd_bf16_kernel<kD>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_kernel<kD><<<
      dim3((unsigned)bh, (unsigned)ceil_div(skv, kBwdKeys)), kBwdThreads,
      smem, stream>>>(
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
  return launch_fwd<8>(q, k, v, key_bias, o, lse, bh, heads, sq, skv, d,
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
    return launch_bwd<2>(q, k, v, dout, lse, delta, glse, dq_acc, dk, dv, bh,
                         sq, skv, d, scale_log2e, scale, causal, st);
  if (d <= 64)
    return launch_bwd<4>(q, k, v, dout, lse, delta, glse, dq_acc, dk, dv, bh,
                         sq, skv, d, scale_log2e, scale, causal, st);
  return launch_bwd<8>(q, k, v, dout, lse, delta, glse, dq_acc, dk, dv, bh,
                       sq, skv, d, scale_log2e, scale, causal, st);
}

}  // extern "C"
