// Attention for heads wider than 256 columns, f32 and bf16 inputs with f32
// sums, on the CUDA cores of Hopper (sm_90a). The tiled kernels of
// fused_short_attn*.cu and flash_attn_*.cu hold a row's head in registers
// and stop at 256 columns (their kMaxD); these take any width d > 256, so
// the port computes every width the JAX package does. They serve both
// families: the fused short attention (B7, B8 of
// analytics_zoo_tpu/ops/attention.py :870, :877) and flash attention (B4,
// B5a, B5b, B6 of :356, :663, :683, :616), with the union of their options
// (scale, a [bh / heads, skv] f32 key bias, the causal mask aligned
// top-left, B7/B8's dropout, the flash backward's delta and glse).
//
//   t[i, j] = (q_i . k_j) * scale*log2(e) + key_bias[j]*log2(e)   f32
//   t[i, j] = -1e30 where causal and j > i;  keys past skv take no part
//   p[i, j] = exp2(t[i, j] - m_i) / l_i,  m_i = max_j t, l_i = sum_j exp2
//   pd      = keep ? p / (1 - rate) : 0        (dropout_hash.cuh's mask)
//   o_i     = sum_j rnd(pd[i, j]) v_j
//
// rnd rounds to the inputs' dtype where every flash kernel does: pd before
// pd.v and pd^T.dO, ds before ds.k and ds^T.q (no-ops in f32).
//
// Forward: a block per (bh, 32 query rows, 128 columns of the output). It
// walks the keys in tiles of 32 with an online softmax (running max and
// sum, the accumulator rescaled per tile). A tile's scores take the full
// head: 32-column chunks of q and k are staged in shared memory in turn,
// so a block never holds a whole row; each block recomputes the scores of
// its rows for its own 128 output columns. It writes o, and from the block
// of column chunk 0 the rows' statistics that the family's backward reads:
// the max (exp2 units) and the sum (B7's `stats`) and/or the logsumexp in
// natural-log units (B4's `lse`).
//
// Backward, two launches, no atomics:
//   dq pass, a block per (bh, 32 query rows, 128 columns of dq), walking
//   the keys: p from the saved statistics (m and l, or lse), dp = dO.v^T
//   over the full head, ds = p (dp - D + glse), dq += rnd(ds) k.
//   dk/dv pass, a block per (bh, 32 keys, 128 columns), walking the query
//   rows (from the tile's first key on when causal): dv += rnd(pd)^T dO,
//   dk += rnd(ds)^T q.
// D is each row's sum of dO.o (the flash routes pass it in `delta`; the
// f32 fused route has the dq pass form it from o) or of dp.p over the keys
// (the bf16 fused route: the dq pass walks the keys once more first); the
// dq pass writes a formed D to `delta` for the dk/dv pass.
//
// A simple design: the scores of a tile are recomputed for every 128-wide
// column chunk, and every product runs as f32 FMAs on the CUDA cores.
// No public model has heads this wide; the tiled kernels stay the fast
// path for every width up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int kBQ = 32;        // query rows a block
constexpr int kBK = 32;        // keys a tile
constexpr int kDC = 32;        // head columns a staged chunk
constexpr int kNC = 128;       // output columns a block
constexpr int kThreads = 256;  // 32 rows x 8 threads
constexpr int kPer = kNC / 8;  // output columns a thread
constexpr int kPad = kDC + 1;
constexpr int kMinD = 257;     // narrower heads take the tiled kernels
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// sum / max over the 8 threads of a row (lanes 8r .. 8r+7 of a warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // forward output (the f32 fused route's D), or NULL
  const void* dout;
  const float* key_bias;  // [bh / heads, skv] or NULL
  const int32_t* seed;    // NULL: no dropout
  const float* stats;     // [2, bh, sq] m and l, or NULL (then lse)
  const float* lse;       // [bh, sq]
  const float* glse;      // [bh, sq] or NULL
  float* delta;           // [bh, sq] D
  void* out0;             // o | dq | dk
  void* out1;             // dv
  float* stats_out;       // forward: [2, bh, sq] or NULL
  float* lse_out;         // forward: [bh, sq] or NULL
  long long bh;
  int heads, sq, skv, d;
  float scale_log2e, scale, inv_keep;
  uint32_t thresh;
  int causal;
  int dmode;  // dq pass: 0 read delta, 1 D = dO.o, 2 D = sum dp.p
};

struct Smem {
  float a[kBQ][kPad];   // q chunk
  float b[kBK][kPad];   // k chunk
  float c[kBQ][kPad];   // dO chunk
  float e[kBK][kPad];   // v chunk
  float p[kBQ][kBK + 1];
  float ds[kBQ][kBK + 1];
  float cols[kBK][kNC];  // 128 columns of v, k, dO or q
  float row[4][kBQ];     // per query row: m or lse, l, D, glse
};

// rows r0.. of a [n, d] matrix (row `base` on), columns d0 .. d0+kDC, to
// `dst`; zeros past n and past d
template <typename T>
__device__ __forceinline__ void stage(float (*dst)[kPad], const T* src,
                                      long long base, int r0, int n, int d,
                                      int d0) {
  for (int e = threadIdx.x; e < kBQ * kDC; e += kThreads) {
    const int r = e / kDC, c = e % kDC;
    dst[r][c] = (r0 + r < n && d0 + c < d)
                    ? ld(src, (base + r0 + r) * (long long)d + d0 + c)
                    : 0.f;
  }
}

// rows r0.. of a [n, d] matrix, the block's 128 columns c0.., to sm.cols
template <typename T>
__device__ __forceinline__ void stage_cols(Smem& sm, const T* src,
                                           long long base, int r0, int n,
                                           int d, int c0) {
  for (int e = threadIdx.x; e < kBK * kNC; e += kThreads) {
    const int r = e / kNC, c = e % kNC;
    sm.cols[r][c] = (r0 + r < n && c0 + c < d)
                        ? ld(src, (base + r0 + r) * (long long)d + c0 + c)
                        : 0.f;
  }
}

// The raw products of query rows q0.. and keys k0.. over the full head:
// this thread's row tid/8 against keys tid%8 + 8i: s = q.k and, with kDp,
// dp = dO.v. Starts with a barrier, so the caller may rewrite any shared
// buffer once it returns.
template <typename T, bool kDp>
__device__ __forceinline__ void products(const Args& a, Smem& sm,
                                         long long bh, int q0, int k0,
                                         float (&s)[4], float (&dp)[4]) {
  const int r = threadIdx.x >> 3, t8 = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
  for (int d0 = 0; d0 < a.d; d0 += kDC) {
    __syncthreads();
    stage(sm.a, static_cast<const T*>(a.q), bh * a.sq, q0, a.sq, a.d, d0);
    stage(sm.b, static_cast<const T*>(a.k), bh * a.skv, k0, a.skv, a.d, d0);
    if (kDp) {
      stage(sm.c, static_cast<const T*>(a.dout), bh * a.sq, q0, a.sq, a.d,
            d0);
      stage(sm.e, static_cast<const T*>(a.v), bh * a.skv, k0, a.skv, a.d,
            d0);
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kDC; ++dd) {
      const float qv = sm.a[r][dd];
      const float gv = kDp ? sm.c[r][dd] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(qv, sm.b[t8 + 8 * i][dd], s[i]);
        if (kDp) dp[i] = fmaf(gv, sm.e[t8 + 8 * i][dd], dp[i]);
      }
    }
  }
}

// the score in exp2 units; -inf for a key past skv
__device__ __forceinline__ float score(const Args& a, float s, long long bh,
                                       int row, int col) {
  if (col >= a.skv) return -INFINITY;
  float t = s * a.scale_log2e;
  if (a.key_bias != nullptr)
    t += a.key_bias[(bh / a.heads) * a.skv + col] * kLog2e;
  if (a.causal && col > row) t = kMasked;
  return t;
}

// p from the forward's statistics: exp2(t - m) / l (fused) or
// exp2(t - lse*log2(e)) (flash)
__device__ __forceinline__ float prob(const Args& a, float t, float ra,
                                      float rb) {
  return a.stats != nullptr ? exp2f(t - ra) / rb : exp2f(t - ra * kLog2e);
}

__device__ __forceinline__ void load_row_stats(const Args& a, long long bh,
                                               int row, float& ra,
                                               float& rb) {
  const long long i = bh * a.sq + row;
  if (a.stats != nullptr) {
    ra = a.stats[i];
    rb = a.stats[a.bh * a.sq + i];
  } else {
    ra = a.lse[i];
    rb = 1.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(Args a) {
  __shared__ Smem sm;
  const int nqt = (a.sq + kBQ - 1) / kBQ;
  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * kBQ;
  const int c0 = blockIdx.y * kNC;
  const int r = threadIdx.x >> 3, t8 = threadIdx.x & 7;
  const int row = q0 + r;
  const bool drop = a.seed != nullptr;
  const uint32_t rkey =
      drop ? row_key((uint32_t)(*a.seed), (uint32_t)bh, (uint32_t)row) : 0u;
  float m = -INFINITY, l = 0.f, acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  const int kend = a.causal ? min(a.skv, q0 + kBQ) : a.skv;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    float s[4], unused[4];
    products<T, false>(a, sm, bh, q0, k0, s, unused);
    float t[4], tm = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[i] = score(a, s[i], bh, row, k0 + t8 + 8 * i);
      tm = fmaxf(tm, t[i]);
    }
    const float mn = fmaxf(m, row_max(tm));
    const float corr = exp2f(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + t8 + 8 * i;
      const float p = exp2f(t[i] - mn);
      ps += p;
      float pd = p;
      if (drop) pd = kept(rkey, (uint32_t)col, a.thresh) ? p * a.inv_keep
                                                         : 0.f;
      sm.p[r][t8 + 8 * i] = rnd<T>(pd);
    }
    l = l * corr + row_sum(ps);
    m = mn;
    stage_cols(sm, static_cast<const T*>(a.v), bh * a.skv, k0, a.skv, a.d,
               c0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[c] *= corr;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pj = sm.p[r][j];
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        acc[c] = fmaf(pj, sm.cols[j][t8 + 8 * c], acc[c]);
    }
  }
  if (row >= a.sq) return;
  const float lf = fmaxf(l, 1e-30f);
  T* o = static_cast<T*>(a.out0);
  const long long base = (bh * a.sq + row) * (long long)a.d;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int col = c0 + t8 + 8 * c;
    if (col < a.d) st(o, base + col, acc[c] / lf);
  }
  if (blockIdx.y == 0 && t8 == 0) {
    const long long i = bh * a.sq + row;
    if (a.stats_out != nullptr) {
      a.stats_out[i] = m;
      a.stats_out[a.bh * a.sq + i] = l;
    }
    if (a.lse_out != nullptr) a.lse_out[i] = m * kLn2 + logf(lf);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(Args a) {
  __shared__ Smem sm;
  const int nqt = (a.sq + kBQ - 1) / kBQ;
  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * kBQ;
  const int c0 = blockIdx.y * kNC;
  const int r = threadIdx.x >> 3, t8 = threadIdx.x & 7;
  const int row = q0 + r;
  const bool live = row < a.sq;
  const bool drop = a.seed != nullptr;
  const uint32_t rkey =
      drop ? row_key((uint32_t)(*a.seed), (uint32_t)bh, (uint32_t)row) : 0u;
  float ra = 0.f, rb = 1.f;
  if (live) load_row_stats(a, bh, row, ra, rb);
  const int kend = a.causal ? min(a.skv, q0 + kBQ) : a.skv;
  float dsum = 0.f;
  if (a.dmode == 0) {
    dsum = live ? a.delta[bh * a.sq + row] : 0.f;
  } else if (a.dmode == 1) {  // D = dO.o over the row
    const T* dout = static_cast<const T*>(a.dout);
    const T* o = static_cast<const T*>(a.o);
    float part = 0.f;
    if (live) {
      const long long base = (bh * a.sq + row) * (long long)a.d;
      for (int col = t8; col < a.d; col += 8)
        part = fmaf(ld(dout, base + col), ld(o, base + col), part);
    }
    dsum = row_sum(part);
  } else {  // D = sum_j dp.p, one more walk over the keys
    float part = 0.f;
    for (int k0 = 0; k0 < kend; k0 += kBK) {
      float s[4], dp[4];
      products<T, true>(a, sm, bh, q0, k0, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + t8 + 8 * i;
        const float t = score(a, s[i], bh, row, col);
        if (t == -INFINITY) continue;
        float g = dp[i];
        if (drop) g = kept(rkey, (uint32_t)col, a.thresh) ? g * a.inv_keep
                                                          : 0.f;
        part = fmaf(g, prob(a, t, ra, rb), part);
      }
    }
    dsum = row_sum(part);
  }
  if (a.dmode != 0 && blockIdx.y == 0 && t8 == 0 && live)
    a.delta[bh * a.sq + row] = dsum;
  const float gl = (a.glse != nullptr && live) ? a.glse[bh * a.sq + row]
                                               : 0.f;
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    float s[4], dp[4];
    products<T, true>(a, sm, bh, q0, k0, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + t8 + 8 * i;
      const float t = score(a, s[i], bh, row, col);
      float ds = 0.f;
      if (live && t != -INFINITY) {
        float g = dp[i];
        if (drop) g = kept(rkey, (uint32_t)col, a.thresh) ? g * a.inv_keep
                                                          : 0.f;
        ds = prob(a, t, ra, rb) * (g - dsum + gl);
      }
      sm.p[r][t8 + 8 * i] = rnd<T>(ds);
    }
    stage_cols(sm, static_cast<const T*>(a.k), bh * a.skv, k0, a.skv, a.d,
               c0);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float dj = sm.p[r][j];
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        acc[c] = fmaf(dj, sm.cols[j][t8 + 8 * c], acc[c]);
    }
  }
  if (!live) return;
  T* dq = static_cast<T*>(a.out0);
  const long long base = (bh * a.sq + row) * (long long)a.d;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int col = c0 + t8 + 8 * c;
    if (col < a.d) st(dq, base + col, acc[c] * a.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(Args a) {
  __shared__ Smem sm;
  const int nkt = (a.skv + kBK - 1) / kBK;
  const long long bh = blockIdx.x / nkt;
  const int k0 = (int)(blockIdx.x % nkt) * kBK;
  const int c0 = blockIdx.y * kNC;
  const int r = threadIdx.x >> 3, t8 = threadIdx.x & 7;
  const bool drop = a.seed != nullptr;
  const uint32_t seed_u = drop ? (uint32_t)(*a.seed) : 0u;
  float acc_k[kPer], acc_v[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc_k[c] = acc_v[c] = 0.f;
  // rows above the tile's first key see none of its keys when causal
  const int qstart = a.causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = qstart; q0 < a.sq; q0 += kBQ) {
    // every thread is past the last tile's reads of sm.row (they precede
    // that tile's barrier before its accumulation)
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      float ra = 0.f, rb = 1.f, dd = 0.f, gl = 0.f;
      if (row < a.sq) {
        load_row_stats(a, bh, row, ra, rb);
        dd = a.delta[bh * a.sq + row];
        if (a.glse != nullptr) gl = a.glse[bh * a.sq + row];
      }
      sm.row[0][threadIdx.x] = ra;
      sm.row[1][threadIdx.x] = rb;
      sm.row[2][threadIdx.x] = dd;
      sm.row[3][threadIdx.x] = gl;
    }
    float s[4], dp[4];
    products<T, true>(a, sm, bh, q0, k0, s, dp);
    const int row = q0 + r;
    const uint32_t rkey =
        drop ? row_key(seed_u, (uint32_t)bh, (uint32_t)row) : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + t8 + 8 * i;
      const float t = score(a, s[i], bh, row, col);
      float pd = 0.f, ds = 0.f;
      if (row < a.sq && t != -INFINITY) {
        const float p = prob(a, t, sm.row[0][r], sm.row[1][r]);
        float g = dp[i];
        pd = p;
        if (drop) {
          const bool keep = kept(rkey, (uint32_t)col, a.thresh);
          g = keep ? g * a.inv_keep : 0.f;
          pd = keep ? p * a.inv_keep : 0.f;
        }
        ds = p * (g - sm.row[2][r] + sm.row[3][r]);
      }
      sm.p[r][t8 + 8 * i] = rnd<T>(pd);
      sm.ds[r][t8 + 8 * i] = rnd<T>(ds);
    }
    // dv += pd^T dO over this tile's rows; then dk += ds^T q
    stage_cols(sm, static_cast<const T*>(a.dout), bh * a.sq, q0, a.sq, a.d,
               c0);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      const float pi = sm.p[i][r];
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        acc_v[c] = fmaf(pi, sm.cols[i][t8 + 8 * c], acc_v[c]);
    }
    __syncthreads();
    stage_cols(sm, static_cast<const T*>(a.q), bh * a.sq, q0, a.sq, a.d,
               c0);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      const float di = sm.ds[i][r];
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        acc_k[c] = fmaf(di, sm.cols[i][t8 + 8 * c], acc_k[c]);
    }
  }
  const int key = k0 + r;
  if (key >= a.skv) return;
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
  const long long base = (bh * a.skv + key) * (long long)a.d;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int col = c0 + t8 + 8 * c;
    if (col < a.d) {
      st(dk, base + col, acc_k[c] * a.scale);
      st(dv, base + col, acc_v[c]);
    }
  }
}

bool bad_shape(long long bh, int heads, int sq, int skv, int d) {
  return bh < 0 || heads < 1 || sq < 1 || skv < 1 || d < kMinD;
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* key_bias, const void* seed,
               const void* stats, const void* lse, const void* glse,
               void* delta, long long bh, int heads, int sq, int skv, int d,
               float scale_log2e, float scale, unsigned int thresh,
               float inv_keep, int causal) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.key_bias = static_cast<const float*>(key_bias);
  a.seed = static_cast<const int32_t*>(seed);
  a.stats = static_cast<const float*>(stats);
  a.lse = static_cast<const float*>(lse);
  a.glse = static_cast<const float*>(glse);
  a.delta = static_cast<float*>(delta);
  a.out0 = a.out1 = nullptr;
  a.stats_out = a.lse_out = nullptr;
  a.bh = bh;
  a.heads = heads;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.scale_log2e = scale_log2e;
  a.scale = scale;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  a.causal = causal;
  a.dmode = 0;
  return a;
}

dim3 grid_of(long long bh, int len, int tile, int d) {
  return dim3((unsigned)(bh * ((len + tile - 1) / tile)),
              (unsigned)((d + kNC - 1) / kNC));
}

int run_fwd(const Args& a, int bf16, cudaStream_t st) {
  const dim3 grid = grid_of(a.bh, a.sq, kBQ, a.d);
  if (bf16)
    wide_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    wide_fwd_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int run_dq(const Args& a, int bf16, cudaStream_t st) {
  const dim3 grid = grid_of(a.bh, a.sq, kBQ, a.d);
  if (bf16)
    wide_dq_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    wide_dq_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int run_dkv(const Args& a, int bf16, cudaStream_t st) {
  const dim3 grid = grid_of(a.bh, a.skv, kBK, a.d);
  if (bf16)
    wide_dkv_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    wide_dkv_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a head narrower than 257 columns (the tiled
// kernels' widths) or an empty shape. q, o, dout, dq: [bh, sq, d]; k, v,
// dk, dv: [bh, skv, d]; bf16 != 0 for bf16 tensors, else f32. key_bias:
// [bh / heads, skv] f32 or NULL. seed: one int32 on the device, or NULL for
// no dropout (then thresh and inv_keep are unused). stats: [2, bh, sq] f32
// (each row's max in exp2 units, then its sum) and lse: [bh, sq] f32; the
// backward reads stats when it is not NULL, else lse. delta, glse: [bh,
// sq] f32, glse NULL for zero. The caller allocates every output.

// The forward: o, and stats and/or lse (either may be NULL).
int azt_attn_wide_fwd(const void* q, const void* k, const void* v,
                      const void* key_bias, const void* seed, void* o,
                      void* stats, void* lse, long long bh, int heads,
                      int sq, int skv, int d, float scale_log2e,
                      unsigned int thresh, float inv_keep, int causal,
                      int bf16, void* stream) {
  if (bad_shape(bh, heads, sq, skv, d) || o == nullptr ||
      (stats == nullptr && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  Args a = make_args(q, k, v, nullptr, nullptr, key_bias, seed, nullptr,
                     nullptr, nullptr, nullptr, bh, heads, sq, skv, d,
                     scale_log2e, 1.f, thresh, inv_keep, causal);
  a.out0 = o;
  a.stats_out = static_cast<float*>(stats);
  a.lse_out = static_cast<float*>(lse);
  return run_fwd(a, bf16, static_cast<cudaStream_t>(stream));
}

// The dq pass. dmode 0 reads D from delta; 1 forms D = rowsum(dO.o) from
// o, 2 forms D = sum_j dp.p over the keys; both write it to delta.
int azt_attn_wide_bwd_dq(const void* q, const void* k, const void* v,
                         const void* o, const void* dout,
                         const void* key_bias, const void* seed,
                         const void* stats, const void* lse,
                         const void* glse, void* delta, void* dq,
                         long long bh, int heads, int sq, int skv, int d,
                         float scale_log2e, float scale, unsigned int thresh,
                         float inv_keep, int causal, int dmode, int bf16,
                         void* stream) {
  if (bad_shape(bh, heads, sq, skv, d) || dq == nullptr ||
      delta == nullptr || (stats == nullptr && lse == nullptr) ||
      dmode < 0 || dmode > 2 || (dmode == 1 && o == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  Args a = make_args(q, k, v, o, dout, key_bias, seed, stats, lse, glse,
                     delta, bh, heads, sq, skv, d, scale_log2e, scale,
                     thresh, inv_keep, causal);
  a.out0 = dq;
  a.dmode = dmode;
  return run_dq(a, bf16, static_cast<cudaStream_t>(stream));
}

// The dk/dv pass; D from delta.
int azt_attn_wide_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* key_bias,
                          const void* seed, const void* stats,
                          const void* lse, const void* glse,
                          const void* delta, void* dk, void* dv,
                          long long bh, int heads, int sq, int skv, int d,
                          float scale_log2e, float scale,
                          unsigned int thresh, float inv_keep, int causal,
                          int bf16, void* stream) {
  if (bad_shape(bh, heads, sq, skv, d) || dk == nullptr || dv == nullptr ||
      delta == nullptr || (stats == nullptr && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return 0;
  Args a = make_args(q, k, v, nullptr, dout, key_bias, seed, stats, lse,
                     glse, const_cast<void*>(delta), bh, heads, sq, skv, d,
                     scale_log2e, scale, thresh, inv_keep, causal);
  a.out0 = dk;
  a.out1 = dv;
  return run_dkv(a, bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
