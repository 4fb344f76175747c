// Attention backward for long sequences: dq, dk, dv (and, on request, the
// bias's cotangent dbias) of
//   out = drop(softmax(q . k^T + mask [+ bias] [causal])) . v,
// tiled over queries and keys.
//
// Replaces vlpet_tpu/ops/attention.py:_pallas_attention_perhead_bwd
// (_ph_bwd_kernel, one head's whole (L, S) block per program) and
// _pallas_attention_ltiled_bwd (_lt_bwd_kernel, query strips against all
// keys with f32 dK/dV resident across the sequential row sweep), the TPU
// backwards of the video path (S 604 and 1024). Layout as A6
// (csrc/attention_bwd.cu): q, do, out (B, L, H*Dh), q pre-scaled; k, v
// (B, S, H*Dh); additive f32 padding mask (B|1, S); ``causal`` hides key j
// from query i unless j <= i + (S - L), the logit set to -1e9 after the
// mask and the bias. The mask gets no gradient. Dh <= 128, fp32 or bf16
// in, fp32 arithmetic, outputs in the input dtype (dbias fp32).
//
// Why not A6: A6 holds a whole (L, S) head in shared memory, 3.5 MB at
// L = S = 604. Here p is recomputed tile by tile from the forward's row
// logsumexp (csrc/attention.cu writes it; the logits are the same fmaf
// chain over Dh, so p = exp(s - lse) is the forward's softmax), and
// softmax's row term rowsum(dp p) is rowsum(do . out) (delta), computed
// once by a pre-pass. No atomics: every output element is one thread's
// fixed-order sum and the result does not depend on scheduling (the fp32
// train-step parity holds kernel and plain steps to 1e-5):
//   1. delta[b, h, i] = sum_d do[b, i, h, d] out[b, i, h, d], one warp per
//      (b, i, h);
//   2. dk/dv: one block per (64-key tile, head, batch) keeps K, V and its
//      dk, dv accumulators and loops over the 64-query tiles:
//      p = exp(q k^T + mask [+ bias] - lse), ds = p (dp - delta),
//      dv += p_drop^T do, dk += ds^T q;
//   3. dq: one block per (64-query tile, head, batch) keeps Q, dO and its
//      dq accumulator and loops over the 64-key tiles: dq += ds k;
//   4. (bias_grad only) dbias: below.
// Tails (S 604 is no multiple of 64) are zero-filled tiles whose p and ds
// are forced to 0. With ``causal`` the tiles that no row may see are
// skipped (their p would be exp(-1e9 - lse) = 0 exactly).
//
// T5's terms, as _ph_bwd_kernel and _lt_bwd_kernel take them: the
// batch-shared per-head bias (H, L, S) f32 is added after the mask, before
// the causal -1e9; with ``drop`` the forward's probability dropout is
// regenerated: element (b, i, j) of head h is kept iff
// hash_bits((b * L + i) * S + j, head_seed(seed, h)) >= thr (common.cuh),
// i and j being the GLOBAL query and key indices, never a tile's own (the
// 64-wide tiles and their zero-filled tails do not shift the index). Then
//   dv = p_drop^T do,  p_drop = keep ? p / (1 - rate) : 0,
//   dp = keep ? (do v^T) / (1 - rate) : 0,  ds = p (dp - delta),
// with the UNdropped p = exp(s - lse), lse being the forward's logsumexp of
// the undropped, biased logits. delta = rowsum(do . out) still equals
// rowsum(dp p) when ``out`` is the forward's DROPPED output, because
// sum_j p_ij dp_ij = sum_j p_drop_ij (do_i . v_j) = do_i . out_i. So the
// pre-pass is unchanged; the forward saves its dropped output.
//
// dbias (_ph_bwd_kernel's bias_grad: dbias[h] = sum_b ds[b, h]): the TPU
// sums over the batch in a grid-resident block, its grid being sequential.
// Here kernel 4, one block per (64-key tile, 64-query tile, head), walks the
// batch in order and recomputes ds for its tile (one more q k^T and do v^T
// per tile and batch, the dq kernel's work again); each thread sums its
// 4 x 4 entries over b in registers: deterministic, no atomics, no
// scratch (a partial per (b, h) would be B H L S floats, 875 MB at B 50,
// S 604).
//
// Bound on the H100: at the video encoder site (B 50, H 12, L = S = 604,
// Dh 64) the function is 10 B H L S Dh = 140 GFLOP against 325 MB of bf16
// q, k, v, do in and dq, dk, dv out: 0.142 ms at the bf16 tensor-core peak
// against 0.097 ms of memory time, so the bound is the operations. This
// kernel recomputes q k^T and do v^T in both (2) and (3) (14 B H L S Dh in
// all; 18 with dbias) on FP32 FMA from shared memory: each thread owns a
// 4 x 4 tile of the 64 x 64 logits and a 4 x (Dh / 16) tile of its
// outputs, two FMAs per shared-memory load. The bias is read straight from
// device memory (17.5 MB at S 604: L2-resident across the batch).
// mma/wgmma on the bf16 inputs are later work.
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // queries per query tile and keys per key tile
// row stride of the p and ds tiles: a warp's two 16-thread halves own rows
// r and r + 1, which then sit 16 banks apart
constexpr int kPL = kT + 16;

// Thread layout of every 64 x 64 tile: ty = tid / 16 owns rows ty + 16 i
// (i < 4), tx = tid % 16 columns tx + 16 j.

// The T5 terms of one head: its (L, S) slice of the bias, or null, and
// the dropout (``on``, the head's seed, threshold, 1 / (1 - rate)).
struct Terms {
  const float* bias;
  int on;
  uint32_t hseed;
  uint32_t thr;
  float scale;
};

__device__ __forceinline__ Terms make_terms(const float* bias,
                                            const int* seed_p, int drop,
                                            uint32_t thr, float scale, int h,
                                            int L, int S) {
  Terms t;
  t.bias = bias != nullptr ? bias + (size_t)h * L * S : nullptr;
  t.on = drop;
  t.hseed = drop ? head_seed((uint32_t)seed_p[0], h) : 0u;
  t.thr = thr;
  t.scale = scale;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int L, int H, int Dh, long rows) {
  // warp w is row (b * L + i) * H + h of the (B, L, H, Dh) view
  const long w = ((long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;  // warp-uniform
  const T* o = out + w * Dh;
  const T* g = dout + w * Dh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long bi = w / H;
    const int h = (int)(w - bi * H);
    const long b = bi / L;
    const int i = (int)(bi - b * L);
    delta[(b * H + h) * L + i] = acc;
  }
}

// Rows n0 .. n0 + kT of one head of x (N rows of stride ``inner``) into
// dst [kT][Dh + 1] as fp32, zeros past N.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          int n0, int N, int inner, int Dh) {
  const int ld = Dh + 1;
  for (int e = threadIdx.x; e < kT * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int n = n0 + r;
    dst[r * ld + d] = n < N ? to_f(x[(size_t)n * inner + d]) : 0.f;
  }
}

// One (query tile q0, key tile k0) pair of batch b: s = Q K^T and
// dp = dO V^T for the thread's 4 x 4 entries, then, in place,
// s <- p_drop (the dropped probabilities, for dv) and dp <- ds, both zero
// outside the L x S range. Ms, Ls, Ds: the key tile's mask, the query
// tile's lse and delta.
__device__ __forceinline__ void probs_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ms, const float* Ls, const float* Ds, const Terms& tm,
    int b, int q0, int k0, int L, int S, int Dh, int causal, float (&s)[4][4],
    float (&dp)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ld = Dh + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * ld + d];
      ga[i] = dOs[(ty + 16 * i) * ld + d];
      kb[i] = Ks[(tx + 16 * i) * ld + d];
      vb[i] = Vs[(tx + 16 * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kj = k0 + c;
      float pd = 0.f, ds = 0.f;
      if (qi < L && kj < S) {
        float a = s[i][j] + Ms[c];
        if (tm.bias != nullptr) a += tm.bias[(size_t)qi * S + kj];
        if (causal && kj > qi + (S - L)) a = -1e9f;
        const float p = expf(a - Ls[r]);
        float g = dp[i][j];
        pd = p;
        if (tm.on) {
          const uint32_t idx =
              ((uint32_t)b * (uint32_t)L + (uint32_t)qi) * (uint32_t)S +
              (uint32_t)kj;
          if (hash_bits(idx, tm.hseed) >= tm.thr) {
            g *= tm.scale;
            pd = p * tm.scale;
          } else {
            g = 0.f;
            pd = 0.f;
          }
        }
        ds = p * (g - Ds[r]);
      }
      s[i][j] = pd;
      dp[i][j] = ds;
    }
  }
}

// (lse, delta) of query rows q0 .. q0 + kT into Ls, Ds; zeros past L.
__device__ __forceinline__ void load_rows(float* Ls, float* Ds,
                                          const float* lb, const float* db,
                                          int q0, int L) {
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const bool ok = q0 + r < L;
    Ls[r] = ok ? lb[q0 + r] : 0.f;
    Ds[r] = ok ? db[q0 + r] : 0.f;
  }
}

__device__ __forceinline__ void load_mask(float* Ms, const float* mb, int k0,
                                          int S) {
  for (int c = threadIdx.x; c < kT; c += kThreads)
    Ms[c] = k0 + c < S ? mb[k0 + c] : 0.f;
}

// The kernels' common arguments.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  const float* bias;
  const int* seed;
  const void* dout;
  const float* lse;
  const float* delta;  // the pre-pass's output, set by launch_all
  int L, S, H, Dh, mask_batched, causal, drop;
  uint32_t thr;
  float scale;
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(Args a, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float sm[];
  const int L = a.L, S = a.S, Dh = a.Dh;
  const int ld = Dh + 1;
  float* Ks = sm;                  // [kT][Dh + 1]
  float* Vs = Ks + kT * ld;        // [kT][Dh + 1]
  float* Qs = Vs + kT * ld;        // [kT][Dh + 1]
  float* dOs = Qs + kT * ld;       // [kT][Dh + 1]
  float* P = dOs + kT * ld;        // [kT][kPL]: p_drop
  float* dS = P + kT * kPL;        // [kT][kPL]
  float* Ms = dS + kT * kPL;       // [kT]
  float* Ls = Ms + kT;             // [kT]
  float* Ds = Ls + kT;             // [kT]

  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.H * Dh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
  const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
  const float* lb = a.lse + ((size_t)b * a.H + h) * L;
  const float* db = a.delta + ((size_t)b * a.H + h) * L;
  const Terms tm = make_terms(a.bias, a.seed, a.drop, a.thr, a.scale, h, L, S);

  load_tile(Ks, (const T*)a.k + koff, k0, S, inner, Dh);
  load_tile(Vs, (const T*)a.v + koff, k0, S, inner, Dh);
  load_mask(Ms, a.mask + (a.mask_batched ? (size_t)b * S : 0), k0, S);

  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // causal: rows before k0 - (S - L) see no key of this tile
  const int qstart = a.causal ? max(0, k0 - (S - L)) / kT * kT : 0;
  for (int q0 = qstart; q0 < L; q0 += kT) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(Qs, (const T*)a.q + qoff, q0, L, inner, Dh);
    load_tile(dOs, (const T*)a.dout + qoff, q0, L, inner, Dh);
    load_rows(Ls, Ds, lb, db, q0, L);
    __syncthreads();
    float s[4][4], dp[4][4];
    probs_tile(Qs, dOs, Ks, Vs, Ms, Ls, Ds, tm, b, q0, k0, L, S, Dh,
               a.causal, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        P[(ty + 16 * i) * kPL + tx + 16 * j] = s[i][j];
        dS[(ty + 16 * i) * kPL + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // dv += p_drop^T do, dk += ds^T q, over the tile's rows in order
    const int rows = min(kT, L - q0);
    for (int r = 0; r < rows; ++r) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = P[r * kPL + ty + 16 * i];
        sa[i] = dS[r * kPL + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float ga = d < Dh ? dOs[r * ld + d] : 0.f;
        const float qa = d < Dh ? Qs[r * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i][j] = fmaf(pa[i], ga, av[i][j]);
          ak[i][j] = fmaf(sa[i], qa, ak[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < S) {
      const size_t row = koff + (size_t)key * inner;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < Dh) {
          dk[row + d] = from_f<T>(ak[i][j]);
          dv[row + d] = from_f<T>(av[i][j]);
        }
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args a, T* __restrict__ dq) {
  extern __shared__ float sm[];
  const int L = a.L, S = a.S, Dh = a.Dh;
  const int ld = Dh + 1;
  float* Qs = sm;                  // [kT][Dh + 1]
  float* dOs = Qs + kT * ld;       // [kT][Dh + 1]
  float* Ks = dOs + kT * ld;       // [kT][Dh + 1]
  float* Vs = Ks + kT * ld;        // [kT][Dh + 1]
  float* dS = Vs + kT * ld;        // [kT][kPL]
  float* Ms = dS + kT * kPL;       // [kT]
  float* Ls = Ms + kT;             // [kT]
  float* Ds = Ls + kT;             // [kT]

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.H * Dh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
  const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
  const float* mb = a.mask + (a.mask_batched ? (size_t)b * S : 0);
  const Terms tm = make_terms(a.bias, a.seed, a.drop, a.thr, a.scale, h, L, S);

  load_tile(Qs, (const T*)a.q + qoff, q0, L, inner, Dh);
  load_tile(dOs, (const T*)a.dout + qoff, q0, L, inner, Dh);
  load_rows(Ls, Ds, a.lse + ((size_t)b * a.H + h) * L,
            a.delta + ((size_t)b * a.H + h) * L, q0, L);

  float aq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;

  // causal: the tile's last row sees keys up to (its index) + (S - L)
  const int kend = a.causal ? min(S, min(q0 + kT, L) + (S - L)) : S;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(Ks, (const T*)a.k + koff, k0, S, inner, Dh);
    load_tile(Vs, (const T*)a.v + koff, k0, S, inner, Dh);
    load_mask(Ms, mb, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    probs_tile(Qs, dOs, Ks, Vs, Ms, Ls, Ds, tm, b, q0, k0, L, S, Dh,
               a.causal, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dS[(ty + 16 * i) * kPL + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dq += ds k, over the tile's keys in order
    const int cols = min(kT, S - k0);
    for (int c = 0; c < cols; ++c) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dS[(ty + 16 * i) * kPL + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float kb = d < Dh ? Ks[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i][j] = fmaf(sa[i], kb, aq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < L) {
      T* dst = dq + qoff + (size_t)row * inner;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < Dh) dst[d] = from_f<T>(aq[i][j]);
      }
    }
  }
}

// dbias[h, i, j] = sum_b ds[b, h, i, j] for one (key tile, query tile, head),
// the batch walked in order, each thread's 4 x 4 sums in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dbias_kernel(Args a, int B, float* __restrict__ dbias) {
  extern __shared__ float sm[];
  const int L = a.L, S = a.S, Dh = a.Dh;
  const int ld = Dh + 1;
  float* Qs = sm;                  // [kT][Dh + 1]
  float* dOs = Qs + kT * ld;       // [kT][Dh + 1]
  float* Ks = dOs + kT * ld;       // [kT][Dh + 1]
  float* Vs = Ks + kT * ld;        // [kT][Dh + 1]
  float* Ms = Vs + kT * ld;        // [kT]
  float* Ls = Ms + kT;             // [kT]
  float* Ds = Ls + kT;             // [kT]

  const int k0 = blockIdx.x * kT, q0 = blockIdx.y * kT, h = blockIdx.z;
  const int inner = a.H * Dh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Terms tm = make_terms(a.bias, a.seed, a.drop, a.thr, a.scale, h, L, S);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // causal: no row of the tile sees a key of it when its first key lies
  // past the last row's limit; dbias is 0 there
  const bool hidden = a.causal && k0 > min(q0 + kT, L) - 1 + (S - L);
  for (int b = 0; b < B && !hidden; ++b) {
    const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
    const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
    __syncthreads();  // the previous batch's tiles are consumed
    load_tile(Qs, (const T*)a.q + qoff, q0, L, inner, Dh);
    load_tile(dOs, (const T*)a.dout + qoff, q0, L, inner, Dh);
    load_tile(Ks, (const T*)a.k + koff, k0, S, inner, Dh);
    load_tile(Vs, (const T*)a.v + koff, k0, S, inner, Dh);
    load_mask(Ms, a.mask + (a.mask_batched ? (size_t)b * S : 0), k0, S);
    load_rows(Ls, Ds, a.lse + ((size_t)b * a.H + h) * L,
              a.delta + ((size_t)b * a.H + h) * L, q0, L);
    __syncthreads();
    float s[4][4], dp[4][4];
    probs_tile(Qs, dOs, Ks, Vs, Ms, Ls, Ds, tm, b, q0, k0, L, S, Dh,
               a.causal, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += dp[i][j];
  }

  float* dst = dbias + (size_t)h * L * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      if (qi < L && kj < S) dst[(size_t)qi * S + kj] = acc[i][j];
    }
  }
}

template <typename T, int NJ>
int launch_all(Args a, const void* out, void* dq, void* dk, void* dv,
               float* delta, float* dbias, int B, cudaStream_t st) {
  const long rows = (long)B * a.L * a.H;
  delta_kernel<T><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>((const T*)out, (const T*)a.dout, delta,
                                       a.L, a.H, a.Dh, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.delta = delta;

  const size_t tile = (size_t)kT * (a.Dh + 1);
  const size_t smem_kv = sizeof(float) * (4 * tile + 2 * kT * kPL + 3 * kT);
  err = cudaFuncSetAttribute(dkdv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, NJ><<<dim3((a.S + kT - 1) / kT, a.H, B), kThreads, smem_kv,
                       st>>>(a, (T*)dk, (T*)dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (4 * tile + kT * kPL + 3 * kT);
  err = cudaFuncSetAttribute(dq_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, NJ><<<dim3((a.L + kT - 1) / kT, a.H, B), kThreads, smem_q,
                     st>>>(a, (T*)dq);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return (int)err;

  const size_t smem_b = sizeof(float) * (4 * tile + 3 * kT);
  err = cudaFuncSetAttribute(dbias_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dbias_kernel<T><<<dim3((a.S + kT - 1) / kT, (a.L + kT - 1) / kT, a.H),
                    kThreads, smem_b, st>>>(a, B, dbias);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, const void* out, void* dq, void* dk, void* dv,
              float* delta, float* dbias, int B, cudaStream_t st) {
  if (a.Dh <= 64)
    return launch_all<T, 4>(a, out, dq, dk, dv, delta, dbias, B, st);
  return launch_all<T, 8>(a, out, dq, dk, dv, delta, dbias, B, st);
}

}  // namespace

// bias: (H, L, S) fp32 or NULL; seed: (1,) int32, read when drop; delta:
// fp32 scratch of B * H * L floats (the wrapper allocates it); dbias: the
// (H, L, S) fp32 output, or NULL for no bias gradient (needs a bias).
extern "C" int vlpet_attention_bwd_long(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, const void* seed, const void* out, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, void* dbias,
    int B, int L, int S, int H, int Dh, int mask_batched, int causal,
    int is_bf16, int drop, int thr, float scale, void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535 || (causal && S < L) ||
      (drop && (seed == nullptr || thr < 0)) ||
      (dbias != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = (const float*)mask;
  a.bias = (const float*)bias;
  a.seed = (const int*)seed;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.L = L;
  a.S = S;
  a.H = H;
  a.Dh = Dh;
  a.mask_batched = mask_batched;
  a.causal = causal;
  a.drop = drop;
  a.thr = (uint32_t)thr;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<bf16>(a, out, dq, dk, dv, (float*)delta, (float*)dbias,
                           B, st);
  return launch_dh<float>(a, out, dq, dk, dv, (float*)delta, (float*)dbias, B,
                          st);
}
