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
// q, k, v, do in and dq, dk, dv out: 0.1416 ms at the bf16 tensor-core
// peak against 0.097 ms of memory time, so the bound is the operations.
// Kernels 2 and 3 recompute q k^T and do v^T each (14 B H L S Dh in all, 196
// GFLOP; 18 with dbias). Two routes, picked by the wrapper with
// ops/attention.py forward_route (a plain function of dtype and Dh) and
// passed as ``tc``; the pre-pass (1) and dbias (4) are the same on both:
//
// "fma" (fp32, and bf16 at Dh != 64; the FMA design): FP32 FMA on
// fp32 copies of the tiles in shared memory, each thread a 4 x 4 tile of
// the 64 x 64 logits and a 4 x (Dh / 16) tile of its outputs, two FMAs per
// shared-memory load; the bias read straight from device memory. It ran at
// about 75x the bound in bf16 (10.6 ms). The fp32 train-step parity
// phases hold it to full fp32 arithmetic (no TF32), so it stays.
//
// "tc" (bf16, Dh 64), dkdv_tc and dq_tc: FlashAttention-2's deterministic
// backward on mma.sync m16n8k16 (bf16 in, fp32 sums), 4 warps a block, 16
// rows of the 64-row tile a warp:
//   - dk/dv: a block per (64-key tile, head, batch) keeps K, V and the key
//     tile's mask in bf16 shared memory and dK, dV in fp32 registers, and
//     walks the 64-query tiles with Q, dO (bf16), lse and delta -- and the
//     bias tile -- double-buffered by 16-byte cp.async. Each warp computes
//     the transposed tiles s^T = K q^T and dp^T = V do^T, then p, the keep
//     bit, p_drop and ds element-wise on the fragments with the global
//     indices; p_drop^T and ds^T, rounded to bf16 in registers, are the A
//     fragments of dv += p_drop^T do and dk += ds^T q, whose B operands
//     come from the Q and dO tiles by ldmatrix.trans;
//   - dq: a block per (64-query tile, head, batch) keeps Q and dO as A
//     fragments in registers and walks the key tiles (K, V, mask, bias)
//     double-buffered: s = q k^T (the forward's instruction, fragments and
//     k order: bitwise the forward's s, so p = exp(s - lse) is the
//     forward's softmax up to EX2's rounding), dp = do v^T, ds in
//     registers, dq += ds k;
//   - exp is one FFMA + EX2 with lse scaled by log2(e); interior tiles skip
//     the range and causal tests; the bias and the dropout are template
//     flags; causal tiles no row may see are skipped as on the FMA route.
//   dk/dv's s^T swaps the operand roles of the forward's product (the same
//   bf16 products summed over the same k order); whether the tensor cores
//   give it the same bits was not measured: the card's checks hold dq, dk,
//   dv to 2e-2 of the plain twin, which takes p from the forward's lse.
// Resources (nvcc -Xptxas -v, sm_90a, no spills): dk/dv 188-235 registers
// a thread, 56,576 bytes of shared memory a block (91,392 with the bias);
// dq 177-222 registers, 56,320 bytes (93,184 with the bias): 2 blocks an
// SM.
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

// kernel 4 (the FMA design on either route)
template <typename T>
int launch_dbias(const Args& a, float* dbias, int B, size_t tile,
                 cudaStream_t st) {
  const size_t smem_b = sizeof(float) * (4 * tile + 3 * kT);
  cudaError_t err = cudaFuncSetAttribute(
      dbias_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dbias_kernel<T><<<dim3((a.S + kT - 1) / kT, (a.L + kT - 1) / kT, a.H),
                    kThreads, smem_b, st>>>(a, B, dbias);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, Dh 64; header): kernels 2 and 3 on
// mma.sync with the bf16 tiles in shared memory, fed by cp.async.

constexpr int kTcThreads = 128;  // 4 warps, 16 rows of the 64-row tile each
// row strides of the staged (64 queries x 64 keys) fp32 bias tiles: dk/dv
// reads a column per quad lane (stride 68: lanes on distinct banks), dq a
// float2 per lane along a row (stride 72)
constexpr int kBiasLdKV = kT + 4;
constexpr int kBiasLdQ = kT + 8;

// shared memory of dkdv_tc and dq_tc: six bf16 tiles (two resident, two
// stages of two), the mask, lse and delta, and with a bias two stages of
// its tile
__host__ __device__ constexpr size_t tc_smem_kv(bool bias) {
  return 6 * (size_t)kTcTile * 2 + (2 * kT + 2 * kT + kT) * 4 +
         (bias ? 2 * (size_t)kT * kBiasLdKV * 4 : 0);
}
__host__ __device__ constexpr size_t tc_smem_q(bool bias) {
  return 6 * (size_t)kTcTile * 2 + (2 * kT + kT + kT) * 4 +
         (bias ? 2 * (size_t)kT * kBiasLdQ * 4 : 0);
}

// p and the dropped terms of one logit of batch b: x the product (s or its
// transpose) at the global (qi, kj), g its dp, bv its bias, lse2 the row's
// logsumexp times log2(e); returns (p_drop, ds) in (x, g). FULL: the
// caller's tile is interior (every (qi, kj) in range and, causal,
// visible), else both are zero outside the L x S range.
template <bool FULL, bool BIAS, bool DROP>
__device__ __forceinline__ void tc_probs(float& x, float& g, float madd,
                                         float bv, float lse2, float delta,
                                         const Terms& tm, int b, int qi,
                                         int kj, int L, int S, int causal) {
  if (!FULL && (qi >= L || kj >= S)) {
    x = g = 0.f;
    return;
  }
  float a = x + madd;
  if (BIAS) a += bv;
  if (!FULL && causal && kj > qi + (S - L)) a = -1e9f;
  const float p = ex2(fmaf(a, kLog2e, -lse2));
  float dp = g, pd = p;
  if (DROP) {
    const uint32_t idx =
        ((uint32_t)b * (uint32_t)L + (uint32_t)qi) * (uint32_t)S +
        (uint32_t)kj;
    const bool keep = hash_bits(idx, tm.hseed) >= tm.thr;
    dp = keep ? dp * tm.scale : 0.f;
    pd = keep ? p * tm.scale : 0.f;
  }
  x = pd;
  g = p * (dp - delta);
}

// Kernel 2 on the tensor cores: one block per (64-key tile, head, batch),
// warp w owns keys 16 w .. 16 w + 16 of it. K and V stay in shared memory;
// the 64-query tiles of Q and dO (with their lse and delta) are
// double-buffered by cp.async. Per query tile each warp computes the
// transposed tiles s^T = K q^T and dp^T = V do^T (16 keys x 64 queries),
// then p_drop^T and ds^T in registers, which are the A fragments of
// dv += p_drop^T do and dk += ds^T q.
template <bool BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads)
dkdv_tc(Args a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTcTile;
  bf16* Qs = Vs + kTcTile;       // [2][kTcTile]
  bf16* Gs = Qs + 2 * kTcTile;   // [2][kTcTile]: dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kTcTile);  // [2][kT]
  float* Ds = Ls + 2 * kT;                                 // [2][kT]
  float* Ms = Ds + 2 * kT;                                 // [kT]
  float* Bs = Ms + kT;  // [2][kT][kBiasLdKV], with a bias

  const int L = a.L, S = a.S;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp * 16;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * kTcD;
  const size_t koff = (size_t)b * S * inner + (size_t)h * kTcD;
  const bf16* qb = (const bf16*)a.q + qoff;
  const bf16* gb = (const bf16*)a.dout + qoff;
  const float* lb = a.lse + ((size_t)b * a.H + h) * L;
  const float* db = a.delta + ((size_t)b * a.H + h) * L;
  const float* mb = a.mask + (a.mask_batched ? (size_t)b * S : 0);
  const Terms tm = make_terms(a.bias, a.seed, DROP, a.thr, a.scale, h, L, S);

  tc_load_tile(Ks, (const bf16*)a.k + koff, k0, S, inner, kTcThreads);
  tc_load_tile(Vs, (const bf16*)a.v + koff, k0, S, inner, kTcThreads);
  if (threadIdx.x < kT)
    Ms[threadIdx.x] = k0 + threadIdx.x < S ? mb[k0 + threadIdx.x] : 0.f;
  // the query tile's lse (times log2(e)) and delta, zeros past L
  auto load_q = [&](int q0, int st) {
    tc_load_tile(Qs + st * kTcTile, qb, q0, L, inner, kTcThreads);
    tc_load_tile(Gs + st * kTcTile, gb, q0, L, inner, kTcThreads);
    if (BIAS)
      tc_load_bias(Bs + st * kT * kBiasLdKV, kBiasLdKV, tm.bias, q0, kT, L,
                   k0, S, kTcThreads);
    if (threadIdx.x < kT) {
      const bool ok = q0 + (int)threadIdx.x < L;
      Ls[st * kT + threadIdx.x] = ok ? lb[q0 + threadIdx.x] * kLog2e : 0.f;
      Ds[st * kT + threadIdx.x] = ok ? db[q0 + threadIdx.x] : 0.f;
    }
  };
  // causal: rows before k0 - (S - L) see no key of this tile
  const int qstart = a.causal ? max(0, k0 - (S - L)) / kT * kT : 0;
  const int nq = (L - qstart + kT - 1) / kT;
  load_q(qstart, 0);
  cp_async_commit();

  float ak[8][4], av[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[i][e] = av[i][e] = 0.f;
  float madd[2];  // the mask of the thread's two keys

  for (int it = 0; it < nq; ++it) {
    const int st = it & 1, q0 = qstart + it * kT;
    if (it + 1 < nq) {
      load_q(q0 + kT, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      madd[0] = Ms[wk + g];
      madd[1] = Ms[wk + g + 8];
    }
    const bf16* Q = Qs + st * kTcTile;
    const bf16* G = Gs + st * kTcTile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ka[4], va[4];
      tc_frag_a(ka, Ks, wk, kc, lane);
      tc_frag_a(va, Vs, wk, kc, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bg[4];
        tc_frag_bt(bq, Q, np * 16, kc, lane);
        tc_frag_bt(bg, G, np * 16, kc, lane);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bg[0], bg[1]);
        mma_bf16(dp[2 * np + 1], va, bg[2], bg[3]);
      }
    }
    // element (r, c) of n8 tile nt: key wk + g + 8 r, query 8 nt + 2 t + c
    auto probs = [&](auto full_t) {
      constexpr bool FULL = decltype(full_t)::value;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ql = nt * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + st * kT + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + st * kT + ql);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kl = wk + g + r * 8;
            const float bv =
                BIAS ? Bs[(st * kT + ql + c) * kBiasLdKV + kl] : 0.f;
            tc_probs<FULL, BIAS, DROP>(
                s[nt][2 * r + c], dp[nt][2 * r + c], madd[r], bv,
                c ? l2.y : l2.x, c ? d2.y : d2.x, tm, b, q0 + ql + c, k0 + kl,
                L, S, a.causal);
          }
      }
    };
    if (q0 + kT <= L && k0 + kT <= S &&
        (!a.causal || k0 + kT - 1 <= q0 + (S - L)))
      probs(std::true_type());
    else
      probs(std::false_type());
    // dv += p_drop^T do, dk += ds^T q over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], sa[4];
      mma_a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
      mma_a_from_c(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t bg[4], bq[4];
        tc_frag_b(bg, G, kk * 16, 2 * dd, lane);
        tc_frag_b(bq, Q, kk * 16, 2 * dd, lane);
        mma_bf16(av[2 * dd], pa, bg[0], bg[1]);
        mma_bf16(av[2 * dd + 1], pa, bg[2], bg[3]);
        mma_bf16(ak[2 * dd], sa, bq[0], bq[1]);
        mma_bf16(ak[2 * dd + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wk + g + r * 8;
    if (key >= S) continue;
    const size_t row = koff + (size_t)key * inner;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
          __floats2bfloat162_rn(ak[dt][2 * r], ak[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + d) =
          __floats2bfloat162_rn(av[dt][2 * r], av[dt][2 * r + 1]);
    }
  }
}

// Kernel 3 on the tensor cores: one block per (64-query tile, head,
// batch), warp w owns queries 16 w .. 16 w + 16. Q and dO stay in
// registers as A fragments; the 64-key tiles of K and V (with the mask)
// are double-buffered by cp.async. s = q k^T is the forward's product --
// the same instruction, fragments and k order (csrc/attention.cu
// attention_fwd_tc) -- then dp = do v^T, ds in registers, and dq += ds k.
template <bool BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads)
dq_tc(Args a, bf16* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kTcTile;       // dO
  bf16* Ks = Gs + kTcTile;       // [2][kTcTile]
  bf16* Vs = Ks + 2 * kTcTile;   // [2][kTcTile]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * kTcTile);  // [2][kT]
  float* Ls = Ms + 2 * kT;                                 // [kT]
  float* Ds = Ls + kT;                                     // [kT]
  float* Bs = Ds + kT;  // [2][kT][kBiasLdQ], with a bias

  const int L = a.L, S = a.S;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * kTcD;
  const size_t koff = (size_t)b * S * inner + (size_t)h * kTcD;
  const bf16* kb = (const bf16*)a.k + koff;
  const bf16* vb = (const bf16*)a.v + koff;
  const float* mb = a.mask + (a.mask_batched ? (size_t)b * S : 0);
  const Terms tm = make_terms(a.bias, a.seed, DROP, a.thr, a.scale, h, L, S);

  tc_load_tile(Qs, (const bf16*)a.q + qoff, q0, L, inner, kTcThreads);
  tc_load_tile(Gs, (const bf16*)a.dout + qoff, q0, L, inner, kTcThreads);
  load_rows(Ls, Ds, a.lse + ((size_t)b * a.H + h) * L,
            a.delta + ((size_t)b * a.H + h) * L, q0, L);
  auto load_kv = [&](int k0, int st) {
    tc_load_tile(Ks + st * kTcTile, kb, k0, S, inner, kTcThreads);
    tc_load_tile(Vs + st * kTcTile, vb, k0, S, inner, kTcThreads);
    if (BIAS)
      tc_load_bias(Bs + st * kT * kBiasLdQ, kBiasLdQ, tm.bias, q0, kT, L, k0,
                   S, kTcThreads);
    if (threadIdx.x < kT)
      Ms[st * kT + threadIdx.x] =
          k0 + threadIdx.x < S ? mb[k0 + threadIdx.x] : 0.f;
  };
  // causal: the tile's last row sees keys up to its index + (S - L)
  const int kend = a.causal ? min(S, min(q0 + kT, L) + (S - L)) : S;
  const int nk = (kend + kT - 1) / kT;
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[4][4], gf[4][4];
  float lse2[2], dl[2];  // the thread's two rows: lse times log2(e), delta
  float aq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[i][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int st = it & 1, k0 = it * kT;
    if (it + 1 < nk) {
      load_kv(k0 + kT, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        tc_frag_a(qf[kc], Qs, wr, kc, lane);
        tc_frag_a(gf[kc], Gs, wr, kc, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = Ls[wr + g + r * 8] * kLog2e;
        dl[r] = Ds[wr + g + r * 8];
      }
    }
    const bf16* K = Ks + st * kTcTile;
    const bf16* V = Vs + st * kTcTile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        tc_frag_bt(bk, K, np * 16, kc, lane);
        mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
        tc_frag_bt(bv, V, np * 16, kc, lane);
        mma_bf16(dp[2 * np], gf[kc], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], gf[kc], bv[2], bv[3]);
      }
    // element (r, c) of n8 tile nt: query wr + g + 8 r, key 8 nt + 2 t + c
    const float* Mt = Ms + st * kT;
    const float* Bt = Bs + st * kT * kBiasLdQ;
    auto probs = [&](auto full_t) {
      constexpr bool FULL = decltype(full_t)::value;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kl = nt * 8 + 2 * t;
        const float2 mk = *reinterpret_cast<const float2*>(Mt + kl);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ql = wr + g + r * 8;
          float2 bv = make_float2(0.f, 0.f);
          if (BIAS)
            bv = *reinterpret_cast<const float2*>(Bt + ql * kBiasLdQ + kl);
          tc_probs<FULL, BIAS, DROP>(s[nt][2 * r], dp[nt][2 * r], mk.x, bv.x,
                                     lse2[r], dl[r], tm, b, q0 + ql, k0 + kl,
                                     L, S, a.causal);
          tc_probs<FULL, BIAS, DROP>(s[nt][2 * r + 1], dp[nt][2 * r + 1],
                                     mk.y, bv.y, lse2[r], dl[r], tm, b,
                                     q0 + ql, k0 + kl + 1, L, S, a.causal);
        }
      }
    };
    if (q0 + kT <= L && k0 + kT <= S &&
        (!a.causal || k0 + kT - 1 <= q0 + (S - L)))
      probs(std::true_type());
    else
      probs(std::false_type());
    // dq += ds k over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      mma_a_from_c(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t bk[4];
        tc_frag_b(bk, K, kk * 16, 2 * dd, lane);
        mma_bf16(aq[2 * dd], sa, bk[0], bk[1]);
        mma_bf16(aq[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= L) continue;
    bf16* dst = dq + qoff + (size_t)row * inner;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(aq[dt][2 * r], aq[dt][2 * r + 1]);
  }
}

// kernels 2 and 3 on the tensor-core route (bf16, Dh 64)
template <bool BIAS, bool DROP>
int launch_tc_terms(const Args& a, void* dq, void* dk, void* dv, int B,
                    cudaStream_t st) {
  const size_t smem_kv = tc_smem_kv(BIAS);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc<BIAS, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_tc<BIAS, DROP><<<dim3((a.S + kT - 1) / kT, a.H, B), kTcThreads,
                        smem_kv, st>>>(a, (bf16*)dk, (bf16*)dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = tc_smem_q(BIAS);
  err = cudaFuncSetAttribute(dq_tc<BIAS, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_tc<BIAS, DROP><<<dim3((a.L + kT - 1) / kT, a.H, B), kTcThreads, smem_q,
                      st>>>(a, (bf16*)dq);
  return (int)cudaGetLastError();
}

int launch_tc(const Args& a, void* dq, void* dk, void* dv, int B,
              cudaStream_t st) {
  if (a.bias != nullptr)
    return a.drop ? launch_tc_terms<true, true>(a, dq, dk, dv, B, st)
                  : launch_tc_terms<true, false>(a, dq, dk, dv, B, st);
  return a.drop ? launch_tc_terms<false, true>(a, dq, dk, dv, B, st)
                : launch_tc_terms<false, false>(a, dq, dk, dv, B, st);
}

template <typename T, int NJ>
int launch_all(Args a, const void* out, void* dq, void* dk, void* dv,
               float* delta, float* dbias, int B, int tc, cudaStream_t st) {
  const long rows = (long)B * a.L * a.H;
  delta_kernel<T><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>((const T*)out, (const T*)a.dout, delta,
                                       a.L, a.H, a.Dh, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.delta = delta;

  const size_t tile = (size_t)kT * (a.Dh + 1);
  if (tc) {
    err = (cudaError_t)launch_tc(a, dq, dk, dv, B, st);
    if (err != cudaSuccess || dbias == nullptr) return (int)err;
    return launch_dbias<T>(a, dbias, B, tile, st);
  }
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
  return launch_dbias<T>(a, dbias, B, tile, st);
}

template <typename T>
int launch_dh(const Args& a, const void* out, void* dq, void* dk, void* dv,
              float* delta, float* dbias, int B, int tc, cudaStream_t st) {
  if (a.Dh <= 64)
    return launch_all<T, 4>(a, out, dq, dk, dv, delta, dbias, B, tc, st);
  return launch_all<T, 8>(a, out, dq, dk, dv, delta, dbias, B, tc, st);
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
    int is_bf16, int tc, int drop, int thr, float scale, void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535 || (causal && S < L) || (tc && (!is_bf16 || Dh != kTcD)) ||
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
                           B, tc, st);
  return launch_dh<float>(a, out, dq, dk, dv, (float*)delta, (float*)dbias, B,
                          tc, st);
}
