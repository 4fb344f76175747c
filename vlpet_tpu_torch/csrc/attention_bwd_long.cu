// Attention backward for long sequences: dq, dk, dv of
// out = softmax(q . k^T + mask) . v, tiled over queries and keys.
//
// Replaces vlpet_tpu/ops/attention.py:_pallas_attention_perhead_bwd
// (_ph_bwd_kernel, one head's whole (L, S) block per program) and
// _pallas_attention_ltiled_bwd (_lt_bwd_kernel, query strips against all
// keys with f32 dK/dV resident across the sequential row sweep), the TPU
// backwards of the video path (S 604 and 1024). Layout as A6
// (csrc/attention_bwd.cu): q, do, out (B, L, H*Dh), q pre-scaled; k, v
// (B, S, H*Dh); additive f32 padding mask (B|1, S); ``causal`` hides key j
// from query i unless j <= i + (S - L), the logit set to -1e9 after the
// mask. The mask gets no gradient. Dh <= 128, fp32 or bf16 in, fp32
// arithmetic, outputs in the input dtype.
//
// Why not A6: A6 holds a whole (L, S) head in shared memory, 3.5 MB at
// L = S = 604. Here p is recomputed tile by tile from the forward's row
// logsumexp (csrc/attention.cu writes it; the logits are the same fmaf
// chain over Dh, so p = exp(s - lse) is the forward's softmax), and
// softmax's row term rowsum(dp p) is rowsum(do . out) (delta), computed
// once by a pre-pass. Three kernels, no atomics, so every output element is
// one thread's fixed-order sum and the result does not depend on
// scheduling (the fp32 train-step parity holds kernel and plain steps to
// 1e-5):
//   1. delta[b, h, i] = sum_d do[b, i, h, d] out[b, i, h, d], one warp per
//      (b, i, h);
//   2. dk/dv: one block per (64-key tile, head, batch) keeps K, V and its
//      dk, dv accumulators and loops over the 64-query tiles:
//      p = exp(q k^T + mask - lse), ds = p (do v^T - delta),
//      dv += p^T do, dk += ds^T q;
//   3. dq: one block per (64-query tile, head, batch) keeps Q, dO and its
//      dq accumulator and loops over the 64-key tiles: dq += ds k.
// Tails (S 604 is no multiple of 64) are zero-filled tiles whose p and ds
// are forced to 0. With ``causal`` the tiles that no row may see are
// skipped (their p would be exp(-1e9 - lse) = 0 exactly).
//
// Bound on the H100: at the video encoder site (B 50, H 12, L = S = 604,
// Dh 64) the function is 10 B H L S Dh = 140 GFLOP against 325 MB of bf16
// q, k, v, do in and dq, dk, dv out: 0.142 ms at the bf16 tensor-core peak
// against 0.097 ms of memory time, so the bound is the operations. This
// kernel recomputes q k^T and do v^T in both (2) and (3) (14 B H L S Dh in
// all) on FP32 FMA from shared memory: each thread owns a 4 x 4 tile of
// the 64 x 64 logits and a 4 x (Dh / 16) tile of its outputs, two FMAs per
// shared-memory load. mma/wgmma on the bf16 inputs are later work.
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

// One (query tile q0, key tile k0) pair: s = Q K^T and dp = dO V^T for the
// thread's 4 x 4 entries, then p = exp(s + mask - lse) and
// ds = p (dp - delta) into P (when kWriteP) and dS, both [kT][kPL]; zero
// outside the L x S range. Ms, Ls, Ds: the key tile's mask, the query
// tile's lse and delta.
template <bool kWriteP>
__device__ __forceinline__ void probs_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ms, const float* Ls, const float* Ds, float* P, float* dS,
    int q0, int k0, int L, int S, int Dh, int causal) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ld = Dh + 1;
  float s[4][4], dp[4][4];
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
      float p = 0.f, ds = 0.f;
      if (qi < L && kj < S) {
        float a = s[i][j] + Ms[c];
        if (causal && kj > qi + (S - L)) a = -1e9f;
        p = expf(a - Ls[r]);
        ds = p * (dp[i][j] - Ds[r]);
      }
      if (kWriteP) P[r * kPL + c] = p;
      dS[r * kPL + c] = ds;
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

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ mask,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, int L, int S, int H, int Dh, int mask_batched,
            int causal) {
  extern __shared__ float sm[];
  const int ld = Dh + 1;
  float* Ks = sm;                  // [kT][Dh + 1]
  float* Vs = Ks + kT * ld;        // [kT][Dh + 1]
  float* Qs = Vs + kT * ld;        // [kT][Dh + 1]
  float* dOs = Qs + kT * ld;       // [kT][Dh + 1]
  float* P = dOs + kT * ld;        // [kT][kPL]
  float* dS = P + kT * kPL;        // [kT][kPL]
  float* Ms = dS + kT * kPL;       // [kT]
  float* Ls = Ms + kT;             // [kT]
  float* Ds = Ls + kT;             // [kT]

  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int inner = H * Dh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
  const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const float* lb = lse + ((size_t)b * H + h) * L;
  const float* db = delta + ((size_t)b * H + h) * L;

  load_tile(Ks, k + koff, k0, S, inner, Dh);
  load_tile(Vs, v + koff, k0, S, inner, Dh);
  for (int c = threadIdx.x; c < kT; c += kThreads)
    Ms[c] = k0 + c < S ? mb[k0 + c] : 0.f;

  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // causal: rows before k0 - (S - L) see no key of this tile
  const int qstart = causal ? max(0, k0 - (S - L)) / kT * kT : 0;
  for (int q0 = qstart; q0 < L; q0 += kT) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(Qs, q + qoff, q0, L, inner, Dh);
    load_tile(dOs, dout + qoff, q0, L, inner, Dh);
    load_rows(Ls, Ds, lb, db, q0, L);
    __syncthreads();
    probs_tile<true>(Qs, dOs, Ks, Vs, Ms, Ls, Ds, P, dS, q0, k0, L, S, Dh,
                     causal);
    __syncthreads();
    // dv += p^T do, dk += ds^T q, over the tile's rows in order
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
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ mask,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int L, int S,
          int H, int Dh, int mask_batched, int causal) {
  extern __shared__ float sm[];
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
  const int inner = H * Dh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
  const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);

  load_tile(Qs, q + qoff, q0, L, inner, Dh);
  load_tile(dOs, dout + qoff, q0, L, inner, Dh);
  load_rows(Ls, Ds, lse + ((size_t)b * H + h) * L,
            delta + ((size_t)b * H + h) * L, q0, L);

  float aq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;

  // causal: the tile's last row sees keys up to (its index) + (S - L)
  const int kend = causal ? min(S, min(q0 + kT, L) + (S - L)) : S;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(Ks, k + koff, k0, S, inner, Dh);
    load_tile(Vs, v + koff, k0, S, inner, Dh);
    for (int c = threadIdx.x; c < kT; c += kThreads)
      Ms[c] = k0 + c < S ? mb[k0 + c] : 0.f;
    __syncthreads();
    probs_tile<false>(Qs, dOs, Ks, Vs, Ms, Ls, Ds, nullptr, dS, q0, k0, L,
                      S, Dh, causal);
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

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* out, const void* lse, const void* dout, void* dq,
           void* dk, void* dv, void* delta, int B, int L, int S, int H,
           int Dh, int mask_batched, int causal, cudaStream_t st) {
  const long rows = (long)B * L * H;
  delta_kernel<T><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>((const T*)out, (const T*)dout,
                                       (float*)delta, L, H, Dh, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t tile = (size_t)kT * (Dh + 1);
  const size_t smem_kv = sizeof(float) * (4 * tile + 2 * kT * kPL + 3 * kT);
  err = cudaFuncSetAttribute(dkdv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, NJ><<<dim3((S + kT - 1) / kT, H, B), kThreads, smem_kv, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      L, S, H, Dh, mask_batched, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (4 * tile + kT * kPL + 3 * kT);
  err = cudaFuncSetAttribute(dq_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, NJ><<<dim3((L + kT - 1) / kT, H, B), kThreads, smem_q, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, L, S,
      H, Dh, mask_batched, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* mask,
              const void* out, const void* lse, const void* dout, void* dq,
              void* dk, void* dv, void* delta, int B, int L, int S, int H,
              int Dh, int mask_batched, int causal, cudaStream_t st) {
  if (Dh <= 64)
    return launch<T, 4>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, B,
                        L, S, H, Dh, mask_batched, causal, st);
  return launch<T, 8>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, B, L,
                      S, H, Dh, mask_batched, causal, st);
}

}  // namespace

// delta: fp32 scratch of B * H * L floats (the wrapper allocates it).
extern "C" int vlpet_attention_bwd_long(
    const void* q, const void* k, const void* v, const void* mask,
    const void* out, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int B, int L, int S, int H, int Dh,
    int mask_batched, int causal, int is_bf16, void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || Dh < 1 || Dh > 128 || B > 65535 ||
      H > 65535 || (causal && S < L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<bf16>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta,
                           B, L, S, H, Dh, mask_batched, causal, st);
  return launch_dh<float>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, B,
                          L, S, H, Dh, mask_batched, causal, st);
}
