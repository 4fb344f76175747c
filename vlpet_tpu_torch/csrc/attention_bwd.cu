// Attention backward (A6): dq, dk, dv (and, on request, the bias's
// cotangent dbias) of
//   out = drop(softmax(q . k^T + mask [+ bias] [causal])) . v.
//
// Replaces vlpet_tpu/ops/attention.py:_pallas_attention_bwd (_bwd_kernel),
// the TPU backward behind fused_attention's custom_vjp. Layout as the
// forward (csrc/attention.cu): q, do (B, L, H*Dh), q pre-scaled; k, v
// (B, S, H*Dh); additive f32 padding mask (B|1, S); ``causal`` hides key j
// from query i unless j <= i + (S - L) (logit set to -1e9 after the mask).
// The mask gets no gradient. As in the TPU kernel, p is recomputed (nothing
// but q, k, v and the mask is saved by the forward) and the backward runs
// in fp32 on fp32 p and fp32 do:
//   dv = p^T do,  dp = do v^T,  ds = p (dp - rowsum(dp p)),
//   dq = ds k,    dk = ds^T q,
// with dq, dk, dv stored in the input dtype. The T5 training terms, as in
// _bwd_kernel: an optional batch-shared per-head bias (H, L, S) f32 added
// after the mask, and with ``drop`` the probability dropout, its mask
// regenerated from the seed as the forward draws it
// (hash_bits((b * L + i) * S + j, head_seed(seed, h)), common.cuh):
//   dv = p_drop^T do,  dp = keep ? (do v^T) / (1 - rate) : 0,
//   ds = p (dp - rowsum(dp p)) with the UNdropped p,
// p_drop = keep ? p / (1 - rate) : 0 being the forward's dropped
// probabilities.
//
// dbias (_bwd_kernel's bias_grad, a trainable relative_attention_bias):
// dbias[h] = sum_b ds[b, h]. The TPU sums over the batch in a grid-resident
// block, its grid being sequential; a CUDA grid is not, and float atomics
// would make the sum depend on scheduling. So each (head, batch) block
// writes its ds to an fp32 partial (B, H, L, S), and a second kernel, one
// thread per (h, i, j), sums the partials in batch order: deterministic.
// The scratch is B H L S floats: 45 MB at T5's encoder site (B 300, H 12,
// L = S = 56), written once and read once, 0.027 ms of memory time at
// 3.35 TB/s beside the ~1.3 ms of the backward itself.
//
// Bound on the H100: per (batch, head) the work is 10 L S Dh FLOPs against
// 4 (L + S) Dh inputs and outputs; at the encoder site (B 500, H 12,
// L = S = 56, Dh 64) that is 12 GFLOP and 7 x 43 MB of bf16 traffic (q, k,
// v, do in; dq, dk, dv out): ~0.09 ms of memory time against ~0.012 ms of
// bf16 tensor-core time, so the bound is the bytes. Design: one block per
// (head, batch) -- 6000 blocks at the encoder site -- holds the whole head:
// q, do, k, v in shared memory as fp32 (k and v rows padded one float so
// the lane-per-key dot products hit distinct banks) and the (L, S) p and
// dp/ds matrices, so dk and dv, which reduce over the query rows, are
// summed inside the block: no atomics, and the result does not depend on
// scheduling. The products run on FP32 FMA from shared memory (the L, S <=
// 56 tiles of the training sites are below a tensor-core tile's
// efficiency); making it fast (mma.sync on the bf16 inputs) is later work.
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsB = kThreads / 32;

inline size_t bwd_smem_floats(int L, int S, int Dh) {
  return (size_t)2 * L * Dh + (size_t)2 * S * (Dh + 1) + (size_t)2 * L * S;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed_p,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias_part, int L, int S,
                     int H, int Dh, int mask_batched, int causal, int drop,
                     uint32_t thr, float scale) {
  extern __shared__ float sm[];
  const int ks = Dh + 1;
  float* Qs = sm;                  // [L][Dh]
  float* dOs = Qs + L * Dh;        // [L][Dh]
  float* Ks = dOs + L * Dh;        // [S][Dh + 1]
  float* Vs = Ks + S * ks;         // [S][Dh + 1]
  float* P = Vs + S * ks;          // [L][S]
  float* dP = P + L * S;           // [L][S]: dp, then ds

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = H * Dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * Dh;
  const size_t koff = (size_t)b * S * inner + (size_t)h * Dh;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const float* bh = bias != nullptr ? bias + (size_t)h * L * S : nullptr;
  const uint32_t hseed = drop ? head_seed((uint32_t)seed_p[0], h) : 0u;
  // global flat index of (b, row 0, key 0) in the (B, L, S) dropout mask
  const uint32_t ibase = (uint32_t)b * (uint32_t)L * (uint32_t)S;

  for (int i = tid; i < L * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const size_t g = qoff + (size_t)r * inner + d;
    Qs[i] = to_f(q[g]);
    dOs[i] = to_f(dout[g]);
  }
  for (int i = tid; i < S * Dh; i += kThreads) {
    const int s = i / Dh, d = i - s * Dh;
    const size_t g = koff + (size_t)s * inner + d;
    Ks[s * ks + d] = to_f(k[g]);
    Vs[s * ks + d] = to_f(v[g]);
  }
  __syncthreads();

  // logits (masked, biased) and dp = do . v^T
  for (int i = tid; i < L * S; i += kThreads) {
    const int r = i / S, s = i - r * S;
    const float* qr = Qs + r * Dh;
    const float* gr = dOs + r * Dh;
    const float* kr = Ks + s * ks;
    const float* vr = Vs + s * ks;
    float a = 0.f, c = 0.f;
    for (int d = 0; d < Dh; ++d) {
      a = fmaf(qr[d], kr[d], a);
      c = fmaf(gr[d], vr[d], c);
    }
    a += mb[s];
    if (bh != nullptr) a += bh[i];
    if (causal && s > r + (S - L)) a = -1e9f;
    P[i] = a;
    dP[i] = c;
  }
  __syncthreads();

  // per row: p = softmax(logits); dp through the dropout mask;
  // ds = p (dp - rowsum(dp p)); then P holds the dropped p for dv
  for (int r = warp; r < L; r += kWarpsB) {
    float* pr = P + r * S;
    float* dr = dP + r * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, pr[s]);
    m = warp_max(m);
    float z = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(pr[s] - m);
      pr[s] = e;
      z += e;
    }
    z = warp_sum(z);
    float t = 0.f;
    const uint32_t irow = ibase + (uint32_t)r * (uint32_t)S;
    for (int s = lane; s < S; s += 32) {
      const float p = pr[s] / z;
      pr[s] = p;
      if (drop) dr[s] = drop_elem(dr[s], irow + s, hseed, thr, scale);
      t = fmaf(dr[s], p, t);
    }
    t = warp_sum(t);
    for (int s = lane; s < S; s += 32) {
      const float p = pr[s];
      dr[s] = p * (dr[s] - t);
      if (drop) pr[s] = drop_elem(p, irow + s, hseed, thr, scale);
    }
  }
  __syncthreads();

  // this (batch, head)'s ds, for the in-order batch sum of dbias
  if (dbias_part != nullptr) {
    float* dst = dbias_part + ((size_t)b * H + h) * L * S;
    for (int i = tid; i < L * S; i += kThreads) dst[i] = dP[i];
  }

  // dv = p_drop^T . do and dk = ds^T . q, summed over the query rows in
  // order
  T* dvb = dv + koff;
  T* dkb = dk + koff;
  for (int i = tid; i < S * Dh; i += kThreads) {
    const int s = i / Dh, d = i - s * Dh;
    float av = 0.f, ak = 0.f;
    for (int r = 0; r < L; ++r) {
      av = fmaf(P[r * S + s], dOs[r * Dh + d], av);
      ak = fmaf(dP[r * S + s], Qs[r * Dh + d], ak);
    }
    dvb[(size_t)s * inner + d] = from_f<T>(av);
    dkb[(size_t)s * inner + d] = from_f<T>(ak);
  }
  // dq = ds . k
  T* dqb = dq + qoff;
  for (int i = tid; i < L * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const float* dsr = dP + r * S;
    float a = 0.f;
    for (int s = 0; s < S; ++s) a = fmaf(dsr[s], Ks[s * ks + d], a);
    dqb[(size_t)r * inner + d] = from_f<T>(a);
  }
}

// dbias[i] = sum_b part[b, i] over the n = H L S entries, b in order.
__global__ void __launch_bounds__(kThreads)
dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                    int B, long n) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
  dbias[i] = acc;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* bias, const void* seed, const void* dout, void* dq,
           void* dk, void* dv, void* dbias_part, void* dbias, int B, int L,
           int S, int H, int Dh,
           int mask_batched, int causal, int drop, uint32_t thr, float scale,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * bwd_smem_floats(L, S, Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<T><<<dim3(H, B), kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const float*)bias, (const int*)seed, (const T*)dout, (T*)dq, (T*)dk,
      (T*)dv, (float*)dbias_part, L, S, H, Dh, mask_batched, causal, drop,
      thr, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return (int)err;
  const long n = (long)H * L * S;
  dbias_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        st>>>((const float*)dbias_part, (float*)dbias, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dbias_part: fp32 scratch of B * H * L * S floats and dbias the (H, L, S)
// fp32 output, both NULL for no bias gradient (they need a bias).
extern "C" int vlpet_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* bias, const void* seed,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* dbias_part, void* dbias,
                                   int B, int L, int S, int H, int Dh,
                                   int mask_batched, int causal, int is_bf16,
                                   int drop, int thr, float scale,
                                   void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || Dh < 1 || B > 65535 ||
      (drop && (seed == nullptr || thr < 0)) ||
      ((dbias != nullptr) != (dbias_part != nullptr)) ||
      (dbias != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<bf16>(q, k, v, mask, bias, seed, dout, dq, dk, dv,
                        dbias_part, dbias, B, L, S, H, Dh, mask_batched,
                        causal, drop, (uint32_t)thr, scale, st);
  return launch<float>(q, k, v, mask, bias, seed, dout, dq, dk, dv,
                       dbias_part, dbias, B, L, S, H, Dh, mask_batched, causal,
                       drop, (uint32_t)thr, scale, st);
}
