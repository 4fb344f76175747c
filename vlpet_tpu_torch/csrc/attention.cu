// Attention forward: out = softmax(q . k^T + mask) . v, per (batch, head).
//
// Replaces vlpet_tpu/ops/attention.py:_pallas_attention (_fwd_kernel), the
// TPU kernel behind fused_attention. Layout as there: q (B, L, H*Dh)
// pre-scaled, k/v (B, S, H*Dh), additive f32 padding mask (B|1, S)
// broadcast over heads and query rows in-kernel (no (B, 1, L, S) tensor).
// An optional batch-shared per-head bias (T5 relative positions), f32
// (H, L, S), is added to the logits after the mask, as in _head_logits:
// the (B, H, L, S) sum of bias and mask never exists.
// With ``causal`` the decoder triangle is applied in-kernel as in
// _shared_terms / _head_logits: query i sees key j iff j <= i + (S - L),
// and a hidden logit is set to -1e9 after the mask and bias are added.
// With ``drop`` the probabilities take T5's attention dropout as in
// _fwd_kernel: element (b, i, j) of head h is kept iff
// hash_bits((b * L + i) * S + j, head_seed(seed, h)) >= thr (common.cuh;
// the global index, so the 16-query tiles give the TPU's bits) and kept
// probabilities are scaled by 1 / (1 - rate). The online softmax divides by
// the row sum only at the end, so the P.V numerator takes the dropped
// terms and the row sum the undropped ones: out = scale * sum_j keep_j
// e_j v_j / sum_j e_j, the dropped normalised probabilities times v. The
// seed is a (1,) int32 device tensor read by pointer.
//
// Bound on the H100: at the slice's shapes (L, S <= 56, Dh 64) each block
// reads its K/V head slice once and does ~2*L*S*Dh FLOPs per head, far
// below the tensor-core ridge, so the kernel is bound by load latency and
// launch width, not FLOPs. Design: one block per (query tile of 16 rows,
// head, batch) -- 24k blocks at the encoder shape -- with K/V tiles of 32
// keys staged in shared memory as fp32 (K rows padded by one float so the
// lane-per-key dot products hit distinct banks), one warp per 4 query rows,
// and an online softmax over the key tiles. Logits, softmax and the
// accumulation are fp32 throughout.
//
// Long sequences (the video path, S 604 and 1024): the same kernel serves
// the per-head and query-strip forwards (_pallas_attention_perhead,
// _pallas_attention_ltiled), which compute this function; the key tiles
// bound its shared memory at any S. Given a non-null ``lse`` it also
// writes the fp32 row logsumexp (B, H, L) of the masked logits, from which
// the long backward (csrc/attention_bwd_long.cu) recomputes p.
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kQT = kWarps * kRows;      // query rows per block
constexpr int kKT = 32;                  // keys per tile: one per lane
constexpr int kMaxDh = 128;
constexpr int kDPL = kMaxDh / 32;        // output dims per lane

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed_p, T* __restrict__ out,
                     float* __restrict__ lse, int L, int S, int H, int Dh,
                     int mask_batched, int causal, int drop, uint32_t thr,
                     float scale) {
  extern __shared__ float smem[];
  const int ks = Dh + 1;
  float* Ks = smem;                  // [kKT][Dh + 1]
  float* Vs = Ks + kKT * ks;         // [kKT][Dh]
  float* Qs = Vs + kKT * Dh;         // [kQT][Dh]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQT;
  const int inner = H * Dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (size_t)b * L * inner + (size_t)h * Dh;
  const T* kb = k + (size_t)b * S * inner + (size_t)h * Dh;
  const T* vb = v + (size_t)b * S * inner + (size_t)h * Dh;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const uint32_t hseed = drop ? head_seed((uint32_t)seed_p[0], h) : 0u;

  for (int i = tid; i < kQT * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    const int row = q0 + r;
    Qs[i] = row < L ? to_f(qb[(size_t)row * inner + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDPL];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[rr][i] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kKT) {
    __syncthreads();  // previous tile consumed; Qs written on the first pass
    for (int i = tid; i < kKT * Dh; i += blockDim.x) {
      const int j = i / Dh, d = i - j * Dh;
      const int s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_f(kb[(size_t)s * inner + d]);
        vv = to_f(vb[(size_t)s * inner + d]);
      }
      Ks[j * ks + d] = kv;
      Vs[j * Dh + d] = vv;
    }
    __syncthreads();

    const int s = s0 + lane;
    const bool valid = s < S;
    const float madd = valid ? mb[s] : 0.f;
    const float* kr = Ks + lane * ks;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      if (q0 + r < L) {  // warp-uniform
        const float* qr = Qs + r * Dh;
        float sc = 0.f;
        for (int d = 0; d < Dh; ++d) sc = fmaf(qr[d], kr[d], sc);
        sc = valid ? sc + madd : -INFINITY;
        if (valid && bias != nullptr)
          sc += bias[((size_t)h * L + q0 + r) * S + s];
        if (valid && causal && s > q0 + r + (S - L)) sc = -1e9f;
        // key 0 of every tile is valid, so mn is finite
        const float mn = fmaxf(m[rr], warp_max(sc));
        const float p = expf(sc - mn);
        const float corr = expf(m[rr] - mn);
        l[rr] = l[rr] * corr + warp_sum(p);
        float pv = p;  // the numerator's term: dropped where not kept
        if (drop && valid) {
          const uint32_t idx =
              ((uint32_t)b * (uint32_t)L + (uint32_t)(q0 + r)) * (uint32_t)S +
              (uint32_t)s;
          if (hash_bits(idx, hseed) < thr) pv = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[rr][i] *= corr;
        for (int j = 0; j < kKT; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pv, j);
          const float* vr = Vs + j * Dh;
#pragma unroll
          for (int i = 0; i < kDPL; ++i) {
            const int d = lane + 32 * i;
            if (d < Dh) acc[rr][i] = fmaf(pj, vr[d], acc[rr][i]);
          }
        }
        m[rr] = mn;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = q0 + warp * kRows + rr;
    if (row < L) {
      const float inv = (drop ? scale : 1.f) / l[rr];
      T* orow = out + ((size_t)b * L + row) * inner + (size_t)h * Dh;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) orow[d] = from_f<T>(acc[rr][i] * inv);
      }
      if (lse != nullptr && lane == 0)
        lse[((size_t)b * H + h) * L + row] = m[rr] + logf(l[rr]);
    }
  }
}

}  // namespace

extern "C" int vlpet_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* bias, const void* seed,
                                   void* out, void* lse, int B, int L, int S,
                                   int H, int Dh, int mask_batched,
                                   int causal, int is_bf16, int drop, int thr,
                                   float scale, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || B < 1 || L < 1 || S < 1 || H < 1 ||
      (drop && (seed == nullptr || thr < 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kQT - 1) / kQT, H, B);
  const size_t smem = sizeof(float) * ((size_t)kKT * (Dh + 1) +
                                       (size_t)kKT * Dh + (size_t)kQT * Dh);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    attention_fwd_kernel<bf16><<<grid, kWarps * 32, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask,
        (const float*)bias, (const int*)seed, (bf16*)out, (float*)lse, L, S,
        H, Dh, mask_batched, causal, drop, (uint32_t)thr, scale);
  } else {
    attention_fwd_kernel<float><<<grid, kWarps * 32, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)mask, (const float*)bias, (const int*)seed,
        (float*)out, (float*)lse, L, S, H, Dh, mask_batched, causal, drop,
        (uint32_t)thr, scale);
  }
  return (int)cudaGetLastError();
}
