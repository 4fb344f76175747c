// Reorder-free beam self-attention for one decode step.
//
// Replaces vlpet_tpu/ops/decode.py:_beam_self_attend_pallas
// (_beam_self_kernel). For each (batch b, beam k, head h), over cache slots
// t <= pos: row = b*J + anc[b, k, t]; s_t = q . K[t, row]; out =
// sum_t softmax(s)_t V[t, row], where s_t gains bias[h, t] when a T5
// relative-bias row (f32 (H, Lc), the same for every beam) is given. The
// time-major cache (Lc, B*J, H*Dh) is
// never reordered. The TPU kernel scored every beam against all tb*J rows
// of its block through a flat (B*K, Lc*8*J) additive mask built per step;
// here each warp reads the raw ancestry and gathers exactly its beam's
// history, so no mask tensor exists and no row is scored for nothing.
//
// Bound on the H100: pure memory -- every step reads (pos+1) cache rows
// per beam and head (<= 2 * Lc * B*K * H*Dh elements) for ~4 FLOPs per
// element. Design: one warp per (b, k, h); lanes split the head dim, so
// each cache row is one coalesced 128-byte (bf16) or 256-byte (fp32) read,
// the dot product is a warp reduction, and the softmax runs online over t
// in registers (fp32), with no shared memory and no mask.
//
// The fused step (D2) replaces vlpet_tpu/ops/decode.py:
// beam_decode_attend_update (_beam_self_update_kernel): the same attend
// over the slots t <= pos - 1 only, plus an own-row term -- each beam's
// score against this step's k_new, its elementwise products rounded to the
// compute dtype as the TPU kernel rounds them, plus own_bias[h] (T5's
// distance-0 bias) -- under one softmax, and the write of k_new / v_new
// into slot pos of the cache in the same launch. The online softmax starts
// from the own-row score (m = s_own, sum = 1, acc = v_new), so at pos 0,
// where no cache slot is attendable, nothing is -inf. Warp (b, k, h) writes
// row b*J + k (J == K), head h of slot pos before its loop; no warp reads
// slot pos, so the warps' order does not matter. Bound: D1's bytes plus the slot's k/v
// read and write.
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kWarps = 4;
constexpr int kMaxDh = 128;
constexpr int kDPL = kMaxDh / 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
beam_attend_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ anc,
                   const float* __restrict__ bias, T* __restrict__ out, int B,
                   int K, int J, int Lc, int H, int Dh, int pos) {
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= B * K * H) return;  // whole warp
  const int h = gw % H;
  const int bk = gw / H;  // b*K + k
  const int b = bk / K;
  const int inner = H * Dh;
  const size_t slot = (size_t)B * J * inner;  // one time step of the cache

  float qv[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < Dh ? to_f(q[(size_t)bk * inner + (size_t)h * Dh + d]) : 0.f;
    acc[i] = 0.f;
  }
  const int* a = anc + (size_t)bk * Lc;
  const float* brow = bias != nullptr ? bias + (size_t)h * Lc : nullptr;
  float m = -INFINITY, lsum = 0.f;
  for (int t = 0; t <= pos; ++t) {
    const size_t off =
        t * slot + (size_t)(b * J + a[t]) * inner + (size_t)h * Dh;
    const T* kr = kc + off;
    const T* vr = vc + off;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) part = fmaf(qv[i], to_f(kr[d]), part);
    }
    float s = warp_sum(part);
    if (brow != nullptr) s += brow[t];
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);
    const float p = expf(s - mn);
    lsum = lsum * corr + p;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) acc[i] = fmaf(p, to_f(vr[d]), acc[i] * corr);
    }
    m = mn;
  }
  const float inv = 1.f / lsum;
  T* orow = out + (size_t)bk * inner + (size_t)h * Dh;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) orow[d] = from_f<T>(acc[i] * inv);
  }
}

// D2: one warp per (b, k, h): the slot write, then the own row (k_new,
// v_new at row b*K + k) as the first term, then slots t < pos through the
// ancestry.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
beam_attend_update_kernel(const T* __restrict__ q, T* __restrict__ kc,
                          T* __restrict__ vc, const T* __restrict__ kn,
                          const T* __restrict__ vn, const int* __restrict__ anc,
                          const float* __restrict__ bias,
                          const float* __restrict__ obias, T* __restrict__ out,
                          int B, int K, int Lc, int H, int Dh, int pos) {
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= B * K * H) return;  // whole warp
  const int h = gw % H;
  const int bk = gw / H;  // b*K + k, also the row b*J + j of k_new / v_new
  const int b = bk / K;
  const int inner = H * Dh;
  const size_t slot = (size_t)B * K * inner;  // one time step of the cache
  const size_t own = (size_t)bk * inner + (size_t)h * Dh;

  T* kw = kc + (size_t)pos * slot + own;
  T* vw = vc + (size_t)pos * slot + own;
  float qv[kDPL], acc[kDPL];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = 0.f;
    acc[i] = 0.f;
    if (d < Dh) {
      const T kd = kn[own + d], vd = vn[own + d];
      // the slot write first: after the loop it cost ~25% more time a
      // slot (B 500, pos 39), before it almost nothing
      kw[d] = kd;
      vw[d] = vd;
      qv[i] = to_f(q[own + d]);
      // the own-row product in the compute dtype, summed in fp32
      part += to_f(from_f<T>(qv[i] * to_f(kd)));
      acc[i] = to_f(vd);
    }
  }
  float m = warp_sum(part);
  if (obias != nullptr) m += obias[h];
  float lsum = 1.f;
  const int* a = anc + (size_t)bk * Lc;
  const float* brow = bias != nullptr ? bias + (size_t)h * Lc : nullptr;
  for (int t = 0; t < pos; ++t) {
    const size_t off =
        t * slot + (size_t)(b * K + a[t]) * inner + (size_t)h * Dh;
    const T* kr = kc + off;
    const T* vr = vc + off;
    float p2 = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) p2 = fmaf(qv[i], to_f(kr[d]), p2);
    }
    float s = warp_sum(p2);
    if (brow != nullptr) s += brow[t];
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);
    const float p = expf(s - mn);
    lsum = lsum * corr + p;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) acc[i] = fmaf(p, to_f(vr[d]), acc[i] * corr);
    }
    m = mn;
  }
  const float inv = 1.f / lsum;
  T* orow = out + own;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) orow[d] = from_f<T>(acc[i] * inv);
  }
}

}  // namespace

extern "C" int vlpet_beam_attend(const void* q, const void* kc,
                                 const void* vc, const void* anc,
                                 const void* bias, void* out, int B, int K,
                                 int J, int Lc, int H, int Dh, int pos,
                                 int is_bf16, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || pos < 0 || pos >= Lc || B < 1 || K < 1 ||
      J < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = B * K * H;
  const int blocks = (warps + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    beam_attend_kernel<bf16><<<blocks, kWarps * 32, 0, st>>>(
        (const bf16*)q, (const bf16*)kc, (const bf16*)vc, (const int*)anc,
        (const float*)bias, (bf16*)out, B, K, J, Lc, H, Dh, pos);
  } else {
    beam_attend_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (const float*)q, (const float*)kc, (const float*)vc,
        (const int*)anc, (const float*)bias, (float*)out, B, K, J, Lc, H, Dh,
        pos);
  }
  return (int)cudaGetLastError();
}

// q, k_new, v_new, out (B*K, H*Dh); caches (Lc, B*K, H*Dh), slot pos written
// in place; anc (B, K, Lc) int32; bias (H, Lc) and own bias (H,) f32 or NULL
extern "C" int vlpet_beam_attend_update(const void* q, void* kc, void* vc,
                                        const void* kn, const void* vn,
                                        const void* anc, const void* bias,
                                        const void* obias, void* out, int B,
                                        int K, int Lc, int H, int Dh, int pos,
                                        int is_bf16, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || pos < 0 || pos >= Lc || B < 1 || K < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = B * K * H;
  const int blocks = (warps + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    beam_attend_update_kernel<bf16><<<blocks, kWarps * 32, 0, st>>>(
        (const bf16*)q, (bf16*)kc, (bf16*)vc, (const bf16*)kn,
        (const bf16*)vn, (const int*)anc, (const float*)bias,
        (const float*)obias, (bf16*)out, B, K, Lc, H, Dh, pos);
  } else {
    beam_attend_update_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (const float*)q, (float*)kc, (float*)vc, (const float*)kn,
        (const float*)vn, (const int*)anc, (const float*)bias,
        (const float*)obias, (float*)out, B, K, Lc, H, Dh, pos);
  }
  return (int)cudaGetLastError();
}
