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
