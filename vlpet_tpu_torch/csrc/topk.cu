// Exact top-k + row logsumexp over f32 logits (R, V), 1 <= k <= 16.
//
// Replaces vlpet_tpu/ops/topk.py:topk_lse_hier (_hier_sweep_kernel) and
// topk_lse_exact (_topk_lse_kernel): the same contract -- top-k values and
// int32 indices in lax.top_k order (value descending, then index
// ascending) plus the row logsumexp -- in one pass over the row. The TPU
// sweep was approximate per lane and needed an exactness detector and a
// fallback; this kernel is exact by construction, and needs no 128-pad.
//
// Bound on the H100: one read of the logits (2500 x 50265 f32 = 503 MB at
// the beam-5 decode shape, ~0.15 ms at 3.35 TB/s) plus one expf per
// element. Design: one block of 256 threads per row; each thread streams a
// coalesced strided slice of the row, keeping an online (max, sum) for the
// logsumexp and a sorted top-k list in registers (k is a template
// parameter, so the insertion network is fully unrolled); a block merge
// then pops the k best heads, one block-wide argmax per output slot.
#include <limits.h>

#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
topk_lse_kernel(const float* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ lse, int V) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float red_m[kWarps], red_s[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + (size_t)row * V;

  float tv[K];
  int ti[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = INT_MAX;
  }
  float m = -INFINITY, s = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float val = xr[i];
    if (val > m) {
      s = s * expf(m - val) + 1.f;
      m = val;
    } else if (val != -INFINITY) {
      s += expf(val - m);
    }
    if (better(val, i, tv[K - 1], ti[K - 1])) {
      tv[K - 1] = val;
      ti[K - 1] = i;
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (better(tv[j], ti[j], tv[j - 1], ti[j - 1])) {
          const float fv = tv[j];
          tv[j] = tv[j - 1];
          tv[j - 1] = fv;
          const int fi = ti[j];
          ti[j] = ti[j - 1];
          ti[j - 1] = fi;
        }
      }
    }
  }

  // logsumexp: warp, then block
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float bm = red_m[0], bs = red_s[0];
    for (int w = 1; w < kWarps; ++w) lse_merge(bm, bs, red_m[w], red_s[w]);
    lse[row] = bm + logf(bs);
  }

  // top-k: k rounds of a block-wide argbest over the threads' list heads
  for (int r = 0; r < K; ++r) {
    float bv = tv[0];
    int bi = ti[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    float wv = red_v[0];
    int wi = red_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(red_v[w], red_i[w], wv, wi)) {
        wv = red_v[w];
        wi = red_i[w];
      }
    }
    if (tid == 0) {
      vals[(size_t)row * K + r] = wv;
      idx[(size_t)row * K + r] = wi;
    }
    // indices are unique across threads: exactly one owner pops its head
    if (wi != INT_MAX && ti[0] == wi) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        tv[j] = tv[j + 1];
        ti[j] = ti[j + 1];
      }
      tv[K - 1] = -INFINITY;
      ti[K - 1] = INT_MAX;
    }
    __syncthreads();  // red_v/red_i are rewritten next round
  }
}

template <int K>
void launch(const float* x, float* vals, int* idx, float* lse, int R, int V,
            cudaStream_t st) {
  topk_lse_kernel<K><<<R, kThreads, 0, st>>>(x, vals, idx, lse, V);
}

}  // namespace

extern "C" int vlpet_topk_lse(const void* x, void* vals, void* idx, void* lse,
                              int R, int V, int k, void* stream) {
  if (R < 1 || k < 1 || k > 16 || k > V) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  float* vf = (float*)vals;
  int* ip = (int*)idx;
  float* lf = (float*)lse;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define VLPET_TOPK_CASE(n) \
  case n:                  \
    launch<n>(xf, vf, ip, lf, R, V, st); \
    break;
    VLPET_TOPK_CASE(1) VLPET_TOPK_CASE(2) VLPET_TOPK_CASE(3)
    VLPET_TOPK_CASE(4) VLPET_TOPK_CASE(5) VLPET_TOPK_CASE(6)
    VLPET_TOPK_CASE(7) VLPET_TOPK_CASE(8) VLPET_TOPK_CASE(9)
    VLPET_TOPK_CASE(10) VLPET_TOPK_CASE(11) VLPET_TOPK_CASE(12)
    VLPET_TOPK_CASE(13) VLPET_TOPK_CASE(14) VLPET_TOPK_CASE(15)
    VLPET_TOPK_CASE(16)
#undef VLPET_TOPK_CASE
  }
  return (int)cudaGetLastError();
}
