// Fused residual dropout + add + LayerNorm, forward (L1) and backward (L2):
//   y = LayerNorm(res + dropout(h; rate)) * gamma + beta, fp32 statistics.
//
// Replaces vlpet_tpu/ops/fused_ln.py:_fwd_call_flat (_fwd_kernel_flat) and
// :_bwd_call_flat (_bwd_kernel_flat), and with them the 3-D layouts
// :_fwd_call / :_bwd_call (L3/L4): the 3-D kernels compute the same
// function with the same element identity, and on the GPU one row kernel
// serves every (B, L, D) view.
//
// The dropout mask is the murmur3 hash of the GLOBAL flat element index
// row * D + col in uint32 arithmetic (vlpet_tpu/ops/hashdrop.py keep_mask;
// ``hash_bits`` in common.cuh, shared with the attention and FFN kernels):
// keep iff (hash & 0x7FFFFFFF) >= int(rate * 2^31). Nothing is stored: the
// backward regenerates the mask from the seed, which is a (1,) int32 device
// tensor read by pointer (no host sync per site). Statistics are the fast
// variance max(0, E[x^2] - mean^2) in fp32, as flax and the TPU kernel do.
//
// Bound on the H100: both passes are memory-bound (a few FLOPs and one hash
// per element). At N = 28000, D = 768 bf16 the forward moves h, res in and
// y out (3 x 43 MB: ~0.039 ms at 3.35 TB/s); the backward moves h, res, dy
// in and dh, dres out (5 x 43 MB: ~0.064 ms). Design: one warp per row,
// each lane holding D/32 columns in registers, so a row is read once and
// its statistics are warp shuffles. The backward's dgamma/dbeta column sums
// are deterministic: each block keeps per-lane partial sums over the rows
// it walks (a fixed row -> block map), reduces its warps in a fixed order
// in shared memory and writes one partial row; a second kernel sums the
// partial rows in order.
#include <type_traits>

#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kWarps = 8;

// x = res + dropout(h) for the NPER columns lane + 32 i of one row, with
// the keep decisions as a bit mask; returns through the arrays.
template <typename T, int NPER>
__device__ __forceinline__ uint32_t load_row(const T* __restrict__ h,
                                             const T* __restrict__ res,
                                             int row, int D, int lane,
                                             int drop, uint32_t thr,
                                             float scale, uint32_t seed,
                                             float (&x)[NPER]) {
  const size_t base = (size_t)row * D;
  uint32_t keep = 0;
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int c = lane + 32 * i;
    float v = 0.f;
    if (c < D) {
      float hv = to_f(h[base + c]);
      if (drop) {
        const uint32_t idx = (uint32_t)row * (uint32_t)D + (uint32_t)c;
        const bool k = hash_bits(idx, seed) >= thr;
        keep |= (uint32_t)k << i;
        hv = k ? hv * scale : 0.f;
      }
      v = to_f(res[base + c]) + hv;
    }
    x[i] = v;
  }
  return keep;
}

template <int NPER>
__device__ __forceinline__ void row_stats(const float (&x)[NPER], int D,
                                          float eps, float* mu, float* rstd) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    s += x[i];
    ss += x[i] * x[i];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float m = s / (float)D;
  const float var = fmaxf(0.f, ss / (float)D - m * m);
  *mu = m;
  *rstd = rsqrtf(var + eps);
}

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const T* __restrict__ h, const T* __restrict__ res,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const int* __restrict__ seed_p, T* __restrict__ y, int N, int D,
              int drop, uint32_t thr, float scale, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // warp-uniform
  float x[NPER];
  load_row<T, NPER>(h, res, row, D, lane, drop, thr, scale,
                    (uint32_t)seed_p[0], x);
  float mu, rstd;
  row_stats<NPER>(x, D, eps, &mu, &rstd);
  const size_t base = (size_t)row * D;
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int c = lane + 32 * i;
    if (c < D)
      y[base + c] = from_f<T>((x[i] - mu) * (rstd * gamma[c]) + beta[c]);
  }
}

// partial: [gridDim.x][2][D] fp32 (dgamma rows, then dbeta rows).
template <typename T, int NPER>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const T* __restrict__ h, const T* __restrict__ res,
              const float* __restrict__ gamma, const int* __restrict__ seed_p,
              const T* __restrict__ dy, T* __restrict__ dh,
              T* __restrict__ dres, float* __restrict__ partial, int N, int D,
              int drop, uint32_t thr, float scale, float eps) {
  extern __shared__ float red[];  // [kWarps][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t seed = (uint32_t)seed_p[0];
  float pg[NPER], pb[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) pg[i] = pb[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < N;
       row += gridDim.x * kWarps) {
    float x[NPER], g[NPER];
    const uint32_t keep =
        load_row<T, NPER>(h, res, row, D, lane, drop, thr, scale, seed, x);
    float mu, rstd;
    row_stats<NPER>(x, D, eps, &mu, &rstd);
    const size_t base = (size_t)row * D;
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int c = lane + 32 * i;
      float d = 0.f, gm = 0.f;
      if (c < D) {
        d = to_f(dy[base + c]);
        gm = gamma[c];
      }
      const float xh = (x[i] - mu) * rstd;
      const float dxh = d * gm;
      a1 += dxh;
      a2 += dxh * xh;
      pg[i] += d * xh;
      pb[i] += d;
      x[i] = xh;   // x now holds xhat
      g[i] = dxh;  // g holds dxhat
    }
    a1 = warp_sum(a1) / (float)D;
    a2 = warp_sum(a2) / (float)D;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        const float dx = rstd * (g[i] - a1 - x[i] * a2);
        dres[base + c] = from_f<T>(dx);
        float dhv = dx;
        if (drop) dhv = ((keep >> i) & 1u) ? dx * scale : 0.f;
        dh[base + c] = from_f<T>(dhv);
      }
    }
  }

  // fixed-order block reduction of the per-lane partials
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int c = lane + 32 * i;
      if (c < D) red[warp * D + c] = which == 0 ? pg[i] : pb[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * D + c];
      partial[((size_t)blockIdx.x * 2 + which) * D + c] = s;
    }
    __syncthreads();
  }
}

// dgamma[c] = sum_g partial[g][0][c], dbeta[c] = sum_g partial[g][1][c],
// summed in block order.
__global__ void ln_col_reduce(const float* __restrict__ partial, int G, int D,
                              float* __restrict__ dgamma,
                              float* __restrict__ dbeta) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * D) return;
  const int which = t / D, c = t - which * D;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[((size_t)g * 2 + which) * D + c];
  (which == 0 ? dgamma : dbeta)[c] = s;
}

template <typename T, int NPER>
int launch_fwd(const void* h, const void* res, const void* gamma,
               const void* beta, const void* seed, void* y, int N, int D,
               int drop, uint32_t thr, float scale, float eps,
               cudaStream_t st) {
  ln_fwd_kernel<T, NPER><<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      (const T*)h, (const T*)res, (const float*)gamma, (const float*)beta,
      (const int*)seed, (T*)y, N, D, drop, thr, scale, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NPER>
int launch_bwd(const void* h, const void* res, const void* gamma,
               const void* seed, const void* dy, void* dh, void* dres,
               void* partial, void* dgamma, void* dbeta, int N, int D, int G,
               int drop, uint32_t thr, float scale, float eps,
               cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarps * D;
  ln_bwd_kernel<T, NPER><<<G, kWarps * 32, smem, st>>>(
      (const T*)h, (const T*)res, (const float*)gamma, (const int*)seed,
      (const T*)dy, (T*)dh, (T*)dres, (float*)partial, N, D, drop, thr, scale,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_col_reduce<<<(2 * D + 255) / 256, 256, 0, st>>>(
      (const float*)partial, G, D, (float*)dgamma, (float*)dbeta);
  return (int)cudaGetLastError();
}

// D in (32 (NPER - 8), 32 NPER] for NPER in {8, 16, 24, 32}: D <= 1024
template <typename F>
int dispatch(int D, F&& fn) {
  if (D <= 256) return fn(std::integral_constant<int, 8>());
  if (D <= 512) return fn(std::integral_constant<int, 16>());
  if (D <= 768) return fn(std::integral_constant<int, 24>());
  return fn(std::integral_constant<int, 32>());
}

}  // namespace

extern "C" int vlpet_ln_fwd(const void* h, const void* res, const void* gamma,
                            const void* beta, const void* seed, void* y,
                            int N, int D, int drop, int thr, float scale,
                            float eps, int is_bf16, void* stream) {
  if (N < 1 || D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch(D, [&](auto n) {
      return launch_fwd<bf16, decltype(n)::value>(
          h, res, gamma, beta, seed, y, N, D, drop, (uint32_t)thr, scale, eps,
          st);
    });
  return dispatch(D, [&](auto n) {
    return launch_fwd<float, decltype(n)::value>(
        h, res, gamma, beta, seed, y, N, D, drop, (uint32_t)thr, scale, eps,
        st);
  });
}

extern "C" int vlpet_ln_bwd(const void* h, const void* res, const void* gamma,
                            const void* seed, const void* dy, void* dh,
                            void* dres, void* partial, void* dgamma,
                            void* dbeta, int N, int D, int G, int drop,
                            int thr, float scale, float eps, int is_bf16,
                            void* stream) {
  if (N < 1 || D < 1 || D > 1024 || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch(D, [&](auto n) {
      return launch_bwd<bf16, decltype(n)::value>(
          h, res, gamma, seed, dy, dh, dres, partial, dgamma, dbeta, N, D, G,
          drop, (uint32_t)thr, scale, eps, st);
    });
  return dispatch(D, [&](auto n) {
    return launch_bwd<float, decltype(n)::value>(
        h, res, gamma, seed, dy, dh, dres, partial, dgamma, dbeta, N, D, G,
        drop, (uint32_t)thr, scale, eps, st);
  });
}
