// Fused transformer FFN forward: y = act(x . W1^T + b1) . W2^T + b2.
//
// Replaces vlpet_tpu/ops/ffn.py:_run with _fwd_kernel (fused_ffn). Weights
// come in PyTorch's Linear layout: W1 (F, D), W2 (D, F); biases are f32;
// act is gelu (erf, code 0) or gelu_new (tanh, code 1), applied in fp32.
// The (N, F) hidden never reaches device memory: each block keeps its rows'
// hidden chunk in shared memory and folds it straight into the fc2 sum.
//
// Bound on the H100: 4*N*D*F FLOPs against ~2*D*F weight reads per block,
// so at the encoder shape (N = 28000) it is compute-bound on the tensor
// cores; at the beam decode shape (N = 2500) the weight stream from L2
// dominates. Design (bf16): one block of 8 warps per 32 rows; the x tile
// lives in shared memory; for each 64-wide hidden chunk the warps compute
// the 32x64 fc1 tile with WMMA bf16 tensor-core products (fp32 accumulate),
// apply bias + activation in fp32, round to bf16 in shared memory, and
// accumulate their 32 x D/8 slice of fc2 in fp32 register fragments. No
// wgmma/TMA yet. fp32 inputs take a plain-FMA kernel of the same shape
// (fp32 tensor-core paths are TF32 and would break fp32 parity). Rows past
// N are zero-filled in shared memory and masked at the store: no padding
// copy.
#include <mma.h>

#include "common.cuh"

using namespace vlpet;
using namespace nvcuda;

namespace {

__device__ __forceinline__ float act_fn(float h, int act) {
  if (act == 0) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  const float c = 0.79788456080286536f;  // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// ---------------------------------------------------------------- bf16 WMMA
constexpr int kBM = 32;     // rows per block (two 16-row fragments)
constexpr int kBF = 64;     // hidden chunk width (four 16-col fragments)
constexpr int kWarps = 8;
constexpr int kPad = 8;     // bf16 row padding: ldm stays a multiple of 8
constexpr int kHLD = kBF + kPad;   // hidden tile row stride (bf16)
constexpr int kFLD = kBF + 4;      // fp32 staging row stride

__host__ __device__ constexpr size_t wmma_smem(int D) {
  return (size_t)kBM * (D + kPad) * 2 + (size_t)kBM * kHLD * 2 +
         (size_t)kBM * kFLD * 4;
}

// D = kWarps * 16 * NCF: each warp owns NCF 16-col fragments of the output
template <int NCF>
__global__ void __launch_bounds__(kWarps * 32)
ffn_fwd_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, bf16* __restrict__ y, int N,
             int F, int act) {
  constexpr int D = kWarps * 16 * NCF;
  constexpr int XLD = D + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);           // [kBM][XLD]
  bf16* hs = xs + kBM * XLD;                              // [kBM][kHLD]
  float* hf = reinterpret_cast<float*>(hs + kBM * kHLD);  // [kBM][kFLD]

  const int n0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kBM * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int n = n0 + r;
    xs[r * XLD + c] = n < N ? x[(size_t)n * D + c] : __float2bfloat16(0.f);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[2][NCF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NCF; ++j) wmma::fill_fragment(yacc[i][j], 0.f);

  const int arow = warp >> 2;  // fc1 tile: row fragment of this warp
  const int acol = warp & 3;   // fc1 tile: hidden col fragment of this warp
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kBF) {
    // fc1: h[32 x 64] = x[32 x D] . W1[f0 : f0+64, :]^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    const bf16* w1p = w1 + (size_t)(f0 + acol * 16) * D;
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, xs + arow * 16 * XLD + kk, XLD);
      wmma::load_matrix_sync(bw, w1p + kk, D);
      wmma::mma_sync(hacc, a, bw, hacc);
    }
    wmma::store_matrix_sync(hf + arow * 16 * kFLD + acol * 16, hacc, kFLD,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBM * kBF; i += blockDim.x) {
      const int r = i / kBF, c = i - r * kBF;
      hs[r * kHLD + c] =
          __float2bfloat16(act_fn(hf[r * kFLD + c] + b1[f0 + c], act));
    }
    __syncthreads();
    // fc2: y[32 x D] += h[32 x 64] . W2[:, f0 : f0+64]^T (this warp's cols)
#pragma unroll
    for (int kk = 0; kk < kBF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hs + kk, kHLD);
      wmma::load_matrix_sync(a1, hs + 16 * kHLD + kk, kHLD);
#pragma unroll
      for (int j = 0; j < NCF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        const bf16* w2p = w2 + (size_t)(warp * NCF * 16 + j * 16) * F + f0 + kk;
        wmma::load_matrix_sync(bw, w2p, F);
        wmma::mma_sync(yacc[0][j], a0, bw, yacc[0][j]);
        wmma::mma_sync(yacc[1][j], a1, bw, yacc[1][j]);
      }
    }
  }

  __syncthreads();  // hf is reused as per-warp output staging
  float* stage = hf + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NCF; ++j) {
      wmma::store_matrix_sync(stage, yacc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int n = n0 + i * 16 + (e >> 4);
        const int o = warp * NCF * 16 + j * 16 + (e & 15);
        if (n < N) y[(size_t)n * D + o] = __float2bfloat16(stage[e] + b2[o]);
      }
      __syncwarp();
    }
  }
}

template <int NCF>
int launch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* y, int N, int F, int act,
                cudaStream_t st) {
  const size_t smem = wmma_smem(kWarps * 16 * NCF);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_wmma<NCF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_wmma<NCF><<<(N + kBM - 1) / kBM, kWarps * 32, smem, st>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (bf16*)y, N, F, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 FMA
constexpr int kFBM = 16;       // rows per block
constexpr int kFBF = 32;       // hidden chunk width
constexpr int kFThreads = 256;
constexpr int kFOut = 4;       // output columns per thread: D <= 1024

__global__ void __launch_bounds__(kFThreads)
ffn_fwd_f32(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ y, int N, int D,
            int F, int act) {
  extern __shared__ float fsm[];
  float* xs = fsm;               // [kFBM][D]
  float* hs = xs + kFBM * D;     // [kFBM][kFBF]
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x;
  for (int i = tid; i < kFBM * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int n = n0 + r;
    xs[i] = n < N ? x[(size_t)n * D + c] : 0.f;
  }
  float yacc[kFBM][kFOut];
#pragma unroll
  for (int r = 0; r < kFBM; ++r)
#pragma unroll
    for (int c = 0; c < kFOut; ++c) yacc[r][c] = 0.f;
  __syncthreads();

  const int hc = tid & (kFBF - 1);  // fc1: hidden column of this thread
  const int hr = tid / kFBF;        // fc1: rows hr and hr + 8
  for (int f0 = 0; f0 < F; f0 += kFBF) {
    const float* w1r = w1 + (size_t)(f0 + hc) * D;
    float h0 = 0.f, h1 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float w = w1r[d];
      h0 = fmaf(xs[hr * D + d], w, h0);
      h1 = fmaf(xs[(hr + 8) * D + d], w, h1);
    }
    const float bb = b1[f0 + hc];
    hs[hr * kFBF + hc] = act_fn(h0 + bb, act);
    hs[(hr + 8) * kFBF + hc] = act_fn(h1 + bb, act);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kFOut; ++c) {
      const int o = tid + kFThreads * c;
      if (o < D) {
        const float* w2r = w2 + (size_t)o * F + f0;
        for (int f = 0; f < kFBF; ++f) {
          const float w = w2r[f];
#pragma unroll
          for (int r = 0; r < kFBM; ++r)
            yacc[r][c] = fmaf(hs[r * kFBF + f], w, yacc[r][c]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kFOut; ++c) {
    const int o = tid + kFThreads * c;
    if (o < D) {
#pragma unroll
      for (int r = 0; r < kFBM; ++r) {
        const int n = n0 + r;
        if (n < N) y[(size_t)n * D + o] = yacc[r][c] + b2[o];
      }
    }
  }
}

}  // namespace

extern "C" int vlpet_ffn_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int N,
                             int D, int F, int act, int is_bf16,
                             void* stream) {
  if (N < 1 || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (D % (kWarps * 16) != 0 || D > 1024 || F % kBF != 0)
      return (int)cudaErrorInvalidValue;
    switch (D / (kWarps * 16)) {
      case 1: return launch_wmma<1>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 2: return launch_wmma<2>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 3: return launch_wmma<3>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 4: return launch_wmma<4>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 5: return launch_wmma<5>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 6: return launch_wmma<6>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 7: return launch_wmma<7>(x, w1, b1, w2, b2, y, N, F, act, st);
      case 8: return launch_wmma<8>(x, w1, b1, w2, b2, y, N, F, act, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (D < 1 || D > kFThreads * kFOut || F % kFBF != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kFBM * D + kFBM * kFBF);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_f32<<<(N + kFBM - 1) / kFBM, kFThreads, smem, st>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)y, N, D, F, act);
  return (int)cudaGetLastError();
}
