// Streamed linear + cross-entropy: the per-token loss of x . W^T + b
// against the labels, and its backward dx, without the (N, V) logits ever
// reaching device memory.
//
// Replaces vlpet_tpu/ops/fused_ce.py:_run_fwd (_fwd_kernel, C1) and
// :_run_bwd (_bwd_kernel, C2), the kernels behind the custom_vjp
// fused_linear_ce. x (N, D) bf16 or fp32, W (V, D) in x's dtype (the frozen
// tied head), b (V,) fp32, labels (N,) int32 with -100 = ignore. Forward:
// logits in fp32 (fp32 products of the x-dtype operands), lse over the V
// real columns, loss = lse - logit[label] (0 for an ignored row), and the
// row lse for the backward. Backward: each logits tile recomputed, g =
// (exp(logit - lse) - onehot) * dloss rounded to x's dtype, as the TPU
// kernel rounds it, and dx = g . W accumulated in fp32, cast to x's dtype.
// W and b get no gradient (the frozen-head contract).
//
// Bound on the H100: 2 N V D FLOPs forward, 4 N V D backward -- at the
// BART train step (N 5000, V 50265, D 768) 0.39 ms and 0.78 ms at 989
// TFLOP/s bf16, against 77 MB of W read once. The TPU walked one row tile
// through all of V per program (N / tn programs: under 160 at N 5000 for
// 132 SMs, each streaming all of W). Design here: the grid is (row blocks,
// vocab splits), so enough blocks fill the card; each block walks its
// split's 64-column vocab tiles in order, stages the W tile (zero rows
// past V, so 0 x garbage never reaches dx) and its rows of x in shared
// memory with cp.async (C1 copies tile t + 1 while it reduces tile t), and
// computes the logits tile with WMMA bf16 tensor-core products
// (fp32 accumulate; fp32 inputs take plain FMA, never TF32). C1 keeps per
// row an online (max, sum, picked logit) and writes one partial a split;
// a second kernel merges the splits in order. C2 (32 rows a block) rounds
// the g tile to bf16 in shared memory and folds it into fp32 dx fragments,
// one partial dx a split, summed in split order by a third kernel. No
// atomics: every sum has a fixed order, so the result is deterministic.
// Consecutive blocks share a split, so one W tile serves the row blocks
// from L2. No wgmma/TMA yet.
#include <mma.h>

#include "common.cuh"

using namespace vlpet;
using namespace nvcuda;

namespace {

constexpr float kNeg = -1e30f;  // masked column (vlpet_tpu fused_ce NEG)
constexpr int kTV = 64;         // vocab tile: four 16-col fragments
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 row padding: ldm a multiple of 8
constexpr int kLLD = kTV + 4;    // fp32 logits staging row stride
constexpr int kGLD = kTV + kPad; // bf16 g tile row stride

// ------------------------------------------------------------ bf16 (WMMA)

__host__ __device__ constexpr size_t fwd_smem(int BM, int D) {
  return (size_t)(BM + kTV) * (D + kPad) * 2 + (size_t)BM * kLLD * 4;
}

__host__ __device__ constexpr size_t bwd_smem(int D) {
  return (size_t)(32 + kTV) * (D + kPad) * 2 + (size_t)32 * kLLD * 4 +
         (size_t)32 * kGLD * 2;
}

// rows [r0, r0 + R) of a (rows, D) bf16 matrix into shared memory with
// row stride D + kPad, zero rows past ``rows``: 16-byte cp.async copies,
// all in flight together; stage_wait() before the block's barrier
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int R, int rows, int D) {
  const int words = D / 8;
  const int ld = D + kPad;
  for (int i = threadIdx.x; i < R * words; i += blockDim.x) {
    const int r = i / words, c = i - r * words;
    bf16* d = dst + r * ld + c * 8;
    if (r0 + r < rows) {
      const unsigned sa = (unsigned)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src + (size_t)(r0 + r) * D + c * 8));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's staged copies have landed (a __syncthreads() then makes
// every thread's visible)
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// lf[BM][kLLD] = xs[BM][D] . ws[kTV][D]^T (fp32), 8 warps: warp w takes
// column fragment w & 3 and row fragments (w >> 2) + 2p
template <int BM>
__device__ __forceinline__ void logits_tile_wmma(const bf16* xs, const bf16* ws,
                                                 float* lf, int D, int warp) {
  constexpr int PER = BM / 32;
  const int ld = D + kPad;
  const int cf = warp & 3, r0 = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) wmma::fill_fragment(acc[p], 0.f);
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
    wmma::load_matrix_sync(bw, ws + cf * 16 * ld + kk, ld);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + (r0 + 2 * p) * 16 * ld + kk, ld);
      wmma::mma_sync(acc[p], a, bw, acc[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p)
    wmma::store_matrix_sync(lf + (r0 + 2 * p) * 16 * kLLD + cf * 16, acc[p],
                            kLLD, wmma::mem_row_major);
}

// ------------------------------------------------------------ fp32 (FMA)

constexpr int kKC = 32;  // fp32 k chunk
constexpr int kFBM = 32; // fp32 rows per block

// lf[32][kLLD] = x[n0:n0+32] . W[v0:v0+64]^T, k-chunked through xs
// [32][kKC+1] and ws [64][kKC+1]; thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16j and columns tx + 16i
__device__ __forceinline__ void logits_tile_f32(const float* x, const float* w,
                                                int N, int V, int D, int n0,
                                                int v0, float* xs, float* ws,
                                                float* lf) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  constexpr int ld = kKC + 1;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < D; k0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kFBM * kKC; i += kThreads) {
      const int r = i / kKC, k = i - r * kKC;
      xs[r * ld + k] = n0 + r < N ? x[(size_t)(n0 + r) * D + k0 + k] : 0.f;
    }
    for (int i = tid; i < kTV * kKC; i += kThreads) {
      const int r = i / kKC, k = i - r * kKC;
      ws[r * ld + k] = v0 + r < V ? w[(size_t)(v0 + r) * D + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      float xa[2], wb[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) xa[j] = xs[(ty + 16 * j) * ld + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) wb[i] = ws[(tx + 16 * i) * ld + k];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(xa[j], wb[i], acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lf[(ty + 16 * j) * kLLD + tx + 16 * i] = acc[j][i];
}

// ------------------------------------------------------------ forward

// Online (max, sum, picked) of the rows a warp owns (RPW of them: rows
// warp * RPW + rr) over one logits tile in lf; lanes take columns lane and
// lane + 32. All lanes of a warp hold the same values.
template <int RPW>
__device__ __forceinline__ void online_lse(const float* lf, const float* b,
                                           const int* lab, int v0, int V,
                                           int warp, int lane, float* m,
                                           float* s, float* pk) {
  const int ca = v0 + lane, cb = v0 + lane + 32;
  const float ba = ca < V ? b[ca] : 0.f, bb = cb < V ? b[cb] : 0.f;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const float* row = lf + (warp * RPW + rr) * kLLD;
    const float la = ca < V ? row[lane] + ba : kNeg;
    const float lb = cb < V ? row[lane + 32] + bb : kNeg;
    const float mn = fmaxf(m[rr], warp_max(fmaxf(la, lb)));
    const float e = warp_sum(expf(la - mn) + expf(lb - mn));
    s[rr] = s[rr] * expf(m[rr] - mn) + e;
    m[rr] = mn;
    const int l = lab[rr];
    if (l >= v0 && l < v0 + kTV && l < V) pk[rr] = row[l - v0] + b[l];
  }
}

// part: [3][S][N] fp32 (max, sum, picked logit) of split blockIdx.y
template <int BM>
__device__ __forceinline__ void write_fwd_partial(float* part, int N, int S,
                                                  int n0, int warp, int lane,
                                                  const float* m,
                                                  const float* s,
                                                  const float* pk) {
  constexpr int RPW = BM / kWarps;
  if (lane != 0) return;
  const size_t plane = (size_t)S * N;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int n = n0 + warp * RPW + rr;
    if (n >= N) continue;
    const size_t o = (size_t)blockIdx.y * N + n;
    part[o] = m[rr];
    part[plane + o] = s[rr];
    part[2 * plane + o] = pk[rr];
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
ce_fwd_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const float* __restrict__ b, const int* __restrict__ labels,
            float* __restrict__ part, int N, int D, int V, int tps, int S) {
  constexpr int RPW = BM / kWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);              // [BM][D+8]
  bf16* ws = xs + BM * (D + kPad);                           // [kTV][D+8]
  float* lf = reinterpret_cast<float*>(ws + kTV * (D + kPad));  // [BM][kLLD]
  const int n0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  float m[RPW], s[RPW], pk[RPW];
  int lab[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int n = n0 + warp * RPW + rr;
    m[rr] = kNeg;
    s[rr] = 0.f;
    pk[rr] = 0.f;
    lab[rr] = n < N ? labels[n] : -1;
  }
  stage_rows(xs, x, n0, BM, N, D);
  if (t0 < t1) stage_rows(ws, w, t0 * kTV, kTV, V, D);
  for (int t = t0; t < t1; ++t) {
    stage_wait();
    __syncthreads();  // W tile t staged; the previous tile's lf consumed
    logits_tile_wmma<BM>(xs, ws, lf, D, warp);
    __syncthreads();  // lf written, ws free: stage tile t + 1 meanwhile
    if (t + 1 < t1) stage_rows(ws, w, (t + 1) * kTV, kTV, V, D);
    online_lse<RPW>(lf, b, lab, t * kTV, V, warp, lane, m, s, pk);
  }
  stage_wait();  // an empty split still staged x
  write_fwd_partial<BM>(part, N, S, n0, warp, lane, m, s, pk);
}

__global__ void __launch_bounds__(kThreads)
ce_fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, const int* __restrict__ labels,
           float* __restrict__ part, int N, int D, int V, int tps, int S) {
  constexpr int RPW = kFBM / kWarps;
  __shared__ float xs[kFBM * (kKC + 1)];
  __shared__ float ws[kTV * (kKC + 1)];
  __shared__ float lf[kFBM * kLLD];
  const int n0 = blockIdx.x * kFBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  float m[RPW], s[RPW], pk[RPW];
  int lab[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int n = n0 + warp * RPW + rr;
    m[rr] = kNeg;
    s[rr] = 0.f;
    pk[rr] = 0.f;
    lab[rr] = n < N ? labels[n] : -1;
  }
  for (int t = t0; t < t1; ++t) {
    logits_tile_f32(x, w, N, V, D, n0, t * kTV, xs, ws, lf);
    __syncthreads();
    online_lse<RPW>(lf, b, lab, t * kTV, V, warp, lane, m, s, pk);
    // the next tile's first __syncthreads orders lf's reuse
  }
  write_fwd_partial<kFBM>(part, N, S, n0, warp, lane, m, s, pk);
}

// merge the S splits in order: lse = max + log(sum), loss = lse - picked
// (0 where the label is negative)
__global__ void ce_fwd_merge(const float* __restrict__ part,
                             const int* __restrict__ labels,
                             float* __restrict__ loss, float* __restrict__ lse,
                             int N, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t plane = (size_t)S * N;
  float m = kNeg;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part[(size_t)s * N + n]);
  float sum = 0.f, pk = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t o = (size_t)s * N + n;
    sum += part[plane + o] * expf(part[o] - m);
    pk += part[2 * plane + o];
  }
  const float l = m + logf(sum);
  lse[n] = l;
  loss[n] = labels[n] >= 0 ? l - pk : 0.f;
}

// ------------------------------------------------------------ backward

// g (fp32) of element (r, c) of the tile at v0: (exp(logit + b - lse) -
// onehot) * scale, 0 past V and on rows past N (scale 0 there)
__device__ __forceinline__ float g_elem(float logit, const float* b, int col,
                                        int V, int lab, float lse_r,
                                        float scale) {
  if (col >= V || scale == 0.f) return 0.f;
  const float p = expf(logit + b[col] - lse_r);
  return (p - (col == lab ? 1.f : 0.f)) * scale;
}

// per-thread row constants of the g tile: thread tid takes column tid % 64
// of rows tid / 64 + 4j
struct GRows {
  int lab[8];
  float lse[8], scale[8];
};

__device__ __forceinline__ GRows g_rows(const int* labels, const float* lse,
                                        const float* dloss, int n0, int N) {
  GRows g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (threadIdx.x >> 6) + 4 * j;
    const bool in = n < N;
    g.lab[j] = in ? labels[n] : -1;
    g.lse[j] = in ? lse[n] : 0.f;
    g.scale[j] = in && g.lab[j] >= 0 ? dloss[n] : 0.f;
  }
  return g;
}

// part: [S][N][D] fp32, split blockIdx.y's dx
template <int NCF>
__global__ void __launch_bounds__(kThreads)
ce_bwd_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const float* __restrict__ b, const int* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ dloss,
            float* __restrict__ part, int N, int V, int tps) {
  constexpr int D = kWarps * 16 * NCF;
  constexpr int ld = D + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                 // [32][ld]
  bf16* ws = xs + 32 * ld;                                      // [kTV][ld]
  float* lf = reinterpret_cast<float*>(ws + kTV * ld);          // [32][kLLD]
  bf16* gs = reinterpret_cast<bf16*>(lf + 32 * kLLD);           // [32][kGLD]
  const int n0 = blockIdx.x * 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  const GRows gr = g_rows(labels, lse, dloss, n0, N);
  const int c = tid & 63;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> xacc[2][NCF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NCF; ++j) wmma::fill_fragment(xacc[i][j], 0.f);

  stage_rows(xs, x, n0, 32, N, D);
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kTV;
    __syncthreads();  // the previous tile's ws is consumed
    stage_rows(ws, w, v0, kTV, V, D);
    stage_wait();
    __syncthreads();
    logits_tile_wmma<32>(xs, ws, lf, D, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (tid >> 6) + 4 * j;
      gs[r * kGLD + c] = __float2bfloat16(g_elem(
          lf[r * kLLD + c], b, v0 + c, V, gr.lab[j], gr.lse[j], gr.scale[j]));
    }
    __syncthreads();
    // dx[32 x D] += g[32 x 64] . W[v0 : v0+64, :] (this warp's columns)
#pragma unroll
    for (int kk = 0; kk < kTV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, gs + kk, kGLD);
      wmma::load_matrix_sync(a1, gs + 16 * kGLD + kk, kGLD);
#pragma unroll
      for (int j = 0; j < NCF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, ws + kk * ld + warp * NCF * 16 + j * 16,
                               ld);
        wmma::mma_sync(xacc[0][j], a0, bw, xacc[0][j]);
        wmma::mma_sync(xacc[1][j], a1, bw, xacc[1][j]);
      }
    }
  }

  stage_wait();      // an empty split still staged x
  __syncthreads();  // lf is reused as per-warp output staging
  float* stage = lf + warp * 256;
  float* prow = part + (size_t)blockIdx.y * N * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NCF; ++j) {
      wmma::store_matrix_sync(stage, xacc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int n = n0 + i * 16 + (e >> 4);
        const int o = warp * NCF * 16 + j * 16 + (e & 15);
        if (n < N) prow[(size_t)n * D + o] = stage[e];
      }
      __syncwarp();
    }
  }
}

// fp32: the logits tile as in the forward, g in place in lf, then dx in
// 64-column chunks through ws2 [kTV][65]; thread (ty, tx) owns rows ty +
// 16j and columns chunk * 64 + tx + 16i
template <int ND>
__global__ void __launch_bounds__(kThreads)
ce_bwd_f32(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, const int* __restrict__ labels,
           const float* __restrict__ lse, const float* __restrict__ dloss,
           float* __restrict__ part, int N, int V, int tps) {
  constexpr int D = ND * 64;
  constexpr int ld2 = kTV + 1;
  __shared__ float xs[kFBM * (kKC + 1)];
  __shared__ float ws[kTV * (kKC + 1)];
  __shared__ float lf[kFBM * kLLD];
  __shared__ float ws2[kTV * ld2];
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  const GRows gr = g_rows(labels, lse, dloss, n0, N);
  const int c = tid & 63;
  float acc[ND][2][4] = {};

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kTV;
    logits_tile_f32(x, w, N, V, D, n0, v0, xs, ws, lf);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (tid >> 6) + 4 * j;
      lf[r * kLLD + c] = g_elem(lf[r * kLLD + c], b, v0 + c, V, gr.lab[j],
                                gr.lse[j], gr.scale[j]);
    }
#pragma unroll
    for (int dc = 0; dc < ND; ++dc) {
      __syncthreads();
      for (int i = tid; i < kTV * 64; i += kThreads) {
        const int r = i >> 6, k = i & 63;
        ws2[r * ld2 + k] =
            v0 + r < V ? w[(size_t)(v0 + r) * D + dc * 64 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int v = 0; v < kTV; ++v) {
        float ga[2], wb[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) ga[j] = lf[(ty + 16 * j) * kLLD + v];
#pragma unroll
        for (int i = 0; i < 4; ++i) wb[i] = ws2[v * ld2 + tx + 16 * i];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[dc][j][i] = fmaf(ga[j], wb[i], acc[dc][j][i]);
      }
    }
  }
  float* prow = part + (size_t)blockIdx.y * N * D;
#pragma unroll
  for (int dc = 0; dc < ND; ++dc)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + ty + 16 * j;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        prow[(size_t)n * D + dc * 64 + tx + 16 * i] = acc[dc][j][i];
    }
}

// dx = the S split partials summed in order, cast to x's dtype
template <typename T>
__global__ void ce_bwd_reduce(const float* __restrict__ part,
                              T* __restrict__ dx, long long total, int S) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[(size_t)s * total + i];
    dx[i] = from_f<T>(acc);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NCF>
int launch_bwd_wmma(const void* x, const void* w, const void* b,
                    const void* labels, const void* lse, const void* dloss,
                    void* part, int N, int V, int tps, dim3 grid,
                    cudaStream_t st) {
  const size_t smem = bwd_smem(kWarps * 16 * NCF);
  const int err = set_smem(ce_bwd_wmma<NCF>, smem);
  if (err) return err;
  ce_bwd_wmma<NCF><<<grid, kThreads, smem, st>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)dloss, (float*)part, N, V, tps);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_bwd_f32(const void* x, const void* w, const void* b,
                   const void* labels, const void* lse, const void* dloss,
                   void* part, int N, int V, int tps, dim3 grid,
                   cudaStream_t st) {
  ce_bwd_f32<ND><<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)w, (const float*)b, (const int*)labels,
      (const float*)lse, (const float*)dloss, (float*)part, N, V, tps);
  return (int)cudaGetLastError();
}

int reduce_blocks(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks > 8192 ? 8192 : blocks);
}

// rows per forward block: bf16 64 where its shared memory fits, else 32
int fwd_rows(int D, int is_bf16) {
  return is_bf16 && fwd_smem(64, D) <= 232448 ? 64 : 32;
}

}  // namespace

// x (N, D), w (V, D) in x's dtype, b (V,) f32, labels (N,) int32; part
// [3][S][N] f32 scratch; loss, lse (N,) f32. S vocab splits of
// ceil(ceil(V / 64) / S) tiles each.
extern "C" int vlpet_ce_fwd(const void* x, const void* w, const void* b,
                            const void* labels, void* part, void* loss,
                            void* lse, int N, int D, int V, int S,
                            int is_bf16, void* stream) {
  if (N < 1 || V < 1 || S < 1 || D < 1 || D % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int tps = (n_tiles + S - 1) / S;
  const int rows = fwd_rows(D, is_bf16);
  const dim3 grid((N + rows - 1) / rows, S);
  if (is_bf16) {
    const size_t smem = fwd_smem(rows, D);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    int err;
    if (rows == 64) {
      err = set_smem(ce_fwd_wmma<64>, smem);
      if (err) return err;
      ce_fwd_wmma<64><<<grid, kThreads, smem, st>>>(
          (const bf16*)x, (const bf16*)w, (const float*)b,
          (const int*)labels, (float*)part, N, D, V, tps, S);
    } else {
      err = set_smem(ce_fwd_wmma<32>, smem);
      if (err) return err;
      ce_fwd_wmma<32><<<grid, kThreads, smem, st>>>(
          (const bf16*)x, (const bf16*)w, (const float*)b,
          (const int*)labels, (float*)part, N, D, V, tps, S);
    }
  } else {
    ce_fwd_f32<<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)b,
        (const int*)labels, (float*)part, N, D, V, tps, S);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_fwd_merge<<<(N + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)labels, (float*)loss, (float*)lse, N,
      S);
  return (int)cudaGetLastError();
}

// lse, dloss (N,) f32; part [S][N][D] f32 scratch; dx (N, D) x's dtype.
// D 512, 768 or 1024.
extern "C" int vlpet_ce_bwd(const void* x, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* dloss, void* part, void* dx, int N,
                            int D, int V, int S, int is_bf16, void* stream) {
  if (N < 1 || V < 1 || S < 1 || (D != 512 && D != 768 && D != 1024))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (V + kTV - 1) / kTV;
  const int tps = (n_tiles + S - 1) / S;
  const dim3 grid((N + 31) / 32, S);
  int err;
  if (is_bf16) {
    err = D == 512   ? launch_bwd_wmma<4>(x, w, b, labels, lse, dloss, part,
                                          N, V, tps, grid, st)
          : D == 768 ? launch_bwd_wmma<6>(x, w, b, labels, lse, dloss, part,
                                          N, V, tps, grid, st)
                     : launch_bwd_wmma<8>(x, w, b, labels, lse, dloss, part,
                                          N, V, tps, grid, st);
  } else {
    err = D == 512   ? launch_bwd_f32<8>(x, w, b, labels, lse, dloss, part,
                                         N, V, tps, grid, st)
          : D == 768 ? launch_bwd_f32<12>(x, w, b, labels, lse, dloss, part,
                                          N, V, tps, grid, st)
                     : launch_bwd_f32<16>(x, w, b, labels, lse, dloss, part,
                                          N, V, tps, grid, st);
  }
  if (err) return err;
  const long long total = (long long)N * D;
  if (is_bf16)
    ce_bwd_reduce<bf16><<<reduce_blocks(total), kThreads, 0, st>>>(
        (const float*)part, (bf16*)dx, total, S);
  else
    ce_bwd_reduce<float><<<reduce_blocks(total), kThreads, 0, st>>>(
        (const float*)part, (float*)dx, total, S);
  return (int)cudaGetLastError();
}
