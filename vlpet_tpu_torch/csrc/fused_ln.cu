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
// in and dh, dres out (5 x 43 MB: ~0.064 ms).
//
// Design (route "vec": rows of a multiple of 16 bytes, 16-byte aligned
// tensors). A warp owns a row at a time; lane l holds the 16-byte chunks
// l, l + 32, .. of it (8 bf16 or 4 fp32 values each, E = 8 ceil(D / 256)
// values a lane), so every access is a 16-byte one and the row's
// statistics are warp shuffles. The warps are persistent: a grid of one
// wave of 8-warp blocks, at most two an SM (ops/fused_ln.py ln_plan sizes
// it), warp w of W walking rows w, w + W, .. in that order. Each thread copies its own
// chunks of the next rows into the warp's shared-memory ring (three rows
// where they fit: the one computed and two in flight) by cp.async, so a
// row's loads (h, res and, in the backward, dy in the same round) are in
// flight behind the previous rows' work and no barrier is needed (a thread
// reads only what it copied). gamma and beta sit in registers for all of a
// warp's rows; the backward reads dy from the ring twice rather than
// holding it, and where its three inputs outrun the L2 it loads them
// evict-first. Its dgamma/dbeta column sums are deterministic: each lane
// sums its columns over its warp's rows in row order, the block sums its
// warps in warp order in shared memory and writes one partial row, and
// ln_col_sum sums the partial rows in a fixed tree (48 blocks of 32 warps
// at D 768). The second route, "scalar" (any other row width or
// alignment), is the same warp walk with one value a lane a step and no
// ring.
#include <type_traits>

#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kWarps = 8;       // warps a block (ops/fused_ln.py WARPS)
constexpr int kSumWarps = 32;   // warps a block of ln_col_sum
// shared memory of an SM (1 KB of it reserved per resident block) and the
// most one block may take
constexpr int kSmemSM = 228 * 1024;
constexpr int kSmemBlock = 227 * 1024;

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

// bytes of a block's rings: S stages of NT tensors' rows a warp
template <typename T, int E, int NT, int S>
__host__ __device__ constexpr int ring_bytes() {
  return kWarps * S * NT * (E / vec_of<T>()) * 32 * 16;
}

// rows a warp holds (the one computed and the next S - 1 in flight): three
// where the backward's ring fits a block, else two (ops/fused_ln.py ring
// computes the same stages for the plan, and the launchers refuse a plan
// of others). The backward's blocks an SM: two up to E 24 (its
// registers), fewer where the ring allows fewer; ln_plan's grid assumes
// the same.
template <typename T, int E>
__host__ __device__ constexpr int stages_of() {
  return ring_bytes<T, E, 3, 3>() <= kSmemBlock ? 3 : 2;
}

template <typename T, int E>
__host__ __device__ constexpr int blocks_per_sm() {
  constexpr int by_smem =
      kSmemSM / (ring_bytes<T, E, 3, stages_of<T, E>()>() + 1024);
  return E <= 24 && by_smem >= 2 ? 2 : 1;
}

// 16 bytes -> VEC floats, and back (bf16: round to nearest even, as
// __float2bfloat16)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (std::is_same_v<T, float>) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (std::is_same_v<T, float>)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  else
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// The warp's ring: stage s, tensor t, chunk j of lane l at
// ((s * NT + t) * CPL + j) * 32 + l (uint4 units), so a warp's read of one
// chunk index is 512 contiguous bytes.
template <int NT, int CPL>
__device__ __forceinline__ uint4& slot(uint4* ring, int s, int t, int j,
                                      int lane) {
  return ring[((s * NT + t) * CPL + j) * 32 + lane];
}

// an L2 policy for the backward's loads: evict-first where its inputs
// outrun the L2 (ops/fused_ln.py ln_plan), so that the streamed rows do
// not push out the dirty dh, dres and partial rows; else normal
__device__ __forceinline__ uint64_t load_policy(int evict_first) {
  uint64_t pol;
  if (evict_first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(pol));
  return pol;
}

// this thread's chunks of row ``row`` of the NT tensors into stage s, one
// commit group (empty when the warp has no such row); HINT: the copies
// carry the L2 policy ``pol``
template <typename T, int NT, int CPL, bool HINT = false>
__device__ __forceinline__ void stage_row(uint4* ring, int s,
                                          const T* const (&src)[NT], int row,
                                          int N, int D, int lane,
                                          int nchunks, uint64_t pol = 0) {
  // the stage's previous reads by this thread are done before any copy
  // into it is issued
  asm volatile("" ::: "memory");
  if (row < N) {
    constexpr int VEC = vec_of<T>();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < nchunks) {
          void* dst = &slot<NT, CPL>(ring, s, t, j, lane);
          const T* from = src[t] + (size_t)row * D + c * VEC;
          if constexpr (HINT)
            asm volatile(
                "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, "
                "%2;\n" ::"r"(smem_u32(dst)),
                "l"(from), "l"(pol));
          else
            cp_async_16(dst, from, 16);
        }
      }
  }
  cp_async_commit();
}

// gamma (and beta) for this lane's columns, once a warp
template <typename T, int E>
__device__ __forceinline__ void lane_params(const float* __restrict__ p,
                                            int lane, int nchunks,
                                            float (&out)[E]) {
  constexpr int VEC = vec_of<T>(), CPL = E / VEC;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[j * VEC + e] = c < nchunks ? p[c * VEC + e] : 0.f;
  }
}

// x = res + dropout(h) for this lane's columns of the row staged at st (h
// and res its tensors 0 and 1), the keep decisions as a bit mask (bit
// j VEC + e), and the lane's sums of x and x^2
template <typename T, int E>
__device__ __forceinline__ uint32_t staged_x(const uint4* st, int row, int D,
                                             int lane, int nchunks, int drop,
                                             uint32_t thr, float scale,
                                             uint32_t seed, float (&x)[E],
                                             float* sum, float* sq) {
  constexpr int VEC = vec_of<T>(), CPL = E / VEC;
  uint32_t keep = 0;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < nchunks) {
      float hv[VEC], rv[VEC];
      unpack<T>(st[j * 32 + lane], hv);  // tensors 0 and 1 of the stage
      unpack<T>(st[(CPL + j) * 32 + lane], rv);
      const uint32_t idx = (uint32_t)row * (uint32_t)D + (uint32_t)(c * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = hv[e];
        if (drop) {
          const bool k = hash_bits(idx + (uint32_t)e, seed) >= thr;
          keep |= (uint32_t)k << (j * VEC + e);
          v = k ? v * scale : 0.f;
        }
        const float xv = rv[e] + v;
        x[j * VEC + e] = xv;
        a += xv;
        b += xv * xv;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[j * VEC + e] = 0.f;
    }
  }
  *sum = a;
  *sq = b;
  return keep;
}

// the row's rstd and -mean * rstd from the lanes' sums of x and x^2:
// xhat = x * rstd + nmr
__device__ __forceinline__ void stats(float s, float ss, int D, float eps,
                                      float* rstd, float* nmr) {
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float m = s / (float)D;
  const float r = rsqrtf(fmaxf(0.f, ss / (float)D - m * m) + eps);
  *rstd = r;
  *nmr = -m * r;
}

template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32, 2)
ln_fwd_vec(const T* __restrict__ h, const T* __restrict__ res,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           const int* __restrict__ seed_p, T* __restrict__ y, int N, int D,
           int drop, uint32_t thr, float scale, float eps) {
  constexpr int VEC = vec_of<T>(), CPL = E / VEC, NT = 2;
  constexpr int S = stages_of<T, E>();
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = D / VEC;
  const int stride = gridDim.x * kWarps;
  uint4* ring = smem + warp * (S * NT * CPL * 32);
  const T* const src[NT] = {h, res};
  const uint32_t seed = (uint32_t)seed_p[0];
  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int k = 0; k < S - 1; ++k)
    stage_row<T, NT, CPL>(ring, k, src, row + k * stride, N, D, lane,
                          nchunks);
  float g[E], b[E];
  lane_params<T, E>(gamma, lane, nchunks, g);
  lane_params<T, E>(beta, lane, nchunks, b);
  for (int s = 0; row < N; row += stride, s = s + 1 == S ? 0 : s + 1) {
    stage_row<T, NT, CPL>(ring, s == 0 ? S - 1 : s - 1, src,
                          row + (S - 1) * stride, N, D, lane, nchunks);
    cp_async_wait<S - 1>();  // this row's group has landed
    float x[E], sum, sq;
    staged_x<T, E>(ring + s * NT * CPL * 32, row, D, lane, nchunks, drop,
                   thr, scale, seed, x, &sum, &sq);
    float rstd, nmr;
    stats(sum, sq, D, eps, &rstd, &nmr);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nchunks) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = j * VEC + e;
          o[e] = fmaf(fmaf(x[i], rstd, nmr), g[i], b[i]);
        }
        *reinterpret_cast<uint4*>(y + (size_t)row * D + c * VEC) = pack<T>(o);
      }
    }
  }
  cp_async_wait<0>();
}

// partial: [gridDim.x][2][D] fp32 (this block's dgamma row, then dbeta's)
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32, blocks_per_sm<T, E>())
ln_bwd_vec(const T* __restrict__ h, const T* __restrict__ res,
           const float* __restrict__ gamma, const int* __restrict__ seed_p,
           const T* __restrict__ dy, T* __restrict__ dh, T* __restrict__ dres,
           float* __restrict__ partial, int N, int D, int drop, uint32_t thr,
           float scale, float eps, int evict_first) {
  constexpr int VEC = vec_of<T>(), CPL = E / VEC, NT = 3;
  constexpr int S = stages_of<T, E>();
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = D / VEC;
  const int stride = gridDim.x * kWarps;
  uint4* ring = smem + warp * (S * NT * CPL * 32);
  const T* const src[NT] = {h, res, dy};
  const uint32_t seed = (uint32_t)seed_p[0];
  const uint64_t pol = load_policy(evict_first);
  int row = blockIdx.x * kWarps + warp;
#pragma unroll
  for (int k = 0; k < S - 1; ++k)
    stage_row<T, NT, CPL, true>(ring, k, src, row + k * stride, N, D, lane,
                                nchunks, pol);
  float g[E], pg[E], pb[E];
  lane_params<T, E>(gamma, lane, nchunks, g);
#pragma unroll
  for (int i = 0; i < E; ++i) pg[i] = pb[i] = 0.f;

  for (int s = 0; row < N; row += stride, s = s + 1 == S ? 0 : s + 1) {
    stage_row<T, NT, CPL, true>(ring, s == 0 ? S - 1 : s - 1, src,
                                row + (S - 1) * stride, N, D, lane, nchunks,
                                pol);
    cp_async_wait<S - 1>();
    const uint4* st = ring + s * NT * CPL * 32;
    float x[E], sum, sq;
    const uint32_t keep = staged_x<T, E>(st, row, D, lane, nchunks, drop,
                                         thr, scale, seed, x, &sum, &sq);
    float rstd, nmr;
    stats(sum, sq, D, eps, &rstd, &nmr);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      float d[VEC];
      if (c < nchunks) {
        unpack<T>(st[(2 * CPL + j) * 32 + lane], d);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) d[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = j * VEC + e;
        const float xh = fmaf(x[i], rstd, nmr);
        const float dxh = d[e] * g[i];
        a1 += dxh;
        a2 += dxh * xh;
        pg[i] += d[e] * xh;
        pb[i] += d[e];
        x[i] = xh;  // x now holds xhat
      }
    }
    // dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
    const float c0 = -rstd * (warp_sum(a1) / (float)D);
    const float c1 = -rstd * (warp_sum(a2) / (float)D);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nchunks) {
        float d[VEC], dx[VEC], dhv[VEC];
        unpack<T>(st[(2 * CPL + j) * 32 + lane], d);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = j * VEC + e;
          dx[e] = fmaf(d[e], g[i] * rstd, fmaf(x[i], c1, c0));
          dhv[e] = dx[e];
          if (drop) dhv[e] = ((keep >> i) & 1u) ? dx[e] * scale : 0.f;
        }
        const size_t at = (size_t)row * D + c * VEC;
        *reinterpret_cast<uint4*>(dres + at) = pack<T>(dx);
        *reinterpret_cast<uint4*>(dh + at) = pack<T>(dhv);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // the block's partial row: warp w's sums at red[w][2][D], then summed in
  // warp order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < nchunks)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[(warp * 2) * D + c * VEC + e] = pg[j * VEC + e];
        red[(warp * 2 + 1) * D + c * VEC + e] = pb[j * VEC + e];
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * 2 * D + c];
    partial[(size_t)blockIdx.x * 2 * D + c] = s;
  }
}

// ---------------------------------------------------------------- scalar
// The second route: the same warp walk, value lane + 32 i of a row in
// register i (E = 8 ceil(D / 256) of them), no ring.

// x = res + dropout(h) for the E columns lane + 32 i of one row, with the
// keep decisions as a bit mask; returns through the arrays.
template <typename T, int E>
__device__ __forceinline__ uint32_t load_row(const T* __restrict__ h,
                                             const T* __restrict__ res,
                                             int row, int D, int lane,
                                             int drop, uint32_t thr,
                                             float scale, uint32_t seed,
                                             float (&x)[E], float* sum,
                                             float* sq) {
  const size_t base = (size_t)row * D;
  uint32_t keep = 0;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
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
    a += v;
    b += v * v;
  }
  *sum = a;
  *sq = b;
  return keep;
}

template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32, 1)
ln_fwd_scalar(const T* __restrict__ h, const T* __restrict__ res,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const int* __restrict__ seed_p, T* __restrict__ y, int N, int D,
              int drop, uint32_t thr, float scale, float eps) {
  const int lane = threadIdx.x & 31;
  const uint32_t seed = (uint32_t)seed_p[0];
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < N;
       row += gridDim.x * kWarps) {
    float x[E], sum, sq, rstd, nmr;
    load_row<T, E>(h, res, row, D, lane, drop, thr, scale, seed, x, &sum,
                   &sq);
    stats(sum, sq, D, eps, &rstd, &nmr);
    const size_t base = (size_t)row * D;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int c = lane + 32 * i;
      if (c < D)
        y[base + c] = from_f<T>(fmaf(fmaf(x[i], rstd, nmr), gamma[c], beta[c]));
    }
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32, 1)
ln_bwd_scalar(const T* __restrict__ h, const T* __restrict__ res,
              const float* __restrict__ gamma, const int* __restrict__ seed_p,
              const T* __restrict__ dy, T* __restrict__ dh,
              T* __restrict__ dres, float* __restrict__ partial, int N, int D,
              int drop, uint32_t thr, float scale, float eps) {
  extern __shared__ float red[];  // [kWarps][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t seed = (uint32_t)seed_p[0];
  float pg[E], pb[E];
#pragma unroll
  for (int i = 0; i < E; ++i) pg[i] = pb[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < N;
       row += gridDim.x * kWarps) {
    float x[E], g[E], sum, sq, rstd, nmr;
    const uint32_t keep = load_row<T, E>(h, res, row, D, lane, drop, thr,
                                         scale, seed, x, &sum, &sq);
    stats(sum, sq, D, eps, &rstd, &nmr);
    const size_t base = (size_t)row * D;
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int c = lane + 32 * i;
      float d = 0.f, gm = 0.f;
      if (c < D) {
        d = to_f(dy[base + c]);
        gm = gamma[c];
      }
      const float xh = fmaf(x[i], rstd, nmr);
      const float dxh = d * gm;
      a1 += dxh;
      a2 += dxh * xh;
      pg[i] += d * xh;
      pb[i] += d;
      x[i] = xh;   // x now holds xhat
      g[i] = dxh;  // g holds dxhat
    }
    const float c0 = -rstd * (warp_sum(a1) / (float)D);
    const float c1 = -rstd * (warp_sum(a2) / (float)D);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        const float dx = fmaf(g[i], rstd, fmaf(x[i], c1, c0));
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
    for (int i = 0; i < E; ++i) {
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

// dgdb[c] = sum_g partial[g][c] over the G partial rows, c < 2 D (dgamma's
// columns, then dbeta's): block b takes columns 32 b .. 32 b + 32, its
// warp w the rows g = w, w + 32, .. in order, then the 32 warps' sums are
// added in warp order. A fixed tree: two runs are bitwise equal.
__global__ void __launch_bounds__(kSumWarps * 32)
ln_col_sum(const float* __restrict__ partial, int G, int D,
           float* __restrict__ dgdb) {
  __shared__ float part[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * D) {
#pragma unroll 4
    for (int g = warp; g < G; g += kSumWarps)
      s += partial[(size_t)g * 2 * D + c];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < 2 * D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += part[w][lane];
    dgdb[c] = t;
  }
}

template <typename K>
bool allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int E>
int launch_fwd(const void* h, const void* res, const void* gamma,
               const void* beta, const void* seed, void* y, int N, int D,
               int drop, uint32_t thr, float scale, float eps, int stages,
               int blocks, cudaStream_t st) {
  if (stages == 0) {
    ln_fwd_scalar<T, E><<<blocks, kWarps * 32, 0, st>>>(
        (const T*)h, (const T*)res, (const float*)gamma, (const float*)beta,
        (const int*)seed, (T*)y, N, D, drop, thr, scale, eps);
    return (int)cudaGetLastError();
  }
  if (stages != stages_of<T, E>() || (D * (int)sizeof(T)) % 16 != 0 ||
      !aligned16(h) || !aligned16(res) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = ring_bytes<T, E, 2, stages_of<T, E>()>();
  static const bool ok = allow_smem(ln_fwd_vec<T, E>, smem);
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  ln_fwd_vec<T, E><<<blocks, kWarps * 32, smem, st>>>(
      (const T*)h, (const T*)res, (const float*)gamma, (const float*)beta,
      (const int*)seed, (T*)y, N, D, drop, thr, scale, eps);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_bwd(const void* h, const void* res, const void* gamma,
               const void* seed, const void* dy, void* dh, void* dres,
               void* partial, void* dgdb, int N, int D, int drop,
               uint32_t thr, float scale, float eps, int stages, int blocks,
               int evict_first, cudaStream_t st) {
  if (stages == 0) {
    ln_bwd_scalar<T, E><<<blocks, kWarps * 32, sizeof(float) * kWarps * D,
                          st>>>(
        (const T*)h, (const T*)res, (const float*)gamma, (const int*)seed,
        (const T*)dy, (T*)dh, (T*)dres, (float*)partial, N, D, drop, thr,
        scale, eps);
  } else {
    if (stages != stages_of<T, E>() || (D * (int)sizeof(T)) % 16 != 0 ||
        !aligned16(h) || !aligned16(res) || !aligned16(dy) ||
        !aligned16(dh) || !aligned16(dres))
      return (int)cudaErrorInvalidValue;
    // the ring also holds the block's 2 D partial sums of each warp
    constexpr int smem = ring_bytes<T, E, 3, stages_of<T, E>()>();
    static_assert(smem >= kWarps * 2 * (E / 8 * 256) * 4,
                  "the ring must hold the warps' partial rows");
    static const bool ok = allow_smem(ln_bwd_vec<T, E>, smem);
    if (!ok) return (int)cudaErrorInvalidConfiguration;
    ln_bwd_vec<T, E><<<blocks, kWarps * 32, smem, st>>>(
        (const T*)h, (const T*)res, (const float*)gamma, (const int*)seed,
        (const T*)dy, (T*)dh, (T*)dres, (float*)partial, N, D, drop, thr,
        scale, eps, evict_first);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_col_sum<<<(2 * D + 31) / 32, kSumWarps * 32, 0, st>>>(
      (const float*)partial, blocks, D, (float*)dgdb);
  return (int)cudaGetLastError();
}

// E = 8 ceil(D / 256) values a lane, D <= 1024 (ops/fused_ln.py ln_plan)
template <typename F>
int dispatch(int D, F&& fn) {
  if (D <= 256) return fn(std::integral_constant<int, 8>());
  if (D <= 512) return fn(std::integral_constant<int, 16>());
  if (D <= 768) return fn(std::integral_constant<int, 24>());
  return fn(std::integral_constant<int, 32>());
}

}  // namespace

// stages, blocks: ops/fused_ln.py ln_plan (stages 0 is the scalar route;
// the vector route's stages must be this file's, and its rows aligned)
extern "C" int vlpet_ln_fwd(const void* h, const void* res, const void* gamma,
                            const void* beta, const void* seed, void* y,
                            int N, int D, int drop, int thr, float scale,
                            float eps, int is_bf16, int stages, int blocks,
                            void* stream) {
  if (N < 1 || D < 1 || D > 1024 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch(D, [&](auto n) {
      return launch_fwd<bf16, decltype(n)::value>(
          h, res, gamma, beta, seed, y, N, D, drop, (uint32_t)thr, scale, eps,
          stages, blocks, st);
    });
  return dispatch(D, [&](auto n) {
    return launch_fwd<float, decltype(n)::value>(
        h, res, gamma, beta, seed, y, N, D, drop, (uint32_t)thr, scale, eps,
        stages, blocks, st);
  });
}

// partial: (blocks, 2, D) fp32 scratch; dgdb: (2, D) fp32, dgamma then
// dbeta; evict_first: the plan's L2 policy of the vector route's loads
extern "C" int vlpet_ln_bwd(const void* h, const void* res, const void* gamma,
                            const void* seed, const void* dy, void* dh,
                            void* dres, void* partial, void* dgdb, int N,
                            int D, int drop, int thr, float scale, float eps,
                            int is_bf16, int stages, int blocks,
                            int evict_first, void* stream) {
  if (N < 1 || D < 1 || D > 1024 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch(D, [&](auto n) {
      return launch_bwd<bf16, decltype(n)::value>(
          h, res, gamma, seed, dy, dh, dres, partial, dgdb, N, D, drop,
          (uint32_t)thr, scale, eps, stages, blocks, evict_first, st);
    });
  return dispatch(D, [&](auto n) {
    return launch_bwd<float, decltype(n)::value>(
        h, res, gamma, seed, dy, dh, dres, partial, dgdb, N, D, drop,
        (uint32_t)thr, scale, eps, stages, blocks, evict_first, st);
  });
}
