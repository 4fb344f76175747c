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
// bf16 tensor-core time, so the bound is the bytes. One block per (head,
// batch) -- 6000 blocks at the encoder site -- holds the whole head, so dk
// and dv, which reduce over the query rows, are summed inside the block:
// no atomics, and the result does not depend on scheduling. Two routes,
// picked by the wrapper with ops/attention.py a6_route (a plain function of
// L, S, Dh and dtype) and passed as ``tc``:
//
// "fma" (fp32; bf16 at Dh != 64 or L or S > 64): q, do, k, v staged in
// shared memory as fp32 (k and v rows padded one float so the lane-per-key
// dot products hit distinct banks) with the (L, S) p and dp/ds matrices;
// the products on FP32 FMA. At the encoder site in bf16 it took ~2.0 ms,
// bound by shared-memory loads (one or two per FMA), with 82,880 bytes a
// block (2 blocks an SM) and nothing to hide a block's load -> compute ->
// store. The fp32 parity phases hold it to full fp32 arithmetic (no TF32),
// so it stays, unchanged.
//
// "tc" (bf16, Dh 64, L, S <= 64; every A6 site of the repo),
// attention_bwd_tc: mma.sync m16n8k16 (bf16 in, fp32 sums), 4 warps.
// q, do, k, v go to bf16 64 x 72 tiles by 16-byte cp.async (zeros past L
// and S), the bias (when given) to an fp32 tile. Warp w owns query rows
// 16 w .. 16 w + 16: s = q k^T and dp = do v^T stay in C fragments; the
// softmax runs over the whole row (S <= 64 keys) with quad reductions and
// EX2, needing no lse; the dropout's keep bit, p_drop and ds = p (dp -
// rowsum(dp p)) are formed in registers; dq = ds k takes ds as its A
// fragment (mma_a_from_c). p_drop and ds are written once to bf16 tiles
// (and ds, fp32, to the dbias partial); after one barrier warp w owns keys
// 16 w .. 16 w + 16 and computes dv = p_drop^T do and dk = ds^T q, their A
// fragments read transposed (ldmatrix.trans), summed over the query chunks
// in order. 55,552 bytes of shared memory a block (73,984 with the bias):
// 3-4 blocks an SM. Why mma.sync and not wgmma: the tiles are at most 64 x
// 64 and each warp's 16 rows finish the softmax in registers; a 64-row
// wgmma would need the four warps' rows in one instruction.
// Where it rounds differently from the FMA kernel: p (dropped) and ds
// enter the dv, dk and dq products in bf16 (the TPU kernel rounds ds to
// bf16 too), and exp is EX2 on log2(e)-scaled differences; the bf16 checks
// hold it to 2e-2 (1 + max|plain|), the rule of every bf16 backward.
// Resources (nvcc -Xptxas -v, sm_90a): 122-126 registers, no spills.
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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, Dh 64, L, S <= 64; header).

constexpr int kTcThreads = 128;  // 4 warps, 16 query rows or 16 keys each
constexpr int kBiasLd = kTcRows + 8;  // the fp32 bias tile's row stride

// bf16 q, do, k, v and the p_drop and ds tiles, the mask, and with a bias
// its fp32 (L, S) tile
__host__ __device__ constexpr size_t tc_smem(bool bias) {
  return 6 * (size_t)kTcTile * 2 + kTcRows * 4 +
         (bias ? (size_t)kTcRows * kBiasLd * 4 : 0);
}

// A fragment of tile^T: rows m0 .. m0 + 16 of the transpose (columns of
// the tile), k = rows 16 kc .. 16 kc + 16 of the tile (ldmatrix.trans)
__device__ __forceinline__ void tc_frag_at(uint32_t (&a)[4], const bf16* tile,
                                           int m0, int kc, int lane) {
  const int mi = lane >> 3;
  const int row = kc * 16 + (lane & 7) + (mi >> 1) * 8;
  const int col = m0 + (mi & 1) * 8;
  ldmatrix_x4_trans(a, tile + row * kTcLd + col);
}

// One block per (head, batch). Warp w first owns query rows 16 w .. 16 w +
// 16: s = q k^T and dp = do v^T in C fragments, the softmax over the whole
// row (S <= 64 keys) with quad reductions, the dropout, ds, and dq = ds k
// with ds as the A fragment (mma_a_from_c); it writes p_drop and ds, in
// bf16, to shared tiles (and ds, fp32, to the dbias partial). Then warp w
// owns keys 16 w .. 16 w + 16: dv = p_drop^T do and dk = ds^T q, the A
// fragments read transposed from those tiles.
template <bool BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ bias,
                 const int* __restrict__ seed_p,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ dbias_part, int L, int S, int H,
                 int mask_batched, int causal, uint32_t thr, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kTcTile;   // dO
  bf16* Ks = Gs + kTcTile;
  bf16* Vs = Ks + kTcTile;
  bf16* Ps = Vs + kTcTile;   // p_drop [query][key]
  bf16* DSs = Ps + kTcTile;  // ds [query][key]
  float* Ms = reinterpret_cast<float*>(DSs + kTcTile);  // [64]
  float* Bs = Ms + kTcRows;  // [64][kBiasLd], with a bias

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * kTcD;
  const size_t koff = (size_t)b * S * inner + (size_t)h * kTcD;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);

  tc_load_tile(Qs, q + qoff, 0, L, inner, kTcThreads);
  tc_load_tile(Gs, dout + qoff, 0, L, inner, kTcThreads);
  tc_load_tile(Ks, k + koff, 0, S, inner, kTcThreads);
  tc_load_tile(Vs, v + koff, 0, S, inner, kTcThreads);
  if (BIAS)
    tc_load_bias(Bs, kBiasLd, bias + (size_t)h * L * S, 0, kTcRows, L, 0, S,
                 kTcThreads);
  cp_async_commit();
  if (threadIdx.x < kTcRows)
    Ms[threadIdx.x] = (int)threadIdx.x < S ? mb[threadIdx.x] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int nq = (L + 15) >> 4;  // 16-row query chunks
  const int nk = (S + 15) >> 4;  // 16-key chunks
  const int r0 = warp * 16;
  if (warp < nq) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t qa[4], ga[4];
      tc_frag_a(qa, Qs, r0, kc, lane);
      tc_frag_a(ga, Gs, r0, kc, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= nk) break;
        uint32_t bk[4], bv[4];
        tc_frag_bt(bk, Ks, np * 16, kc, lane);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        tc_frag_bt(bv, Vs, np * 16, kc, lane);
        mma_bf16(dp[2 * np], ga, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ga, bv[2], bv[3]);
      }
    }
    // element (r, c) of n8 tile nt: query r0 + g + 8 r, key 8 nt + 2 t + c
    const uint32_t hseed = DROP ? head_seed((uint32_t)seed_p[0], h) : 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = nt * 8 + 2 * t + c;
          float a = -INFINITY;
          if (kj < S) {
            a = s[nt][2 * r + c] + Ms[kj];
            if (BIAS) a += Bs[qi * kBiasLd + kj];
            if (causal && kj > qi + (S - L)) a = -1e9f;
          }
          s[nt][2 * r + c] = a;
          m = fmaxf(m, a);
        }
      m = quad_max(m);
      float z = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2((s[nt][2 * r + c] - m) * kLog2e);
          s[nt][2 * r + c] = e;
          z += e;
        }
      const float inv = 1.f / quad_sum(z);
      // p; dp through the dropout mask; rowsum(dp p)
      float tsum = 0.f;
      const uint32_t irow = ((uint32_t)b * (uint32_t)L + (uint32_t)qi) *
                            (uint32_t)S;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = nt * 8 + 2 * t + c;
          const float p = s[nt][2 * r + c] * inv;
          float d = dp[nt][2 * r + c];
          if (DROP)
            d = hash_bits(irow + (uint32_t)kj, hseed) >= thr ? d * scale : 0.f;
          s[nt][2 * r + c] = p;
          dp[nt][2 * r + c] = d;
          tsum = fmaf(d, p, tsum);
        }
      tsum = quad_sum(tsum);
      // ds = p (dp - rowsum); s <- p_drop; both 0 past L
      const bool row_in = qi < L;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = nt * 8 + 2 * t + c;
          const float p = s[nt][2 * r + c];
          float pd = p;
          if (DROP)
            pd = hash_bits(irow + (uint32_t)kj, hseed) >= thr ? p * scale
                                                               : 0.f;
          dp[nt][2 * r + c] = row_in ? p * (dp[nt][2 * r + c] - tsum) : 0.f;
          s[nt][2 * r + c] = row_in ? pd : 0.f;
        }
    }
    // p_drop and ds to their bf16 tiles; ds (fp32) to the dbias partial
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= 2 * nk) break;
      const int kj = nt * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r0 + g + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(Ps + qi * kTcLd + kj) =
            __floats2bfloat162_rn(s[nt][2 * r], s[nt][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(DSs + qi * kTcLd + kj) =
            __floats2bfloat162_rn(dp[nt][2 * r], dp[nt][2 * r + 1]);
        if (dbias_part != nullptr && qi < L) {
          float* dst = dbias_part + (((size_t)b * H + h) * L + qi) * S + kj;
          if (kj < S) dst[0] = dp[nt][2 * r];
          if (kj + 1 < S) dst[1] = dp[nt][2 * r + 1];
        }
      }
    }
    // dq = ds k over the keys
    float aq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nk) break;
      uint32_t sa[4];
      mma_a_from_c(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t bk[4];
        tc_frag_b(bk, Ks, kk * 16, 2 * dd, lane);
        mma_bf16(aq[2 * dd], sa, bk[0], bk[1]);
        mma_bf16(aq[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      if (qi >= L) continue;
      bf16* dst = dq + qoff + (size_t)qi * inner;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(aq[dt][2 * r], aq[dt][2 * r + 1]);
    }
  }
  __syncthreads();  // every p_drop and ds row is in its tile

  // dv = p_drop^T do, dk = ds^T q for keys 16 w .. 16 w + 16, the query
  // chunks in order
  if (warp >= nk) return;
  float av[8][4], ak[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[i][e] = ak[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= nq) break;
    uint32_t pa[4], sa[4];
    tc_frag_at(pa, Ps, r0, kk, lane);
    tc_frag_at(sa, DSs, r0, kk, lane);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      uint32_t bg[4], bq[4];
      tc_frag_b(bg, Gs, kk * 16, 2 * dd, lane);
      tc_frag_b(bq, Qs, kk * 16, 2 * dd, lane);
      mma_bf16(av[2 * dd], pa, bg[0], bg[1]);
      mma_bf16(av[2 * dd + 1], pa, bg[2], bg[3]);
      mma_bf16(ak[2 * dd], sa, bq[0], bq[1]);
      mma_bf16(ak[2 * dd + 1], sa, bq[2], bq[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = r0 + g + 8 * r;
    if (kj >= S) continue;
    const size_t row = koff + (size_t)kj * inner;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
          __floats2bfloat162_rn(ak[dt][2 * r], ak[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + d) =
          __floats2bfloat162_rn(av[dt][2 * r], av[dt][2 * r + 1]);
    }
  }
}

template <bool BIAS, bool DROP>
int launch_tc_terms(const void* q, const void* k, const void* v,
                    const void* mask, const void* bias, const void* seed,
                    const void* dout, void* dq, void* dk, void* dv,
                    void* dbias_part, int B, int L, int S, int H,
                    int mask_batched, int causal, uint32_t thr, float scale,
                    cudaStream_t st) {
  const size_t smem = tc_smem(BIAS);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_tc<BIAS, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_tc<BIAS, DROP><<<dim3(H, B), kTcThreads, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask,
      (const float*)bias, (const int*)seed, (const bf16*)dout, (bf16*)dq,
      (bf16*)dk, (bf16*)dv, (float*)dbias_part, L, S, H, mask_batched, causal,
      thr, scale);
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, const void* mask,
              const void* bias, const void* seed, const void* dout, void* dq,
              void* dk, void* dv, void* dbias_part, int B, int L, int S,
              int H, int mask_batched, int causal, int drop, uint32_t thr,
              float scale, cudaStream_t st) {
  if (bias != nullptr)
    return drop ? launch_tc_terms<true, true>(q, k, v, mask, bias, seed, dout,
                                              dq, dk, dv, dbias_part, B, L, S,
                                              H, mask_batched, causal, thr,
                                              scale, st)
                : launch_tc_terms<true, false>(q, k, v, mask, bias, seed,
                                               dout, dq, dk, dv, dbias_part,
                                               B, L, S, H, mask_batched,
                                               causal, thr, scale, st);
  return drop ? launch_tc_terms<false, true>(q, k, v, mask, bias, seed, dout,
                                             dq, dk, dv, dbias_part, B, L, S,
                                             H, mask_batched, causal, thr,
                                             scale, st)
              : launch_tc_terms<false, false>(q, k, v, mask, bias, seed, dout,
                                              dq, dk, dv, dbias_part, B, L, S,
                                              H, mask_batched, causal, thr,
                                              scale, st);
}

// dbias (when asked for) from the (B, H, L, S) partials, in batch order
int launch_dbias(const void* dbias_part, void* dbias, int B, int L, int S,
                 int H, cudaStream_t st) {
  const long n = (long)H * L * S;
  dbias_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, st>>>((const float*)dbias_part, (float*)dbias, B,
                                 n);
  return (int)cudaGetLastError();
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
  return launch_dbias(dbias_part, dbias, B, L, S, H, st);
}

}  // namespace

// dbias_part: fp32 scratch of B * H * L * S floats and dbias the (H, L, S)
// fp32 output, both NULL for no bias gradient (they need a bias). tc: the
// tensor-core route (bf16, Dh 64, L, S <= 64; ops/attention.py a6_route).
extern "C" int vlpet_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* bias, const void* seed,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* dbias_part, void* dbias,
                                   int B, int L, int S, int H, int Dh,
                                   int mask_batched, int causal, int is_bf16,
                                   int tc, int drop, int thr, float scale,
                                   void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || Dh < 1 || B > 65535 ||
      (drop && (seed == nullptr || thr < 0)) ||
      ((dbias != nullptr) != (dbias_part != nullptr)) ||
      (dbias != nullptr && bias == nullptr) ||
      (tc && (!is_bf16 || Dh != kTcD || L > kTcRows || S > kTcRows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
    const int err = launch_tc(q, k, v, mask, bias, seed, dout, dq, dk, dv,
                              dbias_part, B, L, S, H, mask_batched, causal,
                              drop, (uint32_t)thr, scale, st);
    if (err != 0 || dbias == nullptr) return err;
    return launch_dbias(dbias_part, dbias, B, L, S, H, st);
  }
  if (is_bf16)
    return launch<bf16>(q, k, v, mask, bias, seed, dout, dq, dk, dv,
                        dbias_part, dbias, B, L, S, H, Dh, mask_batched,
                        causal, drop, (uint32_t)thr, scale, st);
  return launch<float>(q, k, v, mask, bias, seed, dout, dq, dk, dv,
                       dbias_part, dbias, B, L, S, H, Dh, mask_batched, causal,
                       drop, (uint32_t)thr, scale, st);
}
