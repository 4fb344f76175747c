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
// L, S, Dh and dtype) and passed as ``tc``; "tc" has three kernels, one
// for a single 64-row tile, one for L or S past 64 up to 128 and one past
// 128 up to 256. ops/attention.py backward_route gives A6 every bf16 Dh 64
// site with L, S <= 256 (the "tc" kernels stage no (L, S) matrix) and
// other sites where the FMA kernel's fp32 staging fits a block; the rest
// (S 604, 704, 1024) take the long backward (csrc/attention_bwd_long.cu):
//
// "fma" (fp32; bf16 at Dh != 64): q, do, k, v staged in
// shared memory as fp32 (k and v rows padded one float so the lane-per-key
// dot products hit distinct banks) with the (L, S) p and dp/ds matrices;
// the products on FP32 FMA. At the encoder site in bf16 it took ~2.0 ms,
// bound by shared-memory loads (one or two per FMA), with 82,880 bytes a
// block (2 blocks an SM) and nothing to hide a block's load -> compute ->
// store. The fp32 parity phases hold it to full fp32 arithmetic (no TF32),
// so it stays, unchanged.
//
// "tc", L, S <= 64 (the image-text train sites at L, S <= 56),
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
//
// "tc", L or S past 64 (up to 128: the CLI's caption L = S 76 and nlvr
// S 102, the prompts' S 96 / 116, the raw path's S 69 / 118 cross sites,
// the prefixes' S 96), attention_bwd_tc_wide. The FMA kernel staged 172,800
// bytes a block at L = S = 96 (one block an SM, nothing to hide a block's
// load -> compute -> store) and took 6-9x SDPA autograd's time there. PR
// 9's layout grown to 128 rows would hold q, do, k, v and the (L, S)
// p_drop and ds tiles: 143,872 bytes at 128 / 128, again one block an SM.
// So this kernel stores no (L, S) tile (FlashAttention-2's split): q, do,
// k, v in bf16 tiles of L and S rounded up to 16 rows (S to at least 64),
// the mask, three fp32 statistics a query row (max, 1 / sum, rowsum(dp
// p)) and, with the dropout, the row's keep bits: 56,832 bytes at 96 / 96
// (58,368 with the dropout), 75,776 at 128 / 128. 4 warps, or 6 where
// both L and S have 5 or 6 chunks of 16 (tw_threads); 168 registers
// (launch bounds (192, 2)): 3 blocks of 4 warps or 2 of 6, 12 warps an
// SM. Phase 1, warps own 16-row query chunks: s = q
// k^T over the whole row (up to 128 keys: 64 fp32 fragment registers,
// started from the bias, so the bias takes no registers of its own), the
// softmax with quad reductions and EX2; dp is never held whole but
// recomputed 16 keys at a time in two sweeps, the first for rowsum(dp p)
// and the dropout's keep bits (hashed once, kept in a register a row and
// in shared memory for phase 2), the second for ds, the dbias partial and
// dq = ds k (ds as the A fragment). Phase 2, after one barrier, warps own
// 16-key chunks and, a 16-query step at a time (a rolled loop), recompute
// s^T = k q^T and dp^T = v do^T, form p, p_drop and ds from the row
// statistics, and sum dv = p_drop^T do and dk = ds^T q with both as A
// fragments (mma_a_from_c), the query steps in order. Eight products
// instead of five: 10 L S Dh flops become 16 L S Dh, still far below the
// bytes' time. What bounds it is latency: 12 warps an SM and each warp's
// chain of ldmatrix -> mma -> softmax -> mma. Hence: phase 1's key loops
// run their first four chunks without a branch (S padded to 64), so the
// compiler schedules across them; phase 2's query loop is rolled, which
// keeps it within 168 registers in the bias modes; 6 warps where both
// sides have 5 or 6 chunks (tw_threads); and each block rotates which
// warp takes the chunks that do not divide among its warps (warp w runs
// on the SM's sub-partition w % 4), so that no sub-partition takes them
// all. Rounding as PR 9's kernel;
// exp(x - m) is EX2 of fma(x, log2 e, -m log2 e); phase 2's p is
// recomputed from the same statistics, so dk and dq see the same ds up to
// the fp32 order of the recomputed logits. A causally hidden logit is the
// constant -1e9 and gets ds = 0 (the plain twin's gradient through
// ``where``; it matters only in a row that sees no key).
// Resources (nvcc -Xptxas -v, sm_90a): PERF.md §6, the A6 row.
//
// "tc", L or S past 128 (up to 256: the prompt's nlvr L = S 142 and cross
// L 10 over S 142, the video tvc encoders L = S 141 / 181 and cross L 20
// over S 141 / 181, the raw 448 px encoder L = S 216),
// attention_bwd_tc_256. Until it, bf16 sites past 128 took the FMA kernel
// where its fp32 staging fitted (the cross sites, 1.3-1.5x SDPA autograd's
// time at tvc) and the long backward elsewhere (a forward with the row lse
// and two tiled kernels). The wide kernel's design carried past 128 keys
// meets two limits. Registers: a 16-row query chunk's whole row of s in C
// fragments is 64 fp32 registers a thread at 128 keys, 128 at 256. So
// phase 1 holds no row: sweep 1 goes over 16-key chunks for s and dp with
// an online softmax -- each lane's running max m, sum z of exp(s - m) and
// t of dp_drop exp(s - m), z and t rescaled by exp(m_old - m_new) where m
// grows, the quad's partials merged at the end, rowsum(dp p) = t / z --
// and hashes the dropout's keep bits once into shared memory; sweep 2
// recomputes s and dp a chunk at a time for p, ds, the dbias partial and
// dq = ds k. The other way, the forward's row lse with rowsum(dp p) =
// rowsum(do o), saves sweep 1 (5 of the 9 products a (query, key) chunk
// pair becomes 3) but makes the forward write the lse and the autograd
// function keep the output at these sites; A6 here keeps its contract
// instead: it recomputes from q, k, v and the mask and needs nothing
// saved. Phase 2 is the wide kernel's (tw_key_phase). Shared memory: q,
// do, k, v in bf16 at the wide kernel's 72-element stride, 147,456 bytes
// at 256 / 256, plus the mask, the row statistics and the keep bits; the
// block is sized to the site (L and S rounded up to 16), so the cross
// sites (L 10-20: one or two query chunks) fit 3 blocks an SM and the
// encoders up to ~190 rows 2. Warps: 12 an SM as in the wide kernel (4, 6
// or 12 a block; t2_warps), 168 registers (launch bounds (384, 1)); a
// block alone on its SM with more than 12 chunks (L or S past 192, the
// 448 px encoder's 14) takes one warp a chunk up to 16, so that each phase
// runs in one round instead of two, in a 128-register instance (launch
// bounds (512, 1); its spills, PERF.md §6, cost less than the second
// round at the 448 px encoder and the causal L = S 200 on an H100). At
// the cross sites phase 1 is one or two
// warps' chain over 9-12 key chunks and the other warps of the block wait
// at the barrier; the three blocks an SM fill in for one another. Rounding
// as the wide kernel's, but for the sums of sweep 1 (z and t rescaled in
// fp32). What bounds it, as the wide kernel: latency, at 4-9x its bytes'
// time on an H100 (PERF.md §6); the video sites' 600 blocks (B 50) are
// one or two waves.
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
// The tensor-core route within one tile (bf16, Dh 64, L, S <= 64; header).

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

// ---------------------------------------------------------------------------
// The tensor-core route past one tile (bf16, Dh 64, L, S <= 128, L or S
// > 64; header).

constexpr int kTwMaxThreads = 192;  // 4 warps, or 6 (tw_threads)
constexpr int kTwRows = 128;     // the largest L and S
constexpr int kTwNt = kTwRows / 8;  // n8 key tiles of a full query row
// phase 1's key loops run their first 4 chunks (64 keys, zeros past S)
// without a branch, so their products and loads schedule freely
constexpr int kTwMinChunks = 4;

// The wide kernel's threads: 6 warps where both the query and the key
// chunk counts are 5 or 6 (one chunk a warp: 2 blocks, 12 warps an SM),
// else 4 (3 blocks, 12 warps; 7 or 8 chunks two a warp). With 4 warps, 5
// chunks keep one warp at two while three wait at the barrier, 6 chunks
// two; where one side has 4 chunks or fewer (L 10 or 56 over S 96), 6
// warps would leave that side's phase with warps idle instead.
inline int tw_threads(int L, int S) {
  const int nq = (L + 15) / 16, nk = (S + 15) / 16;
  return (nq == 5 || nq == 6) && (nk == 5 || nk == 6) ? 192 : 128;
}

// bf16 q, do (L rounded up to 16 rows), k, v (S rounded up) of stride
// kTcLd, the mask, three fp32 statistics of each query row and, with the
// dropout, each row's keep bits (4 words: 128 keys)
__host__ __device__ constexpr size_t tw_smem(int Lp, int Sp, bool drop) {
  return (size_t)2 * (Lp + Sp) * kTcLd * 2 + (size_t)(Sp + 3 * Lp) * 4 +
         (drop ? (size_t)Lp * 16 : 0);
}

// rows 0 .. R of one head of x (N rows of stride ``inner`` elements) into
// dst [R][kTcLd], zeros past N: 16-byte cp.async copies, not committed
__device__ __forceinline__ void tw_load_rows(bf16* dst,
                                             const bf16* __restrict__ x,
                                             int R, int N, int inner) {
  for (int i = threadIdx.x; i < R * (kTcD / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r < N;
    cp_async_16(dst + r * kTcLd + c, ok ? x + (size_t)r * inner + c : x,
                ok ? 16 : 0);
  }
}

// Phase 2 of the kernels past one tile: the warps take the 16-key chunks
// in turn; element (r, c) of n8 tile j is key k0 + g + 8 r, query 16 jj +
// 8 j + 2 t + c. For each 16-query step a warp recomputes s^T = k q^T and
// dp^T = v do^T, forms p, p_drop and ds from the row statistics (max Rm,
// 1 / sum Ri, rowsum(dp p) Rt; with the dropout, the keep bit of query i
// and key j is bit j % 32 of Kb[i kw + j / 32]), and sums dv = p_drop^T do
// and dk = ds^T q with p_drop^T and ds^T as A fragments, the query steps
// in order. Needs every row's statistics in shared memory (a barrier).
template <bool BIAS, bool DROP>
__device__ __forceinline__ void tw_key_phase(
    const bf16* Qs, const bf16* Gs, const bf16* Ks, const bf16* Vs,
    const float* Ms, const float* Rm, const float* Ri, const float* Rt,
    const uint32_t* Kb, int kw, const float* __restrict__ bh,
    bf16* __restrict__ dk, bf16* __restrict__ dv, size_t koff, int inner,
    int L, int S, int nq, int nk, int first, int nw, int causal,
    float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int past = S - L;  // the causal offset
  for (int kc2 = first; kc2 < nk; kc2 += nw) {
    const int k0 = kc2 * 16;
    const int kj[2] = {k0 + g, k0 + g + 8};
    const float mk[2] = {Ms[kj[0]], Ms[kj[1]]};
    float av[8][4], ak[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[i][e] = ak[i][e] = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < nq; ++jj) {
      float st[2][4], dt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = jj * 16 + 8 * j + 2 * t + (e & 1);
          const int kr = kj[e >> 1];
          st[j][e] = BIAS && qi < L && kr < S ? bh[(size_t)qi * S + kr] : 0.f;
          dt[j][e] = 0.f;
        }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ka[4], va[4], bq[4], bg[4];
        tc_frag_a(ka, Ks, k0, kc, lane);
        tc_frag_bt(bq, Qs, jj * 16, kc, lane);
        mma_bf16(st[0], ka, bq[0], bq[1]);
        mma_bf16(st[1], ka, bq[2], bq[3]);
        tc_frag_a(va, Vs, k0, kc, lane);
        tc_frag_bt(bg, Gs, jj * 16, kc, lane);
        mma_bf16(dt[0], va, bg[0], bg[1]);
        mma_bf16(dt[1], va, bg[2], bg[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = jj * 16 + 8 * j + 2 * t + c;
          const float m = Rm[qi], inv = Ri[qi], ts = Rt[qi];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool in = qi < L && kj[r] < S;
            const bool hid = causal && kj[r] > qi + past;
            const float a = hid ? -1e9f : st[j][2 * r + c] + mk[r];
            const float p = in ? ex2(fmaf(a, kLog2e, -m * kLog2e)) * inv : 0.f;
            float dd = dt[j][2 * r + c], pd = p;
            if (DROP) {
              const bool kept =
                  (Kb[qi * kw + (kj[r] >> 5)] >> (kj[r] & 31)) & 1u;
              dd = kept ? dd * scale : 0.f;
              pd = kept ? p * scale : 0.f;
            }
            st[j][2 * r + c] = pd;
            dt[j][2 * r + c] = hid ? 0.f : p * (dd - ts);
          }
        }
      uint32_t pa[4], sa[4];
      mma_a_from_c(pa, st[0], st[1]);
      mma_a_from_c(sa, dt[0], dt[1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t bg[4], bq[4];
        tc_frag_b(bg, Gs, jj * 16, 2 * dd, lane);
        tc_frag_b(bq, Qs, jj * 16, 2 * dd, lane);
        mma_bf16(av[2 * dd], pa, bg[0], bg[1]);
        mma_bf16(av[2 * dd + 1], pa, bg[2], bg[3]);
        mma_bf16(ak[2 * dd], sa, bq[0], bq[1]);
        mma_bf16(ak[2 * dd + 1], sa, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kj[r] >= S) continue;
      const size_t row = koff + (size_t)kj[r] * inner;
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
}

// One block per (head, batch), shared memory sized to the site, 4 or 6
// warps (tw_threads). Phase 1, the warps take the query chunks (16 rows
// each) in turn: s = q k^T over the whole row (up to 128 keys, 64 fp32
// registers) and the softmax in registers; then two sweeps of 16 keys
// recompute dp = do v^T a chunk at a time (dp is never held whole): the
// first forms rowsum(dp p) (and the dropout's keep bits, one register a
// row), the second ds = p (dp - rowsum), the dbias partial and dq = ds k
// with ds as the A fragment. Each row's max, 1 / sum, rowsum(dp p) and
// keep bits go to shared memory. Phase 2, after one barrier, the warps
// take the key chunks in turn: for each 16-query step a warp recomputes
// s^T = k q^T and dp^T = v do^T, forms p and ds from the row statistics
// (FlashAttention-2's split: no (L, S) tile is stored), and sums dv =
// p_drop^T do and dk = ds^T q with p_drop^T and ds^T as A fragments, the
// query steps in order.
template <bool BIAS, bool DROP>
__global__ void __launch_bounds__(kTwMaxThreads, 2)
attention_bwd_tc_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ mask,
                      const float* __restrict__ bias,
                      const int* __restrict__ seed_p,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      float* __restrict__ dbias_part, int L, int S, int H,
                      int mask_batched, int causal, uint32_t thr,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = (L + 15) >> 4, nk = (S + 15) >> 4;
  const int Lp = nq * 16, Sp = max(nk, kTwMinChunks) * 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + Lp * kTcLd;  // dO
  bf16* Ks = Gs + Lp * kTcLd;
  bf16* Vs = Ks + Sp * kTcLd;
  float* Ms = reinterpret_cast<float*>(Vs + Sp * kTcLd);  // [Sp]
  float* Rm = Ms + Sp;  // [Lp] row max
  float* Ri = Rm + Lp;  // [Lp] 1 / row sum, 0 past L
  float* Rt = Ri + Lp;  // [Lp] rowsum(dp p), 0 past L
  uint32_t* Kb = reinterpret_cast<uint32_t*>(Rt + Lp);  // [Lp][4], DROP

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * kTcD;
  const size_t koff = (size_t)b * S * inner + (size_t)h * kTcD;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const float* bh = BIAS ? bias + (size_t)h * L * S : nullptr;
  const int past = S - L;  // the causal offset

  tw_load_rows(Qs, q + qoff, Lp, L, inner);
  tw_load_rows(Gs, dout + qoff, Lp, L, inner);
  tw_load_rows(Ks, k + koff, Sp, S, inner);
  tw_load_rows(Vs, v + koff, Sp, S, inner);
  cp_async_commit();
  for (int i = threadIdx.x; i < Sp; i += blockDim.x)
    Ms[i] = i < S ? mb[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const uint32_t hseed = DROP ? head_seed((uint32_t)seed_p[0], h) : 0u;
  // chunk c goes to warp (c + rot) % 4: warp w of every block runs on the
  // SM's sub-partition w, so the blocks on an SM rotate which of them takes
  // the extra chunks when the chunks do not divide by 4
  const int nw = blockDim.x >> 5;
  const int first = (warp + nw - (int)((blockIdx.x + blockIdx.y) % nw)) % nw;

  // ---- phase 1: query rows; element (r, c) of n8 tile nt is query r0 + g
  // + 8 r, key 8 nt + 2 t + c
  for (int qc = first; qc < nq; qc += nw) {
    const int r0 = qc * 16;
    // the bias is the sums' starting value: no registers of its own
    float s[kTwNt][4];
#pragma unroll
    for (int nt = 0; nt < kTwNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + g + 8 * (e >> 1), kj = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = BIAS && qi < L && kj < S ? bh[(size_t)qi * S + kj] : 0.f;
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t qa[4];
      tc_frag_a(qa, Qs, r0, kc, lane);
#pragma unroll
      for (int np = 0; np < kTwNt / 2; ++np) {
        if (np >= kTwMinChunks && np >= nk) break;
        uint32_t bk[4];
        tc_frag_bt(bk, Ks, np * 16, kc, lane);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }
    uint32_t irow[2], keep[2] = {0u, 0u};
    float tsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      irow[r] = ((uint32_t)b * (uint32_t)L + (uint32_t)qi) * (uint32_t)S;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTwNt; ++nt) {
        if (nt >= 2 * kTwMinChunks && nt >= 2 * nk) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = nt * 8 + 2 * t + c;
          float a = -INFINITY;
          if (kj < S) {
            a = s[nt][2 * r + c] + Ms[kj];
            if (causal && kj > qi + past) a = -1e9f;
          }
          s[nt][2 * r + c] = a;
          m = fmaxf(m, a);
        }
      }
      m = quad_max(m);
      float z = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTwNt; ++nt) {
        if (nt >= 2 * kTwMinChunks && nt >= 2 * nk) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(fmaf(s[nt][2 * r + c], kLog2e, -m * kLog2e));
          s[nt][2 * r + c] = e;
          z += e;
        }
      }
      z = quad_sum(z);  // every lane: a row past L too
      const float inv = qi < L ? 1.f / z : 0.f;
#pragma unroll
      for (int nt = 0; nt < kTwNt; ++nt) {
        if (nt >= 2 * kTwMinChunks && nt >= 2 * nk) break;
        s[nt][0 + 2 * r] *= inv;
        s[nt][1 + 2 * r] *= inv;
      }
      if (t == 0) {
        Rm[qi] = m;
        Ri[qi] = inv;
      }
      tsum[r] = 0.f;
    }
    // sweep 1: rowsum(dp p), dp through the dropout (keep bit 2 nt + c of
    // row r kept for sweep 2)
#pragma unroll
    for (int kk = 0; kk < kTwNt / 2; ++kk) {
      if (kk >= kTwMinChunks && kk >= nk) break;
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ga[4], bv[4];
        tc_frag_a(ga, Gs, r0, kc, lane);
        tc_frag_bt(bv, Vs, kk * 16, kc, lane);
        mma_bf16(d[0], ga, bv[0], bv[1]);
        mma_bf16(d[1], ga, bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int nt = 2 * kk + j;
            float dd = d[j][2 * r + c];
            if (DROP) {
              const uint32_t kj = (uint32_t)(nt * 8 + 2 * t + c);
              const bool kept = hash_bits(irow[r] + kj, hseed) >= thr;
              keep[r] |= (uint32_t)kept << (2 * nt + c);
              dd = kept ? dd * scale : 0.f;
            }
            tsum[r] = fmaf(dd, s[nt][2 * r + c], tsum[r]);
          }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] = quad_sum(tsum[r]);
      const int qi = r0 + g + 8 * r;
      if (t == 0) Rt[qi] = qi < L ? tsum[r] : 0.f;
      if (DROP) {
        // the row's keep bits for phase 2: byte w of keep[r] holds keys 32
        // w + 8 (i / 2) + 2 t + i % 2, i = 0 .. 7; the quad ORs its bytes
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            word |= ((keep[r] >> (8 * w + i)) & 1u)
                    << (8 * (i >> 1) + 2 * t + (i & 1));
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
          if (t == w) Kb[qi * 4 + w] = word;
        }
      }
    }
    // sweep 2: ds = p (dp - rowsum) (0 past L), its dbias partial, and
    // dq = ds k
    float aq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTwNt / 2; ++kk) {
      if (kk >= kTwMinChunks && kk >= nk) break;
      float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ga[4], bv[4];
        tc_frag_a(ga, Gs, r0, kc, lane);
        tc_frag_bt(bv, Vs, kk * 16, kc, lane);
        mma_bf16(d[0], ga, bv[0], bv[1]);
        mma_bf16(d[1], ga, bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = r0 + g + 8 * r;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int nt = 2 * kk + j;
            float dd = d[j][2 * r + c];
            if (DROP) dd = (keep[r] >> (2 * nt + c)) & 1u ? dd * scale : 0.f;
            // a causally hidden logit is the constant -1e9: no gradient
            // (it matters only in a row that sees no key)
            const bool live = qi < L && !(causal && nt * 8 + 2 * t + c >
                                                        qi + past);
            d[j][2 * r + c] = live ? s[nt][2 * r + c] * (dd - tsum[r]) : 0.f;
          }
          const int kj = (2 * kk + j) * 8 + 2 * t;
          if (dbias_part != nullptr && qi < L) {
            float* dst = dbias_part + (((size_t)b * H + h) * L + qi) * S + kj;
            if (kj < S) dst[0] = d[j][2 * r];
            if (kj + 1 < S) dst[1] = d[j][2 * r + 1];
          }
        }
      uint32_t sa[4];
      mma_a_from_c(sa, d[0], d[1]);
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
  __syncthreads();  // every row's statistics are in shared memory

  tw_key_phase<BIAS, DROP>(Qs, Gs, Ks, Vs, Ms, Rm, Ri, Rt, Kb, 4, bh, dk, dv,
                           koff, inner, L, S, nq, nk, first, nw, causal,
                           scale);
}

// ---------------------------------------------------------------------------
// The tensor-core route past 128 rows (bf16, Dh 64, L, S <= 256, L or S >
// 128; header).

constexpr int kT2Rows = 256;  // the largest L and S
constexpr int kT2Warps = 12;  // warps an SM (the wide kernel's 12)
constexpr int kT2AloneWarps = 16;  // a block alone on its SM: up to 16
constexpr int kSmemPerSm = 233472;  // 228 KB of shared memory an SM
constexpr int kSmemPerBlock = 1024;  // what the card reserves a block

// bf16 q, do (L rounded up to 16 rows), k, v (S rounded up) of stride
// kTcLd, the mask, three fp32 statistics of each query row and, with the
// dropout, each row's keep bits (a 32-bit word per 32 keys)
__host__ __device__ constexpr size_t t2_smem(int Lp, int Sp, bool drop) {
  return (size_t)2 * (Lp + Sp) * kTcLd * 2 + (size_t)(Sp + 3 * Lp) * 4 +
         (drop ? (size_t)Lp * ((Sp + 31) / 32) * 4 : 0);
}

// The warps of a block, one a chunk of the side with more chunks at most:
// 12 warps an SM, as many blocks as the shared memory holds (3 at most:
// the cross sites) with 12 / blocks warps each; a block alone on its SM
// (L = S past ~190) with more than 12 chunks takes up to 16, so that each
// phase runs in one round (the kernel's 128-register instance).
inline int t2_warps(size_t smem, int nq, int nk) {
  const int blocks = min(3, (int)(kSmemPerSm / (smem + kSmemPerBlock)));
  const int chunks = max(nq, nk);
  if (blocks <= 1 && chunks > kT2Warps) return min(kT2AloneWarps, chunks);
  return min(kT2Warps / max(blocks, 1), chunks);
}

// s (started from the bias) = q k^T and dp = do v^T of query rows r0 ..
// r0 + 16 and keys k0 .. k0 + 16, from the rows' A fragments qa, ga:
// element (r, c) of n8 tile j is query r0 + g + 8 r, key k0 + 8 j + 2 t + c
template <bool BIAS>
__device__ __forceinline__ void t2_tile(float (&s)[2][4], float (&d)[2][4],
                                        const uint32_t (&qa)[4][4],
                                        const uint32_t (&ga)[4][4],
                                        const bf16* Ks, const bf16* Vs,
                                        const float* __restrict__ bh, int r0,
                                        int k0, int L, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = r0 + g + 8 * (e >> 1), kj = k0 + 8 * j + 2 * t + (e & 1);
      s[j][e] = BIAS && qi < L && kj < S ? bh[(size_t)qi * S + kj] : 0.f;
      d[j][e] = 0.f;
    }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t bk[4], bv[4];
    tc_frag_bt(bk, Ks, k0, kc, lane);
    mma_bf16(s[0], qa[kc], bk[0], bk[1]);
    mma_bf16(s[1], qa[kc], bk[2], bk[3]);
    tc_frag_bt(bv, Vs, k0, kc, lane);
    mma_bf16(d[0], ga[kc], bv[0], bv[1]);
    mma_bf16(d[1], ga[kc], bv[2], bv[3]);
  }
}

// One block per (head, batch), shared memory sized to the site, 4 to 16
// warps (t2_warps; W, the most, sets the launch bounds). Phase 1, the
// warps take the query chunks (16 rows each) in turn, a row never held
// whole: sweep 1 goes over the 16-key chunks computing s and dp, keeping
// each row's running max, its sum of exp(s - max) and its sum of dp
// exp(s - max) (both rescaled where the max grows: an online softmax),
// hashing the dropout's keep bits once into shared memory; sweep 2
// recomputes s and dp chunk by chunk for p, ds = p (dp - rowsum(dp p)),
// the dbias partial and dq = ds k (ds as the A fragment). Phase 2 is the
// wide kernel's (tw_key_phase).
template <bool BIAS, bool DROP, int W>
__global__ void __launch_bounds__(32 * W, 1)
attention_bwd_tc_256(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed_p,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dbias_part, int L, int S, int H,
                     int mask_batched, int causal, uint32_t thr,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = (L + 15) >> 4, nk = (S + 15) >> 4;
  const int Lp = nq * 16, Sp = nk * 16, kw = (Sp + 31) / 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + Lp * kTcLd;  // dO
  bf16* Ks = Gs + Lp * kTcLd;
  bf16* Vs = Ks + Sp * kTcLd;
  float* Ms = reinterpret_cast<float*>(Vs + Sp * kTcLd);  // [Sp]
  float* Rm = Ms + Sp;  // [Lp] row max
  float* Ri = Rm + Lp;  // [Lp] 1 / row sum, 0 past L
  float* Rt = Ri + Lp;  // [Lp] rowsum(dp p), 0 past L
  uint32_t* Kb = reinterpret_cast<uint32_t*>(Rt + Lp);  // [Lp][kw], DROP
  // the keep bits of query i, keys 16 c .. 16 c + 16: Kh[i 2 kw + c]
  uint16_t* Kh = reinterpret_cast<uint16_t*>(Kb);

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)b * L * inner + (size_t)h * kTcD;
  const size_t koff = (size_t)b * S * inner + (size_t)h * kTcD;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const float* bh = BIAS ? bias + (size_t)h * L * S : nullptr;
  const int past = S - L;  // the causal offset

  tw_load_rows(Qs, q + qoff, Lp, L, inner);
  tw_load_rows(Gs, dout + qoff, Lp, L, inner);
  tw_load_rows(Ks, k + koff, Sp, S, inner);
  tw_load_rows(Vs, v + koff, Sp, S, inner);
  cp_async_commit();
  for (int i = threadIdx.x; i < Sp; i += blockDim.x)
    Ms[i] = i < S ? mb[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const uint32_t hseed = DROP ? head_seed((uint32_t)seed_p[0], h) : 0u;
  // chunk c goes to warp (c + rot) % nw, as in the wide kernel
  const int nw = blockDim.x >> 5;
  const int first = (warp + nw - (int)((blockIdx.x + blockIdx.y) % nw)) % nw;

  // ---- phase 1: query rows
  for (int qc = first; qc < nq; qc += nw) {
    const int r0 = qc * 16;
    uint32_t qa[4][4], ga[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      tc_frag_a(qa[kc], Qs, r0, kc, lane);
      tc_frag_a(ga[kc], Gs, r0, kc, lane);
    }
    const int qi[2] = {r0 + g, r0 + g + 8};
    uint32_t irow[2];
    // per lane (its 4 keys of a chunk): running max, sum of 2^((a - m)
    // log2 e) and of dp times it; -1e30, not -inf, so that a rescale of
    // two empty maxima is 2^0
    float m[2] = {-1e30f, -1e30f}, z[2] = {0.f, 0.f}, tt[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
      irow[r] = ((uint32_t)b * (uint32_t)L + (uint32_t)qi[r]) * (uint32_t)S;
    // sweep 1: the row statistics, online
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      const int k0 = kk * 16;
      float s[2][4], d[2][4];
      t2_tile<BIAS>(s, d, qa, ga, Ks, Vs, bh, r0, k0, L, S, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kj = k0 + 8 * j + 2 * t + c;
            float a = -INFINITY;
            if (kj < S) {
              a = s[j][2 * r + c] + Ms[kj];
              if (causal && kj > qi[r] + past) a = -1e9f;
            }
            s[j][2 * r + c] = a;
            cm = fmaxf(cm, a);
          }
        const float mn = fmaxf(m[r], cm);
        const float sc = ex2((m[r] - mn) * kLog2e);
        z[r] *= sc;
        tt[r] *= sc;
        m[r] = mn;
        uint32_t bits = 0u;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float e = ex2(fmaf(s[j][2 * r + c], kLog2e, -mn * kLog2e));
            float dd = d[j][2 * r + c];
            if (DROP) {
              const uint32_t kj = (uint32_t)(k0 + 8 * j + 2 * t + c);
              const bool kept = hash_bits(irow[r] + kj, hseed) >= thr;
              bits |= (uint32_t)kept << (8 * j + 2 * t + c);
              dd = kept ? dd * scale : 0.f;
            }
            z[r] += e;
            tt[r] = fmaf(dd, e, tt[r]);
          }
        if (DROP) {  // the quad's 16 bits of the row
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          if (t == 0) Kh[qi[r] * 2 * kw + kk] = (uint16_t)bits;
        }
      }
    }
    // the quad's partial statistics to the row's: max, 1 / sum, rowsum(dp
    // p) = sum(dp e) / sum(e), both 0 past L
    float inv[2], ts[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mr = quad_max(m[r]);
      const float sc = ex2((m[r] - mr) * kLog2e);
      const float zr = quad_sum(z[r] * sc), tr = quad_sum(tt[r] * sc);
      inv[r] = qi[r] < L ? 1.f / zr : 0.f;
      ts[r] = tr * inv[r];
      m[r] = mr;
      if (t == 0) {
        Rm[qi[r]] = mr;
        Ri[qi[r]] = inv[r];
        Rt[qi[r]] = ts[r];
      }
    }
    if (DROP) __syncwarp();  // the quads' keep bits, read in sweep 2
    // sweep 2: ds = p (dp - rowsum) (0 past L), its dbias partial, and
    // dq = ds k
    float aq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[i][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      const int k0 = kk * 16;
      float s[2][4], d[2][4];
      t2_tile<BIAS>(s, d, qa, ga, Ks, Vs, bh, r0, k0, L, S, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t kept = DROP ? Kh[qi[r] * 2 * kw + kk] : 0u;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kj = k0 + 8 * j + 2 * t + c;
            // a causally hidden logit is the constant -1e9: no gradient
            // (it matters only in a row that sees no key)
            const bool hid = causal && kj > qi[r] + past;
            float a = -INFINITY;
            if (kj < S) a = hid ? -1e9f : s[j][2 * r + c] + Ms[kj];
            const float p = ex2(fmaf(a, kLog2e, -m[r] * kLog2e)) * inv[r];
            float dd = d[j][2 * r + c];
            if (DROP) dd = (kept >> (8 * j + 2 * t + c)) & 1u ? dd * scale
                                                              : 0.f;
            d[j][2 * r + c] = hid ? 0.f : p * (dd - ts[r]);
          }
        if (dbias_part != nullptr && qi[r] < L) {
          float* dst =
              dbias_part + (((size_t)b * H + h) * L + qi[r]) * S + k0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kj = k0 + 8 * j + 2 * t;
            if (kj < S) dst[8 * j] = d[j][2 * r];
            if (kj + 1 < S) dst[8 * j + 1] = d[j][2 * r + 1];
          }
        }
      }
      uint32_t sa[4];
      mma_a_from_c(sa, d[0], d[1]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t bk[4];
        tc_frag_b(bk, Ks, k0, 2 * dd, lane);
        mma_bf16(aq[2 * dd], sa, bk[0], bk[1]);
        mma_bf16(aq[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= L) continue;
      bf16* dst = dq + qoff + (size_t)qi[r] * inner;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(aq[dt][2 * r], aq[dt][2 * r + 1]);
    }
  }
  __syncthreads();  // every row's statistics are in shared memory

  // ---- phase 2: keys
  tw_key_phase<BIAS, DROP>(Qs, Gs, Ks, Vs, Ms, Rm, Ri, Rt, Kb, kw, bh, dk,
                           dv, koff, inner, L, S, nq, nk, first, nw, causal,
                           scale);
}

// attention_bwd_tc where L and S fit one 64-row tile, the wide one up to
// 128 rows, else attention_bwd_tc_256; the three take the same arguments
template <bool BIAS, bool DROP>
int launch_tc_terms(const void* q, const void* k, const void* v,
                    const void* mask, const void* bias, const void* seed,
                    const void* dout, void* dq, void* dk, void* dv,
                    void* dbias_part, int B, int L, int S, int H,
                    int mask_batched, int causal, uint32_t thr, float scale,
                    cudaStream_t st) {
  const int nq = (L + 15) / 16, nk = (S + 15) / 16;
  const bool wide = L > kTcRows || S > kTcRows;
  const bool big = L > kTwRows || S > kTwRows;
  const size_t smem =
      big ? t2_smem(nq * 16, nk * 16, DROP)
          : wide ? tw_smem(nq * 16, max(nk, kTwMinChunks) * 16, DROP)
                 : tc_smem(BIAS);
  const int t2w = big ? t2_warps(smem, nq, nk) : 0;
  decltype(&attention_bwd_tc<BIAS, DROP>) kernel =
      big ? (t2w > kT2Warps ? &attention_bwd_tc_256<BIAS, DROP, kT2AloneWarps>
                            : &attention_bwd_tc_256<BIAS, DROP, kT2Warps>)
          : wide ? &attention_bwd_tc_wide<BIAS, DROP>
                 : &attention_bwd_tc<BIAS, DROP>;
  const int threads =
      big ? 32 * t2w : wide ? tw_threads(L, S) : kTcThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), threads, smem, st>>>(
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
// tensor-core route (bf16, Dh 64, L, S <= 256; ops/attention.py a6_route).
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
      (tc && (!is_bf16 || Dh != kTcD || L > kT2Rows || S > kT2Rows)))
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
