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
// the global index, so either route's tiles give the TPU's bits) and kept
// probabilities are scaled by 1 / (1 - rate). The online softmax divides by
// the row sum only at the end, so the P.V numerator takes the dropped
// terms and the row sum the undropped ones: out = scale * sum_j keep_j
// e_j v_j / sum_j e_j, the dropped normalised probabilities times v. The
// seed is a (1,) int32 device tensor read by pointer.
//
// Two routes, a plain function of (dtype, Dh) that the wrapper picks
// (ops/attention.py forward_route) and passes as ``tc``:
//
// "fma" (fp32, and bf16 at Dh != 64; the FMA design): one block per
// (query tile of 16 rows, head, batch) with K/V tiles of 32 keys staged in
// shared memory as fp32 (K rows padded by one float so the lane-per-key dot
// products hit distinct banks), one warp per 4 query rows, an online
// softmax over the key tiles, fp32 FMA throughout. The fp32 parity phases
// hold the kernels to full fp32 arithmetic (no TF32), so this route stays.
//
// "tc" (bf16, Dh 64: every configuration of the repo), attention_fwd_tc.
// Bound on the H100 at the video encoder site (B 50, H 12, L = S = 604):
// 4 B H L S Dh = 56 GFLOP at the bf16 tensor-core peak, 0.0567 ms, against
// 0.0554 ms for the 186 MB of q, k, v and out: the operations bound it. The
// FMA route runs at about 250x that bound (13.9 ms): scalar FP32 FMA
// with two shared loads per FMA, 32-lane reductions and a shuffle per key.
// This design:
//   - tensor cores: s = q k^T and o += p v on mma.sync m16n8k16 (bf16 in,
//     fp32 sums); one block of 4 warps per (query tile, head, batch): 64
//     rows, 16 a warp, or, for L > 64 without a bias, 128 rows, 32 a warp
//     as two m16 tiles that share every K and V fragment the warp loads
//     (half the shared-memory reads and half the K/V copies a row; 3000
//     blocks at the BART video encoder);
//   - bf16 tiles: K and V tiles of 64 keys in bf16 shared memory (row stride
//     144 bytes: ldmatrix conflict-free), read once per query tile, two
//     stages fed by 16-byte cp.async so tile t + 1 lands while t computes;
//     the bias tile (fp32, 64 x 64) rides the same stages;
//   - the softmax in registers: each thread holds 2 rows of the fragment;
//     the row max and sum reduce over the 4 lanes of a quad (two shuffles),
//     exp is one FFMA + EX2 on logits scaled by log2(e); p goes to bf16 in
//     registers and is the A operand of p v (no shared-memory round trip;
//     the plain twin casts p to the input dtype before v as well);
//   - an interior tile (every key valid, causal visible) skips the range
//     and causal tests; causal tiles past the diagonal are skipped; the
//     bias and the dropout are template flags;
//   - small L (<= 16: decode, decoder sites): one 16-row tile whose 4 warps
//     split each 64-key tile by 16 keys and merge (max, sum, accumulator)
//     through shared memory in warp order: deterministic.
// Resources (nvcc -Xptxas -v, sm_90a, no spills): 128-141 registers a
// thread and 46,592 bytes of shared memory a block (83,456 with the bias):
// 3 blocks an SM; two m16 tiles a warp 252-254 registers and 55,808 bytes:
// 2 blocks an SM; small L 80-96 registers, 39,680 bytes (48,896 with the
// bias).
// Logits, softmax and the accumulation are fp32 on both routes.
//
// Long sequences (the video path, S 604 and 1024): the same kernels serve
// the per-head and query-strip forwards (_pallas_attention_perhead,
// _pallas_attention_ltiled), which compute this function; the key tiles
// bound their shared memory at any S. Given a non-null ``lse`` they also
// write the fp32 row logsumexp (B, H, L) of the masked logits, from which
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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, Dh 64; header).

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kBiasLd = kTcRows + 8;  // fp32 bias tile row stride (288 B)

// shared memory of attention_fwd_tc: Q, two stages of K and V, two of the
// mask and, with a bias, two of the bias tile
__host__ __device__ constexpr size_t tc_fwd_smem(int qrows, bool bias) {
  return (size_t)qrows * kTcLd * 2 + 4 * (size_t)kTcTile * 2 +
         2 * kTcRows * 4 + (bias ? 2 * (size_t)qrows * kBiasLd * 4 : 0);
}

// One block per (query tile, head, batch). SPLIT false: a 64 MT-row query
// tile, warp w owns rows 16 MT w .. 16 MT (w + 1) (MT m16 tiles, which
// share every K and V fragment the warp loads) and walks every key. SPLIT
// true (L <= 16, the decode and decoder sites; MT 1): one 16-row query
// tile for all 4 warps, warp w takes keys 16 w .. 16 w + 16 of every
// 64-key tile, and the four partial (max, sum, accumulator) are merged
// through shared memory in warp order, so the result does not depend on
// scheduling. BIAS and DROP are the bias and the dropout, compiled in or
// out.
template <bool SPLIT, int MT, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ bias,
                 const int* __restrict__ seed_p, bf16* __restrict__ out,
                 float* __restrict__ lse, int L, int S, int H,
                 int mask_batched, int causal, uint32_t thr, float scale) {
  static_assert(!SPLIT || MT == 1, "the split tile is one m16 tile");
  constexpr int QROWS = SPLIT ? 16 : kTcRows * MT;
  constexpr int NK = SPLIT ? 2 : 8;  // n8 key tiles of a warp per key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [QROWS][kTcLd]
  bf16* KVs = Qs + QROWS * kTcLd;                      // [stage][K, V]
  float* Ms = reinterpret_cast<float*>(KVs + 4 * kTcTile);  // [stage][64]
  float* Bs = Ms + 2 * kTcRows;  // [stage][QROWS][kBiasLd], with a bias

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int inner = H * kTcD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)b * L * inner + (size_t)h * kTcD;
  const bf16* kb = k + (size_t)b * S * inner + (size_t)h * kTcD;
  const bf16* vb = v + (size_t)b * S * inner + (size_t)h * kTcD;
  const float* mb = mask + (mask_batched ? (size_t)b * S : 0);
  const float* hb = BIAS ? bias + (size_t)h * L * S : nullptr;
  const uint32_t hseed = DROP ? head_seed((uint32_t)seed_p[0], h) : 0u;
  const int wr = SPLIT ? 0 : warp * 16 * MT;  // the warp's first row
  const int wk = SPLIT ? warp * 16 : 0;       // its first key of a key tile
  // causal: the tile's last row sees keys up to its index + (S - L); the
  // key tiles past that are skipped (their p is exp(-1e9 - m) = 0)
  const int last = min(q0 + QROWS, L) - 1;
  const int kend = causal && S >= L ? min(S, last + (S - L) + 1) : S;
  const int ntiles = (kend + kTcRows - 1) / kTcRows;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * kTcRows;
    tc_load_tile(KVs + (2 * st) * kTcTile, kb, k0, S, inner, kTcThreads);
    tc_load_tile(KVs + (2 * st + 1) * kTcTile, vb, k0, S, inner, kTcThreads);
    if (BIAS)
      tc_load_bias(Bs + st * QROWS * kBiasLd, kBiasLd, hb, q0, QROWS, L, k0,
                   S, kTcThreads);
    if (threadIdx.x < kTcRows) {
      const int c = k0 + threadIdx.x;
      Ms[st * kTcRows + threadIdx.x] = c < S ? mb[c] : 0.f;
    }
  };

  for (int i = threadIdx.x; i < QROWS * (kTcD / 8); i += kTcThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = q0 + r < L;
    cp_async_16(Qs + r * kTcLd + c, ok ? qb + (size_t)(q0 + r) * inner + c : qb,
                ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  // per m16 tile mt: the Q fragments, the output accumulator, and the
  // running max and sum of the thread's two rows
  uint32_t qf[MT][4][4];
  float o[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][i][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {  // the next tile's copies fly during this one
      load_kv(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          tc_frag_a(qf[mt][kc], Qs, wr + 16 * mt, kc, lane);
    }
    const bf16* Ks = KVs + (2 * st) * kTcTile;
    const bf16* Vs = KVs + (2 * st + 1) * kTcTile;
    const float* Mt = Ms + st * kTcRows;
    const float* Bt = Bs + st * QROWS * kBiasLd;
    const int k0 = it * kTcRows;

    // s = q . k^T: k-steps over Dh in order, from zero (the long
    // backward's dq kernel repeats exactly this)
    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bk[4];
        tc_frag_bt(bk, Ks, wk + np * 16, kc, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kc], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kc], bk[2], bk[3]);
        }
      }

    // the logits of the global (row, col): + mask [+ bias] [causal -1e9],
    // -inf past S, and the row max. An interior tile (every key valid and,
    // causal, visible to the tile's first row) needs neither test.
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mx[mt][0] = m[mt][0];
      mx[mt][1] = m[mt][1];
    }
    auto logits = [&](auto full_t) {
      constexpr bool FULL = decltype(full_t)::value;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rl = wr + 16 * mt + g + r * 8;
            const int cl = wk + nt * 8 + 2 * t;
            const float2 mk = *reinterpret_cast<const float2*>(Mt + cl);
            float2 bv = make_float2(0.f, 0.f);
            if (BIAS)
              bv = *reinterpret_cast<const float2*>(Bt + rl * kBiasLd + cl);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = s[mt][nt][2 * r + c] + (c ? mk.y : mk.x);
              if (BIAS) x += c ? bv.y : bv.x;
              if (!FULL) {
                const int col = k0 + cl + c;
                if (causal && col > q0 + rl + (S - L)) x = -1e9f;
                if (col >= S) x = -INFINITY;
              }
              s[mt][nt][2 * r + c] = x;
              mx[mt][r] = fmaxf(mx[mt][r], x);
            }
          }
    };
    if (k0 + kTcRows <= S && (!causal || k0 + kTcRows - 1 <= q0 + (S - L)))
      logits(std::true_type());
    else
      logits(std::false_type());

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mref2[2];  // the running max, times log2(e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = quad_max(mx[mt][r]);
        const float mref = mn == -INFINITY ? 0.f : mn;  // no valid key yet
        const float corr = ex2((m[mt][r] - mref) * kLog2e);
        mref2[r] = mref * kLog2e;
        m[mt][r] = mn;
        l[mt][r] *= corr;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          o[mt][dt][2 * r] *= corr;
          o[mt][dt][2 * r + 1] *= corr;
        }
      }
      // p = exp(s - m): the row sum takes it undropped, the numerator
      // dropped (keep bit of the global index)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][nt][e], kLog2e, -mref2[e >> 1]));
          l[mt][e >> 1] += p;
          float pv = p;
          if (DROP) {
            const uint32_t row =
                (uint32_t)(q0 + wr + 16 * mt + g + (e >> 1) * 8);
            const uint32_t col =
                (uint32_t)(k0 + wk + nt * 8 + 2 * t + (e & 1));
            const uint32_t idx =
                ((uint32_t)b * (uint32_t)L + row) * (uint32_t)S + col;
            if (hash_bits(idx, hseed) < thr) pv = 0.f;
          }
          s[mt][nt][e] = pv;
        }
    }
    // o += p . v, p straight from the registers as bf16
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_a_from_c(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bv[4];
        tc_frag_b(bv, Vs, wk + kk * 16, 2 * dp, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) l[mt][r] = quad_sum(l[mt][r]);
  const float num = DROP ? scale : 1.f;  // the kept terms' 1 / (1 - rate)

  if (!SPLIT) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wr + 16 * mt + g + r * 8;
        if (row >= L) continue;
        const float inv = num / l[mt][r];
        bf16* orow = out + ((size_t)b * L + row) * inner + (size_t)h * kTcD;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t) =
              __floats2bfloat162_rn(o[mt][dt][2 * r] * inv,
                                    o[mt][dt][2 * r + 1] * inv);
        if (lse != nullptr && t == 0)
          lse[((size_t)b * H + h) * L + row] = m[mt][r] + logf(l[mt][r]);
      }
    return;
  }

  // SPLIT: the warps' partials into the (now free) tile buffers, then
  // each thread merges 8 columns of one row over the warps in order
  constexpr int kOld = kTcD + 4;
  float* Os = reinterpret_cast<float*>(KVs);  // [4][16][kOld]
  float* Mw = Os + 4 * 16 * kOld;             // [4][16]
  float* Lw = Mw + 4 * 16;                    // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * 16 + g + r * 8;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      Os[rr * kOld + dt * 8 + 2 * t] = o[0][dt][2 * r];
      Os[rr * kOld + dt * 8 + 2 * t + 1] = o[0][dt][2 * r + 1];
    }
    if (t == 0) {
      Mw[rr] = m[0][r];
      Lw[rr] = l[0][r];
    }
  }
  __syncthreads();
  const int rr = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * 8;
  const int row = q0 + rr;
  if (row >= L) return;
  float mrow = -INFINITY;
#pragma unroll
  for (int w = 0; w < 4; ++w) mrow = fmaxf(mrow, Mw[w * 16 + rr]);
  float f[4], lt = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float mw = Mw[w * 16 + rr];
    f[w] = mw == -INFINITY ? 0.f : __expf(mw - mrow);
    lt += Lw[w * 16 + rr] * f[w];
  }
  const float inv = num / lt;
  bf16* orow = out + ((size_t)b * L + row) * inner + (size_t)h * kTcD + c0;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      a0 += Os[(w * 16 + rr) * kOld + c0 + j] * f[w];
      a1 += Os[(w * 16 + rr) * kOld + c0 + j + 1] * f[w];
    }
    *reinterpret_cast<__nv_bfloat162*>(orow + j) =
        __floats2bfloat162_rn(a0 * inv, a1 * inv);
  }
  if (lse != nullptr && c0 == 0)
    lse[((size_t)b * H + h) * L + row] = mrow + logf(lt);
}

typedef void (*FwdTcKernel)(const bf16*, const bf16*, const bf16*,
                            const float*, const float*, const int*, bf16*,
                            float*, int, int, int, int, int, uint32_t, float);

// The instance of a site: SPLIT for L <= 16; two m16 tiles a warp for
// L > 64 without a bias (with one, the 128-row bias stages would leave one
// block an SM); else one.
FwdTcKernel fwd_tc_kernel(int L, bool bias, bool drop, int* qrows) {
  if (L <= 16) {
    *qrows = 16;
    if (bias)
      return drop ? attention_fwd_tc<true, 1, true, true>
                  : attention_fwd_tc<true, 1, true, false>;
    return drop ? attention_fwd_tc<true, 1, false, true>
                : attention_fwd_tc<true, 1, false, false>;
  }
  if (L > kTcRows && !bias) {
    *qrows = 2 * kTcRows;
    return drop ? attention_fwd_tc<false, 2, false, true>
                : attention_fwd_tc<false, 2, false, false>;
  }
  *qrows = kTcRows;
  if (bias)
    return drop ? attention_fwd_tc<false, 1, true, true>
                : attention_fwd_tc<false, 1, true, false>;
  return drop ? attention_fwd_tc<false, 1, false, true>
              : attention_fwd_tc<false, 1, false, false>;
}

}  // namespace

extern "C" int vlpet_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* bias, const void* seed,
                                   void* out, void* lse, int B, int L, int S,
                                   int H, int Dh, int mask_batched,
                                   int causal, int is_bf16, int tc, int drop,
                                   int thr, float scale, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || B < 1 || L < 1 || S < 1 || H < 1 ||
      H > 65535 || B > 65535 || (drop && (seed == nullptr || thr < 0)) ||
      (tc && (!is_bf16 || Dh != kTcD)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
    int qrows = 0;
    const FwdTcKernel kern = fwd_tc_kernel(L, bias != nullptr, drop != 0,
                                           &qrows);
    const size_t smem = tc_fwd_smem(qrows, bias != nullptr);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((L + qrows - 1) / qrows, H, B), kTcThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)mask,
        (const float*)bias, (const int*)seed, (bf16*)out, (float*)lse, L, S,
        H, mask_batched, causal, (uint32_t)thr, scale);
    return (int)cudaGetLastError();
  }
  const dim3 grid((L + kQT - 1) / kQT, H, B);
  const size_t smem = sizeof(float) * ((size_t)kKT * (Dh + 1) +
                                       (size_t)kKT * Dh + (size_t)kQT * Dh);
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
