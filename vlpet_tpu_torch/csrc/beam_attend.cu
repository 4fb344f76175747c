// Reorder-free beam self-attention for one decode step: D1 and D2.
//
// Replaces vlpet_tpu/ops/decode.py:_beam_self_attend_pallas (its body
// _beam_self_kernel; D1) and vlpet_tpu/ops/decode.py:
// beam_decode_attend_update (its body _beam_self_update_kernel; D2, the
// opt-in use_fused_beam). For batch element b, beam k and head h, over the
// cache slots t < P: row = b*J + anc[b, k, t]; s_t = q . K[t, row], plus
// bias[h, t] when T5's relative-bias row (fp32, the same for every beam) is
// given; p = softmax(s), rounded to the compute dtype as the TPU kernels
// round it; out = sum_t p_t V[t, row], summed in fp32. D1 reads t <= pos
// (P = pos + 1: slot pos already holds this step's K/V). D2 reads t < pos
// (P = pos) plus an own-row term under the same softmax -- q . k_new with
// its products rounded to the compute dtype, summed in fp32, plus
// own_bias[h] (T5's distance-0 bias), its probability kept in fp32 as the
// TPU kernel keeps it -- and writes k_new / v_new into slot pos in the
// same launch (J == K; no block reads slot pos). The time-major cache
// (Lc, B*J, H*Dh) is never reordered and no mask tensor exists.
//
// Bound on the H100: bytes. Per (b, h) a step reads the distinct rows its
// K beams reference, one K and one V head slice each (128 B at Dh 64 in
// bf16), and does 4 FLOPs per beam and row element: with the smoke's
// uniform ancestry (3.4 distinct rows for 5 beams) that is 4 * 5 / 3.4 /
// 2 = 3 FLOPs a byte, two orders under the ~295 at which the tensor cores
// would set the pace. wgmma is not used: its A is a 64-row tile of a
// warpgroup, and here the rows are the K <= 16 beams (a 64-row tile would
// be 92 % padding), while its asynchrony buys nothing where bytes set the
// pace. mma.sync is used (route "tc") for its instruction count, not its
// rate: the first version of this kernel did the math with FMAs and was
// bound by its instructions -- the index arithmetic and range checks
// around 3 FLOPs a byte -- not by its bytes (BART B 500, pos 39: 0.166 ms
// against the warp kernels' 0.151 and a bound of 0.065). The design's
// job: read each distinct row once, spend few instructions per byte, and
// keep blocks in flight. At the uniform ancestry it is now bound by the
// rate at which the card serves scattered 512-byte runs (~2 TB/s, my
// measurement: BART pos 39 moves 217 MB in 0.11 ms).
//
// Design, route "tc" (bf16, Dh 64, K <= 16; ops/decode.py beam_route):
// a block per (b, G heads), G = 4 at 12 heads (ops/decode.py tc_heads),
// a warp per head. 6 and 12 heads a block (one run of a row's heads)
// measured slower: fewer blocks in flight.
// 1. The block reads anc[b, :, 0..P) (int32 or int64, as the caller holds
//    it), marks per slot which of the J rows any beam references (a 32-bit
//    mask: J <= 32), numbers these distinct (slot, row) entries slot-major
//    by a prefix sum, and replaces each (beam, slot) by its entry's number:
//    once for its G heads.
// 2. The entries' K head slices, then their V head slices, stream through
//    a ring of kStages tiles of kTcEnt entries x G heads in shared memory
//    by 16-byte cp.async (a thread half a row), so that a tile's copies
//    overlap the math on the tiles before it: each distinct row is read
//    once, the bytes the bound counts. (The PR 1 / PR 6 warp kernels read
//    a row once per beam that referenced it, one dependent round trip per
//    slot.) Rows past the last entry are zero-filled by cp.async, so no
//    stale value meets a zero.
// 3. K tiles: each warp's scores on mma.sync m16n8k16 with the K beams as
//    the 16 rows of A (zeros past K): every entry of the tile is scored,
//    and a score is kept (in shared memory, K x P floats a head) where the
//    entry is the beam's own at its slot. 3.4 entries a slot for 5 beams:
//    the waste is in the tensor cores, which have 300x to spare.
// 4. Between the passes a softmax per (beam, head): max, sum, then p = e /
//    sum rounded to bf16, the TPU kernels' rounding of the normalised
//    probabilities, which an online merge across tiles could not
//    reproduce. D2's own score joins the max and the sum; its probability
//    stays fp32.
// 5. V tiles: P.V on mma.sync with A = p laid out per entry (zero where
//    an entry is not the beam's), 64 columns a warp, fp32 sums in
//    registers. No atomics: the output is deterministic.
// D2 copies its k_new / v_new rows into shared memory with the queries
// (the first copy group), and takes the own score, the own term and the
// slot write (after the output) from there: three dependent round trips
// fewer, 0.143 -> 0.118 ms at BART pos 39 (my measurement).
// Route "fma" (fp32 -- no tensor-core product keeps fp32; TF32 would round
// it -- and bf16 at another Dh): a block of kThreads per (b, h), the same
// entries and ring (tiles of _TILE_BYTES), scores by 8 lanes a dot product
// over 16-byte vectors (3 shuffles), P.V by a thread per (slot split,
// beam, 16-byte column) with fp32 sums parked in shared memory between
// tiles and the splits summed in order at the end.
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kThreads = 128;     // "fma": threads a block
constexpr int kStages = 3;        // tiles in flight (ops/decode.py _STAGES)
constexpr int kMaxDh = 128;
constexpr int kMaxJ = 32;         // a slot's rows are one 32-bit mask
constexpr int kTcMaxHeads = 4;    // "tc": heads a block, a warp each
constexpr int kTcMaxK = 16;       // "tc": the beams are the rows of an m16
constexpr int kTcEnt = 16;        // "tc": entries a tile (one k16 step)
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// "fma" P.V's slot splits: threads per (beam, 16-byte column) while they
// last
__host__ __device__ __forceinline__ int splits_of(int K, int vecs) {
  return K * vecs >= kThreads ? 1 : kThreads / (K * vecs);
}

// Byte offsets of the block's shared-memory regions, in order;
// ops/decode.py beam_plan computes the same total. "tc" holds G heads (G =
// 1 on "fma"): a tile is kTcEnt entries of each, its rows padded to kTcLd
// (ldmatrix's 8 rows on distinct banks), 16 query rows a head (zeros past
// K), and keeps its P.V sums in registers.
struct Layout {
  int ring, q, acc, sc, ja, msk, off, ent, own, nkv, total;
};

__host__ __device__ __forceinline__ Layout layout_of(int K, int J, int P,
                                                    int Dh, int esize,
                                                    int rows, bool tc,
                                                    int G, bool update) {
  const int ld = tc ? kTcLd : Dh;
  Layout L;
  int o = 0;
  L.ring = o;
  o += align16(kStages * rows * G * ld * esize);  // K or V head slices
  L.q = o;
  o += align16(G * (tc ? kTcMaxK : K) * ld * esize);  // the queries
  L.acc = o;
  o += tc ? 0 : align16(splits_of(K, Dh * esize / 16) * K * Dh * 4);
  L.sc = o;
  o += align16(G * K * P * 4);  // scores, then probabilities
  L.ja = o;
  o += align16(K * P * 4);  // ancestry, then entry numbers
  L.msk = o;
  o += align16(P * 4);  // rows referenced per slot
  L.off = o;
  o += align16((P + 1) * 4);  // first entry per slot, then the count
  L.ent = o;
  o += align16(P * (K < J ? K : J) * 4);  // entry -> (slot << 5) | row
  L.own = o;
  o += align16(G * K * 4);  // D2: the own row's probabilities
  L.nkv = o;
  o += update ? align16(2 * K * G * Dh * esize) : 0;  // D2: k_new, v_new
  L.total = o;
  return L;
}

struct Args {
  const void* q;       // (B*K, H*Dh)
  void* kc;            // (Lc, B*J, H*Dh), slot pos written by D2
  void* vc;
  const void* kn;      // D2: (B*K, H*Dh)
  const void* vn;
  const void* anc;     // (B, K, Lc) int32 or int64
  const float* bias;   // bias[h * bias_sh + t * bias_st], or NULL
  const float* obias;  // D2: obias[h * obias_s], or NULL
  void* out;           // (B*K, H*Dh)
  int B, K, J, Lc, H, Dh, pos, P, anc64, bias_sh, bias_st, obias_s, rows;
  int G;  // heads a block ("tc"; 1 on "fma")
};

template <typename T>
struct Vec;  // 16 bytes of T as fp32

template <>
struct Vec<bf16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(float (&x)[8], const bf16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&x)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(float (&x)[4], const float* p) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

// The block's ancestry anc[b, :, 0..P) -> entries: msk[t] the rows any
// beam references at slot t, off[t] the first entry of slot t (off[P] the
// count E), ent[e] = (slot << 5) | row, slot-major; ja[k * P + t] the
// entry of beam k at slot t. Every thread takes part (it synchronises).
__device__ __forceinline__ void build_entries(const Args& a, int b, int* ja,
                                              unsigned* msk, int* off,
                                              int* ent) {
  const int K = a.K, P = a.P, tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < K * P; i += nthr) {
    const int k = i / P, t = i - k * P;
    const size_t g = (size_t)(b * K + k) * a.Lc + t;
    ja[i] = a.anc64 ? (int)reinterpret_cast<const long long*>(a.anc)[g]
                    : reinterpret_cast<const int*>(a.anc)[g];
  }
  __syncthreads();
  for (int t = tid; t < P; t += nthr) {
    unsigned m = 0u;
    for (int k = 0; k < K; ++k) m |= 1u << ja[k * P + t];
    msk[t] = m;
  }
  __syncthreads();
  if (tid < 32) {  // off[t] = entries of the slots before t (warp scan)
    const int per = (P + 31) / 32;
    const int t0 = min(P, tid * per), t1 = min(P, t0 + per);
    int mine = 0;
    for (int t = t0; t < t1; ++t) mine += __popc(msk[t]);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += n;
    }
    int run = incl - mine;
    for (int t = t0; t < t1; ++t) {
      off[t] = run;
      run += __popc(msk[t]);
    }
    if (tid == 31) off[P] = incl;
  }
  __syncthreads();
  for (int t = tid; t < P; t += nthr) {
    unsigned m = msk[t];
    int e = off[t];
    while (m) {
      ent[e++] = (t << 5) | (__ffs(m) - 1);
      m &= m - 1u;
    }
  }
  for (int i = tid; i < K * P; i += nthr) {
    const int t = i % P;
    ja[i] = off[t] + __popc(msk[t] & ((1u << ja[i]) - 1u));
  }
  __syncthreads();
}

// One (beam, head) softmax by a warp over the scores s[0..P), with D2's
// own score ``so`` (-inf for D1) in the max and the sum: s becomes p = e /
// sum rounded to T; returns the own row's probability (kept in fp32).
template <typename T>
__device__ __forceinline__ float softmax_row(float* s, int P, float so,
                                             int lane) {
  float m = so;
  for (int t = lane; t < P; t += 32) m = fmaxf(m, s[t]);
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < P; t += 32) sum += expf(s[t] - m);
  sum = warp_sum(sum) + expf(so - m);
  for (int t = lane; t < P; t += 32)
    s[t] = to_f(from_f<T>(expf(s[t] - m) / sum));
  return expf(so - m) / sum;
}

// D2's own score of a beam and head by a warp: q . k_new (both rows in
// shared memory) with each product rounded to T, summed in fp32, plus the
// own bias
template <typename T>
__device__ __forceinline__ float own_score(const Args& a, const T* q,
                                           const T* kn, int h, int lane) {
  float part = 0.f;
  for (int d = lane; d < a.Dh; d += 32)
    part += to_f(from_f<T>(to_f(q[d]) * to_f(kn[d])));
  return warp_sum(part) +
         (a.obias != nullptr ? a.obias[(size_t)h * a.obias_s] : 0.f);
}

__device__ __forceinline__ float bias_at(const Args& a, int h, int t) {
  return a.bias != nullptr
             ? a.bias[(size_t)h * a.bias_sh + (size_t)t * a.bias_st]
             : 0.f;
}

// D2: this step's K/V, rows b*K .. b*K + K, heads h0 .. h0 + G, into the
// block's stash nkv ([2][K][G * Dh]: k_new, then v_new) by cp.async, in
// the queries' group (not committed): the own score, the own term and the
// slot write read them there, with no round trip of their own
template <typename T>
__device__ __forceinline__ void stash_new(const Args& a, int b, int h0,
                                          int G, T* nkv) {
  constexpr int VE = Vec<T>::n;
  const int row = G * a.Dh, vecs = row / VE, inner = a.H * a.Dh;
  for (int i = threadIdx.x; i < a.K * vecs; i += blockDim.x) {
    const int k = i / vecs, c = i - k * vecs;
    const size_t src = (size_t)(b * a.K + k) * inner + (size_t)h0 * a.Dh +
                       c * VE;
    cp_async_16(nkv + k * row + c * VE,
                reinterpret_cast<const T*>(a.kn) + src, 16);
    cp_async_16(nkv + (a.K + k) * row + c * VE,
                reinterpret_cast<const T*>(a.vn) + src, 16);
  }
}

// D2: the stash into slot pos of the caches (J == K; no block reads slot
// pos)
template <typename T>
__device__ __forceinline__ void write_slot(const Args& a, int b, int h0,
                                           int G, const T* nkv) {
  constexpr int VE = Vec<T>::n;
  const int row = G * a.Dh, vecs = row / VE, inner = a.H * a.Dh;
  for (int i = threadIdx.x; i < a.K * vecs; i += blockDim.x) {
    const int k = i / vecs, c = i - k * vecs;
    const size_t dst = (size_t)a.pos * a.B * a.K * inner +
                       (size_t)(b * a.K + k) * inner + (size_t)h0 * a.Dh +
                       c * VE;
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.kc) + dst) =
        *reinterpret_cast<const uint4*>(nkv + k * row + c * VE);
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(a.vc) + dst) =
        *reinterpret_cast<const uint4*>(nkv + (a.K + k) * row + c * VE);
  }
}

// Route "tc": a block per (b, G heads), warp w the head h0 + w.
// Scores and P.V on mma.sync m16n8k16 with the K beams as the 16 rows of
// A: the scores against every entry of a tile, kept where the entry is
// the beam's own at its slot; P.V with A = p laid out per entry (zero off
// a beam's own entries). A tile's rows past its last entry are zero-filled
// by cp.async, so no stale value meets a zero.
template <bool UPDATE>
__device__ __forceinline__ void beam_tc(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, J = a.J, P = a.P, H = a.H, G = a.G;
  const int b = blockIdx.x / (H / G), h0 = (blockIdx.x % (H / G)) * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;  // 32 G
  const int h = h0 + warp;  // this warp's head
  const int inner = H * kTcD;
  const size_t slot = (size_t)a.B * J * inner;  // one time step of the cache
  const Layout L = layout_of(K, J, P, kTcD, 2, kTcEnt, true, G, UPDATE);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* ja = reinterpret_cast<int*>(smem + L.ja);
  unsigned* msk = reinterpret_cast<unsigned*>(smem + L.msk);
  int* off = reinterpret_cast<int*>(smem + L.off);
  int* ent = reinterpret_cast<int*>(smem + L.ent);
  float* own = reinterpret_cast<float*>(smem + L.own) + warp * K;
  bf16* nkv = reinterpret_cast<bf16*>(smem + L.nkv);
  const bf16* qw = qs + warp * kTcMaxK * kTcLd;  // this warp's queries
  float* sw = sc + warp * K * P;                 // this warp's scores
  const bf16* q = reinterpret_cast<const bf16*>(a.q);
  const bf16* kc = reinterpret_cast<const bf16*>(a.kc);
  const bf16* vc = reinterpret_cast<const bf16*>(a.vc);

  // the queries (the oldest cp.async group, complete before any tile),
  // then zeros in the A rows past the K beams
  for (int i = tid; i < G * K * 8; i += nthr) {
    const int w = i / (K * 8), k = (i >> 3) % K, c = i & 7;
    cp_async_16(qs + (w * kTcMaxK + k) * kTcLd + c * 8,
                q + (size_t)(b * K + k) * inner + (h0 + w) * kTcD + c * 8,
                16);
  }
  if (UPDATE) stash_new<bf16>(a, b, h0, G, nkv);
  cp_async_commit();
  for (int i = tid; i < G * (kTcMaxK - K) * 8; i += nthr) {
    const int w = i / ((kTcMaxK - K) * 8), r = K + (i >> 3) % (kTcMaxK - K);
    *reinterpret_cast<uint4*>(qs + (w * kTcMaxK + r) * kTcLd + (i & 7) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  build_entries(a, b, ja, msk, off, ent);
  const int E = off[P];
  const int nt = (E + kTcEnt - 1) / kTcEnt;  // tiles a pass
  // tile u < nt: K slices of entries [16 u, 16 u + 16) of the block's
  // heads, then V likewise; a thread takes half a row (4 pieces) of head
  // tid / 32, entry (tid / 2) % 16
  auto issue = [&](int u) {
    if (u < 2 * nt) {
      const int pass = u >= nt, lo = (u - pass * nt) * kTcEnt;
      const int r = (tid >> 1) & 15, half = tid & 1;
      const bool ok = lo + r < E;
      const int e = ok ? ent[lo + r] : 0;
      const bf16* src = (pass ? vc : kc) + (size_t)(e >> 5) * slot +
                        (size_t)(b * J + (e & 31)) * inner +
                        (h0 + warp) * kTcD + half * 32;
      bf16* dst = ring + ((u % kStages) * G * kTcEnt + warp * kTcEnt + r) *
                             kTcLd + half * 32;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cp_async_16(dst + c * 8, src + c * 8, ok ? 16 : 0);
    }
    cp_async_commit();  // empty past the last tile: the group count holds
  };
  auto softmax = [&]() {  // this warp's head, a beam at a time
    for (int k = 0; k < K; ++k) {
      const float so =
          UPDATE ? own_score<bf16>(a, qw + k * kTcLd,
                                   nkv + (k * G + warp) * kTcD, h, lane)
                 : -INFINITY;
      const float po = softmax_row<bf16>(sw + k * P, P, so, lane);
      if (lane == 0) own[k] = po;
    }
    __syncwarp();
  };

  for (int u = 0; u < kStages - 1; ++u) issue(u);
  const int g = lane >> 2, cq = (lane & 3) * 2;  // an mma fragment's row, col
  uint32_t qa[4][4];   // A = this head's queries, k16 steps of Dh
  float o[8][4] = {};  // this head's P.V, n8 tiles of Dh
  for (int u = 0; u < 2 * nt; ++u) {
    issue(u + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int pass = u >= nt, lo = (u - pass * nt) * kTcEnt;
    const int n = min(kTcEnt, E - lo);
    const bf16* tw = ring + ((u % kStages) * G + warp) * kTcEnt * kTcLd;
    if (!pass) {
      if (u == 0) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) tc_frag_a(qa[kc], qw, 0, kc, lane);
      }
      float c[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t bb[4];
        tc_frag_bt(bb, tw, 0, kc, lane);
        mma_bf16(c[0], qa[kc], bb[0], bb[1]);
        mma_bf16(c[1], qa[kc], bb[2], bb[3]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // (n8 tile, row half, column)
        const int k = g + ((i >> 1) & 1) * 8;
        const int el = (i >> 2) * 8 + cq + (i & 1);
        if (k < K && el < n) {
          const int e = lo + el, t = ent[e] >> 5;
          if (ja[k * P + t] == e)
            sw[k * P + t] = c[i >> 2][i & 3] + bias_at(a, h, t);
        }
      }
    } else {
      if (u == nt) softmax();
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a[i]: row g (+8), column (+8)
        float pv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = g + (i & 1) * 8, el = (i >> 1) * 8 + cq + j;
          pv[j] = 0.f;
          if (k < K && el < n) {
            const int e = lo + el, t = ent[e] >> 5;
            if (ja[k * P + t] == e) pv[j] = sw[k * P + t];
          }
        }
        pa[i] = pack_bf16(pv[0], pv[1]);
      }
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        uint32_t bb[4];
        tc_frag_b(bb, tw, 0, 2 * dt, lane);
        mma_bf16(o[2 * dt], pa, bb[0], bb[1]);
        mma_bf16(o[2 * dt + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  if (nt == 0) {  // D2 at pos 0: the own row alone
    cp_async_wait<0>();
    __syncthreads();
    softmax();
  }
  // rows g (+8) are beams, columns 8 j + cq (+1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = g + half * 8;
      if (k < K) {
        const size_t x = (size_t)(b * K + k) * inner + h * kTcD + j * 8 + cq;
        float r0 = o[j][half * 2], r1 = o[j][half * 2 + 1];
        if (UPDATE) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  nkv + ((K + k) * G + warp) * kTcD + j * 8 + cq));
          r0 = fmaf(own[k], v.x, r0);
          r1 = fmaf(own[k], v.y, r1);
        }
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(a.out) +
                                           x) = __floats2bfloat162_rn(r0, r1);
      }
    }
  }
  if (UPDATE) write_slot<bf16>(a, b, h0, G, nkv);
}

// Route "fma": a block per (b, h). Scores: 8 lanes a (beam, slot) dot
// product over 16-byte vectors (3 shuffles); P.V: a thread per (slot
// split, beam, 16-byte column), fp32 sums parked in shared memory between
// tiles, the splits summed in order at the end.
template <typename T, bool UPDATE>
__device__ __forceinline__ void beam_fma(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VE = Vec<T>::n;  // elements in 16 bytes
  const int K = a.K, J = a.J, P = a.P, Dh = a.Dh, H = a.H, R = a.rows;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vecs = Dh / VE;
  const int inner = H * Dh;
  const size_t slot = (size_t)a.B * J * inner;  // one time step of the cache
  const size_t head = (size_t)h * Dh;
  const Layout L = layout_of(K, J, P, Dh, (int)sizeof(T), R, false, 1,
                             UPDATE);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* ja = reinterpret_cast<int*>(smem + L.ja);
  unsigned* msk = reinterpret_cast<unsigned*>(smem + L.msk);
  int* off = reinterpret_cast<int*>(smem + L.off);
  int* ent = reinterpret_cast<int*>(smem + L.ent);
  float* own = reinterpret_cast<float*>(smem + L.own);
  T* nkv = reinterpret_cast<T*>(smem + L.nkv);
  const int nsplit = splits_of(K, vecs);
  const T* kc = reinterpret_cast<const T*>(a.kc);
  const T* vc = reinterpret_cast<const T*>(a.vc);

  for (int i = tid; i < K * vecs; i += kThreads) {
    const int k = i / vecs, c = i - k * vecs;
    cp_async_16(qs + k * Dh + c * VE,
                reinterpret_cast<const T*>(a.q) + (size_t)(b * K + k) * inner +
                    head + c * VE,
                16);
  }
  if (UPDATE) stash_new<T>(a, b, h, 1, nkv);
  cp_async_commit();
  for (int i = tid; i < nsplit * K * Dh; i += kThreads) acc[i] = 0.f;
  build_entries(a, b, ja, msk, off, ent);
  const int E = off[P];
  const int nt = (E + R - 1) / R;  // tiles a pass
  // tile u < nt: K slices of entries [u R, u R + R); then V, likewise
  auto issue = [&](int u) {
    if (u < 2 * nt) {
      const int pass = u >= nt;
      const int lo = (u - pass * nt) * R, n = min(R, E - lo);
      const T* src = pass ? vc : kc;
      T* dst = ring + (u % kStages) * R * Dh;
      for (int i = tid; i < n * vecs; i += kThreads) {
        const int r = i / vecs, c = i - r * vecs;
        const int e = ent[lo + r];
        cp_async_16(dst + r * Dh + c * VE,
                    src + (size_t)(e >> 5) * slot +
                        (size_t)(b * J + (e & 31)) * inner + head + c * VE,
                    16);
      }
    }
    cp_async_commit();  // empty past the last tile: the group count holds
  };
  auto softmax = [&]() {  // a warp per beam
    for (int k = warp; k < K; k += kThreads / 32) {
      const float so = UPDATE ? own_score<T>(a, qs + k * Dh, nkv + k * Dh,
                                             h, lane)
                              : -INFINITY;
      const float po = softmax_row<T>(sc + k * P, P, so, lane);
      if (lane == 0) own[k] = po;
    }
  };

  for (int u = 0; u < kStages - 1; ++u) issue(u);
  const int l8 = tid & 7;
  const unsigned gmask = 0xffu << (tid & 24);  // this thread's 8 lanes
  for (int u = 0; u < 2 * nt; ++u) {
    issue(u + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int pass = u >= nt;
    const int lo = (u - pass * nt) * R, hi = min(E, lo + R);
    const T* tile = ring + (u % kStages) * R * Dh;
    const int tlo = ent[lo] >> 5, thi = ent[hi - 1] >> 5;
    if (!pass) {  // scores of the (beam, slot) pairs whose entry is here
      const int pairs = (thi - tlo + 1) * K;
      for (int i = tid >> 3; i < pairs; i += kThreads / 8) {
        const int t = tlo + i / K, k = i - (i / K) * K;
        const int e = ja[k * P + t];
        if (e < lo || e >= hi) continue;  // the same for the 8 lanes
        float part = 0.f;
        for (int c = l8; c < vecs; c += 8) {
          float x[VE], y[VE];
          Vec<T>::load(x, qs + k * Dh + c * VE);
          Vec<T>::load(y, tile + (e - lo) * Dh + c * VE);
#pragma unroll
          for (int j = 0; j < VE; ++j) part = fmaf(x[j], y[j], part);
        }
        part += __shfl_xor_sync(gmask, part, 4);
        part += __shfl_xor_sync(gmask, part, 2);
        part += __shfl_xor_sync(gmask, part, 1);
        if (l8 == 0) sc[k * P + t] = part + bias_at(a, h, t);
      }
    } else {
      if (u == nt) {
        softmax();
        __syncthreads();
      }
      // P.V: split s takes the slots t = s (mod nsplit)
      for (int i = tid; i < nsplit * K * vecs; i += kThreads) {
        const int c = i % vecs, k = (i / vecs) % K, s = i / (vecs * K);
        float* ac = acc + (s * K + k) * Dh + c * VE;
        float r[VE];
#pragma unroll
        for (int j = 0; j < VE; ++j) r[j] = ac[j];
        for (int t = tlo + ((s - tlo) % nsplit + nsplit) % nsplit; t <= thi;
             t += nsplit) {
          const int e = ja[k * P + t];
          if (e < lo || e >= hi) continue;
          const float p = sc[k * P + t];
          float y[VE];
          Vec<T>::load(y, tile + (e - lo) * Dh + c * VE);
#pragma unroll
          for (int j = 0; j < VE; ++j) r[j] = fmaf(p, y[j], r[j]);
        }
#pragma unroll
        for (int j = 0; j < VE; ++j) ac[j] = r[j];
      }
    }
    __syncthreads();
  }
  if (nt == 0) {  // D2 at pos 0: the own row alone
    cp_async_wait<0>();
    __syncthreads();
    softmax();
    __syncthreads();
  }
  for (int i = tid; i < K * vecs; i += kThreads) {
    const int k = i / vecs, c = i - k * vecs;
    float r[VE];
#pragma unroll
    for (int j = 0; j < VE; ++j) r[j] = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ac = acc + (s * K + k) * Dh + c * VE;
#pragma unroll
      for (int j = 0; j < VE; ++j) r[j] += ac[j];
    }
    const size_t x = (size_t)(b * K + k) * inner + head + c * VE;
    if (UPDATE) {
      float y[VE];
      Vec<T>::load(y, nkv + (K + k) * Dh + c * VE);
#pragma unroll
      for (int j = 0; j < VE; ++j) r[j] = fmaf(own[k], y[j], r[j]);
    }
    Vec<T>::store(reinterpret_cast<T*>(a.out) + x, r);
  }
  if (UPDATE) write_slot<T>(a, b, h, 1, nkv);
}

// D1 and D2 under their own names (the profiler's kernel families)
template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads, TC ? 5 : 1)
    beam_attend_kernel(Args a) {
  if constexpr (TC)
    beam_tc<false>(a);
  else
    beam_fma<T, false>(a);
}

template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads, TC ? 5 : 1)
    beam_attend_update_kernel(Args a) {
  if constexpr (TC)
    beam_tc<true>(a);
  else
    beam_fma<T, true>(a);
}

template <typename T, bool TC>
int launch(const Args& a, bool update, int smem, cudaStream_t st) {
  const int esize = (int)sizeof(T);
  if (a.Dh < 1 || a.Dh > kMaxDh || (a.Dh * esize) % 16 || a.pos < 0 ||
      a.pos >= a.Lc || a.B < 1 || a.K < 1 || a.J < 1 || a.J > kMaxJ ||
      a.H < 1 || a.rows < 1 || (update && a.J != a.K) ||
      (TC ? (a.Dh != kTcD || a.K > kTcMaxK || a.rows != kTcEnt ||
             a.G < 1 || a.G > kTcMaxHeads || a.H % a.G)
          : a.G != 1))
    return (int)cudaErrorInvalidValue;
  const Layout L =
      layout_of(a.K, a.J, a.P, a.Dh, esize, a.rows, TC, a.G, update);
  if (smem != L.total || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kern)(Args) = update ? beam_attend_update_kernel<T, TC>
                              : beam_attend_kernel<T, TC>;
  // all of L1 as shared memory, so that as many blocks as the registers
  // allow share an SM
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.B * (a.H / a.G), TC ? 32 * a.G : kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, bool update, int is_bf16, int tc, int smem,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16) {
    if (tc) return (int)cudaErrorInvalidValue;
    return launch<float, false>(a, update, smem, st);
  }
  return tc ? launch<bf16, true>(a, update, smem, st)
            : launch<bf16, false>(a, update, smem, st);
}

}  // namespace

// q, out (B*K, H*Dh); caches (Lc, B*J, H*Dh); anc (B, K, Lc) int32 or
// int64 (anc64); bias row bias[h * bias_sh + t * bias_st] f32 or NULL;
// tc (the route), heads a block, rows and smem from ops/decode.py
// beam_route / beam_plan
extern "C" int vlpet_beam_attend(const void* q, const void* kc,
                                 const void* vc, const void* anc,
                                 const void* bias, void* out, int B, int K,
                                 int J, int Lc, int H, int Dh, int pos,
                                 int anc64, int bias_sh, int bias_st,
                                 int is_bf16, int tc, int heads, int rows,
                                 int smem, void* stream) {
  const Args a{q, const_cast<void*>(kc), const_cast<void*>(vc), nullptr,
               nullptr, anc, (const float*)bias, nullptr, out, B, K, J, Lc,
               H, Dh, pos, pos + 1, anc64, bias_sh, bias_st, 0, rows, heads};
  return dispatch(a, false, is_bf16, tc, smem, stream);
}

// q, k_new, v_new, out (B*K, H*Dh); caches (Lc, B*K, H*Dh), slot pos
// written in place; anc (B, K, Lc) int32 or int64 (anc64); bias row as
// above and own bias obias[h * obias_s] f32, or NULL
extern "C" int vlpet_beam_attend_update(
    const void* q, void* kc, void* vc, const void* kn, const void* vn,
    const void* anc, const void* bias, const void* obias, void* out, int B,
    int K, int Lc, int H, int Dh, int pos, int anc64, int bias_sh,
    int bias_st, int obias_s, int is_bf16, int tc, int heads, int rows,
    int smem, void* stream) {
  const Args a{q,     kc,   vc,   kn,   vn,   anc,     (const float*)bias,
               (const float*)obias, out, B,   K,    K,    Lc,      H,
               Dh,    pos,  pos,  anc64, bias_sh, bias_st, obias_s, rows,
               heads};
  return dispatch(a, true, is_bf16, tc, smem, stream);
}
