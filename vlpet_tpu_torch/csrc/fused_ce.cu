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
// split's vocab tiles in order. Consecutive blocks share a split, so one W
// tile serves the row blocks from L2. Zero rows past V, so 0 x garbage
// never reaches dx. No atomics: every sum has a fixed order (a partial a
// split, merged or summed in split order by a second kernel), so the
// result is deterministic; fp32 inputs take plain FMA, never TF32.
//
// C1, bf16 (ce_fwd_tc; below, before the kernel): 64 rows a block, one
// warpgroup, 32-column vocab tiles of C2's re-laid W (ce_w_tiles, bias
// included) streamed by one TMA bulk copy a tile into an mbarrier ring
// (4 stages at D 512, 2 at D 768, 1 at D 1024 beside the 64 x D x tile).
// The 64 x 32 logits come from one wgmma m64n32k16 chain over all of D
// and stay in registers: each quad of lanes holds a row's 32 columns, and
// the row's running (max, sum, picked logit) is updated with quad
// shuffles and EX2. Two register sets of logits let tile t + 1's chain run
// on the tensor cores while the CUDA cores reduce tile t. It replaced a
// WMMA design (ce_fwd_wmma, 64-column tiles, 8 warps) that staged each W
// tile by 16-byte cp.async copies from every thread, sent the logits
// through an fp32 shared tile read back one warp a row, and took two
// barriers a tile: 2.14 ms at the T5 site against 1.37 for F.linear +
// F.cross_entropy (PERF.md). The forward hands its wt to C2
// (ops/fused_ce.py), so a step re-lays W once.
//
// C2, bf16 (ce_bwd_tc; below, before the kernel): 64 rows a block (32 at
// D 1024), 32-column vocab tiles. It replaced a WMMA design (32 rows a
// block, 64-column tiles) that staged each W tile with no overlap, sent
// the logits through fp32 and g through bf16 shared memory (four barriers
// a tile) and held one block an SM: 3.15 ms at the T5 site against 1.59
// for autograd of F.linear + F.cross_entropy. What the new one does about
// it: (1) W streams through a 2-3 stage ring filled by one TMA bulk copy a
// tile from a tile-contiguous copy of W (ce_w_tiles): one instruction, not
// a few thousand 16-byte cp.async a tile (issued by every thread, those
// took as long as the products); (2) the logits' C
// fragments become g and then g's A fragments in registers (mma_a_from_c),
// no staging; (3) 64 rows a block read each W tile from L2 half as often.
// Why wgmma for the logits and mma.sync for dx: the logits are a 64-row x
// 32-column product over all of D with both operands in shared memory,
// wgmma's shape, and its accumulator lands in mma.sync's C layout, so g
// needs no shuffle; dx keeps its fp32 accumulator, 64 rows x D, in the
// registers of the warps that own the rows (384 columns a warpgroup at
// D 768: 192 registers a thread), which wgmma's A-from-registers form
// could also do, but at no gain here. The price of register-resident dx:
// each warpgroup computes the logits of its rows again (twice at D 768).
// Tried and not kept (measured on an NVIDIA H100 80GB HBM3, 700 W): a
// 2- or 4-block cluster sharing each W tile by TMA multicast (no gain: the
// L2 reads were not the limit), mma.sync logits (1.5x slower), 48 rows
// with 256-column slices (spills).
#include "common.cuh"

using namespace vlpet;

namespace {

constexpr float kNeg = -1e30f;  // masked column (vlpet_tpu fused_ce NEG)
constexpr int kTV = 64;         // fp32 vocab tile: four 16-col fragments
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLLD = kTV + 4;    // fp32 logits staging row stride
constexpr int kCTV = 32;         // vocab columns of a bf16 W tile (wt)

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

// ------------------------------------------------------- bf16 (tensor cores)
// C2 on the tensor cores (header): a block of BM rows x all D columns of
// dx; warpgroup sl (4 warps) owns dx columns SL sl .. SL sl + SL, warp rc
// of it rows 16 rc .. 16 rc + 16 (SL / 2 fp32 accumulator registers a
// thread). Per 32-column vocab tile each warpgroup computes the BM x 32
// logits over all of D (WG: one wgmma m64n32k16 chain from shared memory;
// else mma.sync per warp), turns them into g in registers, and the C
// fragments of g are the A fragments of dx += g . W (mma_a_from_c,
// mma.sync). The W tiles come from ``wt``, W re-laid out by ce_w_tiles so
// that each tile, with its bias, is one contiguous block in the shared
// memory layout: one bulk copy (TMA, cp.async.bulk) a tile, completing on
// the stage's mbarrier, into a ring of STAGES stages, tile t + STAGES - 1
// copying while tile t multiplies; one barrier a tile.
//
// Shared-memory layout, x and W alike: chunk-major (common.cuh).

template <int D, int BM, int STAGES, int SL, bool WG>
struct BwdTc {
  static constexpr int warps = (BM / 16) * (D / SL);
  static constexpr int threads = warps * 32;
  // a ring stage (and a tile of wt): the W tile and its kCTV fp32 biases,
  // in bf16 units
  static constexpr int stage = kCTV * D + 2 * kCTV;
  static constexpr uint32_t stage_bytes = stage * 2;
  static constexpr size_t smem =
      ((size_t)BM * D + (size_t)STAGES * stage) * 2 + STAGES * 8;
  static_assert(stage_bytes % 16 == 0, "bulk copies of 16 bytes");
};

// wt[t] = W rows 32 t .. 32 t + 32 chunk-major, then their 32 biases;
// zeros past V. One 16-byte chunk (or one bias) a thread. C1 and C2 read
// the same wt.
__global__ void ce_w_tiles(const bf16* __restrict__ w,
                           const float* __restrict__ b, bf16* __restrict__ wt,
                           int V, int D, long long items) {
  const int words = D / 8;
  const int stage = kCTV * D + 2 * kCTV;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long tile = i / (kCTV * (words + 1));
    const int j = (int)(i - tile * (kCTV * (words + 1)));
    const int r = j / (words + 1), c = j - r * (words + 1);
    const long long v = tile * kCTV + r;
    bf16* dst = wt + tile * stage;
    if (c < words) {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (v < V) val = *reinterpret_cast<const uint4*>(w + v * D + c * 8);
      *reinterpret_cast<uint4*>(dst + (c * kCTV + r) * 8) = val;
    } else {
      reinterpret_cast<float*>(dst + kCTV * D)[r] = v < V ? b[v] : 0.f;
    }
  }
}

// ------------------------------------------------ C1, bf16 (tensor cores)
// C1 on the tensor cores (header): one warpgroup takes 64 rows, warp w of
// it rows 16 w .. 16 w + 16, the thread rows g and g + 8 of those (g =
// lane / 4) and, of each 32-column tile, columns 8 nt + 2 t, + 1 (t = lane
// % 4, nt 0..3). x stays in shared memory; the tiles of wt stream through
// a ring of ``stages`` stages, one bulk copy each.
constexpr int kC1Rows = 64;
constexpr int kC1Threads = 128;
constexpr int kC1MaxStages = 4;

size_t c1_stage_bytes(int D) { return ((size_t)kCTV * D + 2 * kCTV) * 2; }

// ring stages that fit beside the x tile (0: D too wide for one)
int c1_stages(int D) {
  const long long room =
      232448 - (long long)kC1Rows * D * 2 - kC1MaxStages * 8;
  const long long fit = room / (long long)c1_stage_bytes(D);
  return (int)(fit < kC1MaxStages ? fit : kC1MaxStages);
}

size_t c1_smem(int D, int stages) {
  return (size_t)kC1Rows * D * 2 + stages * c1_stage_bytes(D) +
         kC1MaxStages * 8;
}

// part: [3][S][N] fp32 (max, sum, picked logit) of split blockIdx.y
__global__ void __launch_bounds__(kC1Threads)
ce_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wt,
          const int* __restrict__ labels, float* __restrict__ part, int N,
          int D, int V, int tps, int S, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int stage = kCTV * D + 2 * kCTV;  // bf16 elements of a ring stage
  const uint32_t stage_bytes = (uint32_t)stage * 2;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // chunk-major [D / 8][64]
  bf16* ws = xs + kC1Rows * D;  // [stages][stage]: W chunk-major, then bias
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + (size_t)stages * stage);

  const int n0 = blockIdx.x * kC1Rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (V + kCTV - 1) / kCTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  // tile nt of wt into its ring stage (one thread)
  auto issue = [&](int nt) {
    const int st = (nt - t0) % stages;
    mbar_expect_tx(full + st, stage_bytes);
    bulk_copy(ws + (size_t)st * stage, wt + (size_t)nt * stage, stage_bytes,
              full + st);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(full + st, 1);
    mbar_init_fence();
  }
  // the thread's two rows: label and running (max, sum, picked logit)
  int lab[2];
  float m[2], s[2], pk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + warp * 16 + g + 8 * r;
    lab[r] = n < N ? labels[n] : -1;
    m[r] = kNeg;
    s[r] = 0.f;
    pk[r] = 0.f;
  }
  cp_rows(xs, x, n0, kC1Rows, N, D, kC1Threads);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (threadIdx.x == 0)
    for (int nt = t0; nt < min(t0 + stages, t1); ++nt) issue(nt);
  cp_async_wait<0>();
  fence_proxy_async();  // x (cp.async) is read by wgmma
  __syncthreads();

  // tile it's logits into l: wait for its stage, one wgmma chain over D
  auto chain = [&](float (&l)[4][4], int it) {
    const int st = (it - t0) % stages;
    mbar_wait(full + st, ((it - t0) / stages) & 1);
    const bf16* W = ws + (size_t)st * stage;
    wgmma_fence();
#pragma unroll 8
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_m64n32(l, wg_desc(xs + 2 * kc * kC1Rows * 8, kC1Rows * 16, 128),
                   wg_desc(W + 2 * kc * kCTV * 8, kCTV * 16, 128), kc > 0);
    wgmma_commit();
  };
  // tile it, whose chain into cur is in flight: wait for it, free its
  // stage, start tile it + 1's chain into nxt, then reduce cur
  auto step = [&](float (&cur)[4][4], float (&nxt)[4][4], int it) {
    wgmma_wait<0>();
    const int st = (it - t0) % stages;
    const float* Bt =
        reinterpret_cast<const float*>(ws + (size_t)st * stage + kCTV * D);
    float2 bc[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bc[nt] = *reinterpret_cast<const float2*>(Bt + nt * 8 + 2 * t);
    __syncthreads();  // every warp is done with stage st: refill it
    if (threadIdx.x == 0 && it + stages < t1) issue(it + stages);
    if (it + 1 < t1) chain(nxt, it + 1);
    const int v0 = it * kCTV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float e[8];
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = v0 + nt * 8 + 2 * t + c;
          const float v = col < V ? cur[nt][2 * r + c] + (c ? bc[nt].y
                                                            : bc[nt].x)
                                  : kNeg;
          e[2 * nt + c] = v;
          mx = fmaxf(mx, v);
          if (col == lab[r]) pk[r] = v;
        }
      const float mn = fmaxf(m[r], quad_max(mx));
      const float mn2 = mn * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += ex2(fmaf(e[i], kLog2e, -mn2));
      s[r] = s[r] * ex2(fmaf(m[r], kLog2e, -mn2)) + quad_sum(sum);
      m[r] = mn;
    }
  };
  // written only by wgmma (scale-d 0 first): no serialised products
  float la[4][4], lb[4][4];
  if (t0 < t1) chain(la, t0);
  for (int it = t0; it < t1; it += 2) {
    step(la, lb, it);
    if (it + 1 < t1) step(lb, la, it + 1);
  }
  const size_t plane = (size_t)S * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float p = quad_sum(pk[r]);  // one lane of the quad holds it
    const int n = n0 + warp * 16 + g + 8 * r;
    if (t != 0 || n >= N) continue;
    const size_t o = (size_t)blockIdx.y * N + n;
    part[o] = m[r];
    part[plane + o] = s[r];
    part[2 * plane + o] = p;
  }
}

template <int D, int BM, int STAGES, int SL, bool WG>
__global__ void __launch_bounds__(BwdTc<D, BM, STAGES, SL, WG>::threads)
ce_bwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wt,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ dloss, float* __restrict__ part, int N,
          int V, int tps) {
  using C = BwdTc<D, BM, STAGES, SL, WG>;
  constexpr int RCH = BM / 16;
  static_assert(!WG || BM == 64, "a wgmma logits tile is 64 rows");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // chunk-major [D / 8][BM]
  bf16* ws = xs + BM * D;  // [STAGES][C::stage]: W chunk-major, then bias
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + STAGES * C::stage);

  const int n0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RCH) * 16, c0 = (warp / RCH) * SL;
  const int n_tiles = (V + kCTV - 1) / kCTV;
  const int t0 = blockIdx.y * tps;
  const int t1 = min(t0 + tps, n_tiles);
  // tile nt of wt into its ring stage (one thread)
  auto issue = [&](int nt) {
    const int st = (nt - t0) % STAGES;
    mbar_expect_tx(full + st, C::stage_bytes);
    bulk_copy(ws + st * C::stage, wt + (size_t)nt * C::stage,
              C::stage_bytes, full + st);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(full + st, 1);
    mbar_init_fence();
  }
  // the label, lse (times log2(e): exp(l - lse) is one FFMA and one EX2)
  // and dloss of the thread's two rows (dloss 0 on ignored rows, past N)
  int lab[2];
  float lr2[2], sc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + r0 + g + 8 * r;
    const bool in = n < N;
    lab[r] = in ? labels[n] : -1;
    lr2[r] = in ? lse[n] * kLog2e : 0.f;
    sc[r] = in && lab[r] >= 0 ? dloss[n] : 0.f;
  }
  cp_rows(xs, x, n0, BM, N, D, C::threads);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (threadIdx.x == 0)
    for (int nt = t0; nt < min(t0 + STAGES - 1, t1); ++nt) issue(nt);
  cp_async_wait<0>();
  // x (written by cp.async) is read by wgmma, the async proxy
  fence_proxy_async();

  float acc[SL / 8][4];
#pragma unroll
  for (int i = 0; i < SL / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // ldmatrix lane offsets in the chunk-major tiles: row (or vocab row) and
  // chunk of an A fragment / a B fragment with k down the rows (.trans),
  // and of a B fragment with the rows as n
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  const int bt_row = (lane & 7) + (lane >> 4) * 8;
  const int bt_chunk = (lane >> 3) & 1;

  for (int it = t0; it < t1; ++it) {
    // every warp is done with tile it - 1: its stage is free for tile
    // it + STAGES - 1 (and, the first time, x is in place)
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES - 1 < t1) issue(it + STAGES - 1);
    const int st = (it - t0) % STAGES;
    mbar_wait(full + st, ((it - t0) / STAGES) & 1);
    const bf16* W = ws + st * C::stage;
    const float* Bt = reinterpret_cast<const float*>(W + kCTV * D);
    const int v0 = it * kCTV;

    // logits (16 rows x 32 columns a warp) over all of D
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    if constexpr (WG) {
      wgmma_fence();
#pragma unroll 8
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n32(s, wg_desc(xs + 2 * kc * BM * 8, BM * 16, 128),
                     wg_desc(W + 2 * kc * kCTV * 8, kCTV * 16, 128), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll 4
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4], b0[4], b1[4];
        ldmatrix_x4(a, xs + ((2 * kc + a_chunk) * BM + r0 + a_row) * 8);
        ldmatrix_x4(b0, W + ((2 * kc + bt_chunk) * kCTV + bt_row) * 8);
        ldmatrix_x4(b1, W + ((2 * kc + bt_chunk) * kCTV + 16 + bt_row) * 8);
        mma_bf16(s[0], a, b0[0], b0[1]);
        mma_bf16(s[1], a, b0[2], b0[3]);
        mma_bf16(s[2], a, b1[0], b1[1]);
        mma_bf16(s[3], a, b1[2], b1[3]);
      }
    }
    // g = (exp(logit + b - lse) - onehot) * dloss, 0 past V; element (r, c)
    // of n8 tile nt: row r0 + g + 8 r, column v0 + 8 nt + 2 t + c
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = v0 + nt * 8 + 2 * t + c;
        const float bc = Bt[nt * 8 + 2 * t + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& e = s[nt][2 * r + c];
          const float p = ex2(fmaf(e + bc, kLog2e, -lr2[r]));
          e = col < V && sc[r] != 0.f
                  ? (p - (col == lab[r] ? 1.f : 0.f)) * sc[r]
                  : 0.f;
        }
      }
    // dx[16 x SL] += g[16 x 32] . W[32 x SL], g's A fragments from its C
    // fragments (rounded to bf16), W's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ga[4];
      mma_a_from_c(ga, s[2 * kk], s[2 * kk + 1]);
      const bf16* wk = W + ((c0 / 8 + a_chunk) * kCTV + kk * 16 + a_row) * 8;
#pragma unroll
      for (int dn = 0; dn < SL / 16; ++dn) {
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, wk + 2 * dn * kCTV * 8);
        mma_bf16(acc[2 * dn], ga, bw[0], bw[1]);
        mma_bf16(acc[2 * dn + 1], ga, bw[2], bw[3]);
      }
    }
  }
  float* prow = part + (size_t)blockIdx.y * N * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + r0 + g + 8 * r;
    if (n >= N) continue;
    float* dst = prow + (size_t)n * D + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < SL / 8; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8) =
          make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
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

// C2 over wt (ce_w_tiles has re-laid W out)
template <int D, int BM, int STAGES, int SL, bool WG>
int launch_bwd_tc(const void* x, const void* wt, const void* labels,
                  const void* lse, const void* dloss, void* part, int N,
                  int V, int S, cudaStream_t st) {
  using C = BwdTc<D, BM, STAGES, SL, WG>;
  static_assert(C::smem <= 232448, "C2's shared memory exceeds a block's");
  const int n_tiles = (V + kCTV - 1) / kCTV;
  const int err = set_smem(ce_bwd_tc<D, BM, STAGES, SL, WG>, C::smem);
  if (err) return err;
  const int tps = (n_tiles + S - 1) / S;
  ce_bwd_tc<D, BM, STAGES, SL, WG>
      <<<dim3((N + BM - 1) / BM, S), C::threads, C::smem, st>>>(
          (const bf16*)x, (const bf16*)wt, (const int*)labels,
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

}  // namespace

// W (V, D) bf16 and b (V,) f32 re-laid out into wt, ceil(V / 32) tiles of
// 32 D + 64 bf16 (ce_w_tiles): what the bf16 C1 and C2 read
extern "C" int vlpet_ce_w_tiles(const void* w, const void* b, void* wt,
                                int V, int D, void* stream) {
  if (V < 1 || D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  const int n_tiles = (V + kCTV - 1) / kCTV;
  const long long items = (long long)n_tiles * kCTV * (D / 8 + 1);
  const long long want = (items + 255) / 256;
  ce_w_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0,
               (cudaStream_t)stream>>>((const bf16*)w, (const float*)b,
                                       (bf16*)wt, V, D, items);
  return (int)cudaGetLastError();
}

// x (N, D), labels (N,) int32; part [3][S][N] f32 scratch; loss, lse (N,)
// f32. bf16: wt from vlpet_ce_w_tiles (w and b unused), 64 rows a block
// and S vocab splits of ceil(ceil(V / 32) / S) tiles of 32 columns; fp32:
// w (V, D), b (V,) f32, wt unused, 32 rows a block and tiles of 64 columns.
extern "C" int vlpet_ce_fwd(const void* x, const void* w, const void* b,
                            const void* labels, const void* wt, void* part,
                            void* loss, void* lse, int N, int D, int V, int S,
                            int is_bf16, void* stream) {
  if (N < 1 || V < 1 || S < 1 || D < 1 || D % 32 ||
      (is_bf16 && wt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int stages = c1_stages(D);
    if (stages < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = c1_smem(D, stages);
    const int err = set_smem(ce_fwd_tc, smem);
    if (err) return err;
    const int n_tiles = (V + kCTV - 1) / kCTV;
    const int tps = (n_tiles + S - 1) / S;
    ce_fwd_tc<<<dim3((N + kC1Rows - 1) / kC1Rows, S), kC1Threads, smem,
                st>>>((const bf16*)x, (const bf16*)wt, (const int*)labels,
                      (float*)part, N, D, V, tps, S, stages);
  } else {
    const int n_tiles = (V + kTV - 1) / kTV;
    const int tps = (n_tiles + S - 1) / S;
    ce_fwd_f32<<<dim3((N + kFBM - 1) / kFBM, S), kThreads, 0, st>>>(
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
// D 512, 768 or 1024. bf16: wt from vlpet_ce_w_tiles (w and b unused),
// rows per block 64, 64, 32 (ops/fused_ce.py _BWD_ROWS) and S splits of
// ceil(ceil(V / 32) / S) tiles of 32 columns; fp32: wt unused (NULL), 32
// rows and tiles of 64 columns.
extern "C" int vlpet_ce_bwd(const void* x, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* dloss, const void* wt, void* part,
                            void* dx, int N, int D, int V, int S, int is_bf16,
                            void* stream) {
  if (N < 1 || V < 1 || S < 1 || (D != 512 && D != 768 && D != 1024) ||
      (is_bf16 && wt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (is_bf16) {
    // D <= 768: 64 rows, the logits on wgmma; D 1024: 32 rows (the fp32 dx
    // accumulator of 64 rows would fill the register file), mma.sync
    err = D == 512 ? launch_bwd_tc<512, 64, 3, 256, true>(
                         x, wt, labels, lse, dloss, part, N, V, S, st)
          : D == 768
              ? launch_bwd_tc<768, 64, 2, 384, true>(x, wt, labels, lse,
                                                     dloss, part, N, V, S, st)
              : launch_bwd_tc<1024, 32, 2, 256, false>(
                    x, wt, labels, lse, dloss, part, N, V, S, st);
  } else {
    const int n_tiles = (V + kTV - 1) / kTV;
    const int tps = (n_tiles + S - 1) / S;
    const dim3 grid((N + kFBM - 1) / kFBM, S);
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
