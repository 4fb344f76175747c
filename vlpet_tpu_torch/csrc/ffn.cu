// Fused transformer FFN, forward (F1) and backward (F2):
//   y = drop(act(x . W1^T + b1)) . W2^T + b2,
// and the gated FFN (t5-v1.1 gated-gelu), forward (F3) and backward (F4):
//   y = drop(act(x . W0^T) * (x . W1^T)) . Wo^T.
//
// Replaces vlpet_tpu/ops/ffn.py:_run with _fwd_kernel (F1), with
// _bwd_kernel (F2), with _gated_fwd_kernel (F3) and with _gated_bwd_kernel
// (F4), the kernels behind the custom_vjps of fused_ffn and
// fused_gated_ffn. Weights come in PyTorch's Linear layout: W1 (F, D),
// W2 (D, F), W0 (F, D), Wo (D, F); biases are f32; act is gelu (erf, code
// 0), gelu_new (tanh, code 1) or relu (code 2), applied in fp32. The (N, F)
// hidden never reaches device memory: each block keeps its rows' hidden
// chunk in shared memory and folds it straight into the next product. The
// weight matrices are frozen (no dW); the backward recomputes fc1 and gives
// dx, db1 = sum of fp32 ds over the rows and db2 = sum of dy, with ds
// rounded to x's dtype before the dx product as the TPU kernel does.
// Hidden dropout (T5 training): element (n, f) of the (N, F) hidden is
// kept iff hash_bits(n * F + f, seed) >= thr (common.cuh; the global
// index, so the 32-row blocks give the TPU's bits; a tensor-parallel
// rank's hidden, columns [c0, c0 + F) of a hidden W wide, hashes
// n * W + c0 + f: common.cuh drop_index), applied in fp32 after
// the activation and before the bf16 rounding; the backward regenerates
// the mask on the hidden's cotangent. F4 recomputes h0 = x . W0^T and
// h1 = x . W1^T, forms dg = dy . Wo, drops it, and folds
// dh0 = dg * h1 * act'(h0) and dh1 = dg * act(h0), each rounded to x's
// dtype as the TPU kernel does, into dx = dh0 . W0 + dh1 . W1 (no biases
// in T5, so dx alone).
//
// Bound on the H100: the forward is 4 N D F FLOPs, the backward 6 N D F
// (recomputed fc1, dh = dy . W2, dx = ds . W1), against ~2 D F weight
// reads per block, so at the encoder shape (N = 28000) both are
// compute-bound on the tensor cores (0.27 ms forward, 0.40 ms backward at
// 989 TFLOP/s); at the decode rows (N 250-2500: 0.01-0.02 ms) the 9.4 MB
// of bf16 weights, read once, and the card's fill weigh as much.
//
// F1, bf16 (ffn_fwd_tc; below): one block of 64 rows and two warpgroups
// an SM (247 registers, no spills; 208 KB of shared memory at D 768). x
// sits in shared memory; W1 and W2 stream through a ring of two 48 KB
// stages (D 768) from a copy re-laid out so that a stage is one TMA bulk
// copy in wgmma's no-swizzle layout (ffn_w_tiles; the wrapper keeps the
// copy beside W1 and rebuilds it when either weight changes). Per 64-wide
// hidden chunk, fc1 runs on wgmma m64n32k16 (each warpgroup 32 columns
// over all of D), the bias, activation, hash dropout and bf16 rounding
// happen on the accumulator registers, the bf16 hidden goes to one
// double-buffered 64 x 64 shared tile, and fc2 adds hidden . W2^T into the
// fp32 y accumulator with wgmma m64n64k16: 64 x D in the registers of the
// two warpgroups (192 a thread at D 768; D 896 and 1024 split y's columns
// over two blocks, which both compute fc1). At decode rows the hidden
// chunks are split over blocks (ops/ffn.py f1_splits: one wave, one split
// at the encoder rows); each split writes an fp32 partial of y and
// ffn_fwd_reduce sums them in split order with b2: deterministic, no
// atomics. What holds it (probe runs on an NVIDIA H100 80GB HBM3, 700 W,
// scripts not kept): the weight stream. A block's bulk copies complete
// about one at a time, each in about the same time up to ~48 KB, so 16 KB
// stages left the products waiting; stages as large as two fit, issued by
// the warps in turn, were the fastest tried. Tried and not kept: a 2-block
// cluster sharing each stage by TMA multicast (slower: the leader's
// copies served two blocks at the same rate), a tensor-map TMA in place
// of the bulk copy (same rate), splitting a stage into smaller copies or
// rotating the chunk order per block (no gain). It replaced a
// WMMA design (one block of 8 warps per 32 rows, 47 blocks at N 1500;
// every block read 16 x 16 fragments of W1 and W2 straight from global
// memory; the hidden and y went through fp32 shared tiles, two barriers a
// chunk): 0.84-0.87 ms at N 1500-2500 and 5.14 at N 28000 against
// 0.07-0.11 and 0.51 for the plain three-GEMM chain (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
//
// F3, bf16 (gated_fwd_tc): F1's kernel with two up-projections (one
// template, fwd_tc<DU, GATED>). At N = 16800, D 768, F 2048 it is 6 N D F
// FLOPs, 0.16 ms at 989 TFLOP/s, against 9.4 MB of weights that every
// 64-row block streams (at N 1500: 0.014 ms of bytes). W0 and W1 are
// re-laid out together (gated_w_tiles): each hidden chunk has two sets of
// D / 128 up pieces, 64 rows each, W0 and W1 rows interleaved in 8-row
// groups, so that one wgmma m64n32k16 of a warpgroup yields h0 (n8 tiles
// 0, 2) and h1 (tiles 1, 3) of the same 16 hidden columns: each thread
// holds the h0 and h1 of its elements, the gating product never leaves
// the thread, and fc1's registers stay F1's 16 (two sets a chunk, each
// with its own epilogue, instead of one m64n64 of 32 registers beside the
// 192 of y). Then Wo's pieces as F1's fc2 pieces; the dropout (global
// index n F + f) on act(h0) * h1 in fp32 before the bf16 rounding, split
// over one wave at decode rows (ops/ffn.py gated_splits, f1_splits' rule)
// with gated_fwd_reduce summing the partials in order. 247 registers, no
// spills. It replaced a WMMA design (8 warps per 32 rows reading 16 x 16
// fragments of W0, W1 and Wo straight from global memory): 0.6908 -> 0.1623
// ms at N 1500 and 2.7628 -> 0.7786 at N 16800 (chip_phases.py phase 3i,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// F4, bf16 (gated_bwd_tc<DU>): dx of F3, 10 N D F FLOPs (0.27 ms at N
// 16800, D 768, F 2048). 64 rows a block, two warpgroups, the fp32 dx
// accumulator (64 x D) in their registers as F1's y. Per 64-wide hidden
// chunk: dg = dy . Wo on wgmma m64n32 (each warpgroup 32 columns), the
// dropout applied and the fp32 dg parked in a per-thread shared stash (16
// KB: the 16 registers it would hold beside h0/h1 and dx do not fit); then
// per set h0, h1 as F3 and, on the accumulator registers, dh0 = dg h1
// act'(h0) and dh1 = dg act(h0), each rounded to bf16 (where the TPU
// kernel rounds) into two 64 x 64 tiles; then dx += dh0 . W0 + dh1 . W1
// (m64n64 per piece). Shared memory is the binding limit: x and dy at 64
// rows and D 768 are 96 KB each, so x stays resident and dy streams
// through the ring beside the weights, re-laid out per call into 64-row
// pieces (gated_dy_tiles, an extra N D read and write): a ring of two 48 KB
// stages, x, the dh tiles (single-buffered: one more barrier a chunk) and
// the stash take 224 KB. The products read the weights K-major only, so W0
// and W1 (K = D for h, K = F for dx) and Wo^T (dg's B) come from a second
// re-laid copy (gated_bwd_tiles: Wo^T, then per 128 dx columns a W0^T and
// a W1^T piece, 3 F D bf16, 9.4 MB a layer at t5-v1.1-base, beside F3's
// copy whose up pieces F4 reads too); wgmma's transpose-B bit would have
// read one copy both ways, but its no-swizzle MN-major layout was not
// tried. Per chunk a block streams 36 pieces (dy 6, Wo^T 6, up 12, dx 12 at
// D 768): the dg products wait for a dy stage and a Wo^T stage together.
// At N 3000 (47 row blocks) the hidden splits over blocks with fp32
// partials of dx (gated_bwd_reduce, in order). 248 registers, no spills.
// It replaced a WMMA design (8 warps per 32 rows, three accumulators):
// 6.9401 -> 1.4552 ms at N 16800 and 1.5342 -> 0.4298 at N 3000, rate 0.1
// (chip_phases.py phase 3i, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
// Both F3 and F4 run at the rate F1's stream found (about 3.5 TB/s of
// weights from L2 over the card).
//
// F2, bf16 (ffn_bwd_tc<DU>): dx, db1 and db2 of F1, 6 N D F FLOPs (0.40 ms
// at N 28000, D 768, F 3072). F4's block with one up-product: 64 rows, two
// warpgroups, dx's fp32 accumulator (64 x D) in their registers, x
// resident in shared memory, dy re-laid per call into 64-row pieces
// (ffn_bwd_dy_tiles, which also writes each 64-row block's fp32 column
// sums of dy: db2's partial row) and streamed through the ring beside the
// weights. Per 64-wide hidden chunk: dh = dy . W2[:, chunk] on wgmma m64n32
// (32 columns a warpgroup), the dropout (global index n F + f), the fp32
// dh parked in the per-thread stash; h = x . W1[chunk]^T; on the
// accumulator registers ds = dh act'(h + b1) in fp32, rounded to bf16 into
// a double-buffered 64 x 64 tile (one barrier a chunk), and its column
// sums: shuffles over the 16 rows of a warp, then the four warps of the
// column's warpgroup in order, written once per (row block, chunk) into
// the block's db1 partial row (each split owns its chunks' columns; no
// atomics); then dx += ds . W1[chunk, :] on m64n64 per 128 dx columns.
// Every weight comes from F1's re-laid copy (ffn_w_tiles): h from its up
// pieces as F1's fc1, and dh's and dx's B operands, W2[:, chunk] and
// W1[chunk, :], from its fc2 and up pieces read MN-major (wgmma's
// transpose-B bit, no swizzle), so F2 needs no second copy. Per chunk a
// block streams 24 pieces at D 768 (dy 6, fc2 6, up 6 for h and again 6
// for dx). At N 3000 and below the hidden splits over blocks (f1_splits'
// rule) with fp32 partials of dx (ffn_bwd_reduce, in order);
// ffn_bias_reduce sums the bias partial rows in block order. Rows past N
// are zero in x's tile and in dy's pieces, so their ds is 0 and the sums
// need no mask. Shared memory at D 768: x 96 KB, the ds tiles 16, the
// stash 16, the column sums 2, a ring of two 48 KB stages: 226 KB. 255
// registers at DU 6, no spills. Tried first: F4's second re-laid copy
// (W2^T and W1^T, K-major, 4.7 MB a layer), which ran no faster than the
// transpose-B reads that replaced it. fp32 keeps ffn_bwd_f32 (plain FMA,
// 16 rows a block): fp32 tensor-core paths are TF32 and would break fp32
// parity. It replaced a WMMA design (8 warps per 32 rows reading 16 x 16
// fragments of W1 and W2 straight from global memory): 9.1060 -> 2.6921
// ms at N 28000 (gelu), 5.0809 -> 1.3026 at N 16800 (relu, rate 0.1) and
// 1.2428 -> 0.5183 at N 3000, still 6-7x the bound at the encoder rows:
// the weight stream holds it, as it holds F1, F3 and F4 (chip_phases.py
// phase 3j, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Three translation units, built in parallel: this file compiles F1's and
// F3's entry points, the weight re-lays and the fp32 forwards
// (VLPET_FFN_PART 0); ffn_f2.cu and ffn_f4.cu include it with
// VLPET_FFN_PART 1 and 2 and compile F2's and F4's entry points alone (the
// kernels in the anonymous namespace below are each TU's own).
#include "common.cuh"

#ifndef VLPET_FFN_PART
#define VLPET_FFN_PART 0
#endif

using namespace vlpet;

namespace {

__device__ __forceinline__ float act_fn(float h, int act) {
  if (act == 2) return fmaxf(h, 0.f);
  if (act == 0) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  const float c = 0.79788456080286536f;  // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// d act / d h, as vlpet_tpu/ops/ffn.py:_act_grad
__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == 2) return h > 0.f ? 1.f : 0.f;
  if (act == 0) {
    const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    const float pdf = 0.39894228040143268f * expf(-0.5f * h * h);
    return cdf + h * pdf;
  }
  const float c = 0.79788456080286536f;
  const float t = tanhf(c * (h + 0.044715f * h * h * h));
  const float dinner = c * (1.f + 3.f * 0.044715f * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * dinner;
}

// act_fn(h) and act_grad(h) with one erf or tanh for both
__device__ __forceinline__ void act_and_grad(float h, int act, float& a,
                                             float& da) {
  if (act == 2) {
    a = fmaxf(h, 0.f);
    da = h > 0.f ? 1.f : 0.f;
  } else if (act == 0) {
    const float e = erff(h * 0.70710678118654752f);
    a = 0.5f * h * (1.f + e);
    da = 0.5f * (1.f + e) + h * (0.39894228040143268f * expf(-0.5f * h * h));
  } else {
    const float c = 0.79788456080286536f;
    const float t = tanhf(c * (h + 0.044715f * h * h * h));
    const float dinner = c * (1.f + 3.f * 0.044715f * h * h);
    a = 0.5f * h * (1.f + t);
    da = 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * dinner;
  }
}

// ------------------------------------------------- F1, bf16 (tensor cores)
// F1 on the tensor cores (header). A block takes 64 rows of x (chunk-major
// in shared memory, common.cuh), one range of 64-wide hidden chunks (its
// split) and DU 128-column pieces of y (all of D up to D 768). Per chunk c
// the weights arrive as 16 KB pieces of wt (ffn_w_tiles): D / 128 fc1
// pieces (W1 rows 64 c .. 64 c + 64, columns 128 kp .. 128 kp + 128) and
// the block's fc2 pieces (W2 rows 128 dp .. 128 dp + 128, columns 64 c ..
// 64 c + 64), P neighbouring pieces a ring stage, one TMA bulk copy each;
// every warp releases a stage on its ``empty`` mbarrier once its wgmma
// reads of it are done, and the warps take turns refilling. Two
// warpgroups: warpgroup j computes hidden columns 32 j .. 32 j + 32 of the
// chunk (wgmma m64n32k16 over D from x and the fc1 pieces), adds b1,
// applies the activation and the dropout in its accumulator registers and
// stores the bf16 hidden into a chunk-major 64 x 64 tile (double-buffered:
// one barrier a chunk); then y columns 64 j .. 64 j + 64 of every fc2
// piece += hidden . piece^T (wgmma m64n64k16), 32 fp32 registers a piece.
constexpr int kFc = 64;            // hidden chunk width
constexpr int kF1Rows = 64;        // rows a block (the wgmma M)
constexpr int kF1Threads = 256;    // two warpgroups
constexpr int kPiece = 8192;       // bf16 elements of a weight piece
constexpr uint32_t kPieceBytes = kPiece * 2;
constexpr int kF1MaxStages = 8;
constexpr int kF1MaxDu = 6;        // 192 accumulator registers a thread

// fc2 pieces (128 y columns each) a block: all D / 128 up to 6, else the
// fewest a group of blockIdx.z that keeps under 6 (D 896 and 1024: 4)
int f1_du(int D) {
  const int pieces = D / 128;
  const int groups = (pieces + kF1MaxDu - 1) / kF1MaxDu;
  return (pieces + groups - 1) / groups;
}

// shared memory besides the ring: x, two 64 x 64 bf16 hidden tiles (F1,
// F3 and F2: one tile, double-buffered; F4: dh0 and dh1) and, in the
// backwards, the fp32 stash of 64 x 64 (F2's dh, F4's dg); the barriers
size_t tc_fixed_smem(int D, bool bwd) {
  return (size_t)kF1Rows * D * 2 + 2 * kF1Rows * kFc * 2 +
         (bwd ? (size_t)kF1Rows * kFc * 4 : 0) + 2 * kF1MaxStages * 8;
}

// ring stages of ``pieces`` 16 KB pieces that fit beside ``fixed`` bytes
int tc_stages(size_t fixed, int pieces) {
  const long long fit = (232448 - (long long)fixed) /
                        ((long long)pieces * kPieceBytes);
  return (int)(fit < kF1MaxStages ? fit : kF1MaxStages);
}

// pieces a ring stage takes (one bulk copy): the most that leave two
// stages in the ring. A block's bulk copies complete about one at a time,
// each in about the same time up to ~48 KB, so fewer, larger copies stream
// the weights faster (3 pieces, 48 KB, at D 768). It divides the D / 128
// pieces of an up-product (and of dy) and the du pieces of y's (or dx's)
// columns of a chunk, so that a copy is one contiguous run of its buffer.
int tc_pieces(int D, int du, size_t fixed) {
  for (int p = du; p > 1; --p)
    if ((D / 128) % p == 0 && du % p == 0 && tc_stages(fixed, p) >= 2)
      return p;
  return 1;
}

// wt: for each hidden chunk c (of F / 64), D / 128 fc1 pieces then D / 128
// fc2 pieces of kPiece bf16 each. fc1 piece (c, kp): W1 rows 64 c + r,
// columns 128 kp + 8 kc .. + 8, chunk-major [16][64]; fc2 piece (c, dp):
// W2 rows 128 dp + r, columns 64 c + 8 fc .. + 8, chunk-major [8][128].
// One 16-byte chunk a thread, neighbouring threads along a source row.
__global__ void ffn_w_tiles(const bf16* __restrict__ w1,
                            const bf16* __restrict__ w2,
                            bf16* __restrict__ wt, int D, int F,
                            long long items) {
  const int KP = D / 128;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long piece = i >> 10;
    const int j = (int)(i & 1023);
    const int c = (int)(piece / (2 * KP)), k = (int)(piece % (2 * KP));
    const bf16* src;
    int dst;
    if (k < KP) {
      const int r = j >> 4, kc = j & 15;
      src = w1 + (size_t)(c * kFc + r) * D + k * 128 + kc * 8;
      dst = (kc * 64 + r) * 8;
    } else {
      const int r = j >> 3, fc = j & 7;
      src = w2 + (size_t)((k - KP) * 128 + r) * F + c * kFc + fc * 8;
      dst = (fc * 128 + r) * 8;
    }
    *reinterpret_cast<uint4*>(wt + piece * kPiece + dst) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// gt, F3's weights (and F4's up pieces): for each hidden chunk c, the two
// sets' D / 128 up pieces, then D / 128 Wo pieces. Up piece (c, s, kp): row
// r is W0's (r / 8 even) or W1's (odd) row f = 64 c + 32 (r / 32) + 16 s +
// 8 ((r / 16) % 2) + r % 8, columns 128 kp + 8 kc .. + 8, chunk-major
// [16][64]: warpgroup j's m64n32 over rows 32 j .. 32 j + 32 gives h0 (n8
// tiles 0 and 2) and h1 (tiles 1 and 3) of chunk columns 32 j + 16 s ..
// + 16. Wo piece (c, dp): as ffn_w_tiles' fc2 pieces.
__global__ void gated_w_tiles(const bf16* __restrict__ w0,
                              const bf16* __restrict__ w1,
                              const bf16* __restrict__ wo,
                              bf16* __restrict__ gt, int D, int F,
                              long long items) {
  const int KP = D / 128;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long piece = i >> 10;
    const int j = (int)(i & 1023);
    const int c = (int)(piece / (3 * KP)), k = (int)(piece % (3 * KP));
    const bf16* src;
    int dst;
    if (k < 2 * KP) {
      const int s = k / KP, kp = k % KP, r = j >> 4, kc = j & 15;
      const int f = c * kFc + 32 * (r >> 5) + 16 * s + 8 * ((r >> 4) & 1) +
                    (r & 7);
      src = ((r >> 3) & 1 ? w1 : w0) + (size_t)f * D + kp * 128 + kc * 8;
      dst = (kc * 64 + r) * 8;
    } else {
      const int r = j >> 3, fc = j & 7;
      src = wo + (size_t)((k - 2 * KP) * 128 + r) * F + c * kFc + fc * 8;
      dst = (fc * 128 + r) * 8;
    }
    *reinterpret_cast<uint4*>(gt + piece * kPiece + dst) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// bt, the rest of F4's weights: for each hidden chunk c, D / 128 pieces of
// Wo^T (dg's B: rows f = 64 c + r, columns 128 kp + 8 kc .. + 8,
// chunk-major [16][64]), then for each 128 dx columns dp a W0^T and a W1^T
// piece (rows d = 128 dp + r, columns 64 c + 8 fc .. + 8, chunk-major
// [8][128]). Transposing gathers: one 16-byte chunk a thread, eight
// strided reads, neighbouring threads on neighbouring source columns.
__global__ void gated_bwd_tiles(const bf16* __restrict__ w0,
                                const bf16* __restrict__ w1,
                                const bf16* __restrict__ wo,
                                bf16* __restrict__ bt, int D, int F,
                                long long items) {
  const int KP = D / 128;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long piece = i >> 10;
    const int j = (int)(i & 1023);
    const int c = (int)(piece / (3 * KP)), k = (int)(piece % (3 * KP));
    const bf16* src;
    size_t stride;
    int dst;
    if (k < KP) {
      const int r = j & 63, kc = j >> 6;
      src = wo + (size_t)(k * 128 + kc * 8) * F + c * kFc + r;
      stride = F;
      dst = (kc * 64 + r) * 8;
    } else {
      const int dp = (k - KP) >> 1, r = j & 127, fc = j >> 7;
      src = ((k - KP) & 1 ? w1 : w0) + (size_t)(c * kFc + fc * 8) * D +
            dp * 128 + r;
      stride = D;
      dst = (fc * 128 + r) * 8;
    }
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e * stride];
    *reinterpret_cast<uint4*>(bt + piece * kPiece + dst) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// dy (N, D) into 64-row blocks of D / 128 pieces, each chunk-major
// [16][64] as x in shared memory, zeros past N: F4 streams it beside the
// weights. Thread pairs take the two 16-byte chunks of a 32-byte sector.
__global__ void gated_dy_tiles(const bf16* __restrict__ dy,
                               bf16* __restrict__ dyt, int N, int D,
                               long long items) {
  const int KP = D / 128;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long piece = i >> 10;
    const int j = (int)(i & 1023);
    const int pr = j >> 1, r = pr & 63, kc = ((pr >> 6) << 1) | (j & 1);
    const long long n = piece / KP * kF1Rows + r;
    const int kp = (int)(piece % KP);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N)
      v = *reinterpret_cast<const uint4*>(dy + n * D + kp * 128 + kc * 8);
    *reinterpret_cast<uint4*>(dyt + piece * kPiece + (kc * 64 + r) * 8) = v;
  }
}

// F2's dy re-lay: dy into dyt as gated_dy_tiles lays it out, and each
// 64-row block's fp32 column sums of dy (zeros past N) into its bias
// partial row, bias_part[block][F + d] (db2's share of the block). One
// thread a 64-row block and 16-byte column chunk, down the block's rows;
// neighbouring threads on neighbouring chunks of a row.
__global__ void ffn_bwd_dy_tiles(const bf16* __restrict__ dy,
                                 bf16* __restrict__ dyt,
                                 float* __restrict__ bias_part, int N, int D,
                                 int F, long long items) {
  const int words = D / 8;  // 16-byte chunks of a row
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long rb = i / words;
    const int w = (int)(i - rb * words);
    bf16* dst = dyt + (rb * (D / 128) + (w >> 4)) * kPiece + (w & 15) * 64 * 8;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int r = 0; r < kF1Rows; ++r) {
      const long long n = rb * kF1Rows + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) v = *reinterpret_cast<const uint4*>(dy + n * D + w * 8);
      *reinterpret_cast<uint4*>(dst + r * 8) = v;
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += __bfloat162float(e[k]);
    }
    float4* o = reinterpret_cast<float4*>(bias_part + rb * (F + D) + F + w * 8);
    o[0] = make_float4(s[0], s[1], s[2], s[3]);
    o[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// d (+)= A . B^T, m64n64k16, A K-major in shared memory, B K-major (TB 0)
// or MN-major (TB 1, as wgmma_m64n32's); d[4 nt .. 4 nt + 4] is n8 tile nt
// in mma.sync's C layout (wgmma_m64n32)
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// The tensor-core forward of F1 (GATED false) and F3 (GATED true). part:
// [S][N][D] fp32 partials of y when the hidden is split (S > 1; NULL for
// one split, which writes y itself). A ring stage holds P pieces
// (tc_pieces), one bulk copy. wt: F1's ffn_w_tiles or F3's gated_w_tiles;
// F3 has no biases (b1, b2 unread).
template <int DU, bool GATED>
__device__ __forceinline__ void fwd_tc(
    const bf16* __restrict__ x, const bf16* __restrict__ wt,
    const float* __restrict__ b1, const float* __restrict__ b2,
    bf16* __restrict__ y, float* __restrict__ part, int N, int D, int F,
    int cps, int stages, int P, int act, DropArgs dr) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // chunk-major [D / 8][64]
  bf16* hs = xs + kF1Rows * D;  // 2 x chunk-major [8][64]: the hidden
  bf16* ring = hs + 2 * kF1Rows * kFc;  // [stages][P][kPiece]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)stages * P * kPiece);
  uint64_t* empty = full + kF1MaxStages;

  constexpr int kSets = GATED ? 2 : 1;  // up-products a chunk
  const int KP = D / 128;  // pieces of an up-product
  const int UP = kSets * KP;
  const int n0 = blockIdx.x * kF1Rows;
  const int c0 = blockIdx.y * cps;
  const int c1 = min(c0 + cps, F / kFc);
  const int u0 = blockIdx.z * DU;  // the block's first fc2 piece
  const int du = min(DU, KP - u0);
  const int per_chunk = (UP + du) / P;  // ring stages a chunk takes
  const int total = (c1 - c0) * per_chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = seed_of(dr);
  const uint32_t stage_bytes = (uint32_t)P * kPieceBytes;

  // stage q of the block's sequence into its ring slot (one thread): P
  // pieces that lie next to each other in wt
  auto issue = [&](int q) {
    const int c = c0 + q / per_chunk, i = (q % per_chunk) * P;
    const int tile = c * (UP + KP) + (i < UP ? i : UP + u0 + (i - UP));
    const int st = q % stages;
    mbar_expect_tx(full + st, stage_bytes);
    bulk_copy(ring + (size_t)st * P * kPiece, wt + (size_t)tile * kPiece,
              stage_bytes, full + st);
  };
  auto slot = [&](int q) {  // wait for stage q; its pieces
    mbar_wait(full + q % stages, (q / stages) & 1);
    return ring + (size_t)(q % stages) * P * kPiece;
  };
  // this warp's wgmma reads of stage q are done: release its slot; once
  // all eight warps have, lane 0 of warp (q + stages) % 8 refills it with
  // stage q + stages (a bulk copy holds its issuing thread a while: the
  // warps take turns)
  auto release = [&](int q) {
    if (lane == 0) mbar_arrive(empty + q % stages);
    if (lane == 0 && warp == (q + stages) % 8 && q + stages < total) {
      mbar_wait(empty + q % stages, (q / stages) & 1);
      issue(q + stages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kF1Threads / 32);
    }
    mbar_init_fence();
  }
  cp_rows(xs, x, n0, kF1Rows, N, D, kF1Threads);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (lane == 0)
    for (int q = warp; q < min(stages, total); q += 8) issue(q);
  cp_async_wait<0>();
  fence_proxy_async();  // x (cp.async) is read by wgmma
  __syncthreads();

  // the accumulators are only ever written by wgmma (the first product of
  // a sum does not add: scale-d 0), so ptxas keeps the products in flight
  // across stages instead of serialising them
  float acc[DU][32];
  float h[4][4];
  int q = 0;
  for (int c = c0; c < c1; ++c) {
    bf16* hb = hs + (c & 1) * kF1Rows * kFc;  // this chunk's hidden tile
#pragma unroll
    for (int set = 0; set < kSets; ++set) {
      // fc1 (F3: the set's up pieces): this warpgroup's 64 x 32 over all
      // of D
      for (int kq = 0; kq < KP / P; ++kq, ++q) {
        const bf16* W = slot(q);
        wgmma_fence();
        for (int p = 0; p < P; ++p) {
          const int kp = kq * P + p;
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int kc = kp * 8 + s;
            wgmma_m64n32(
                h, wg_desc(xs + 2 * kc * kF1Rows * 8, kF1Rows * 16, 128),
                wg_desc(W + p * kPiece + (2 * s * 64 + 32 * wg) * 8, 64 * 16,
                        128),
                kc > 0);
          }
        }
        wgmma_commit();
        if (kq > 0) {
          wgmma_wait<1>();
          release(q - 1);
        }
      }
      wgmma_wait<0>();
      release(q - 1);

      // F1: + b1 and the activation; F3: act(h0) * h1 (n8 tiles 2 j and
      // 2 j + 1 hold h0 and h1 of the same 8 columns). Then the dropout
      // (global index n F + f) in fp32, rounded to bf16 into the hidden
      // tile
#pragma unroll
      for (int j = 0; j < (GATED ? 2 : 4); ++j) {
        const int fl = GATED ? 32 * wg + 16 * set + 8 * j + 2 * t
                             : 32 * wg + 8 * j + 2 * t;  // chunk column
        const int f = c * kFc + fl;
        float2 bb = make_float2(0.f, 0.f);
        if constexpr (!GATED) bb = *reinterpret_cast<const float2*>(b1 + f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wr + g + 8 * r;
          float v0, v1;
          if constexpr (GATED) {
            v0 = act_fn(h[2 * j][2 * r], act) * h[2 * j + 1][2 * r];
            v1 = act_fn(h[2 * j][2 * r + 1], act) * h[2 * j + 1][2 * r + 1];
          } else {
            v0 = act_fn(h[j][2 * r] + bb.x, act);
            v1 = act_fn(h[j][2 * r + 1] + bb.y, act);
          }
          if (dr.on) {
            const uint32_t idx = drop_index(dr, n0 + row, f);
            v0 = drop_elem(v0, idx, seed, dr.thr, dr.scale);
            v1 = drop_elem(v1, idx + 1u, seed, dr.thr, dr.scale);
          }
          *reinterpret_cast<uint32_t*>(hb + ((fl >> 3) * kF1Rows + row) * 8 +
                                       (fl & 7)) = pack_bf16(v0, v1);
        }
      }
    }
    fence_proxy_async();  // the hidden is read by wgmma
    __syncthreads();  // both halves written (the other tile's readers done)

    // fc2: y columns 128 (u0 + u) + 64 wg .. + 64 += hidden . W2 piece^T
    const bf16* W = nullptr;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      if (u < du) {
        const int p = u % P;
        if (p == 0) {
          W = slot(q);
          wgmma_fence();
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64(acc[u],
                       wg_desc(hb + 2 * s * kF1Rows * 8, kF1Rows * 16, 128),
                       wg_desc(W + p * kPiece + (2 * s * 128 + 64 * wg) * 8,
                               128 * 16, 128),
                       c > c0 || s > 0);
        if (p == P - 1) {
          wgmma_commit();
          if (u >= P) {
            wgmma_wait<1>();
            release(q - 1);
          }
          ++q;
        }
      }
    }
    wgmma_wait<0>();
    release(q - 1);
  }

  // one split: y = bf16(acc + b2); else the split's fp32 partial
#pragma unroll
  for (int u = 0; u < DU; ++u) {
    if (u >= du) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (u0 + u) * 128 + 64 * wg + 8 * nt + 2 * t;
      const float2 bb = GATED || part != nullptr
                            ? make_float2(0.f, 0.f)
                            : *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + wr + g + 8 * r;
        if (n >= N) continue;
        const float v0 = acc[u][4 * nt + 2 * r];
        const float v1 = acc[u][4 * nt + 2 * r + 1];
        if (part == nullptr)
          *reinterpret_cast<uint32_t*>(y + (size_t)n * D + col) =
              pack_bf16(v0 + bb.x, v1 + bb.y);
        else
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.y * N + n) * D + col) =
              make_float2(v0, v1);
      }
    }
  }
}

template <int DU>
__global__ void __launch_bounds__(kF1Threads, 1)
ffn_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wt,
           const float* __restrict__ b1, const float* __restrict__ b2,
           bf16* __restrict__ y, float* __restrict__ part, int N, int D,
           int F, int cps, int stages, int P, int act, DropArgs dr) {
  fwd_tc<DU, false>(x, wt, b1, b2, y, part, N, D, F, cps, stages, P, act,
                    dr);
}

template <int DU>
__global__ void __launch_bounds__(kF1Threads, 1)
gated_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wt,
             const float* __restrict__ b1, const float* __restrict__ b2,
             bf16* __restrict__ y, float* __restrict__ part, int N, int D,
             int F, int cps, int stages, int P, int act, DropArgs dr) {
  fwd_tc<DU, true>(x, wt, b1, b2, y, part, N, D, F, cps, stages, P, act, dr);
}

// out = bf16(sum of the S partials in split order (+ b, when not NULL)),
// two columns a thread
__device__ __forceinline__ void reduce_splits(const float* __restrict__ part,
                                              const float* __restrict__ b,
                                              bf16* __restrict__ out, int N,
                                              int D, int S) {
  const long long pairs = (long long)N * D / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;
    const int col = (int)(e % D);
    const float2 a = b == nullptr ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(b + col);
    float2 sum = make_float2(0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float2 p =
          *reinterpret_cast<const float2*>(part + (size_t)s * N * D + e);
      sum.x += p.x;
      sum.y += p.y;
    }
    *reinterpret_cast<uint32_t*>(out + e) =
        pack_bf16(sum.x + a.x, sum.y + a.y);
  }
}

// one kernel name per path, for the profile's families (F1, F2, F3, F4)
__global__ void ffn_fwd_reduce(const float* __restrict__ part,
                               const float* __restrict__ b,
                               bf16* __restrict__ out, int N, int D, int S) {
  reduce_splits(part, b, out, N, D, S);
}

__global__ void gated_fwd_reduce(const float* __restrict__ part,
                                 const float* __restrict__ b,
                                 bf16* __restrict__ out, int N, int D, int S) {
  reduce_splits(part, b, out, N, D, S);
}

__global__ void ffn_bwd_reduce(const float* __restrict__ part,
                               const float* __restrict__ b,
                               bf16* __restrict__ out, int N, int D, int S) {
  reduce_splits(part, b, out, N, D, S);
}

__global__ void gated_bwd_reduce(const float* __restrict__ part,
                                 const float* __restrict__ b,
                                 bf16* __restrict__ out, int N, int D, int S) {
  reduce_splits(part, b, out, N, D, S);
}

// db1[f] = sum_g partial[g][f], db2[c] = sum_g partial[g][F + c], in order
__global__ void ffn_bias_reduce(const float* __restrict__ partial, int G,
                                int F, int D, float* __restrict__ db1,
                                float* __restrict__ db2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= F + D) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[(size_t)g * (F + D) + t];
  if (t < F)
    db1[t] = s;
  else
    db2[t - F] = s;
}

int launch_reduce(bool fwd, bool gated, const void* part, const void* b,
                  void* out, int N, int D, int S, cudaStream_t st) {
  const long long pairs = (long long)N * D / 2;
  const long long want = (pairs + 255) / 256;
  const unsigned blocks = (unsigned)(want > 8192 ? 8192 : want);
  auto kern = gated ? (fwd ? &gated_fwd_reduce : &gated_bwd_reduce)
                    : (fwd ? &ffn_fwd_reduce : &ffn_bwd_reduce);
  kern<<<blocks, 256, 0, st>>>((const float*)part, (const float*)b,
                               (bf16*)out, N, D, S);
  return (int)cudaGetLastError();
}

// F1 (GATED false) or F3 over S hidden splits, y's columns over
// ceil(D / 128 / DU) groups of blocks
template <int DU, bool GATED>
int launch_fwd_tc(const void* x, const void* wt, const void* b1,
                  const void* b2, void* y, void* part, int N, int D, int F,
                  int S, int act, DropArgs dr, cudaStream_t st) {
  const int groups = (D / 128 + DU - 1) / DU;
  const size_t fixed = tc_fixed_smem(D, false);
  const int P = tc_pieces(D, DU, fixed);  // divides every group's pieces
  const int stages = tc_stages(fixed, P);
  const size_t smem = fixed + (size_t)stages * P * kPieceBytes;
  auto kern = GATED ? &gated_fwd_tc<DU> : &ffn_fwd_tc<DU>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = F / kFc;
  const int cps = (chunks + S - 1) / S;
  kern<<<dim3((N + kF1Rows - 1) / kF1Rows, S, groups), kF1Threads, smem,
         st>>>((const bf16*)x, (const bf16*)wt, (const float*)b1,
               (const float*)b2, (bf16*)y, S > 1 ? (float*)part : nullptr, N,
               D, F, cps, stages, P, act, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return launch_reduce(true, GATED, part, GATED ? nullptr : b2, y, N, D, S,
                       st);
}

// F4 on the tensor cores (header). A block takes 64 rows of x (chunk-major
// in shared memory), one range of 64-wide hidden chunks (its split) and DU
// 128-column pieces of dx. Per chunk c the ring brings, P pieces a stage:
// the block's dy pieces and the chunk's Wo^T pieces in turn (dg: the
// products wait for one stage of each), the chunk's 2 D / 128 up pieces of
// gt (h0 and h1, two sets), then the block's dx pieces of bt (a W0^T and a
// W1^T piece per 128 dx columns). part: [S][N][D] fp32 partials of dx when
// the hidden is split (S > 1), else NULL.
template <int DU>
__global__ void __launch_bounds__(kF1Threads, 1)
gated_bwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ dyt,
             const bf16* __restrict__ gt, const bf16* __restrict__ bt,
             bf16* __restrict__ dx, float* __restrict__ part, int N, int D,
             int F, int cps, int stages, int P, int act, DropArgs dr) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // chunk-major [D / 8][64]
  bf16* d0s = xs + kF1Rows * D;        // dh0, chunk-major [8][64]
  bf16* d1s = d0s + kF1Rows * kFc;     // dh1
  // dg after the dropout, each thread's own 16 values: [8][256] float2
  float2* stash = reinterpret_cast<float2*>(d1s + kF1Rows * kFc);
  bf16* ring = reinterpret_cast<bf16*>(stash + 8 * kF1Threads);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)stages * P * kPiece);
  uint64_t* empty = full + kF1MaxStages;

  const int KP = D / 128;
  const int n0 = blockIdx.x * kF1Rows;
  const int c0 = blockIdx.y * cps;
  const int c1 = min(c0 + cps, F / kFc);
  const int u0 = blockIdx.z * DU;  // the block's first 128 dx columns
  const int du = min(DU, KP - u0);
  const int dgs = 2 * KP / P;          // a chunk's stages of dy and Wo^T
  const int ups = dgs + 2 * KP / P;    // ... then of the up pieces
  const int per_chunk = ups + 2 * du / P;  // ... then of the dx pieces
  const int total = (c1 - c0) * per_chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = seed_of(dr);
  const uint32_t stage_bytes = (uint32_t)P * kPieceBytes;
  const size_t wchunk = (size_t)3 * KP * kPiece;  // a chunk of gt or bt

  auto issue = [&](int q) {
    const int c = c0 + q / per_chunk, i = q % per_chunk;
    const bf16* src;
    if (i < dgs) {
      const int kp = (i >> 1) * P;
      src = (i & 1) ? bt + c * wchunk + (size_t)kp * kPiece
                    : dyt + ((size_t)blockIdx.x * KP + kp) * kPiece;
    } else if (i < ups) {
      src = gt + c * wchunk + (size_t)(i - dgs) * P * kPiece;
    } else {
      src = bt + c * wchunk + (size_t)(KP + 2 * u0 + (i - ups) * P) * kPiece;
    }
    const int st = q % stages;
    mbar_expect_tx(full + st, stage_bytes);
    bulk_copy(ring + (size_t)st * P * kPiece, src, stage_bytes, full + st);
  };
  auto slot = [&](int q) {
    mbar_wait(full + q % stages, (q / stages) & 1);
    return ring + (size_t)(q % stages) * P * kPiece;
  };
  auto release = [&](int q) {  // as fwd_tc's
    if (lane == 0) mbar_arrive(empty + q % stages);
    if (lane == 0 && warp == (q + stages) % 8 && q + stages < total) {
      mbar_wait(empty + q % stages, (q / stages) & 1);
      issue(q + stages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kF1Threads / 32);
    }
    mbar_init_fence();
  }
  cp_rows(xs, x, n0, kF1Rows, N, D, kF1Threads);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (lane == 0)
    for (int q = warp; q < min(stages, total); q += 8) issue(q);
  cp_async_wait<0>();
  fence_proxy_async();  // x (cp.async) is read by wgmma
  __syncthreads();

  float acc[DU][32];
  float h[4][4];  // dg, then each set's h0 and h1
  int q = 0;
  for (int c = c0; c < c1; ++c) {
    // dg = dy . Wo[:, chunk]: this warpgroup's columns 32 wg .. + 32. With
    // two ring stages a dy and a Wo^T stage fill the ring: the pair is
    // released before the next one is waited for
    for (int kq = 0; kq < KP / P; ++kq, q += 2) {
      const bf16* A = slot(q);
      const bf16* W = slot(q + 1);
      wgmma_fence();
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
          wgmma_m64n32(
              h, wg_desc(A + p * kPiece + 2 * s * kF1Rows * 8, kF1Rows * 16,
                         128),
              wg_desc(W + p * kPiece + (2 * s * 64 + 32 * wg) * 8, 64 * 16,
                      128),
              kq > 0 || p > 0 || s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      release(q);
      release(q + 1);
    }
    // the dropout on dg (global index n F + f), parked in the stash
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = c * kFc + 32 * wg + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(h[nt][2 * r], h[nt][2 * r + 1]);
        if (dr.on) {
          const uint32_t idx = drop_index(dr, n0 + wr + g + 8 * r, f);
          v.x = drop_elem(v.x, idx, seed, dr.thr, dr.scale);
          v.y = drop_elem(v.y, idx + 1u, seed, dr.thr, dr.scale);
        }
        stash[(nt * 2 + r) * kF1Threads + tid] = v;
      }
    }
#pragma unroll
    for (int set = 0; set < 2; ++set) {
      // h0, h1 of this warpgroup's chunk columns 32 wg + 16 set .. + 16
      for (int kq = 0; kq < KP / P; ++kq, ++q) {
        const bf16* W = slot(q);
        wgmma_fence();
        for (int p = 0; p < P; ++p) {
          const int kp = kq * P + p;
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int kc = kp * 8 + s;
            wgmma_m64n32(
                h, wg_desc(xs + 2 * kc * kF1Rows * 8, kF1Rows * 16, 128),
                wg_desc(W + p * kPiece + (2 * s * 64 + 32 * wg) * 8, 64 * 16,
                        128),
                kc > 0);
          }
        }
        wgmma_commit();
        if (kq > 0) {
          wgmma_wait<1>();
          release(q - 1);
        }
      }
      wgmma_wait<0>();
      release(q - 1);
      // the last chunk's dx products are done with dh0 and dh1
      if (set == 0 && c > c0) __syncthreads();
      // dh0 = dg h1 act'(h0), dh1 = dg act(h0), each rounded to bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int fl = 32 * wg + 16 * set + 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wr + g + 8 * r;
          const float2 dg = stash[((2 * set + j) * 2 + r) * kF1Threads + tid];
          float a0, da0, a1, da1;
          act_and_grad(h[2 * j][2 * r], act, a0, da0);
          act_and_grad(h[2 * j][2 * r + 1], act, a1, da1);
          const int at = ((fl >> 3) * kF1Rows + row) * 8 + (fl & 7);
          *reinterpret_cast<uint32_t*>(d0s + at) =
              pack_bf16(dg.x * h[2 * j + 1][2 * r] * da0,
                        dg.y * h[2 * j + 1][2 * r + 1] * da1);
          *reinterpret_cast<uint32_t*>(d1s + at) =
              pack_bf16(dg.x * a0, dg.y * a1);
        }
      }
    }
    fence_proxy_async();  // dh0 and dh1 are read by wgmma
    __syncthreads();

    // dx columns 128 (u0 + i / 2) + 64 wg .. + 64 += dh0 . W0^T piece^T
    // (i even) or dh1 . W1^T piece^T (i odd)
    const bf16* W = nullptr;
#pragma unroll
    for (int i = 0; i < 2 * DU; ++i) {
      if (i < 2 * du) {
        const int p = i % P;
        if (p == 0) {
          W = slot(q);
          wgmma_fence();
        }
        const bf16* A = (i & 1) ? d1s : d0s;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64(acc[i >> 1],
                       wg_desc(A + 2 * s * kF1Rows * 8, kF1Rows * 16, 128),
                       wg_desc(W + p * kPiece + (2 * s * 128 + 64 * wg) * 8,
                               128 * 16, 128),
                       c > c0 || (i & 1) || s > 0);
        if (p == P - 1) {
          wgmma_commit();
          if (i >= P) {
            wgmma_wait<1>();
            release(q - 1);
          }
          ++q;
        }
      }
    }
    wgmma_wait<0>();
    release(q - 1);
  }

  // one split: dx = bf16(acc); else the split's fp32 partial
#pragma unroll
  for (int u = 0; u < DU; ++u) {
    if (u >= du) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (u0 + u) * 128 + 64 * wg + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + wr + g + 8 * r;
        if (n >= N) continue;
        const float v0 = acc[u][4 * nt + 2 * r];
        const float v1 = acc[u][4 * nt + 2 * r + 1];
        if (part == nullptr)
          *reinterpret_cast<uint32_t*>(dx + (size_t)n * D + col) =
              pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.y * N + n) * D + col) =
              make_float2(v0, v1);
      }
    }
  }
}

// dy re-laid out into dyt, then F4 over S hidden splits (and the reduce)
template <int DU>
int launch_f4_tc(const void* x, const void* dy, void* dyt, const void* gt,
                 const void* bt, void* dx, void* part, int N, int D, int F,
                 int S, int act, DropArgs dr, cudaStream_t st) {
  const int groups = (D / 128 + DU - 1) / DU;
  const size_t fixed = tc_fixed_smem(D, true);
  const int P = tc_pieces(D, DU, fixed);
  const int stages = tc_stages(fixed, P);
  const size_t smem = fixed + (size_t)stages * P * kPieceBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gated_bwd_tc<DU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (N + kF1Rows - 1) / kF1Rows;
  const long long items = (long long)rows * (D / 128) * 1024;
  const long long want = (items + 255) / 256;
  gated_dy_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0, st>>>(
      (const bf16*)dy, (bf16*)dyt, N, D, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = F / kFc;
  const int cps = (chunks + S - 1) / S;
  gated_bwd_tc<DU><<<dim3(rows, S, groups), kF1Threads, smem, st>>>(
      (const bf16*)x, (const bf16*)dyt, (const bf16*)gt, (const bf16*)bt,
      (bf16*)dx, S > 1 ? (float*)part : nullptr, N, D, F, cps, stages, P,
      act, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return launch_reduce(false, true, part, nullptr, dx, N, D, S, st);
}

// F2 on the tensor cores (header): F4's block with one up-product. A block
// takes 64 rows of x (chunk-major in shared memory), one range of 64-wide
// hidden chunks (its split) and DU 128-column pieces of dx. Per chunk c the
// ring brings, P pieces a stage, all of them from F1's wt but dy: the
// block's dy pieces and the chunk's fc2 pieces in turn (dh: the products
// wait for one stage of each), the chunk's D / 128 up pieces (h), then the
// block's dx pieces, the up pieces of its 128-column groups again (dx).
// dh and dx read their B operands, W2[:, chunk] and W1[chunk, :], from the
// fc2 and up pieces MN-major (wgmma's transpose-B): no second copy. part:
// [S][N][D] fp32 partials of dx when the hidden is split (S > 1), else
// NULL. bias_part: [gridDim.x][F + D] fp32, the block's db1
// column sums (written here by the blocks of the first dx-column group,
// each split its own chunks) and db2's (ffn_bwd_dy_tiles).
constexpr int kF2ColFloats = 2 * (kF1Threads / 32) * 32;  // [2][8 warps][32]

template <int DU>
__global__ void __launch_bounds__(kF1Threads, 1)
ffn_bwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ dyt,
           const bf16* __restrict__ wt, const float* __restrict__ b1,
           bf16* __restrict__ dx,
           float* __restrict__ part, float* __restrict__ bias_part, int N,
           int D, int F, int cps, int stages, int P, int act, DropArgs dr) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // chunk-major [D / 8][64]
  bf16* dss = xs + kF1Rows * D;  // 2 x chunk-major [8][64]: bf16 ds
  // dh after the dropout, each thread's own 16 values: [8][256] float2
  float2* stash = reinterpret_cast<float2*>(dss + 2 * kF1Rows * kFc);
  // each warp's column sums of ds over its 16 rows, double-buffered
  float* cols = reinterpret_cast<float*>(stash + 8 * kF1Threads);
  bf16* ring = reinterpret_cast<bf16*>(cols + kF2ColFloats);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)stages * P * kPiece);
  uint64_t* empty = full + kF1MaxStages;

  const int KP = D / 128;
  const int n0 = blockIdx.x * kF1Rows;
  const int c0 = blockIdx.y * cps;
  const int c1 = min(c0 + cps, F / kFc);
  const int u0 = blockIdx.z * DU;  // the block's first 128 dx columns
  const int du = min(DU, KP - u0);
  const int dhs = 2 * KP / P;          // a chunk's stages of dy and fc2
  const int ups = dhs + KP / P;        // ... then of the up pieces
  const int per_chunk = ups + du / P;  // ... then of the dx pieces
  const int total = (c1 - c0) * per_chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t seed = seed_of(dr);
  const uint32_t stage_bytes = (uint32_t)P * kPieceBytes;
  const size_t wchunk = (size_t)2 * KP * kPiece;  // a chunk of wt

  auto issue = [&](int q) {
    const int c = c0 + q / per_chunk, i = q % per_chunk;
    const bf16* src;
    if (i < dhs) {
      const int kp = (i >> 1) * P;
      src = (i & 1) ? wt + c * wchunk + (size_t)(KP + kp) * kPiece
                    : dyt + ((size_t)blockIdx.x * KP + kp) * kPiece;
    } else if (i < ups) {
      src = wt + c * wchunk + (size_t)(i - dhs) * P * kPiece;
    } else {
      src = wt + c * wchunk + (size_t)(u0 + (i - ups) * P) * kPiece;
    }
    const int st = q % stages;
    mbar_expect_tx(full + st, stage_bytes);
    bulk_copy(ring + (size_t)st * P * kPiece, src, stage_bytes, full + st);
  };
  auto slot = [&](int q) {
    mbar_wait(full + q % stages, (q / stages) & 1);
    return ring + (size_t)(q % stages) * P * kPiece;
  };
  auto release = [&](int q) {  // as fwd_tc's
    if (lane == 0) mbar_arrive(empty + q % stages);
    if (lane == 0 && warp == (q + stages) % 8 && q + stages < total) {
      mbar_wait(empty + q % stages, (q / stages) & 1);
      issue(q + stages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kF1Threads / 32);
    }
    mbar_init_fence();
  }
  cp_rows(xs, x, n0, kF1Rows, N, D, kF1Threads);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (lane == 0)
    for (int q = warp; q < min(stages, total); q += 8) issue(q);
  cp_async_wait<0>();
  fence_proxy_async();  // x (cp.async) is read by wgmma
  __syncthreads();

  float acc[DU][32];
  float h[4][4];  // dh, then h
  int q = 0;
  for (int c = c0; c < c1; ++c) {
    // dh = dy . W2[:, chunk]: this warpgroup's columns 32 wg .. + 32 (as
    // F4's dg: the pair of stages is released before the next is waited
    // for). B MN-major from an fc2 piece, chunk-major [8][128]: a core
    // matrix is 8 of its rows (d, K) of one 16-byte chunk (8 f, N); the
    // next along K 128 bytes on, the next along N 2048
    for (int kq = 0; kq < KP / P; ++kq, q += 2) {
      const bf16* A = slot(q);
      const bf16* W = slot(q + 1);
      wgmma_fence();
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
          wgmma_m64n32<1>(
              h, wg_desc(A + p * kPiece + 2 * s * kF1Rows * 8, kF1Rows * 16,
                         128),
              wg_desc(W + p * kPiece + (4 * wg * 128 + 16 * s) * 8, 128,
                      128 * 16),
              kq > 0 || p > 0 || s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      release(q);
      release(q + 1);
    }
    // the dropout on dh (global index n F + f), parked in the stash
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = c * kFc + 32 * wg + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(h[nt][2 * r], h[nt][2 * r + 1]);
        if (dr.on) {
          const uint32_t idx = drop_index(dr, n0 + wr + g + 8 * r, f);
          v.x = drop_elem(v.x, idx, seed, dr.thr, dr.scale);
          v.y = drop_elem(v.y, idx + 1u, seed, dr.thr, dr.scale);
        }
        stash[(nt * 2 + r) * kF1Threads + tid] = v;
      }
    }
    // h = x . W1[chunk]^T (F1's fc1 over its up pieces)
    for (int kq = 0; kq < KP / P; ++kq, ++q) {
      const bf16* W = slot(q);
      wgmma_fence();
      for (int p = 0; p < P; ++p) {
        const int kp = kq * P + p;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int kc = kp * 8 + s;
          wgmma_m64n32(
              h, wg_desc(xs + 2 * kc * kF1Rows * 8, kF1Rows * 16, 128),
              wg_desc(W + p * kPiece + (2 * s * 64 + 32 * wg) * 8, 64 * 16,
                      128),
              kc > 0);
        }
      }
      wgmma_commit();
      if (kq > 0) {
        wgmma_wait<1>();
        release(q - 1);
      }
    }
    wgmma_wait<0>();
    release(q - 1);

    // ds = dh act'(h + b1) in fp32: rounded to bf16 into this chunk's tile
    // (double-buffered: the other chunk's readers are done), and its column
    // sums over the warp's 16 rows (lanes of one t: shuffles over g) into
    // the warp's row of cols
    bf16* dsb = dss + (c & 1) * kF1Rows * kFc;
    float* cs = cols + (c & 1) * (kF2ColFloats / 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int fl = 32 * wg + 8 * nt + 2 * t;  // chunk column
      const float2 bb = *reinterpret_cast<const float2*>(b1 + c * kFc + fl);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr + g + 8 * r;
        const float2 d = stash[(nt * 2 + r) * kF1Threads + tid];
        const float v0 = d.x * act_grad(h[nt][2 * r] + bb.x, act);
        const float v1 = d.y * act_grad(h[nt][2 * r + 1] + bb.y, act);
        s0 += v0;
        s1 += v1;
        *reinterpret_cast<uint32_t*>(dsb + ((fl >> 3) * kF1Rows + row) * 8 +
                                     (fl & 7)) = pack_bf16(v0, v1);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0)
        *reinterpret_cast<float2*>(cs + warp * 32 + 8 * nt + 2 * t) =
            make_float2(s0, s1);
    }
    fence_proxy_async();  // ds is read by wgmma
    __syncthreads();  // ds and the column sums written

    // dx columns 128 (u0 + u) + 64 wg .. + 64 += ds . W1[chunk, those]:
    // B MN-major from the up piece, chunk-major [16][64]: a core matrix is
    // 8 of its rows (f, K) of one 16-byte chunk (8 d, N); the next along K
    // 128 bytes on, the next along N 1024
    const bf16* W = nullptr;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      if (u < du) {
        const int p = u % P;
        if (p == 0) {
          W = slot(q);
          wgmma_fence();
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64<1>(
              acc[u], wg_desc(dsb + 2 * s * kF1Rows * 8, kF1Rows * 16, 128),
              wg_desc(W + p * kPiece + (8 * wg * 64 + 16 * s) * 8, 128,
                      64 * 16),
              c > c0 || s > 0);
        if (p == P - 1) {
          wgmma_commit();
          if (u >= P) {
            wgmma_wait<1>();
            release(q - 1);
          }
          ++q;
        }
      }
    }
    wgmma_wait<0>();
    release(q - 1);

    // db1 of the chunk's columns: the four warps of the column's
    // warpgroup, in order (the first dx-column group's blocks)
    if (blockIdx.z == 0 && tid < kFc) {
      const float* w4 = cs + (tid >> 5) * 4 * 32 + (tid & 31);
      bias_part[(size_t)blockIdx.x * (F + D) + c * kFc + tid] =
          ((w4[0] + w4[32]) + w4[64]) + w4[96];
    }
  }

  // one split: dx = bf16(acc); else the split's fp32 partial
#pragma unroll
  for (int u = 0; u < DU; ++u) {
    if (u >= du) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = (u0 + u) * 128 + 64 * wg + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + wr + g + 8 * r;
        if (n >= N) continue;
        const float v0 = acc[u][4 * nt + 2 * r];
        const float v1 = acc[u][4 * nt + 2 * r + 1];
        if (part == nullptr)
          *reinterpret_cast<uint32_t*>(dx + (size_t)n * D + col) =
              pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.y * N + n) * D + col) =
              make_float2(v0, v1);
      }
    }
  }
}

// dy re-laid out into dyt (and db2's partials), F2 over S hidden splits,
// the reduce of dx's partials, then the bias sums in block order
template <int DU>
int launch_f2_tc(const void* x, const void* dy, void* dyt, const void* wt,
                 const void* b1, void* dx, void* part,
                 void* bias_part, void* db1, void* db2, int N, int D, int F,
                 int S, int act, DropArgs dr, cudaStream_t st) {
  const int groups = (D / 128 + DU - 1) / DU;
  const size_t fixed = tc_fixed_smem(D, true) + kF2ColFloats * 4;
  const int P = tc_pieces(D, DU, fixed);
  const int stages = tc_stages(fixed, P);
  const size_t smem = fixed + (size_t)stages * P * kPieceBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_tc<DU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (N + kF1Rows - 1) / kF1Rows;
  const long long items = (long long)rows * (D / 8);
  const long long want = (items + 255) / 256;
  ffn_bwd_dy_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0, st>>>(
      (const bf16*)dy, (bf16*)dyt, (float*)bias_part, N, D, F, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = F / kFc;
  const int cps = (chunks + S - 1) / S;
  ffn_bwd_tc<DU><<<dim3(rows, S, groups), kF1Threads, smem, st>>>(
      (const bf16*)x, (const bf16*)dyt, (const bf16*)wt, (const float*)b1,
      (bf16*)dx, S > 1 ? (float*)part : nullptr,
      (float*)bias_part, N, D, F, cps, stages, P, act, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (S > 1) {
    const int e = launch_reduce(false, false, part, nullptr, dx, N, D, S, st);
    if (e != 0) return e;
  }
  ffn_bias_reduce<<<(F + D + 255) / 256, 256, 0, st>>>(
      (const float*)bias_part, rows, F, D, (float*)db1, (float*)db2);
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
            int F, int act, DropArgs dr) {
  extern __shared__ float fsm[];
  float* xs = fsm;               // [kFBM][D]
  float* hs = xs + kFBM * D;     // [kFBM][kFBF]
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x;
  const uint32_t seed = seed_of(dr);
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
    float a0 = act_fn(h0 + bb, act), a1 = act_fn(h1 + bb, act);
    if (dr.on) {
      const uint32_t i0 = drop_index(dr, n0 + hr, f0 + hc);
      a0 = drop_elem(a0, i0, seed, dr.thr, dr.scale);
      a1 = drop_elem(a1, i0 + 8u * dr.width, seed, dr.thr, dr.scale);
    }
    hs[hr * kFBF + hc] = a0;
    hs[(hr + 8) * kFBF + hc] = a1;
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

// partial: [gridDim.x][F + D] fp32, the block's db1 then db2 row sums
__global__ void __launch_bounds__(kFThreads)
ffn_bwd_f32(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, float* __restrict__ dx,
            float* __restrict__ partial, int N, int D, int F, int act,
            DropArgs dr) {
  extern __shared__ float fsm[];
  float* xs = fsm;               // [kFBM][D]
  float* dys = xs + kFBM * D;    // [kFBM][D]
  float* ds = dys + kFBM * D;    // [kFBM][kFBF]
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x;
  const uint32_t seed = seed_of(dr);
  float* prow = partial + (size_t)blockIdx.x * (F + D);
  for (int i = tid; i < kFBM * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int n = n0 + r;
    xs[i] = n < N ? x[(size_t)n * D + c] : 0.f;
    dys[i] = n < N ? dy[(size_t)n * D + c] : 0.f;
  }
  float xacc[kFBM][kFOut];
#pragma unroll
  for (int r = 0; r < kFBM; ++r)
#pragma unroll
    for (int c = 0; c < kFOut; ++c) xacc[r][c] = 0.f;
  __syncthreads();

  const int hc = tid & (kFBF - 1);  // hidden column of this thread
  const int hr = tid / kFBF;        // rows hr and hr + 8
  for (int f0 = 0; f0 < F; f0 += kFBF) {
    const float* w1r = w1 + (size_t)(f0 + hc) * D;
    const float* w2c = w2 + f0 + hc;
    float h0 = 0.f, h1 = 0.f, g0 = 0.f, g1 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float w = w1r[d];
      const float u = w2c[(size_t)d * F];
      h0 = fmaf(xs[hr * D + d], w, h0);
      h1 = fmaf(xs[(hr + 8) * D + d], w, h1);
      g0 = fmaf(dys[hr * D + d], u, g0);
      g1 = fmaf(dys[(hr + 8) * D + d], u, g1);
    }
    const float bb = b1[f0 + hc];
    if (dr.on) {
      const uint32_t i0 = drop_index(dr, n0 + hr, f0 + hc);
      g0 = drop_elem(g0, i0, seed, dr.thr, dr.scale);
      g1 = drop_elem(g1, i0 + 8u * dr.width, seed, dr.thr, dr.scale);
    }
    ds[hr * kFBF + hc] = g0 * act_grad(h0 + bb, act);
    ds[(hr + 8) * kFBF + hc] = g1 * act_grad(h1 + bb, act);
    __syncthreads();
    if (tid < kFBF) {
      float s = 0.f;
      for (int r = 0; r < kFBM; ++r) s += ds[r * kFBF + tid];
      prow[f0 + tid] = s;
    }
#pragma unroll
    for (int c = 0; c < kFOut; ++c) {
      const int o = tid + kFThreads * c;
      if (o < D) {
        for (int f = 0; f < kFBF; ++f) {
          const float w = w1[(size_t)(f0 + f) * D + o];
#pragma unroll
          for (int r = 0; r < kFBM; ++r)
            xacc[r][c] = fmaf(ds[r * kFBF + f], w, xacc[r][c]);
        }
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < kFBM; ++r) s += dys[r * D + c];
    prow[F + c] = s;
  }
#pragma unroll
  for (int c = 0; c < kFOut; ++c) {
    const int o = tid + kFThreads * c;
    if (o < D) {
#pragma unroll
      for (int r = 0; r < kFBM; ++r) {
        const int n = n0 + r;
        if (n < N) dx[(size_t)n * D + o] = xacc[r][c];
      }
    }
  }
}

// ------------------------------------------------- gated (F3, F4), fp32
__global__ void __launch_bounds__(kFThreads)
gated_fwd_f32(const float* __restrict__ x, const float* __restrict__ w0,
              const float* __restrict__ w1, const float* __restrict__ wo,
              float* __restrict__ y, int N, int D, int F, int act,
              DropArgs dr) {
  extern __shared__ float fsm[];
  float* xs = fsm;               // [kFBM][D]
  float* hs = xs + kFBM * D;     // [kFBM][kFBF]
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x;
  const uint32_t seed = seed_of(dr);
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

  const int hc = tid & (kFBF - 1);  // up products: hidden column
  const int hr = tid / kFBF;        // up products: rows hr and hr + 8
  for (int f0 = 0; f0 < F; f0 += kFBF) {
    const float* w0r = w0 + (size_t)(f0 + hc) * D;
    const float* w1r = w1 + (size_t)(f0 + hc) * D;
    float a0 = 0.f, a1 = 0.f, g0 = 0.f, g1 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float u = w0r[d], w = w1r[d];
      const float xa = xs[hr * D + d], xb = xs[(hr + 8) * D + d];
      a0 = fmaf(xa, u, a0);
      a1 = fmaf(xb, u, a1);
      g0 = fmaf(xa, w, g0);
      g1 = fmaf(xb, w, g1);
    }
    float v0 = act_fn(a0, act) * g0, v1 = act_fn(a1, act) * g1;
    if (dr.on) {
      const uint32_t i0 = drop_index(dr, n0 + hr, f0 + hc);
      v0 = drop_elem(v0, i0, seed, dr.thr, dr.scale);
      v1 = drop_elem(v1, i0 + 8u * dr.width, seed, dr.thr, dr.scale);
    }
    hs[hr * kFBF + hc] = v0;
    hs[(hr + 8) * kFBF + hc] = v1;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kFOut; ++c) {
      const int o = tid + kFThreads * c;
      if (o < D) {
        const float* wor = wo + (size_t)o * F + f0;
        for (int f = 0; f < kFBF; ++f) {
          const float w = wor[f];
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
        if (n < N) y[(size_t)n * D + o] = yacc[r][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
gated_bwd_f32(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ w0, const float* __restrict__ w1,
              const float* __restrict__ wo, float* __restrict__ dx, int N,
              int D, int F, int act, DropArgs dr) {
  extern __shared__ float fsm[];
  float* xs = fsm;               // [kFBM][D]
  float* dys = xs + kFBM * D;    // [kFBM][D]
  float* d0 = dys + kFBM * D;    // [kFBM][kFBF] dh0
  float* d1 = d0 + kFBM * kFBF;  // [kFBM][kFBF] dh1
  const int n0 = blockIdx.x * kFBM;
  const int tid = threadIdx.x;
  const uint32_t seed = seed_of(dr);
  for (int i = tid; i < kFBM * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const int n = n0 + r;
    xs[i] = n < N ? x[(size_t)n * D + c] : 0.f;
    dys[i] = n < N ? dy[(size_t)n * D + c] : 0.f;
  }
  float xacc[kFBM][kFOut];
#pragma unroll
  for (int r = 0; r < kFBM; ++r)
#pragma unroll
    for (int c = 0; c < kFOut; ++c) xacc[r][c] = 0.f;
  __syncthreads();

  const int hc = tid & (kFBF - 1);  // hidden column of this thread
  const int hr = tid / kFBF;        // rows hr and hr + 8
  for (int f0 = 0; f0 < F; f0 += kFBF) {
    const float* w0r = w0 + (size_t)(f0 + hc) * D;
    const float* w1r = w1 + (size_t)(f0 + hc) * D;
    const float* woc = wo + f0 + hc;
    float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f}, g[2] = {0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float u = w0r[d], w = w1r[d], o = woc[(size_t)d * F];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float xv = xs[(hr + 8 * k) * D + d];
        a[k] = fmaf(xv, u, a[k]);
        b[k] = fmaf(xv, w, b[k]);
        g[k] = fmaf(dys[(hr + 8 * k) * D + d], o, g[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = hr + 8 * k;
      float gk = g[k];
      if (dr.on)
        gk = drop_elem(gk, drop_index(dr, n0 + r, f0 + hc), seed, dr.thr,
                       dr.scale);
      d0[r * kFBF + hc] = gk * b[k] * act_grad(a[k], act);
      d1[r * kFBF + hc] = gk * act_fn(a[k], act);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kFOut; ++c) {
      const int o = tid + kFThreads * c;
      if (o < D) {
        for (int f = 0; f < kFBF; ++f) {
          const float u = w0[(size_t)(f0 + f) * D + o];
          const float w = w1[(size_t)(f0 + f) * D + o];
#pragma unroll
          for (int r = 0; r < kFBM; ++r)
            xacc[r][c] = fmaf(d1[r * kFBF + f], w,
                              fmaf(d0[r * kFBF + f], u, xacc[r][c]));
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
        if (n < N) dx[(size_t)n * D + o] = xacc[r][c];
      }
    }
  }
}

inline DropArgs drop_args(const void* seed, int drop, int thr, float scale,
                          int col_base, int width) {
  return DropArgs{(const int*)seed, drop, (uint32_t)thr, scale,
                  (uint32_t)col_base, (uint32_t)width};
}

// the hidden's columns [col_base, col_base + F) must lie in its width
inline bool bad_drop(const void* seed, int drop, int thr, int F,
                     int col_base, int width) {
  return (drop && (seed == nullptr || thr < 0)) || col_base < 0 ||
         width < F || col_base > width - F;
}

// what the bf16 tensor-core kernels take: D a multiple of 128 up to 1024,
// F of 64, S hidden splits of ceil(F / 64 / S) chunks each (none empty),
// partials when S > 1
inline bool bad_tc(int D, int F, int S, const void* part) {
  const int chunks = F / kFc;
  return D < 128 || D % 128 != 0 || D > 1024 || F < kFc || F % kFc != 0 ||
         S > chunks || (S - 1) * ((chunks + S - 1) / S) >= chunks ||
         (S > 1 && part == nullptr);
}

}  // namespace

#if VLPET_FFN_PART == 0
// W1 (F, D) and W2 (D, F) bf16 re-laid out into wt, 2 F D bf16
// (ffn_w_tiles): what the bf16 F1 reads. D a multiple of 128, F of 64.
extern "C" int vlpet_ffn_w_tiles(const void* w1, const void* w2, void* wt,
                                 int D, int F, void* stream) {
  if (D < 128 || D % 128 || F < kFc || F % kFc)
    return (int)cudaErrorInvalidValue;
  const long long items = 2LL * F * D / 8;
  const long long want = (items + 255) / 256;
  ffn_w_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0,
                (cudaStream_t)stream>>>((const bf16*)w1, (const bf16*)w2,
                                        (bf16*)wt, D, F, items);
  return (int)cudaGetLastError();
}

// x (N, D), y (N, D) in x's dtype; b1 (F,), b2 (D,) f32. bf16: wt from
// vlpet_ffn_w_tiles (w1, w2 unused), D a multiple of 128 up to 1024, F of
// 64, S hidden splits of ceil(F / 64 / S) chunks each (none empty) and
// part [S][N][D] f32 scratch when S > 1 (ops/ffn.py f1_splits); fp32: w1
// (F, D), w2 (D, F), wt and part unused, S 1.
extern "C" int vlpet_ffn_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* seed,
                             const void* wt, void* part, void* y, int N,
                             int D, int F, int S, int act, int is_bf16,
                             int drop, int thr, float scale, int col_base,
                             int width, void* stream) {
  if (N < 1 || S < 1 || act < 0 || act > 2 ||
      bad_drop(seed, drop, thr, F, col_base, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DropArgs dr = drop_args(seed, drop, thr, scale, col_base, width);
  if (is_bf16) {
    if (wt == nullptr || bad_tc(D, F, S, part))
      return (int)cudaErrorInvalidValue;
    switch (f1_du(D)) {
      case 1: return launch_fwd_tc<1, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
      case 2: return launch_fwd_tc<2, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
      case 3: return launch_fwd_tc<3, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
      case 4: return launch_fwd_tc<4, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
      case 5: return launch_fwd_tc<5, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
      case 6: return launch_fwd_tc<6, false>(x, wt, b1, b2, y, part, N, D, F, S, act, dr, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (S != 1 || D < 1 || D > kFThreads * kFOut || F % kFBF != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kFBM * D + kFBM * kFBF);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_f32<<<(N + kFBM - 1) / kFBM, kFThreads, smem, st>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)y, N, D, F, act, dr);
  return (int)cudaGetLastError();
}
#endif  // VLPET_FFN_PART == 0

#if VLPET_FFN_PART == 1
// dx (N, D) in x's dtype, db1 (F,) and db2 (D,) f32 of vlpet_ffn_fwd for dy
// (N, D); partial: [G][F + D] f32 scratch, the per-block bias sums. bf16:
// wt from vlpet_ffn_w_tiles (w1, w2 unused), dyt scratch of G 64 D bf16
// (dy re-laid out), G = ceil(N / 64), S and part as the forward's; fp32:
// w1, w2, G = ceil(N / 16), dyt, wt and part unused, S 1.
extern "C" int vlpet_ffn_bwd(const void* x, const void* dy, const void* w1,
                             const void* b1, const void* w2, const void* seed,
                             void* dyt, const void* wt, void* part,
                             void* dx, void* partial, void* db1,
                             void* db2, int N, int D, int F, int G, int S,
                             int act, int is_bf16, int drop, int thr,
                             float scale, int col_base, int width,
                             void* stream) {
  if (N < 1 || S < 1 || act < 0 || act > 2 ||
      bad_drop(seed, drop, thr, F, col_base, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DropArgs dr = drop_args(seed, drop, thr, scale, col_base, width);
  if (is_bf16) {
    if (dyt == nullptr || wt == nullptr || bad_tc(D, F, S, part) ||
        G != (N + kF1Rows - 1) / kF1Rows)
      return (int)cudaErrorInvalidValue;
    switch (f1_du(D)) {
      case 1: return launch_f2_tc<1>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
      case 2: return launch_f2_tc<2>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
      case 3: return launch_f2_tc<3>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
      case 4: return launch_f2_tc<4>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
      case 5: return launch_f2_tc<5>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
      case 6: return launch_f2_tc<6>(x, dy, dyt, wt, b1, dx, part, partial, db1, db2, N, D, F, S, act, dr, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (S != 1 || D < 1 || D > kFThreads * kFOut || F % kFBF != 0 ||
      G != (N + kFBM - 1) / kFBM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * kFBM * D + kFBM * kFBF);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_f32<<<G, kFThreads, smem, st>>>(
      (const float*)x, (const float*)dy, (const float*)w1, (const float*)b1,
      (const float*)w2, (float*)dx, (float*)partial, N, D, F, act, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_bias_reduce<<<(F + D + 255) / 256, 256, 0, st>>>(
      (const float*)partial, G, F, D, (float*)db1, (float*)db2);
  return (int)cudaGetLastError();
}
#endif  // VLPET_FFN_PART == 1

#if VLPET_FFN_PART == 0
// W0, W1 (F, D) and Wo (D, F) bf16 re-laid out: gt (gated_w_tiles, what
// F3 reads and F4's up pieces) or bt (gated_bwd_tiles, the rest of F4's
// weights), 3 F D bf16 each. D a multiple of 128, F of 64.
extern "C" int vlpet_gated_w_tiles(const void* w0, const void* w1,
                                   const void* wo, void* gt, int D, int F,
                                   void* stream) {
  if (D < 128 || D % 128 || F < kFc || F % kFc)
    return (int)cudaErrorInvalidValue;
  const long long items = 3LL * F * D / 8;
  const long long want = (items + 255) / 256;
  gated_w_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0,
                  (cudaStream_t)stream>>>((const bf16*)w0, (const bf16*)w1,
                                          (const bf16*)wo, (bf16*)gt, D, F,
                                          items);
  return (int)cudaGetLastError();
}

extern "C" int vlpet_gated_bwd_tiles(const void* w0, const void* w1,
                                     const void* wo, void* bt, int D, int F,
                                     void* stream) {
  if (D < 128 || D % 128 || F < kFc || F % kFc)
    return (int)cudaErrorInvalidValue;
  const long long items = 3LL * F * D / 8;
  const long long want = (items + 255) / 256;
  gated_bwd_tiles<<<(unsigned)(want > 16384 ? 16384 : want), 256, 0,
                    (cudaStream_t)stream>>>((const bf16*)w0, (const bf16*)w1,
                                            (const bf16*)wo, (bf16*)bt, D, F,
                                            items);
  return (int)cudaGetLastError();
}

// x (N, D), y (N, D) in x's dtype. bf16: gt from vlpet_gated_w_tiles (w0,
// w1, wo unused), S hidden splits and part [S][N][D] f32 scratch when S >
// 1 (ops/ffn.py gated_splits), D and F as bad_tc; fp32: w0, w1 (F, D), wo
// (D, F), gt and part unused, S 1.
extern "C" int vlpet_gated_ffn_fwd(const void* x, const void* w0,
                                   const void* w1, const void* wo,
                                   const void* seed, const void* gt,
                                   void* part, void* y, int N, int D, int F,
                                   int S, int act, int is_bf16, int drop,
                                   int thr, float scale, int col_base,
                                   int width, void* stream) {
  if (N < 1 || S < 1 || act < 0 || act > 2 ||
      bad_drop(seed, drop, thr, F, col_base, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DropArgs dr = drop_args(seed, drop, thr, scale, col_base, width);
  if (is_bf16) {
    if (gt == nullptr || bad_tc(D, F, S, part))
      return (int)cudaErrorInvalidValue;
    switch (f1_du(D)) {
      case 1: return launch_fwd_tc<1, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
      case 2: return launch_fwd_tc<2, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
      case 3: return launch_fwd_tc<3, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
      case 4: return launch_fwd_tc<4, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
      case 5: return launch_fwd_tc<5, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
      case 6: return launch_fwd_tc<6, true>(x, gt, nullptr, nullptr, y, part, N, D, F, S, act, dr, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (S != 1 || D < 1 || D > kFThreads * kFOut || F % kFBF != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kFBM * D + kFBM * kFBF);
  cudaError_t err = cudaFuncSetAttribute(
      gated_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gated_fwd_f32<<<(N + kFBM - 1) / kFBM, kFThreads, smem, st>>>(
      (const float*)x, (const float*)w0, (const float*)w1, (const float*)wo,
      (float*)y, N, D, F, act, dr);
  return (int)cudaGetLastError();
}
#endif  // VLPET_FFN_PART == 0

#if VLPET_FFN_PART == 2
// dx (N, D) of vlpet_gated_ffn_fwd for dy (N, D). bf16: gt and bt from
// the re-lay entries (w0, w1, wo unused), dyt scratch of ceil(N / 64) 64 D
// bf16 (dy re-laid out), S and part as the forward's; fp32: w0, w1, wo,
// dyt, gt, bt and part unused, S 1.
extern "C" int vlpet_gated_ffn_bwd(const void* x, const void* dy,
                                   const void* w0, const void* w1,
                                   const void* wo, const void* seed,
                                   void* dyt, const void* gt, const void* bt,
                                   void* part, void* dx, int N, int D, int F,
                                   int S, int act, int is_bf16, int drop,
                                   int thr, float scale, int col_base,
                                   int width, void* stream) {
  if (N < 1 || S < 1 || act < 0 || act > 2 ||
      bad_drop(seed, drop, thr, F, col_base, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DropArgs dr = drop_args(seed, drop, thr, scale, col_base, width);
  if (is_bf16) {
    if (dyt == nullptr || gt == nullptr || bt == nullptr ||
        bad_tc(D, F, S, part))
      return (int)cudaErrorInvalidValue;
    switch (f1_du(D)) {
      case 1: return launch_f4_tc<1>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
      case 2: return launch_f4_tc<2>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
      case 3: return launch_f4_tc<3>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
      case 4: return launch_f4_tc<4>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
      case 5: return launch_f4_tc<5>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
      case 6: return launch_f4_tc<6>(x, dy, dyt, gt, bt, dx, part, N, D, F, S, act, dr, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (S != 1 || D < 1 || D > kFThreads * kFOut || F % kFBF != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)2 * kFBM * D + (size_t)2 * kFBM * kFBF);
  cudaError_t err = cudaFuncSetAttribute(
      gated_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gated_bwd_f32<<<(N + kFBM - 1) / kFBM, kFThreads, smem, st>>>(
      (const float*)x, (const float*)dy, (const float*)w0, (const float*)w1,
      (const float*)wo, (float*)dx, N, D, F, act, dr);
  return (int)cudaGetLastError();
}
#endif  // VLPET_FFN_PART == 2
