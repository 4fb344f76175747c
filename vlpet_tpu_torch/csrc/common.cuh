// Shared helpers for the port's kernels (plain C interface, no PyTorch
// headers). Every launcher is `extern "C"`, launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace vlpet {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The dropout hash of vlpet_tpu/ops/hashdrop.py keep_mask: a murmur3
// finalizer of the GLOBAL flat element index, in uint32 arithmetic (every
// product and sum wraps mod 2^32). An element is kept iff
// hash_bits(idx, seed) >= thr, with thr = int(rate * 2^31): P(keep) =
// 1 - rate on 31 bits. The backward kernels regenerate the forward's mask
// from (seed, index); nothing is stored.
__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed) {
  uint32_t z = idx * 2654435761u + seed;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z & 0x7FFFFFFFu;
}

// The per-head seed of the attention dropout (vlpet_tpu/ops/attention.py
// head_seed): seed + h * 0x9E3779B9 mod 2^32.
__device__ __forceinline__ uint32_t head_seed(uint32_t seed, int h) {
  return seed + (uint32_t)h * 0x9E3779B9u;
}

// Dropout of one element at flat index idx: v / (1 - rate) where kept
// (scale = 1 / (1 - rate)), else 0.
__device__ __forceinline__ float drop_elem(float v, uint32_t idx,
                                           uint32_t seed, uint32_t thr,
                                           float scale) {
  return hash_bits(idx, seed) >= thr ? v * scale : 0.f;
}

// A kernel's dropout arguments: ``on`` = rate > 0, the (1,) int32 device
// seed read by pointer (no host sync per site), thr = int(rate * 2^31),
// scale = 1 / (1 - rate).
struct DropArgs {
  const int* seed;
  int on;
  uint32_t thr;
  float scale;
};

__device__ __forceinline__ uint32_t seed_of(const DropArgs& d) {
  return d.on ? (uint32_t)d.seed[0] : 0u;
}

// Tensor-core and asynchronous-copy primitives of the bf16 attention
// kernels (csrc/attention.cu, csrc/attention_bwd_long.cu), per warp:
// mma.sync m16n8k16 bf16 -> fp32. With g = lane / 4 and t = lane % 4, the
// fragments hold A (16 x 16, row-major) a0 = (g, 2t..2t+1), a1 = (g + 8,
// 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8) b0 = (k
// 2t..2t+1, n g), b1 = (k 2t + 8.., n g); C (16 x 8) c0, c1 = (g, 2t..2t+1),
// c2, c3 = (g + 8, 2t..). So the C fragments of two neighbouring n8 tiles
// are, packed to bf16, the A fragment of the next product over those 16
// columns (mma_a_from_c): no shared-memory round trip.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without staging in registers; ``bytes`` 0
// zero-fills the destination (rows past the end of a ragged tile)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives r[m] = (row l / 4, columns 2 (l % 4) ..) of
// matrix m; with .trans, (rows 2 (l % 4) .., column l / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment (16 rows x 16 columns) made of the C fragments of n8 tiles
// c0 (columns 0..7) and c1 (columns 8..15), rounded to bf16
__device__ __forceinline__ void mma_a_from_c(uint32_t (&a)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one instruction (MUFU.EX2); the kernels scale their logits by
// log2(e) so that exp(x - m) = ex2(x log2(e) - m log2(e)) is one FFMA
// and one EX2
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 4 lanes of a quad (the lanes that share a row of an
// mma fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bf16 attention tiles: 64 rows of one head's Dh = 64 values, row
// stride 72 (144 bytes: the 8 rows an ldmatrix reads fall on distinct
// banks, and every row starts 16-byte aligned for cp.async)
constexpr int kTcD = 64;
constexpr int kTcRows = 64;
constexpr int kTcLd = kTcD + 8;
constexpr int kTcTile = kTcRows * kTcLd;  // bf16 elements of one tile

// rows n0 .. n0 + 64 of one head of x (N rows of stride ``inner``
// elements) into dst [64][72], zeros past N: 512 16-byte copies spread
// over ``threads`` threads, not committed
__device__ __forceinline__ void tc_load_tile(bf16* dst,
                                             const bf16* __restrict__ x,
                                             int n0, int N, int inner,
                                             int threads) {
  for (int i = threadIdx.x; i < kTcRows * (kTcD / 8); i += threads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int n = n0 + r;
    const bool ok = n < N;
    cp_async_16(dst + r * kTcLd + c, ok ? x + (size_t)n * inner + c : x,
                ok ? 16 : 0);
  }
}

// rows r0 .. r0 + R of the (N, S) fp32 bias of one head, columns c0 ..
// c0 + 64, into dst [R][ld], zeros outside (N, S): 16-byte copies where S
// is a multiple of 4 (every row then starts 16-byte aligned), else 4-byte
// ones; not committed
__device__ __forceinline__ void tc_load_bias(float* dst, int ld,
                                             const float* __restrict__ x,
                                             int r0, int R, int N, int c0,
                                             int S, int threads) {
  if ((S & 3) == 0) {
    for (int i = threadIdx.x; i < R * 16; i += threads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = r0 + r < N && c0 + c < S;
      cp_async_16(dst + r * ld + c, ok ? x + (size_t)(r0 + r) * S + c0 + c : x,
                  ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * 64; i += threads) {
      const int r = i >> 6, c = i & 63;
      const bool ok = r0 + r < N && c0 + c < S;
      cp_async_4(dst + r * ld + c, ok ? x + (size_t)(r0 + r) * S + c0 + c : x,
                 ok ? 4 : 0);
    }
  }
}

// A fragment of rows r0 .. r0 + 16, columns 16 kc .. 16 kc + 16 of a tile
__device__ __forceinline__ void tc_frag_a(uint32_t (&a)[4], const bf16* tile,
                                          int r0, int kc, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = kc * 16 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + row * kTcLd + col);
}

// B fragments where the tile's rows are the n dimension (B = tile^T):
// n8 tiles of rows r0 .. r0 + 8 (b[0], b[1]) and r0 + 8 .. r0 + 16 (b[2],
// b[3]), k = columns 16 kc .. 16 kc + 16
__device__ __forceinline__ void tc_frag_bt(uint32_t (&b)[4], const bf16* tile,
                                           int r0, int kc, int lane) {
  const int row = r0 + (lane & 7) + (lane >> 4) * 8;
  const int col = kc * 16 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + row * kTcLd + col);
}

// B fragments where the tile's rows are the k dimension (B = tile):
// k = rows r0 .. r0 + 16, n8 tiles of columns 8 dt .. (b[0], b[1]) and
// 8 dt + 8 .. (b[2], b[3])
__device__ __forceinline__ void tc_frag_b(uint32_t (&b)[4], const bf16* tile,
                                          int r0, int dt, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = (dt + (lane >> 4)) * 8;
  ldmatrix_x4_trans(b, tile + row * kTcLd + col);
}

// ------------------------------------------------ wgmma, TMA, mbarriers
// The streamed kernels (csrc/fused_ce.cu C1 and C2, csrc/ffn.cu F1) keep
// their operand tiles in shared memory "chunk-major": the 16-byte chunk c
// (columns 8 c .. 8 c + 8) of row r of an R-row tile at (c * R + r) * 16
// bytes, so each 8-row x 16-byte core matrix is 128 contiguous bytes:
// wgmma's no-swizzle K-major layout (leading offset R * 16 bytes between
// the two k chunks of a k16 step, stride offset 128 between 8-row groups)
// and conflict-free for ldmatrix. Weight tiles arrive already in that
// layout (re-laid out in device memory by the wrapper's tiling kernel), one
// TMA bulk copy a tile, completing on an mbarrier.

// rows r0 .. r0 + R of a (rows, D) bf16 matrix into the chunk-major dst
// (R rows), zeros past ``rows``: 16-byte cp.async copies, not committed.
// Neighbouring threads take the two chunks of a 32-byte sector of a row,
// then the next rows.
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int r0,
                                        int R, int rows, int D,
                                        int threads) {
  const int words = D / 8;
  for (int i = threadIdx.x; i < R * words; i += threads) {
    const int pr = i >> 1, r = pr % R;
    const int c = (pr / R) * 2 + (i & 1);
    const bool ok = r0 + r < rows;
    cp_async_16(dst + (c * R + r) * 8,
                ok ? src + (size_t)(r0 + r) * D + c * 8 : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the initialised barriers are visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ``bytes`` (a multiple of 16) from global src to shared dst by the
// tensor memory accelerator, completing on the mbarrier bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) are visible
// to the async proxy (wgmma operands) once every writer has run this and a
// barrier has followed
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between the two 8-column core matrices of a k16 step), stride
// byte offset (between 8-row groups)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N of this warpgroup's committed wgmma groups still pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A . B^T, m64n32k16, A K-major in shared memory, B K-major (TB 0)
// or MN-major (TB 1: wgmma's transpose-B; no swizzle, core matrices of 8
// K rows x 16 bytes of N, the descriptor's leading offset between core
// matrices along K, its stride offset between those along N); warp w of
// the warpgroup receives rows 16 w .. 16 w + 16 in mma.sync's C layout:
// d[nt] is n8 tile nt, (row g, columns 2 t, 2 t + 1), then row g + 8
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, "
      "p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

}  // namespace vlpet
