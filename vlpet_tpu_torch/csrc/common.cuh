// Shared helpers for the port's kernels (plain C interface, no PyTorch
// headers). Every launcher is `extern "C"`, launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace vlpet
