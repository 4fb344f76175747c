// In-place write of one time slot of one or two KV caches, one launch.
//
// Replaces vlpet_tpu/ops/cache_update.py:cache_slot_update
// (_update_kernel): cache (N, L, R) with R = H * Dh elements per slot row,
// new (N, R); cache[n, pos, :] = new[n, :] for every n, and no other byte
// of the cache is touched. The TPU kernel aliased the cache and DMA'd the
// one (N, 1, H, Dh) slot; here the cache is a PyTorch tensor updated in
// place. The decode's time-major (L, B, H*Dh) cache is the N = 1 case.
// A decode step writes its K and V slots together: one launch takes both
// (cache, new) pairs (same shape and dtype), blockIdx.y picking the pair.
//
// Bound on the H100: pure memory -- N * R elements read once and written
// once per pair (2 x 2 x 3.84 MB for K and V at the BART beam cache,
// 0.0046 ms at 3.35 TB/s). The device copy runs near that; what a launch
// costs beside it is the host's enqueue (the Python wrapper and the ctypes
// call), which the pair form pays once for K and V instead of twice: a K+V
// write at the BART beam cache (bf16) took 0.0376 ms of CUDA-event time
// against 0.0657 for the two launches it replaced and 0.0527 for two
// cache[pos].copy_ calls (chip_phases.py phase 3j, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md).
// Design: a grid-stride copy in 16-byte words when the slot rows and every
// pointer allow it (R * elem bytes a multiple of 16), else in 4-byte or
// 2-byte words; neighbouring threads copy neighbouring words.
#include "common.cuh"

namespace {

template <typename W>
__global__ void slot_copy(W* __restrict__ cache0, const W* __restrict__ src0,
                          W* __restrict__ cache1, const W* __restrict__ src1,
                          long long row_words, long long slot_stride,
                          long long total) {
  W* cache = blockIdx.y ? cache1 : cache0;
  const W* src = blockIdx.y ? src1 : src0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / row_words;
    const long long w = i - n * row_words;
    cache[n * slot_stride + w] = src[i];
  }
}

template <typename W>
int launch(void* cache0, const void* src0, void* cache1, const void* src1,
           long long N, long long L, long long row_bytes, int pos,
           cudaStream_t st) {
  const long long row_words = row_bytes / (long long)sizeof(W);
  const long long total = N * row_words;
  const long long at = (long long)pos * row_words;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  slot_copy<W><<<dim3((unsigned)blocks, cache1 ? 2 : 1), threads, 0, st>>>(
      reinterpret_cast<W*>(cache0) + at, reinterpret_cast<const W*>(src0),
      cache1 ? reinterpret_cast<W*>(cache1) + at : nullptr,
      reinterpret_cast<const W*>(src1), row_words, L * row_words, total);
  return (int)cudaGetLastError();
}

}  // namespace

// cache0 (N, L, R) and new0 (N, R) of elem_bytes-wide elements (2 or 4);
// cache1 and new1 the second pair of the same shape, or both NULL
extern "C" int vlpet_cache_update(void* cache0, const void* src0,
                                  void* cache1, const void* src1, int N,
                                  int L, int R, int elem_bytes, int pos,
                                  void* stream) {
  if (N < 1 || L < 1 || R < 1 || pos < 0 || pos >= L ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      (cache1 == nullptr) != (src1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_bytes = (long long)R * elem_bytes;
  const uintptr_t align = (uintptr_t)cache0 | (uintptr_t)src0 |
                          (uintptr_t)cache1 | (uintptr_t)src1;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(cache0, src0, cache1, src1, N, L, row_bytes, pos, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(cache0, src0, cache1, src1, N, L, row_bytes, pos,
                            st);
  return launch<uint16_t>(cache0, src0, cache1, src1, N, L, row_bytes, pos,
                          st);
}
