// In-place write of one time slot of a KV cache.
//
// Replaces vlpet_tpu/ops/cache_update.py:cache_slot_update
// (_update_kernel): cache (N, L, R) with R = H * Dh elements per slot row,
// new (N, R); cache[n, pos, :] = new[n, :] for every n, and no other byte
// of the cache is touched. The TPU kernel aliased the cache and DMA'd the
// one (N, 1, H, Dh) slot; here the cache is a PyTorch tensor updated in
// place. The decode's time-major (L, B, H*Dh) cache is the N = 1 case.
//
// Bound on the H100: pure memory -- N * R elements read once and written
// once (2 x 3.84 MB at the BART beam cache, 0.0023 ms at 3.35 TB/s).
// Design: a grid-stride copy in 16-byte words when the slot rows and both
// pointers allow it (R * elem bytes a multiple of 16), else in 4-byte or
// 2-byte words; neighbouring threads copy neighbouring words.
#include "common.cuh"

namespace {

template <typename W>
__global__ void slot_copy(W* __restrict__ cache, const W* __restrict__ src,
                          long long n_rows, long long row_words,
                          long long slot_stride, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / row_words;
    const long long w = i - n * row_words;
    cache[n * slot_stride + w] = src[i];
  }
}

template <typename W>
int launch(void* cache, const void* src, long long N, long long L,
           long long row_bytes, int pos, cudaStream_t st) {
  const long long row_words = row_bytes / (long long)sizeof(W);
  const long long total = N * row_words;
  W* dst = reinterpret_cast<W*>(cache) + (long long)pos * row_words;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  slot_copy<W><<<(int)blocks, threads, 0, st>>>(
      dst, reinterpret_cast<const W*>(src), N, row_words, L * row_words,
      total);
  return (int)cudaGetLastError();
}

}  // namespace

// cache (N, L, R) and new (N, R) of elem_bytes-wide elements (2 or 4)
extern "C" int vlpet_cache_update(void* cache, const void* src, int N, int L,
                                  int R, int elem_bytes, int pos,
                                  void* stream) {
  if (N < 1 || L < 1 || R < 1 || pos < 0 || pos >= L ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_bytes = (long long)R * elem_bytes;
  const uintptr_t align = (uintptr_t)cache | (uintptr_t)src;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(cache, src, N, L, row_bytes, pos, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(cache, src, N, L, row_bytes, pos, st);
  return launch<uint16_t>(cache, src, N, L, row_bytes, pos, st);
}
