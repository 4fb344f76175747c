// Exact top-k + row logsumexp over f32 logits (R, V), 1 <= k <= 16.
//
// Replaces vlpet_tpu/ops/topk.py:topk_lse_hier (_hier_sweep_kernel) and
// topk_lse_exact (_topk_lse_kernel): the same contract -- top-k values and
// int32 indices in lax.top_k order (value descending, then index
// ascending) plus the row logsumexp -- in one pass over the row. The TPU
// sweep was approximate per lane and needed an exactness detector and a
// fallback; this kernel is exact by construction, and needs no 128-pad.
//
// Bound on the H100: bytes. One read of the logits (2500 x 50265 f32 = 503
// MB at the beam-5 decode shape, 0.150 ms at 3.35 TB/s); the exp per
// element and the compares are far below the instruction rate. What the design
// does about it:
//   * the row is read in 16-byte pieces: its head is peeled to a 16-byte
//     boundary (BART's odd vocabulary, 50265, starts row r at r mod 4
//     floats) and its tail read as scalars; in between, each thread copies
//     its kLoads float4s of a group (16 values) by cp.async into a ring of
//     kStages groups in shared memory, two groups in flight while it reads
//     the third. A thread reads back only what it copied itself, so
//     cp.async.wait_group orders it and the ring needs no barrier; loads
//     stay in flight while a warp inserts, and hold no registers;
//   * the logsumexp rescales its running sum once a group, at the group's
//     max, and adds exp2 terms (-inf entries add nothing; a row that is all
//     -inf gives -inf);
//   * k >= 2: one candidate list a warp, lane j < k holding the warp's j-th
//     best (value, index), and a row-wide admission threshold in shared
//     memory (the max over the block's warps of their k-th values, as an
//     order-preserving uint32 key raised by atomicMax, read once a group).
//     A value below some warp's k-th value has k values above it, so it
//     cannot be in the top k; ">=" keeps ties at the threshold, which then
//     resolve by index. A thread's group is tested against the threshold by
//     its max first; only admitted values are inserted, one at a time, by
//     a shuffle shift across the lanes. Until a warp's list is full (a
//     row's first group), the k-th largest of its lanes' group maxima
//     bounds it instead. Insertion no longer diverges per thread on every
//     element;
//   * k = 1: a per-thread (best, index) from the group max, no list;
//   * the merge: each warp hands its k entries to shared memory, and after
//     one barrier each of the block's first W * k threads ranks one of
//     them against all the others: the entries of rank < k are the row's
//     top k, written in place.
// One block a row; ops/topk.py topk_plan sizes it (threads, the group, the
// ring's stages, shared bytes), and the launcher checks the plan against
// this layout.
#include <limits.h>

#include "common.cuh"

using namespace vlpet;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kLoads = 4;            // float4s a thread copies a group
constexpr int kGroup = 4 * kLoads;   // values a thread holds per group
constexpr int kStages = 3;           // groups of the ring: two in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// An order-preserving uint32 key of a float (larger float, larger key).
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The 32 lanes' x, sorted descending across the warp (bitonic).
__device__ __forceinline__ float warp_sort_desc(float x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, x, stride);
      const bool desc = (lane & size) == 0, low = (lane & stride) == 0;
      x = low == desc ? fmaxf(x, o) : fminf(x, o);
    }
  }
  return x;
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * exp2f((m - mn) * kLog2e) + s2 * exp2f((m2 - mn) * kLog2e);
  m = mn;
}

// What a thread carries along its row.
struct RowState {
  float m, s;    // running max, and the sum of exp(x - m)
  float bv;      // k = 1: this thread's best value and its index
  int bi;
  float lv;      // k >= 2: this lane's entry of the warp's list
  int li;
  float kv;      // k >= 2: the warp's k-th entry
  int ki;
};

// One group of N values (indices ix, ascending in the thread's order;
// unused slots hold -inf at index INT_MAX). Every lane of the warp calls
// it.
template <int N, bool ONE>
__device__ __forceinline__ void consume(const float (&v)[N], const int (&ix)[N],
                                        RowState& st, int k, int lane,
                                        unsigned* s_thr) {
  float g = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) g = fmaxf(g, v[j]);
  if (g != -INFINITY) {  // logsumexp: one rescale a group
    const float mn = fmaxf(st.m, g);
    st.s *= exp2f((st.m - mn) * kLog2e);
    st.m = mn;
    const float ml = mn * kLog2e;
#pragma unroll
    for (int j = 0; j < N; ++j) st.s += exp2f(fmaf(v[j], kLog2e, -ml));
  }
  if constexpr (ONE) {
    // the thread's indices ascend, so an equal max keeps the earlier one
    if (g > st.bv || (g == st.bv && st.bi == INT_MAX)) {
      int bi = INT_MAX;
#pragma unroll
      for (int j = N - 1; j >= 0; --j)
        if (v[j] == g) bi = ix[j];
      st.bv = g;
      st.bi = bi;
    }
    return;
  }
  const float thr = value_of(*(volatile unsigned*)s_thr);
  float t = fmaxf(thr, st.kv);
  if (N > 1 && st.kv == -INFINITY) {
    // the warp's list is not yet full (a row's first group): the k-th
    // largest of the lanes' group maxima is the max of k distinct entries,
    // so nothing below it is in the top k
    t = fmaxf(t, __shfl_sync(kFull, warp_sort_desc(g, lane), k - 1));
  }
  if (!__any_sync(kFull, g >= t)) return;
  bool raised = false;  // warp-uniform
#pragma unroll
  for (int j = 0; j < N; ++j) {
    unsigned c = __ballot_sync(kFull, v[j] >= t &&
                                          better(v[j], ix[j], st.kv, st.ki));
    while (c) {
      const int src = __ffs(c) - 1;
      c &= c - 1;
      const float cv = __shfl_sync(kFull, v[j], src);
      const int ci = __shfl_sync(kFull, ix[j], src);
      if (!better(cv, ci, st.kv, st.ki)) continue;  // beaten meanwhile
      const int pos = __popc(__ballot_sync(
          kFull, lane < k && better(st.lv, st.li, cv, ci)));
      const float uv = __shfl_up_sync(kFull, st.lv, 1);
      const int ui = __shfl_up_sync(kFull, st.li, 1);
      if (lane > pos) {
        st.lv = uv;
        st.li = ui;
      } else if (lane == pos) {
        st.lv = cv;
        st.li = ci;
      }
      st.kv = __shfl_sync(kFull, st.lv, k - 1);
      st.ki = __shfl_sync(kFull, st.li, k - 1);
      raised = true;
    }
  }
  if (raised && lane == 0 && st.kv > thr) atomicMax(s_thr, key_of(st.kv));
}

// This thread's values of one group from its ring stage, with their
// indices; MASKED: the row's last group, whose slots past the row hold -inf
// at INT_MAX.
template <bool MASKED>
__device__ __forceinline__ void take(const float4* stage, int T, int tid,
                                     int b4, int head, int nv4,
                                     float (&v)[kGroup], int (&ix)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const float4 q = stage[u * T + tid];
    const bool in = !MASKED || b4 + u * T < nv4;
    const int e = head + 4 * (b4 + u * T);
    v[4 * u] = in ? q.x : -INFINITY;
    v[4 * u + 1] = in ? q.y : -INFINITY;
    v[4 * u + 2] = in ? q.z : -INFINITY;
    v[4 * u + 3] = in ? q.w : -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) ix[4 * u + c] = in ? e + c : INT_MAX;
  }
}

// Shared memory: the ring (kStages groups of the block's float4s), the
// threshold key (16 bytes), the warps' (max, sum) pairs, then their k
// entries each as (value, index bits).
__host__ __device__ constexpr int ring_bytes(int threads) {
  return kStages * threads * kLoads * 16;
}

__host__ __device__ constexpr int smem_bytes(int threads, int k) {
  return ring_bytes(threads) + 16 + 8 * (threads / 32) * (k + 1);
}

// Row blockIdx.x, by the whole block. ONE: k = 1.
template <bool ONE>
__global__ void __launch_bounds__(kMaxThreads, 2)
topk_lse_rows(const float* __restrict__ x, float* __restrict__ vals,
              int* __restrict__ idx, float* __restrict__ lse, int V,
              int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* ring = reinterpret_cast<float4*>(smem);
  unsigned* s_thr = reinterpret_cast<unsigned*>(smem + ring_bytes(T));
  float* red_m = reinterpret_cast<float*>(s_thr + 4);
  float* red_s = red_m + W;
  float2* cand = reinterpret_cast<float2*>(red_s + W);

  const int row = blockIdx.x;
  if (tid == 0) *s_thr = key_of(-INFINITY);
  __syncthreads();
  const float* xr = x + (size_t)row * V;
  const int mis = (int)((reinterpret_cast<uintptr_t>(xr) >> 2) & 3);
  const int head = min((4 - mis) & 3, V);
  const int nv4 = (V - head) >> 2;
  const int tail = V - head - 4 * nv4;
  const float4* body = reinterpret_cast<const float4*>(xr + head);
  RowState st{-INFINITY, 0.f, -INFINITY, INT_MAX, -INFINITY, INT_MAX,
              -INFINITY, INT_MAX};
  const int span = T * kLoads;  // float4s a group of the block
  const int groups = (nv4 + span - 1) / span;
  const int full = nv4 / span;  // groups with no slot past the row
  // this thread's float4s of group gi into ring stage gi mod kStages
  auto fetch = [&](int gi) {
    if (gi < groups) {
      float4* stage = ring + (gi % kStages) * span;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j4 = gi * span + u * T + tid;
        if (j4 < nv4) cp_async_16(stage + u * T + tid, body + j4, 16);
      }
    }
    cp_async_commit();  // an empty group past the row: the count holds
  };
#pragma unroll
  for (int gi = 0; gi < kStages - 1; ++gi) fetch(gi);

  {  // the head, up to the first 16-byte boundary
    const float v[1] = {tid < head ? xr[tid] : -INFINITY};
    const int ix[1] = {tid < head ? tid : INT_MAX};
    consume<1, ONE>(v, ix, st, k, lane, s_thr);
  }
  for (int gi = 0; gi < groups; ++gi) {
    fetch(gi + kStages - 1);
    cp_async_wait<kStages - 1>();  // this thread's copies of group gi
    const float4* stage = ring + (gi % kStages) * span;
    const int b4 = gi * span + tid;
    float v[kGroup];
    int ix[kGroup];
    if (gi < full)
      take<false>(stage, T, tid, b4, head, nv4, v, ix);
    else
      take<true>(stage, T, tid, b4, head, nv4, v, ix);
    consume<kGroup, ONE>(v, ix, st, k, lane, s_thr);
  }
  {  // the tail, past the last whole float4
    const int e = head + 4 * nv4 + tid;
    const float v[1] = {tid < tail ? xr[e] : -INFINITY};
    const int ix[1] = {tid < tail ? e : INT_MAX};
    consume<1, ONE>(v, ix, st, k, lane, s_thr);
  }

  // the warp's (max, sum), and its entries
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, st.m, o);
    const float s2 = __shfl_xor_sync(kFull, st.s, o);
    lse_merge(st.m, st.s, m2, s2);
  }
  if constexpr (ONE) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, st.bv, o);
      const int oi = __shfl_xor_sync(kFull, st.bi, o);
      if (better(ov, oi, st.bv, st.bi)) {
        st.bv = ov;
        st.bi = oi;
      }
    }
    if (lane == 0) cand[warp] = make_float2(st.bv, __int_as_float(st.bi));
  } else if (lane < k) {
    cand[warp * k + lane] = make_float2(st.lv, __int_as_float(st.li));
  }
  if (lane == 0) {
    red_m[warp] = st.m;
    red_s[warp] = st.s;
  }
  __syncthreads();

  // the merge: entry tid's rank among the W * k; ranks < k are distinct
  // (the row has at least k real entries, each better than a sentinel)
  const int n = W * k;
  if (tid < n) {
    const float2 me = cand[tid];
    const int mi = __float_as_int(me.y);
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float2 o = cand[j];
      rank += better(o.x, __float_as_int(o.y), me.x, mi);
    }
    if (rank < k) {
      vals[(size_t)row * k + rank] = me.x;
      idx[(size_t)row * k + rank] = mi;
    }
  } else if (warp == W - 1) {  // n <= T / 2: the last warp is free
    float m = lane < W ? red_m[lane] : -INFINITY;
    float s = lane < W ? red_s[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m, o);
      const float s2 = __shfl_xor_sync(kFull, s, o);
      lse_merge(m, s, m2, s2);
    }
    if (lane == 0) lse[row] = m + logf(s);  // all -inf: -inf + log(0)
  }
}

}  // namespace

// x, vals, idx, lse, R, V, k, then the plan (ops/topk.py topk_plan):
// threads, float4s a thread a group, ring stages, shared bytes.
extern "C" int vlpet_topk_lse(const void* x, void* vals, void* idx, void* lse,
                              int R, int V, int k, int threads, int loads,
                              int stages, int smem, void* stream) {
  if (R < 1 || k < 1 || k > 16 || k > V) return (int)cudaErrorInvalidValue;
  if (threads < 64 || threads > kMaxThreads || threads % 32 != 0 ||
      loads != kLoads || stages != kStages || smem != smem_bytes(threads, k))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // above 48 KB only by opting in
  if (!sized) {
    for (auto fn : {topk_lse_rows<true>, topk_lse_rows<false>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes(kMaxThreads, 16));
      if (e != cudaSuccess) return (int)e;
    }
    sized = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  if (k == 1)
    topk_lse_rows<true><<<R, threads, smem, st>>>(xf, (float*)vals, (int*)idx,
                                                  (float*)lse, V, k);
  else
    topk_lse_rows<false><<<R, threads, smem, st>>>(xf, (float*)vals,
                                                   (int*)idx, (float*)lse, V, k);
  return (int)cudaGetLastError();
}
