"""Exact top-k + logsumexp (kernel 4) and its plain twin.

Replaces both vlpet_tpu/ops/topk.py kernels, topk_lse_hier
(_hier_sweep_kernel) and topk_lse_exact (_topk_lse_kernel), which share one
contract: top-k values and indices in lax.top_k order (value descending,
then index ascending) and the row logsumexp. The CUDA kernel
(csrc/topk.cu) is exact by construction, so the TPU sweep's detector, its
lax.cond fallback and the 128-lane vocab pad have no counterpart here.
Bound on the H100 and design: see the note at the top of csrc/topk.cu;
``topk_plan`` is its launch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from vlpet_tpu_torch.ops import _build

# float4s a thread copies a group (csrc/topk.cu kLoads: 16 values), and the
# groups of the block's shared-memory ring (kStages: two in flight while one
# is read)
LOADS, STAGES = 4, 3
# the H100's SMs: rows that fit one wave at two 512-thread blocks an SM get
# 512 threads; only the speed depends on it
SMS = 132


@functools.lru_cache(maxsize=256)
def topk_plan(R: int, V: int, k: int) -> Tuple[int, int, int, int]:
    """(threads, float4s a thread a group, ring stages, shared bytes) of
    one launch of csrc/topk.cu over (R, V) at k: one block a row, streamed
    through the block's ring. At most 2 * SMS rows (the video beam's 250)
    take 512 threads a row, so that one wave holds every row (no row is
    split); more rows take 256 threads, four blocks an SM (the ring's
    shared memory and 64 registers a thread). Shared memory: the ring, the
    threshold (16 bytes), each warp's (max, sum) and k entries of 8
    bytes."""
    threads = 512 if R <= 2 * SMS and V >= 512 * 4 * LOADS else 256
    smem = STAGES * threads * LOADS * 16 + 16 + 8 * (threads // 32) * (k + 1)
    return threads, LOADS, STAGES, smem


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over the last axis: the first k of a STABLE descending
    sort, so equal values come out in ascending index order. (torch.topk
    leaves the order among equal values unspecified.)"""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_lse_reference(logits: torch.Tensor, k: int):
    """Plain version: (vals (R, k) f32, toks (R, k) int32, lse (R,) f32)."""
    x = logits.float()
    vals, idx = stable_topk(x, k)
    return vals, idx.to(torch.int32), torch.logsumexp(x, dim=-1)


def topk_lse(logits: torch.Tensor, k: int):
    """(vals (R, k) f32, toks (R, k) int32, lse (R,) f32) from f32 logits
    (R, V), 1 <= k <= min(16, V). CPU tensors run the plain version; CUDA
    tensors launch the kernel: one launch, on the caller's contiguous fp32
    tensor as it is (anything else raises)."""
    R, V = logits.shape
    if not 1 <= k <= min(16, V):
        raise ValueError(f"topk_lse: need 1 <= k <= min(16, V={V}), got {k}")
    if not _build.use_kernel(logits):
        return topk_lse_reference(logits, k)
    _build.check(logits, "logits", (torch.float32,), 2)
    dev = logits.device
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    toks = torch.empty((R, k), dtype=torch.int32, device=dev)
    lse = torch.empty((R,), dtype=torch.float32, device=dev)
    if R == 0:
        return vals, toks, lse
    _build.launch("vlpet_topk_lse", logits.data_ptr(), vals.data_ptr(),
                  toks.data_ptr(), lse.data_ptr(), R, V, k,
                  *topk_plan(R, V, k))
    topk_lse.launches += 1
    return vals, toks, lse


topk_lse.launches = 0
