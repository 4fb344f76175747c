"""Exact top-k + logsumexp (kernel 4) and its plain twin.

Replaces both vlpet_tpu/ops/topk.py kernels, topk_lse_hier
(_hier_sweep_kernel) and topk_lse_exact (_topk_lse_kernel), which share one
contract: top-k values and indices in lax.top_k order (value descending,
then index ascending) and the row logsumexp. The CUDA kernel
(csrc/topk.cu) is exact by construction, so the TPU sweep's detector, its
lax.cond fallback and the 128-lane vocab pad have no counterpart here.
Bound on the H100 and design: see the note at the top of csrc/topk.cu.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vlpet_tpu_torch.ops import _build


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
    tensors launch the kernel."""
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
                  toks.data_ptr(), lse.data_ptr(), R, V, k)
    topk_lse.launches += 1
    return vals, toks, lse


topk_lse.launches = 0
