"""In-place KV-cache slot write (kernel U1) and its plain twin.

Replaces vlpet_tpu/ops/cache_update.py:cache_slot_update (_update_kernel),
which aliases the (N, L, H, Dh) cache and DMAs the one (N, 1, H, Dh) time
slot into it. Here the cache is a PyTorch tensor written in place. It
serves every decode step's K and V write, the write that
``jax.lax.dynamic_update_slice`` performs in the JAX decode: the
time-major (L, B, H*Dh) decode cache is the N = 1 case, viewed as
(1, L, B, H*Dh). Bound on the H100 and design: csrc/cache_update.cu.
"""

from __future__ import annotations

import math

import torch

from vlpet_tpu_torch.ops import _build


def cache_slot_update_reference(cache: torch.Tensor, new: torch.Tensor,
                                pos: int) -> torch.Tensor:
    """Plain twin: cache[:, pos] = new, in place; returns the cache."""
    cache[:, pos] = new.reshape(cache[:, pos].shape).to(cache.dtype)
    return cache


def cache_slot_update(cache: torch.Tensor, new: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """Write ``new`` (N, H, Dh), cast to the cache's dtype, into time slot
    ``pos`` of cache (N, L, H, Dh), in place; returns the same tensor. The
    trailing dims may be any shape with H*Dh elements. CPU tensors run the
    plain twin; CUDA tensors launch U1."""
    N, L = cache.shape[:2]
    if not 0 <= pos < L:
        raise ValueError(f"pos {pos} outside the cache [0, {L})")
    row = math.prod(cache.shape[2:])
    if new.numel() != N * row:
        raise ValueError(f"new {tuple(new.shape)} does not fill a slot of "
                         f"cache {tuple(cache.shape)}")
    if not _build.use_kernel(cache, new):
        return cache_slot_update_reference(cache, new, pos)
    if cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cache_slot_update: dtype {cache.dtype}")
    if not cache.is_contiguous():
        raise ValueError("cache_slot_update: the cache must be contiguous")
    src = new.to(cache.dtype).contiguous()
    if src.numel() == 0:
        return cache
    _build.launch("vlpet_cache_update", cache.data_ptr(), src.data_ptr(), N,
                  L, row, cache.element_size(), int(pos))
    cache_slot_update.launches += 1
    return cache


cache_slot_update.launches = 0
