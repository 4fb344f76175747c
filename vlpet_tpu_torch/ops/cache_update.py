"""In-place KV-cache slot write (kernel U1) and its plain twin.

Replaces vlpet_tpu/ops/cache_update.py:cache_slot_update (_update_kernel),
which aliases the (N, L, H, Dh) cache and DMAs the one (N, 1, H, Dh) time
slot into it. Here the cache is a PyTorch tensor written in place. It
serves every decode step's K and V write, the write that
``jax.lax.dynamic_update_slice`` performs in the JAX decode: the
time-major (L, B, H*Dh) decode cache is the N = 1 case, viewed as
(1, L, B, H*Dh). A step's K and V slots go through one launch
(``cache_slots_update``): the copy is a few microseconds of device time,
so what a launch costs is the host's enqueue, paid once a step and layer.
Bound on the H100 and design: csrc/cache_update.cu.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vlpet_tpu_torch.ops import _build


def cache_slot_update_reference(cache: torch.Tensor, new: torch.Tensor,
                                pos: int) -> torch.Tensor:
    """Plain twin: cache[:, pos] = new, in place; returns the cache."""
    cache[:, pos] = new.reshape(cache[:, pos].shape).to(cache.dtype)
    return cache


def cache_slots_update_reference(caches: Sequence[torch.Tensor],
                                 news: Sequence[torch.Tensor], pos: int):
    """Plain twin of the pair form: each write in turn; returns caches."""
    for cache, new in zip(caches, news):
        cache_slot_update_reference(cache, new, pos)
    return caches


def cache_slots_update(caches: Sequence[torch.Tensor],
                       news: Sequence[torch.Tensor], pos: int):
    """Write each ``news[i]`` (N, H, Dh), cast to the caches' dtype, into
    time slot ``pos`` of ``caches[i]`` (N, L, H, Dh), in place, for one or
    two (cache, new) pairs (a step's K and V); returns ``caches``. The
    caches share shape and dtype; the trailing dims may be any shape with
    H*Dh elements. CPU tensors run the plain twin; CUDA tensors launch U1
    once for all pairs (``cache_slot_update.launches`` counts it)."""
    n = len(caches)
    if n not in (1, 2) or len(news) != n:
        raise ValueError(f"cache_slots_update: one or two (cache, new) "
                         f"pairs, got {n} caches and {len(news)} slots")
    cache = caches[0]
    shape, dtype = cache.shape, cache.dtype
    N, L = shape[0], shape[1]
    if not 0 <= pos < L:
        raise ValueError(f"pos {pos} outside the cache [0, {L})")
    if n == 2 and (caches[1].shape != shape or caches[1].dtype != dtype):
        raise ValueError("cache_slots_update: the caches differ in shape "
                         "or dtype")
    slot = cache.numel() // L  # N rows of H*Dh
    for new in news:
        if new.numel() != slot:
            raise ValueError(f"new {tuple(new.shape)} does not fill a slot "
                             f"of cache {tuple(shape)}")
    if not _build.use_kernel(*caches, *news):
        return cache_slots_update_reference(caches, news, pos)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cache_slot_update: dtype {dtype}")
    if not all(c.is_contiguous() for c in caches):
        raise ValueError("cache_slot_update: the cache must be contiguous")
    srcs = [new if new.dtype == dtype and new.is_contiguous()
            else new.to(dtype).contiguous() for new in news]
    if slot == 0:
        return caches
    second = (caches[1].data_ptr(), srcs[1].data_ptr()) if n == 2 \
        else (None, None)
    _build.launch("vlpet_cache_update", cache.data_ptr(), srcs[0].data_ptr(),
                  *second, N, L, slot // N, cache.element_size(), int(pos))
    cache_slot_update.launches += 1
    return caches


def cache_slot_update(cache: torch.Tensor, new: torch.Tensor,
                      pos: int) -> torch.Tensor:
    """The one-cache case of cache_slots_update: ``new`` (N, H, Dh) into
    time slot ``pos`` of cache (N, L, H, Dh), in place; returns the same
    tensor."""
    cache_slots_update((cache,), (new,), pos)
    return cache


cache_slot_update.launches = 0
