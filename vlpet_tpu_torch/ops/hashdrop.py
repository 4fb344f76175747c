"""Counter-based dropout masks, bit-equal to vlpet_tpu/ops/hashdrop.py.

``keep_mask`` hashes the GLOBAL flat element index with a murmur3
finalizer, so a kernel's backward regenerates the forward's mask from
(seed, index) without storing it, and the plain twins compute the same mask
with tensor ops. P(keep) = 1 - rate, decided on 31 bits.

The JAX functions work in uint32. Here every value is an int64 tensor that
holds a uint32 (0 <= v < 2**32): each product is split into 16-bit halves
so that no intermediate leaves int64's range, and each sum and shift is
masked back to 32 bits. The CUDA kernels (``hash_bits`` in
csrc/common.cuh: the LayerNorm, attention and FFN kernels) compute the
same function in native uint32.

``head_seed`` is vlpet_tpu/ops/attention.py:50 (the per-head seed of the
attention kernels' dropout); ``attention_keep_mask`` is the probability
mask of the attention kernels (vlpet_tpu/ops/attention.py:1001-1006).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and an int
    constant c in [0, 2**32)."""
    lo = (a & 0xFFFF) * c                       # < 2**48
    hi = ((a >> 16) * (c & 0xFFFF)) & 0xFFFF    # a_hi * c mod 2**16
    return (lo + (hi << 16)) & _M32


def _seed_u32(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return _u32(seed.reshape(()).to(device))
    return torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)


def keep_threshold(rate: float) -> int:
    """The 31-bit threshold: keep iff (hash & 0x7FFFFFFF) >= threshold."""
    return int(rate * (1 << 31))


def keep_mask(shape: Sequence[int], row_base, seed, rate: float,
              device=None) -> torch.Tensor:
    """Boolean keep mask of ``shape``; element identity = global flat index
    where dim 0 is offset by ``row_base`` (uint32 arithmetic, as in
    vlpet_tpu/ops/hashdrop.py:21). ``seed`` is an int or a one-element
    integer tensor (its device is used unless ``device`` is given)."""
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    shape = tuple(int(s) for s in shape)
    nd = len(shape)

    def iota(d):
        view = [1] * nd
        view[d] = shape[d]
        return torch.arange(shape[d], dtype=torch.int64,
                            device=device).reshape(view)

    idx = (iota(0) + (int(row_base) & _M32)) & _M32
    for d in range(1, nd):
        idx = (_mul32(idx, shape[d]) + iota(d)) & _M32
    z = (_mul32(idx, 2654435761) + _seed_u32(seed, device)) & _M32
    z = z ^ (z >> 16)
    z = _mul32(z, 0x7FEB352D)
    z = z ^ (z >> 15)
    z = _mul32(z, 0x846CA68B)
    z = z ^ (z >> 16)
    return ((z & 0x7FFFFFFF) >= keep_threshold(rate)).expand(shape)


def check_drop(rate: float, seed) -> None:
    """A dropping op's arguments: rate in [0, 1) and, when rate > 0, a (1,)
    int32 seed tensor."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate > 0.0 and (not isinstance(seed, torch.Tensor)
                       or seed.shape != (1,) or seed.dtype != torch.int32):
        raise ValueError("rate > 0 needs a (1,) int32 seed tensor")


def kernel_drop_args(rate: float):
    """(drop, thr, scale) of a dropping kernel's launch: whether rate > 0,
    the 31-bit keep threshold and 1 / (1 - rate)."""
    return int(rate > 0.0), keep_threshold(rate), 1.0 / (1.0 - rate)


def hash_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Dropout from the hash mask over x's whole flat index
    (vlpet_tpu/ops/hashdrop.py:57): kept elements scaled by 1/(1-rate)
    rounded to x's dtype, as the JAX function does."""
    keep = keep_mask(x.shape, 0, seed, rate, device=x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


def head_seed(seed, h: int) -> torch.Tensor:
    """Per-head seed of the attention dropout: (seed + h * 0x9E3779B9) mod
    2**32, as an int64 tensor holding the uint32."""
    device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    return (_seed_u32(seed, device) + _mul32(
        torch.tensor(int(h) & _M32, dtype=torch.int64, device=device),
        0x9E3779B9)) & _M32


def attention_keep_mask(batch: int, L: int, S: int, num_heads: int, seed,
                        rate: float, device=None) -> torch.Tensor:
    """(B, H, L, S) keep mask of the attention probabilities: head h keeps
    element (b, i, j) iff keep_mask((B, L, S), 0, head_seed(seed, h),
    rate), i.e. the hash of the flat index (b * L + i) * S + j under the
    head's seed."""
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    return torch.stack([keep_mask((batch, L, S), 0, head_seed(seed, h), rate,
                                  device=device)
                        for h in range(num_heads)], dim=1)


class DropoutSeeds:
    """The dropout seeds of one training step: ``n`` int32 values in
    [0, 2**31 - 1) drawn from ``generator`` in ONE call, handed out in
    call order as (1,) views by ``next()`` (a kernel reads its seed by
    pointer, so no site syncs with the host). The model consumes them in a
    fixed site order (``VLBart.dropout_sites``, ``VLT5.dropout_sites``)."""

    def __init__(self, n: int, generator: Optional[torch.Generator],
                 device):
        self.seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=generator,
                                   device=device, dtype=torch.int32)
        self.used = 0

    def next(self) -> torch.Tensor:
        if self.used >= self.seeds.numel():
            raise RuntimeError(f"more dropout sites than the {self.seeds.numel()}"
                               f" seeds drawn for the step")
        s = self.seeds[self.used:self.used + 1]
        self.used += 1
        return s
