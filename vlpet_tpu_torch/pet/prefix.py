"""Prefix tuning, ported from vlpet_tpu/pet/prefix.py: per-layer attention
K/V prefixes (``AttnPrefixController``) and the visual features as
per-encoder-layer K/V (``ResidualVisualPrefix``).

Both return, per layer, a (k, v) pair of (B, P, H*Dh) tensors, which the
attention concatenates before its own K and V (models/bart.py
``BartAttention``). The flat projection is read as (P, 2L, H, Dh): layer
i's k is slot 2i and its v slot 2i + 1, as in the JAX modules.

The prefixes do not depend on a position, so generation writes the
decoder's into the first P slots of the self-attention cache once and
decodes from slot P (models/generate.py ``seq2seq_generate``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.pet.modules import TaskDense, normal_

PrefixKV = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def _per_layer(flat: torch.Tensor, n_layers: int) -> PrefixKV:
    """(..., P, 2L * d) -> per layer (k, v), each (..., P, d): the flat
    row read as (2L, H, Dh), k at slot 2i and v at 2i + 1."""
    per = flat.reshape(flat.shape[:-1] + (2 * n_layers, -1))
    return tuple((per[..., 2 * i, :], per[..., 2 * i + 1, :])
                 for i in range(n_layers))


class AttnPrefixController(nn.Module):
    """``prefix_embedding`` (P, d) -> ``mlp_in`` (d -> mid) -> tanh ->
    ``mlp_out`` (mid -> 2 L d), broadcast over the batch
    (vlpet_tpu/pet/prefix.py:27). The table's init is normal(0, init_std),
    normal(0, 1) under an init_std of None; the dense layers take the
    model's generic init."""

    def __init__(self, preseqlen: int, n_layers: int, d_model: int,
                 mid_dim: int = 768, init_std: Optional[float] = 0.02,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.n_layers, self.init_std = n_layers, init_std
        self.prefix_embedding = nn.Parameter(torch.empty(
            (preseqlen, d_model), dtype=dtype, device=resolve_device(device)))
        kw = dict(dtype=dtype, device=device)
        self.mlp_in = TaskDense(d_model, mid_dim, **kw)
        self.mlp_out = TaskDense(mid_dim, n_layers * d_model * 2, **kw)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.prefix_embedding, self.init_std or 1.0, g)

    def forward(self, bsz: int) -> PrefixKV:
        flat = self.mlp_out(torch.tanh(self.mlp_in(self.prefix_embedding)))
        return tuple((k[None].expand((bsz,) + k.shape),
                      v[None].expand((bsz,) + v.shape))
                     for k, v in _per_layer(flat, self.n_layers))


class ResidualVisualPrefix(nn.Module):
    """Visual features (B, N, feat_dim) -> ``feat_prefix_projection``
    (feat_dim -> 2 L d) -> per encoder layer one (k, v) slot a visual token
    (vlpet_tpu/pet/prefix.py:61). Registered as the encoder's
    ``visual_embedding``."""

    def __init__(self, feat_dim: int, n_layers: int, d_model: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.n_layers = n_layers
        self.feat_prefix_projection = TaskDense(
            feat_dim, n_layers * d_model * 2, dtype=dtype, device=device)

    def forward(self, feats: torch.Tensor) -> PrefixKV:
        return _per_layer(self.feat_prefix_projection(feats), self.n_layers)
