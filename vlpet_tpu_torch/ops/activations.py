"""gelu variants (vlpet_tpu/ops/activations.py): the erf form and HF's
tanh approximation ``gelu_new``. Eval only, so no custom backward."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-form gelu (jax.nn.gelu(approximate=False))."""
    return F.gelu(x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation gelu (HF gelu_new, jax.nn.gelu(approximate=True))."""
    return F.gelu(x, approximate="tanh")
