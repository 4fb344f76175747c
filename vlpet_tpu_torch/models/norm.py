"""LayerNorm and RMSNorm with flax's numerics (the port's counterparts of
flax.linen.LayerNorm and flax.linen.RMSNorm as the JAX package uses them).

flax computes the statistics in fp32 with the fast variance
max(0, E[x^2] - E[x]^2) and eps 1e-5, then (x - mu) * (rsqrt(var + eps) *
scale) + bias; torch's two-pass layer_norm differs in the last bits, which
is enough to flip near-tied tokens in a decode (the hypernets' LayerNorm
takes eps 1e-6). Parameters are ``scale`` and
``bias`` as in the flax tree, kept in fp32. RMSNorm (T5) takes the fp32
mean of squares and gives x * (rsqrt(ms + eps) * scale) in the compute
dtype; its one parameter is ``scale``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vlpet_tpu_torch.device import Device, resolve_device


EPS = 1e-5  # torch nn.LayerNorm's default, as HF BART uses it


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype, eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(out_dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda", eps: float = EPS):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.dtype, self.eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             out_dtype: torch.dtype) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * (torch.rsqrt(ms + eps) * scale)).to(out_dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim,
                                             device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps, self.dtype)
