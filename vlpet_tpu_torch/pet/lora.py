"""The LoRA layer family beyond ``LoRADense`` (pet/modules.py) and the
inference-time merge, ported from vlpet_tpu/pet/lora.py (reference:
src/lora/layers.py).

* ``LoRAEmbedding``: embedding + delta, A zeros and B normal(0, 1) (the
  reverse of the linear layers), so the delta starts at 0;
* ``LoRAMergedLinear``: a linear whose equal output blocks are adapted
  where ``enable_lora`` says (the packed-QKV use), the grouped delta
  scattered into the enabled blocks;
* ``LoRAConv2d``: an NHWC convolution with the delta folded onto the
  kernel;
* ``merge_lora`` / ``unmerge_lora`` / ``strip_lora``: the reference's
  eval()/train() weight folding, on the port's state_dict (a flat
  name -> tensor mapping).

Nothing on the training or decode path calls these. Names follow the flax
tree as everywhere in the port: a flax ``kernel`` is ``weight`` with its
last two axes swapped ((out, in) for the linear; the conv's HWIO kernel is
(kh, kw, out, in)); ``embedding``, ``lora_A``, ``lora_B`` and ``bias``
keep their names and shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.ops.hashdrop import hash_dropout
from vlpet_tpu_torch.pet.modules import normal_, uniform_


def lecun_normal_(p: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at 2 std, rescaled so the
    result has std 1/sqrt(fan_in)."""
    z = torch.empty(p.shape, device=g.device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=g)
    p.copy_(z * (1.0 / math.sqrt(fan_in)) / 0.87962566103423978)


class LoRAEmbedding(nn.Module):
    """Embedding + LoRA delta (vlpet_tpu/pet/lora.py:37)."""

    def __init__(self, num_embeddings: int, features: int, r: int = 0,
                 lora_alpha: int = 1, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.r, self.lora_alpha, self.dtype = r, lora_alpha, dtype
        self.embedding = nn.Parameter(torch.empty((num_embeddings, features),
                                                  device=dev))
        if r > 0:
            self.lora_A = nn.Parameter(torch.empty((r, num_embeddings),
                                                   device=dev))
            self.lora_B = nn.Parameter(torch.empty((features, r), device=dev))

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.embedding, 1.0, g)
        if self.r > 0:
            self.lora_A.zero_()
            normal_(self.lora_B, 1.0, g)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        y = self.embedding[ids].to(self.dtype)
        if self.r > 0:
            after_a = self.lora_A.t()[ids].to(self.dtype)
            y = y + (after_a @ self.lora_B.t().to(self.dtype)) * (
                self.lora_alpha / self.r)
        return y


class LoRAMergedLinear(nn.Module):
    """Linear with a grouped LoRA delta on the enabled output blocks
    (vlpet_tpu/pet/lora.py:67): A is (r * n_on, in), B (block * n_on, r).
    The dropout on the delta's input is the hash mask, drawn only when a
    call hands the layer its seed."""

    def __init__(self, in_dim: int, out_dim: int, r: int = 0,
                 lora_alpha: int = 1, enable_lora: Sequence[bool] = (False,),
                 lora_dropout: float = 0.0, use_bias: bool = True,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        if out_dim % len(enable_lora):
            raise ValueError(f"out_dim {out_dim} not divisible into "
                             f"{len(enable_lora)} blocks")
        dev = resolve_device(device)
        self.in_dim, self.out_dim, self.r = in_dim, out_dim, r
        self.lora_alpha, self.rate, self.dtype = lora_alpha, lora_dropout, dtype
        self.enable_lora = tuple(bool(e) for e in enable_lora)
        self.block = out_dim // len(enable_lora)
        n_on = sum(self.enable_lora)
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim), device=dev))
        self.bias = (nn.Parameter(torch.empty((out_dim,), device=dev))
                     if use_bias else None)
        if r > 0 and n_on:
            self.lora_A = nn.Parameter(torch.empty((r * n_on, in_dim),
                                                   device=dev))
            self.lora_B = nn.Parameter(torch.empty((self.block * n_on, r),
                                                   device=dev))

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_dim, g)
        if self.bias is not None:
            self.bias.zero_()
        if hasattr(self, "lora_A"):
            bound = 1.0 / math.sqrt(self.in_dim)
            uniform_(self.lora_A, -bound, bound, g)
            self.lora_B.zero_()

    def forward(self, x: torch.Tensor,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_dim).to(dt)
        y = x2 @ self.weight.to(dt).t()
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if hasattr(self, "lora_A"):
            xz = x2
            if seed is not None and self.rate > 0.0:
                xz = hash_dropout(xz, seed, self.rate)
            after_a = xz @ self.lora_A.t().to(dt)  # (N, r * n_on)
            scale = self.lora_alpha / self.r
            r, blk, g = self.r, self.block, 0
            parts = []
            for bi, on in enumerate(self.enable_lora):
                part = y[:, bi * blk:(bi + 1) * blk]
                if on:
                    bg = self.lora_B[g * blk:(g + 1) * blk].t().to(dt)
                    part = part + (after_a[:, g * r:(g + 1) * r] @ bg) * scale
                    g += 1
                parts.append(part)
            y = torch.cat(parts, dim=1)
        return y.reshape(lead + (self.out_dim,))


class LoRAConv2d(nn.Module):
    """NHWC convolution with the LoRA delta folded onto the kernel
    (vlpet_tpu/pet/lora.py:124): one convolution with
    W + (B @ A).view(out, in, kh, kw) * (alpha / r). ``weight`` is the
    flax HWIO kernel with its last two axes swapped, (kh, kw, out, in);
    ``padding`` "SAME" or "VALID", as lax.conv_general_dilated takes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 r: int = 0, lora_alpha: int = 1, stride: int = 1,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        dev = resolve_device(device)
        ks = kernel_size
        self.cin, self.cout, self.ks = in_channels, out_channels, ks
        self.r, self.lora_alpha, self.dtype = r, lora_alpha, dtype
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty((ks, ks, out_channels,
                                                in_channels), device=dev))
        if r > 0:
            self.lora_A = nn.Parameter(torch.empty((r * ks, in_channels * ks),
                                                   device=dev))
            self.lora_B = nn.Parameter(torch.empty((out_channels * ks, r * ks),
                                                   device=dev))
        self.bias = (nn.Parameter(torch.empty((out_channels,), device=dev))
                     if use_bias else None)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, self.ks * self.ks * self.cin, g)
        if self.r > 0:
            bound = 1.0 / math.sqrt(self.cin * self.ks)
            uniform_(self.lora_A, -bound, bound, g)
            self.lora_B.zero_()
        if self.bias is not None:
            self.bias.zero_()

    def _pad(self, n: int):
        if self.padding == "VALID":
            return 0, 0
        total = max((-(-n // self.stride) - 1) * self.stride + self.ks - n, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.permute(2, 3, 0, 1)  # (out, in, kh, kw)
        if self.r > 0:
            delta = (self.lora_B @ self.lora_A).reshape(
                self.cout, self.cin, self.ks, self.ks)
            w = w + delta * (self.lora_alpha / self.r)
        xc = x.to(dt).permute(0, 3, 1, 2)  # NCHW
        (t, b), (l, rt) = self._pad(x.shape[1]), self._pad(x.shape[2])
        y = F.conv2d(F.pad(xc, (l, rt, t, b)), w.to(dt), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def _merge(sd: Mapping[str, torch.Tensor], sign: float, alpha: float,
           task_idx: Optional[int]) -> Dict[str, torch.Tensor]:
    """Fold sign * (A @ B) * (alpha / r) into the base weight of every
    ``LoRADense`` (a module holding ``lora_A``, ``lora_B`` and
    ``base.weight``); a task-stacked one folds task ``task_idx``'s."""
    out = dict(sd)
    for name, a in sd.items():
        if not name.endswith("lora_A"):
            continue
        prefix = name[:-len("lora_A")]
        wname = prefix + "base.weight"
        if wname not in sd:
            continue
        b = sd[prefix + "lora_B"]
        if a.ndim == 3:
            if task_idx is None:
                raise ValueError("task-routed LoRA needs task_idx to merge")
            a, b = a[task_idx], b[task_idx]
        delta = (a.float() @ b.float()) * (alpha / a.shape[-1]) * sign
        w = out[wname]
        out[wname] = w + delta.t().to(w.dtype)
    return out


def merge_lora(sd: Mapping[str, torch.Tensor], lora_alpha: float,
               task_idx: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A state_dict with every LoRADense delta folded into its base weight
    (vlpet_tpu/pet/lora.py:201). The lora_A / lora_B entries stay; load the
    result into a LoRA-free model after ``strip_lora``."""
    return _merge(sd, +1.0, lora_alpha, task_idx)


def unmerge_lora(sd: Mapping[str, torch.Tensor], lora_alpha: float,
                 task_idx: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The inverse of ``merge_lora``."""
    return _merge(sd, -1.0, lora_alpha, task_idx)


def strip_lora(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop every lora_A / lora_B entry and hoist each LoRADense's base
    (``q_proj.base.weight`` -> ``q_proj.weight``), so a merged state_dict
    loads into a model built without LoRA (vlpet_tpu/pet/lora.py:219)."""
    bases = {name[:-len("lora_A")] for name in sd
             if name.endswith("lora_A")
             and name[:-len("lora_A")] + "base.weight" in sd}
    out = {}
    for name, t in sd.items():
        if name.rsplit(".", 1)[-1] in ("lora_A", "lora_B"):
            continue
        for prefix in bases:
            if name.startswith(prefix + "base."):
                name = prefix + name[len(prefix + "base."):]
                break
        out[name] = t
    return out
