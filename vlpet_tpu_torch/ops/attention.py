"""Fused attention forward (kernel 1) and its plain twin.

Replaces vlpet_tpu/ops/attention.py:fused_attention, whose TPU kernel is
_pallas_attention (_fwd_kernel). The CUDA kernel (csrc/attention.cu) keeps
the layout of the JAX function: q (B, L, H*Dh) pre-scaled, k/v
(B, S, H*Dh), an additive f32 padding mask (B|1, 1, 1, S) broadcast inside
the kernel. Bound on the H100 and design: see the note at the top of
csrc/attention.cu. Causal masks, per-head masks, biases and dropout are not
on the ported path and are not accepted.
"""

from __future__ import annotations

import torch

from vlpet_tpu_torch.ops import _build


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain version (vlpet_tpu/ops/attention.py:984
    fused_attention_reference, no causal/bias/dropout): fp32 logits and
    softmax, probabilities cast to q's dtype before the value product."""
    B, L, inner = q.shape
    S = k.shape[1]
    hd = inner // num_heads
    qh = q.reshape(B, L, num_heads, hd)
    kh = k.reshape(B, S, num_heads, hd)
    vh = v.reshape(B, S, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    s = s + mask.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return o.reshape(B, L, inner)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q . k^T + mask) . v per head -> (B, L, H*Dh) in q's dtype.

    mask: additive (B|1, 1, 1, S). CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    B, L, inner = q.shape
    S = k.shape[1]
    if k.shape != (B, S, inner) or v.shape != (B, S, inner):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if (mask.dim() != 4 or mask.shape[1:] != (1, 1, S)
            or mask.shape[0] not in (1, B)):
        raise ValueError(f"mask must be additive (B|1, 1, 1, S={S}); got "
                         f"{tuple(mask.shape)} (per-head or per-query masks "
                         "are not supported)")
    if inner % num_heads:
        raise ValueError(f"inner {inner} not divisible by {num_heads} heads")
    if not _build.use_kernel(q, k, v, mask):
        return fused_attention_reference(q, k, v, mask, num_heads)
    dts = (torch.float32, torch.bfloat16)
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        _build.check(t, n, dts, 3)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share a dtype")
    m = mask.reshape(mask.shape[0], S)
    _build.check(m, "mask", (torch.float32,), 2)
    out = torch.empty_like(q)
    _build.launch("vlpet_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), out.data_ptr(), B, L, S,
                  num_heads, inner // num_heads, int(m.shape[0] == B),
                  int(q.dtype == torch.bfloat16))
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
