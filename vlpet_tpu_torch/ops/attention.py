"""Fused attention, forward (kernel A1) and backward (kernel A6), and the
plain twin.

Replaces vlpet_tpu/ops/attention.py:fused_attention, whose TPU kernels are
_pallas_attention (_fwd_kernel) and _pallas_attention_bwd (_bwd_kernel)
under a custom_vjp. The layout is the JAX function's: q (B, L, H*Dh)
pre-scaled, k/v (B, S, H*Dh), an additive f32 padding mask (B|1, 1, 1, S)
broadcast inside the kernels, and ``causal`` for the decoder triangle with
past offset S - L. On CUDA tensors ``fused_attention`` is a
torch.autograd.Function: A1 forward (csrc/attention.cu), A6 backward
(csrc/attention_bwd.cu), which recomputes the softmax and gives dq, dk, dv;
the mask gets no gradient. Bounds on the H100 and designs: the header notes
of the two sources. Per-head masks, the T5 bias and probability dropout are
not on the ported path and are not accepted.
"""

from __future__ import annotations

import torch

from vlpet_tpu_torch.ops import _build

_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def _causal_allowed(L: int, S: int, device) -> torch.Tensor:
    """(L, S) bool: query i may see key j iff j <= i + (S - L)."""
    row = torch.arange(L, device=device)[:, None]
    col = torch.arange(S, device=device)[None, :]
    return col <= row + (S - L)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor,
                              num_heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain version (vlpet_tpu/ops/attention.py:984
    fused_attention_reference, no bias/dropout): fp32 logits plus the mask,
    hidden causal logits set to -1e9, fp32 softmax, probabilities cast to
    q's dtype before the value product. Autograd differentiates it."""
    B, L, inner = q.shape
    S = k.shape[1]
    hd = inner // num_heads
    qh = q.reshape(B, L, num_heads, hd)
    kh = k.reshape(B, S, num_heads, hd)
    vh = v.reshape(B, S, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    s = s + mask.float()
    if causal:
        s = torch.where(_causal_allowed(L, S, s.device), s,
                        torch.full((), -1e9, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return o.reshape(B, L, inner)


def _check(q, k, v, mask, num_heads):
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


def _kernel_inputs(q, k, v, mask, extra=()):
    dts = (torch.float32, torch.bfloat16)
    for t, n in ((q, "q"), (k, "k"), (v, "v")) + tuple(extra):
        _build.check(t, n, dts, 3)
        if t.dtype != q.dtype:
            raise TypeError(f"{n}: dtype {t.dtype} != q's {q.dtype}")
    m = mask.reshape(mask.shape[0], mask.shape[-1])
    _build.check(m, "mask", (torch.float32,), 2)
    return m


def _launch_fwd(q, k, v, mask, num_heads, causal):
    B, L, inner = q.shape
    S = k.shape[1]
    m = _kernel_inputs(q, k, v, mask)
    out = torch.empty_like(q)
    _build.launch("vlpet_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), out.data_ptr(), B, L, S,
                  num_heads, inner // num_heads, int(m.shape[0] == B),
                  int(causal), int(q.dtype == torch.bfloat16))
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, do: torch.Tensor, num_heads: int,
                        causal: bool = False):
    """(dq, dk, dv) of fused_attention for cotangent ``do`` (B, L, H*Dh), in
    the inputs' dtype: kernel A6 on CUDA tensors, autograd of the plain
    version on CPU tensors. The mask gets no gradient."""
    _check(q, k, v, mask, num_heads)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    if not _build.use_kernel(q, k, v, mask, do):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fused_attention_reference(*args, mask, num_heads, causal)
            return torch.autograd.grad(out, args, do)
    B, L, inner = q.shape
    S = k.shape[1]
    Dh = inner // num_heads
    smem = 4 * (2 * L * Dh + 2 * S * (Dh + 1) + 2 * L * S)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_attention_bwd: L {L}, S {S}, Dh {Dh} need "
                         f"{smem} B of shared memory per block (limit "
                         f"{_SMEM_LIMIT}); long sequences are not ported")
    do = do.contiguous()
    m = _kernel_inputs(q, k, v, mask, extra=((do, "do"),))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("vlpet_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), B, L, S, num_heads, Dh,
                  int(m.shape[0] == B), int(causal),
                  int(q.dtype == torch.bfloat16))
    fused_attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, causal):
        ctx.save_for_backward(q, k, v, mask)
        ctx.num_heads, ctx.causal = num_heads, causal
        return _launch_fwd(q, k, v, mask, num_heads, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, mask, do, ctx.num_heads,
                                         ctx.causal)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q . k^T + mask [causal]) . v per head -> (B, L, H*Dh) in q's
    dtype; differentiable in q, k, v.

    mask: additive (B|1, 1, 1, S). CPU tensors run the plain version; CUDA
    tensors launch A1 forward and A6 backward."""
    _check(q, k, v, mask, num_heads)
    if not _build.use_kernel(q, k, v, mask):
        return fused_attention_reference(q, k, v, mask, num_heads, causal)
    return _FusedAttention.apply(q, k, v, mask, num_heads, causal)


fused_attention.launches = 0
fused_attention_bwd.launches = 0
