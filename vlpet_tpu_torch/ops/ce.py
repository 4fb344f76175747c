"""Cross-entropy losses of the port, ported from vlpet_tpu/ops/ce.py
(``linear_ce``) and vlpet_tpu/models/vlbart.py:376
(``cross_entropy_with_ignore``).

``linear_ce`` keeps the JAX custom_vjp's schedule: the logits GEMM with an
fp32 result, the logits saved ONCE in bf16 with the fp32 logsumexp, and in
the backward the softmax recomputed from the saved bf16 logits and the
dlogits emitted in bf16 before the dx product. It is not a Pallas kernel in
the JAX package (XLA computes it), so plain torch is its port. Labels equal
to -100 are ignored (loss 0, no gradient).
"""

from __future__ import annotations

import torch

IGNORE = -100


def _logits_f32(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """fp32 logits of x (N, d) against w (V, d) rounded to x's dtype: the
    operands multiplied in fp32 (the exact value of a low-precision GEMM
    with fp32 accumulation and output)."""
    return x.float() @ w.to(x.dtype).float().t() + b.float()


class _LinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, labels):
        logits = _logits_f32(x, w, b)
        lse = torch.logsumexp(logits, dim=-1)
        valid = labels != IGNORE
        safe = torch.where(valid, labels, 0)
        picked = logits.gather(1, safe[:, None])[:, 0]
        nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
        logits_bf16 = logits.to(torch.bfloat16)
        ctx.save_for_backward(x, w, logits_bf16, lse, labels)
        ctx.mark_non_differentiable(logits_bf16)
        return nll, logits_bf16

    @staticmethod
    def backward(ctx, g, _):
        x, w, logits_bf16, lse, labels = ctx.saved_tensors
        valid = labels != IGNORE
        safe = torch.where(valid, labels, 0)
        gv = torch.where(valid, g, torch.zeros_like(g))
        p = torch.exp(logits_bf16.float() - lse[:, None])
        p[torch.arange(p.shape[0], device=p.device), safe] -= 1.0
        dlogits = (p * gv[:, None]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (dlogits @ wb if x.dtype == torch.bfloat16
                  else (dlogits.float() @ wb.float()).to(x.dtype))
        if ctx.needs_input_grad[1]:
            dw = (dlogits.float().t() @ x.float()).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dlogits.float().sum(dim=0)
        return dx, dw, db, None


def linear_ce(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              labels: torch.Tensor):
    """x (N, d) activations; w (V, d) the tied LM head; b (V,)
    final_logits_bias; labels (N,) int with -100 = ignore. Returns (per-token
    nll (N,) fp32 with 0 at ignored positions, the logits as the bf16 copy
    the backward keeps)."""
    return _LinearCE.apply(x, w, b, labels)


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              reduce: bool = False) -> torch.Tensor:
    """CE with ignore_index=-100 over fp32 logits (B, T, V):
    per-token (B, T) with 0 at ignored positions, or the mean over the
    valid tokens when ``reduce``."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return mean_or_per_token(nll, labels, reduce)


def mean_or_per_token(per_tok: torch.Tensor, labels: torch.Tensor,
                      reduce: bool) -> torch.Tensor:
    """Per-token losses (B, T) as they are, or their mean over the valid
    (label != -100) tokens when ``reduce``."""
    if reduce:
        return per_tok.sum() / (labels != IGNORE).sum().clamp(min=1)
    return per_tok
