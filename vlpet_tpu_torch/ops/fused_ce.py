"""Streamed linear + cross-entropy, forward (kernel C1) and backward
(kernel C2), and their plain twins.

Replaces vlpet_tpu/ops/fused_ce.py:fused_linear_ce, whose TPU kernels are
_run_fwd (_fwd_kernel, C1) and _run_bwd (_bwd_kernel, C2) under a
custom_vjp: the per-token cross-entropy of x . W^T + b straight from the
decoder states, with an online logsumexp over vocab tiles, so the (N, V)
logits never exist; the backward recomputes each tile and accumulates
dx = ((softmax - onehot) * dloss) . W. Bound on the H100 and design: the
header note of csrc/fused_ce.cu. In bf16 both kernels stream W, with its
bias, from a copy re-laid out tile by tile (``w_tiles``); the forward
makes it and the autograd Function hands it to the backward, so a step
re-lays the head once (the copy, V x D bf16, lives from C1 to C2).

The frozen-head contract (vlpet_tpu/ops/fused_ce.py:11-15): W (the tied
``shared`` embedding) and the bias get no gradient. The JAX package returns
zeros for them; the models here route a trainable head to the dense loss,
so ``fused_linear_ce`` raises when w or b requires a gradient instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.ce import IGNORE, _logits_f32

_TV = 64                 # vocab tile of the fp32 kernels (csrc/fused_ce.cu kTV)
_TC_TV = 32              # vocab tile of the bf16 kernels and of wt (kCTV)
_FWD_ROWS = {torch.bfloat16: 64, torch.float32: 32}  # rows a C1 block
_BLOCKS_PER_SM = 4       # vocab splits: about this many blocks a SM
_BWD_DIMS = (512, 768, 1024)
# rows a bf16 backward block takes, by D (csrc/fused_ce.cu vlpet_ce_bwd):
# its fp32 dx accumulator, rows x D, lives in registers, and its x rows and
# the ring of W tiles in shared memory
_BWD_ROWS = {512: 64, 768: 64, 1024: 32}


def fused_linear_ce_reference(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, labels: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of C1 (vlpet_tpu/ops/fused_ce.py:44-112): the logits in
    fp32 from the x-dtype operands (``ops.ce._logits_f32``), the fp32 bias
    added, lse over the V columns, loss = lse - logit[label] and 0 where
    the label is -100. Returns (loss, lse), (N,) fp32 each; autograd
    differentiates it."""
    logits = _logits_f32(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0)
    picked = logits.gather(1, safe[:, None].long())[:, 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse)), lse


def fused_linear_ce_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, labels: torch.Tensor,
                                  lse: torch.Tensor,
                                  dloss: torch.Tensor) -> torch.Tensor:
    """Plain twin of C2 (vlpet_tpu/ops/fused_ce.py:80-112): g =
    (exp(logit - lse) - onehot) * dloss, 0 on ignored rows, rounded to x's
    dtype; dx = g . W (W in x's dtype) accumulated in fp32, cast to x's
    dtype."""
    logits = _logits_f32(x, w, b)
    p = torch.exp(logits - lse.float()[:, None])
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    p[torch.arange(p.shape[0], device=p.device), safe] -= 1.0
    scale = torch.where(valid, dloss.float(), torch.zeros_like(lse))
    g = (p * scale[:, None]).to(x.dtype)
    return (g.float() @ w.to(x.dtype).float()).to(x.dtype)


def _check(x, w, b, labels):
    N, D = x.shape
    V = w.shape[0]
    if w.shape != (V, D) or b.shape != (V,) or labels.shape != (N,):
        raise ValueError(f"fused_linear_ce: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, labels "
                         f"{tuple(labels.shape)} do not match")


def vocab_splits(rows_per_block: int, N: int, V: int, sms: int,
                 tile: int = _TV) -> int:
    """Vocab splits of ``tile``-column tiles: enough blocks for about
    _BLOCKS_PER_SM an SM, no split empty (each takes ceil(tiles / splits)
    tiles, the last the rest). A function of the shapes and the SM count,
    so a result does not change from call to call."""
    tiles = -(-V // tile)
    row_blocks = -(-N // rows_per_block)
    want = min(tiles, max(1, -(-_BLOCKS_PER_SM * sms // row_blocks)))
    per = -(-tiles // want)
    return -(-tiles // per)


def _splits(rows_per_block: int, N: int, V: int, device,
            tile: int = _TV) -> int:
    return vocab_splits(rows_per_block, N, V,
                        _build.multiprocessors(device), tile)


def w_tiles(wc: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The bf16 head wc (V, D) and its fp32 bias re-laid out for C1 and
    C2: ceil(V / 32) tiles of 32 rows, chunk-major, each followed by its
    32 biases (csrc/fused_ce.cu ce_w_tiles)."""
    V, D = wc.shape
    wt = torch.empty(-(-V // _TC_TV) * (_TC_TV * D + 2 * _TC_TV),
                     dtype=torch.bfloat16, device=wc.device)
    _build.launch("vlpet_ce_w_tiles", wc.data_ptr(), bf.data_ptr(),
                  wt.data_ptr(), V, D)
    return wt


def _kernel_inputs(x, w, b, labels):
    """Kernel input guard; returns (w in x's dtype, b fp32, labels int32),
    contiguous."""
    _build.check(x, "x", (torch.float32, torch.bfloat16), 2)
    D = x.shape[1]
    if D % 32:
        raise ValueError(f"fused_linear_ce: need D % 32 == 0, got D={D}")
    wc = w.to(x.dtype).contiguous()
    if x.data_ptr() % 16 or wc.data_ptr() % 16:
        raise ValueError("fused_linear_ce: x and w must be 16-byte aligned")
    return (wc, b.float().contiguous(),
            labels.to(torch.int32).contiguous())


def _launch_fwd(x, wc, bf, lab):
    """C1: (loss, lse, wt), wt the re-laid head (bf16; None for fp32)."""
    N, D = x.shape
    V = wc.shape[0]
    bf16 = x.dtype == torch.bfloat16
    loss = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return loss, lse, None
    wt = w_tiles(wc, bf) if bf16 else None
    S = _splits(_FWD_ROWS[x.dtype], N, V, x.device,
                _TC_TV if bf16 else _TV)
    part = torch.empty((3, S, N), dtype=torch.float32, device=x.device)
    _build.launch("vlpet_ce_fwd", x.data_ptr(), wc.data_ptr(), bf.data_ptr(),
                  lab.data_ptr(), None if wt is None else wt.data_ptr(),
                  part.data_ptr(), loss.data_ptr(), lse.data_ptr(), N, D, V,
                  S, int(bf16))
    fused_linear_ce.launches += 1
    return loss, lse, wt


def fused_linear_ce_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        labels: torch.Tensor, lse: torch.Tensor,
                        dloss: torch.Tensor,
                        wt: torch.Tensor = None) -> torch.Tensor:
    """dx (x's dtype) of fused_linear_ce for the per-token cotangent dloss,
    from the forward's row lse: kernel C2 on CUDA tensors (D 512, 768 or
    1024), the plain twin on CPU tensors. ``wt``, bf16 only: the forward's
    re-laid head (``w_tiles`` of the same w and b); made here when None."""
    _check(x, w, b, labels)
    ts = (x, w, b, labels, lse, dloss)
    if not _build.use_kernel(*ts):
        return fused_linear_ce_bwd_reference(x, w, b, labels, lse, dloss)
    x = x.contiguous()
    N, D = x.shape
    if D not in _BWD_DIMS:
        raise ValueError(f"fused_linear_ce_bwd: D must be one of "
                         f"{_BWD_DIMS}, got {D}")
    wc, bf, lab = _kernel_inputs(x, w, b, labels)
    lse = lse.float().contiguous()
    dl = dloss.float().contiguous()
    dx = torch.empty_like(x)
    if N == 0:
        return dx
    V = wc.shape[0]
    if x.dtype == torch.bfloat16:
        S = _splits(_BWD_ROWS[D], N, V, x.device, _TC_TV)
        if wt is None:
            wt = w_tiles(wc, bf)
        elif wt.numel() != -(-V // _TC_TV) * (_TC_TV * D + 2 * _TC_TV):
            raise ValueError("fused_linear_ce_bwd: wt is not the re-laid "
                             "head of this w")
    else:
        wt = None
        S = _splits(32, N, V, x.device)
    part = torch.empty((S, N, D), dtype=torch.float32, device=x.device)
    _build.launch("vlpet_ce_bwd", x.data_ptr(), wc.data_ptr(), bf.data_ptr(),
                  lab.data_ptr(), lse.data_ptr(), dl.data_ptr(),
                  None if wt is None else wt.data_ptr(), part.data_ptr(),
                  dx.data_ptr(), N, D, V, S, int(x.dtype == torch.bfloat16))
    fused_linear_ce_bwd.launches += 1
    return dx


class _FusedLinearCE(torch.autograd.Function):
    """(loss, lse) with the backward from the saved row lse: the kernels
    (``kernels``) or the plain twins."""

    @staticmethod
    def forward(ctx, x, w, b, labels, kernels):
        wt = None
        if kernels:  # the head cast to x's dtype (and re-laid) once for C2
            w, b, labels = _kernel_inputs(x, w, b, labels)
            loss, lse, wt = _launch_fwd(x, w, b, labels)
        else:
            loss, lse = fused_linear_ce_reference(x, w, b, labels)
        ctx.save_for_backward(x, w, b, labels, lse)
        ctx.kernels, ctx.wt = kernels, wt
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, dloss, _):
        x, w, b, labels, lse = ctx.saved_tensors
        if ctx.kernels:
            dx = fused_linear_ce_bwd(x, w, b, labels, lse, dloss, ctx.wt)
        else:
            dx = fused_linear_ce_bwd_reference(x, w, b, labels, lse, dloss)
        ctx.wt = None
        return dx, None, None, None, None


def _frozen(name, w, b):
    if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
        raise ValueError(f"{name}: the head w and the bias b are frozen (no "
                         f"gradient); take the dense loss to train them")


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE of softmax(x . w^T + b) against labels (-100 ignored),
    differentiable in x. x (N, D) bf16/fp32; w (V, D), cast to x's dtype;
    b (V,) fp32; labels (N,) int. Returns (loss, lse), (N,) fp32 each:
    loss 0 at ignored rows, lse the row logsumexp the backward keeps. Raises
    when w or b requires a gradient while autograd is on (the frozen-head
    contract). CPU tensors run the plain twins; CUDA tensors launch C1
    forward and C2 backward."""
    _check(x, w, b, labels)
    _frozen("fused_linear_ce", w, b)
    kernels = _build.use_kernel(x, w, b, labels)
    return _FusedLinearCE.apply(x.contiguous() if kernels else x, w, b,
                                labels, kernels)


def fused_linear_ce_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_linear_ce`` through the plain twins on any device (the
    model's route inside ``ops.plain_twins()``)."""
    _check(x, w, b, labels)
    _frozen("fused_linear_ce", w, b)
    return _FusedLinearCE.apply(x, w, b, labels, False)


fused_linear_ce.launches = 0
fused_linear_ce_bwd.launches = 0
