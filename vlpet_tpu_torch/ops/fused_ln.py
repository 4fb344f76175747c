"""Fused residual dropout + add + LayerNorm (kernels L1 + L2) and its plain
twin.

Replaces vlpet_tpu/ops/fused_ln.py:fused_dropout_add_ln, whose TPU kernels
are _fwd_call_flat / _bwd_call_flat (L1, L2) and the 3-D _fwd_call /
_bwd_call (L3, L4). y = LayerNorm(res + dropout(h; rate)) * gamma + beta
with fp32 fast-variance statistics; the dropout mask is the hash of the
global flat element index (ops/hashdrop.py), regenerated in the backward,
so nothing but the inputs is saved. gamma and beta get true gradients (the
encoder LayerNorms train in VL-PET-large).

On CUDA tensors ``fused_dropout_add_ln`` is a torch.autograd.Function whose
forward launches L1 and whose backward launches L2 (csrc/fused_ln.cu:
bound and design in its header note); CPU tensors take the plain twin,
which autograd differentiates.
"""

from __future__ import annotations

import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.hashdrop import kernel_drop_args, keep_mask

EPS = 1e-5  # torch nn.LayerNorm's default, as HF BART uses it
_BWD_BLOCKS = 528  # row blocks of the backward: 4 per SM on 132 SMs
_ROWS_PER_BLOCK = 8  # one warp per row


def _scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def fused_dropout_add_ln_reference(h: torch.Tensor, res: torch.Tensor,
                                   gamma: torch.Tensor, beta: torch.Tensor,
                                   seed: torch.Tensor, rate: float,
                                   eps: float = EPS) -> torch.Tensor:
    """Plain version: the hash mask (ops/hashdrop.py) and the fp32
    fast-variance LayerNorm of vlpet_tpu/models/bart.py:138-142, in h's
    dtype."""
    hf = h.float()
    if rate > 0.0:
        keep = keep_mask(h.shape, 0, seed, rate, device=h.device)
        scale = torch.tensor(_scale(rate), dtype=torch.float32,
                             device=h.device)
        hf = torch.where(keep, hf * scale, torch.zeros_like(hf))
    x = res.float() + hf
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (x - mu) * (torch.rsqrt(var + eps) * gamma.float()) + beta.float()
    return y.to(h.dtype)


def _check(h, res, gamma, beta, seed, rate):
    D = h.shape[-1]
    if res.shape != h.shape or res.dtype != h.dtype:
        raise ValueError(f"res {tuple(res.shape)} {res.dtype} must match h "
                         f"{tuple(h.shape)} {h.dtype}")
    if gamma.shape != (D,) or (beta is not None and beta.shape != (D,)):
        raise ValueError(f"gamma/beta must be ({D},)")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be a (1,) int32 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate {rate} outside [0, 1)")


def _kernel_args(h, rate):
    N = h.numel() // h.shape[-1]
    return (N, h.shape[-1], *kernel_drop_args(rate))


def _check_kernel_inputs(h, res, gamma, seed, dy=None):
    if h.shape[-1] > 1024:
        raise ValueError(f"fused LayerNorm kernels: D {h.shape[-1]} > 1024")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h: dtype {h.dtype} not float32/bfloat16")
    for t, n in ((h, "h"), (res, "res"), (dy, "dy")):
        if t is not None and (t.dtype != h.dtype or not t.is_contiguous()):
            raise ValueError(f"{n}: must be contiguous {h.dtype}")
    _build.check(gamma, "gamma", (torch.float32,), 1)
    _build.check(seed, "seed", (torch.int32,), 1)


def _launch_fwd(h, res, gamma, beta, seed, rate, eps):
    _check_kernel_inputs(h, res, gamma, seed)
    _build.check(beta, "beta", (torch.float32,), 1)
    y = torch.empty_like(h)
    N, D, drop, thr, scale = _kernel_args(h, rate)
    if N == 0:
        return y
    _build.launch("vlpet_ln_fwd", h.data_ptr(), res.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), seed.data_ptr(),
                  y.data_ptr(), N, D, drop, thr, scale, eps,
                  int(h.dtype == torch.bfloat16))
    fused_dropout_add_ln.launches += 1
    return y


def fused_dropout_add_ln_bwd(h: torch.Tensor, res: torch.Tensor,
                             gamma: torch.Tensor, seed: torch.Tensor,
                             dy: torch.Tensor, rate: float,
                             eps: float = EPS):
    """(dh, dres, dgamma, dbeta) of fused_dropout_add_ln for cotangent dy:
    kernel L2 on CUDA tensors (dgamma/dbeta fp32, summed in a fixed order),
    autograd of the plain version on CPU tensors."""
    if dy.shape != h.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match h {tuple(h.shape)}")
    _check(h, res, gamma, None, seed, rate)
    if not _build.use_kernel(h, res, gamma, seed, dy):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (h, res, gamma)]
            beta = torch.zeros_like(gamma, requires_grad=True)
            y = fused_dropout_add_ln_reference(*args, beta, seed, rate, eps)
            return torch.autograd.grad(y, (*args, beta), dy)
    dy = dy.contiguous()
    _check_kernel_inputs(h, res, gamma, seed, dy)
    N, D, drop, thr, scale = _kernel_args(h, rate)
    dh, dres = torch.empty_like(h), torch.empty_like(res)
    dg = torch.empty(D, dtype=torch.float32, device=h.device)
    db = torch.empty(D, dtype=torch.float32, device=h.device)
    if N == 0:
        return dh, dres, dg.zero_(), db.zero_()
    G = min(-(-N // _ROWS_PER_BLOCK), _BWD_BLOCKS)
    partial = torch.empty((G, 2, D), dtype=torch.float32, device=h.device)
    _build.launch("vlpet_ln_bwd", h.data_ptr(), res.data_ptr(),
                  gamma.data_ptr(), seed.data_ptr(), dy.data_ptr(),
                  dh.data_ptr(), dres.data_ptr(), partial.data_ptr(),
                  dg.data_ptr(), db.data_ptr(), N, D, G, drop, thr, scale,
                  eps, int(h.dtype == torch.bfloat16))
    fused_dropout_add_ln_bwd.launches += 1
    return dh, dres, dg, db


class _FusedDropoutAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, res, gamma, beta, seed, rate, eps):
        ctx.save_for_backward(h, res, gamma, seed)
        ctx.rate, ctx.eps = rate, eps
        return _launch_fwd(h, res, gamma, beta, seed, rate, eps)

    @staticmethod
    def backward(ctx, dy):
        h, res, gamma, seed = ctx.saved_tensors
        dh, dres, dg, db = fused_dropout_add_ln_bwd(h, res, gamma, seed, dy,
                                                    ctx.rate, ctx.eps)
        return dh, dres, dg, db, None, None, None


def fused_dropout_add_ln(h: torch.Tensor, res: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         seed: torch.Tensor, rate: float,
                         eps: float = EPS) -> torch.Tensor:
    """y = LayerNorm(res + dropout(h; rate)) * gamma + beta in h's dtype.

    h, res (..., D) of one dtype; gamma, beta (D,) fp32; seed (1,) int32
    (drives the hash mask; a device tensor on CUDA, read by the kernel).
    CPU tensors run the plain version; CUDA tensors launch L1 forward and
    L2 backward (D <= 1024)."""
    _check(h, res, gamma, beta, seed, rate)
    if not _build.use_kernel(h, res, gamma, beta, seed):
        return fused_dropout_add_ln_reference(h, res, gamma, beta, seed, rate,
                                              eps)
    return _FusedDropoutAddLN.apply(h.contiguous(), res.contiguous(), gamma,
                                    beta, seed, rate, eps)


fused_dropout_add_ln.launches = 0
fused_dropout_add_ln_bwd.launches = 0
