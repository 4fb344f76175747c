"""Fused FFN, forward (kernel F1) and backward (kernel F2), the gated FFN's
forward (kernel F3), and their plain twins.

Replaces vlpet_tpu/ops/ffn.py:fused_ffn, whose TPU kernels are _run with
_fwd_kernel (F1) and with _bwd_kernel (F2) under a custom_vjp:
y = act(x . W1 + b1) . W2 + b2 with the (N, F) hidden kept off device
memory; the backward recomputes fc1 and gives dx, db1 and db2. The weight
matrices are frozen, as ``ffn_supported`` requires in the JAX package: the
Function has no dW1/dW2 and raises when either weight requires a gradient
(the model routes a trainable language model to the plain fc1 -> act ->
fc2). Weights here are in PyTorch's Linear layout, W1 (F, D) and W2 (D, F).
Bound on the H100 and design: the header note of csrc/ffn.cu. bf16 runs on
tensor cores (WMMA), fp32 on plain FMA. The activation is gelu, gelu_new or
relu (T5); F2 has no relu yet, so relu raises where a gradient is asked
for. Activation dropout is not on the ported path.

``fused_gated_ffn`` replaces vlpet_tpu/ops/ffn.py:fused_gated_ffn (_run with
_gated_fwd_kernel, F3): y = (act(x . W0^T) * (x . W1^T)) . Wo^T, the
t5-v1.1 gated-gelu FFN, with both (N, F) hiddens kept off device memory.
It is eval only: its backward (_gated_bwd_kernel, F4) is not ported, and a
call that needs a gradient raises NotImplementedError.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.activations import gelu, gelu_new

_ACTS = {"gelu": (0, gelu), "gelu_new": (1, gelu_new),
         "relu": (2, torch.relu)}
_ROWS = {torch.bfloat16: 32, torch.float32: 16}  # rows per kernel block


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  act: str = "gelu") -> torch.Tensor:
    """Plain fc1 -> act -> fc2 in x's dtype (the JAX package's unfused
    TaskDense path); autograd differentiates it."""
    fn = _ACTS[act][1]
    h = fn(F.linear(x, w1.to(x.dtype), b1.to(x.dtype)))
    return F.linear(h, w2.to(x.dtype), b2.to(x.dtype))


def _check(x, w1, b1, w2, b2, act):
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    N, D = x.shape
    Fh = w1.shape[0]
    if w1.shape != (Fh, D) or w2.shape != (D, Fh) or b1.shape != (Fh,) \
            or b2.shape != (D,):
        raise ValueError("fused_ffn: weight shapes do not match x")


def _kernel_inputs(x, w1, w2, extra=()):
    """Kernel input guard: x (and dy) contiguous fp32/bf16, weights in x's
    dtype; returns whether the bf16 tensor-core kernels run."""
    N, D = x.shape
    Fh = w1.shape[0]
    _build.check(x, "x", (torch.float32, torch.bfloat16), 2)
    for t, n in ((w1, "w1"), (w2, "w2")) + tuple(extra):
        _build.check(t, n, (x.dtype,), 2)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if D % 128 or D > 1024 or Fh % 64:
            raise ValueError(f"fused_ffn bf16: need D % 128 == 0, D <= 1024, "
                             f"F % 64 == 0; got D={D}, F={Fh}")
        # tensor-core fragment loads read the weights straight from global
        # memory and need 32-byte aligned rows
        if w1.data_ptr() % 32 or w2.data_ptr() % 32:
            raise ValueError("fused_ffn bf16: weights must be 32-byte aligned")
    elif D > 1024 or Fh % 32:
        raise ValueError(f"fused_ffn fp32: need D <= 1024, F % 32 == 0; got "
                         f"D={D}, F={Fh}")
    return bf16


def _launch_fwd(x, w1, b1, w2, b2, act):
    N, D = x.shape
    bf16 = _kernel_inputs(x, w1, w2)
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    y = torch.empty_like(x)
    if N == 0:
        return y
    _build.launch("vlpet_ffn_fwd", x.data_ptr(), w1.data_ptr(),
                  b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(), y.data_ptr(),
                  N, D, w1.shape[0], _ACTS[act][0], int(bf16))
    fused_ffn.launches += 1
    return y


def fused_ffn_bwd(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, act: str = "gelu"):
    """(dx in x's dtype, db1 fp32, db2 fp32) of fused_ffn for cotangent dy
    (cast to x's dtype, as the TPU backward does): kernel F2 on CUDA
    tensors, autograd of the plain version on CPU tensors."""
    N, D = x.shape
    Fh = w1.shape[0]
    _check(x, w1, b1, w2, torch.empty(D), act)
    if act == "relu":
        raise NotImplementedError("fused_ffn_bwd: F2 has no relu yet (it "
                                  "comes with T5 training)")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    dy = dy.to(x.dtype)
    if not _build.use_kernel(x, dy, w1, b1, w2):
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            b1r = b1.detach().float().requires_grad_()
            b2r = torch.zeros(D, device=x.device, requires_grad=True)
            y = ffn_reference(xr, w1.detach(), b1r, w2.detach(), b2r, act)
            return torch.autograd.grad(y, (xr, b1r, b2r), dy)
    dy = dy.contiguous()
    bf16 = _kernel_inputs(x, w1, w2, extra=((dy, "dy"),))
    b1f = b1.float().contiguous()
    dx = torch.empty_like(x)
    db1 = torch.zeros(Fh, dtype=torch.float32, device=x.device)
    db2 = torch.zeros(D, dtype=torch.float32, device=x.device)
    if N == 0:
        return dx, db1, db2
    G = -(-N // _ROWS[x.dtype])
    partial = torch.empty((G, Fh + D), dtype=torch.float32, device=x.device)
    _build.launch("vlpet_ffn_bwd", x.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                  b1f.data_ptr(), w2.data_ptr(), dx.data_ptr(),
                  partial.data_ptr(), db1.data_ptr(), db2.data_ptr(), N, D,
                  Fh, G, _ACTS[act][0], int(bf16))
    fused_ffn_bwd.launches += 1
    return dx, db1, db2


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.act, ctx.b2_dtype = act, b2.dtype
        return _launch_fwd(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, db1, db2 = fused_ffn_bwd(x, dy, w1, b1, w2, ctx.act)
        return (dx, None, db1.to(b1.dtype), None, db2.to(ctx.b2_dtype), None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    """x (N, D); w1 (F, D); b1 (F,); w2 (D, F); b2 (D,) -> (N, D) in x's
    dtype, differentiable in x, b1 and b2. The weight matrices are frozen:
    raises when either requires a gradient while autograd is on. CPU
    tensors run the plain version; CUDA tensors launch F1 forward and F2
    backward (bf16: D a multiple of 128 up to 1024, F a multiple of 64;
    fp32: D <= 1024, F a multiple of 32)."""
    _check(x, w1, b1, w2, b2, act)
    grad = torch.is_grad_enabled()
    if grad and (w1.requires_grad or w2.requires_grad):
        raise ValueError("fused_ffn: the weight matrices are frozen (no dW); "
                         "take the plain fc1 -> act -> fc2 to train them")
    if grad and act == "relu" and (x.requires_grad or b1.requires_grad
                                   or b2.requires_grad):
        raise NotImplementedError("fused_ffn: F2 has no relu backward yet "
                                  "(it comes with T5 training)")
    if not _build.use_kernel(x, w1, b1, w2, b2):
        return ffn_reference(x, w1, b1, w2, b2, act)
    return _FusedFFN.apply(x.contiguous(), w1, b1, w2, b2, act)


def gated_ffn_reference(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                        wo: torch.Tensor, act: str = "gelu_new") -> torch.Tensor:
    """Plain act(x . W0^T) * (x . W1^T) -> . Wo^T in x's dtype (the JAX
    package's unfused wi_0 / wi_1 / wo path, vlpet_tpu/models/t5.py:500)."""
    h = _ACTS[act][1](F.linear(x, w0.to(x.dtype))) * F.linear(x, w1.to(x.dtype))
    return F.linear(h, wo.to(x.dtype))


def fused_gated_ffn(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                    wo: torch.Tensor, act: str = "gelu_new") -> torch.Tensor:
    """x (N, D); w0, w1 (F, D); wo (D, F) -> (N, D) in x's dtype. CPU
    tensors run the plain version; CUDA tensors launch F3 (bf16: D a
    multiple of 128 up to 1024, F a multiple of 64; fp32: D <= 1024, F a
    multiple of 32). Eval only: raises NotImplementedError when x or a
    weight requires a gradient while autograd is on."""
    if act not in _ACTS:
        raise ValueError(f"fused_gated_ffn: unsupported activation {act!r}")
    N, D = x.shape
    Fh = w0.shape[0]
    if w0.shape != (Fh, D) or w1.shape != (Fh, D) or wo.shape != (D, Fh):
        raise ValueError("fused_gated_ffn: weight shapes do not match x")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w0, w1, wo)):
        raise NotImplementedError("fused_gated_ffn: the gated backward (F4) "
                                  "is not ported; it comes with T5 training")
    if not _build.use_kernel(x, w0, w1, wo):
        return gated_ffn_reference(x, w0, w1, wo, act)
    x = x.contiguous()
    bf16 = _kernel_inputs(x, w0, wo, extra=((w1, "w1"),))
    if bf16 and w1.data_ptr() % 32:
        raise ValueError("fused_gated_ffn bf16: weights must be 32-byte "
                         "aligned")
    y = torch.empty_like(x)
    if N == 0:
        return y
    _build.launch("vlpet_gated_ffn_fwd", x.data_ptr(), w0.data_ptr(),
                  w1.data_ptr(), wo.data_ptr(), y.data_ptr(), N, D, Fh,
                  _ACTS[act][0], int(bf16))
    fused_gated_ffn.launches += 1
    return y


fused_ffn.launches = 0
fused_ffn_bwd.launches = 0
fused_gated_ffn.launches = 0
