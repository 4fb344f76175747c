"""Fused FFN forward (kernel 2) and its plain twin.

Replaces vlpet_tpu/ops/ffn.py:fused_ffn, whose TPU kernel is _run with
_fwd_kernel: y = act(x . W1 + b1) . W2 + b2 with the (N, F) hidden kept off
device memory. Weights here are in PyTorch's Linear layout, W1 (F, D) and
W2 (D, F). Bound on the H100 and design: see the note at the top of
csrc/ffn.cu. bf16 runs on tensor cores (WMMA), fp32 on plain FMA.
Activation dropout is not on the ported (eval) path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.activations import gelu, gelu_new

_ACTS = {"gelu": (0, gelu), "gelu_new": (1, gelu_new)}


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  act: str = "gelu") -> torch.Tensor:
    """Plain fc1 -> act -> fc2 in x's dtype (the JAX package's unfused
    TaskDense path)."""
    fn = _ACTS[act][1]
    h = fn(F.linear(x, w1.to(x.dtype), b1.to(x.dtype)))
    return F.linear(h, w2.to(x.dtype), b2.to(x.dtype))


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    """x (N, D); w1 (F, D); b1 (F,); w2 (D, F); b2 (D,) -> (N, D) in x's
    dtype. CPU tensors run the plain version; CUDA tensors launch the
    kernel (bf16: D a multiple of 128 up to 1024, F a multiple of 64;
    fp32: D <= 1024, F a multiple of 32)."""
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    N, D = x.shape
    Fh = w1.shape[0]
    if w1.shape != (Fh, D) or w2.shape != (D, Fh) or b1.shape != (Fh,) \
            or b2.shape != (D,):
        raise ValueError("fused_ffn: weight shapes do not match x")
    if not _build.use_kernel(x, w1, b1, w2, b2):
        return ffn_reference(x, w1, b1, w2, b2, act)
    dts = (torch.float32, torch.bfloat16)
    _build.check(x, "x", dts, 2)
    _build.check(w1, "w1", (x.dtype,), 2)
    _build.check(w2, "w2", (x.dtype,), 2)
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
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    y = torch.empty_like(x)
    if N == 0:
        return y
    _build.launch("vlpet_ffn_fwd", x.data_ptr(), w1.data_ptr(),
                  b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(), y.data_ptr(),
                  N, D, Fh, _ACTS[act][0], int(bf16))
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0
