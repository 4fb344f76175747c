"""Fused FFN, forward (kernel F1) and backward (kernel F2), the gated FFN's
forward (kernel F3) and backward (kernel F4), and their plain twins.

Replaces vlpet_tpu/ops/ffn.py:fused_ffn, whose TPU kernels are _run with
_fwd_kernel (F1) and with _bwd_kernel (F2) under a custom_vjp:
y = drop(act(x . W1 + b1)) . W2 + b2 with the (N, F) hidden kept off
device memory; the backward recomputes fc1 and gives dx, db1 and db2. The
weight matrices are frozen, as ``ffn_supported`` requires in the JAX
package: the Functions have no dW and raise when a weight requires a
gradient (the models route a trainable language model to the plain
fc1 -> act -> fc2). Weights here are in PyTorch's Linear layout, W1 (F, D)
and W2 (D, F). Bound on the H100 and design: the header note of
csrc/ffn.cu. bf16 runs on tensor cores (F1-F4: wgmma over weight pieces
that TMA streams from re-laid copies of the weights, kept beside them,
split over the hidden at decode rows, ``f1_splits`` and ``gated_splits``),
fp32 on plain FMA. The activation is gelu, gelu_new or relu (T5).

``fused_gated_ffn`` replaces vlpet_tpu/ops/ffn.py:fused_gated_ffn (_run with
_gated_fwd_kernel, F3, and _gated_bwd_kernel, F4):
y = drop(act(x . W0^T) * (x . W1^T)) . Wo^T, the t5-v1.1 gated-gelu FFN,
with both (N, F) hiddens kept off device memory; F4 recomputes them and
gives dx alone (T5 dense layers have no biases).

Hidden dropout (T5 training, ``rate`` > 0, ``seed`` a (1,) int32 tensor):
element (n, f) of the (N, F) hidden is kept iff keep_mask((N, F), 0, seed,
rate) (ops/hashdrop.py), applied in fp32 after the activation (after the
gating product in the gated FFN) and regenerated in the backward, as the
TPU kernels do (vlpet_tpu/ops/ffn.py:182-189, :343-347).
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.activations import gelu, gelu_new
from vlpet_tpu_torch.ops.hashdrop import (check_drop, keep_mask,
                                          kernel_drop_args)

_ACTS = {"gelu": (0, gelu), "gelu_new": (1, gelu_new),
         "relu": (2, torch.relu)}
_F1_ROWS = 64    # rows a bf16 F1-F4 block (csrc/ffn.cu kF1Rows)
_F32_ROWS = 16   # rows an fp32 F2 block (kFBM)
_F1_CHUNK = 64   # hidden columns of an F1 chunk (kFc)
_F1_MAX_DU = 6   # 128-column y pieces a bf16 F1 block (kF1MaxDu)


def _drop_hidden(h: torch.Tensor, rate: float, seed) -> torch.Tensor:
    """The (N, F) hidden through the hash dropout in fp32, back in h's
    dtype (the kernels round the dropped fp32 hidden)."""
    if rate <= 0.0:
        return h
    keep = keep_mask(h.shape, 0, seed, rate, device=h.device)
    hf = h.float()
    return torch.where(keep, hf * (1.0 / (1.0 - rate)),
                       torch.zeros_like(hf)).to(h.dtype)


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, act: str = "gelu",
                  rate: float = 0.0, seed: torch.Tensor = None) -> torch.Tensor:
    """Plain fc1 -> act -> dropout -> fc2 in x's dtype (the JAX package's
    unfused TaskDense path, with the kernels' hash mask); autograd
    differentiates it."""
    fn = _ACTS[act][1]
    h = fn(F.linear(x, w1.to(x.dtype), b1.to(x.dtype)))
    return F.linear(_drop_hidden(h, rate, seed), w2.to(x.dtype),
                    b2.to(x.dtype))


def _check(x, w1, b1, w2, b2, act, rate=0.0, seed=None):
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    N, D = x.shape
    Fh = w1.shape[0]
    if w1.shape != (Fh, D) or w2.shape != (D, Fh) or b1.shape != (Fh,) \
            or b2.shape != (D,):
        raise ValueError("fused_ffn: weight shapes do not match x")
    check_drop(rate, seed)


def _kernel_inputs(x, weights, dy=None):
    """Kernel input guard: x (and dy) contiguous fp32/bf16, the weight
    matrices (first one (F, D)) in x's dtype; returns whether the bf16
    tensor-core kernels run."""
    N, D = x.shape
    Fh = weights[0].shape[0]
    _build.check(x, "x", (torch.float32, torch.bfloat16), 2)
    for i, w in enumerate(weights):
        _build.check(w, f"weight {i}", (x.dtype,), 2)
    if dy is not None:
        _build.check(dy, "dy", (x.dtype,), 2)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        if D % 128 or D > 1024 or Fh % 64:
            raise ValueError(f"fused_ffn bf16: need D % 128 == 0, D <= 1024, "
                             f"F % 64 == 0; got D={D}, F={Fh}")
        # the kernels copy x (the backwards also dy) and re-lay the
        # weights in 16-byte pieces
        rows = (x,) if dy is None else (x, dy)
        if any(t.data_ptr() % 16 for t in rows + tuple(weights)):
            what = "x" if dy is None else "x and dy"
            raise ValueError(f"fused_ffn bf16: {what} must be 16-byte "
                             f"aligned, as must the weights")
    elif D > 1024 or Fh % 32:
        raise ValueError(f"fused_ffn fp32: need D <= 1024, F % 32 == 0; got "
                         f"D={D}, F={Fh}")
    return bf16


def _seed_arg(rate, seed):
    """The seed pointer of a launch (None without dropout)."""
    if rate <= 0.0:
        return None
    _build.check(seed, "seed", (torch.int32,), 1)
    return seed.data_ptr()


def f1_splits(N: int, D: int, Fh: int, sms: int):
    """(splits, hidden chunks a split) of the bf16 F1 at N rows: as many
    splits of the F / 64 chunks as leave every block of the grid (row
    blocks x y-column groups x splits) an SM of its own, one wave; none
    empty. One split once the row blocks fill the card (the encoder and
    training rows: y is written directly, no partial). A function of the
    shapes and the SM count, so a result does not change between calls."""
    chunks = Fh // _F1_CHUNK
    groups = -(-(D // 128) // _F1_MAX_DU)
    blocks = -(-N // _F1_ROWS) * groups
    want = max(1, min(chunks, sms // blocks))
    per = -(-chunks // want)
    return -(-chunks // per), per


def gated_splits(N: int, D: int, Fh: int, sms: int):
    """(splits, hidden chunks a split) of the bf16 F3 and F4 at N rows:
    f1_splits' rule, for the same 64-row blocks, 64-wide hidden chunks and
    groups of 128 output columns (F3 at the T5 beam rows, F4 at the
    decoder's training rows split; both take one split at the encoder
    rows)."""
    return f1_splits(N, D, Fh, sms)


# W1 -> (weakref to W2, stamp, its re-laid copy): F1's weight pieces
_F1_TILES = WeakIdKeyDictionary()
# W0 -> [weakrefs to W1 and Wo, stamp, F3's re-laid copy (gt) or None,
# F4's (bt) or None]
_GATED_TILES = WeakIdKeyDictionary()


def _stamp(*weights):
    """What must not change for a cached re-laid copy to stay valid: the
    weights' storage and version counters (None for inference tensors,
    which keep no version counter: never cached)."""
    if any(w.is_inference() for w in weights):
        return None
    return tuple(v for w in weights for v in (w.data_ptr(), w._version))


def f1_tiles(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """W1 (F, D) and W2 (D, F) bf16 re-laid out into F1's 16 KB weight
    pieces (csrc/ffn.cu ffn_w_tiles, 2 F D bf16, one pass over both); F2
    reads them too, W2[:, chunk] and W1[chunk, :] MN-major. Kept beside W1
    while W1 lives, and rebuilt when W2 is another tensor or an in-place
    write moved either weight's version counter or storage: the weights of
    every path that takes F1 and F2 are frozen, so an eval or a train run
    re-lays each layer once."""
    stamp = _stamp(w1, w2)
    hit = _F1_TILES.get(w1) if stamp is not None else None
    if hit is not None and hit[0]() is w2 and hit[1] == stamp:
        return hit[2]
    Fh, D = w1.shape
    wt = torch.empty(2 * Fh * D, dtype=torch.bfloat16, device=w1.device)
    _build.launch("vlpet_ffn_w_tiles", w1.data_ptr(), w2.data_ptr(),
                  wt.data_ptr(), D, Fh)
    if stamp is not None:
        _F1_TILES[w1] = (weakref.ref(w2), stamp, wt)
    return wt


def gated_tiles(w0: torch.Tensor, w1: torch.Tensor, wo: torch.Tensor,
                backward: bool = False) -> torch.Tensor:
    """W0, W1 (F, D) and Wo (D, F) bf16 re-laid out for the tensor-core
    kernels, 3 F D bf16: F3's weights (csrc/ffn.cu gated_w_tiles; F4 reads
    its up pieces too) or, with ``backward``, the rest of F4's (Wo^T, W0^T,
    W1^T: gated_bwd_tiles). Kept beside W0 while it lives and rebuilt, as
    f1_tiles, when W1 or Wo is another tensor or a weight's version counter
    or storage moved: an eval or a train run re-lays each layer once (a
    train run twice: both copies)."""
    stamp = _stamp(w0, w1, wo)
    hit = _GATED_TILES.get(w0) if stamp is not None else None
    if (hit is None or hit[0]() is not w1 or hit[1]() is not wo
            or hit[2] != stamp):
        hit = [weakref.ref(w1), weakref.ref(wo), stamp, None, None]
        if stamp is not None:
            _GATED_TILES[w0] = hit
    k = 4 if backward else 3
    if hit[k] is None:
        Fh, D = w0.shape
        hit[k] = torch.empty(3 * Fh * D, dtype=torch.bfloat16,
                             device=w0.device)
        _build.launch("vlpet_gated_bwd_tiles" if backward
                      else "vlpet_gated_w_tiles", w0.data_ptr(),
                      w1.data_ptr(), wo.data_ptr(), hit[k].data_ptr(), D, Fh)
    return hit[k]


def _splits_and_partials(x, D, Fh):
    """(splits, fp32 partials or None) of a bf16 F2, F3 or F4 launch
    (f1_splits' rule)."""
    N = x.shape[0]
    S, _ = f1_splits(N, D, Fh, _build.multiprocessors(x.device))
    part = (torch.empty((S, N, D), dtype=torch.float32, device=x.device)
            if S > 1 else None)
    return S, part


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, w1, b1, w2, b2, act, rate, seed):
    N, D = x.shape
    Fh = w1.shape[0]
    bf16 = _kernel_inputs(x, (w1, w2))
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    y = torch.empty_like(x)
    if N == 0:
        return y
    S, wt, part = 1, None, None
    if bf16:
        S, part = _splits_and_partials(x, D, Fh)
        wt = f1_tiles(w1, w2)
    _build.launch("vlpet_ffn_fwd", x.data_ptr(), w1.data_ptr(),
                  b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
                  _seed_arg(rate, seed), _ptr(wt), _ptr(part), y.data_ptr(),
                  N, D, Fh, S, _ACTS[act][0], int(bf16),
                  *kernel_drop_args(rate))
    fused_ffn.launches += 1
    return y


def fused_ffn_bwd(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, act: str = "gelu",
                  rate: float = 0.0, seed: torch.Tensor = None):
    """(dx in x's dtype, db1 fp32, db2 fp32) of fused_ffn for cotangent dy
    (cast to x's dtype, as the TPU backward does), the forward's dropout
    mask regenerated from ``seed``: kernel F2 on CUDA tensors, autograd of
    the plain version on CPU tensors."""
    N, D = x.shape
    Fh = w1.shape[0]
    _check(x, w1, b1, w2, torch.empty(D), act, rate, seed)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    dy = dy.to(x.dtype)
    ts = (x, dy, w1, b1, w2) + ((seed,) if seed is not None else ())
    if not _build.use_kernel(*ts):
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            b1r = b1.detach().float().requires_grad_()
            b2r = torch.zeros(D, device=x.device, requires_grad=True)
            y = ffn_reference(xr, w1.detach(), b1r, w2.detach(), b2r, act,
                              rate, seed)
            return torch.autograd.grad(y, (xr, b1r, b2r), dy)
    dy = dy.contiguous()
    bf16 = _kernel_inputs(x, (w1, w2), dy)
    b1f = b1.float().contiguous()
    dx = torch.empty_like(x)
    db1 = torch.zeros(Fh, dtype=torch.float32, device=x.device)
    db2 = torch.zeros(D, dtype=torch.float32, device=x.device)
    if N == 0:
        return dx, db1, db2
    G = -(-N // (_F1_ROWS if bf16 else _F32_ROWS))
    S, dyt, wt, part = 1, None, None, None
    if bf16:
        S, part = _splits_and_partials(x, D, Fh)
        # dy re-laid out into 64-row pieces (csrc/ffn.cu ffn_bwd_dy_tiles)
        dyt = torch.empty(G * _F1_ROWS * D, dtype=torch.bfloat16,
                          device=x.device)
        wt = f1_tiles(w1, w2)  # F2 reads F1's copy (MN-major where needed)
    # per-block column sums: db1's (F2) and db2's (the dy re-lay or F2)
    partial = torch.empty((G, Fh + D), dtype=torch.float32, device=x.device)
    _build.launch("vlpet_ffn_bwd", x.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                  b1f.data_ptr(), w2.data_ptr(), _seed_arg(rate, seed),
                  _ptr(dyt), _ptr(wt), _ptr(part), dx.data_ptr(),
                  partial.data_ptr(), db1.data_ptr(), db2.data_ptr(), N, D,
                  Fh, G, S, _ACTS[act][0], int(bf16),
                  *kernel_drop_args(rate))
    fused_ffn_bwd.launches += 1
    return dx, db1, db2


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, act, rate):
        ctx.save_for_backward(x, w1, b1, w2, seed)
        ctx.act, ctx.rate, ctx.b2_dtype = act, rate, b2.dtype
        return _launch_fwd(x, w1, b1, w2, b2, act, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, seed = ctx.saved_tensors
        dx, db1, db2 = fused_ffn_bwd(x, dy, w1, b1, w2, ctx.act, ctx.rate,
                                     seed)
        return (dx, None, db1.to(b1.dtype), None, db2.to(ctx.b2_dtype), None,
                None, None)


def _frozen(name, grad, *weights):
    if grad and any(w.requires_grad for w in weights):
        raise ValueError(f"{name}: the weight matrices are frozen (no dW); "
                         f"take the plain path to train them")


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, act: str = "gelu",
              rate: float = 0.0, seed: torch.Tensor = None) -> torch.Tensor:
    """x (N, D); w1 (F, D); b1 (F,); w2 (D, F); b2 (D,) -> (N, D) in x's
    dtype, differentiable in x, b1 and b2; ``rate`` > 0 drops the hidden
    (``seed`` a (1,) int32 tensor). The weight matrices are frozen: raises
    when either requires a gradient while autograd is on. CPU tensors run
    the plain version; CUDA tensors launch F1 forward and F2 backward (bf16:
    D a multiple of 128 up to 1024, F a multiple of 64; fp32: D <= 1024, F
    a multiple of 32)."""
    _check(x, w1, b1, w2, b2, act, rate, seed)
    grad = torch.is_grad_enabled()
    _frozen("fused_ffn", grad, w1, w2)
    ts = (x, w1, b1, w2, b2) + ((seed,) if seed is not None else ())
    if not _build.use_kernel(*ts):
        return ffn_reference(x, w1, b1, w2, b2, act, rate, seed)
    x = x.contiguous()
    if not (grad and (x.requires_grad or b1.requires_grad
                      or b2.requires_grad)):
        return _launch_fwd(x, w1, b1, w2, b2, act, rate, seed)
    return _FusedFFN.apply(x, w1, b1, w2, b2, seed, act, rate)


def gated_ffn_reference(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                        wo: torch.Tensor, act: str = "gelu_new",
                        rate: float = 0.0,
                        seed: torch.Tensor = None) -> torch.Tensor:
    """Plain act(x . W0^T) * (x . W1^T) -> dropout -> . Wo^T in x's dtype
    (the JAX package's unfused wi_0 / wi_1 / wo path,
    vlpet_tpu/models/t5.py:500, with the kernels' hash mask); autograd
    differentiates it."""
    h = _ACTS[act][1](F.linear(x, w0.to(x.dtype))) * F.linear(x, w1.to(x.dtype))
    return F.linear(_drop_hidden(h, rate, seed), wo.to(x.dtype))


def _check_gated(x, w0, w1, wo, act, rate, seed):
    if act not in _ACTS:
        raise ValueError(f"fused_gated_ffn: unsupported activation {act!r}")
    N, D = x.shape
    Fh = w0.shape[0]
    if w0.shape != (Fh, D) or w1.shape != (Fh, D) or wo.shape != (D, Fh):
        raise ValueError("fused_gated_ffn: weight shapes do not match x")
    check_drop(rate, seed)


def _launch_gated_fwd(x, w0, w1, wo, act, rate, seed):
    N, D = x.shape
    Fh = w0.shape[0]
    bf16 = _kernel_inputs(x, (w0, w1, wo))
    y = torch.empty_like(x)
    if N == 0:
        return y
    S, gt, part = 1, None, None
    if bf16:
        S, part = _splits_and_partials(x, D, Fh)
        gt = gated_tiles(w0, w1, wo)
    _build.launch("vlpet_gated_ffn_fwd", x.data_ptr(), w0.data_ptr(),
                  w1.data_ptr(), wo.data_ptr(), _seed_arg(rate, seed),
                  _ptr(gt), _ptr(part), y.data_ptr(), N, D, Fh, S,
                  _ACTS[act][0], int(bf16), *kernel_drop_args(rate))
    fused_gated_ffn.launches += 1
    return y


def fused_gated_ffn_bwd(x: torch.Tensor, dy: torch.Tensor, w0: torch.Tensor,
                        w1: torch.Tensor, wo: torch.Tensor,
                        act: str = "gelu_new", rate: float = 0.0,
                        seed: torch.Tensor = None) -> torch.Tensor:
    """dx (x's dtype) of fused_gated_ffn for cotangent dy (cast to x's
    dtype, as the TPU backward does), the forward's dropout mask
    regenerated from ``seed``: kernel F4 on CUDA tensors, autograd of the
    plain version on CPU tensors."""
    _check_gated(x, w0, w1, wo, act, rate, seed)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    dy = dy.to(x.dtype)
    ts = (x, dy, w0, w1, wo) + ((seed,) if seed is not None else ())
    if not _build.use_kernel(*ts):
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            y = gated_ffn_reference(xr, w0.detach(), w1.detach(), wo.detach(),
                                    act, rate, seed)
            return torch.autograd.grad(y, xr, dy)[0]
    N, D = x.shape
    Fh = w0.shape[0]
    dy = dy.contiguous()
    bf16 = _kernel_inputs(x, (w0, w1, wo), dy)
    dx = torch.empty_like(x)
    if N == 0:
        return dx
    S, dyt, gt, bt, part = 1, None, None, None, None
    if bf16:
        S, part = _splits_and_partials(x, D, Fh)
        # dy re-laid out into 64-row pieces (csrc/ffn.cu gated_dy_tiles)
        dyt = torch.empty(-(-N // _F1_ROWS) * _F1_ROWS * D,
                          dtype=torch.bfloat16, device=x.device)
        gt = gated_tiles(w0, w1, wo)
        bt = gated_tiles(w0, w1, wo, backward=True)
    _build.launch("vlpet_gated_ffn_bwd", x.data_ptr(), dy.data_ptr(),
                  w0.data_ptr(), w1.data_ptr(), wo.data_ptr(),
                  _seed_arg(rate, seed), _ptr(dyt), _ptr(gt), _ptr(bt),
                  _ptr(part), dx.data_ptr(), N, D, Fh, S, _ACTS[act][0],
                  int(bf16), *kernel_drop_args(rate))
    fused_gated_ffn_bwd.launches += 1
    return dx


class _FusedGatedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, w1, wo, seed, act, rate):
        ctx.save_for_backward(x, w0, w1, wo, seed)
        ctx.act, ctx.rate = act, rate
        return _launch_gated_fwd(x, w0, w1, wo, act, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, w0, w1, wo, seed = ctx.saved_tensors
        dx = fused_gated_ffn_bwd(x, dy, w0, w1, wo, ctx.act, ctx.rate, seed)
        return dx, None, None, None, None, None, None


def fused_gated_ffn(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                    wo: torch.Tensor, act: str = "gelu_new",
                    rate: float = 0.0,
                    seed: torch.Tensor = None) -> torch.Tensor:
    """x (N, D); w0, w1 (F, D); wo (D, F) -> (N, D) in x's dtype,
    differentiable in x; ``rate`` > 0 drops the gated hidden (``seed`` a
    (1,) int32 tensor). The weights are frozen: raises when one requires a
    gradient while autograd is on. CPU tensors run the plain version; CUDA
    tensors launch F3 forward and F4 backward (bf16: D a multiple of 128 up
    to 1024, F a multiple of 64; fp32: D <= 1024, F a multiple of 32)."""
    _check_gated(x, w0, w1, wo, act, rate, seed)
    grad = torch.is_grad_enabled()
    _frozen("fused_gated_ffn", grad, w0, w1, wo)
    ts = (x, w0, w1, wo) + ((seed,) if seed is not None else ())
    if not _build.use_kernel(*ts):
        return gated_ffn_reference(x, w0, w1, wo, act, rate, seed)
    x = x.contiguous()
    if not (grad and x.requires_grad):
        return _launch_gated_fwd(x, w0, w1, wo, act, rate, seed)
    return _FusedGatedFFN.apply(x, w0, w1, wo, seed, act, rate)


fused_ffn.launches = 0
fused_ffn_bwd.launches = 0
fused_gated_ffn.launches = 0
fused_gated_ffn_bwd.launches = 0
