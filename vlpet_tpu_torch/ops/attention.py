"""Fused attention, forward (kernel A1) and backward (kernels A6 and the
long backward), and the plain twins.

Replaces vlpet_tpu/ops/attention.py:fused_attention, whose TPU kernels are
the all-heads pair _pallas_attention / _pallas_attention_bwd, the per-head
pair _pallas_attention_perhead / _pallas_attention_perhead_bwd and the
query-strip pair _pallas_attention_ltiled / _pallas_attention_ltiled_bwd
under a custom_vjp, routed by the TPU's scoped-VMEM fit. The layout is the
JAX function's: q (B, L, H*Dh) pre-scaled, k/v (B, S, H*Dh), an additive
f32 padding mask (B|1, 1, 1, S) broadcast inside the kernels, and
``causal`` for the decoder triangle with past offset S - L. On CUDA tensors
``fused_attention`` is a torch.autograd.Function. Its forward is A1
(csrc/attention.cu) at every shape: the key-tiled online softmax runs at
any S, so it computes what the three TPU forwards compute. Its backward is
picked by ``backward_route``: A6 (csrc/attention_bwd.cu), which holds a
whole head in shared memory, where that fits; else the tiled long backward
(csrc/attention_bwd_long.cu), for which the forward also saves its output
and A1's row logsumexp. Both recompute the softmax and give dq, dk, dv;
the mask gets no gradient. Bounds on the H100 and designs: the header
notes of the sources.

Routes: ``forward_route(L, S, Dh, dtype)``, a plain function of (dtype,
Dh), picks the kernel family of A1 and of the long backward: "tc" for bf16
at Dh 64 (products on the tensor cores, mma.sync; bf16 tiles fed by
cp.async, which needs 16-byte aligned q, k, v, do and bias: the wrappers
check and raise), "fma" for fp32 and for bf16 at other widths (the FP32-FMA
kernels, which the fp32 parity runs hold to full fp32 arithmetic).
``fused_attention.launches_by_route`` and
``fused_attention_bwd_long.launches_by_route`` count the launches of each.
A6's kernel is picked by ``a6_route(L, S, Dh, dtype)``: "tc" for bf16 at
Dh 64 with L, S <= 256 (one kernel for a single 64-row tile, the B 500
train sites; one up to 128 rows, the CLI's caption L 76 and nlvr S 102,
the prompts' and prefixes' S 96 / 116, the raw NLVR encoder's 118; one
past 128, the prompt's nlvr S 142, the video tvc sites at S 141 / 181,
the raw 448 px encoder's 216), "fma" for fp32 and other widths;
``fused_attention_bwd.launches_by_route`` counts them, and
``fused_attention_bwd.tc256_launches`` the launches past 128 rows.

T5 terms: the relative bias rides as ``bias``, a batch-shared (1, H, L, S)
fp32 term added to the logits after the mask (the (B, H, L, S) sum never
exists), and ``rate`` > 0 drops the probabilities with the hash mask of
ops/hashdrop.py ``attention_keep_mask`` (seed: a (1,) int32 tensor),
regenerated in the backward, as vlpet_tpu/ops/attention.py does. A1, A6
and the long backward take both. A bias that requires a gradient (a
trainable ``relative_attention_bias``: unfreeze_language_model, BitFit)
gets the true dbias[h] = sum_b ds[b, h] in fp32 from either backward
(``bias_grad``, the JAX package's flag; here set by autograd's
``needs_input_grad``, so a site whose bias is frozen computes none), summed
over the batch in a fixed order. Per-head masks are not on the ported path
and are not accepted.
"""

from __future__ import annotations

import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.hashdrop import (attention_keep_mask, check_drop,
                                          kernel_drop_args)

_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def _causal_allowed(L: int, S: int, device) -> torch.Tensor:
    """(L, S) bool: query i may see key j iff j <= i + (S - L)."""
    row = torch.arange(L, device=device)[:, None]
    col = torch.arange(S, device=device)[None, :]
    return col <= row + (S - L)


def _logits(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
            num_heads: int, causal: bool,
            bias: torch.Tensor = None) -> torch.Tensor:
    """fp32 (B, H, L, S) logits plus the mask, plus the bias, hidden causal
    logits set to -1e9."""
    B, L, inner = q.shape
    S = k.shape[1]
    hd = inner // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk",
                     q.reshape(B, L, num_heads, hd).float(),
                     k.reshape(B, S, num_heads, hd).float())
    s = s + mask.float()
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = torch.where(_causal_allowed(L, S, s.device), s,
                        torch.full((), -1e9, device=s.device))
    return s


def _drop_probs(p: torch.Tensor, rate: float, seed) -> torch.Tensor:
    """The fp32 (B, H, L, S) probabilities through the attention dropout:
    kept ones scaled by 1 / (1 - rate), the rest 0."""
    if rate <= 0.0:
        return p
    B, H, L, S = p.shape
    keep = attention_keep_mask(B, L, S, H, seed, rate, device=p.device)
    return torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))


def _attend(p: torch.Tensor, v: torch.Tensor, num_heads: int,
            dtype: torch.dtype) -> torch.Tensor:
    """(B, H, L, S) probabilities cast to ``dtype``, times v -> (B, L, H*Dh)."""
    B, S, inner = v.shape
    vh = v.reshape(B, S, num_heads, inner // num_heads)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype), vh)
    return o.reshape(B, p.shape[2], inner)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor,
                              num_heads: int, causal: bool = False,
                              bias: torch.Tensor = None, rate: float = 0.0,
                              seed: torch.Tensor = None) -> torch.Tensor:
    """Plain version (vlpet_tpu/ops/attention.py:984
    fused_attention_reference): fp32 logits plus the mask, plus the
    (1, H, L, S) bias, hidden causal logits set to -1e9, fp32 softmax,
    the probability dropout of ``attention_keep_mask`` in fp32 when
    ``rate`` > 0, probabilities cast to q's dtype before the value product.
    Autograd differentiates it."""
    p = torch.softmax(_logits(q, k, mask, num_heads, causal, bias), dim=-1)
    return _attend(_drop_probs(p, rate, seed), v, num_heads, q.dtype)


def fused_attention_lse_reference(q, k, v, mask, num_heads: int,
                                  causal: bool = False, bias=None,
                                  rate: float = 0.0, seed=None):
    """Plain twin of ``fused_attention_fwd_lse``: (the reference output,
    dropped where ``rate`` > 0, and the fp32 row logsumexp (B, H, L) of the
    masked, biased, undropped logits)."""
    s = _logits(q, k, mask, num_heads, causal, bias)
    p = _drop_probs(torch.softmax(s, dim=-1), rate, seed)
    return _attend(p, v, num_heads, q.dtype), torch.logsumexp(s, dim=-1)


def fused_attention_bwd_long_reference(q, k, v, mask, out, lse, do,
                                       num_heads: int, causal: bool = False,
                                       bias=None, rate: float = 0.0,
                                       seed=None, bias_grad: bool = False):
    """Plain twin of the long backward, in its arithmetic: p recomputed as
    exp(logits - lse) (bias included), the dropout's keep mask regenerated,
    delta = rowsum(do * out) with ``out`` the dropped output,
    dp = keep ? (do v^T) / (1 - rate) : 0, ds = p (dp - delta), dq = ds k,
    dk = ds^T q, dv = p_drop^T do, all fp32, cast to the inputs' dtype;
    with ``bias_grad`` also dbias = sum_b ds, fp32 (1, H, L, S)."""
    B, L, inner = q.shape
    S = k.shape[1]
    hd = inner // num_heads

    def heads(t, n):
        return t.reshape(B, n, num_heads, hd).float()

    qh, kh, vh, doh = heads(q, L), heads(k, S), heads(v, S), heads(do, L)
    p = torch.exp(_logits(q, k, mask, num_heads, causal, bias)
                  - lse[..., None])
    delta = (doh * heads(out, L)).sum(-1).transpose(1, 2)  # (B, H, L)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    pd = p
    if rate > 0.0:
        keep = attention_keep_mask(B, L, S, num_heads, seed, rate,
                                   device=q.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
        pd = torch.where(keep, p * inv, torch.zeros_like(p))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, doh)
    grads = (dq.reshape(B, L, inner).to(q.dtype),
             dk.reshape(B, S, inner).to(k.dtype),
             dv.reshape(B, S, inner).to(v.dtype))
    return grads + (ds.sum(0, keepdim=True),) if bias_grad else grads


# the head width of the tensor-core kernels (every configuration of the
# repo: BART-base and T5-base, d 768 over 12 heads)
TC_HEAD_DIM = 64
# the largest L and S of A6's tensor-core kernels (csrc/attention_bwd.cu
# kT2Rows), and of those up to 128 rows (kTwRows): past it, L or S,
# attention_bwd_tc_256 serves
A6_TC_ROWS = 256
A6_WIDE_ROWS = 128


def forward_route(L: int, S: int, Dh: int, dtype: torch.dtype) -> str:
    """The kernel family of an attention site, a plain function of (dtype,
    Dh): "tc" (the tensor-core kernels: bf16 products on mma.sync, bf16
    tiles fed by cp.async) for bf16 at Dh 64, else "fma" (the FP32-FMA
    kernels, fp32 or bf16 at any Dh up to 128). It picks A1's kernel and,
    at "long" sites of ``backward_route``, the long backward's. L and S do
    not decide it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernels take fp32 or bf16, not {dtype}")
    if not 1 <= Dh <= 128:
        raise ValueError(f"attention kernels take Dh 1..128, not {Dh}")
    return "tc" if dtype == torch.bfloat16 and Dh == TC_HEAD_DIM else "fma"


def _check_aligned(*named) -> None:
    """The tensor-core kernels copy rows in 16-byte pieces (cp.async; the
    bias's rows too where S is a multiple of 4): every (tensor, name) must
    start on a 16-byte boundary."""
    for t, n in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{n}: the tensor-core attention kernels need "
                             f"16-byte aligned data; this view starts at "
                             f"{t.data_ptr() % 16} bytes past a boundary")


def a6_route(L: int, S: int, Dh: int, dtype: torch.dtype) -> str:
    """A6's kernel, a plain function of (L, S, Dh, dtype): "tc" (the
    tensor-core kernels: bf16 products on mma.sync, p and ds in registers,
    bf16 tiles fed by cp.async, 16-byte aligned inputs) for bf16 at Dh 64
    with L, S <= 256 -- the image-text sites, the prompts' and prefixes'
    S 96 / 116 / 142, the video tvc sites' S 141 / 181, the raw encoders'
    118 / 216 -- else "fma" (the FP32-FMA kernel: fp32, other widths)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernels take fp32 or bf16, not {dtype}")
    return ("tc" if dtype == torch.bfloat16 and Dh == TC_HEAD_DIM
            and L <= A6_TC_ROWS and S <= A6_TC_ROWS else "fma")


def backward_route(L: int, S: int, Dh: int, dtype: torch.dtype) -> str:
    """The backward kernel of an attention site: "A6" where A6's kernel
    holds the whole head in a block, else "long". In bf16 at Dh 64 that is
    where ``a6_route`` says "tc" (L, S <= 256: the tensor-core kernels
    stage q, do, k, v in bf16 and no (L, S) matrix); elsewhere where the
    FMA kernel's block fits a block's shared memory -- q, do, k, v and the
    (L, S) p and dp matrices, staged as fp32. The image-text sites (L, S <=
    56) take A6; the video sites (S 604, 704, 1024) the long backward."""
    if a6_route(L, S, Dh, dtype) == "tc":
        return "A6"
    if dtype == torch.bfloat16 and Dh == TC_HEAD_DIM:
        return "long"
    smem = 4 * (2 * L * Dh + 2 * S * (Dh + 1) + 2 * L * S)
    return "A6" if smem <= _SMEM_LIMIT else "long"


def _check(q, k, v, mask, num_heads, bias=None, rate=0.0, seed=None,
           bias_grad=False):
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
    if bias is not None and (bias.shape != (1, num_heads, L, S)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be (1, H={num_heads}, L={L}, S={S}) "
                         f"fp32; got {bias.dtype} {tuple(bias.shape)}")
    if bias_grad and bias is None:
        raise ValueError("bias_grad needs a bias")
    check_drop(rate, seed)


def _kernel_inputs(q, k, v, mask, extra=()):
    dts = (torch.float32, torch.bfloat16)
    for t, n in ((q, "q"), (k, "k"), (v, "v")) + tuple(extra):
        _build.check(t, n, dts, 3)
        if t.dtype != q.dtype:
            raise TypeError(f"{n}: dtype {t.dtype} != q's {q.dtype}")
    m = mask.reshape(mask.shape[0], mask.shape[-1])
    _build.check(m, "mask", (torch.float32,), 2)
    return m


def _ptr(t):
    return None if t is None else t.data_ptr()


def _extras(bias, rate, seed):
    """The kernels' bias and seed inputs, checked and contiguous."""
    if bias is not None:
        bias = bias.contiguous()
    if rate > 0.0:
        _build.check(seed, "seed", (torch.int32,), 1)
    else:
        seed = None
    return bias, seed


def _launch_fwd(q, k, v, mask, num_heads, causal, with_lse=False,
                bias=None, rate=0.0, seed=None):
    """A1 -> out, or (out, lse) with ``with_lse``."""
    B, L, inner = q.shape
    S = k.shape[1]
    m = _kernel_inputs(q, k, v, mask)
    bias, seed = _extras(bias, rate, seed)
    route = forward_route(L, S, inner // num_heads, q.dtype)
    if route == "tc":
        _check_aligned((q, "q"), (k, "k"), (v, "v"),
                       *([(bias, "bias")] if bias is not None else []))
    out = torch.empty_like(q)
    lse = (torch.empty((B, num_heads, L), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    _build.launch("vlpet_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), _ptr(bias), _ptr(seed),
                  out.data_ptr(), _ptr(lse), B, L, S, num_heads,
                  inner // num_heads, int(m.shape[0] == B), int(causal),
                  int(q.dtype == torch.bfloat16), int(route == "tc"),
                  *kernel_drop_args(rate))
    fused_attention.launches += 1
    fused_attention.launches_by_route[route] += 1
    return (out, lse) if with_lse else out


def fused_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor,
                            num_heads: int, causal: bool = False,
                            bias: torch.Tensor = None, rate: float = 0.0,
                            seed: torch.Tensor = None):
    """(out, lse): fused_attention's output (dropped where ``rate`` > 0) and
    the fp32 row logsumexp (B, H, L) of the masked, biased, undropped
    logits, what the long backward takes. A1 on CUDA tensors, the plain twin
    on CPU tensors."""
    _check(q, k, v, mask, num_heads, bias, rate, seed)
    ts = (q, k, v, mask) + tuple(t for t in (bias, seed) if t is not None)
    if not _build.use_kernel(*ts):
        return fused_attention_lse_reference(q, k, v, mask, num_heads, causal,
                                             bias, rate, seed)
    return _launch_fwd(q, k, v, mask, num_heads, causal, with_lse=True,
                       bias=bias, rate=rate, seed=seed)


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, do: torch.Tensor, num_heads: int,
                        causal: bool = False, bias: torch.Tensor = None,
                        rate: float = 0.0, seed: torch.Tensor = None,
                        bias_grad: bool = False):
    """(dq, dk, dv) of fused_attention for cotangent ``do`` (B, L, H*Dh), in
    the inputs' dtype, and with ``bias_grad`` the bias's fp32 cotangent
    dbias (1, H, L, S) = sum_b ds[b] as a fourth: kernel A6 on CUDA tensors
    (where ``backward_route`` says "A6"; raises otherwise), autograd of the
    plain version on CPU tensors. The mask gets no gradient; with ``rate``
    > 0 the forward's dropout mask is regenerated from ``seed``."""
    _check(q, k, v, mask, num_heads, bias, rate, seed, bias_grad)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    ts = (q, k, v, mask, do) + tuple(t for t in (bias, seed) if t is not None)
    if not _build.use_kernel(*ts):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            b = None if bias is None else bias.detach()
            if bias_grad:
                b.requires_grad_()
                args.append(b)
            out = fused_attention_reference(args[0], args[1], args[2], mask,
                                            num_heads, causal, b, rate, seed)
            return torch.autograd.grad(out, args, do)
    B, L, inner = q.shape
    S = k.shape[1]
    Dh = inner // num_heads
    if backward_route(L, S, Dh, q.dtype) != "A6":
        raise ValueError(f"fused_attention_bwd: L {L}, S {S}, Dh {Dh} do not "
                         f"fit A6's block; fused_attention_bwd_long serves "
                         f"them")
    do = do.contiguous()
    m = _kernel_inputs(q, k, v, mask, extra=((do, "do"),))
    bias, seed = _extras(bias, rate, seed)
    route = a6_route(L, S, Dh, q.dtype)
    if route == "tc":
        _check_aligned((q, "q"), (k, "k"), (v, "v"), (do, "do"),
                       *([(bias, "bias")] if bias is not None else []))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = dbias = None
    if bias_grad:
        part = torch.empty((B, num_heads, L, S), dtype=torch.float32,
                           device=q.device)
        dbias = torch.empty((1, num_heads, L, S), dtype=torch.float32,
                            device=q.device)
    _build.launch("vlpet_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), _ptr(bias), _ptr(seed),
                  do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  _ptr(part), _ptr(dbias), B, L, S, num_heads, Dh,
                  int(m.shape[0] == B), int(causal),
                  int(q.dtype == torch.bfloat16), int(route == "tc"),
                  *kernel_drop_args(rate))
    fused_attention_bwd.launches += 1
    fused_attention_bwd.launches_by_route[route] += 1
    if route == "tc" and max(L, S) > A6_WIDE_ROWS:
        fused_attention_bwd.tc256_launches += 1
    if not bias_grad:
        return dq, dk, dv
    fused_attention_bwd.dbias_launches += 1
    return dq, dk, dv, dbias


def fused_attention_bwd_long(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor,
                             do: torch.Tensor, num_heads: int,
                             causal: bool = False, bias: torch.Tensor = None,
                             rate: float = 0.0, seed: torch.Tensor = None,
                             bias_grad: bool = False):
    """(dq, dk, dv) of fused_attention for cotangent ``do``, from the
    forward's ``out`` and row logsumexp ``lse`` (``fused_attention_fwd_lse``
    with the same bias, rate and seed), in the inputs' dtype, and with
    ``bias_grad`` the fp32 dbias (1, H, L, S) as a fourth: the tiled long
    backward on CUDA tensors (any L, S; Dh <= 128), its plain twin on CPU
    tensors. The mask gets no gradient."""
    _check(q, k, v, mask, num_heads, bias, rate, seed, bias_grad)
    B, L, inner = q.shape
    S = k.shape[1]
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} / out {tuple(out.shape)} must "
                         f"match q {tuple(q.shape)}")
    if lse.shape != (B, num_heads, L) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 (B, H, L) = ({B}, {num_heads}, "
                         f"{L}); got {lse.dtype} {tuple(lse.shape)}")
    if causal and S < L:
        raise ValueError(f"causal attention needs S >= L, got L {L} S {S}")
    ts = (q, k, v, mask, out, lse, do) + tuple(
        t for t in (bias, seed) if t is not None)
    if not _build.use_kernel(*ts):
        return fused_attention_bwd_long_reference(
            q, k, v, mask, out, lse, do, num_heads, causal, bias, rate, seed,
            bias_grad)
    do = do.contiguous()
    m = _kernel_inputs(q, k, v, mask, extra=((do, "do"), (out, "out")))
    _build.check(lse, "lse", (torch.float32,), 3)
    bias, seed = _extras(bias, rate, seed)
    route = forward_route(L, S, inner // num_heads, q.dtype)
    if route == "tc":
        _check_aligned((q, "q"), (k, "k"), (v, "v"), (do, "do"),
                       *([(bias, "bias")] if bias is not None else []))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    dbias = (torch.empty((1, num_heads, L, S), dtype=torch.float32,
                         device=q.device) if bias_grad else None)
    _build.launch("vlpet_attention_bwd_long", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), _ptr(bias), _ptr(seed),
                  out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  delta.data_ptr(), _ptr(dbias), B, L, S, num_heads,
                  inner // num_heads, int(m.shape[0] == B), int(causal),
                  int(q.dtype == torch.bfloat16), int(route == "tc"),
                  *kernel_drop_args(rate))
    fused_attention_bwd_long.launches += 1
    fused_attention_bwd_long.launches_by_route[route] += 1
    if not bias_grad:
        return dq, dk, dv
    fused_attention_bwd_long.dbias_launches += 1
    return dq, dk, dv, dbias


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, bias, seed, num_heads, causal, rate):
        ctx.num_heads, ctx.causal, ctx.rate = num_heads, causal, rate
        ctx.long = backward_route(q.shape[1], k.shape[1],
                                  q.shape[2] // num_heads, q.dtype) == "long"
        if not ctx.long:
            ctx.save_for_backward(q, k, v, mask, bias, seed)
            return _launch_fwd(q, k, v, mask, num_heads, causal, bias=bias,
                               rate=rate, seed=seed)
        out, lse = _launch_fwd(q, k, v, mask, num_heads, causal, with_lse=True,
                               bias=bias, rate=rate, seed=seed)
        ctx.save_for_backward(q, k, v, mask, bias, seed, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        # dbias only where the bias is trainable: the counterpart of the
        # JAX package's per-site path_is_trainable(... relative_attention_bias)
        bias_grad = ctx.needs_input_grad[4]
        if ctx.long:
            q, k, v, mask, bias, seed, out, lse = ctx.saved_tensors
            grads = fused_attention_bwd_long(
                q, k, v, mask, out, lse, do, ctx.num_heads, ctx.causal, bias,
                ctx.rate, seed, bias_grad)
        else:
            q, k, v, mask, bias, seed = ctx.saved_tensors
            grads = fused_attention_bwd(q, k, v, mask, do, ctx.num_heads,
                                        ctx.causal, bias, ctx.rate, seed,
                                        bias_grad)
        dq, dk, dv = (g if need else None
                      for g, need in zip(grads[:3], ctx.needs_input_grad))
        return (dq, dk, dv, None, grads[3] if bias_grad else None, None, None,
                None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int, causal: bool = False,
                    bias: torch.Tensor = None, rate: float = 0.0,
                    seed: torch.Tensor = None) -> torch.Tensor:
    """drop(softmax(q . k^T + mask [+ bias] [causal])) . v per head ->
    (B, L, H*Dh) in q's dtype; differentiable in q, k and v.

    mask: additive (B|1, 1, 1, S); bias: batch-shared additive (1, H, L, S)
    fp32 (T5 relative positions), differentiable too (a trainable
    relative_attention_bias); ``rate`` > 0: probability dropout driven by
    ``seed``, a (1,) int32 tensor. CPU tensors run the plain version; CUDA
    tensors launch A1 forward and the backward ``backward_route`` picks."""
    _check(q, k, v, mask, num_heads, bias, rate, seed)
    need_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    ts = (q, k, v, mask) + tuple(t for t in (bias, seed) if t is not None)
    if not _build.use_kernel(*ts):
        return fused_attention_reference(q, k, v, mask, num_heads, causal,
                                         bias, rate, seed)
    if not need_grad:
        return _launch_fwd(q, k, v, mask, num_heads, causal, bias=bias,
                           rate=rate, seed=seed)
    return _FusedAttention.apply(q, k, v, mask, bias, seed, num_heads, causal,
                                 rate)


fused_attention.launches = 0
fused_attention_bwd.launches = 0
fused_attention_bwd_long.launches = 0
# the same launches by forward_route: a run shows which kernels it took
fused_attention.launches_by_route = {"tc": 0, "fma": 0}
fused_attention_bwd_long.launches_by_route = {"tc": 0, "fma": 0}
# A6's launches by a6_route, and those on its tensor-core kernel past 128
# rows (attention_bwd_tc_256)
fused_attention_bwd.launches_by_route = {"tc": 0, "fma": 0}
fused_attention_bwd.tc256_launches = 0
# launches that also computed dbias (a mode of each backward, counted apart)
fused_attention_bwd.dbias_launches = 0
fused_attention_bwd_long.dbias_launches = 0
