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

import functools
from typing import NamedTuple

import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.hashdrop import kernel_drop_args, keep_mask

EPS = 1e-5  # torch nn.LayerNorm's default, as HF BART uses it
WARPS = 8  # warps a block (csrc/fused_ln.cu kWarps)
# the H100's SMs, the shared memory of one (228 KB, 1 KB of it reserved
# per resident block) and the most a block may take; only the speed
# depends on them
SMS = 132
SMEM_SM = 228 * 1024
SMEM_BLOCK = 227 * 1024
L2_BYTES = 50 * 2 ** 20
MAX_D = 1024


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


class LnPlan(NamedTuple):
    """One launch of csrc/fused_ln.cu: ``route`` "vec" (16-byte chunks,
    ``vec`` values each, through the warp's cp.async ring of ``stages``
    rows) or "scalar" (``vec`` 1, ``stages`` 0: no ring); ``blocks`` of
    ``warps`` warps, warp w of W = blocks * warps taking rows w, w + W, ..
    (at most ``rows_per_warp`` of them); ``evict_first``: the backward's
    vector route loads h, res and dy evict-first, its inputs being more
    than the L2 holds."""
    route: str
    vec: int
    stages: int
    blocks: int
    warps: int
    rows_per_warp: int
    evict_first: bool


def ring(D: int, dtype: torch.dtype):
    """(stages, bytes) of the backward's block of rings on the vector route:
    each warp holds S rows of h, res and dy, E = 8 ceil(D / 256) values a
    lane each; three stages where they fit a block, else two. Both
    kernels take these stages, and the launcher refuses others
    (csrc/fused_ln.cu stages_of)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    row = WARPS * 3 * 8 * -(-D // 256) * 32 * elem
    stages = 3 if 3 * row <= SMEM_BLOCK else 2
    return stages, stages * row


@functools.lru_cache(maxsize=256)
def ln_plan(N: int, D: int, dtype: torch.dtype, aligned: bool) -> LnPlan:
    """The launch of L1 and L2 over N rows of D values of ``dtype`` (both
    take the same plan; ``aligned``: every row tensor starts on 16 bytes).
    The vector route needs aligned rows of a multiple of 16 bytes; any
    other shape or view takes the scalar one. A lane holds E = 8 ceil(D /
    256) values of a row, and the backward's registers allow two blocks an
    SM up to E 24, one above; its rings (``ring``) may allow fewer. The
    grid is one full wave of those blocks, or one row a warp where N is
    smaller: the warps' rows then differ by at most one, and every SM
    holds as many warps as it can (grids of one, two or four rows a warp,
    and the wave cut so that every warp takes the same rows, were slower
    at the paths' N: scripts/ln_grids_torch.py, PERF.md §6). The scalar
    route takes the same grid."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"fused LayerNorm kernels: D {D} outside "
                         f"[1, {MAX_D}]")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused LayerNorm kernels: dtype {dtype} not "
                        f"float32/bfloat16")
    if N < 1:
        raise ValueError(f"fused LayerNorm kernels: N {N} < 1")
    elem = 2 if dtype == torch.bfloat16 else 4
    E = 8 * -(-D // 256)
    vec = 16 // elem if aligned and D * elem % 16 == 0 else 1
    per_sm = 2 if E <= 24 else 1
    stages, ring_bytes = ring(D, dtype)
    if vec > 1:
        per_sm = min(per_sm, SMEM_SM // (ring_bytes + 1024))
    blocks = min(SMS * per_sm, -(-N // WARPS))
    return LnPlan("vec" if vec > 1 else "scalar", vec,
                  stages if vec > 1 else 0, blocks, WARPS,
                  -(-N // (blocks * WARPS)),
                  vec > 1 and 3 * N * D * elem > L2_BYTES)


@functools.lru_cache(maxsize=256)
def _check_site(shape, dtype, res_shape, res_dtype, g_shape, b_shape,
                seed_shape, seed_dtype, rate, kernel):
    """A call's checks of shapes and dtypes, once per distinct model site
    (they depend on nothing else). ``kernel``: the CUDA route's own, None
    on the CPU, else (gamma's and beta's dtypes and contiguity)."""
    D = shape[-1]
    if res_shape != shape or res_dtype != dtype:
        raise ValueError(f"res {tuple(res_shape)} {res_dtype} must match h "
                         f"{tuple(shape)} {dtype}")
    if g_shape != (D,) or (b_shape is not None and b_shape != (D,)):
        raise ValueError(f"gamma/beta must be ({D},)")
    if seed_shape != (1,) or seed_dtype != torch.int32:
        raise ValueError(f"seed must be a (1,) int32 tensor, got "
                         f"{tuple(seed_shape)} {seed_dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate {rate} outside [0, 1)")
    if kernel is not None and any(
            p is not None and p != (torch.float32, True) for p in kernel):
        raise TypeError("gamma/beta: the kernels take contiguous float32")


def _check(h, res, gamma, beta, seed, rate, kernel):
    params = None
    if kernel:
        params = tuple(None if p is None else (p.dtype, p.is_contiguous())
                       for p in (gamma, beta))
    _check_site(h.shape, h.dtype, res.shape, res.dtype, gamma.shape,
                None if beta is None else beta.shape, seed.shape,
                seed.dtype, rate, params)


def _launch_fwd(h, res, gamma, beta, seed, rate, eps):
    """L1 on contiguous h and res (gamma, beta and seed as _check took
    them)."""
    y = torch.empty_like(h)
    D = h.shape[-1]
    N = h.numel() // D if D else 0
    if N == 0:
        return y
    hp, rp = h.data_ptr(), res.data_ptr()
    plan = ln_plan(N, D, h.dtype, (hp | rp) % 16 == 0)
    _build.launch("vlpet_ln_fwd", hp, rp, gamma.data_ptr(), beta.data_ptr(),
                  seed.data_ptr(), y.data_ptr(), N, D,
                  *kernel_drop_args(rate), eps,
                  int(h.dtype == torch.bfloat16), plan.stages, plan.blocks)
    fused_dropout_add_ln.launches += 1
    fused_dropout_add_ln.launches_by_route[plan.route] += 1
    return y


def fused_dropout_add_ln_bwd(h: torch.Tensor, res: torch.Tensor,
                             gamma: torch.Tensor, seed: torch.Tensor,
                             dy: torch.Tensor, rate: float,
                             eps: float = EPS):
    """(dh, dres, dgamma, dbeta) of fused_dropout_add_ln for cotangent dy:
    kernel L2 on CUDA tensors (one launch of the row kernel and one of the
    column sum: dgamma/dbeta fp32, summed in a fixed order), autograd of
    the plain version on CPU tensors."""
    if dy.shape != h.shape or dy.dtype != h.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match h "
                         f"{tuple(h.shape)} {h.dtype}")
    kernel = _build.use_kernel(h, res, gamma, seed, dy)
    _check(h, res, gamma, None, seed, rate, kernel)
    if not kernel:
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (h, res, gamma)]
            beta = torch.zeros_like(gamma, requires_grad=True)
            y = fused_dropout_add_ln_reference(*args, beta, seed, rate, eps)
            return torch.autograd.grad(y, (*args, beta), dy)
    h, res, dy = h.contiguous(), res.contiguous(), dy.contiguous()
    D = h.shape[-1]
    N = h.numel() // D if D else 0
    dh, dres = torch.empty_like(h), torch.empty_like(res)
    dgdb = torch.empty((2, D), dtype=torch.float32, device=h.device)
    if N == 0:
        dgdb.zero_()
        return dh, dres, dgdb[0], dgdb[1]
    hp, rp, dp = h.data_ptr(), res.data_ptr(), dy.data_ptr()
    plan = ln_plan(N, D, h.dtype, (hp | rp | dp) % 16 == 0)
    partial = torch.empty((plan.blocks, 2, D), dtype=torch.float32,
                          device=h.device)
    _build.launch("vlpet_ln_bwd", hp, rp, gamma.data_ptr(), seed.data_ptr(),
                  dp, dh.data_ptr(), dres.data_ptr(), partial.data_ptr(),
                  dgdb.data_ptr(), N, D, *kernel_drop_args(rate), eps,
                  int(h.dtype == torch.bfloat16), plan.stages, plan.blocks,
                  int(plan.evict_first))
    fused_dropout_add_ln_bwd.launches += 1
    fused_dropout_add_ln_bwd.launches_by_route[plan.route] += 1
    return dh, dres, dgdb[0], dgdb[1]


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
    L2 backward (D <= 1024; ``ln_plan`` is their launch)."""
    kernel = _build.use_kernel(h, res, gamma, beta, seed)
    _check(h, res, gamma, beta, seed, rate, kernel)
    if not kernel:
        return fused_dropout_add_ln_reference(h, res, gamma, beta, seed, rate,
                                              eps)
    return _FusedDropoutAddLN.apply(h.contiguous(), res.contiguous(), gamma,
                                    beta, seed, rate, eps)


fused_dropout_add_ln.launches = 0
fused_dropout_add_ln_bwd.launches = 0
fused_dropout_add_ln.launches_by_route = {"vec": 0, "scalar": 0}
fused_dropout_add_ln_bwd.launches_by_route = {"vec": 0, "scalar": 0}
