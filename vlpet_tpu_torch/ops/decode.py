"""Decode-time attention for greedy and reorder-free beam search.

Port of vlpet_tpu/ops/decode.py. The self-attention KV cache is time-major
(L, B*J, H*Dh) and its rows are never reordered: each beam carries an
ancestry vector anc[b, k, t], the physical row that holds its KV at slot t,
and attention reads through it. The cross-attention KV stays at B rows,
shared by the K beams of a batch element.

beam_decode_attend is kernel D1 (csrc/beam_attend.cu, replacing
_beam_self_attend_pallas); its plain twin is the einsum form of the JAX
function's XLA branch. The kernel reads ``anc`` directly: the flat
(B*K, L*8*J) mask, the 8-row batch blocking and the pad of B to a multiple
of 8 were TPU sublane artefacts. T5's relative-bias row (1, H, 1, L), the
same for every beam of a step, rides as ``bias_row`` in both attends.

beam_decode_attend_update is kernel D2 (csrc/beam_attend.cu, replacing
beam_decode_attend_update's _beam_self_update_kernel, the opt-in
``use_fused_beam``): D1 over the slots before ``decode_pos``, plus each
beam's own new K/V as an extra term, then the write of the new K/V into
slot ``decode_pos``, in one launch.

On the card both are one launch of one kernel template and nothing else:
the ancestry goes by pointer as the caller holds it (int32 or int64, the
kernel reads either), the bias row and the own bias by pointer and
strides (T5's own bias is a column of its bias row: no copy), and the
checks cost no launch. ``beam_plan`` is the launch's shared-memory plan.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops.attention import fused_attention

NEG_INF = -1.0e9

# D1 / D2's launch (csrc/beam_attend.cu): kStages ring tiles of head slices
# in flight; "fma" a block of kThreads per head, tiles of _TILE_BYTES;
# "tc" a warp per head, up to _TC_MAX_HEADS heads a block (tc_heads), tiles
# of _TC_ENT entries, rows padded to _TC_LD elements
_STAGES, _THREADS, _TILE_BYTES = 3, 128, 8192
_TC_DH, _TC_LD, _TC_ENT, _TC_MAX_K = 64, 72, 16, 16
_TC_MAX_HEADS = 4
SMEM_LIMIT = 232448  # a block's shared memory on sm_90 (227 KB)
MAX_ROWS = 32  # J: a slot's rows are one 32-bit mask in the kernel
_FLOATS, _INDEX = (torch.float32, torch.bfloat16), (torch.int32, torch.int64)


def beam_route(K: int, Dh: int, dtype: torch.dtype) -> str:
    """D1 / D2's math, a plain function of (K, Dh, dtype): "tc" (a warp per
    head, tc_heads(H) heads a block, scores and P.V on mma.sync with the K
    beams as the rows of an m16 tile) for bf16 at Dh 64 with K <= 16 --
    every beam site of the repo -- else "fma" (a block per head, FMA dot
    products: fp32, which no tensor-core product keeps, and other
    widths)."""
    return ("tc" if dtype == torch.bfloat16 and Dh == _TC_DH
            and K <= _TC_MAX_K else "fma")


def tc_heads(H: int, K: int, J: int, P: int, update: bool = False) -> int:
    """Heads a "tc" block takes over P slots: the most that divide H, up to
    _TC_MAX_HEADS (4 at BART-base and T5-base: three blocks a batch
    element, five an SM; 6 and 12 heads a block, one 1536-byte run of a
    row's heads, measured slower: fewer blocks in flight), whose shared
    memory fits a block (fewer for a long cache); 1 if none does.
    ``update``: D2's launch."""
    for g in range(min(H, _TC_MAX_HEADS), 0, -1):
        if H % g == 0 and beam_plan(K, J, P, _TC_DH, 2, g,
                                    update)[1] <= SMEM_LIMIT:
            return g
    return 1


def _a16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def beam_plan(K: int, J: int, P: int, Dh: int, elem: int, heads: int,
              update: bool = False):
    """(rows, smem) of a D1 / D2 launch over P slots of a (B*J)-row cache,
    on route "tc" with ``heads`` heads a block, or "fma" (``heads`` 0): a
    ring tile holds ``rows`` entries -- _TC_ENT of each head ("tc"), or
    _TILE_BYTES of head slices, or the P * min(K, J) distinct rows a block
    can read at most, if fewer ("fma") -- and the block takes ``smem``
    bytes of shared memory, region by region as csrc/beam_attend.cu
    layout_of lays them out: the ring, the queries (16 rows a head on
    "tc"), "fma"'s fp32 P.V sums per slot split, per (head, beam, slot) a
    score, per (beam, slot) an entry number, per slot a row mask, a first
    entry and up to min(K, J) entries, D2's own probabilities and (D2,
    ``update``) its k_new and v_new rows. The kernel refuses a launch whose
    smem differs from its own layout."""
    if heads:
        G, ld, rows, qrows, acc = heads, _TC_LD, _TC_ENT, _TC_MAX_K, 0
    else:
        vecs = Dh * elem // 16
        splits = 1 if K * vecs >= _THREADS else _THREADS // (K * vecs)
        G, ld, qrows, acc = 1, Dh, K, _a16(splits * K * Dh * 4)
        rows = min(_TILE_BYTES // (Dh * elem), max(1, P * min(K, J)))
    smem = (_a16(_STAGES * rows * G * ld * elem) + _a16(G * qrows * ld * elem)
            + acc + _a16(G * K * P * 4) + _a16(K * P * 4) + _a16(P * 4)
            + _a16((P + 1) * 4) + _a16(P * min(K, J) * 4) + _a16(G * K * 4)
            + (_a16(2 * K * G * Dh * elem) if update else 0))
    return rows, smem


def _card_args(q: torch.Tensor, others: tuple, names: tuple,
               anc: torch.Tensor, J: int, P: int,
               bias_row: Optional[torch.Tensor], update: bool):
    """The checks of a D1 / D2 launch, none of which launches anything, and
    the launch's shared arguments: q as (B*K, H*Dh) (copied only where the
    caller's is not contiguous), the ancestry's int64 flag, the bias row's
    pointer and strides, and the launch's route flag, heads a block, tile
    rows and smem (beam_route, tc_heads, beam_plan). ``others`` (the
    caches, D2's new K/V; ``names`` names q and them) must have q's dtype
    and be contiguous and 16-byte aligned. The ancestry goes as the caller
    holds it: int32 or int64, and one that is not contiguous raises (it is
    never copied)."""
    B, K, _ = anc.shape
    H, Dh = q.shape[-2:]
    dt = q.dtype
    q2 = q.reshape(B * K, H * Dh)
    if not q2.is_contiguous():
        q2 = q2.contiguous()
    ts = (q2,) + others
    elem = q2.element_size()
    if (dt not in _FLOATS or anc.dtype not in _INDEX
            or not anc.is_contiguous() or J > MAX_ROWS or (Dh * elem) % 16
            or any(t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16
                   for t in ts)):
        _refuse(ts, names, anc, J, Dh)
    heads = (tc_heads(H, K, J, P, update) if beam_route(K, Dh, dt) == "tc"
             else 0)
    rows, smem = beam_plan(K, J, P, Dh, elem, heads, update)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K {K}, {P} slots, Dh {Dh}: {smem} bytes of "
                         f"shared memory, over the block's {SMEM_LIMIT}")
    bias = ((None, 0, 0) if bias_row is None else
            (bias_row.data_ptr(), bias_row.stride(1), bias_row.stride(3)))
    return (q2, int(anc.dtype == torch.int64), bias,
            (int(heads > 0), max(heads, 1), rows, smem))


def _refuse(ts: tuple, names: tuple, anc: torch.Tensor, J: int, Dh: int):
    """Raise the error of the check of _card_args that failed."""
    if ts[0].dtype not in _FLOATS:
        raise TypeError(f"q: dtype {ts[0].dtype} not in {_FLOATS}")
    if anc.dtype not in _INDEX:
        raise TypeError(f"anc: dtype {anc.dtype} not in {_INDEX}")
    if not anc.is_contiguous():
        raise ValueError("anc: the ancestry must be contiguous (the kernel "
                         "reads it in place)")
    if J > MAX_ROWS:
        raise ValueError(f"{J} cache rows per batch element: the kernel "
                         f"takes at most {MAX_ROWS}")
    for name, t in zip(names, ts):
        _build.check(t, name, (ts[0].dtype,), t.dim())  # shapes: the caller
        if t.data_ptr() % 16 or (Dh * t.element_size()) % 16:
            raise ValueError(f"{name}: the kernel copies 16-byte pieces of "
                             f"each head's Dh {Dh}: the tensor must be "
                             f"16-byte aligned and Dh * {t.element_size()} "
                             f"a multiple of 16")


def beam_selection_mask(anc: torch.Tensor, decode_pos: int, cache_len: int,
                        num_rows: int) -> torch.Tensor:
    """Additive (B, K, J, L) f32 mask: slot l of row j is attendable by beam
    k iff l <= decode_pos and anc[b, k, l] == j."""
    j = torch.arange(num_rows, device=anc.device)[None, None, :, None]
    l = torch.arange(cache_len, device=anc.device)[None, None, None, :]
    sel = (anc[:, :, None, :] == j) & (l <= decode_pos)
    return torch.where(sel, 0.0, NEG_INF).float()


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  bias_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode self-attention over the time-major cache (plain, as in
    the JAX package). q (B, 1, H, Dh); k, v (L, B, H*Dh); mask additive with
    trailing L axis, e.g. (1, 1, 1, L); bias_row additive (1, H, 1, L) (T5).
    Returns (B, 1, H*Dh)."""
    H, Dh = q.shape[-2:]
    L, B = k.shape[:2]
    kh = k.reshape(L, B, H, Dh)
    vh = v.reshape(L, B, H, Dh)
    logits = torch.einsum("bhd,lbhd->bhl", q.reshape(B, H, Dh).float(),
                          kh.float())
    if mask is not None:
        logits = logits + mask.float().reshape(mask.shape[0], 1, L)
    if bias_row is not None:
        logits = logits + bias_row.float().reshape(1, H, L)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhl,lbhd->bhd", probs, vh)
    return out.reshape(B, 1, H * Dh)


def beam_decode_attend_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, anc: torch.Tensor,
                                 decode_pos: int,
                                 bias_row: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain twin of the beam kernel: the einsum form of
    vlpet_tpu/ops/decode.py:beam_decode_attend (:409-434), every beam scored
    against all J rows of its batch element through the ancestry mask, the
    bias row added to every row's slots."""
    B, K, _ = anc.shape
    L = k.shape[0]
    J = k.shape[1] // B
    H, Dh = q.shape[-2:]
    sel = beam_selection_mask(anc, decode_pos, L, J)
    qb = q.reshape(B, K, H, Dh)
    kb = k.reshape(L, B, J, H, Dh)
    vb = v.reshape(L, B, J, H, Dh)
    logits = torch.einsum("bqhd,lbjhd->bhqjl", qb.float(), kb.float())
    logits = logits.reshape(B, H, K, J * L) + sel.reshape(B, 1, K, J * L)
    if bias_row is not None:
        # memory index j*L + l: the L-long row repeats over the J rows
        logits = logits + bias_row.float().reshape(1, H, 1, L).repeat(
            1, 1, 1, J)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqjl,lbjhd->bqhd", probs.reshape(B, H, K, J, L), vb)
    return out.reshape(B * K, 1, H * Dh)


def beam_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       anc: torch.Tensor, decode_pos: int,
                       bias_row: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Ancestry-routed self-attention for one beam decode step.

    q (B*K, 1, H, Dh); k, v (L, B*J, H*Dh) time-major cache whose slot
    ``decode_pos`` already holds this step's KV (the mask is inclusive);
    anc (B, K, L) integer ancestry with values in [0, J) (on the card int32
    or int64, contiguous: the kernel reads it in place); bias_row optional
    additive (1, H, 1, L) fp32 (T5 relative positions, any strides), added
    to slot l of every beam. Returns (B*K, 1, H*Dh). CPU tensors run the
    plain version; CUDA tensors launch the kernel (one launch)."""
    B, K, Lc = anc.shape
    H, Dh = q.shape[-2:]
    if k.shape[0] != Lc or k.shape[1] % B or k.shape != v.shape:
        raise ValueError(f"cache {tuple(k.shape)} does not match ancestry "
                         f"{tuple(anc.shape)}")
    if q.shape[0] != B * K or k.shape[2] != H * Dh:
        raise ValueError(f"q {tuple(q.shape)} does not match cache/ancestry")
    if not 0 <= decode_pos < Lc:
        raise ValueError(f"decode_pos {decode_pos} outside the cache [0, {Lc})")
    if bias_row is not None and (bias_row.shape != (1, H, 1, Lc) or
                                 bias_row.dtype != torch.float32):
        raise ValueError(f"bias_row must be (1, H={H}, 1, L={Lc}) fp32; got "
                         f"{bias_row.dtype} {tuple(bias_row.shape)}")
    ts = (q, k, v, anc) + (() if bias_row is None else (bias_row,))
    if not _build.use_kernel(*ts):
        return beam_decode_attend_reference(q, k, v, anc, decode_pos,
                                            bias_row)
    J = k.shape[1] // B
    q2, anc64, (bias, sh, st), plan = _card_args(
        q, (k, v), ("q", "k", "v"), anc, J, decode_pos + 1, bias_row, False)
    out = torch.empty_like(q2)
    _build.launch("vlpet_beam_attend", q2.data_ptr(), k.data_ptr(),
                  v.data_ptr(), anc.data_ptr(), bias, out.data_ptr(), B, K,
                  J, Lc, H, Dh, int(decode_pos), anc64, sh, st,
                  int(q.dtype == torch.bfloat16), *plan)
    beam_decode_attend.launches += 1
    return out.reshape(B * K, 1, H * Dh)


beam_decode_attend.launches = 0


def beam_cross_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      attend: Callable = fused_attention) -> torch.Tensor:
    """Cross-attention with beam-shared encoder KV: the K beams of a batch
    element are a K-long query sequence over its one (S, H*Dh) KV copy,
    through the fused attention (kernel 1 on CUDA).

    q (B*K, 1, H, Dh); k, v (B, S, H*Dh); mask additive (B, 1, 1, S).
    ``attend`` is fused_attention or its plain twin. Returns
    (B*K, 1, H*Dh)."""
    H, Dh = q.shape[-2:]
    B, S = k.shape[:2]
    K = q.shape[0] // B
    if mask is None:
        m = torch.zeros((1, 1, 1, S), dtype=torch.float32, device=q.device)
    else:
        m = mask.float().reshape(B, 1, 1, S)
    out = attend(q.reshape(B, K, H * Dh), k, v, m, H)
    return out.reshape(B * K, 1, H * Dh)


_D2_NAMES = ("q", "k_cache", "v_cache", "k_new", "v_new")


def _check_update(q, k_cache, v_cache, k_new, v_new, anc, decode_pos,
                  own_bias, bias_row):
    B, K, Lc = anc.shape
    H, Dh = q.shape[-2:]
    if k_cache.shape != (Lc, B * K, H * Dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} must be (L, B*K, "
                         f"H*Dh) = ({Lc}, {B * K}, {H * Dh}): one physical "
                         f"row per beam")
    if q.shape[0] != B * K or k_new.numel() != B * K * H * Dh \
            or v_new.numel() != k_new.numel():
        raise ValueError("q / k_new / v_new do not match the ancestry")
    if not 0 <= decode_pos < Lc:
        raise ValueError(f"decode_pos {decode_pos} outside the cache [0, {Lc})")
    for name, t, shape in (("own_bias", own_bias, (H,)),
                           ("bias_row", bias_row, (1, H, 1, Lc))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} fp32; got {t.dtype} "
                             f"{tuple(t.shape)}")


def beam_decode_attend_update_reference(
        q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        k_new: torch.Tensor, v_new: torch.Tensor, anc: torch.Tensor,
        decode_pos: int, own_bias: Optional[torch.Tensor] = None,
        bias_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of D2 (vlpet_tpu/ops/decode.py:208-247): the cache slots
    l <= decode_pos - 1 read through the ancestry, plus an own-row score
    q . k_new (elementwise products in q's dtype, summed in fp32, plus
    ``own_bias``) under one softmax; the cache part of the probabilities
    rounded to q's dtype before P.V (fp32 accumulation), the own part added
    in fp32. Then k_new and v_new are written into slot ``decode_pos`` of
    the caches, in place. Returns (B*K, 1, H*Dh)."""
    _check_update(q, k_cache, v_cache, k_new, v_new, anc, decode_pos,
                  own_bias, bias_row)
    B, K, L = anc.shape
    H, Dh = q.shape[-2:]
    sel = beam_selection_mask(anc, decode_pos - 1, L, K)
    qb = q.reshape(B, K, H, Dh)
    kb = k_cache.reshape(L, B, K, H, Dh)
    vb = v_cache.reshape(L, B, K, H, Dh)
    kn = k_new.reshape(B, K, H, Dh).to(q.dtype)
    vn = v_new.reshape(B, K, H, Dh).to(q.dtype)
    s = torch.einsum("bqhd,lbjhd->bhqjl", qb.float(), kb.float())
    s = s.reshape(B, H, K, K * L) + sel.reshape(B, 1, K, K * L)
    if bias_row is not None:
        s = s + bias_row.float().reshape(1, H, 1, L).repeat(1, 1, 1, K)
    s_own = (qb * kn).float().sum(-1).permute(0, 2, 1)  # (B, H, K)
    if own_bias is not None:
        s_own = s_own + own_bias.float().reshape(1, H, 1)
    m = torch.maximum(s.amax(-1), s_own)
    e = torch.exp(s - m[..., None])
    eo = torch.exp(s_own - m)
    denom = e.sum(-1) + eo
    p = (e / denom[..., None]).to(q.dtype).float()
    out = torch.einsum("bhqjl,lbjhd->bqhd", p.reshape(B, H, K, K, L),
                       vb.float())
    out = out + (eo / denom).permute(0, 2, 1)[..., None] * vn.float()
    k_cache[decode_pos] = kn.reshape(B * K, H * Dh).to(k_cache.dtype)
    v_cache[decode_pos] = vn.reshape(B * K, H * Dh).to(v_cache.dtype)
    return out.to(q.dtype).reshape(B * K, 1, H * Dh)


def beam_decode_attend_update(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, anc: torch.Tensor,
                              decode_pos: int,
                              own_bias: Optional[torch.Tensor] = None,
                              bias_row: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Fused beam self-attention and cache write for one decode step.

    q (B*K, 1, H, Dh); k_cache, v_cache (L, B*K, H*Dh) time-major, one
    physical row per beam (J == K), whose slot ``decode_pos`` still holds
    stale data and is overwritten, in place, with k_new, v_new ((B*K) *
    H*Dh elements each, rows beam-major); anc (B, K, L) ancestry, read at
    slots l <= decode_pos - 1 (this step enters through the own-row term);
    own_bias optional (H,) fp32 on the own score (T5's distance-0 bias: a
    column of the bias row, any stride); bias_row optional (1, H, 1, L)
    fp32 on the cache side (any strides); on the card the ancestry is
    int32 or int64 and contiguous, read in place. Returns
    (B*K, 1, H*Dh). CPU tensors run the plain twin; CUDA tensors launch
    D2."""
    _check_update(q, k_cache, v_cache, k_new, v_new, anc, decode_pos,
                  own_bias, bias_row)
    ts = (q, k_cache, v_cache, k_new, v_new, anc)
    if own_bias is not None:
        ts += (own_bias,)
    if bias_row is not None:
        ts += (bias_row,)
    if not _build.use_kernel(*ts):
        return beam_decode_attend_update_reference(
            q, k_cache, v_cache, k_new, v_new, anc, decode_pos, own_bias,
            bias_row)
    B, K, Lc = anc.shape
    H, Dh = q.shape[-2:]
    kn = k_new.reshape(B * K, H * Dh)
    vn = v_new.reshape(B * K, H * Dh)
    if kn.dtype != q.dtype or not kn.is_contiguous():
        kn = kn.to(q.dtype).contiguous()
    if vn.dtype != q.dtype or not vn.is_contiguous():
        vn = vn.to(q.dtype).contiguous()
    q2, anc64, (bias, sh, st), plan = _card_args(
        q, (k_cache, v_cache, kn, vn), _D2_NAMES, anc, K, decode_pos,
        bias_row, True)
    obias, so = ((None, 0) if own_bias is None
                 else (own_bias.data_ptr(), own_bias.stride(0)))
    out = torch.empty_like(q2)
    _build.launch("vlpet_beam_attend_update", q2.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(),
                  vn.data_ptr(), anc.data_ptr(), bias, obias, out.data_ptr(),
                  B, K, Lc, H, Dh, int(decode_pos), anc64, sh, st, so,
                  int(q.dtype == torch.bfloat16), *plan)
    beam_decode_attend_update.launches += 1
    return out.reshape(B * K, 1, H * Dh)


beam_decode_attend_update.launches = 0
