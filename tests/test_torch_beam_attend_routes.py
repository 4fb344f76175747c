"""D1 and D2 (the beam self-attends) on CPU: the bf16 twins, the launch
plan and the wrappers' host path.

The bf16 twins (``beam_decode_attend`` and ``beam_decode_attend_update``
on CPU tensors) are held to the JAX package's Pallas kernels in interpret
mode (``_beam_self_attend_pallas`` through ``beam_sel_big``, and
``beam_decode_attend_update`` with ``_INTERPRET``) at ragged beam counts
(K 2, 3, 5) and several positions, with and without T5's bias row (and
the own bias, its column ``pos``): the output within 2e-2 * (1 +
max|jax|) (the twins and the kernels round the probabilities to bf16 at
the same place but sum in other orders), D2's caches bit for bit.

``ops.decode.beam_route`` picks the kernel's math ("tc", mma.sync, for
bf16 at Dh 64; "fma" otherwise), ``tc_heads`` the heads a "tc" block
takes, and ``ops.decode.beam_plan`` is its launch plan: the ring tiles
cover every distinct (slot, row) entry once, and the block's shared
memory stays within the card's 227 KB for every cache length up to 1024,
Dh up to 128 and K up to 8, bf16 and fp32, D1 and D2.

The wrappers' routes, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA): one
launch per D1 and D2 call and nothing else; the ancestry pointer passed
is the caller's own, int32 and int64 alike, with the matching flag (no
cast, no copy); a non-contiguous ancestry raises; the bias row and the
own bias go by pointer and strides, so T5's D2 call site hands over a
column of its bias row with no copy. ``beam_generate`` hands the model an
int32 ancestry, as the JAX loop does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.ops.decode as jdecode
from test_torch_t5 import _jax_cfg as _t5_jax_cfg
from test_torch_t5 import _port_cfg as _t5_port_cfg
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.models.t5 import T5Attention
from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import decode as tdec

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
B, H, Dh, L = 8, 2, 16, 6


def _inputs(K: int, pos: int, bias: bool, seed: int):
    """bf16-exact inputs (numpy fp32 holding bf16 values): q, caches, new
    K/V, an ancestry with slot pos the own rows, T5's bias row."""
    rng = np.random.default_rng(seed)

    def bf(*shape, scale=1.0):
        x = torch.from_numpy((rng.normal(size=shape) * scale)
                             .astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()
    anc = rng.integers(0, K, (B, K, L)).astype(np.int32)
    anc[:, :, pos] = np.arange(K)
    row = bf(1, H, 1, L) if bias else None
    return dict(q=bf(B * K, 1, H, Dh, scale=Dh ** -0.5),
                k=bf(L, B * K, H * Dh), v=bf(L, B * K, H * Dh),
                kn=bf(B * K, 1, H, Dh), vn=bf(B * K, 1, H, Dh), anc=anc,
                row=row, own=None if row is None else row[0, :, 0, pos])


def _bf(x):
    return None if x is None else torch.from_numpy(np.array(x)).to(
        torch.bfloat16)


def _jbf(x):
    return None if x is None else jnp.asarray(x, jnp.bfloat16)


def _close(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * (1.0 + np.abs(want).max()))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("K", [2, 3, 5])
def test_d1_bf16_twin_matches_pallas(K, bias):
    # one trace for every pos (the mask is an input)
    pallas = jax.jit(lambda *x: jdecode._beam_self_attend_pallas(
        *x, H, K, K, interpret=True))
    for pos in (0, 3, L - 1):
        a = _inputs(K, pos, bias, seed=10 * K + pos)
        janc = jnp.asarray(a["anc"])
        sel = jdecode.beam_sel_big(janc, pos, K, L, 8)
        bias_big = (jnp.repeat(jnp.asarray(a["row"]).reshape(H, L), 8 * K,
                               axis=1) if bias
                    else jnp.zeros((H, L * 8 * K), jnp.float32))
        want = pallas(_jbf(a["q"]).reshape(B * K, H * Dh), _jbf(a["k"]),
                      _jbf(a["v"]), sel, bias_big)
        got = tdec.beam_decode_attend(
            _bf(a["q"]), _bf(a["k"]), _bf(a["v"]),
            torch.from_numpy(a["anc"]).long(), pos,
            None if a["row"] is None else torch.from_numpy(a["row"]))
        assert got.dtype == torch.bfloat16
        _close(got, want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("K", [2, 3, 5])
def test_d2_bf16_twin_matches_pallas(K, bias):
    # one trace for every pos (decode_pos is traced), in interpret mode
    pallas = jax.jit(jdecode.beam_decode_attend_update)
    for pos in (0, 3, L - 1):
        a = _inputs(K, pos, bias, seed=100 + 10 * K + pos)
        opt = (lambda x: None if x is None else jnp.asarray(x))
        jdecode._INTERPRET = True
        try:
            want, want_k, want_v = pallas(
                _jbf(a["q"]), _jbf(a["k"]), _jbf(a["v"]), _jbf(a["kn"]),
                _jbf(a["vn"]), jnp.asarray(a["anc"]), pos,
                own_bias=opt(a["own"]), bias_row=opt(a["row"]))
        finally:
            jdecode._INTERPRET = False
        kc, vc = _bf(a["k"]), _bf(a["v"])
        row = None if a["row"] is None else torch.from_numpy(a["row"])
        got = tdec.beam_decode_attend_update(
            _bf(a["q"]), kc, vc, _bf(a["kn"]), _bf(a["vn"]),
            torch.from_numpy(a["anc"]), pos,
            None if row is None else row[0, :, 0, pos], row)
        _close(got, want)
        for c, w in ((kc, want_k), (vc, want_v)):
            np.testing.assert_array_equal(
                c.float().numpy().reshape(L, B * K, H * Dh),
                np.asarray(jnp.asarray(w, jnp.float32)).reshape(
                    L, B * K, H * Dh))


@pytest.mark.parametrize("Dh, elem, tc", [
    (Dh, elem, False) for Dh in (16, 32, 64, 128) for elem in (2, 4)]
    + [(64, 2, True)])
def test_beam_plan_fits_and_tiles_every_entry_once(Dh, elem, tc):
    for K in range(1, 9):
        for P in (0, 1, 40, 160, 1023, 1024):
            for update in (False, True):
                heads = tdec.tc_heads(12, K, K, P, update) if tc else 0
                smem = tdec.beam_plan(K, K, P, Dh, elem, heads, update)[1]
                assert smem % 16 == 0 and smem <= tdec.SMEM_LIMIT, \
                    (K, P, update, smem)
            rows = tdec.beam_plan(K, K, P, Dh, elem, heads)[0]
            if tc:
                assert rows == 16  # entries a head: one k16 step
                assert 12 % heads == 0 and heads >= 3
            else:  # no more rows than a block reads
                assert 1 <= rows <= min(tdec._TILE_BYTES // (Dh * elem),
                                        max(1, P * K))
            # the kernel's tiles: entries [u rows, u rows + rows), each
            # entry of a block (at most P * K) in exactly one, none empty
            for E in {0, 1, rows - 1, rows, rows + 1, P * K}:
                spans = [range(u * rows, min(E, (u + 1) * rows))
                         for u in range(-(-E // rows))]
                assert sorted(e for s in spans for e in s) == list(range(E))
                assert all(len(s) for s in spans)


def test_beam_route_and_the_decode_paths_plan():
    bf, f32 = torch.bfloat16, torch.float32
    assert tdec.beam_route(5, 64, bf) == "tc"
    assert tdec.beam_route(16, 64, bf) == "tc"
    for K, Dh, dtype in ((5, 64, f32), (5, 32, bf), (5, 128, bf),
                         (17, 64, bf)):
        assert tdec.beam_route(K, Dh, dtype) == "fma"
    # the BART / T5 beam sites (12 heads): four heads a block, fewer where
    # a long cache needs the room
    for P in (1, 40, 160, 1024):
        assert tdec.tc_heads(12, 5, 5, P) == 4
    assert tdec.tc_heads(12, 8, 8, 1024) == 3
    assert tdec.tc_heads(7, 5, 5, 40) == 1 and tdec.tc_heads(6, 5, 5, 40) == 3
    assert tdec.beam_plan(5, 5, 1, 64, 4, 0)[0] == 5


class _Recorder:
    """Stands in for ``_build.launch``: records (name, args), runs
    nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))

    def names(self):
        return [n for n, _ in self.calls]


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers take their CUDA route on CPU tensors and launch into a
    recorder."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", rec)
    return rec


def _card_inputs(K=5, Lc=40, dtype=torch.bfloat16, Dh=Dh, H=H):
    q = torch.zeros(B * K, 1, H, Dh, dtype=dtype)
    k = torch.zeros(Lc, B * K, H * Dh, dtype=dtype)
    new = torch.zeros(B * K, 1, H * Dh, dtype=dtype)
    row = torch.zeros(1, Lc, H).permute(2, 0, 1)[None]  # T5's layout
    return q, k, k.clone(), new, new.clone(), row


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_d1_one_launch_with_the_callers_ancestry(card_route, idx):
    q, k, v, _, _, row = _card_inputs(Dh=64, H=4)
    anc = torch.zeros(B, 5, 40, dtype=idx)
    before = tdec.beam_decode_attend.launches
    tdec.beam_decode_attend(q, k, v, anc, 39, row)
    assert card_route.names() == ["vlpet_beam_attend"]
    assert tdec.beam_decode_attend.launches == before + 1
    args = card_route.calls[0][1]
    assert args[3] == anc.data_ptr()  # no cast, no copy
    assert args[13] == int(idx == torch.int64)
    assert args[4] == row.data_ptr() and args[14:16] == (1, 4)
    assert args[6:13] == (B, 5, 5, 40, 4, 64, 39)
    # bf16 at Dh 64: the tensor-core route, a block of four heads
    assert args[16:] == (1, 1, 4) + tdec.beam_plan(5, 5, 40, 64, 2, 4)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_d2_one_launch_with_the_callers_ancestry(card_route, idx):
    q, k, v, kn, vn, row = _card_inputs(dtype=torch.float32)
    anc = torch.zeros(B, 5, 40, dtype=idx)
    own = row[0, :, 0, 17]  # a column of the row: a strided view
    before = tdec.beam_decode_attend_update.launches
    tdec.beam_decode_attend_update(q, k, v, kn, vn, anc, 17, own, row)
    assert card_route.names() == ["vlpet_beam_attend_update"]
    assert tdec.beam_decode_attend_update.launches == before + 1
    args = card_route.calls[0][1]
    assert args[1:6] == (k.data_ptr(), v.data_ptr(), kn.data_ptr(),
                         vn.data_ptr(), anc.data_ptr())
    assert args[15] == int(idx == torch.int64)
    assert args[6] == row.data_ptr() and args[16:18] == (1, H)
    assert args[7] == own.data_ptr() == row.data_ptr() + 4 * 17 * H
    assert args[18] == 1
    assert args[9:15] == (B, 5, 40, H, Dh, 17)
    assert args[19:] == (0, 0, 1) + tdec.beam_plan(5, 5, 17, Dh, 4, 0, True)


def test_non_contiguous_ancestry_raises(card_route):
    q, k, v, kn, vn, _ = _card_inputs()
    anc = torch.zeros(B, 5, 80, dtype=torch.int64)[:, :, ::2]
    with pytest.raises(ValueError, match="ancestry must be contiguous"):
        tdec.beam_decode_attend(q, k, v, anc, 3)
    with pytest.raises(ValueError, match="ancestry must be contiguous"):
        tdec.beam_decode_attend_update(q, k, v, kn, vn, anc, 3)
    assert card_route.calls == []


@pytest.mark.parametrize("fused", [False, True])
def test_t5_self_attention_hands_over_its_bias_row(card_route, fused):
    """T5's decode-step self-attention: D2 (use_fused_beam) gets the bias
    row and its column pos by pointer, no own-bias copy; D1 gets the row
    by pointer and strides after U1's slot write."""
    cfg = dataclasses.replace(_t5_port_cfg(_t5_jax_cfg(False)),
                              use_fused_beam=fused)
    att = T5Attention(cfg, "dec_self", device="cpu")
    Hc, Dc = att.num_heads, att.head_dim
    K, Lc, pos = 5, 12, 7
    cache = {"k": torch.zeros(Lc, 2 * K, Hc * Dc),
             "v": torch.zeros(Lc, 2 * K, Hc * Dc)}
    bias = torch.zeros(1, Lc, Hc).permute(2, 0, 1)[None]
    anc = torch.zeros(2, K, Lc, dtype=torch.int32)
    with torch.no_grad():
        att(torch.zeros(2 * K, 1, cfg.backbone.d_model), None, bias=bias,
            cache=cache, decode_pos=pos, beam_anc=anc)
    if fused:
        assert card_route.names() == ["vlpet_beam_attend_update"]
        args = card_route.calls[0][1]
        assert args[5] == anc.data_ptr() and args[15] == 0
        assert args[6] == bias.data_ptr()
        assert args[7] == bias.data_ptr() + 4 * pos * bias.stride(3)
        assert args[16:19] == (bias.stride(1), bias.stride(3),
                               bias.stride(1))
    else:
        assert card_route.names() == ["vlpet_cache_update",
                                      "vlpet_beam_attend"]
        args = card_route.calls[1][1]
        assert args[3] == anc.data_ptr() and args[4] == bias.data_ptr()
        assert args[14:16] == (bias.stride(1), bias.stride(3))


def test_beam_generate_hands_an_int32_ancestry():
    """The loop builds and gathers the ancestry in int32 (the JAX loop's
    dtype), contiguous, and hands it to the model as it is."""
    seen = []
    B2, K, V = 2, 3, 11

    def decode_topk(tok, pos, cache, anc, k):
        seen.append((anc.dtype, anc.is_contiguous(),
                     anc[:, :, pos].tolist()))
        g = torch.Generator().manual_seed(pos)
        vals = torch.rand(B2 * K, V, generator=g)
        top, idx = vals.topk(k, dim=-1)
        return top, idx, torch.zeros(B2 * K), cache

    tgen.beam_generate(decode_topk, ({"k": torch.zeros(6, B2 * K, 4)},),
                       B2, K, 6, 0, 1, 0, device="cpu")
    assert len(seen) >= 2
    for dtype, contiguous, own in seen:
        assert dtype == torch.int32 and contiguous
        assert own == [list(range(K))] * B2
