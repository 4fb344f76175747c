"""F2's launch rule, the bf16 FFN backward twin, U1's K+V write and the
wrappers' routes, on CPU.

On the card the bf16 F2 (csrc/ffn.cu ffn_bwd_tc) splits the hidden over
blocks where the row blocks do not fill the card, by ``ops.ffn.f1_splits``
(F1's rule); here it is held as a plain function of the shapes and the SM
count at F2's rows: every 64-wide hidden chunk in exactly one split, no
split empty, the grid one wave when it splits, one split at the encoders'
training rows (N 16800, 28000, 30200: no partials).

The bf16 twin (``fused_ffn_bwd`` on CPU tensors) is held to the jax.vjp of
vlpet_tpu/ops/ffn.py's fused_ffn with the Pallas kernels in interpret mode
over 16-row tiles (several programs, so the hash mask follows the global
index n F + f that a kernel splitting F over blocks must reproduce): dx,
db1 and db2 at ragged row counts, gelu with biases (BART) and relu without
(T5), with and without dropout, within 2e-2 * (1 + max|jax|) (the twin
rounds h and dh to bf16, the kernels keep them in fp32); the dropout mask
itself bit for bit through picking weights (dx is the dropped cotangent of
the picked columns).

U1's pair form (``cache_slots_update`` on CPU tensors, the loop of its
plain twin) equals two ``jax.lax.dynamic_update_slice`` writes, bit for
bit.

The wrappers' routes, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA): F2
reads F1's re-laid copy of the weights (its only one: W2[:, chunk] and
W1[chunk, :] are read MN-major from the same pieces), made once while the
weights are unchanged and again after an in-place write; each launch
carries f1_splits' split count with partials when it splits; fp32 takes
the FMA kernel with no re-lay; a misaligned bf16 dy is refused;
``write_slot`` makes one U1 launch for a layer's K and V.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.models.bart import write_slot
from vlpet_tpu_torch.ops import _build, cache_update
from vlpet_tpu_torch.ops import ffn as tffn

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([13579], np.int32)
SMS = (132, 114, 8)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", [1, 37, 500, 2501, 3000, 5000, 16800, 28000,
                               30200])
def test_f2_splits_cover_every_chunk_once(N, sms):
    for D, Fh in ((768, 3072), (128, 256), (1024, 4096), (896, 3584)):
        S, per = tffn.f1_splits(N, D, Fh, sms)
        chunks = Fh // 64
        spans = [range(s * per, min((s + 1) * per, chunks))
                 for s in range(S)]
        assert all(len(r) for r in spans), "an empty split"
        assert sorted(c for r in spans for c in r) == list(range(chunks))
        blocks = -(-N // 64) * -(-(D // 128) // 6)
        if S > 1:
            assert blocks * S <= sms, "a split grid past one wave"


@pytest.mark.parametrize("N, S", [(16800, 1), (28000, 1), (30200, 1),
                                  (5000, 1), (3000, 2), (500, 16)])
def test_f2_splits_at_the_model_rows(N, S):
    """D 768, F 3072 on 132 SMs: the encoders' and the BART decoder's
    training rows take one split, T5's decoder rows two, the video
    decoder's sixteen."""
    assert tffn.f1_splits(N, 768, 3072, 132)[0] == S


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, its values as a bf16 jax array)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _jax_ffn_vjp(monkeypatch, x, w1, b1, w2, b2, act, rate, dy):
    """(dx, db1, db2) of vlpet_tpu's fused_ffn for dy, in interpret mode over
    16-row tiles; weights in torch's Linear layout (out, in)."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    _, vjp = jax.vjp(lambda a, c1, c2: jffn.fused_ffn(
        a, w1.T, c1, w2.T, c2, act, rate, jnp.asarray(SEED)),
        x, jnp.asarray(b1), jnp.asarray(b2))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(dy)]


def _close(got, want):
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= TOL * (1.0 + np.abs(want).max()), err.max()


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("N", [37, 250])
def test_f2_bf16_twin_matches_pallas_interpret(monkeypatch, N, act, rate):
    D, Fh = 128, 256
    rng = np.random.default_rng(N + 7 * (act == "relu"))
    (tx, jx), (tdy, jdy), (tw1, jw1), (tw2, jw2) = map(_bf16, (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(D, Fh)).astype(np.float32) * 0.1))
    # gelu with biases (BART), relu without (T5's FFN has none)
    bias = 0.1 if act == "gelu" else 0.0
    b1 = (rng.normal(size=(Fh,)) * bias).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * bias).astype(np.float32)
    want = _jax_ffn_vjp(monkeypatch, jx, jw1, b1, jw2, b2, act, rate, jdy)
    got = tffn.fused_ffn_bwd(tx, tdy, tw1, torch.from_numpy(b1), tw2, act,
                             rate, torch.from_numpy(SEED))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (N, D)
    assert got[1].shape == (Fh,) and got[2].shape == (D,)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("N", [37, 250])
def test_f2_bf16_dropout_mask_matches_pallas_bit_for_bit(monkeypatch, N):
    """W1 spreads x = 1 onto hidden columns off .. off + D (b1 = 1 keeps
    relu' at 1) and W2 picks dy = 1 back from them, so dx = drop(dh) . W1
    is the dropped cotangent of the picked columns: nonzero exactly where
    the mask keeps."""
    D, Fh, off = 128, 256, 128
    pick = np.zeros((D, Fh), np.float32)
    pick[np.arange(D), np.arange(D) + off] = 1.0
    (tx, jx), (tsp, jsp), (tpk, jpk) = map(_bf16, (
        np.ones((N, D), np.float32), np.ascontiguousarray(pick.T), pick))
    b1, b2 = np.ones(Fh, np.float32), np.zeros(D, np.float32)
    want_dx = _jax_ffn_vjp(monkeypatch, jx, jsp, b1, jpk, b2, "relu", RATE,
                           jx)[0]
    dx = tffn.fused_ffn_bwd(tx, tx, tsp, torch.from_numpy(b1), tpk, "relu",
                            RATE, torch.from_numpy(SEED))[0]
    np.testing.assert_array_equal(dx.float().numpy() != 0, want_dx != 0)
    assert 0.8 < (want_dx != 0).mean() < 0.95


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5])
def test_cache_slots_update_is_two_dynamic_update_slices(dtype, pos):
    rng = np.random.default_rng(pos + 1)
    tdt = getattr(torch, dtype)
    for shape in ((3, 6, 2, 8), (1, 6, 4, 16)):  # (N, L, H, Dh); time-major
        N, L = shape[:2]
        caches = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  .to(tdt) for _ in range(2)]
        news = [torch.from_numpy(rng.normal(size=(N,) + shape[2:])
                                 .astype(np.float32)) for _ in range(2)]
        want = [jax.lax.dynamic_update_slice(
            jnp.asarray(c.float().numpy(), dtype),
            jnp.asarray(n.numpy(), dtype)[:, None], (0, pos, 0, 0))
            for c, n in zip(caches, news)]
        got = cache_update.cache_slots_update(caches, news, pos)
        assert got is caches
        for c, w in zip(caches, want):
            np.testing.assert_array_equal(c.float().numpy(),
                                          np.asarray(w.astype(jnp.float32)))


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
    """The wrappers take their CUDA route on CPU tensors, 132 SMs, and
    launch into a recorder."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", rec)
    monkeypatch.setattr(_build, "multiprocessors", lambda device: 132)
    return rec


def _ffn_inputs(N=3000, D=128, Fh=256, dtype=torch.bfloat16):
    return (torch.zeros(N, D, dtype=dtype), torch.zeros(Fh, D, dtype=dtype),
            torch.zeros(Fh), torch.zeros(D, Fh, dtype=dtype), torch.zeros(D))


def test_f2_reads_f1s_copy(card_route):
    x, w1, b1, w2, b2 = _ffn_inputs()
    x.requires_grad_()
    y = tffn.fused_ffn(x, w1, b1, w2, b2, "relu")
    y.backward(torch.ones_like(y))
    assert card_route.names() == ["vlpet_ffn_w_tiles", "vlpet_ffn_fwd",
                                  "vlpet_ffn_bwd"]
    bwd = card_route.calls[2][1]
    assert bwd[7] == card_route.calls[1][1][6]  # F1's re-laid copy
    assert bwd[6] is not None  # dy re-laid


@pytest.mark.parametrize("N", [37, 3000, 16800])
def test_f2_launch_carries_splits_and_partials(card_route, N):
    x, w1, b1, w2, _ = _ffn_inputs(N)
    before = tffn.fused_ffn_bwd.launches
    tffn.fused_ffn_bwd(x, x, w1, b1, w2, "gelu", RATE,
                       torch.from_numpy(SEED))
    assert tffn.fused_ffn_bwd.launches == before + 1
    args = card_route.calls[-1][1]
    S = tffn.f1_splits(N, 128, 256, 132)[0]
    assert args[13:18] == (N, 128, 256, -(-N // 64), S)
    assert (args[8] is None) == (S == 1)  # dx's partials when it splits
    assert args[10] is not None and args[5] is not None  # bias sums, seed
    assert (S > 1) == (N < 16800)


def test_f2_fp32_takes_the_fma_kernel(card_route):
    x, w1, b1, w2, _ = _ffn_inputs(37, dtype=torch.float32)
    tffn.fused_ffn_bwd(x, x, w1, b1, w2, "gelu")
    assert card_route.names() == ["vlpet_ffn_bwd"]
    args = card_route.calls[0][1]
    assert args[6:9] == (None, None, None)  # no re-lays, no splits
    assert args[16:20] == (-(-37 // 16), 1, 0, 0)  # G, S, gelu, fp32


def test_f2_tiles_are_kept_until_a_weight_changes(card_route):
    x, w1, b1, w2, _ = _ffn_inputs(37)
    for _ in range(2):
        tffn.fused_ffn_bwd(x, x, w1, b1, w2)
    assert card_route.names().count("vlpet_ffn_w_tiles") == 1
    with torch.no_grad():
        w1.add_(1.0)  # an in-place write moves the version counter
    tffn.fused_ffn_bwd(x, x, w1, b1, w2)
    assert card_route.names().count("vlpet_ffn_w_tiles") == 2
    tffn.fused_ffn_bwd(x, x, w1, b1, w2.clone())  # another W2 beside W1
    assert card_route.names().count("vlpet_ffn_w_tiles") == 3
    assert card_route.names().count("vlpet_ffn_bwd") == 4


def test_f2_bf16_refuses_a_misaligned_dy_on_the_card(card_route):
    x, w1, b1, w2, _ = _ffn_inputs(37)
    dy = torch.zeros(37 * 128 + 1, dtype=torch.bfloat16)[1:].view(37, 128)
    assert dy.data_ptr() % 16
    with pytest.raises(ValueError, match="x and dy must be 16-byte"):
        tffn.fused_ffn_bwd(x, dy, w1, b1, w2)
    assert card_route.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_slot_makes_one_u1_launch_per_layer_step(card_route, dtype):
    L, B, inner, pos = 6, 4, 16, 3
    cache = {"k": torch.zeros(L, B, inner, dtype=dtype),
             "v": torch.zeros(L, B, inner, dtype=dtype)}
    k, v = torch.ones(B, 1, inner), torch.ones(B, 1, inner)  # cast in U1
    before = cache_update.cache_slot_update.launches
    write_slot(cache, k, v, pos)
    assert cache_update.cache_slot_update.launches == before + 1
    assert card_route.names() == ["vlpet_cache_update"]
    args = card_route.calls[0][1]
    assert args[0] == cache["k"].data_ptr()
    assert args[2] == cache["v"].data_ptr()
    assert args[4:] == (1, L, B * inner, cache["k"].element_size(), pos)


def test_write_slot_on_cpu_writes_both_slots():
    L, B, inner, pos = 6, 4, 16, 2
    cache = {"k": torch.randn(L, B, inner), "v": torch.randn(L, B, inner)}
    before = {n: c.clone() for n, c in cache.items()}
    k, v = torch.randn(B, 1, inner), torch.randn(B, 1, inner)
    write_slot(cache, k, v, pos)
    for name, new in (("k", k), ("v", v)):
        assert torch.equal(cache[name][pos], new.reshape(B, inner))
        others = [t for t in range(L) if t != pos]
        assert torch.equal(cache[name][others], before[name][others])


def test_cache_slots_update_refuses_what_the_kernel_cannot_take(card_route):
    c = torch.zeros(1, 6, 4, 8)
    n = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="differ in shape or dtype"):
        cache_update.cache_slots_update([c, c.to(torch.bfloat16)], [n, n], 1)
    with pytest.raises(ValueError, match="one or two"):
        cache_update.cache_slots_update([c, c, c], [n, n, n], 1)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(1, 6, 4, 16)[..., :8]
        cache_update.cache_slots_update([c, strided], [n, n], 1)
    assert card_route.calls == []
