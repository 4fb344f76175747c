"""F1's and C1's launch rules, the bf16 F1 twin, and the wrappers' routes,
on CPU.

On the card the bf16 F1 (csrc/ffn.cu ffn_fwd_tc) splits the hidden over
blocks at decode rows and C1 (csrc/fused_ce.cu ce_fwd_tc) splits the
vocabulary; here the split rules are held as plain functions of the shapes
and the SM count:

* ``ops.ffn.f1_splits``: every 64-wide hidden chunk in exactly one split,
  no split empty, the grid one wave when it splits, one split at the
  encoder and training rows (no partials then);
* ``ops.fused_ce.vocab_splits`` at C1's 64 rows and 32-column tiles:
  every vocab tile in exactly one split, none empty.

The bf16 F1 twin (``fused_ffn`` on CPU tensors) is held to
vlpet_tpu/ops/ffn.py's Pallas kernel in interpret mode over 16-row tiles
(several programs, so the hash mask follows the global index n F + f that
a kernel splitting F over blocks must reproduce), at ragged decode-like
row counts, with and without dropout: 2e-2 * (1 + max|jax|) (the twin
rounds the fc1 output to bf16 before the activation, the kernels after
it); the dropout mask itself bit for bit (picking weights make y the
dropped hidden).

The wrappers' routes, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA):
``fused_ffn`` without a gradient to carry launches F1 directly, not
through the autograd Function, and re-lays its weights once while they are
unchanged; ``fused_linear_ce`` re-lays the head once a step and hands it to
C2; ``fused_linear_ce_bwd`` still makes its own when given none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.ops import fused_ce

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([97531], np.int32)
SMS = (132, 114, 8)


def _spans(splits: int, per: int, items: int):
    return [range(s * per, min((s + 1) * per, items)) for s in range(splits)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", [1, 37, 250, 1500, 2500, 2501, 3000, 5000,
                               16800, 28000, 30200])
def test_f1_splits_cover_every_chunk_once(N, sms):
    for D, Fh in ((768, 3072), (128, 256), (1024, 4096), (896, 3072)):
        S, per = tffn.f1_splits(N, D, Fh, sms)
        assert (S, per) == tffn.f1_splits(N, D, Fh, sms)
        chunks = Fh // 64
        spans = _spans(S, per, chunks)
        assert all(len(r) for r in spans), "an empty split"
        assert sorted(c for r in spans for c in r) == list(range(chunks))
        blocks = -(-N // 64) * -(-(D // 128) // 6)
        if S > 1:
            assert blocks * S <= sms, "a split grid past one wave"


@pytest.mark.parametrize("N", [16800, 28000, 30200])
def test_f1_takes_one_split_at_the_encoder_rows(N):
    assert tffn.f1_splits(N, 768, 3072, 132) == (1, 48)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N, V", [(1, 1000), (61, 1000), (2999, 32100),
                                  (3000, 32100), (5000, 50265),
                                  (28000, 50265)])
def test_c1_vocab_splits_cover_every_tile_once(N, V, sms):
    S = fused_ce.vocab_splits(64, N, V, sms, 32)
    assert S == fused_ce.vocab_splits(64, N, V, sms, 32)
    tiles = -(-V // 32)
    per = -(-tiles // S)
    spans = _spans(S, per, tiles)
    assert all(len(r) for r in spans), "an empty split"
    assert sorted(t for r in spans for t in r) == list(range(tiles))


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, its values as a bf16 jax array)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _pallas_ffn(monkeypatch, x, w1, b1, w2, b2, act, rate):
    """vlpet_tpu's fused_ffn in interpret mode over 16-row tiles; weights in
    torch's Linear layout (out, in)."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    return np.asarray(jffn.fused_ffn(
        x, w1.T, jnp.asarray(b1), w2.T, jnp.asarray(b2), act, rate,
        jnp.asarray(SEED)).astype(jnp.float32))


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("N, act", [(37, "gelu"), (250, "relu")])
def test_f1_bf16_twin_matches_pallas_interpret(monkeypatch, N, act, rate):
    D, Fh = 128, 256
    rng = np.random.default_rng(N)
    (tx, jx), (tw1, jw1), (tw2, jw2) = map(_bf16, (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(D, Fh)).astype(np.float32) * 0.1))
    b1 = (rng.normal(size=(Fh,)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    want = _pallas_ffn(monkeypatch, jx, jw1, b1, jw2, b2, act, rate)
    got = tffn.fused_ffn(tx, tw1, torch.from_numpy(b1), tw2,
                         torch.from_numpy(b2), act, rate,
                         torch.from_numpy(SEED))
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= TOL * (1.0 + np.abs(want).max()), err.max()


@pytest.mark.parametrize("N", [37, 250])
def test_f1_bf16_dropout_mask_matches_pallas_bit_for_bit(monkeypatch, N):
    """W1 = 0 and b1 = 1 make the hidden 1 before the dropout; W2 picks
    hidden columns off .. off + D, so y is the dropped hidden itself."""
    D, Fh, off = 128, 256, 128
    pick = np.zeros((D, Fh), np.float32)
    pick[np.arange(D), np.arange(D) + off] = 1.0
    (tx, jx), (tw1, jw1), (tw2, jw2) = map(_bf16, (
        np.ones((N, D), np.float32), np.zeros((Fh, D), np.float32), pick))
    b1, b2 = np.ones(Fh, np.float32), np.zeros(D, np.float32)
    want = _pallas_ffn(monkeypatch, jx, jw1, b1, jw2, b2, "relu", RATE)
    got = tffn.fused_ffn(tx, tw1, torch.from_numpy(b1), tw2,
                         torch.from_numpy(b2), "relu", RATE,
                         torch.from_numpy(SEED)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.8 < (got != 0).mean() < 0.95


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


def _ffn_inputs(N=37, D=128, Fh=256):
    bf = torch.bfloat16
    return (torch.zeros(N, D, dtype=bf), torch.zeros(Fh, D, dtype=bf),
            torch.zeros(Fh), torch.zeros(D, Fh, dtype=bf), torch.zeros(D))


def test_fused_ffn_without_a_gradient_launches_f1_directly(card_route):
    x, w1, b1, w2, b2 = _ffn_inputs()
    before = tffn.fused_ffn.launches
    with torch.no_grad():
        y = tffn.fused_ffn(x, w1, b1, w2, b2, "gelu")
    y2 = tffn.fused_ffn(x, w1, b1, w2, b2, "gelu")  # autograd on, no leaf
    assert y.grad_fn is None and y2.grad_fn is None
    assert card_route.names() == ["vlpet_ffn_w_tiles", "vlpet_ffn_fwd",
                                  "vlpet_ffn_fwd"]
    assert tffn.fused_ffn.launches == before + 2
    # the splits of the launch are f1_splits'; no partials with one split
    args = card_route.calls[1][1]
    S = tffn.f1_splits(37, 128, 256, 132)[0]
    assert args[12] == S and (args[7] is None) == (S == 1)


@pytest.mark.parametrize("leaf", ["x", "b1", "b2"])
def test_fused_ffn_with_a_gradient_goes_through_the_function(card_route,
                                                             leaf):
    t = dict(zip(("x", "w1", "b1", "w2", "b2"), _ffn_inputs()))
    t[leaf].requires_grad_()
    y = tffn.fused_ffn(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], "gelu")
    assert "FusedFFN" in type(y.grad_fn).__name__


def test_f1_tiles_are_kept_until_a_weight_changes(card_route):
    x, w1, b1, w2, b2 = _ffn_inputs()
    with torch.no_grad():
        tffn.fused_ffn(x, w1, b1, w2, b2, "relu")
        tffn.fused_ffn(x, w1, b1, w2, b2, "relu")
        assert card_route.names().count("vlpet_ffn_w_tiles") == 1
        w2.add_(1.0)  # an in-place write moves the version counter
        tffn.fused_ffn(x, w1, b1, w2, b2, "relu")
        assert card_route.names().count("vlpet_ffn_w_tiles") == 2
        other = w2.clone()  # another W2 beside the same W1
        tffn.fused_ffn(x, w1, b1, other, b2, "relu")
        assert card_route.names().count("vlpet_ffn_w_tiles") == 3


def _ce_inputs(dtype=torch.bfloat16, N=61, D=768, V=100):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)
                         * D ** -0.5).to(dtype)
    w = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.normal(size=(V,)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, (N,)))
    labels[[0, 30]] = -100
    return x, w, b, labels


def test_fused_linear_ce_hands_its_tiles_to_the_backward(card_route):
    x, w, b, labels = _ce_inputs()
    x.requires_grad_()
    loss, _ = fused_ce.fused_linear_ce(x, w, b, labels)
    loss.sum().backward()
    names = card_route.names()
    assert names == ["vlpet_ce_w_tiles", "vlpet_ce_fwd", "vlpet_ce_bwd"]
    wt = card_route.calls[0][1][2]
    assert card_route.calls[1][1][4] == wt  # C1 reads it ...
    assert card_route.calls[2][1][6] == wt  # ... and so does C2


def test_fused_linear_ce_bwd_makes_its_own_tiles_when_given_none(card_route):
    x, w, b, labels = _ce_inputs()
    lse, dloss = torch.zeros(x.shape[0]), torch.ones(x.shape[0])
    fused_ce.fused_linear_ce_bwd(x, w, b, labels, lse, dloss)
    assert card_route.names() == ["vlpet_ce_w_tiles", "vlpet_ce_bwd"]
    with pytest.raises(ValueError, match="not the re-laid head"):
        fused_ce.fused_linear_ce_bwd(x, w, b, labels, lse, dloss,
                                     torch.empty(10, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_linear_ce_cpu_route_is_the_plain_twins(dtype):
    x, w, b, labels = _ce_inputs(dtype)
    x.requires_grad_()
    loss, lse = fused_ce.fused_linear_ce(x, w, b, labels)
    want_loss, want_lse = fused_ce.fused_linear_ce_reference(x.detach(), w, b,
                                                             labels)
    assert torch.equal(loss, want_loss) and torch.equal(lse, want_lse)
    dloss = torch.linspace(0.5, 1.5, x.shape[0])
    (dx,) = torch.autograd.grad(loss, x, dloss)
    want_dx = fused_ce.fused_linear_ce_bwd_reference(x.detach(), w, b, labels,
                                                     lse, dloss)
    assert torch.equal(dx, want_dx)
    assert torch.equal(fused_ce.fused_linear_ce_bwd(x.detach(), w, b, labels,
                                                    lse, dloss), want_dx)
