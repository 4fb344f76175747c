"""F3's and F4's launch rule, the bf16 gated FFN twins, and the wrappers'
routes, on CPU.

On the card the bf16 F3 (csrc/ffn.cu gated_fwd_tc) and F4
(gated_bwd_tc) split the hidden over blocks where the row blocks do not
fill the card; here ``ops.ffn.gated_splits`` is held as a plain function
of the shapes and the SM count: every 64-wide hidden chunk in exactly one
split, no split empty, the grid one wave when it splits, one split at the
encoder's training rows (N 16800, no partials).

The bf16 twins (``fused_gated_ffn`` and ``fused_gated_ffn_bwd`` on CPU
tensors) are held to vlpet_tpu/ops/ffn.py's fused_gated_ffn and its
jax.vjp with the Pallas kernels in interpret mode over 16-row tiles
(several programs, so the hash mask follows the global index n F + f that
a kernel splitting F over blocks must reproduce), at ragged row counts,
with and without dropout: 2e-2 * (1 + max|jax|) (the twins round the
up-products to bf16 before the gating, the kernels after it); the dropout
mask itself bit for bit through picking weights (y is the dropped gated
hidden, dx its dropped cotangent).

The wrappers' routes, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA): both
re-lays happen once while the weights are unchanged and again after an
in-place write, F3 without a gradient to carry launches directly (no
autograd Function), and every launch takes gated_splits' split count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import ffn as tffn

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([86420], np.int32)
SMS = (132, 114, 8)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", [1, 37, 250, 1500, 1501, 2999, 3000, 16800,
                               28000])
def test_gated_splits_cover_every_chunk_once(N, sms):
    for D, Fh in ((768, 2048), (128, 256), (1024, 2816), (896, 2048)):
        S, per = tffn.gated_splits(N, D, Fh, sms)
        assert (S, per) == tffn.gated_splits(N, D, Fh, sms)
        chunks = Fh // 64
        spans = [range(s * per, min((s + 1) * per, chunks))
                 for s in range(S)]
        assert all(len(r) for r in spans), "an empty split"
        assert sorted(c for r in spans for c in r) == list(range(chunks))
        blocks = -(-N // 64) * -(-(D // 128) // 6)
        if S > 1:
            assert blocks * S <= sms, "a split grid past one wave"


@pytest.mark.parametrize("N, S", [(16800, 1), (3000, 2), (1500, 5)])
def test_gated_splits_at_the_t5_rows(N, S):
    """t5-v1.1-base on 132 SMs: the encoder's training rows take one split,
    the decoder's (F4) two, the beam rows (F3) five."""
    assert tffn.gated_splits(N, 768, 2048, 132)[0] == S


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, its values as a bf16 jax array)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _jax_gated(monkeypatch, x, w0, w1, wo, rate, dy):
    """vlpet_tpu's fused_gated_ffn and its vjp for dy, in interpret mode
    over 16-row tiles; weights in torch's Linear layout (out, in)."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    y, vjp = jax.vjp(lambda a: jffn.fused_gated_ffn(
        a, w0.T, w1.T, wo.T, "gelu_new", rate, jnp.asarray(SEED)), x)
    (dx,) = vjp(dy)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _close(got, want):
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= TOL * (1.0 + np.abs(want).max()), err.max()


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("N", [37, 250])
def test_gated_bf16_twins_match_pallas_interpret(monkeypatch, N, rate):
    D, Fh = 128, 256
    rng = np.random.default_rng(N)
    (tx, jx), (tdy, jdy), (tw0, jw0), (tw1, jw1), (two, jwo) = map(_bf16, (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(D, Fh)).astype(np.float32) * 0.1))
    want_y, want_dx = _jax_gated(monkeypatch, jx, jw0, jw1, jwo, rate, jdy)
    seed = torch.from_numpy(SEED)
    y = tffn.fused_gated_ffn(tx, tw0, tw1, two, "gelu_new", rate, seed)
    assert y.dtype == torch.bfloat16 and y.shape == (N, D)
    _close(y, want_y)
    dx = tffn.fused_gated_ffn_bwd(tx, tdy, tw0, tw1, two, "gelu_new", rate,
                                  seed)
    assert dx.dtype == torch.bfloat16 and dx.shape == (N, D)
    _close(dx, want_dx)


@pytest.mark.parametrize("N", [37, 250])
def test_gated_bf16_dropout_mask_matches_pallas_bit_for_bit(monkeypatch, N):
    """W0 = W1 spread x = 3 onto hidden columns off .. off + D (h0 = h1 = 3
    there, 0 elsewhere) and Wo picks them back, so y is the dropped gated
    hidden; dy = 1 makes dx the dropped cotangent of the same columns:
    both nonzero exactly where the mask keeps."""
    D, Fh, off = 128, 256, 128
    pick = np.zeros((D, Fh), np.float32)
    pick[np.arange(D), np.arange(D) + off] = 1.0
    (tx, jx), (tdy, jdy), (tsp, jsp), (tpk, jpk) = map(_bf16, (
        np.full((N, D), 3.0, np.float32), np.ones((N, D), np.float32),
        np.ascontiguousarray(pick.T), pick))
    want_y, want_dx = _jax_gated(monkeypatch, jx, jsp, jsp, jpk, RATE, jdy)
    seed = torch.from_numpy(SEED)
    y = tffn.fused_gated_ffn(tx, tsp, tsp, tpk, "gelu_new", RATE, seed)
    dx = tffn.fused_gated_ffn_bwd(tx, tdy, tsp, tsp, tpk, "gelu_new", RATE,
                                  seed)
    np.testing.assert_array_equal(y.float().numpy() != 0, want_y != 0)
    np.testing.assert_array_equal(dx.float().numpy() != 0, want_dx != 0)
    assert 0.8 < (want_y != 0).mean() < 0.95


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


def _gated_inputs(N=3000, D=128, Fh=256):
    bf = torch.bfloat16
    return (torch.zeros(N, D, dtype=bf), torch.zeros(Fh, D, dtype=bf),
            torch.zeros(Fh, D, dtype=bf), torch.zeros(D, Fh, dtype=bf))


def test_gated_ffn_without_a_gradient_launches_f3_directly(card_route):
    x, w0, w1, wo = _gated_inputs()
    before = tffn.fused_gated_ffn.launches
    with torch.no_grad():
        y = tffn.fused_gated_ffn(x, w0, w1, wo)
    y2 = tffn.fused_gated_ffn(x, w0, w1, wo)  # autograd on, no leaf
    assert y.grad_fn is None and y2.grad_fn is None
    assert card_route.names() == ["vlpet_gated_w_tiles",
                                  "vlpet_gated_ffn_fwd",
                                  "vlpet_gated_ffn_fwd"]
    assert tffn.fused_gated_ffn.launches == before + 2
    # the launch takes gated_splits' count, with partials when it splits
    args = card_route.calls[1][1]
    S = tffn.gated_splits(3000, 128, 256, 132)[0]
    assert S == 2 and args[11] == S and args[6] is not None
    # the re-laid weights are what the launch reads
    assert args[5] == card_route.calls[0][1][3]


def test_gated_ffn_with_a_gradient_goes_through_the_function(card_route):
    x, w0, w1, wo = _gated_inputs()
    x.requires_grad_()
    y = tffn.fused_gated_ffn(x, w0, w1, wo, "gelu_new")
    assert "FusedGatedFFN" in type(y.grad_fn).__name__
    y.backward(torch.ones_like(y))
    names = card_route.names()
    assert names == ["vlpet_gated_w_tiles", "vlpet_gated_ffn_fwd",
                     "vlpet_gated_bwd_tiles", "vlpet_gated_ffn_bwd"]
    fwd, bwd = card_route.calls[1][1], card_route.calls[3][1]
    assert bwd[7] == fwd[5]  # F4 reads F3's re-laid copy ...
    assert bwd[8] == card_route.calls[2][1][3]  # ... and its own
    assert bwd[6] is not None and bwd[14] == 2  # dy re-laid; two splits


def test_gated_tiles_are_kept_until_a_weight_changes(card_route):
    x, w0, w1, wo = _gated_inputs(N=37)
    for _ in range(2):
        tffn.fused_gated_ffn_bwd(x, x, w0, w1, wo)
    assert card_route.names().count("vlpet_gated_w_tiles") == 1
    assert card_route.names().count("vlpet_gated_bwd_tiles") == 1
    with torch.no_grad():
        wo.add_(1.0)  # an in-place write moves the version counter
    tffn.fused_gated_ffn_bwd(x, x, w0, w1, wo)
    assert card_route.names().count("vlpet_gated_w_tiles") == 2
    assert card_route.names().count("vlpet_gated_bwd_tiles") == 2
    tffn.fused_gated_ffn(x, w0, w1.clone(), wo)  # another W1 beside W0
    assert card_route.names().count("vlpet_gated_w_tiles") == 3
    # the decode-like rows split: partials beside the split count
    args = card_route.calls[-1][1]
    assert args[11] == tffn.gated_splits(37, 128, 256, 132)[0] > 1
    assert args[6] is not None


def test_gated_bf16_refuses_a_misaligned_dy_on_the_card(card_route):
    x, w0, w1, wo = _gated_inputs(N=37)
    dy = torch.zeros(37 * 128 + 1, dtype=torch.bfloat16)[1:].view(37, 128)
    assert dy.data_ptr() % 16
    with pytest.raises(ValueError, match="x and dy must be 16-byte"):
        tffn.fused_gated_ffn_bwd(x, dy, w0, w1, wo)
