"""The T5 training slice's ops of the port against the JAX package, on CPU.

Every port wrapper takes its plain PyTorch twin here (the tensors lie on
the CPU); the JAX side runs its Pallas kernels in interpret mode
(``interpret=True``, or ``_INTERPRET`` monkeypatched as
tests/test_torch_train_ops.py does). Inputs come from seeded numpy and reach
both frameworks as the same arrays. Covered, all at dropout rate 0.1 with
one fixed seed: A1 with the per-head bias, the causal triangle and
probability dropout (``_pallas_attention``), A6 with the bias and the
dropout (``_pallas_attention_bwd``), over a batch the TPU kernels split
into several programs, so the mask must follow the global index; F1/F2
relu with hidden dropout and F3/F4 gated-gelu with hidden dropout, through
jax.vjp of fused_ffn and fused_gated_ffn over several row tiles; the
attention mask helper bit for bit against the JAX keep_mask/head_seed; and
the cases that still raise (a per-head mask, a rate without a seed,
bias_grad without a bias) beside the ones that now compute (a bias with a
gradient, a biased and dropping site on the long backward). fp32 tolerance
1e-5 * (1 + max|jax|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.ops import hashdrop as thd

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5
RATE = 0.1
SEED = np.array([24680135], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    want = np.asarray(want)
    tol = TOL * (1.0 + np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("seed", [0, 24680135, 2 ** 31 - 2])
def test_attention_keep_mask_bit_equal(seed):
    """(B, H, L, S) probability mask: head h hashes (b * L + i) * S + j
    under head_seed(seed, h), as the JAX kernels and reference do."""
    from vlpet_tpu.ops.attention import head_seed
    from vlpet_tpu.ops.hashdrop import keep_mask

    B, L, S, H = 5, 7, 9, 12
    want = np.stack([np.asarray(keep_mask((B, L, S), jnp.uint32(0),
                                          head_seed(jnp.int32(seed), h), RATE))
                     for h in range(H)], axis=1)
    got = thd.attention_keep_mask(B, L, S, H,
                                  torch.tensor([seed], dtype=torch.int32),
                                  RATE)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.85 < want.mean() < 0.95


# L, S, causal, bias: the T5 training sites at small size (encoder self
# with the relative bias, decoder self with bias and the causal triangle,
# cross-attention over the encoder states)
SITES = {"enc_self": (7, 7, False, True), "dec_self": (5, 5, True, True),
         "cross": (5, 9, False, False)}


@pytest.mark.parametrize("site", list(SITES))
def test_attention_dropout_fwd_bwd_match_pallas_interpret(site):
    """B 24: the forward runs 2 programs of 12 rows, the dropping backward
    3 of 8, so a mask keyed on a block-local index would differ."""
    from vlpet_tpu.ops.attention import (_pallas_attention,
                                         _pallas_attention_bwd)

    L, S, causal, has_bias = SITES[site]
    rng = np.random.default_rng(L * 10 + S)
    B, H, Dh = 24, 4, 8
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.3
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    bias = (rng.normal(size=(1, H, L, S)).astype(np.float32)
            if has_bias else None)
    jargs = list(map(jnp.asarray, (q, k, v, mask)))
    jbias = None if bias is None else jnp.asarray(bias)
    jseed = jnp.asarray(SEED)
    want = _pallas_attention(*jargs, H, causal, jbias, RATE, jseed,
                             interpret=True)
    wgrads = _pallas_attention_bwd(*jargs, jnp.asarray(do), H, causal, jbias,
                                   RATE, jseed, interpret=True)
    tbias = None if bias is None else _t(bias)
    args = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tatt.fused_attention(*args, _t(mask), H, causal, tbias, RATE,
                               _t(SEED))
    _close(got, want)
    assert not np.allclose(np.asarray(want), np.asarray(_pallas_attention(
        *jargs, H, causal, jbias, interpret=True)))  # dropout dropped
    ggrads = torch.autograd.grad(got, args, _t(do))
    bwd = tatt.fused_attention_bwd(_t(q), _t(k), _t(v), _t(mask), _t(do), H,
                                   causal, tbias, RATE, _t(SEED))
    for name, g, b, w in zip(("dq", "dk", "dv"), ggrads, bwd, wgrads):
        _close(g, w, msg=name)
        _close(b, w, msg=name + " (bwd wrapper)")


def test_attention_raises_for_unported_training():
    """What stays unported raises: a per-head mask, a rate without a seed,
    bias_grad without a bias. A bias that requires a gradient, and a biased
    and dropping site on the long route (L = S = 128, Dh 64: past A6's
    shared memory), now train: autograd of fused_attention gives dq, dk, dv
    and dbias, and the long backward's plain twin gives the same."""
    q = torch.zeros(2, 3, 8, requires_grad=True)
    kv = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="per-head"):
        tatt.fused_attention(q, kv, kv, torch.zeros(2, 2, 1, 4), 2)
    with pytest.raises(ValueError, match="seed"):
        tatt.fused_attention(q, kv, kv, torch.zeros(2, 1, 1, 4), 2, rate=RATE)
    with pytest.raises(ValueError, match="bias_grad"):
        tatt.fused_attention_bwd(q.detach(), kv, kv, torch.zeros(2, 1, 1, 4),
                                 q.detach(), 2, bias_grad=True)
    L = 128
    assert tatt.backward_route(L, L, 64, torch.float32) == "long"
    rng = np.random.default_rng(11)
    ql, kl, vl, dol = (_t(rng.normal(size=(1, L, 64)).astype(np.float32)
                          * s) for s in (0.125, 1.0, 1.0, 1.0))
    bias = _t(rng.normal(size=(1, 1, L, L)).astype(np.float32))
    ml = torch.zeros(1, 1, 1, L)
    seed = _t(SEED)
    leaves = [t.clone().requires_grad_() for t in (ql, kl, vl, bias)]
    out = tatt.fused_attention(*leaves[:3], ml, 1, False, leaves[3], RATE,
                               seed)
    grads = torch.autograd.grad(out, leaves, dol)
    fwd, lse = tatt.fused_attention_fwd_lse(ql, kl, vl, ml, 1, False, bias,
                                            RATE, seed)
    _close(fwd, out.detach().numpy(), "out")
    long = tatt.fused_attention_bwd_long(ql, kl, vl, ml, fwd, lse, dol, 1,
                                         False, bias, RATE, seed, True)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), long, grads):
        _close(g, w.numpy(), name)
    assert float(grads[3].abs().max()) > 0


def _ffn_inputs(rng, N, D, F, n_w):
    x, dy = (rng.normal(size=(N, D)).astype(np.float32) for _ in range(2))
    ws = [rng.normal(size=(D, F)).astype(np.float32) * 0.2
          for _ in range(n_w - 1)]
    ws.append(rng.normal(size=(F, D)).astype(np.float32) * 0.2)
    return x, dy, ws


def test_relu_ffn_dropout_fwd_bwd_match_jax_interpret(monkeypatch):
    """F1/F2 relu at rate 0.1 with the biases, N 37 over row tiles of 16
    (3 programs, the last padded): y, dx, db1, db2."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    rng = np.random.default_rng(11)
    N, D, F = 37, 32, 64
    x, dy, (w1, w2) = _ffn_inputs(rng, N, D, F, 2)
    b1 = rng.normal(size=(F,)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.2
    seed = jnp.asarray(SEED)
    want, vjp = jax.vjp(lambda a, c, e: jffn.fused_ffn(
        a, jnp.asarray(w1), c, jnp.asarray(w2), e, "relu", RATE, seed),
        *map(jnp.asarray, (x, b1, b2)))
    wgrads = vjp(jnp.asarray(dy))
    tw1, tw2 = _t(w1.T), _t(w2.T)  # torch Linear layout (out, in)
    args = [_t(a).requires_grad_() for a in (x, b1, b2)]
    y = tffn.fused_ffn(args[0], tw1, args[1], tw2, args[2], "relu", RATE,
                       _t(SEED))
    _close(y, want)
    for name, g, w in zip(("dx", "db1", "db2"),
                          torch.autograd.grad(y, args, _t(dy)), wgrads):
        _close(g, w, msg=name)
    for name, g, w in zip(("dx", "db1", "db2"),
                          tffn.fused_ffn_bwd(_t(x), _t(dy), tw1, _t(b1), tw2,
                                             "relu", RATE, _t(SEED)), wgrads):
        _close(g, w, msg=name + " (bwd wrapper)")


def test_gated_ffn_dropout_fwd_bwd_match_jax_interpret(monkeypatch):
    """F3/F4 gated-gelu at rate 0.1, N 37 over row tiles of 16: y and
    dx."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    rng = np.random.default_rng(12)
    N, D, F = 37, 32, 64
    x, dy, (w0, w1, wo) = _ffn_inputs(rng, N, D, F, 3)
    seed = jnp.asarray(SEED)
    want, vjp = jax.vjp(lambda a: jffn.fused_gated_ffn(
        a, jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(wo), "gelu_new",
        RATE, seed), jnp.asarray(x))
    (wdx,) = vjp(jnp.asarray(dy))
    tws = [_t(w.T) for w in (w0, w1, wo)]
    xt = _t(x).requires_grad_()
    y = tffn.fused_gated_ffn(xt, *tws, "gelu_new", RATE, _t(SEED))
    _close(y, want)
    assert not np.allclose(np.asarray(want), np.asarray(jffn.fused_gated_ffn(
        *map(jnp.asarray, (x, w0, w1, wo)), "gelu_new")))
    (dx,) = torch.autograd.grad(y, xt, _t(dy))
    _close(dx, wdx, msg="dx")
    _close(tffn.fused_gated_ffn_bwd(_t(x), _t(dy), *tws, "gelu_new", RATE,
                                    _t(SEED)), wdx, msg="dx (bwd wrapper)")
