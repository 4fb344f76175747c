"""The port's kernel modules (vlpet_tpu_torch.ops) against the JAX package.

On this CPU lane every port wrapper takes its plain PyTorch twin (the
tensors lie on the CPU); the JAX side runs its Pallas kernels in interpret
mode, as tests/test_ops.py and tests/test_topk.py do. Inputs come from
seeded numpy and reach both frameworks as the same arrays. The CUDA kernels
themselves are held against the same plain twins on the card by
chip_smoke.py.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.ops import cache_update as tcu
from vlpet_tpu_torch.ops import decode as tdec
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.ops import fused_ce as tfce
from vlpet_tpu_torch.ops import fused_ln as tln
from vlpet_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)  # several xdist workers share the host

FP32_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("L", [7, 5])
@pytest.mark.parametrize("batched_mask", [True, False])
def test_attention_plain_matches_pallas_interpret(L, batched_mask):
    from vlpet_tpu.ops.attention import _pallas_attention

    rng = np.random.default_rng(L)
    B, S, H, Dh = 4, 11, 4, 16
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    keep = rng.uniform(size=(B if batched_mask else 1, 1, 1, S)) > 0.3
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    want = np.asarray(_pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(mask), H,
                                        interpret=True))
    got = tatt.fused_attention(_t(q), _t(k), _t(v), _t(mask), H).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_bias_plain_matches_pallas_interpret(causal):
    """A1 with the batch-shared per-head T5 bias (1, H, L, S), with and
    without the causal triangle, and the row logsumexp with a bias."""
    from vlpet_tpu.ops.attention import _pallas_attention

    rng = np.random.default_rng(11)
    B, L, S, H, Dh = 3, 6, 9, 4, 8
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    bias = rng.normal(size=(1, H, L, S)).astype(np.float32)
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.3
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    want = np.asarray(_pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), H,
        causal, jnp.asarray(bias), interpret=True))
    got = tatt.fused_attention(_t(q), _t(k), _t(v), _t(mask), H, causal,
                               _t(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    out, lse = tatt.fused_attention_fwd_lse(_t(q), _t(k), _t(v), _t(mask), H,
                                            causal, _t(bias))
    np.testing.assert_allclose(out.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)
    s = tatt._logits(_t(q), _t(k), _t(mask), H, causal, _t(bias))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_attention_bias_gradient():
    """A bias that requires a gradient gets the batch sum of the per-example
    logits' cotangents (the same function with the bias repeated per example
    and summed); q, k and v train through a biased site whose bias is
    frozen, and A6's CPU wrapper gives the same dbias."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_t(rng.normal(size=shape).astype(np.float32))
                   for shape in ((2, 3, 8), (2, 4, 8), (2, 4, 8), (2, 3, 8)))
    mask = torch.zeros(2, 1, 1, 4)
    bias = _t(rng.normal(size=(1, 2, 3, 4)).astype(np.float32))
    b = bias.clone().requires_grad_()
    (dbias,) = torch.autograd.grad(
        tatt.fused_attention(q, k, v, mask, 2, bias=b), b, do)
    per_example = bias.repeat(2, 1, 1, 1).requires_grad_()
    s = tatt._logits(q, k, mask, 2, False) + per_example
    want = torch.autograd.grad(
        tatt._attend(torch.softmax(s, -1), v, 2, q.dtype), per_example, do)[0]
    np.testing.assert_allclose(dbias.numpy(), want.sum(0, keepdim=True).numpy(),
                               rtol=FP32_TOL, atol=FP32_TOL)
    *_, bwd_dbias = tatt.fused_attention_bwd(q, k, v, mask, do, 2,
                                             bias=bias, bias_grad=True)
    np.testing.assert_allclose(bwd_dbias.numpy(), dbias.numpy(),
                               rtol=FP32_TOL, atol=FP32_TOL)
    qg = q.clone().requires_grad_()
    out = tatt.fused_attention(qg, k, v, mask, 2, bias=bias)
    assert out.requires_grad
    with pytest.raises(ValueError, match="bias must be"):
        tatt.fused_attention(q, k, v, mask, 2, bias=torch.zeros(1, 1, 3, 4))


def test_attention_rejects_per_head_mask():
    q = torch.zeros(2, 3, 8)
    kv = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="per-head"):
        tatt.fused_attention(q, kv, kv, torch.zeros(2, 2, 1, 4), 2)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
def test_ffn_plain_matches_pallas_interpret(act, monkeypatch):
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    N, D, F = 37, 32, 64  # ragged N: the JAX kernel pads, the port does not
    x = rng.normal(size=(N, D)).astype(np.float32)
    w1 = rng.normal(size=(D, F)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(F,)).astype(np.float32) * 0.2
    w2 = rng.normal(size=(F, D)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(D,)).astype(np.float32) * 0.2
    want = np.asarray(jffn.fused_ffn(jnp.asarray(x), jnp.asarray(w1),
                                     jnp.asarray(b1), jnp.asarray(w2),
                                     jnp.asarray(b2), act))
    # port weights are in torch Linear layout (out, in)
    got = tffn.fused_ffn(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                         act).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_gated_ffn_plain_matches_pallas_interpret(monkeypatch):
    """F3 (rate 0): gelu_new(x W0) * (x W1) -> Wo, ragged N."""
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    rng = np.random.default_rng(4)
    N, D, F = 37, 32, 64
    x = rng.normal(size=(N, D)).astype(np.float32)
    w0, w1 = (rng.normal(size=(D, F)).astype(np.float32) * 0.2
              for _ in range(2))
    wo = rng.normal(size=(F, D)).astype(np.float32) * 0.2
    want = np.asarray(jffn.fused_gated_ffn(*map(jnp.asarray, (x, w0, w1, wo)),
                                           "gelu_new"))
    got = tffn.fused_gated_ffn(_t(x), _t(w0.T), _t(w1.T), _t(wo.T),
                               "gelu_new").numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_relu_ffn_and_gated_ffn_are_eval_only():
    """Only the weight matrices are eval only (frozen, no dW: a weight that
    requires a gradient raises); x trains through the relu FFN (F2) and the
    gated FFN (F4), as autograd of the plain twins."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(3, 16)).astype(np.float32)).requires_grad_()
    w1, w2 = (_t(rng.normal(size=s).astype(np.float32))
              for s in ((32, 16), (16, 32)))
    dy = _t(rng.normal(size=(3, 16)).astype(np.float32))
    y = tffn.fused_ffn(x, w1, torch.zeros(32), w2, torch.zeros(16), "relu")
    (dx,) = torch.autograd.grad(y, x, dy)
    np.testing.assert_allclose(
        tffn.fused_ffn_bwd(x.detach(), dy, w1, torch.zeros(32), w2,
                           "relu")[0].numpy(), dx.numpy(), rtol=FP32_TOL,
        atol=FP32_TOL)
    y = tffn.fused_gated_ffn(x, w1, w1, w2)
    (dx,) = torch.autograd.grad(y, x, dy)
    np.testing.assert_allclose(
        tffn.fused_gated_ffn_bwd(x.detach(), dy, w1, w1, w2).numpy(),
        dx.numpy(), rtol=FP32_TOL, atol=FP32_TOL)
    for call in (lambda w: tffn.fused_ffn(x, w, torch.zeros(32), w2,
                                          torch.zeros(16), "relu"),
                 lambda w: tffn.fused_gated_ffn(x, w1, w, w2)):
        with pytest.raises(ValueError, match="frozen"):
            call(w1.clone().requires_grad_())


def test_beam_attend_bias_row_plain_matches_pallas_every_pos():
    """D1 with T5's bias row (1, H, 1, L), the same for every beam, at
    every decode position."""
    from vlpet_tpu.ops.decode import (_beam_self_attend_pallas,
                                      beam_decode_attend, beam_sel_big)

    rng = np.random.default_rng(12)
    B, K, L, H, Dh = 8, 3, 6, 4, 16
    J = K
    q = rng.normal(size=(B * K, 1, H, Dh)).astype(np.float32) * Dh ** -0.5
    kc = rng.normal(size=(L, B * J, H * Dh)).astype(np.float32)
    vc = rng.normal(size=(L, B * J, H * Dh)).astype(np.float32)
    anc = rng.integers(0, J, size=(B, K, L)).astype(np.int32)
    row = rng.normal(size=(1, H, 1, L)).astype(np.float32)
    jq, jk, jv, janc, jrow = map(jnp.asarray, (q, kc, vc, anc, row))
    bias_big = jnp.repeat(jrow.reshape(H, L), 8 * J, axis=1)
    for pos in range(L):
        sel = beam_sel_big(janc, pos, J, L, 8)
        want_kernel = np.asarray(_beam_self_attend_pallas(
            jq.reshape(B * K, H * Dh), jk, jv, sel, bias_big, H, K, J,
            interpret=True)).reshape(B * K, 1, H * Dh)
        want_einsum = np.asarray(beam_decode_attend(
            jq, jk, jv, janc, bias_row=jrow, decode_pos=pos))
        got = tdec.beam_decode_attend(_t(q), _t(kc), _t(vc), _t(anc).long(),
                                      pos, _t(row)).numpy()
        np.testing.assert_allclose(got, want_kernel, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"pos {pos}")
        np.testing.assert_allclose(got, want_einsum, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"pos {pos}")


def test_beam_attend_plain_matches_pallas_and_einsum_every_pos():
    from vlpet_tpu.ops.decode import (_beam_self_attend_pallas,
                                      beam_decode_attend, beam_sel_big)

    rng = np.random.default_rng(5)
    B, K, L, H, Dh = 8, 3, 6, 4, 16
    J = K
    q = rng.normal(size=(B * K, 1, H, Dh)).astype(np.float32) * Dh ** -0.5
    kc = rng.normal(size=(L, B * J, H * Dh)).astype(np.float32)
    vc = rng.normal(size=(L, B * J, H * Dh)).astype(np.float32)
    anc = rng.integers(0, J, size=(B, K, L)).astype(np.int32)
    jq, jk, jv, janc = map(jnp.asarray, (q, kc, vc, anc))
    bias = jnp.zeros((H, L * 8 * J), jnp.float32)
    for pos in range(L):
        sel = beam_sel_big(janc, pos, J, L, 8)
        want_kernel = np.asarray(_beam_self_attend_pallas(
            jq.reshape(B * K, H * Dh), jk, jv, sel, bias, H, K, J,
            interpret=True)).reshape(B * K, 1, H * Dh)
        want_einsum = np.asarray(beam_decode_attend(jq, jk, jv, janc,
                                                    decode_pos=pos))
        got = tdec.beam_decode_attend(_t(q), _t(kc), _t(vc),
                                      _t(anc).long(), pos).numpy()
        np.testing.assert_allclose(got, want_kernel, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"pos {pos}")
        np.testing.assert_allclose(got, want_einsum, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"pos {pos}")


def test_decode_attend_and_cross_attend_match_jax():
    from vlpet_tpu.ops.decode import beam_cross_attend, decode_attend

    rng = np.random.default_rng(6)
    B, K, L, S, H, Dh = 3, 2, 5, 7, 2, 8
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    kc = rng.normal(size=(L, B, H * Dh)).astype(np.float32)
    vc = rng.normal(size=(L, B, H * Dh)).astype(np.float32)
    mask = np.where(np.arange(L) <= 2, 0.0, -1e9).astype(np.float32)[None, None, None]
    want = np.asarray(decode_attend(*map(jnp.asarray, (q, kc, vc, mask))))
    got = tdec.decode_attend(_t(q), _t(kc), _t(vc), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    # T5 greedy: the bias row plus the causal mask, (1, H, 1, L)
    row = (rng.normal(size=(1, H, 1, L)) + mask).astype(np.float32)
    want = np.asarray(decode_attend(*map(jnp.asarray, (q, kc, vc)),
                                    bias_row=jnp.asarray(row)))
    got = tdec.decode_attend(_t(q), _t(kc), _t(vc), bias_row=_t(row)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)

    qb = rng.normal(size=(B * K, 1, H, Dh)).astype(np.float32)
    ke = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    ve = rng.normal(size=(B, S, H * Dh)).astype(np.float32)
    cm = np.where(rng.uniform(size=(B, 1, 1, S)) > 0.3, 0.0, -1e9).astype(np.float32)
    cm[..., 0] = 0.0
    want = np.asarray(beam_cross_attend(*map(jnp.asarray, (qb, ke, ve, cm))))
    got = tdec.beam_cross_attend(_t(qb), _t(ke), _t(ve), _t(cm)).numpy()
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def _tied_logits(rng, R, V):
    """Quantized logits (every top value tied many ways) plus copies of
    each row's max, so the tie order decides the indices."""
    x = rng.integers(-200, 200, size=(R, V)).astype(np.float32) / 10.0
    for r in range(R):
        x[r, rng.choice(V, 5, replace=False)] = x[r].max()
    return x


@pytest.mark.parametrize("k", [1, 2, 10, 16])
def test_topk_plain_matches_hier_and_exact_interpret(k):
    from vlpet_tpu.ops.topk import topk_lse_exact, topk_lse_hier

    rng = np.random.default_rng(k)
    R, V = 16, 1000
    for x in (_tied_logits(rng, R, V),
              rng.normal(size=(R, V)).astype(np.float32)):
        vals, toks, lse = ttopk.topk_lse(_t(x), k)
        assert toks.dtype == torch.int32
        for fn in (topk_lse_hier, topk_lse_exact):
            wv, wt, wl = map(np.asarray, fn(jnp.asarray(x), k, interpret=True))
            np.testing.assert_array_equal(toks.numpy(), wt)
            np.testing.assert_array_equal(vals.numpy(), wv)
            np.testing.assert_allclose(lse.numpy(), wl, rtol=FP32_TOL,
                                       atol=FP32_TOL)


def test_stable_topk_matches_lax_top_k_on_ties():
    import jax

    rng = np.random.default_rng(9)
    x = np.full((4, 50), -1e7, np.float32)
    x[:, ::7] = rng.integers(0, 3, size=(4, 8)).astype(np.float32)
    wv, wt = jax.lax.top_k(jnp.asarray(x), 10)
    gv, gt = ttopk.stable_topk(_t(x), 10)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("case", ["tied", "neg_inf", "all_neg_inf",
                                  "batched", "nan"])
def test_stable_topk_candidates_match_a_full_stable_sort(case):
    """The CPU path sorts only each row's candidates (values at or above
    its k-th largest): the same values and indices as lax.top_k, and as a
    full stable sort where a row holds NaN."""
    import jax

    rng = np.random.default_rng(3)
    x = _tied_logits(rng, 12, 300)
    if case == "neg_inf":
        x[x < 15.0] = -np.inf
    elif case == "all_neg_inf":
        x[:] = -np.inf
    elif case == "batched":
        x = x.reshape(3, 4, 300)
    elif case == "nan":
        x[2, 7] = np.nan
    gv, gt = ttopk.stable_topk(_t(x), 10)
    if case == "nan":
        wv, wt = torch.sort(_t(x), dim=-1, descending=True, stable=True)
        wv, wt = wv[..., :10].numpy(), wt[..., :10].numpy()
    else:
        wv, wt = map(np.asarray, jax.lax.top_k(jnp.asarray(x), 10))
    np.testing.assert_array_equal(gt.numpy(), wt)
    np.testing.assert_array_equal(gv.numpy(), wv)


def _wrapper_calls():
    q = torch.zeros(2, 3, 8)
    kv = torch.zeros(2, 4, 8)
    yield "fused_attention", tatt, "fused_attention_reference", \
        lambda: tatt.fused_attention(q, kv, kv, torch.zeros(2, 1, 1, 4), 2)
    x = torch.zeros(3, 128)
    yield "fused_ffn", tffn, "ffn_reference", lambda: tffn.fused_ffn(
        x, torch.zeros(64, 128), torch.zeros(64), torch.zeros(128, 64),
        torch.zeros(128))
    qb = torch.zeros(4, 1, 2, 4)
    cache = torch.zeros(5, 4, 8)
    anc = torch.zeros(2, 2, 5, dtype=torch.long)
    yield "beam_decode_attend", tdec, "beam_decode_attend_reference", \
        lambda: tdec.beam_decode_attend(qb, cache, cache, anc, 1)
    yield "topk_lse", ttopk, "topk_lse_reference", \
        lambda: ttopk.topk_lse(torch.zeros(2, 50), 3)
    yield "fused_attention_bwd", tatt, "fused_attention_reference", \
        lambda: tatt.fused_attention_bwd(q, kv, kv, torch.zeros(2, 1, 1, 4),
                                         q, 2, True)
    yield "fused_ffn_bwd", tffn, "ffn_reference", lambda: tffn.fused_ffn_bwd(
        x, x, torch.zeros(64, 128), torch.zeros(64), torch.zeros(128, 64))
    h = torch.zeros(2, 3, 8)
    g = torch.ones(8)
    seed = torch.zeros(1, dtype=torch.int32)
    yield "fused_dropout_add_ln", tln, "fused_dropout_add_ln_reference", \
        lambda: tln.fused_dropout_add_ln(h, h, g, g, seed, 0.1)
    yield "fused_dropout_add_ln_bwd", tln, "fused_dropout_add_ln_reference", \
        lambda: tln.fused_dropout_add_ln_bwd(h, h, g, seed, h, 0.1)
    lse = torch.zeros(2, 2, 3)
    yield "fused_attention", tatt, "fused_attention_lse_reference", \
        lambda: tatt.fused_attention_fwd_lse(q, kv, kv,
                                             torch.zeros(2, 1, 1, 4), 2)
    yield "fused_attention_bwd_long", tatt, \
        "fused_attention_bwd_long_reference", \
        lambda: tatt.fused_attention_bwd_long(q, kv, kv,
                                              torch.zeros(2, 1, 1, 4), q, lse,
                                              q, 2, True)
    yield "fused_gated_ffn", tffn, "gated_ffn_reference", \
        lambda: tffn.fused_gated_ffn(x, torch.zeros(64, 128),
                                     torch.zeros(64, 128), torch.zeros(128, 64))
    yield "fused_gated_ffn_bwd", tffn, "gated_ffn_reference", \
        lambda: tffn.fused_gated_ffn_bwd(x, x, torch.zeros(64, 128),
                                         torch.zeros(64, 128),
                                         torch.zeros(128, 64), "gelu_new",
                                         0.1, seed)
    yield "fused_attention", tatt, "fused_attention_reference", \
        lambda: tatt.fused_attention(q, kv, kv, torch.zeros(2, 1, 1, 4), 2,
                                     bias=torch.zeros(1, 2, 3, 4))
    yield "beam_decode_attend", tdec, "beam_decode_attend_reference", \
        lambda: tdec.beam_decode_attend(qb, cache, cache, anc, 1,
                                        torch.zeros(1, 2, 1, 5))
    labels = torch.zeros(3, dtype=torch.long)
    yield "fused_linear_ce", tfce, "fused_linear_ce_reference", \
        lambda: tfce.fused_linear_ce(torch.zeros(3, 64), torch.zeros(10, 64),
                                     torch.zeros(10), labels)
    yield "fused_linear_ce_bwd", tfce, "fused_linear_ce_bwd_reference", \
        lambda: tfce.fused_linear_ce_bwd(torch.zeros(3, 768),
                                         torch.zeros(10, 768),
                                         torch.zeros(10), labels,
                                         torch.zeros(3), torch.ones(3))
    new = torch.zeros(4, 1, 8)
    yield "beam_decode_attend_update", tdec, \
        "beam_decode_attend_update_reference", \
        lambda: tdec.beam_decode_attend_update(qb, cache.clone(),
                                               cache.clone(), new, new, anc, 1)
    yield "cache_slot_update", tcu, "cache_slot_update_reference", \
        lambda: tcu.cache_slot_update(torch.zeros(1, 5, 4, 8),
                                      torch.zeros(1, 4, 8), 1)


@pytest.mark.parametrize("which", range(18))
def test_cuda_request_without_library_raises_not_falls_back(which,
                                                            monkeypatch):
    """A wrapper asked to launch (device check patched to say CUDA) on a
    host with no CUDA build must raise, not quietly run the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the library would build and launch")
    name, mod, ref_name, call = list(_wrapper_calls())[which]
    wrapper = getattr(mod, name)

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain path ran for a CUDA request")

    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(mod, ref_name, plain_must_not_run)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA|nvcc"):
        call()
    assert wrapper.launches == before


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="all be on CPU or all on CUDA"):
        _build.use_kernel(torch.zeros(1), torch.zeros(1, device="meta"))


ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py with everything it
    imports, loads neither jax nor flax (the machine with the card has no
    JAX) nor any module of the JAX package: the port keeps its own copy of
    the configuration. Nor does loading them import PIL, transformers or
    safetensors: the modules that read images or checkpoints import what
    they use where they use it."""
    code = ("import importlib, pkgutil, sys\n"
            "import vlpet_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(vlpet_tpu_torch.__path__,\n"
            "                               'vlpet_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "chip_smoke.flagship_cfg('bfloat16')\n"
            "top = lambda m: m.split('.')[0]\n"
            "bad = [m for m in sys.modules\n"
            "       if top(m) in ('jax', 'jaxlib', 'flax', 'vlpet_tpu',\n"
            "                     'PIL', 'transformers', 'safetensors')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_torch_and_the_port():
    """Every import statement of chip_smoke.py, at any depth, names the
    standard library, torch or vlpet_tpu_torch."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    extra = names - set(sys.stdlib_module_names) - {"torch", "vlpet_tpu_torch"}
    assert not extra, extra
    assert "vlpet_tpu_torch" in names


def test_flagship_cfg_is_the_graft_entry_config():
    from __graft_entry__ import _flagship_cfg

    from vlpet_tpu_torch.config import FLAGSHIP_TASKS, flagship_cfg

    want, tasks = _flagship_cfg()
    got = flagship_cfg()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert FLAGSHIP_TASKS == tasks
    assert flagship_cfg("bfloat16").dtype == "bfloat16"


@pytest.mark.parametrize("name", ["AdapterSpec", "LoraSpec", "PromptSpec",
                                  "HyperformerSpec", "PetConfig", "VisConfig",
                                  "BartConfig", "T5Config", "VLModelConfig"])
def test_config_copy_has_the_jax_fields_and_defaults(name):
    """The port's copy of each dataclass has the JAX package's field names,
    in order, and its defaults, so the two cannot drift apart."""
    import vlpet_tpu.config as jc

    import vlpet_tpu_torch.config as pc

    ours, theirs = getattr(pc, name), getattr(jc, name)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert (dataclasses.asdict(pc.vlpet_recipe("large", tasks=("a", "b")))
            == dataclasses.asdict(jc.vlpet_recipe("large", tasks=("a", "b"))))
    pet = dict(tasks=("a", "b"), lora_dim=8, use_single_lora=True)
    assert (dataclasses.asdict(pc.PetConfig(**pet).lora_spec())
            == dataclasses.asdict(jc.PetConfig(**pet).lora_spec()))


def test_entry_points_default_to_the_card():
    """With no device argument the port builds on CUDA, so on a host
    without a card it raises instead of quietly building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from vlpet_tpu_torch.config import BartConfig, VisConfig, VLModelConfig
    from vlpet_tpu_torch.models.generate import init_self_cache
    from vlpet_tpu_torch.models.vlbart import VLBart

    cfg = VLModelConfig(backbone=BartConfig(
        vocab_size=32, d_model=16, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=32, decoder_ffn_dim=32),
        vis=VisConfig(feat_dim=8, n_boxes=2))
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        VLBart(cfg)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        init_self_cache(cfg, 2, 4)
    VLBart(cfg, device="cpu")  # asked for the CPU: builds


def test_plain_twins_routes_and_restores():
    from vlpet_tpu_torch import ops

    kernel, plain = object(), object()
    assert ops.route(kernel, plain) is kernel
    with pytest.raises(KeyError):
        with ops.plain_twins():
            assert ops.route(kernel, plain) is plain
            raise KeyError
    assert ops.route(kernel, plain) is kernel
