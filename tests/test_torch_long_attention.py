"""The port's long-sequence attention against the JAX package's per-head
and query-strip Pallas kernels, on CPU.

The video path (S 604, 1024) runs, in the JAX package, the per-head pair
_pallas_attention_perhead / _pallas_attention_perhead_bwd and the L-tiled
pair _pallas_attention_ltiled / _pallas_attention_ltiled_bwd; here they run
in interpret mode. The port serves them with A1 forward and the long
backward (csrc/attention_bwd_long.cu); on CPU tensors its wrappers take the
plain twins: fused_attention (the reference, differentiated by autograd),
fused_attention_fwd_lse and fused_attention_bwd_long (the long backward's
arithmetic: p from the row logsumexp, delta = rowsum(do * out)). Inputs
come from seeded numpy. fp32 tolerance 1e-5 (absolute and relative): both
sides sum fp32 products in different orders over at most 72 keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 1e-5
B, H, Dh, BLOCK_L = 2, 2, 16, 8

# L, S, causal: ragged-padding self-attention, cross-attention with L < S
# (the decoder's 10 queries over the joint sequence), and the causal
# triangle with past offset S - L
CASES = {"self": (40, 40, False), "cross": (10, 72, False),
         "causal": (36, 44, True)}


def _inputs(L, S):
    rng = np.random.default_rng(L * 100 + S)
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    # ragged padding: example 1 keeps its first S - 9 keys, random holes too
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.2
    keep[1, ..., S - 9:] = False
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, mask, do


def _jax_kernels(family):
    from vlpet_tpu.ops import attention as jatt

    if family == "perhead":
        return (lambda *a: jatt._pallas_attention_perhead(*a, interpret=True),
                lambda *a: jatt._pallas_attention_perhead_bwd(
                    *a, interpret=True))
    return (lambda *a: jatt._pallas_attention_ltiled(
        *a, block_l=BLOCK_L, interpret=True),
        lambda *a: jatt._pallas_attention_ltiled_bwd(
            *a, block_l=BLOCK_L, interpret=True))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("family", ["perhead", "ltiled"])
@pytest.mark.parametrize("case", list(CASES))
def test_long_attention_matches_pallas_interpret(case, family):
    L, S, causal = CASES[case]
    q, k, v, mask, do = _inputs(L, S)
    fwd, bwd = _jax_kernels(family)
    jq, jk, jv, jm, jdo = map(jnp.asarray, (q, k, v, mask, do))
    want = np.asarray(fwd(jq, jk, jv, jm, H, causal))
    wgrads = [np.asarray(g) for g in bwd(jq, jk, jv, jm, jdo, H, causal)]

    args = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tatt.fused_attention(*args, _t(mask), H, causal)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    ggrads = torch.autograd.grad(got, args, _t(do))

    out, lse = tatt.fused_attention_fwd_lse(_t(q), _t(k), _t(v), _t(mask), H,
                                            causal)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    long = tatt.fused_attention_bwd_long(_t(q), _t(k), _t(v), _t(mask), out,
                                         lse, _t(do), H, causal)
    for name, g, b, w in zip(("dq", "dk", "dv"), ggrads, long, wgrads):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name + " (autograd)")
        np.testing.assert_allclose(b.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name + " (long backward)")


def test_row_logsumexp_is_the_softmax_normalizer():
    """lse is log sum_j exp(logit_ij) over the masked logits: exp(logits -
    lse) sums to 1 along each row and is the reference's softmax."""
    L, S, causal = CASES["causal"]
    q, k, v, mask, _ = _inputs(L, S)
    _, lse = tatt.fused_attention_fwd_lse(_t(q), _t(k), _t(v), _t(mask), H,
                                          causal)
    s = tatt._logits(_t(q), _t(k), _t(mask), H, causal)
    p = torch.exp(s - lse[..., None])
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.numpy(), torch.softmax(s, -1).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L, S, route", [
    (56, 56, "A6"), (10, 10, "A6"), (10, 56, "A6"),  # image-text sites
    (604, 604, "long"), (10, 604, "long"), (1024, 1024, "long"),  # video
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_route(L, S, route, dtype):
    assert tatt.backward_route(L, S, 64, dtype) == route


def test_a6_wrapper_refuses_long_shapes_on_the_card(monkeypatch):
    """A6's wrapper asked to launch at a long shape points to the long
    backward instead of building an oversized block."""
    monkeypatch.setattr(tatt._build, "use_kernel", lambda *t: True)
    q = torch.zeros(1, 604, 64)
    with pytest.raises(ValueError, match="fused_attention_bwd_long"):
        tatt.fused_attention_bwd(q, q, q, torch.zeros(1, 1, 1, 604), q, 1)


def test_long_backward_rejects_bad_lse_and_short_causal_keys():
    q, k, v, mask, do = map(_t, _inputs(10, 72))
    out, lse = tatt.fused_attention_fwd_lse(q, k, v, mask, H)
    with pytest.raises(ValueError, match="lse"):
        tatt.fused_attention_bwd_long(q, k, v, mask, out, lse[:, :1], do, H)
    with pytest.raises(ValueError, match="S >= L"):
        tatt.fused_attention_bwd_long(k, q, q, torch.zeros(1, 1, 1, 10), k,
                                      torch.zeros(B, H, 72), k, H, True)
