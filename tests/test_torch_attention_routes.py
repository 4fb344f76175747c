"""The attention kernels' routes and the bf16 plain twins, on CPU.

ops/attention.py picks the kernels of an attention site by
``forward_route(L, S, Dh, dtype)``: "tc" (the tensor-core kernels of
csrc/attention.cu and csrc/attention_bwd_long.cu) for bf16 at Dh 64, "fma"
(the FP32-FMA kernels) for fp32 and for bf16 at other widths. On the card
the bf16 kernels are held to their plain twins, so here the bf16 twins --
``fused_attention_lse_reference`` and ``fused_attention_bwd_long_reference``
through the wrappers' CPU route -- are held to the JAX package's per-head
and L-tiled Pallas pairs (_pallas_attention_perhead / _bwd, the A2 and A3
kernels, and _pallas_attention_ltiled / _bwd, A4 and A5) in interpret mode,
on bf16 inputs made with numpy from a seed, at a ragged shape (L = S = 70
over row blocks of 8), with the relative bias, dropout and the causal
triangle. Tolerance 2e-2 * (1 + |ref|) on the output: the two round the
probabilities to bf16 at different places (a few bf16 ulps of O(1)
values, as chip_smoke.py's bf16 checks). The gradients take 2e-2 * (1 +
max|ref|), chip_smoke.py's rule for every backward: the Pallas kernels
round ds to bf16 before the dq and dk products while the twin keeps fp32
to the end, so an element whose terms cancel carries the rounding of
terms several times its own size.

The wrappers also refuse, on the card, a bf16 view that the tensor-core
kernels' 16-byte copies cannot take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([24680], np.int32)
B, H, Dh, BLOCK_L = 2, 2, 16, 8

# L, S, causal, bias, rate: ragged self-attention (two 64-row tiles on the
# card, the second of 6 rows), the relative bias with dropout, and the
# causal triangle with the bias and dropout
CASES = {"self": (70, 70, False, False, 0.0),
         "bias_dropout": (70, 70, False, True, RATE),
         "causal": (70, 70, True, True, RATE)}


@pytest.mark.parametrize("dtype, Dh_, route", [
    (torch.float32, 64, "fma"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 128, "fma")])
@pytest.mark.parametrize("L, S", [(56, 56), (604, 604), (1, 604), (10, 10)])
def test_forward_route(L, S, dtype, Dh_, route):
    assert tatt.forward_route(L, S, Dh_, dtype) == route


@pytest.mark.parametrize("dtype, Dh_, route", [
    (torch.float32, 64, "fma"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "fma")])
def test_long_backward_takes_the_forward_route(dtype, Dh_, route):
    """Inside "long" the same (dtype, Dh) test picks the long backward's
    kernels: the video encoder site at each width."""
    assert tatt.backward_route(604, 604, Dh_, dtype) == "long"
    assert tatt.forward_route(604, 604, Dh_, dtype) == route


def test_forward_route_rejects_other_dtypes_and_widths():
    with pytest.raises(TypeError, match="float16"):
        tatt.forward_route(56, 56, 64, torch.float16)
    with pytest.raises(ValueError, match="Dh"):
        tatt.forward_route(56, 56, 256, torch.bfloat16)


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, its values as a bf16 jax array)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _inputs(L, S, has_bias, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    keep = rng.uniform(size=(B, 1, 1, S)) > 0.2
    keep[-1, ..., S - 7:] = False
    keep[..., 0] = True
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    # the model feeds the relative bias at the compute dtype's values, fp32
    bias = (torch.from_numpy(rng.normal(size=(1, H, L, S)).astype(np.float32))
            .to(torch.bfloat16).float().numpy() if has_bias else None)
    return q, k, v, mask, do, bias


def _jax_pair(family):
    from vlpet_tpu.ops import attention as jatt

    if family == "perhead":
        return (lambda *a: jatt._pallas_attention_perhead(*a, interpret=True),
                lambda *a: jatt._pallas_attention_perhead_bwd(
                    *a, interpret=True))
    return (lambda *a: jatt._pallas_attention_ltiled(
        *a, block_l=BLOCK_L, interpret=True),
        lambda *a: jatt._pallas_attention_ltiled_bwd(
            *a, block_l=BLOCK_L, interpret=True))


def _close(got, want, msg, scaled=False):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got - want)
    bad = err > TOL * (1.0 + (np.abs(want).max() if scaled
                              else np.abs(want)))
    assert not bad.any(), (f"{msg}: {bad.sum()} elements past tol, max "
                           f"|err| {err.max():.3e}")


@pytest.mark.parametrize("family", ["perhead", "ltiled"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_twins_match_pallas_interpret(case, family):
    L, S, causal, has_bias, rate = CASES[case]
    q, k, v, mask, do, bias = _inputs(L, S, has_bias, L * 31 + S)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = map(_bf16, (q, k, v, do))
    fwd, bwd = _jax_pair(family)
    jb = None if bias is None else jnp.asarray(bias)
    jseed = jnp.asarray(SEED)
    jm = jnp.asarray(mask)
    want = fwd(jq, jk, jv, jm, H, causal, jb, rate, jseed)
    wgrads = bwd(jq, jk, jv, jm, jdo, H, causal, jb, rate, jseed)

    tb = None if bias is None else torch.from_numpy(bias)
    tm, tseed = torch.from_numpy(mask), torch.from_numpy(SEED)
    out, lse = tatt.fused_attention_fwd_lse(tq, tk, tv, tm, H, causal, tb,
                                            rate, tseed)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, want, "out")
    grads = tatt.fused_attention_bwd_long(tq, tk, tv, tm, out, lse, tdo, H,
                                          causal, tb, rate, tseed)
    for name, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert g.dtype == torch.bfloat16
        _close(g, w, name, scaled=True)


def _misaligned(shape):
    """A contiguous bf16 view that starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    view = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("which", ["q", "k"])
def test_tc_forward_refuses_misaligned_bf16_views_on_the_card(monkeypatch,
                                                              which):
    """On the tensor-core route A1's wrapper checks the 16-byte alignment of
    q, k and v before any launch (the tensors lie on the CPU; the wrapper
    is made to take its CUDA route)."""
    monkeypatch.setattr(tatt._build, "use_kernel", lambda *t: True)
    Bq, L, inner = 1, 8, 64
    q, k = (torch.zeros(Bq, L, inner, dtype=torch.bfloat16) for _ in range(2))
    if which == "q":
        q = _misaligned((Bq, L, inner))
    else:
        k = _misaligned((Bq, L, inner))
    with pytest.raises(ValueError, match=f"{which}: .*16-byte"):
        tatt.fused_attention(q, k, k, torch.zeros(1, 1, 1, L), 1)


def test_tc_long_backward_refuses_misaligned_bf16_do_on_the_card(monkeypatch):
    monkeypatch.setattr(tatt._build, "use_kernel", lambda *t: True)
    Bq, L, inner = 1, 8, 64
    q = torch.zeros(Bq, L, inner, dtype=torch.bfloat16)
    lse = torch.zeros(Bq, 1, L)
    with pytest.raises(ValueError, match="do: .*16-byte"):
        tatt.fused_attention_bwd_long(q, q, q, torch.zeros(1, 1, 1, L), q,
                                      lse, _misaligned((Bq, L, inner)), 1)
