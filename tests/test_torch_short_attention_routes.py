"""A6's routes, the bf16 plain twins of A6 and C2, and the wrappers'
refusals, on CPU.

ops/attention.py picks A6's kernel by ``a6_route(L, S, Dh, dtype)``: "tc"
(the tensor-core kernel of csrc/attention_bwd.cu) for bf16 at Dh 64 where
L and S fit one 64-row tile -- every A6 site of the repo -- and "fma" (the
FP32-FMA kernel) otherwise. On the card each bf16 kernel is held to its
plain twin, so here the bf16 twins -- ``fused_attention_bwd`` and
``fused_linear_ce_bwd`` through their CPU route -- are held to the JAX
package's TPU kernels in interpret mode, on bf16 inputs made with numpy
from a seed:

* A6 against ``_pallas_attention_bwd`` at a ragged L = S = 50 with a
  batched padding mask, L 10 over S 56, and the causal L = S = 10, each
  with the relative bias, with dropout 0.1, and with ``bias_grad`` (dbias
  too). Tolerance 2e-2 * (1 + max|ref|), tests/test_torch_attention_routes.py's
  rule for gradients: the two round p and ds to bf16 at other places, and
  an element whose terms cancel carries the rounding of terms several times
  its own size.
* C2 against ``vlpet_tpu/ops/fused_ce.py:_run_bwd`` at N 61 (no multiple of
  any row block) and V 1000 (no multiple of 64), D 64; the same tolerance
  (the one-ulp flips of the g both round to bf16).

The wrappers also refuse, on the card, a bf16 view that A6's tensor-core
kernel cannot copy in 16-byte pieces, and C2 a width it has no kernel for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import attention as tatt
from vlpet_tpu_torch.ops import fused_ce

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([13579], np.int32)
B, H, Dh = 3, 2, 16

# L, S, causal, batched padding mask
SHAPES = {"ragged50": (50, 50, False, True),
          "cross10x56": (10, 56, False, True),
          "causal10": (10, 10, True, False)}
# bias, rate, bias_grad
MODES = {"bias": (True, 0.0, False), "dropout": (False, RATE, False),
         "bias_grad": (True, RATE, True)}


@pytest.mark.parametrize("L, S", [(56, 56), (10, 10), (10, 56), (64, 64),
                                  (1, 1)])
@pytest.mark.parametrize("dtype, Dh_, route", [
    (torch.bfloat16, 64, "tc"), (torch.float32, 64, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 128, "fma")])
def test_a6_route(L, S, dtype, Dh_, route):
    assert tatt.a6_route(L, S, Dh_, dtype) == route
    assert tatt.backward_route(L, S, Dh_, dtype) == "A6"


@pytest.mark.parametrize("L, S", [(65, 65), (10, 65), (65, 10), (90, 90)])
def test_a6_route_past_one_tile_is_fma(L, S):
    """bf16 Dh 64 sites that A6 still serves but whose L or S passes 64
    keep the FMA kernel."""
    assert tatt.backward_route(L, S, 64, torch.bfloat16) == "A6"
    assert tatt.a6_route(L, S, 64, torch.bfloat16) == "fma"


def test_a6_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        tatt.a6_route(56, 56, 64, torch.float16)


def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, its values as a bf16 jax array)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _close(got, want, msg):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got - want)
    bad = err > TOL * (1.0 + np.abs(want).max())
    assert not bad.any(), (f"{msg}: {bad.sum()} elements past tol, max "
                           f"|err| {err.max():.3e}")


def _attention_inputs(L, S, batched, has_bias, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H * Dh)).astype(np.float32) * Dh ** -0.5
    k, v = (rng.normal(size=(B, S, H * Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    if batched:
        keep = rng.uniform(size=(B, 1, 1, S)) > 0.2
        keep[-1, ..., S - 5:] = False
        keep[..., 0] = True
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    else:
        mask = np.zeros((1, 1, 1, S), np.float32)
    # the model feeds the relative bias at the compute dtype's values, fp32
    bias = (torch.from_numpy(rng.normal(size=(1, H, L, S)).astype(np.float32))
            .to(torch.bfloat16).float().numpy() if has_bias else None)
    return q, k, v, mask, do, bias


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_a6_bf16_twin_matches_pallas_interpret(shape, mode):
    from vlpet_tpu.ops.attention import _pallas_attention_bwd

    L, S, causal, batched = SHAPES[shape]
    has_bias, rate, bias_grad = MODES[mode]
    q, k, v, mask, do, bias = _attention_inputs(L, S, batched, has_bias,
                                                L * 7 + S)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = map(_bf16, (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    want = _pallas_attention_bwd(jq, jk, jv, jnp.asarray(mask), jdo, H,
                                 causal, jb, rate, jnp.asarray(SEED),
                                 bias_grad, interpret=True)
    tb = None if bias is None else torch.from_numpy(bias)
    got = tatt.fused_attention_bwd(tq, tk, tv, torch.from_numpy(mask), tdo,
                                   H, causal, tb, rate,
                                   torch.from_numpy(SEED), bias_grad)
    assert len(got) == len(want) == (4 if bias_grad else 3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, name)
    if bias_grad:
        assert got[3].dtype == torch.float32 and got[3].shape == (1, H, L, S)
        _close(got[3], want[3], "dbias")


def test_c2_bf16_twin_matches_pallas_interpret():
    import vlpet_tpu.ops.fused_ce as jfc

    N, D, V = 61, 64, 1000
    rng = np.random.default_rng(9)
    x = rng.normal(size=(N, D)).astype(np.float32) * D ** -0.5
    w = rng.normal(size=(V, D)).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    labels[[0, 30, 60]] = -100
    dloss = rng.uniform(0.5, 1.5, (N,)).astype(np.float32)
    (tx, jx), (tw, jw) = _bf16(x), _bf16(w)
    jl = jnp.asarray(labels).reshape(-1, 1)
    _, lse = jfc._run_fwd(jx, jw, jnp.asarray(b).reshape(1, -1), jl,
                          interpret=True)
    want = jfc._run_bwd(jx, jw, jnp.asarray(b).reshape(1, -1), jl, lse,
                        jnp.asarray(dloss).reshape(-1, 1), interpret=True)
    got = fused_ce.fused_linear_ce_bwd(
        tx, tw, torch.from_numpy(b), torch.from_numpy(labels).long(),
        torch.from_numpy(np.array(lse)[:, 0]), torch.from_numpy(dloss))
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    assert not got[[0, 30, 60]].any()  # ignored rows get no gradient
    _close(got, want, "dx")


def _misaligned(shape):
    """A contiguous bf16 view that starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    view = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("which", ["q", "k", "do"])
def test_tc_a6_refuses_misaligned_bf16_views_on_the_card(monkeypatch,
                                                         which):
    """On the tensor-core route A6's wrapper checks the 16-byte alignment
    of q, k, v and do before any launch (the tensors lie on the CPU; the
    wrapper is made to take its CUDA route)."""
    monkeypatch.setattr(tatt._build, "use_kernel", lambda *t: True)
    Bq, L, inner = 1, 8, 64
    t = {n: torch.zeros(Bq, L, inner, dtype=torch.bfloat16)
         for n in ("q", "k", "do")}
    t[which] = _misaligned((Bq, L, inner))
    assert tatt.a6_route(L, L, inner, torch.bfloat16) == "tc"
    with pytest.raises(ValueError, match=f"{which}: .*16-byte"):
        tatt.fused_attention_bwd(t["q"], t["k"], t["k"],
                                 torch.zeros(1, 1, 1, L), t["do"], 1)


@pytest.mark.parametrize("D", [256, 640, 2048])
def test_c2_refuses_widths_without_a_kernel_on_the_card(monkeypatch, D):
    monkeypatch.setattr(fused_ce._build, "use_kernel", lambda *t: True)
    N, V = 4, 64
    x = torch.zeros(N, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D must be one of"):
        fused_ce.fused_linear_ce_bwd(x, torch.zeros(V, D), torch.zeros(V),
                                     torch.zeros(N, dtype=torch.long),
                                     torch.zeros(N), torch.ones(N))
