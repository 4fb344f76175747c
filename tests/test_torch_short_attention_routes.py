"""A6's routes, the bf16 plain twins of A6 and C2, and the wrappers'
refusals, on CPU.

ops/attention.py picks A6's kernel by ``a6_route(L, S, Dh, dtype)``: "tc"
(the tensor-core kernels of csrc/attention_bwd.cu: one for a single 64-row
tile, one for L or S past 64 up to 128, one past 128) for bf16 at Dh 64
with L, S <= 256 -- every bf16 A6 site of the repo -- and "fma" (the
FP32-FMA kernel) for fp32 and other widths. ``backward_route`` gives every
bf16 Dh 64 site within 256 to A6 and the video sites (S 604, 704, 1024) to
the long backward. On the card each bf16 kernel is held to its plain twin,
so here the bf16 twins -- ``fused_attention_bwd`` and
``fused_linear_ce_bwd`` through their CPU route -- are held to the JAX
package's TPU kernels in interpret mode, on bf16 inputs made with numpy
from a seed:

* A6 against ``_pallas_attention_bwd`` at a ragged L = S = 50 with a
  batched padding mask, L 10 over S 56, and the causal L = S = 10 (the
  one-tile kernel's shapes), at a ragged L = S = 96 with a batched mask,
  L 40 over S 116 and a causal L = S = 76 (the wide kernel's), and at a
  ragged L = S = 142 with a batched mask, L 20 over S 181 and a causal
  L = S = 200 (the kernel past 128 rows), each with the relative bias,
  with dropout 0.1, and with ``bias_grad`` (dbias too). Tolerance 2e-2 *
  (1 + max|ref|), tests/test_torch_attention_routes.py's rule for
  gradients: the two round p and ds to bf16 at other places, and an
  element whose terms cancel carries the rounding of terms several times
  its own size. At the wide shapes, an emulation of the wide kernel's
  arithmetic (row statistics from phase 1, p and ds recomputed from them
  on the key side, p_drop and ds rounded to bf16 before the products) is
  held to the same kernel by the same rule; past 128 rows, an emulation
  of that kernel's (the row statistics from one online sweep over 16-key
  chunks: running max, rescaled sum and rescaled rowsum(dp e)).
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
          "causal10": (10, 10, True, False),
          "ragged96": (96, 96, False, True),
          "cross40x116": (40, 116, False, True),
          "causal76": (76, 76, True, False),
          "ragged142": (142, 142, False, True),
          "cross20x181": (20, 181, False, True),
          "causal200": (200, 200, True, False)}
# the shapes of the wide tensor-core kernel (L or S past 64, up to 128)
WIDE = ("ragged96", "cross40x116", "causal76")
# the shapes of the tensor-core kernel past 128 rows
PAST128 = ("ragged142", "cross20x181", "causal200")
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


@pytest.mark.parametrize("L, S, route", [
    (65, 65, "tc"), (10, 65, "tc"), (65, 10, "tc"), (90, 90, "tc"),
    (116, 116, "tc"), (40, 116, "tc"), (128, 10, "tc"), (40, 141, "tc"),
    (10, 142, "tc"), (20, 181, "tc")])
def test_a6_route_past_one_tile_is_fma(L, S, route):
    """bf16 Dh 64 sites that A6 serves past one 64-row tile take a
    tensor-core kernel: the wide one up to L, S 128, the one past 128 rows
    beyond it (the video tvc cross sites, the prompt's nlvr cross site)."""
    assert tatt.backward_route(L, S, 64, torch.bfloat16) == "A6"
    assert tatt.a6_route(L, S, 64, torch.bfloat16) == route


def test_a6_route_is_tc_wherever_a6_serves_bf16_up_to_128():
    """Every 1 <= L, S <= 256 is given to A6 in bf16 at Dh 64 and takes
    "tc" there; fp32 and other widths keep "fma" where A6 serves them; the
    video sites stay on the long backward."""
    served = 0
    for L in range(1, 257):
        for S in range(1, 257):
            if tatt.backward_route(L, S, 64, torch.bfloat16) != "A6":
                continue
            served += 1
            assert tatt.a6_route(L, S, 64, torch.bfloat16) == "tc", (L, S)
            assert tatt.a6_route(L, S, 64, torch.float32) == "fma", (L, S)
            assert tatt.a6_route(L, S, 32, torch.bfloat16) == "fma", (L, S)
    assert served == 256 * 256
    assert tatt.backward_route(118, 118, 64, torch.bfloat16) == "A6"
    for L, S in ((257, 257), (604, 604), (10, 604), (704, 704),
                 (1024, 1024)):
        assert tatt.backward_route(L, S, 64, torch.bfloat16) == "long"
        assert tatt.a6_route(L, S, 64, torch.bfloat16) == "fma"
    # fp32 and Dh 32 keep the FMA kernel's fp32-staging rule
    assert tatt.backward_route(118, 118, 64, torch.float32) == "long"
    assert tatt.backward_route(10, 142, 64, torch.float32) == "A6"
    assert tatt.backward_route(100, 100, 32, torch.bfloat16) == "A6"
    assert tatt.backward_route(142, 142, 32, torch.bfloat16) == "long"


@pytest.mark.parametrize("L, S, past128", [
    (10, 96, 0), (128, 128, 0), (10, 142, 1), (20, 181, 1), (216, 216, 1),
    (256, 256, 1)])
def test_a6_counts_its_launches_past_128_rows(monkeypatch, L, S, past128):
    """On the card A6 launches its tensor-core route (tc = 1) at a bf16 Dh
    64 site within 256 rows, and counts the launches past 128 rows apart
    (the tensors lie on the CPU; the launcher is replaced by a recorder)."""
    calls = []
    monkeypatch.setattr(tatt._build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tatt._build, "launch",
                        lambda name, *args: calls.append((name, args)))
    fn = tatt.fused_attention_bwd
    before = fn.launches_by_route["tc"], fn.tc256_launches
    q = torch.zeros(1, L, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, S, 64, dtype=torch.bfloat16)
    fn(q, kv, kv, torch.zeros(1, 1, 1, S), q, 1)
    (name, args), = calls
    assert name == "vlpet_attention_bwd" and args[13:15] == (L, S)
    assert args[20] == 1  # tc
    assert (fn.launches_by_route["tc"] - before[0],
            fn.tc256_launches - before[1]) == (1, past128)


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


def _wide_emulation(q, k, v, mask, do, causal, bias, rate, seed,
                    bias_grad, chunk=0):
    """The wide tensor-core kernel's arithmetic on bf16 torch tensors:
    fp32 logits, per query row the max m, 1 / sum of 2^((a - m) log2 e)
    and rowsum(dp p) (phase 1); p recomputed from those statistics, ds = p
    (dp - rowsum) with the undropped p, p_drop and ds rounded to bf16 before
    the dq, dk and dv products (fp32 sums); dbias = sum_b ds in fp32. With
    ``chunk`` > 0, the kernel past 128 rows: the statistics from one online
    sweep over ``chunk``-key pieces (running max m, sum z and t = sum of
    dp e, both rescaled by 2^((m_old - m_new) log2 e) where m grows), then
    rowsum(dp p) = t / z."""
    from vlpet_tpu_torch.ops.hashdrop import attention_keep_mask

    Bq, L, inner = q.shape
    S = k.shape[1]
    log2e = 1.4426950408889634

    def heads(t, n):
        return t.float().reshape(Bq, n, H, Dh).transpose(1, 2)

    qh, kh, vh, doh = heads(q, L), heads(k, S), heads(v, S), heads(do, L)
    a = qh @ kh.transpose(-1, -2) + mask
    if bias is not None:
        a = a + bias
    if causal:
        a = torch.where(tatt._causal_allowed(L, S, "cpu"), a,
                        torch.full((), -1e9))
    dp = doh @ vh.transpose(-1, -2)
    if rate > 0.0:
        keep = attention_keep_mask(Bq, L, S, H, seed, rate, device="cpu")
        scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
        dp = torch.where(keep, dp * scale, torch.zeros(()))
    if chunk:
        m = torch.full(a.shape[:-1] + (1,), -1e30)
        z, t = torch.zeros_like(m), torch.zeros_like(m)
        for c0 in range(0, S, chunk):
            ac, dc = a[..., c0:c0 + chunk], dp[..., c0:c0 + chunk]
            mn = torch.maximum(m, ac.amax(-1, keepdim=True))
            sc = torch.exp2((m - mn) * log2e)
            e = torch.exp2((ac - mn) * log2e)
            z = z * sc + e.sum(-1, keepdim=True)
            t = t * sc + (dc * e).sum(-1, keepdim=True)
            m = mn
        inv = 1.0 / z
        p = torch.exp2((a - m) * log2e) * inv
        rowsum = t * inv
    else:
        m = a.amax(-1, keepdim=True)
        e = torch.exp2((a - m) * log2e)
        p = e * (1.0 / e.sum(-1, keepdim=True))
        rowsum = (dp * p).sum(-1, keepdim=True)
    pd = torch.where(keep, p * scale, torch.zeros(())) if rate > 0.0 else p
    ds = p * (dp - rowsum)
    ds16 = ds.to(torch.bfloat16).float()
    pd16 = pd.to(torch.bfloat16).float()

    def back(x, n):
        return x.transpose(1, 2).reshape(Bq, n, inner).to(torch.bfloat16)

    grads = (back(ds16 @ kh, L), back(ds16.transpose(-1, -2) @ qh, S),
             back(pd16.transpose(-1, -2) @ doh, S))
    return grads + (ds.sum(0, keepdim=True),) if bias_grad else grads


def _emulation_matches_pallas_interpret(shape, mode, chunk):
    from vlpet_tpu.ops.attention import _pallas_attention_bwd

    L, S, causal, batched = SHAPES[shape]
    has_bias, rate, bias_grad = MODES[mode]
    q, k, v, mask, do, bias = _attention_inputs(L, S, batched, has_bias,
                                                L * 7 + S)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = map(_bf16, (q, k, v, do))
    want = _pallas_attention_bwd(jq, jk, jv, jnp.asarray(mask), jdo, H,
                                 causal, None if bias is None
                                 else jnp.asarray(bias), rate,
                                 jnp.asarray(SEED), bias_grad,
                                 interpret=True)
    got = _wide_emulation(tq, tk, tv, torch.from_numpy(mask), tdo, causal,
                          None if bias is None else torch.from_numpy(bias),
                          rate, torch.from_numpy(SEED), bias_grad, chunk)
    assert len(got) == len(want)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", WIDE)
def test_a6_wide_kernel_arithmetic_matches_pallas_interpret(shape, mode):
    _emulation_matches_pallas_interpret(shape, mode, chunk=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", PAST128)
def test_a6_past_128_kernel_arithmetic_matches_pallas_interpret(shape, mode):
    """csrc/attention_bwd.cu attention_bwd_tc_256's statistics sweep goes
    over 16-key chunks."""
    _emulation_matches_pallas_interpret(shape, mode, chunk=16)


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
