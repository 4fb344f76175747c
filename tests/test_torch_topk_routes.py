"""T1 and T2 (the exact top-k + logsumexp) on CPU: the plain twin at the
real vocabulary widths, an emulation of the kernel's selection, the launch
plan and the wrapper's host path.

The plain twin (``topk_lse`` on CPU tensors) is held to the JAX package's
Pallas kernels in interpret mode at V 50265 (BART), 32100 (T5 relu/tied)
and 32128 (T5 gated/untied), R 8, k 1, 2, 10 and 16, on randn rows, rows
with half their entries at -inf, and quantized rows whose top values tie
many ways: values and indices exactly, the logsumexp within 1e-5 relative.
``topk_lse_hier`` sends k <= 2 to ``topk_lse_exact``
(vlpet_tpu/ops/topk.py:195), so those are held to the latter alone. A row
that is all -inf is held to ``lax.top_k`` and JAX's logsumexp (-inf): both
Pallas kernels leave that row undefined (a NaN logsumexp; the pad sentinel
or a repeated index in the top k).

The kernel's selection (csrc/topk.cu), emulated in numpy: ``topk_plan``'s
block, a row's head peeled to a 16-byte boundary at every row offset mod
4, groups of 16 values a thread, one candidate list a warp behind the
row-wide ">=" threshold (read once a group, raised after it, the warps
taking each group in a random order; while a warp's list is not full, the
k-th largest of its lanes' group maxima bounds it too), then the rank merge of the warps'
entries. On adversarial ties (few levels, constant rows, rows ascending
and descending, -inf rows) it must equal ``lax.top_k`` exactly, and its
group-wise logsumexp JAX's within 1e-5 relative. ``topk_plan`` keeps the
block's shared memory within the card's 227 KB for V up to 65536 and k up
to 16, and its partition covers every element of a row once.

The wrapper's CUDA route, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA): one
launch a call, with the caller's pointer (no cast, no copy) and the plan;
a non-fp32 or non-contiguous input and k outside 1..min(16, V) raise
before any launch.
"""

import bisect
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.ops.topk import topk_lse_exact, topk_lse_hier
from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)  # several xdist workers share the host

LSE_TOL = 1e-5  # chip_smoke.py TOPK_LSE_TOL
BIG = 2 ** 31 - 1  # the kernel's sentinel index (INT_MAX)
L2E = np.float32(1.4426950408889634)


def _randn(rng, R, V):
    return rng.normal(size=(R, V)).astype(np.float32)


def _ties(rng, R, V):
    """chip_smoke.py's ties: 2000 levels, every top value tied ~V/2000
    ways."""
    return (rng.integers(-1000, 1000, size=(R, V)) / 100.0).astype(np.float32)


def _half_inf(rng, R, V):
    x = _randn(rng, R, V)
    x[rng.uniform(size=(R, V)) < 0.5] = -np.inf
    return x


def _lse_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin])
    assert np.all(np.abs(got[fin] - want[fin])
                  <= LSE_TOL * (1 + np.abs(want[fin])))


@functools.cache
def _jitted(fn, k):
    """fn in interpret mode, jitted once a k: the second batch of a width
    reuses the first one's compile."""
    return jax.jit(functools.partial(fn, k=k, interpret=True))


@pytest.mark.parametrize("k", [1, 2, 10, 16])
@pytest.mark.parametrize("V", [50265, 32100, 32128])
def test_twin_matches_pallas_interpret_at_vocab_width(V, k):
    rng = np.random.default_rng(V + k)
    for x in (np.concatenate([_randn(rng, 4, V), _half_inf(rng, 4, V)]),
              _ties(rng, 8, V)):
        vals, toks, lse = ttopk.topk_lse(torch.from_numpy(x), k)
        assert toks.dtype == torch.int32 and vals.shape == (8, k)
        for fn in (topk_lse_exact,) + ((topk_lse_hier,) if k > 2 else ()):
            wv, wt, wl = map(np.asarray, _jitted(fn, k)(jnp.asarray(x)))
            np.testing.assert_array_equal(toks.numpy(), wt)
            np.testing.assert_array_equal(vals.numpy(), wv)
            _lse_close(lse.numpy(), wl)


def test_twin_on_an_all_inf_row_matches_lax_top_k():
    rng = np.random.default_rng(3)
    x = _half_inf(rng, 3, 50265)
    x[1] = -np.inf
    vals, toks, lse = ttopk.topk_lse(torch.from_numpy(x), 16)
    wv, wt = jax.lax.top_k(jnp.asarray(x), 16)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    _lse_close(lse.numpy(), jax.nn.logsumexp(jnp.asarray(x), axis=-1))
    assert lse[1].item() == -np.inf and toks[1].tolist() == list(range(16))


# --- the kernel's selection, emulated ---------------------------------


def _groups(V, threads, mis):
    """A row's schedule in the kernel: (threads, N) element indices per
    group, -1 where a slot is unused, in the order the block runs them:
    the head (up to the first 16-byte boundary; ``mis`` is the row's start
    in floats mod 4), the float4 groups, the tail."""
    head = min((4 - mis) % 4, V)
    nv4 = (V - head) // 4
    tail = V - head - 4 * nv4
    tid = np.arange(threads)
    out = [np.where(tid < head, tid, -1)[:, None]]
    span = threads * ttopk.LOADS
    for g in range(-(-nv4 // span)):
        j4 = g * span + tid[:, None] + threads * np.arange(ttopk.LOADS)
        e = head + 4 * j4[:, :, None] + np.arange(4)
        out.append(np.where((j4 < nv4)[:, :, None], e, -1)
                   .reshape(threads, 4 * ttopk.LOADS))
    out.append(np.where(tid < tail, head + 4 * nv4 + tid, -1)[:, None])
    return out


def _lse_merge(m, s, m2, s2):
    mn = np.maximum(m, m2)
    if mn == -np.inf:
        return m, s
    return mn, np.float32(s * np.exp2((m - mn) * L2E)
                          + s2 * np.exp2((m2 - mn) * L2E))


def _emulate_row(x, k, threads, mis, rng, stats=None):
    """(vals, idx, lse) of one row as csrc/topk.cu computes them. An entry
    is the key (-value, index): (value desc, index asc) is key order."""
    V, W = x.shape[0], threads // 32
    neg = np.float32(-np.inf)
    sentinel = (np.float32(np.inf), BIG)
    thr = neg  # the block's threshold
    lists = [[sentinel] * k for _ in range(W)]  # keys, ascending
    bv = np.full(threads, neg)  # k = 1: each thread's best
    bi = np.full(threads, BIG)
    m = np.full(threads, neg, np.float32)
    s = np.zeros(threads, np.float32)
    inserted = 0
    for grp in _groups(V, threads, mis):
        v = np.where(grp >= 0, x[np.maximum(grp, 0)], neg).astype(np.float32)
        ix = np.where(grp >= 0, grp, BIG)
        g = v.max(axis=1)
        live = g != neg  # the logsumexp: one rescale a group
        mn = np.where(live, np.maximum(m, g), m)
        with np.errstate(invalid="ignore"):
            s = np.where(live, s * np.exp2((m - mn) * L2E), s)
            ml = mn * L2E
            for j in range(v.shape[1]):
                s = np.where(live, s + np.exp2(v[:, j] * L2E - ml), s)
        m = mn.astype(np.float32)
        s = s.astype(np.float32)
        if k == 1:  # the thread's first index of its group max
            for t in np.nonzero((g > bv) | ((g == bv) & (bi == BIG)))[0]:
                bv[t], bi[t] = g[t], ix[t][np.argmax(v[t] == g[t])]
            continue
        for w in rng.permutation(W):
            lanes = slice(32 * w, 32 * w + 32)
            vw, iw, lst = v[lanes], ix[lanes], lists[w]
            seen = thr  # read once a group
            t = max(seen, -lst[-1][0])
            if v.shape[1] > 1 and lst[-1][0] == np.inf:
                # the list not yet full: the k-th largest lane max
                t = max(t, np.sort(g[lanes])[::-1][k - 1])
            if not (g[lanes] >= t).any():
                continue
            raised = False
            for j in range(vw.shape[1]):
                nk, ki = lst[-1]  # the ballot, against the k-th entry now
                nv = -vw[:, j]
                for lane in np.nonzero((vw[:, j] >= t) & (
                        (nv < nk) | ((nv == nk) & (iw[:, j] < ki))))[0]:
                    key = (nv[lane], iw[lane, j])
                    if key >= lst[-1]:
                        continue  # beaten meanwhile
                    bisect.insort(lst, key)
                    lst.pop()
                    raised = True
                    inserted += 1
            if raised and -lst[-1][0] > seen:
                thr = max(thr, -lst[-1][0])
    if stats is not None:
        stats["inserted"] = inserted
    if k == 1:
        entries = [min(zip(-bv[32 * w:32 * w + 32], bi[32 * w:32 * w + 32]))
                   for w in range(W)]
    else:
        entries = [e for lst in lists for e in lst]
    vals, idx = np.zeros(k, np.float32), np.full(k, -1)
    ranks = [sum(o < e for o in entries) for e in entries]  # the merge
    for e, r in zip(entries, ranks):
        if r < k:
            vals[r], idx[r] = -e[0], e[1]
    assert sorted(r for r in ranks if r < k) == list(range(k))
    lm, ls = [], []
    for w in range(W):
        mw, sw = m[32 * w], s[32 * w]
        for t in range(32 * w + 1, 32 * w + 32):
            mw, sw = _lse_merge(mw, sw, m[t], s[t])
        lm.append(mw)
        ls.append(sw)
    mb, sb = lm[0], ls[0]
    for w in range(1, W):
        mb, sb = _lse_merge(mb, sb, lm[w], ls[w])
    with np.errstate(divide="ignore"):
        return vals, idx, np.float32(mb + np.log(sb))


def _adversarial(rng, R, V, k):
    """Rows whose ties decide the order: four levels, a constant row,
    ascending and descending rows, copies of the max spread over the row,
    half -inf and all -inf."""
    few = rng.integers(0, 4, size=(R, V)).astype(np.float32)
    rows = [few[r] for r in range(R)]
    rows.append(np.full(V, 0.5, np.float32))
    rows.append(np.arange(V, dtype=np.float32) // 3)
    rows.append(-(np.arange(V, dtype=np.float32) // 3))
    spread = _ties(rng, 1, V)[0]
    spread[rng.choice(V, min(V, 3 * k), replace=False)] = spread.max()
    rows.append(spread)
    rows.append(_half_inf(rng, 1, V)[0])
    rows.append(np.full(V, -np.inf, np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("k", [1, 2, 10, 16])
@pytest.mark.parametrize("R, V", [(2500, 50265), (250, 50265),
                                  (1500, 32100), (300, 37), (2500, 1000)])
def test_emulated_selection_matches_lax_top_k(R, V, k):
    """The emulation at the plan of an (R, V) launch (256 or 512
    threads), every row offset mod 4; V 37 and 1000 fill one group."""
    rng = np.random.default_rng(R + V + k)
    threads = ttopk.topk_plan(R, V, k)[0]
    x = _adversarial(rng, 4, V, k)
    wv, wt = map(np.asarray, jax.lax.top_k(jnp.asarray(x), k))
    wl = np.asarray(jax.nn.logsumexp(jnp.asarray(x), axis=-1))
    for r in range(x.shape[0]):
        # row r of the launch starts at r * V floats; add 0..3 to cover
        # every head the kernel peels, whatever V is
        mis = (r * V + r) % 4
        vals, idx, lse = _emulate_row(x[r], k, threads, mis, rng)
        np.testing.assert_array_equal(idx, wt[r], err_msg=f"row {r}")
        np.testing.assert_array_equal(vals, wv[r], err_msg=f"row {r}")
        _lse_close(np.array([lse]), wl[r:r + 1])


def test_emulated_threshold_admits_few_values():
    """On a randn row at BART's width a warp's list takes a few dozen of
    the 6284 values its lanes see at k 10 (27 in this order of the warps;
    the parent's per-thread lists inserted ~39 a thread, ~1250 a warp)."""
    rng = np.random.default_rng(5)
    x = _randn(rng, 1, 50265)[0]
    wv, wt = map(np.asarray, jax.lax.top_k(jnp.asarray(x), 10))
    stats = {}
    vals, idx, _ = _emulate_row(x, 10, 256, 1, rng, stats)
    np.testing.assert_array_equal(idx, wt)
    assert stats["inserted"] / 8 < 64, stats


# --- the plan -----------------------------------------------------------


@pytest.mark.parametrize("V", [1, 3, 37, 1000, 4095, 8192, 32100, 32128,
                               50265, 65536])
def test_plan_fits_shared_memory_and_covers_the_row(V):
    for R in (1, 250, 264, 265, 300, 500, 1500, 2500, 2501):
        for k in range(1, min(16, V) + 1):
            threads, loads, stages, smem = ttopk.topk_plan(R, V, k)
            assert threads in (256, 512) and loads == ttopk.LOADS
            assert stages == ttopk.STAGES
            assert smem == (stages * threads * loads * 16 + 16
                            + 8 * (threads // 32) * (k + 1))
            assert smem <= 227 * 1024
            # the blocks an SM the plan counts on fit its shared memory
            assert (2 if threads == 512 else 4) * (smem + 1024) <= 228 * 1024
    for threads in (256, 512):
        for mis in range(4):
            seen = np.concatenate([g[g >= 0] for g in
                                   _groups(V, threads, mis)])
            assert np.array_equal(np.sort(seen), np.arange(V))
            # the body starts on a 16-byte boundary
            assert (mis + min((4 - mis) % 4, V)) % 4 == 0 or V < 4


def test_plan_at_the_sites():
    """512 threads where one wave holds every row at a block a row (the
    video beam's 250 rows); 256 at the greedy and beam rows above 264 and
    at short rows."""
    assert ttopk.topk_plan(250, 50265, 10)[0] == 512
    assert ttopk.topk_plan(264, 50265, 1)[0] == 512
    assert ttopk.topk_plan(7, 37, 16)[0] == 256
    for R, V in ((265, 50265), (300, 32100), (500, 50265), (1500, 32100),
                 (1500, 32128), (2500, 50265)):
        for k in (1, 10):
            assert ttopk.topk_plan(R, V, k)[0] == 256
    assert ttopk.topk_plan(2500, 50265, 10) == (256, 4, 3,
                                                3 * 256 * 64 + 16 + 8 * 8 * 11)


# --- the wrapper's host path ----------------------------------------------


class _Recorder:
    """Stands in for ``_build.launch``: records (name, args), runs
    nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def card_route(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", rec)
    return rec


@pytest.mark.parametrize("R, V, k", [(2500, 50265, 10), (500, 50265, 1),
                                     (250, 50265, 10), (1500, 32128, 16),
                                     (3, 7, 7)])
def test_one_launch_on_the_callers_tensor(card_route, R, V, k):
    x = torch.zeros(R, V)
    before = ttopk.topk_lse.launches
    vals, toks, lse = ttopk.topk_lse(x, k)
    assert [n for n, _ in card_route.calls] == ["vlpet_topk_lse"]
    assert ttopk.topk_lse.launches == before + 1
    args = card_route.calls[0][1]
    assert args[0] == x.data_ptr()  # no cast, no copy
    assert args[1:4] == (vals.data_ptr(), toks.data_ptr(), lse.data_ptr())
    assert args[4:] == (R, V, k) + ttopk.topk_plan(R, V, k)
    assert toks.dtype == torch.int32 and vals.shape == (R, k)


def test_no_launch_for_zero_rows(card_route):
    vals, toks, lse = ttopk.topk_lse(torch.zeros(0, 50), 3)
    assert card_route.calls == [] and vals.shape == (0, 3)


@pytest.mark.parametrize("case", ["bf16", "f64", "strided", "k0", "k17",
                                  "k>V"])
def test_refused_before_any_launch(card_route, case):
    x = torch.zeros(6, 64)
    k = 4
    if case == "bf16":
        x, err = x.bfloat16(), TypeError
    elif case == "f64":
        x, err = x.double(), TypeError
    elif case == "strided":
        x, err = torch.zeros(6, 128)[:, ::2], ValueError
    else:
        err = ValueError
        k = {"k0": 0, "k17": 17, "k>V": 5}[case]
        if case == "k>V":
            x = torch.zeros(6, 4)
    with pytest.raises(err):
        ttopk.topk_lse(x, k)
    assert card_route.calls == []


def test_cpu_tensors_take_the_twin(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "launch", rec)
    x = torch.from_numpy(_ties(np.random.default_rng(1), 4, 300))
    got = ttopk.topk_lse(x, 5)
    want = ttopk.topk_lse_reference(x, 5)
    assert rec.calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
