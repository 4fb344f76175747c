"""L1 and L2 (the fused dropout + add + LayerNorm) on CPU: the launch plan,
the fixed-order dgamma/dbeta summation of the backward, the bf16 plain twin
and the wrappers' routes.

``ops.fused_ln.ln_plan`` sizes every launch of csrc/fused_ln.cu: the
route ("vec", 16-byte chunks, for aligned rows of a multiple of 16 bytes;
"scalar" otherwise), the ring's stages, the blocks, the warps a block and
the rows a warp. Warp w of W = blocks * warps takes rows w, w + W, ..: a
walk of that map covers every row exactly once, at most rows_per_warp a
warp and the warps' rows differing by at most one, at the paths' N (the
image-text and video steps' encoder and decoder rows), ragged N, D 100
(bf16 rows of 200 bytes) and D 1024. The grid is one full wave of the
card's SMs, or one row a warp below it.

The backward's column sums, emulated in numpy in the kernel's order: each
lane sums its columns over its warp's rows in row order, each block its 8
warps in warp order (one partial row a block), then ln_col_sum's 32 warps
the partial rows g = k mod 32 in order and the 32 sums in warp order.
Under the card's own plans of several rows a warp and more than 32 blocks
the emulation agrees, within 1e-5 * (1 + max|ref|), with the plain
twin's autograd and with vlpet_tpu/ops/fused_ln.py's _bwd_call_flat in
interpret mode.

The bf16 plain twin (``fused_dropout_add_ln`` and ``_bwd`` on CPU tensors)
is held to the Pallas kernels in interpret mode at D 768, ragged N, rate 0
and 0.1: y within 2e-2 * (1 + |jax|), the gradients within 2e-2 * (1 +
max|jax|) (the earlier route tests' rule: both round only the outputs to
bf16, and sum in other orders).

The wrappers' CUDA route, with the launcher replaced by a recorder (the
tensors lie on the CPU; ``_build.use_kernel`` is made to say CUDA): one
launch a call with the plan, counted by route; a misaligned view takes
"scalar" (ring stages 0); D > 1024 is refused before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu_torch.ops import _build
from vlpet_tpu_torch.ops import fused_ln as tln
from vlpet_tpu_torch.ops.hashdrop import keep_mask

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
F32_TOL = 1e-5
SEED = np.array([24680], np.int32)
# the paths' rows: image-text encoder (500 x 56) and decoder (500 x 10),
# video encoder (50 x 604) and decoder (50 x 10); ragged and one row
PATH_N = (28000, 5000, 30200, 500, 28001, 1, 61, 2113)
SHAPES = ((768, torch.bfloat16, True), (768, torch.bfloat16, False),
          (100, torch.bfloat16, True), (768, torch.float32, True),
          (1024, torch.bfloat16, True), (1024, torch.float32, True))


def _rows_of(plan, N):
    """The rows warp (block, warp) takes, step by step: row = block *
    warps + warp + step * blocks * warps."""
    W = plan.blocks * plan.warps
    return {(b, w): [r for r in range(b * plan.warps + w, N, W)]
            for b in range(plan.blocks) for w in range(plan.warps)}


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"D{d}-{str(t)[6:]}-{'al' if a else 'mis'}"
                              for d, t, a in SHAPES])
@pytest.mark.parametrize("N", PATH_N)
def test_ln_plan_covers_every_row_once(N, shape):
    D, dtype, aligned = shape
    plan = tln.ln_plan(N, D, dtype, aligned)
    walk = _rows_of(plan, N)
    rows = sorted(r for rs in walk.values() for r in rs)
    assert rows == list(range(N))
    counts = [len(rs) for rs in walk.values()]
    assert max(counts) == plan.rows_per_warp
    assert max(counts) - min(counts) <= 1
    per_sm = 2 if D <= 768 else 1
    assert plan.blocks <= tln.SMS * per_sm, "more than one wave"
    # a full wave (as many blocks on every SM), or one row a warp below it
    assert plan.rows_per_warp == 1 or plan.blocks % tln.SMS == 0
    assert plan.warps == tln.WARPS


def test_ln_plan_routes_and_the_bench_sites():
    bf, f32 = torch.bfloat16, torch.float32
    assert tln.ln_plan(28000, 768, bf, True)[:3] == ("vec", 8, 3)
    assert tln.ln_plan(28000, 768, f32, True)[:3] == ("vec", 4, 3)
    assert tln.ln_plan(61, 100, bf, True)[:3] == ("scalar", 1, 0)
    assert tln.ln_plan(61, 100, f32, True)[:3] == ("vec", 4, 3)  # 400 bytes
    assert tln.ln_plan(28000, 768, bf, False)[:3] == ("scalar", 1, 0)
    # one full wave of two 8-warp blocks an SM (one row a warp at N 500);
    # the backward's loads evict-first where h, res and dy outrun the L2
    for N, blocks, rows, ef in ((28000, 264, 14, True), (5000, 264, 3, False),
                                (30200, 264, 15, True), (500, 63, 1, False)):
        assert tln.ln_plan(N, 768, bf, True) == ("vec", 8, 3, blocks, 8,
                                                 rows, ef)
    assert not tln.ln_plan(28000, 768, bf, False).evict_first  # scalar
    # the backward's rings: S rows of h, res, dy a warp, within a block's
    # and the SM's shared memory; three rows at the bf16 path's D 768
    assert tln.ring(768, bf) == (3, 3 * 8 * 3 * 768 * 2)
    for D in (256, 512, 768, 1024):
        for dtype, elem in ((bf, 2), (f32, 4)):
            stages, nbytes = tln.ring(D, dtype)
            assert stages in (2, 3) and nbytes <= tln.SMEM_BLOCK
            assert nbytes == stages * 8 * 3 * 8 * -(-D // 256) * 32 * elem
            plan = tln.ln_plan(100000, D, dtype, True)
            per_sm = -(-plan.blocks // tln.SMS)
            assert per_sm * (nbytes + 1024) <= tln.SMEM_SM


@pytest.mark.parametrize("args", [(5, 1025, torch.bfloat16),
                                  (5, 0, torch.bfloat16),
                                  (5, 768, torch.float16),
                                  (0, 768, torch.bfloat16)])
def test_ln_plan_refuses(args):
    N, D, dtype = args
    with pytest.raises((ValueError, TypeError)):
        tln.ln_plan(N, D, dtype, True)


# --- the backward's fixed-order column sums --------------------------------

def _emulate_dgdb(h, res, gamma, dy, rate, plan):
    """dgamma, dbeta in csrc/fused_ln.cu's order (fp32 throughout): lanes
    over their warp's rows, the block's warps in order (a partial row a
    block), ln_col_sum's 32 warps over the partial rows g = k mod 32 in
    order, then those 32 sums in warp order."""
    N, D = h.shape
    hf = h.astype(np.float32)
    if rate > 0:
        keep = keep_mask((N, D), 0, torch.from_numpy(SEED), rate).numpy()
        hf = np.where(keep, hf * np.float32(1.0 / (1.0 - rate)),
                      np.float32(0))
    x = res.astype(np.float32) + hf
    mu = x.mean(axis=1, keepdims=True, dtype=np.float32)
    var = np.maximum((x * x).mean(axis=1, keepdims=True, dtype=np.float32)
                     - mu * mu, np.float32(0))
    xhat = (x - mu) * (np.float32(1) / np.sqrt(var + np.float32(tln.EPS)))
    terms = np.stack([dy * xhat, dy], axis=1)  # (N, 2, D)
    W = plan.blocks * plan.warps
    lanes = np.zeros((W, 2, D), np.float32)
    for step in range(plan.rows_per_warp):
        rows = np.arange(W) + step * W
        ok = rows < N
        lanes[ok] += terms[rows[ok]]
    per_block = lanes.reshape(plan.blocks, plan.warps, 2 * D)
    partial = np.zeros((plan.blocks, 2 * D), np.float32)
    for w in range(plan.warps):
        partial += per_block[:, w]
    sums = np.zeros((32, 2 * D), np.float32)
    for g in range(plan.blocks):
        sums[g % 32] += partial[g]
    out = np.zeros(2 * D, np.float32)
    for k in range(32):
        out += sums[k]
    return out[:D], out[D:]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N", [1203, 2113])
def test_fixed_order_dgdb_matches_autograd_and_pallas(N, rate):
    from vlpet_tpu.ops.fused_ln import _bwd_call_flat

    D = 768
    rng = np.random.default_rng(N + D)
    h, res, dy = (rng.normal(size=(N, D)).astype(np.float32)
                  for _ in range(3))
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    plan = tln.ln_plan(N, D, torch.float32, True)
    # several rows a warp, several partial rows a ln_col_sum warp
    assert plan.rows_per_warp > 1 and plan.blocks > 32
    got = _emulate_dgdb(h, res, gamma, dy, rate, plan)
    plain = tln.fused_dropout_add_ln_bwd(
        *map(torch.from_numpy, (h, res, gamma, SEED, dy)), rate)[2:]
    _, _, jdg, jdb = _bwd_call_flat(
        jnp.asarray(h)[None], jnp.asarray(res)[None], jnp.asarray(gamma),
        jnp.asarray(SEED), jnp.asarray(dy)[None], rate, tln.EPS,
        interpret=True)
    for g, p, j in zip(got, plain, (jdg, jdb)):
        for ref in (p.numpy(), np.asarray(j)):
            assert np.abs(g - ref).max() <= F32_TOL * (1 + np.abs(ref).max())


# --- the bf16 plain twin against the Pallas kernels ------------------------

def _bf16(x):
    """fp32 numpy -> (bf16 torch tensor, the same values as bf16 jax)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N", [37, 301])
def test_bf16_twin_matches_pallas_interpret(monkeypatch, N, rate):
    import vlpet_tpu.ops.fused_ln as jln

    monkeypatch.setattr(jln, "_INTERPRET", True)
    D = 768
    rng = np.random.default_rng(N)
    (th, jh), (tr, jr), (tdy, jdy) = (
        _bf16(rng.normal(size=(N, D)).astype(np.float32)) for _ in range(3))
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, g, be: jln.fused_dropout_add_ln(
        a, b, g, be, jnp.asarray(SEED), rate, tln.EPS),
        jh[None], jr[None], jnp.asarray(gamma), jnp.asarray(beta))
    wgrads = vjp(jdy[None])
    tg, tb, ts = map(torch.from_numpy, (gamma, beta, SEED))
    got = tln.fused_dropout_add_ln(th, tr, tg, tb, ts, rate)
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    w = np.asarray(want[0].astype(jnp.float32))
    assert np.all(np.abs(got.float().numpy() - w) <= TOL * (1 + np.abs(w)))
    bwd = tln.fused_dropout_add_ln_bwd(th, tr, tg, ts, tdy, rate)
    assert bwd[0].dtype == bwd[1].dtype == torch.bfloat16
    assert bwd[2].dtype == bwd[3].dtype == torch.float32
    for g, wg in zip(bwd, wgrads):
        wg = np.asarray(wg.astype(jnp.float32)).reshape(g.shape)
        assert np.abs(g.float().numpy() - wg).max() <= TOL * (
            1 + np.abs(wg).max())


# --- the wrappers' CUDA route, recorded -------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda *ts: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: calls.append((name, args)))
    for fn in (tln.fused_dropout_add_ln, tln.fused_dropout_add_ln_bwd):
        monkeypatch.setattr(fn, "launches_by_route", {"vec": 0, "scalar": 0})
    return calls


def _inputs(N, D, dtype, offset=0):
    base = torch.zeros(N * D + offset, dtype=dtype)
    h = base[offset:].view(N, D)
    gamma, beta = torch.ones(D), torch.zeros(D)
    return h, torch.zeros(N, D, dtype=dtype), gamma, beta, \
        torch.from_numpy(SEED)


@pytest.mark.parametrize("offset, route", [(0, "vec"), (1, "scalar")])
def test_one_launch_a_call_on_the_plan(recorder, offset, route):
    N, D = 5000, 768
    h, res, gamma, beta, seed = _inputs(N, D, torch.bfloat16, offset)
    tln.fused_dropout_add_ln(h, res, gamma, beta, seed, 0.1)
    tln.fused_dropout_add_ln_bwd(h, res, gamma, seed, res, 0.1)
    assert [c[0] for c in recorder] == ["vlpet_ln_fwd", "vlpet_ln_bwd"]
    plan = tln.ln_plan(N, D, torch.bfloat16, offset == 0)
    assert plan.route == route
    (_, fwd), (_, bwd) = recorder
    assert fwd[-3:] == (1, plan.stages, plan.blocks)  # is_bf16, the plan
    assert bwd[-4:] == (1, plan.stages, plan.blocks, int(plan.evict_first))
    assert (plan.stages == 0) == (route == "scalar")
    assert recorder[0][1][0] == h.data_ptr()  # the caller's h, no copy
    for fn in (tln.fused_dropout_add_ln, tln.fused_dropout_add_ln_bwd):
        assert fn.launches_by_route == {route: 1,
                                        ("scalar" if route == "vec"
                                         else "vec"): 0}


def test_d_over_1024_refused_before_any_launch(recorder):
    h, res, gamma, beta, seed = _inputs(3, 1025, torch.bfloat16)
    with pytest.raises(ValueError, match="1024"):
        tln.fused_dropout_add_ln(h, res, gamma, beta, seed, 0.1)
    with pytest.raises(ValueError, match="1024"):
        tln.fused_dropout_add_ln_bwd(h, res, gamma, seed, res, 0.1)
    assert recorder == []
