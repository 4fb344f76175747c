"""Dropout under the port's tensor parallelism on the CPU: a rank holding
a slice of a mask's columns draws, bit for bit, those columns of the mask
one process draws.

* ``keep_mask`` with a column base and the whole width over an (N, F/M)
  shard equals those columns of the (N, F) mask, at M 2 and 4, with and
  without a row base; ``fold_heads`` moves an attention seed so that
  H/M heads draw ``attention_keep_mask``'s heads h0 .. h0 + H/M.
* The bf16 plain twins of F1 / F2 (gelu with biases, relu without) and
  F3 / F4 (gated) at each shard's column base, a zero b2, the shards'
  outputs summed (then b2) and their dx summed, against
  vlpet_tpu/ops/ffn.py's fused_ffn / fused_gated_ffn and their jax.vjp on
  the whole width, Pallas in interpret mode over 16-row tiles, at rate
  0.1: within the route tests' 2e-2 * (1 + max|jax|); db1 the shards'
  concatenation.
* Training at every dropout 0.1 -- the tiny flagship with BART's
  attention and activation dropout and vis.sparse_sample (vqa), a tiny T5
  + VL-PET-large relu (caption) and gated at (data, model) = (1, 2) and
  (2, 2), and the flagship under the VL-PET-small, -middleX and -middleY
  gates (vqa) at (1, 2): 3 steps equal the port's one process to fp32
  round-off, which only the same masks give.

The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distributed import _batch, _dropout_cases
from test_torch_tensor_parallel import spawn_layouts
from torch_dist_ranks import run_steps
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import ffn as tffn
from vlpet_tpu_torch.ops.hashdrop import (attention_keep_mask, fold_heads,
                                          keep_mask)

torch.set_num_threads(2)  # several xdist workers share the host

TOL = 2e-2
RATE = 0.1
SEED = np.array([13579], np.int32)


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("row_base", [0, 5])
def test_keep_mask_column_shards_bit_for_bit(model_axis, row_base):
    N, F = 37, 256
    for s in (11, 2 ** 31 - 2, 987654321):
        seed = torch.tensor([s], dtype=torch.int32)
        whole = keep_mask((N, F), row_base, seed, RATE)
        f = F // model_axis
        for r in range(model_axis):
            got = keep_mask((N, f), row_base, seed, RATE, col_base=r * f,
                            width=F)
            assert torch.equal(got, whole[:, r * f:(r + 1) * f]), (s, r)
        # the defaults are the shard's own width: another mask
        assert not torch.equal(keep_mask((N, f), row_base, seed, RATE),
                               whole[:, f:2 * f])
    with pytest.raises(ValueError):
        keep_mask((N, 64), 0, 1, RATE, col_base=200, width=F)


@pytest.mark.parametrize("model_axis", [2, 4])
def test_fold_heads_draws_the_ranks_heads(model_axis):
    B, L, S, H = 3, 5, 7, 8
    for s in (11, 2 ** 31 - 2):
        seed = torch.tensor([s], dtype=torch.int32)
        whole = attention_keep_mask(B, L, S, H, seed, RATE)
        h = H // model_axis
        for r in range(model_axis):
            folded = fold_heads(seed, r * h)
            assert folded.dtype == torch.int32 and folded.shape == (1,)
            got = attention_keep_mask(B, L, S, h, folded, RATE)
            assert torch.equal(got, whole[:, r * h:(r + 1) * h]), (s, r)
    assert fold_heads(seed, 0) is seed


def _bf16(x):
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _close(got, want):
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= TOL * (1.0 + np.abs(want).max()), err.max()


def _interpret(monkeypatch):
    import vlpet_tpu.ops.ffn as jffn

    monkeypatch.setattr(jffn, "_INTERPRET", True)
    monkeypatch.setattr(jffn, "_ROW_TILE_OVERRIDE", 16)
    return jffn


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_f1_f2_column_shards_match_pallas(monkeypatch, act, model_axis):
    N, D, Fh = 37, 128, 256
    rng = np.random.default_rng(3 + (act == "relu"))
    (tx, jx), (tdy, jdy), (tw1, jw1), (tw2, jw2) = map(_bf16, (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(D, Fh)).astype(np.float32) * 0.1))
    bias = 0.1 if act == "gelu" else 0.0
    b1 = (rng.normal(size=(Fh,)) * bias).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * bias).astype(np.float32)
    jffn = _interpret(monkeypatch)
    y, vjp = jax.vjp(lambda a, c1: jffn.fused_ffn(
        a, jw1.T, c1, jw2.T, jnp.asarray(b2), act, RATE, jnp.asarray(SEED)),
        jx, jnp.asarray(b1))
    want_dx, want_db1 = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdy)]
    seed, f = torch.from_numpy(SEED), Fh // model_axis
    tb1, zero = torch.from_numpy(b1), torch.zeros(D)
    ys, dxs, db1s = [], [], []
    for r in range(model_axis):
        c = slice(r * f, (r + 1) * f)
        cols = dict(col_base=r * f, width=Fh)
        w1, w2 = tw1[c].contiguous(), tw2[:, c].contiguous()
        ys.append(tffn.fused_ffn(tx, w1, tb1[c], w2, zero, act, RATE, seed,
                                 **cols).float())
        dx, db1, _ = tffn.fused_ffn_bwd(tx, tdy, w1, tb1[c], w2, act, RATE,
                                        seed, **cols)
        dxs.append(dx.float())
        db1s.append(db1)
    _close(sum(ys) + torch.from_numpy(b2), np.asarray(y.astype(jnp.float32)))
    _close(sum(dxs), want_dx)
    _close(torch.cat(db1s), want_db1)


@pytest.mark.parametrize("model_axis", [2, 4])
def test_f3_f4_column_shards_match_pallas(monkeypatch, model_axis):
    N, D, Fh = 37, 128, 256
    rng = np.random.default_rng(5)
    (tx, jx), (tdy, jdy), (tw0, jw0), (tw1, jw1), (two, jwo) = map(_bf16, (
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(N, D)).astype(np.float32),
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(Fh, D)).astype(np.float32) * 0.1,
        rng.normal(size=(D, Fh)).astype(np.float32) * 0.1))
    jffn = _interpret(monkeypatch)
    y, vjp = jax.vjp(lambda a: jffn.fused_gated_ffn(
        a, jw0.T, jw1.T, jwo.T, "gelu_new", RATE, jnp.asarray(SEED)), jx)
    (want_dx,) = vjp(jdy)
    seed, f = torch.from_numpy(SEED), Fh // model_axis
    ys, dxs = [], []
    for r in range(model_axis):
        c = slice(r * f, (r + 1) * f)
        cols = dict(col_base=r * f, width=Fh)
        w0, w1 = tw0[c].contiguous(), tw1[c].contiguous()
        wo = two[:, c].contiguous()
        ys.append(tffn.fused_gated_ffn(tx, w0, w1, wo, "gelu_new", RATE,
                                       seed, **cols).float())
        dxs.append(tffn.fused_gated_ffn_bwd(tx, tdy, w0, w1, wo, "gelu_new",
                                            RATE, seed, **cols).float())
    _close(sum(ys), np.asarray(y.astype(jnp.float32)))
    _close(sum(dxs), np.asarray(want_dx.astype(jnp.float32)))


GATES = ("small", "middleX", "middleY")


def _cases():
    """The flagship with every BART dropout and sparse_sample (vqa), the
    tiny T5 at 0.1 (caption), that T5 gated / untied, and the flagship
    under each of GATES (vqa)."""
    bart, t5 = _dropout_cases()[:2]
    cfg = t5["cfg"]
    gated = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False))
    model = VLT5(gated, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    cases = [bart, t5, dict(t5, cfg=gated, state=model.state_dict(),
                            batch=_batch(128, 4, 32, seed=4))]
    for i, variant in enumerate(GATES):
        gcfg = dataclasses.replace(bart["cfg"], pet=pc.vlpet_recipe(
            variant, r=16, num_heads=4, gate_dim=16,
            tasks=bart["cfg"].pet.tasks))
        gmodel = VLBart(gcfg, device="cpu").init_weights(
            torch.Generator().manual_seed(i))
        cases.append(dict(bart, cfg=gcfg, state=gmodel.state_dict(),
                          batch=_batch(128, 7, 32, seed=5 + i)))
    return cases


@pytest.fixture(scope="module")
def dropout_runs():
    """Every case at (1, 2); the first three also at (2, 2), spawned at
    the same time."""
    cases = _cases()
    with ThreadPoolExecutor(2) as pool:
        wide = pool.submit(spawn_layouts, cases[:3], [(2, 2)])
        ranks = spawn_layouts(cases, [(1, 2)])
        ranks.update(wide.result())
    return cases, ranks


@pytest.mark.parametrize("i,label,layout", [
    (i, label, layout) for i, label in enumerate(("bart_sparse", "t5",
                                                  "t5_gated"))
    for layout in ((1, 2), (2, 2))]
    + [(3 + j, g, (1, 2)) for j, g in enumerate(GATES)],
    ids=lambda x: x if isinstance(x, str) else
    (f"{x[0]}x{x[1]}" if isinstance(x, tuple) else str(x)))
def test_dropout_tp_equals_one_process(dropout_runs, i, label, layout):
    cases, ranks = dropout_runs
    want = run_steps(**cases[i])  # one process, the whole batch
    got = ranks[layout][0]["train"][i]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    for name, w in want["params"].items():
        np.testing.assert_allclose(
            got["params"][name].numpy(), w.numpy(), rtol=1e-4,
            atol=max(1e-8, 1e-6 * w.abs().max().item()), err_msg=name)
    for other in ranks[layout][1:]:
        for name, p in got["params"].items():
            assert torch.equal(other["train"][i]["params"][name], p), name
