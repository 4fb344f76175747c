"""The port's data-parallel training step on the CPU: ranks spawned over
gloo (vlpet_tpu_torch.parallel.launch.run_ranks), each on its contiguous
share of one global batch, held to one process on the whole batch.

* Against the JAX step: the tiny flagship (BART + VL-PET-large,
  __graft_entry__._flagship_cfg(tiny=True)), dropout 0, fp32, global batch
  8, K = 3 steps of make_train_step + build_optimizer at world 2 and 4 --
  vqa, and caption with unequal valid-token counts across the ranks (a
  mean of the ranks' means misses the global token mean, which the test
  checks first). The weights are the port's seeded init, carried to the
  JAX model in the npz export's flax layout. Per step the loss and the gradient norm within 1e-5
  relative, the trainable tensors at the end within the lockstep's rtol
  1e-3, atol 1e-5 * max|p| (tests/test_torch_train.py), every rank
  holding the same tensors bit for bit.
* Against the port's own one process, at dropout 0.1: the flagship with
  attention and activation dropout 0.1 and vis.sparse_sample (7 visual
  tokens subsampled to 4), vqa; a tiny T5 + VL-PET-large at dropout 0.1,
  caption; the flagship with 2 accumulation steps, caption. World 2
  equals world 1 to fp32 round-off, which only the same masks and the
  same sparse_sample draws give. The fold itself is held
  bit for bit: a rank's seed folded by ``fold_seed`` draws the mask of
  its rows of the global batch at every site shape (a (B, L, D)
  activation, the attention's (B, H, L, S) probabilities, the FFN's
  (B * L, F) hidden).

The ranks (tests/torch_dist_ranks.py) import no JAX; this process
computes the JAX references. Each spawn has its own time limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from test_torch_gates import port_cfg
from torch_dist_ranks import run_steps, share, to_torch, train_ranks
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_leaves, flax_to_state_dict
from vlpet_tpu_torch.models.heads import task_loss
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops.hashdrop import (attention_keep_mask, fold_seed,
                                          keep_mask)
from vlpet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
B, L_TXT, L_TGT = 8, 6, 5
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
SPAWN_TIMEOUT_S = 120


def _batch(V, n_vis, feat_dim, seed=0):
    """The global batch: padded text, and targets whose valid-token count
    falls by one every two examples (so every world's ranks hold unequal
    counts)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, L_TXT - 2:] = 0
    targets = rng.integers(3, V, (B, L_TGT)).astype(np.int32)
    for i in range(B):
        targets[i, L_TGT - i // 2:] = -100
    return dict(input_ids=rng.integers(3, V, (B, L_TXT)).astype(np.int32),
                attention_mask=mask,
                vis_feats=rng.normal(size=(B, n_vis, feat_dim)).astype(
                    np.float32),
                boxes=rng.uniform(size=(B, n_vis, 4)).astype(np.float32),
                target_ids=targets,
                scores=rng.uniform(0.3, 1.0, B).astype(np.float32))


def _jax_run(jcfg, tasks, params, batch, task):
    jmodel = JVLBart(jcfg)
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    step = jmake_step(jmodel, tx, tasks)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(K):
        state, metrics = step(state, frozen, jbatch, jax.random.PRNGKey(0),
                              tasks.index(task))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": flax_to_state_dict(jax.device_get(state.params))}


def _flax_tree(model):
    """The model's parameters as the JAX model's flax tree
    (convert.flax_leaves, the npz export's layout)."""
    tree = {}
    for name, t in model.named_parameters():
        for path, a in flax_leaves(name, t.detach()):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
    return tree


def _with_backbone(cfg, **kw):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, **kw))


@pytest.fixture(scope="module")
def flagship():
    """The dropout-0 cases: config, weights, batch and the JAX runs."""
    jcfg, tasks = _flagship_cfg(tiny=True)
    jcfg = _with_backbone(jcfg, dropout=0.0)
    batch = _batch(jcfg.backbone.vocab_size, jcfg.vis.n_boxes,
                   jcfg.vis.feat_dim)
    cfg = port_cfg(jcfg)
    model = VLBart(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    params = _flax_tree(model)  # the port's seeded init, in flax's layout
    state = model.state_dict()
    cases = [dict(cfg=cfg, state=state, batch=batch, tasks=tasks, task=t,
                  steps=K, opt=OPT) for t in ("vqa", "caption")]
    want = {t: _jax_run(jcfg, tasks, params, batch, t)
            for t in ("vqa", "caption")}
    return cases, want


def _dropout_cases():
    """The dropout-0.1 cases: the flagship with every BART dropout and
    vis.sparse_sample on vqa; a tiny T5 + VL-PET-large on caption; the
    flagship again on caption with gradient accumulation over 2 steps
    (each micro-batch summed over the ranks before it joins the mean)."""
    jcfg, tasks = _flagship_cfg(tiny=True)
    cfg = _with_backbone(port_cfg(jcfg), dropout=0.1, attention_dropout=0.1,
                         activation_dropout=0.1)
    cfg = dataclasses.replace(cfg, vis=dataclasses.replace(
        cfg.vis, sparse_sample=True))
    bart = VLBart(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    t5cfg = pc.VLModelConfig(
        backbone=pc.T5Config(vocab_size=128, d_model=32, num_layers=2,
                             num_decoder_layers=2, num_heads=4, d_kv=8,
                             d_ff=64, dropout_rate=0.1),
        vis=pc.VisConfig(feat_dim=32, n_boxes=4),
        pet=pc.vlpet_recipe("large", r=16, num_heads=4, gate_dim=16,
                            tasks=tasks))
    t5 = VLT5(t5cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    return [dict(cfg=cfg, state=bart.state_dict(),
                 batch=_batch(128, 7, 32, seed=1), tasks=tasks, task="vqa",
                 steps=K, opt=OPT),
            dict(cfg=t5cfg, state=t5.state_dict(),
                 batch=_batch(128, 4, 32, seed=2), tasks=tasks,
                 task="caption", steps=K, opt=OPT),
            dict(cfg=cfg, state=bart.state_dict(),
                 batch=_batch(128, 7, 32, seed=3), tasks=tasks,
                 task="caption", steps=4, opt=OPT, accumulation=2)]


@pytest.fixture(scope="module")
def ranks(flagship):
    """The ranks' results by world size: world 2 runs the two dropout-0
    cases, then the two dropout-0.1 cases; world 4 the dropout-0 cases."""
    cases, _ = flagship
    dropout = _dropout_cases()
    got = {2: run_ranks(train_ranks, 2, cases + dropout,
                        timeout=SPAWN_TIMEOUT_S),
           4: run_ranks(train_ranks, 4, cases, timeout=SPAWN_TIMEOUT_S)}
    return got, dropout


def _close(got, want, rtol, atol_scale):
    for name, w in want["params"].items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got["params"][name].numpy(), w, rtol=rtol,
            atol=max(1e-8, atol_scale * np.abs(w).max()), err_msg=name)


def test_caption_batch_tells_rank_means_apart(flagship):
    """At every world size the caption batch's ranks hold unequal token
    counts, so the mean of the ranks' token means misses the global one
    by ten times the step test's loss tolerance (1e-5) and more: the
    step must use the global count."""
    cases, _ = flagship
    case = cases[1]
    model = VLBart(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    t = to_torch(case["batch"])
    with torch.no_grad():
        per_token = model(t["input_ids"], t["attention_mask"], t["vis_feats"],
                          t["boxes"], labels=t["target_ids"])["loss"]
    whole = float(task_loss("caption", per_token, t["target_ids"]))
    for world in (2, 4):
        b = B // world
        means = [float(task_loss("caption", per_token[r * b:(r + 1) * b],
                                 t["target_ids"][r * b:(r + 1) * b]))
                 for r in range(world)]
        assert abs(np.mean(means) - whole) > 1e-4 * abs(whole), world


@pytest.mark.parametrize("world,task", [(2, "vqa"), (2, "caption"),
                                        (4, "vqa"), (4, "caption")])
def test_data_parallel_step_matches_jax(flagship, ranks, world, task):
    cases, want = flagship
    res = ranks[0][world]
    i = ("vqa", "caption").index(task)
    got = res[0][i]
    np.testing.assert_allclose(got["losses"], want[task]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want[task]["norms"], rtol=1e-5)
    _close(got, want[task], rtol=1e-3, atol_scale=1e-5)
    for other in res[1:]:  # every rank holds the same state
        assert other[i]["losses"] == got["losses"]
        for name, p in got["params"].items():
            assert torch.equal(other[i]["params"][name], p), name


@pytest.mark.parametrize("i,label", [(0, "bart_sparse"), (1, "t5"),
                                     (2, "bart_accumulation")])
def test_dropout_world2_equals_world1(ranks, i, label):
    got, dropout = ranks
    case = dropout[i]
    want = run_steps(**case)  # one process, the whole batch
    world2 = got[2][0][2 + i]
    np.testing.assert_allclose(world2["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(world2["norms"], want["norms"], rtol=1e-5)
    _close(world2, want, rtol=1e-4, atol_scale=1e-6)
    # the masks follow the examples' positions: the reversed batch's
    # first loss is far off
    other = run_steps(**{**case, "steps": 1,
                         "batch": {k: v[::-1].copy()
                                   for k, v in case["batch"].items()}})
    assert abs(other["losses"][0] - want["losses"][0]) > 1e-4


@pytest.mark.parametrize("site", ["activation", "attention", "ffn_hidden"])
def test_fold_seed_draws_the_ranks_rows(site):
    """Rank r of a world-4 batch of 8, its seed folded by its first
    example times the site's elements per example, draws bit for bit the
    global mask's rows of its examples (keep_mask with row_base, the
    kernels' hash over the global flat index)."""
    Bg, L, S, D, H, F = 8, 5, 7, 12, 3, 20
    world, b = 4, 2
    for s in (11, 2 ** 31 - 2, 987654321):
        seed = torch.tensor([s], dtype=torch.int32)
        for r in range(world):
            base = r * b
            if site == "activation":
                want = keep_mask((Bg, L, D), 0, seed, 0.1)[base:base + b]
                got = keep_mask((b, L, D), 0, fold_seed(seed, base * L * D),
                                0.1)
                rows = keep_mask((b * L, D), base * L, seed, 0.1)
                assert torch.equal(got.reshape(b * L, D), rows)
            elif site == "attention":
                want = attention_keep_mask(Bg, L, S, H, seed,
                                           0.1)[base:base + b]
                got = attention_keep_mask(b, L, S, H,
                                          fold_seed(seed, base * L * S), 0.1)
            else:
                want = keep_mask((Bg * L, F), 0, seed, 0.1)[
                    base * L:(base + b) * L]
                got = keep_mask((b * L, F), 0, fold_seed(seed, base * L * F),
                                0.1)
            assert got.dtype == torch.bool and torch.equal(got, want), (s, r)
        assert torch.equal(fold_seed(seed, 0), seed)


def test_fold_seed_keeps_int32_bit_patterns():
    """A folded seed is a (1,) int32 whose uint32 is seed + o * 2654435761
    mod 2**32: negative int32 values carry the high half, as the kernels
    read them."""
    seed = torch.tensor([2 ** 31 - 2], dtype=torch.int32)
    for o in (1, 3, 1000, 2 ** 20 + 7):
        got = fold_seed(seed, o)
        assert got.shape == (1,) and got.dtype == torch.int32
        want = (2 ** 31 - 2 + o * 2654435761) % 2 ** 32
        assert int(got) & 0xFFFFFFFF == want
    assert share({"input_ids": np.arange(8)}, 3, 4)["input_ids"].tolist() \
        == [6, 7]
