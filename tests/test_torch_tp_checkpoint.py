"""Checkpoints and LAST.npz under the port's tensor parallelism on the
CPU: four ranks spawned over gloo run the Trainer (a tiny BART +
VL-PET-large, tests/torch_dist_ranks.py ``tiny_trainer``) under two
layouts in turn.

* At (data, model) = (2, 2): the sharded beam-5 caption and greedy vqa
  ``predict`` and ``predict_nlvr`` merged from model index 0 of each data
  group -- every answer once, the tokens and the evaluators' scores those
  of one process; then one caption epoch (batch 2 a data shard),
  checkpointed by rank 0, with LAST.npz gathered to whole tensors.
* At (1, 4): every rank restores that checkpoint (its tensors are all
  replicated), loads LAST.npz into its shards, and the second epoch (batch
  4) ends where an uninterrupted one-process run of two epochs ends (fp32
  round-off: the same global batches), every rank bit for bit.
* LAST.npz written under a model axis of 2 loads into the JAX package
  (vlpet_tpu/train/checkpoint.py load_params_npz) leaf for leaf: the
  frozen backbone whole, equal to one process's seeded init, the
  trainable tensors the ranks'.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_ranks import (evaluate_all, tiny_trainer, tp_checkpoint_ranks,
                              train_caption)
from vlpet_tpu import config as jc
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train import checkpoint as jckpt
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)  # several xdist workers share the host

SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_ckpt"))
    saved = run_ranks(tp_checkpoint_ranks, 4, out, 2, "save",
                      timeout=SPAWN_TIMEOUT_S)
    last = dict(np.load(os.path.join(out, "LAST.npz")))
    resumed = run_ranks(tp_checkpoint_ranks, 4, out, 4, "resume",
                        timeout=SPAWN_TIMEOUT_S)
    return out, saved, last, resumed


def test_sharded_eval_merges_each_data_shard_once(runs):
    _, saved, _, _ = runs
    one = evaluate_all(tiny_trainer())
    for r in saved:
        got = r["eval"]
        for task in ("caption", "vqa"):
            assert got[task]["quesid2ans"] == one[task]["quesid2ans"]
            assert len(got[task]["predictions"]) == 7
            assert got["scores"][task] == one["scores"][task]
        assert got["nlvr"] == one["nlvr"]


def test_checkpoint_at_2x2_resumes_at_1x4(runs, tmp_path):
    out, saved, _, resumed = runs
    assert [r["layout"] for r in saved] == [(2, 2)] * 4
    assert [r["layout"] for r in resumed] == [(1, 4)] * 4
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["4.pt", "8.pt"]
    straight = tiny_trainer(output_dir=str(tmp_path), lr=1e-2, total_steps=8)
    want = train_caption(straight, epochs=2, batch_size=4)
    n_params = len(list(straight.model.parameters()))
    for r in resumed:
        assert r["restored"] == 4 and r["step"] == 8
        assert r["npz_loaded"] == n_params
        for name, w in want.items():
            torch.testing.assert_close(r["params"][name], w, rtol=1e-5,
                                       atol=1e-6)
            assert torch.equal(r["params"][name],
                               resumed[0]["params"][name]), name
    whole = {n: tuple(p.shape) for n, p in straight.model.named_parameters()}
    for n, shape in resumed[1]["shapes"].items():
        frac = 4 if n.endswith(("q_proj.weight", "fc2.weight")) else None
        if frac:
            assert np.prod(shape) * frac == np.prod(whole[n]), n


def test_last_npz_of_a_split_run_loads_into_jax(runs):
    _, saved, last, _ = runs
    one = tiny_trainer()
    cfg = one.cfg
    d = dataclasses.asdict(cfg)
    jcfg = jc.VLModelConfig(backbone=jc.BartConfig(**d.pop("backbone")),
                            vis=jc.VisConfig(**d.pop("vis")),
                            pet=jc.PetConfig(**d.pop("pet")), **d)
    ids = jnp.ones((2, 4), jnp.int32)
    shapes = jax.eval_shape(lambda: JVLBart(jcfg).init(
        jax.random.PRNGKey(0), ids, ids, vis_feats=jnp.ones((2, 4, 16)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=JCtx())["params"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    path = os.path.join(runs[0], "split.npz")
    np.savez(path, **last)
    loaded, n = jckpt.load_params_npz(path, zeros)
    assert n == len(jax.tree_util.tree_leaves(zeros)) == len(last)
    got = flax_to_state_dict(jax.device_get(loaded))
    trained = saved[0]["params"]
    for name, p in one.model.named_parameters():
        want = trained.get(name, p.detach())
        torch.testing.assert_close(got[name], want, rtol=0, atol=0)
