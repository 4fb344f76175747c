"""Split trainable tensors under the port's tensor parallelism on the CPU,
against the JAX package (rule 2 of vlpet_tpu_torch/parallel/mesh.py):
BitFit (``unfreeze_bias``: the q/k/v and fc1 biases train as the rank's
shards) and full fine-tuning (``unfreeze_language_model``: every split
weight trains as its shard, F1 / F2 off as in one process), with a clip
norm small enough that the clip bites on every step, so a norm that
missed the other ranks' squares would change the update.

* BitFit and full fine-tuning on the tiny BART of
  tests/test_torch_pet_recipes.py (d 32, 2+2 layers, 4 heads, FFN 64;
  fp32, dropout 0) at (data, model) = (1, 2), (2, 2) and (1, 4), and
  BitFit on the tiny T5 (its trainable relative bias sliced to the
  rank's heads) at (1, 2): 3 vqa steps against the JAX make_train_step on
  the whole batch -- loss and gradient norm within 1e-5 relative a step
  (the JAX norm above the clip every step), the trainable tensors,
  gathered whole, within rtol 1e-3, atol 1e-5 max|p|, every rank bit for
  bit, each split trainable 1/M of its whole on the rank.
* Checkpoints: the Trainer (tests/torch_dist_ranks.py ``tiny_trainer``
  with BitFit and a biting clip) trains one caption epoch at (2, 2); its
  checkpoint, whose split biases, Adam moments and gradients were
  gathered whole, resumes at (1, 4) and in one process, and both end the
  second epoch where an uninterrupted one-process run ends, the ranks'
  state digests equal; LAST.npz holds whole tensors.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_decoder_prompt import t5_cfg
from test_torch_pet_recipes import recipe_cfg
from test_torch_tp_pet import LAYOUTS, check_family, families_run
from torch_dist_ranks import (EVAL_TASKS, tiny_trainer, tp_checkpoint_ranks,
                              train_caption)
from vlpet_tpu_torch.config import PetConfig
from vlpet_tpu_torch.parallel.launch import run_ranks
from vlpet_tpu_torch.parallel.mesh import param_plan, split_plan
from vlpet_tpu_torch.train.checkpoint import load_params_npz

torch.set_num_threads(2)  # several xdist workers share the host

CLIP = 0.05  # below every step's gradient norm: the clip bites
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1, clip_grad_norm=CLIP)
FAMILIES = {
    "bitfit": (lambda: recipe_cfg("bitfit"), LAYOUTS, False),
    "full_finetuning": (lambda: recipe_cfg("full_finetuning"), LAYOUTS,
                        False),
    "bitfit_t5": (lambda: t5_cfg(["--unfreeze_bias"]), LAYOUTS[:1], False),
}
SPAWN_TIMEOUT_S = 150
BITFIT = PetConfig(unfreeze_bias=True, tasks=EVAL_TASKS)


@pytest.fixture(scope="module")
def trainable_run():
    return families_run(FAMILIES, opt=OPT)


@pytest.mark.parametrize("name,layout", [
    (n, lay) for n, (_, lays, _) in FAMILIES.items() for lay in lays],
    ids=lambda x: x if isinstance(x, str) else f"{x[0]}x{x[1]}")
def test_tp_split_trainables_match_jax(trainable_run, name, layout):
    want, _, ports, names, _, ranks = trainable_run
    assert min(want[name][1]) > CLIP  # the clip bites on every step
    check_family(trainable_run, name, layout)
    port, M = ports[name], layout[1]
    plan = split_plan(port, M)
    split = [n for n in want[name][2] if n in plan]
    if name.endswith("_t5"):  # T5's biases: the relative bias, whole
        assert any("relative_attention_bias" in n for n in want[name][2])
    else:
        assert split  # some trainable tensor is split
    for r in ranks[layout]:
        local = r["train"][names[layout].index(name)]["local"]
        for n in split:
            assert np.prod(local[n]) * M == port.get_parameter(n).numel(), n


def test_full_finetuning_trains_every_split_family(trainable_run):
    _, _, ports, _, _, _ = trainable_run
    plan = split_plan(ports["full_finetuning"], 2)
    for fam in ("q_proj.weight", "k_proj.bias", "out_proj.weight",
                "fc1.weight", "fc1.bias", "fc2.weight"):
        assert any(n.endswith(fam) for n in plan), fam
    reasons = {why for _, _, why in param_plan(ports["full_finetuning"], 2)}
    assert reasons == {"split, trains", "whole by design"}


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_bitfit_ckpt"))
    saved = run_ranks(tp_checkpoint_ranks, 4, out, 2, "save", BITFIT, CLIP,
                      timeout=SPAWN_TIMEOUT_S)
    one_dir = out + "_one"
    shutil.copytree(out, one_dir)
    last = dict(np.load(os.path.join(out, "LAST.npz")))
    resumed = run_ranks(tp_checkpoint_ranks, 4, out, 4, "resume", BITFIT,
                        CLIP, timeout=SPAWN_TIMEOUT_S)
    return out, one_dir, saved, last, resumed


def test_bitfit_checkpoint_at_2x2_resumes_at_1x4_and_one_process(
        ckpt_runs, tmp_path):
    out, one_dir, saved, last, resumed = ckpt_runs
    assert [r["layout"] for r in saved] == [(2, 2)] * 4
    assert [r["layout"] for r in resumed] == [(1, 4)] * 4
    straight = tiny_trainer(output_dir=str(tmp_path), lr=1e-2, total_steps=8,
                            pet=BITFIT, clip_grad_norm=CLIP)
    want = train_caption(straight, epochs=2, batch_size=4)
    one = tiny_trainer(output_dir=one_dir, lr=1e-2, total_steps=8,
                       pet=BITFIT, clip_grad_norm=CLIP)
    assert one.restore() == 4
    got_one = train_caption(one, epochs=2, batch_size=4)
    plan = split_plan(straight.model, 2)
    assert any(n in plan for n in want)  # split biases train
    for r in resumed:
        assert r["restored"] == 4 and r["step"] == 8
        assert r["digest"] == resumed[0]["digest"]
        for name, w in want.items():
            torch.testing.assert_close(r["params"][name], w, rtol=1e-5,
                                       atol=1e-6)
            assert torch.equal(r["params"][name],
                               resumed[0]["params"][name]), name
    for name, w in want.items():
        torch.testing.assert_close(got_one[name], w, rtol=1e-5, atol=1e-6)
    # LAST.npz of the (2, 2) run: whole tensors, the ranks' trained ones
    path = os.path.join(str(tmp_path), "split.npz")
    np.savez(path, **last)
    fresh = tiny_trainer(pet=BITFIT)
    _, n = load_params_npz(path, fresh.model)
    assert n == len(list(fresh.model.parameters()))
    for name, t in saved[0]["params"].items():
        assert torch.equal(fresh.model.get_parameter(name).detach(), t), name
