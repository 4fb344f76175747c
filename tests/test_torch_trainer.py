"""The port's Trainer and checkpoints against the JAX package's, on CPU.

A tiny BART (d 32, 1+1 layers, vocab 256) with VL-PET-small at r 8, two
tasks (vqa and caption), fp32, dropout 0.0, the WhitespaceTokenizer at 256
words; 16 synthetic examples a task, batch 8 (the JAX Trainer's 8 CPU
devices then take whole batches, no wrap-around padding).

* Lockstep: the JAX Trainer and the port's start from the same weights
  (the JAX init carried by vlpet_tpu_torch.convert) and take the same
  batches through ``do_train_step`` for two epochs of the round-robin
  loader: per-step losses within 1e-5 relative, the trainable tensors at
  the end within rtol 1e-3, atol 1e-5 * max|p|, with
  ``gradient_accumulation_steps`` 1 and 2 (optax.MultiSteps on the JAX
  side).
* Then ``predict`` (greedy vqa, beam-5 caption) gives identical strings and
  ``evaluate`` identical scores.
* Checkpoints: ``save`` / ``restore`` resumes to the state, bit for bit
  (``state_digest``), of an uninterrupted run -- at dropout 0.1 (the
  generator state) and mid-accumulation; ``train`` restored after its first
  epoch ends where an uninterrupted ``train`` ends.
* The npz export and import round-trip in both directions with
  vlpet_tpu/train/checkpoint.py ``save_params_npz`` / ``load_params_npz``,
  strict=False: a tensor of another shape or name is left and not counted.
"""

import jax
import numpy as np
import pytest
import torch

from vlpet_tpu.config import BartConfig, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.data import datasets as jds
from vlpet_tpu.data.multitask import MultitaskLoader as JMultitaskLoader
from vlpet_tpu.data.tokenization import WhitespaceTokenizer
from vlpet_tpu.train import checkpoint as jckpt
from vlpet_tpu.train.trainer import Trainer as JTrainer
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.data import datasets as tds
from vlpet_tpu_torch.data.multitask import MultitaskLoader
from vlpet_tpu_torch.evalsuite import COCOCaptionEvaluator, VQAEvaluator
from vlpet_tpu_torch.train import checkpoint as tckpt
from vlpet_tpu_torch.train.trainer import Trainer

from test_torch_gates import port_cfg

torch.set_num_threads(2)  # several xdist workers share the host

TASKS = ("vqa", "caption")
BS = 8
OPT = dict(lr=1e-2, total_steps=8, warmup_ratio=0.1)


def _jcfg(dropout=0.0):
    return VLModelConfig(
        backbone=BartConfig(vocab_size=256, d_model=32, encoder_layers=1,
                            decoder_layers=1, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=64,
                            decoder_ffn_dim=64, max_position_embeddings=64,
                            dropout=dropout),
        vis=VisConfig(feat_dim=8, n_boxes=4),
        pet=vlpet_recipe("small", r=8, num_heads=4, gate_dim=8, tasks=TASKS))


def _loaders(ds_mod, tok, mode):
    out = []
    for task in TASKS:
        examples, source = ds_mod.synthetic_task_data(task, 16, n_boxes=4,
                                                      feat_dim=8, seed=0)
        cfg = ds_mod.DatasetConfig(task=task, max_text_length=12,
                                   gen_max_length=6, n_boxes=4, feat_dim=8,
                                   prompt=ds_mod.TASK_PROMPTS[task])
        ds = ds_mod.TaskDataset(cfg, examples, source, tok, mode=mode, seed=0)
        ev = (VQAEvaluator({e["question_id"]: e for e in examples})
              if task == "vqa" else COCOCaptionEvaluator())
        out.append(ds_mod.Loader(ds, BS, shuffle=mode == "train",
                                 drop_last=mode == "train", evaluator=ev,
                                 prefetch=0))
    return out


def _port_trainer(jcfg, tok, accum=1, output_dir=None, **kw):
    return Trainer(port_cfg(jcfg), TASKS, **OPT, seed=5, tokenizer=tok,
                   gradient_accumulation_steps=accum, output_dir=output_dir,
                   verbose=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def tok():
    return WhitespaceTokenizer(vocab_size=256)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_lockstep_predict_and_evaluate_match_jax(tok, accum):
    jcfg = _jcfg()
    jt = JTrainer(jcfg, TASKS, **OPT, seed=5, tokenizer=tok, verbose=False,
                  gradient_accumulation_steps=accum)
    tt = _port_trainer(jcfg, tok, accum)
    load_flax_params(tt.model, jax.device_get(jt.merged_params))
    jmt = JMultitaskLoader(_loaders(jds, tok, "train"))
    tmt = MultitaskLoader(_loaders(tds, tok, "train"))
    jl, tl = [], []
    for epoch in range(2):
        jmt.set_epoch(epoch)
        tmt.set_epoch(epoch)
        for jb, tb in zip(jmt, tmt):
            jl.append(float(jt.do_train_step(jb)["loss"]))
            tl.append(float(tt.do_train_step(tb)["loss"]))
    assert len(tl) == 8 and tt.step == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jt.state.params))
    assert set(want) == set(tt.trainable)
    for name, p in tt.trainable.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-3,
                                   atol=max(1e-8, 1e-5 * np.abs(w).max()),
                                   err_msg=name)
    # from the same weights, predictions and scores are identical
    load_flax_params(tt.model, jax.device_get(jt.merged_params))
    for jloader, tloader in zip(_loaders(jds, tok, "val"),
                                _loaders(tds, tok, "val")):
        beams = 5 if jloader.task == "caption" else 1
        jp = jt.predict(jloader, num_beams=beams, max_length=6)
        tp = tt.predict(tloader, num_beams=beams, max_length=6)
        assert tp == jp
        assert (tt.evaluate(tloader, max_length=6)
                == jt.evaluate(jloader, max_length=6))


def _batches(tok):
    mt = MultitaskLoader(_loaders(tds, tok, "train"))
    return list(mt)


@pytest.mark.parametrize("accum,cut", [(1, 2), (2, 3)])
def test_save_restore_resumes_bit_for_bit(tok, tmp_path, accum, cut):
    jcfg = _jcfg(dropout=0.1)
    batches = _batches(tok)
    full = _port_trainer(jcfg, tok, accum)
    for b in batches:
        full.do_train_step(b)

    first = _port_trainer(jcfg, tok, accum, output_dir=str(tmp_path))
    for b in batches[:cut]:
        first.do_train_step(b)
    first.save(first.step)
    digest = first.state_digest()
    second = _port_trainer(jcfg, tok, accum, output_dir=str(tmp_path))
    assert second.state_digest() != digest
    assert second.restore() == cut
    assert second.state_digest() == digest
    for b in batches[cut:]:
        second.do_train_step(b)
    assert second.state_digest() == full.state_digest()


def test_train_resumes_after_an_epoch(tok, tmp_path):
    jcfg = _jcfg(dropout=0.1)
    full = _port_trainer(jcfg, tok, output_dir=str(tmp_path / "full"))
    hist = full.train(MultitaskLoader(_loaders(tds, tok, "train")), 2,
                      log_every=3)
    assert sorted(hist) == [0, 1] and hist[1]["train_steps"] == 4

    run = str(tmp_path / "cut")
    _port_trainer(jcfg, tok, output_dir=run).train(
        MultitaskLoader(_loaders(tds, tok, "train")), 1)
    resumed = _port_trainer(jcfg, tok, output_dir=run)
    assert resumed.restore() == 4
    hist = resumed.train(MultitaskLoader(_loaders(tds, tok, "train")), 2)
    assert sorted(hist) == [1]
    assert resumed.state_digest() == full.state_digest()
    assert tckpt.CheckpointManager(run + "/ckpt").all_steps() == [4, 8]


def test_npz_round_trips_with_the_jax_format(tok, tmp_path):
    jcfg = _jcfg()
    jt = JTrainer(jcfg, TASKS, **OPT, seed=5, tokenizer=tok, verbose=False)
    params = jax.device_get(jt.merged_params)
    n_leaves = len(jax.tree_util.tree_leaves(params))

    # JAX export -> port import: every tensor, equal
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(params, jpath)
    tt = _port_trainer(jcfg, tok)
    _, n = tckpt.load_params_npz(jpath, tt.model)
    assert n == n_leaves
    want = flax_to_state_dict(params)
    for name, p in tt.model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=0)

    # port export -> JAX import: every leaf, equal
    tt2 = _port_trainer(jcfg, tok)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_params_npz(tt2.named_weights(), tpath)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    loaded, n = jckpt.load_params_npz(tpath, zeros)
    assert n == n_leaves
    got = flax_to_state_dict(jax.device_get(loaded))
    for name, p in tt2.model.named_parameters():
        torch.testing.assert_close(got[name], p.detach(), rtol=0, atol=0)

    # strict=False: a renamed key and a reshaped array are skipped
    data = dict(np.load(tpath))
    key = next(k for k in data if k.endswith("fc1/kernel"))
    data[key] = data[key][:, :-1]
    data["model/no_such_module/kernel"] = np.zeros((2, 2), np.float32)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **data)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    _, n = tckpt.load_params_npz(bad, tt.model)
    assert n == n_leaves - 1
    name = key.replace("/", ".").replace("kernel", "weight")
    assert torch.equal(dict(tt.model.named_parameters())[name], before[name])
