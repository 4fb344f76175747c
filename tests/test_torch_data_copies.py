"""The port's copies of the JAX package's framework-free modules against
the originals, on CPU: same inputs, equal outputs.

* tokenizers: the WhitespaceTokenizer fallback and the T5 sentencepiece
  tokenizer on tests/fixtures/tiny_spiece.model (encode, __call__,
  batch_decode, the vocabulary size the model gets);
* the synthetic datasets of the four image-text tasks and their collated
  batches, array for array, through the shuffling Loader and the
  round-robin MultitaskLoader (train and val modes, prompts on);
* the VQA, GQA, NLVR2 and COCO-caption evaluators' scores, exactly;
* ``parse_args`` + ``build_model_config`` field for field, for the flags
  of every scripts/image-text/*.sh (read by chip_smoke.py's
  ``script_flags``, positional arguments filled in), the port's three own
  flags at their defaults.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from chip_smoke import script_flags

from vlpet_tpu.cli import multitask as jcli
from vlpet_tpu.cli import param as jparam
from vlpet_tpu.data import datasets as jds
from vlpet_tpu.data import multitask as jmt
from vlpet_tpu.data import tokenization as jtok
from vlpet_tpu import evalsuite as jev
from vlpet_tpu_torch.cli import multitask as tcli
from vlpet_tpu_torch.cli import param as tparam
from vlpet_tpu_torch.data import datasets as tds
from vlpet_tpu_torch.data import multitask as tmt
from vlpet_tpu_torch.data import tokenization as ttok
from vlpet_tpu_torch import evalsuite as tev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIECE = os.path.join(REPO, "tests", "fixtures", "tiny_spiece.model")
TASKS = ("vqa", "gqa", "nlvr", "caption")
TEXTS = ["vqa: what is the red dog doing?", "a man rides a horse",
         "is there a tree near the car", ""]


@pytest.mark.parametrize("backbone,path", [
    ("facebook/bart-base", None), ("t5-base", SPIECE)])
def test_tokenizers_match(backbone, path):
    jt, jadded = jtok.get_tokenizer(backbone, path)
    tt, tadded = ttok.get_tokenizer(backbone, path)
    assert type(jt).__name__ == type(tt).__name__
    assert jadded == tadded
    assert (jtok.effective_vocab_size(jt, jadded)
            == ttok.effective_vocab_size(tt, tadded))
    for text in TEXTS:
        assert jt.encode(text) == tt.encode(text)
        assert (jt(text, add_special_tokens=False).input_ids
                == tt(text, add_special_tokens=False).input_ids)
    ids = [tt.encode(t) for t in TEXTS]
    assert jt.batch_decode(ids) == tt.batch_decode(ids)
    assert (jt.batch_decode(ids, skip_special_tokens=False)
            == tt.batch_decode(ids, skip_special_tokens=False))


def _loaders(ds_mod, mt_mod, cli_mod, tok, mode):
    loaders = []
    for task in TASKS:
        examples, source = ds_mod.synthetic_task_data(task, 24, n_boxes=4,
                                                      feat_dim=8, seed=3)
        cfg = ds_mod.DatasetConfig(
            task=task, max_text_length=cli_mod.TEXT_LEN[task],
            gen_max_length=cli_mod.GEN_LEN[task], n_boxes=4, feat_dim=8,
            prompt=ds_mod.TASK_PROMPTS.get(task, ""))
        ds = ds_mod.TaskDataset(cfg, examples, source, tok, mode=mode, seed=3)
        loaders.append(ds_mod.Loader(
            ds, cli_mod.task_batch_size(task, 6), shuffle=mode == "train",
            drop_last=mode == "train",
            evaluator=cli_mod.make_evaluator(task, ds.examples)))
    return loaders, mt_mod.MultitaskLoader(loaders)


def _assert_batches_equal(jb, tb):
    assert jb.keys() == tb.keys()
    for k in jb:
        if isinstance(jb[k], np.ndarray):
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
        else:
            assert jb[k] == tb[k], k


@pytest.mark.parametrize("mode", ["train", "val"])
def test_synthetic_batches_match(mode):
    tok = jtok.WhitespaceTokenizer()
    jl, jm = _loaders(jds, jmt, jcli, tok, mode)
    tl, tm = _loaders(tds, tmt, tcli, tok, mode)
    for a, b in zip(jl, tl):
        assert a.dataset.examples == b.dataset.examples
        assert len(a) == len(b)
    for epoch in (0, 1):
        jm.set_epoch(epoch)
        tm.set_epoch(epoch)
        assert jm.epoch_tasks == tm.epoch_tasks
        jbatches, tbatches = list(jm), list(tm)
        assert len(jbatches) == len(tbatches) == len(jm)
        for jb, tb in zip(jbatches, tbatches):
            _assert_batches_equal(jb, tb)


def _answers(loader, rng, words):
    """A prediction per example: the ground truth or a random word."""
    out = {}
    for e in loader.dataset.examples:
        if "label" in e and isinstance(e["label"], dict):
            truth = max(e["label"], key=e["label"].get)
        else:
            truth = e.get("sent", "")
        out[e.get("question_id", e.get("uid"))] = (
            truth if rng.uniform() < 0.5 else str(rng.choice(words)))
    return out


def test_evaluator_scores_match():
    tok = jtok.WhitespaceTokenizer()
    jl, _ = _loaders(jds, jmt, jcli, tok, "val")
    tl, _ = _loaders(tds, tmt, tcli, tok, "val")
    words = ["red", "dog", "cat", "tree", "blue"]
    for jloader, tloader in zip(jl, tl):
        je, te = jloader.evaluator, tloader.evaluator
        rng = np.random.default_rng(7)
        if jloader.task in ("vqa", "gqa"):
            ans = _answers(jloader, rng, words)
            assert je.evaluate(ans) == te.evaluate(ans)
            if jloader.task == "vqa":
                # the official 10-answer accuracy on human answers
                gt = {q: {"answers": [{"answer": str(w)} for w in
                                      rng.choice(words + ["Dog!", "two"],
                                                 10)],
                          "question_type": "what", "answer_type": "other"}
                      for q in ans}
                jraw = jev.VQAEvaluator(je.id2datum, gt)
                traw = tev.VQAEvaluator(te.id2datum, gt)
                assert jraw.evaluate_raw(ans) == traw.evaluate_raw(ans)
        elif jloader.task == "nlvr":
            ans = {e["uid"]: int(rng.integers(0, 2))
                   for e in jloader.dataset.examples}
            assert je.evaluate(ans) == te.evaluate(ans)
        else:
            refs = [e["targets"] for e in jloader.dataset.examples]
            preds = [" ".join(rng.choice(words, 4)) if i % 3 else r[0]
                     for i, r in enumerate(refs)]
            assert je.evaluate(preds, refs) == te.evaluate(preds, refs)
    assert isinstance(jev.COCOCaptionEvaluator.BASIS, str)
    assert tev.COCOCaptionEvaluator.BASIS == jev.COCOCaptionEvaluator.BASIS


SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "image-text",
                                        "*.sh")))


@pytest.mark.parametrize("path", SCRIPTS, ids=os.path.basename)
def test_parse_args_and_model_config_match(path):
    argv = script_flags(path, ["0", "96", "4", "96", "96", "1e-3", "9595"])
    assert "--tasks" in argv
    jargs, targs = jparam.parse_args(argv), tparam.parse_args(argv)
    own = {"device": "cuda", "use_fused_ce": False, "use_fused_beam": False}
    got = vars(targs)
    assert {k: got.pop(k) for k in own} == own
    assert got == vars(jargs)
    tasks = tuple(jargs.tasks.split(","))
    want = dataclasses.asdict(jparam.build_model_config(jargs, tasks, 50365))
    assert dataclasses.asdict(
        tparam.build_model_config(targs, tasks, 50365)) == want
