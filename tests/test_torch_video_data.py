"""The port's video-text data and evaluators against the JAX package's, on
CPU: same inputs, equal outputs.

* ``build_qa_prompt`` with and without subtitles; ``load_video_qa`` (jsonl
  plus ``subtitles.json``, with and without answers, ``topk``) and
  ``load_video_caption`` (one example per description at train time, all
  descriptions as targets at eval; dict and string descriptions);
* ``build_video_loader`` over a data root written here (npz frame
  features of several lengths, time-resized to ``n_boxes``; ann jsonl;
  subtitles) and without one (the synthetic data): every batch array and
  string equal, train (shuffled over two epochs) and val, QA and caption;
* ``synthetic_video_data``: the same examples and feature bytes;
* the matching formulation (``expand_matching_examples``,
  ``MatchingEvaluator``) and ``TVQAEvaluator`` / ``TVCEvaluator`` on the same
  predictions: identical scores.
"""

import json

import numpy as np
import pytest

from vlpet_tpu.cli import param as jparam
from vlpet_tpu.data import tokenization as jtok
from vlpet_tpu.data import video as jvid
from vlpet_tpu_torch.cli import param as tparam
from vlpet_tpu_torch.data import video as tvid

TASKS = ("tvqa", "how2qa", "tvc", "yc2c")
QA = [dict(vid_name="s01e02_seg1", qid=7, show_name="friends",
           q="What does Ross hold? ", ts="3.2-9.8", answer_idx=2,
           **{f"a{i}": f"a cup {i}." for i in range(5)}),
      dict(vid_name="s03e01_seg2", qid=8, show_name="house", q="Who came in",
           ts="0.0-4.1", answer_idx=0,
           **{f"a{i}": f"doctor {i}" for i in range(5)}),
      dict(vid_name="noSubs", show_name="house", q="Why", ts="1-2",
           **{f"a{i}": f"reason {i}.." for i in range(5)}),
      dict(vid_name="s01e02_seg1", qid=10, q="Where", ts="5-6",
           answer_idx=4, a0="here", a1="there")]
SUBS = {"s01e02_seg1": [{"text": " Hi there "}, {"text": "a cup?"}],
        "s03e01_seg2": [{"text": "Come in."}]}
CAPS = [dict(vid_name="clip_a", clip_id=3, ts="1.0-2.5",
             descs=[{"desc": "a man opens a door"}, {"desc": "someone enters"}]),
        dict(vid_name="clip_b", ts="0-4", descs=["she laughs", "two people talk",
                                                 "a joke"]),
        dict(vid_name="clip_c", clip_id=9, desc="the dog barks")]


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_qa_prompt_matches_jax():
    for d in QA:
        for subs in (None, SUBS):
            for n in (5, 2):
                assert (tvid.build_qa_prompt(d, subs, n)
                        == jvid.build_qa_prompt(d, subs, n))
    assert tvid.VIDEO_QA_TASKS == jvid.VIDEO_QA_TASKS
    assert tvid.VIDEO_CAP_TASKS == jvid.VIDEO_CAP_TASKS


@pytest.mark.parametrize("topk", [-1, 2])
def test_annotation_parsing_matches_jax(tmp_path, topk):
    _write_jsonl(tmp_path / "qa.jsonl", QA)
    _write_jsonl(tmp_path / "cap.jsonl", CAPS)
    with open(tmp_path / "subtitles.json", "w") as f:
        json.dump(SUBS, f)
    for subs in (str(tmp_path / "subtitles.json"), None,
                 str(tmp_path / "missing.json")):
        want = jvid.load_video_qa("tvqa", str(tmp_path / "qa.jsonl"), subs,
                                  topk=topk)
        assert tvid.load_video_qa("tvqa", str(tmp_path / "qa.jsonl"), subs,
                                  topk=topk) == want
    for mode in ("train", "val"):
        want = jvid.load_video_caption("tvc", str(tmp_path / "cap.jsonl"),
                                       topk=topk, mode=mode)
        assert tvid.load_video_caption("tvc", str(tmp_path / "cap.jsonl"),
                                       topk=topk, mode=mode) == want


def _data_root(root):
    """vis_features/<task>/clip-vit/<vid>.npz (3, 8 and 13 frames around
    n_boxes 8) and ann/<task>/<task>_<split>.jsonl + subtitles."""
    rng = np.random.default_rng(5)
    for task in TASKS:
        feats = root / "vis_features" / task / "clip-vit"
        ann = root / "ann" / task
        feats.mkdir(parents=True)
        ann.mkdir(parents=True)
        # every QA row answered: a batch collates targets for all or none
        rows = ([r for r in QA if "answer_idx" in r]
                if task in jvid.VIDEO_QA_TASKS else CAPS)
        for i, r in enumerate(rows):
            np.savez(feats / f"{r['vid_name']}.npz",
                     features=rng.normal(size=(3 + 5 * i, 512))
                     .astype(np.float32))
        for split in ("train", "val"):
            _write_jsonl(ann / f"{task}_{split}.jsonl", rows * 3)
        with open(ann / "subtitles.json", "w") as f:
            json.dump(SUBS, f)


def _assert_batches_equal(jb, tb):
    assert jb.keys() == tb.keys()
    for k in jb:
        if isinstance(jb[k], np.ndarray):
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
        else:
            assert jb[k] == tb[k], k


@pytest.mark.parametrize("with_root", [True, False], ids=["data_root",
                                                          "synthetic"])
def test_video_loaders_match_jax(tmp_path, with_root):
    root = None
    if with_root:
        _data_root(tmp_path)
        root = str(tmp_path)
    argv = ["--batch_size", "3", "--valid_batch_size", "4", "--n_boxes", "8",
            "--gen_max_length", "6", "--synthetic_examples", "7", "--seed",
            "11"]
    jargs, targs = jparam.parse_args(argv), tparam.parse_args(argv)
    jargs.feat_dim = targs.feat_dim = 512
    tok = jtok.WhitespaceTokenizer()
    for task in TASKS:
        for mode, split in (("train", "train"), ("val", "val")):
            jl = jvid.build_video_loader(task, jargs, tok, split, mode, root)
            tl = tvid.build_video_loader(task, targs, tok, split, mode, root)
            assert jl.dataset.examples == tl.dataset.examples
            assert len(jl) == len(tl) > 0
            assert type(jl.evaluator).__name__ == type(tl.evaluator).__name__
            for epoch in ((0, 1) if mode == "train" else (0,)):
                jl.set_epoch(epoch)
                tl.set_epoch(epoch)
                jbatches, tbatches = list(jl), list(tl)
                assert len(jbatches) == len(tbatches) == len(jl)
                for jb, tb in zip(jbatches, tbatches):
                    _assert_batches_equal(jb, tb)
                    assert jb["vis_feats"].shape[1:] == (8, 512)


@pytest.mark.parametrize("task", TASKS)
def test_synthetic_video_data_same_bytes(task):
    jex, jsrc, jev = jvid.synthetic_video_data(task, 5, n_frames=6,
                                               feat_dim=16, seed=4)
    tex, tsrc, tev = tvid.synthetic_video_data(task, 5, n_frames=6,
                                               feat_dim=16, seed=4)
    assert jex == tex
    assert type(jev).__name__ == type(tev).__name__
    for e in jex:
        for a, b in zip(jsrc.get(e["img_id"]), tsrc.get(e["img_id"])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_matching_and_video_evaluators_match_jax():
    rng = np.random.default_rng(2)
    examples, _, _ = jvid.synthetic_video_data("tvqa", 12, n_frames=2,
                                               feat_dim=4, seed=1)
    # string question ids: the matching scorer's group ids are strings
    examples = [{**e, "question_id": f"q{e['question_id']}"} for e in examples]
    with_options = [{**e, "options": [f"opt {i}." for i in range(5)]}
                    for e in examples[:3]]
    for rows in (examples, with_options):
        assert (tvid.expand_matching_examples(rows)
                == jvid.expand_matching_examples(rows))
    groups = {str(e["question_id"]): {f"a{i}": float(rng.normal())
                                      for i in range(5)}
              for e in examples}
    groups["unknown"] = {"a0": 1.0}
    assert (tvid.MatchingEvaluator(examples, ["showA"]).evaluate(groups)
            == jvid.MatchingEvaluator(examples, ["showA"]).evaluate(groups))
    assert tvid.MatchingEvaluator(examples).evaluate(groups)["overall"] > 0

    types = ["showA", "showB", "showC"]
    preds = [{"question_id": e["question_id"],
              "answer": e["answer"] if rng.uniform() < 0.6 else "a9"}
             for e in examples[:10]]
    want = jvid.TVQAEvaluator(examples, types).eval(preds)
    assert tvid.TVQAEvaluator(examples, types).eval(preds) == want
    assert 0 < want["overall"] < 1 and want["showC"] == 0.0

    words = ["a", "man", "dog", "runs", "clip", "does", "something"]
    refs = [["clip 1 does something", "a man runs"], ["the dog runs"],
            ["clip 3 does something"], ["a dog", "a man"]]
    preds = [" ".join(rng.choice(words, 4)) for _ in refs[:-1]] + ["a man"]
    want = jvid.TVCEvaluator().evaluate(preds, refs)
    assert tvid.TVCEvaluator().evaluate(preds, refs) == want
    assert set(want) == {"CIDEr"} and want["CIDEr"] > 0
