"""The port's video-text entry points against the JAX package's, on CPU,
with the tiny backbone of tests/test_torch_cli.py (its position table
long enough for the 600-token QA text) and the ``--load`` npz pattern of
tests/test_torch_cli_parity.py, at dropout 0.

* ``vlpet_tpu_torch.cli.multitask_video.main`` against
  ``vlpet_tpu.cli.multitask_video.main`` on one argv (tvqa and tvc, two
  epochs, each evaluated: QA greedy to length 20, captions beam 5 to length
  40): each epoch's train loss within 1e-5 relative, every eval score
  (``tvqa/overall``, per show, ``tvc/CIDEr``) and every generated string
  identical.
* ``cli.single_task.main`` for ``tvqa`` (the video loaders) and
  ``caption`` (the image-text ones), one epoch each, against JAX.
* ``train.trainer.predict_matching``: the group scores within
  1e-5 * (1 + max|jax|) and the same ``MatchingEvaluator`` result.
* ``--test_only`` evaluates; ``--device`` left at cuda raises on a host
  without CUDA.
* Every scripts/video-text/*.sh (read by chip_smoke.py's ``video_flags``)
  through ``parse_args`` and ``build_model_config`` as the video CLI calls
  them: the JAX config field for field, and the port's model at BART-base
  width (``device="meta"``) counts the trainable and total parameters the
  JAX freezing engine counts; ``--backbone t5-base`` builds the JAX config.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.cli.param as jparam
import vlpet_tpu_torch.cli.param as tparam
from chip_smoke import VIDEO_SCRIPTS, video_flags
from test_torch_cli import GATE_FLAGS, TINY
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.parallel.mesh import Layout, shard_model

TINY_VIDEO = {**TINY, "max_position_embeddings": 640}
VIDEO_TASKS = ("tvqa", "how2qa", "tvc", "yc2c")


def _argv(extra):
    return (["--backbone", "facebook/bart-base", "--batch_size", "8",
             "--valid_batch_size", "8", "--n_boxes", "4", "--lr", "1e-3",
             "--gen_max_length", "4", "--num_beams", "5", "--dropout", "0.0",
             "--use_adapter", "--use_single_adapter", "--no_encoder_adapter",
             "--use_adapter_down_dim", "--use_encoder_adapter_down_multihead",
             "--adapter_down_dim", "8", "--encoder_adapter_multihead_num_head",
             "4", "--unfreeze_encoder_layer_norms", "--no_decoder_adapter",
             "--use_decoder_enc_attn_value_parallel_adapter_down_dim",
             "--decoder_enc_attn_value_parallel_adapter_down_dim", "8"]
            + GATE_FLAGS["small"] + extra)


@pytest.fixture(autouse=True)
def tiny_backbone(monkeypatch):
    """Force the tiny backbone through both packages' video entry points."""
    import vlpet_tpu.cli.multitask_video as jmv
    import vlpet_tpu.cli.single_task as jst
    import vlpet_tpu_torch.cli.multitask_video as tmv
    import vlpet_tpu_torch.cli.single_task as tst
    from vlpet_tpu.config import BartConfig as JBart
    from vlpet_tpu_torch.config import BartConfig as TBart

    def patch(orig, bart):
        def patched(args, tasks, vocab_size=None):
            cfg = orig(args, tasks, vocab_size)
            return dataclasses.replace(
                cfg, backbone=bart(**TINY_VIDEO, dropout=args.dropout))
        return patched

    for mod, orig, bart in ((jmv, jparam.build_model_config, JBart),
                            (jst, jparam.build_model_config, JBart),
                            (tmv, tparam.build_model_config, TBart),
                            (tst, tparam.build_model_config, TBart)):
        monkeypatch.setattr(mod, "build_model_config", patch(orig, bart))
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load
    torch.set_num_threads(2)
    yield


def _jax_init_npz(argv, tasks, feat_dim, path):
    """The JAX init of the tiny config ``argv`` builds, as a LAST.npz."""
    import vlpet_tpu.cli.multitask_video as jmv
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu.models.vlbart import VLBart
    from vlpet_tpu.pet.modules import PetContext
    from vlpet_tpu.train.checkpoint import save_params_npz

    args = jparam.parse_args(argv)
    args.feat_dim = feat_dim
    tok, added = get_tokenizer(args.backbone, None)
    model = VLBart(jmv.build_model_config(args, tasks,
                                          effective_vocab_size(tok, added)))
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), vis_feats=jnp.ones((2, 4, feat_dim)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=PetContext())["params"])()
    save_params_npz(jax.device_get(params), path)
    return ["--load", path]


def _assert_histories_match(got, want, tasks):
    assert sorted(got) == sorted(want)
    for epoch in want:
        np.testing.assert_allclose(got[epoch]["train_loss"],
                                   want[epoch]["train_loss"], rtol=1e-5)
        scores = {k: v for k, v in want[epoch].items()
                  if "/" in k and not k.endswith("seconds")}
        assert {t.split("/")[0] for t in scores} == set(tasks)
        assert {k: got[epoch][k] for k in scores} == scores


def _predictions(trainer, loaders):
    """Each val loader's generated strings, at the in-training eval's
    beams and length."""
    out = {}
    for loader in loaders:
        cap = loader.task in ("caption", "tvc", "yc2c")
        res = trainer.predict(loader, num_beams=5 if cap else 1,
                              max_length=40 if cap else 20)
        out[loader.task] = res["predictions"]
    return out


def _val_loaders(video_mod, param_mod, argv, tasks):
    args = param_mod.parse_args(argv)
    args.feat_dim = 512
    from vlpet_tpu_torch.data.tokenization import WhitespaceTokenizer

    return [video_mod.build_video_loader(t, args, WhitespaceTokenizer(),
                                         args.valid, "val", None)
            for t in tasks]


def test_multitask_video_main_matches_jax(tmp_path):
    import vlpet_tpu.cli.multitask_video as jm
    import vlpet_tpu.data.video as jvid
    import vlpet_tpu_torch.cli.multitask_video as tm
    import vlpet_tpu_torch.data.video as tvid

    tasks = ("tvqa", "tvc")
    argv = _argv(["--tasks", ",".join(tasks), "--epochs", "2",
                  "--synthetic_examples", "8"])
    argv += _jax_init_npz(argv, tasks, 512, str(tmp_path / "w.npz"))
    jtrainer, want = jm.main(argv + ["--output", str(tmp_path / "jax")])
    ttrainer, got = tm.main(argv + ["--output", str(tmp_path / "port")],
                            device="cpu")
    _assert_histories_match(got, want, tasks)
    assert {"tvqa/overall", "tvqa/showA", "tvqa/showB",
            "tvc/CIDEr"} <= set(want[1])
    assert ttrainer.step == 4 and np.isfinite(got[1]["train_loss"])
    # the strings behind the scores: greedy QA and beam-5 captions
    jpred = _predictions(jtrainer, _val_loaders(jvid, jparam, argv, tasks))
    tpred = _predictions(ttrainer, _val_loaders(tvid, tparam, argv, tasks))
    assert tpred == jpred
    assert all(len(v) == 8 for v in jpred.values())


@pytest.mark.parametrize("task", ["tvqa", "caption"])
def test_single_task_main_matches_jax(tmp_path, task):
    import vlpet_tpu.cli.single_task as jst
    import vlpet_tpu_torch.cli.single_task as tst

    # caption trains at 50/60 of the batch: 40 of 48, whole batches for the
    # JAX Trainer's 8 CPU devices
    argv = _argv(["--epochs", "1", "--feat_dim", "8", "--synthetic_examples"]
                 + (["8"] if task == "tvqa" else
                    ["40", "--batch_size", "48", "--valid_batch_size", "48"]))
    argv += _jax_init_npz(argv, (task,), 512 if task == "tvqa" else 8,
                          str(tmp_path / "w.npz"))
    _, want = jst.main(task, argv + ["--output", str(tmp_path / "jax")])
    trainer, got = tst.main(task, argv + ["--output", str(tmp_path / "port")],
                            device="cpu")
    _assert_histories_match(got, want, (task,))
    assert trainer.tasks == (task,) and trainer.step >= 1
    assert trainer.cfg.vis.feat_dim == (512 if task == "tvqa" else 8)


def test_predict_matching_matches_jax(tmp_path):
    from vlpet_tpu.data import datasets as jds
    from vlpet_tpu.data import tokenization as jtok
    from vlpet_tpu.data import video as jvid
    from vlpet_tpu.train import trainer as jtr
    from vlpet_tpu_torch.data import datasets as tds
    from vlpet_tpu_torch.data import video as tvid
    from vlpet_tpu_torch.train import trainer as ttr
    import vlpet_tpu.cli.multitask_video as jmv
    import vlpet_tpu_torch.cli.multitask_video as tmv

    argv = _argv(["--tasks", "tvqa", "--feat_dim", "8"])
    npz = _jax_init_npz(argv, ("tvqa",), 8, str(tmp_path / "w.npz"))[1]
    examples, source, _ = jvid.synthetic_video_data("tvqa", 4, n_frames=4,
                                                    feat_dim=8, seed=3)
    examples = [{**e, "question_id": f"q{e['question_id']}"} for e in examples]
    rows = jvid.expand_matching_examples(examples)
    tok = jtok.WhitespaceTokenizer()

    def scores(ds_mod, tr_mod, cfg):
        ds = ds_mod.TaskDataset(ds_mod.DatasetConfig(
            task="tvqa", max_text_length=64, gen_max_length=4, n_boxes=4,
            feat_dim=8), rows, source, tok)
        loader = ds_mod.Loader(ds, 8, shuffle=False, drop_last=False)
        kw = {} if tr_mod is jtr else {"device": "cpu"}
        trainer = tr_mod.Trainer(cfg, ("tvqa",), lr=1e-3, total_steps=2,
                                 tokenizer=tok, load=npz, verbose=False, **kw)
        return tr_mod.predict_matching(trainer, loader)

    want = scores(jds, jtr, jmv.build_model_config(
        jparam.parse_args(argv), ("tvqa",), 50265))
    got = scores(tds, ttr, tmv.build_model_config(
        tparam.parse_args(argv), ("tvqa",), 50265))
    assert got.keys() == want.keys() and len(want) == 4
    top = max(abs(v) for g in want.values() for v in g.values())
    for gid, cands in want.items():
        assert got[gid].keys() == cands.keys() and len(cands) == 5
        for c, v in cands.items():
            assert abs(got[gid][c] - v) <= 1e-5 * (1 + top), (gid, c)
    assert (tvid.MatchingEvaluator(examples).evaluate(got)
            == jvid.MatchingEvaluator(examples).evaluate(want))


def test_test_only_evaluates(tmp_path, capsys):
    import vlpet_tpu_torch.cli.multitask_video as tm

    trainer = tm.main(_argv(["--tasks", "tvqa,tvc", "--test_only",
                             "--synthetic_examples", "8", "--num_beams", "2",
                             "--output", str(tmp_path / "run")]),
                      device="cpu")
    printed = capsys.readouterr().out
    assert "tvqa {" in printed and "'overall'" in printed
    assert "tvc {'CIDEr'" in printed
    assert trainer.step == 0


def test_device_cuda_raises_without_cuda(tmp_path, monkeypatch, capsys):
    import vlpet_tpu_torch.cli.multitask_video as tm
    import vlpet_tpu_torch.cli.single_task as tst

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(["--tasks", "tvqa", "--epochs", "1", "--synthetic_examples",
                  "8", "--output", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        tm.main(argv)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        tst.main("tvqa", argv)
    # one process: the model axis falls back to 1 (the JAX rule), said once
    capsys.readouterr()
    trainer, history = tm.main(argv + ["--mesh_model_axis", "2", "--output",
                                       str(tmp_path / "tp")], device="cpu")
    assert (trainer.layout.model, trainer.layout.data) == (1, 1)
    assert np.isfinite(history[0]["train_loss"])
    assert capsys.readouterr().out.count(
        "mesh_model_axis 2 does not divide 1 process(es): the model axis "
        "is 1") == 1
    # a flag once refused under a split (an allowlist), under a 2-rank
    # model axis: it shards (LoRA's base q / v rows split)
    lora = dataclasses.replace(trainer.cfg, pet=dataclasses.replace(
        trainer.cfg.pet, use_lora=True))
    model = shard_model(VLBart(lora, device="cpu"), Layout(model=2))
    q = model.model.encoder.layers_0.self_attn.q_proj
    assert q.base.weight.shape[0] * 2 == q.lora_B.shape[-1]
    # --classifier builds the answer head, which the video steps leave unread
    trainer, history = tm.main(argv + ["--classifier", "--output",
                                       str(tmp_path / "cls")], device="cpu")
    assert "answer_head" in trainer.model._modules
    assert np.isfinite(history[0]["train_loss"])


def _script_configs(argv):
    jargs, targs = jparam.parse_args(argv), tparam.parse_args(argv)
    jargs.feat_dim = targs.feat_dim = 512  # as the video CLI forces it
    tasks = tuple(jargs.tasks.split(","))
    assert tasks == VIDEO_TASKS
    return (jparam.build_model_config(jargs, tasks, 50265),
            tparam.build_model_config(targs, tasks, 50265))


@pytest.mark.parametrize("name", VIDEO_SCRIPTS)
def test_video_script_config_and_count_match_jax(name):
    from vlpet_tpu.models.vlbart import VLBart as JVLBart
    from vlpet_tpu.pet.modules import PetContext as JCtx
    from vlpet_tpu.train.freezing import trainable_mask, trainable_report
    from vlpet_tpu_torch.models.vlbart import VLBart
    from vlpet_tpu_torch.train.freezing import trainable_report as treport

    argv = video_flags(name)
    assert "--downsample" not in argv
    jcfg, tcfg = _script_configs(argv)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.vis.feat_dim, tcfg.vis.n_boxes) == (512, 64)
    v = jcfg.vis
    params = jax.eval_shape(lambda: JVLBart(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), jnp.int32),
        vis_feats=jnp.ones((1, v.n_boxes, v.feat_dim)),
        boxes=jnp.zeros((1, v.n_boxes, 4)),
        labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx()))["params"]
    want = trainable_report(params, trainable_mask(params, jcfg.pet))
    got = treport(VLBart(tcfg, device="meta"), tcfg.pet)
    assert (got["trainable"], got["total"]) == (want["trainable"],
                                                 want["total"])


def test_t5_video_config_matches_jax():
    argv = video_flags("VL-PET-large")
    argv[argv.index("--backbone") + 1] = "t5-base"
    jcfg, tcfg = _script_configs(argv)
    assert tcfg.is_t5 and tcfg.vis.feat_dim == 512
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
