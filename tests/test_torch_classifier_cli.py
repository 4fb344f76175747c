"""The port's entry points with ``--classifier`` against the JAX package's,
on CPU, with the tiny backbones of tests/test_torch_cli.py and
tests/test_torch_video_cli.py and one ``--load`` of the JAX init (dropout
0).

* ``cli.multitask.main``: vqa, one epoch; ``num_answers`` is the answer
  vocabulary's size (``load_ans2label``'s fallback without a data root),
  the vqa batches carry the answer scores, the steps take the BCE and the
  evaluation answers by ``predict_classifier``: the epoch's train loss
  within 1e-5 relative, the vqa score identical.

tests/test_torch_classifier_video_cli.py holds the video entry points with
the flag, with these helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classifier import _jit_init
from test_torch_cli import TINY, _argv

TINY_VIDEO = {**TINY, "max_position_embeddings": 640}


def _tiny(monkeypatch, mods, backbone):
    """Force the tiny backbone through each (module, build_model_config,
    BartConfig) of ``mods``."""
    for mod, orig, bart in mods:
        def patched(args, tasks, vocab_size=None, orig=orig, bart=bart):
            cfg = orig(args, tasks, vocab_size)
            return dataclasses.replace(
                cfg, backbone=bart(**backbone, dropout=args.dropout))
        monkeypatch.setattr(mod, "build_model_config", patched)


@pytest.fixture(autouse=True)
def jit_init(monkeypatch):
    from vlpet_tpu.models.vlbart import VLBart

    _jit_init(monkeypatch, VLBart)


def _init_npz(cfg, feat_dim, path):
    """The JAX init of ``cfg`` as a LAST.npz."""
    from vlpet_tpu.models.vlbart import VLBart
    from vlpet_tpu.pet.modules import PetContext
    from vlpet_tpu.train.checkpoint import save_params_npz

    model = VLBart(cfg)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), vis_feats=jnp.ones((2, 4, feat_dim)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=PetContext())["params"])()
    assert "answer_head" in params
    save_params_npz(jax.device_get(params), path)
    return ["--load", path]


def _same_history(got, want, tasks):
    assert sorted(got) == sorted(want)
    for epoch in want:
        np.testing.assert_allclose(got[epoch]["train_loss"],
                                   want[epoch]["train_loss"], rtol=1e-5)
        scores = {k: v for k, v in want[epoch].items()
                  if "/" in k and not k.endswith("seconds")}
        assert {t.split("/")[0] for t in scores} == set(tasks)
        assert {k: got[epoch][k] for k in scores} == scores


def test_multitask_main_classifier_matches_jax(tmp_path, monkeypatch):
    import vlpet_tpu.cli.multitask as jm
    import vlpet_tpu.cli.param as jp
    import vlpet_tpu_torch.cli.multitask as tm
    import vlpet_tpu_torch.cli.param as tp
    from vlpet_tpu.config import BartConfig as JBart
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu_torch.config import BartConfig as TBart

    _tiny(monkeypatch, ((jm, jp.build_model_config, JBart),
                        (tm, tp.build_model_config, TBart)), TINY)
    argv = _argv(["--tasks", "vqa", "--epochs", "1", "--batch_size", "8",
                  "--valid_batch_size", "8", "--synthetic_examples", "16",
                  "--dropout", "0.0", "--classifier"])
    args = jp.parse_args(argv)
    tok, added = get_tokenizer(args.backbone, None)
    n = len(jm.load_ans2label(args))
    cfg = dataclasses.replace(jm.build_model_config(
        args, ("vqa",), effective_vocab_size(tok, added)), num_answers=n)
    argv += _init_npz(cfg, 8, str(tmp_path / "w.npz"))
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load
    torch.set_num_threads(2)

    _, want = jm.main(argv + ["--output", str(tmp_path / "jax")])
    trainer, got = tm.main(argv + ["--output", str(tmp_path / "port")],
                           device="cpu")
    assert trainer.cfg.classifier and trainer.cfg.num_answers == n
    assert trainer.model.answer_head.fc2.weight.shape[0] == n
    _same_history(got, want, ("vqa",))
