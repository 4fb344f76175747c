"""``cli.multitask_video.main`` and ``cli.single_task.main`` (tvqa) with
``--classifier`` against the JAX package's, on CPU, with the tiny backbone
of tests/test_torch_video_cli.py and one ``--load`` of the JAX init
(dropout 0). The answer head is built (``num_answers`` as configured) and
nothing reads it -- the video loaders carry no answer scores -- as in the
JAX video entry points: each epoch's train loss within 1e-5 relative and
every eval score identical.
"""

import torch

from test_torch_classifier_cli import (TINY_VIDEO, _argv, _init_npz,
                                       _same_history, _tiny)
from test_torch_classifier_cli import jit_init  # noqa: F401 (fixture)


def test_video_mains_with_classifier_match_jax(tmp_path, monkeypatch):
    import vlpet_tpu.cli.multitask_video as jmv
    import vlpet_tpu.cli.param as jp
    import vlpet_tpu.cli.single_task as jst
    import vlpet_tpu_torch.cli.multitask_video as tmv
    import vlpet_tpu_torch.cli.param as tp
    import vlpet_tpu_torch.cli.single_task as tst
    from vlpet_tpu.config import BartConfig as JBart
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu_torch.config import BartConfig as TBart

    _tiny(monkeypatch, ((jmv, jp.build_model_config, JBart),
                        (jst, jp.build_model_config, JBart),
                        (tmv, tp.build_model_config, TBart),
                        (tst, tp.build_model_config, TBart)), TINY_VIDEO)
    argv = _argv(["--tasks", "tvqa", "--epochs", "1", "--batch_size", "8",
                  "--valid_batch_size", "8", "--synthetic_examples", "8",
                  "--gen_max_length", "4", "--dropout", "0.0",
                  "--classifier"])
    args = jp.parse_args(argv)
    args.feat_dim = 512
    tok, added = get_tokenizer(args.backbone, None)
    cfg = jmv.build_model_config(args, ("tvqa",),
                                 effective_vocab_size(tok, added))
    argv += _init_npz(cfg, 512, str(tmp_path / "w.npz"))
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load
    torch.set_num_threads(2)

    _, want = jmv.main(argv + ["--output", str(tmp_path / "jax")])
    trainer, got = tmv.main(argv + ["--output", str(tmp_path / "port")],
                            device="cpu")
    assert trainer.model.answer_head.fc2.weight.shape[0] == cfg.num_answers
    _same_history(got, want, ("tvqa",))
    _, want = jst.main("tvqa", argv + ["--output", str(tmp_path / "jax1")])
    trainer, got = tst.main("tvqa", argv + ["--output",
                                            str(tmp_path / "port1")],
                            device="cpu")
    assert "answer_head" in trainer.model._modules
    _same_history(got, want, ("tvqa",))
