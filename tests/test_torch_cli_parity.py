"""``vlpet_tpu_torch.cli.multitask.main`` against
``vlpet_tpu.cli.multitask.main`` on one argv, on CPU, with the tiny backbone
of tests/test_torch_cli.py.

Both CLIs start from one set of weights (``--load`` of a LAST.npz written
from the JAX init by the JAX package's ``save_params_npz``), at dropout 0,
and train the four image-text tasks with the VL-PET-small flags for two
epochs, evaluating each. So the CLI's own glue is held: the per-task batch
scale (base 48: vqa 48, gqa 80, nlvr 16, caption 40, whole batches for the
JAX Trainer's 8 CPU devices), the per-task text and target lengths and
prompts, the loaders, the round-robin order, the schedule's total steps and
the per-epoch evaluations. Each epoch's train loss agrees within 1e-5
relative, and every evaluation score is identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_cli import TINY, _argv, tiny_backbone  # noqa: F401 (fixture)

TASKS = ("vqa", "gqa", "nlvr", "caption")


def test_multitask_main_matches_jax(tmp_path, monkeypatch):
    import vlpet_tpu.cli.multitask as jm
    import vlpet_tpu.cli.param as jp
    import vlpet_tpu_torch.cli.multitask as tm
    from vlpet_tpu.config import BartConfig
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu.models.vlbart import VLBart
    from vlpet_tpu.pet.modules import PetContext
    from vlpet_tpu.train.checkpoint import save_params_npz

    def tiny(args, tasks, vocab_size=None):
        cfg = jp.build_model_config(args, tasks, vocab_size)
        return dataclasses.replace(
            cfg, backbone=BartConfig(**TINY, dropout=args.dropout))

    monkeypatch.setattr(jm, "build_model_config", tiny)
    argv = _argv(["--tasks", ",".join(TASKS), "--epochs", "2",
                  "--batch_size", "48", "--synthetic_examples", "80",
                  "--dropout", "0.0"])
    args = jp.parse_args(argv)
    tok, added = get_tokenizer(args.backbone, None)
    model = VLBart(tiny(args, TASKS, effective_vocab_size(tok, added)))
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), vis_feats=jnp.ones((2, 4, 8)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=PetContext())["params"])()
    npz = str(tmp_path / "w.npz")
    save_params_npz(jax.device_get(params), npz)
    argv += ["--load", npz]
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load

    _, want = jm.main(argv + ["--output", str(tmp_path / "jax")])
    _, got = tm.main(argv + ["--output", str(tmp_path / "port")],
                     device="cpu")
    assert sorted(got) == sorted(want) == [0, 1]
    for epoch in want:
        np.testing.assert_allclose(got[epoch]["train_loss"],
                                   want[epoch]["train_loss"], rtol=1e-5)
        scores = {k: v for k, v in want[epoch].items()
                  if "/" in k and not k.endswith("seconds")}
        assert {t.split("/")[0] for t in scores} == set(TASKS)
        assert {k: got[epoch][k] for k in scores} == scores
