"""``vlpet_tpu_torch.cli.multitask_infer``'s gate dump against the JAX
dump, on CPU, with the tiny backbone of tests/test_torch_cli.py.

From one set of weights -- the JAX init spread by N(0, 0.2), written as a
LAST.npz -- the port's CLI (``main([...], device="cpu")`` with
``--use_store_gate_large --store_gate_path --load_trained_model_path``)
and vlpet_tpu/cli/multitask_infer.py ``dump_gates`` on the JAX CLI's val
loaders write the same files, name for name (``{task}_{flax path}.npy``),
with the same arrays within 1e-5 (1 + max|jax|), for the small, middleX and
large gates; middle-Y, whose vector the JAX model does not sow, dumps none
in either. The JAX model's apply is jitted here (one compile a model
instead of one a primitive); the dump's names come from its intermediates
tree either way.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cli import _argv, tiny_backbone  # noqa: F401 (fixture)


class _JitApply:
    """A flax module whose ``apply`` runs jitted, with the call's static
    keywords (ctx, deterministic, mutable) bound."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, ctx, deterministic, mutable, **kw):
        fn = jax.jit(functools.partial(self.model.apply, ctx=ctx,
                                       deterministic=deterministic,
                                       mutable=mutable))
        return fn(variables, *args, **kw)


@pytest.mark.parametrize("gate", ["small", "middleX", "middleY", "large"])
def test_gate_dump_matches_jax(tmp_path, monkeypatch, gate):
    import vlpet_tpu.cli.multitask_infer as jmi
    import vlpet_tpu_torch.cli.multitask_infer as tmi
    from vlpet_tpu.cli.multitask import build_loaders
    from vlpet_tpu.cli.param import parse_args
    from vlpet_tpu.data.tokenization import effective_vocab_size, get_tokenizer
    from vlpet_tpu.models.vlbart import VLBart as JVLBart
    from vlpet_tpu.pet.modules import PetContext as JCtx
    from vlpet_tpu.train.checkpoint import save_params_npz

    tasks = ("vqa", "caption")
    argv = _argv(["--tasks", ",".join(tasks), "--epochs", "1"], gate)
    args = parse_args(argv)
    tok, added = get_tokenizer(args.backbone, None)
    jcfg = jmi.build_model_config(args, tasks,
                                  vocab_size=effective_vocab_size(tok, added))
    model = JVLBart(jcfg)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((2, 4), jnp.int32),
        jnp.ones((2, 4), jnp.int32), vis_feats=jnp.ones((2, 4, 8)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=JCtx())["params"])()
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
        * 0.2, jax.device_get(params))
    npz = str(tmp_path / "w.npz")
    save_params_npz(params, npz)

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    stub = types.SimpleNamespace(model=_JitApply(model), merged_params=params,
                                 task_idx=tasks.index)
    for loader in build_loaders(args, tasks, tok, args.valid, "val"):
        jmi.dump_gates(stub, loader, str(jdir))
    monkeypatch.setenv("PYTHONHASHSEED", "0")  # --load_trained_model_path
    tmi.main(argv + ["--use_store_gate_large", "--store_gate_path",
                     str(tdir), "--output", str(tmp_path / "o"),
                     "--load_trained_model_path", npz], device="cpu")
    dumps = {name: {f: np.load(d / f) for f in sorted(os.listdir(d))}
             for name, d in (("jax", jdir), ("port", tdir))}
    assert dumps["port"].keys() == dumps["jax"].keys()
    if gate == "middleY":
        assert not dumps["jax"]
        return
    assert len(dumps["jax"]) == 2 * 2  # two tasks, two sublayers, one layer
    for f, want in dumps["jax"].items():
        np.testing.assert_allclose(dumps["port"][f], want, rtol=0,
                                   atol=1e-5 * (1 + np.abs(want).max()),
                                   err_msg=f)
