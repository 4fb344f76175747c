"""The four CLIs under ``--distributed --mesh_model_axis 2`` on the CPU:
two ranks spawned over gloo form a (1, 2) mesh, split the tiny BART's
heads and FFN columns, and feed the same data shard. Then
scripts/image-text/single_lora.sh's and bitfit.sh's flags at the tiny
sizes on cli.multitask: train, evaluate, resume, and a LAST.npz that
loads into the JAX package (``test_script_trains_evaluates_resumes_split``).

multitask (train and evaluate vqa + caption, one epoch), multitask_infer
on its LAST.npz (whole tensors, cut to each rank's shards on load),
multitask_video (tvqa) and single_task (vqa), each on synthetic data
with the VL-PET-large flags: both ranks take the (1, 2) layout and the
same examples, hold half of every q/k/v, out_proj, fc1 and fc2, and run
the same number of steps; rank 0 alone writes the checkpoints, LAST.npz
and the metrics.

The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import numpy as np
import pytest
import torch

from torch_dist_ranks import cli_ranks
from vlpet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)  # several xdist workers share the host

SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLIs' WhitespaceTokenizer ids words by str hash: one
    PYTHONHASHSEED makes the ranks agree."""
    out = str(tmp_path_factory.mktemp("tp_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONHASHSEED", "0")
        return run_ranks(cli_ranks, 2, out, ["--mesh_model_axis", "2"],
                         timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", ["multitask", "multitask_infer",
                                  "multitask_video", "single_task"])
def test_cli_tensor_parallel(cli, name):
    r0, r1 = (r[name] for r in cli)
    assert r0["layout"] == r1["layout"] == (1, 2)
    assert r0["world"] == r1["world"] == 2
    assert r0["step"] == r1["step"]
    assert r0["seen"] == r1["seen"]  # one data shard, both model ranks
    if name == "multitask_infer":
        assert r0["seen"] == []
    else:
        assert r0["seen"]
        assert set(r0["writes"]) == {"checkpoint", "LAST.npz"}
        assert {"LAST.npz", "ckpt", "metrics.jsonl"} <= set(r0["files"])
    assert r1["writes"] == [] and not r1["logs"] and r0["logs"]
    for n, shape in r0["shapes"].items():
        if n.endswith(("q_proj.weight", "v_proj.weight", "out_proj.weight",
                       "fc1.weight", "fc2.weight")):
            whole = 32 * 64 if "fc" in n else 32 * 32
            assert np.prod(shape) * 2 == whole, (n, shape)
        assert r1["shapes"][n] == shape


# --- single_lora.sh and bitfit.sh under the model axis ----------------------

SCRIPTS = {"single_lora": ["1e-3", "4", "9595"], "bitfit": ["1e-3", "9595"]}
TINY_FLAGS = ["--batch_size", "2", "--valid_batch_size", "2", "--feat_dim",
              "8", "--n_boxes", "4", "--synthetic_examples", "8",
              "--gen_max_length", "4", "--num_beams", "2", "--epochs", "1",
              "--tasks", "vqa,caption", "--distributed", "--mesh_model_axis",
              "2"]


def _script_argv(name):
    import os

    from chip_smoke import script_flags

    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "image-text", name + ".sh")
    return [f for f in script_flags(path, SCRIPTS[name])
            if f != "--downsample"] + TINY_FLAGS


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    from torch_dist_ranks import cli_scripts_ranks

    paths = {name: str(tmp_path_factory.mktemp(f"tp_{name}"))
             for name in SCRIPTS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONHASHSEED", "0")
        ranks = run_ranks(cli_scripts_ranks, 2,
                          [(paths[n], _script_argv(n)) for n in SCRIPTS],
                          timeout=SPAWN_TIMEOUT_S)
    return {n: (paths[n], [r[i] for r in ranks])
            for i, n in enumerate(SCRIPTS)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_trains_evaluates_resumes_split(scripts, name):
    """The script's flags with --mesh_model_axis 2 at world 2: a (1, 2)
    mesh; one epoch with both tasks' evaluations; split trainables (LoRA's
    q/k/v biases, BitFit's q/k/v and fc1 biases) half on each rank, whole
    and equal once gathered; --resume restores the whole state bit for
    bit on both ranks; LAST.npz loads into the JAX package leaf for
    leaf, its trainable tensors the ranks'."""
    import dataclasses
    import os

    import jax
    import jax.numpy as jnp

    from torch_dist_ranks import TINY
    from vlpet_tpu import config as jc
    from vlpet_tpu.cli import param as jparam
    from vlpet_tpu.models.vlbart import VLBart as JVLBart
    from vlpet_tpu.pet.modules import PetContext as JCtx
    from vlpet_tpu.train import checkpoint as jckpt
    from vlpet_tpu_torch.convert import flax_to_state_dict

    path, (r0, r1) = scripts[name]
    for r in (r0, r1):
        assert r["layout"] == (1, 2) and r["step"] > 0
        assert {"vqa/eval_seconds", "caption/eval_seconds"} <= set(
            r["history"])
        assert r["resumed_step"] == r["step"] and r["resumed_history"] == {}
        assert r["resumed_digest"] == r["digest"] == r0["digest"]
    split = [n for n, shape in r0["local"].items()
             if tuple(r0["trainable"][n].shape) != shape]
    assert split and all(n.endswith("proj.bias") or n.endswith("fc1.bias")
                         or "proj.base.bias" in n for n in split)
    for n in split:
        assert r0["trainable"][n].numel() == 2 * np.prod(r0["local"][n])
    for n, t in r0["trainable"].items():
        assert torch.equal(r1["trainable"][n], t), n
    argv = _script_argv(name)
    args = jparam.parse_args(argv)
    jcfg = jparam.build_model_config(args, ("vqa", "caption"), 50265)
    jcfg = dataclasses.replace(jcfg, backbone=jc.BartConfig(
        **TINY, dropout=args.dropout))
    ids = jnp.ones((2, 4), jnp.int32)
    shapes = jax.eval_shape(lambda: JVLBart(jcfg).init(
        jax.random.PRNGKey(0), ids, ids, vis_feats=jnp.ones((2, 4, 8)),
        boxes=jnp.zeros((2, 4, 4)), labels=jnp.ones((2, 3), jnp.int32),
        ctx=JCtx())["params"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    loaded, n = jckpt.load_params_npz(os.path.join(path, "run", "LAST.npz"),
                                      zeros)
    assert n == len(jax.tree_util.tree_leaves(zeros))
    got = flax_to_state_dict(jax.device_get(loaded))
    for name_, t in r0["trainable"].items():
        torch.testing.assert_close(got[name_], t, rtol=0, atol=0)
