"""The seven baseline scripts of scripts/image-text/ in the port, on CPU.

* Each script's flags (read by chip_smoke.py's ``script_flags`` with the
  positional values the scripts leave to their caller: lr 1e-3,
  ``hypercomplex_division`` 4, ``lora_dim`` 4, ``projected_task_embedding_dim``
  64), parsed by the port's ``parse_args`` / ``build_model_config``, give
  the JAX CLI's config; the port's model at BART-base width, built on
  ``device="meta"``, counts the trainable and total parameters that the JAX
  freezing engine counts on ``jax.eval_shape`` of the same config.
* ``python -m vlpet_tpu_torch.cli.multitask`` with each script's flags (on
  the tiny backbone of tests/test_torch_cli.py, synthetic data, one epoch)
  trains and evaluates the four tasks, and ``--resume`` restores its
  state (parameters, optimizer, step) bit for bit.
* Refusals: ``check_supported`` still raises for every PET flag the port
  leaves unported (the encoder prompt under ``use_attn_prefix`` too), and
  the port's T5 for each baseline flag and for serial adapters.
* ``LAST.npz`` of every recipe of tests/test_torch_pet_recipes.py
  round-trips between the packages, every tensor bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.cli.param as jparam
import vlpet_tpu.train.checkpoint as jckpt
import vlpet_tpu_torch.cli.param as tparam
import vlpet_tpu_torch.train.checkpoint as tckpt
from chip_smoke import script_flags
from test_torch_cli import tiny_backbone  # noqa: F401
from test_torch_gates import _models, port_cfg, setup_cfg
from test_torch_pet_recipes import RECIPES, recipe_cfg
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import trainable_mask, trainable_report
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models import vlbart as tvlbart
from vlpet_tpu_torch.models.t5 import check_t5_supported
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.train.freezing import trainable_report as treport

torch.set_num_threads(2)  # several xdist workers share the host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("single_adapter", "single_compacter", "single_lora",
           "single_prompt", "hyperformer", "bitfit", "full_finetuning")
# $1 lr, then the script's own: single_compacter's $2 hypercomplex_division,
# single_lora's $2 lora_dim, hyperformer's $2 projected_task_embedding_dim;
# the last is the seed
POSITIONAL = {"single_compacter": ["1e-3", "4", "9595"],
              "single_lora": ["1e-3", "4", "9595"],
              "hyperformer": ["1e-3", "64", "9595"]}


def flags(name: str):
    return script_flags(os.path.join(REPO, "scripts", "image-text",
                                     name + ".sh"),
                        POSITIONAL.get(name, ["1e-3", "9595"]))


def _configs(name):
    argv = flags(name)
    jargs, targs = jparam.parse_args(argv), tparam.parse_args(argv)
    tasks = tuple(jargs.tasks.split(","))
    return (jparam.build_model_config(jargs, tasks, 50265),
            tparam.build_model_config(targs, tasks, 50265))


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_config_and_full_width_count_match_jax(name):
    jcfg, tcfg = _configs(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel = JVLBart(jcfg)
    v = jcfg.vis
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), jnp.int32), vis_feats=jnp.ones((1, v.n_boxes,
                                                          v.feat_dim)),
        boxes=jnp.zeros((1, v.n_boxes, 4)),
        labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx()))["params"]
    want = trainable_report(params, trainable_mask(params, jcfg.pet))
    got = treport(VLBart(tcfg, device="meta"), tcfg.pet)
    assert (got["trainable"], got["total"]) == (want["trainable"],
                                                 want["total"])


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_trains_evaluates_and_resumes_on_the_cli(name, tmp_path,
                                                        monkeypatch):
    from vlpet_tpu_torch.cli.multitask import main

    monkeypatch.setenv("PYTHONHASHSEED", "0")
    argv = [f for f in flags(name) if f != "--downsample"] + [
        "--batch_size", "4", "--valid_batch_size", "4", "--feat_dim", "8",
        "--n_boxes", "4", "--synthetic_examples", "8", "--gen_max_length",
        "4", "--epochs", "1", "--output", str(tmp_path / "run")]
    trainer, history = main(argv, device="cpu")
    assert trainer.step > 0 and np.isfinite(history[0]["train_loss"])
    for task in ("vqa", "gqa", "caption"):
        assert f"{task}/eval_seconds" in history[0]
    assert "nlvr/accuracy" in history[0]
    # the checkpoint restores the recipe's parameters and optimizer state
    # bit for bit (nothing is left to train, so the state is saved again)
    again, history = main(argv + ["--resume"], device="cpu")
    assert history == {} and again.step == trainer.step
    assert again.state_digest() == trainer.state_digest()


def _with(cfg, **pet):
    return dataclasses.replace(cfg, pet=dataclasses.replace(cfg.pet, **pet))


def test_unported_flags_still_raise():
    cfg = pc.flagship_cfg()
    for flag in tvlbart._UNPORTED_VIS_FLAGS:
        with pytest.raises(NotImplementedError, match=flag):
            tvlbart.check_supported(dataclasses.replace(
                cfg, vis=dataclasses.replace(cfg.vis, **{flag: True})))
    # the prefixes and the decoder prompt build, under use_attn_prefix too
    tvlbart.check_supported(_with(cfg, encoder_prompt_len=4,
                                  decoder_prompt_len=4, use_attn_prefix=True,
                                  use_lm_head_adapter=True))
    for name in SCRIPTS:  # what the seven scripts set builds
        tvlbart.check_supported(_configs(name)[1])


@pytest.mark.parametrize("pet", [
    dict(use_adapter=True, no_encoder_adapter=False),
    dict(use_compacter=True),
    dict(use_lradapter=True), dict(use_lora=True),
    dict(use_hyperformer=True), dict(encoder_prompt_len=4)],
    ids=lambda p: next(iter(p)))
def test_t5_rejects_the_baselines(pet):
    """The baselines build on T5 now; what the JAX T5 does not read on top
    of one (the attention prefix, the LM-head adapter) is still refused."""
    cfg = pc.t5_cfg("float32")
    check_t5_supported(_with(cfg, **pet))
    for flag in ("use_attn_prefix", "use_lm_head_adapter"):
        with pytest.raises(NotImplementedError, match="JAX T5"):
            check_t5_supported(_with(cfg, **pet, **{flag: True}))


@pytest.mark.parametrize("name", RECIPES)
def test_last_npz_round_trips_between_the_packages(name, tmp_path):
    jcfg, _, params, _, _, _ = setup_cfg(recipe_cfg(name))
    _, T = _models(jcfg)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    want = flax_to_state_dict(params)
    # JAX export -> port import
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(params, jpath)
    port = T(port_cfg(jcfg), device="cpu")
    _, n = tckpt.load_params_npz(jpath, port)
    assert n == n_leaves
    for k, p in port.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    # port export -> JAX import
    port.init_weights(torch.Generator().manual_seed(7))
    tpath = str(tmp_path / "port.npz")
    tckpt.save_params_npz(dict(port.named_parameters()), tpath)
    loaded, n = jckpt.load_params_npz(
        tpath, jax.tree_util.tree_map(np.zeros_like, params))
    assert n == n_leaves
    got = flax_to_state_dict(jax.device_get(loaded))
    for k, p in port.named_parameters():
        assert torch.equal(got[k], p.detach()), k
