"""The PET baselines of the image-text scripts in the port against the JAX
package on BART, on CPU: the serial adapter, the low-rank adapter (its
sampler-sharing form too), LoRA and prompt tuning here;
tests/test_torch_pet_compacter.py runs the four Compacter forms and
tests/test_torch_pet_hyperformer.py the hyperformer, BitFit and full
fine-tuning, all with the helpers below.

Each recipe is a VARIANTS entry of tests/test_pet_variants.py, parsed with
its BASE flags by the JAX CLI (``parse_args`` / ``build_model_config``,
tasks vqa and caption) on that file's tiny BART (d 32, 2+2 layers, 4
heads, FFN 64, vocab 512), fp32, dropout 0 and LoRA dropout 0 (the JAX
layer draws its dropout with jax.random: ``no_lora_dropout``). Weights are
spread as tests/test_torch_gates.py spreads them (norm scales
1 + N(0, 0.1), the rest N(0, 0.2)) and carried to the port by
vlpet_tpu_torch.convert. Per recipe:

* the trainable set, by name, equal to the JAX freezing engine's;
* a 3-step vqa lockstep of the port's make_train_step against
  vlpet_tpu/train/steps.py make_train_step: per-step loss and gradient
  norm within 1e-5 relative, trainable parameters within rtol 1e-3, atol
  1e-5 * max|p|, frozen parameters unchanged (``check_lockstep``);
* beam-5 tokens identical to the JAX seq2seq_generate on the batch with a
  ragged padding mask (caption; see ``BEAM_TASK``), and the teacher-forced
  loss and logits of both tasks within 1e-5 (1 + max|jax|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.config as jc
import vlpet_tpu_torch.config as pc
from test_pet_variants import BASE, VARIANTS
from test_torch_gates import (OPT, _models, check_beam5, check_forward,
                              check_lockstep, port_cfg, setup_cfg)
from vlpet_tpu.cli.param import build_model_config, parse_args
from vlpet_tpu.config import BartConfig
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import HFAdamWState
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

TASKS = ("vqa", "caption")
TINY = dict(vocab_size=512, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_position_embeddings=64, dropout=0.0)
# the recipes of tests/test_pet_variants.py this slice ports
RECIPES = ("single_adapter", "single_compacter", "compacter_shared_samplers",
           "compacter_shared_W", "compacter_per_task", "single_lradapter",
           "lradapter_shared_samplers", "single_lora", "single_prompt",
           "hyperformer", "bitfit", "full_finetuning")
# the task of the beam-5 check: at the spread weights compacter_per_task's
# caption decode repeats one token in every row (in both packages), its
# vqa decode does not
BEAM_TASK = {"compacter_per_task": "vqa"}


def recipe_cfg(name: str, **backbone):
    """The JAX config of a recipe: its flags through the JAX CLI, on the
    tiny BART of tests/test_pet_variants.py (``backbone`` overrides)."""
    args = parse_args(BASE + VARIANTS[name])
    cfg = build_model_config(args, TASKS, vocab_size=512)
    return dataclasses.replace(cfg, backbone=BartConfig(**{**TINY,
                                                           **backbone}))


@pytest.fixture(scope="module", autouse=True)
def no_lora_dropout():
    """LoRA dropout 0 in both packages while the module runs: the JAX
    LoRADense draws its mask from jax.random, the port's from the hash
    (held op by op in tests/test_torch_pet_modules.py)."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jc.PetConfig, pc.PetConfig):
            orig = cls.lora_spec
            mp.setattr(cls, "lora_spec", lambda self, orig=orig:
                       dataclasses.replace(orig(self), lora_dropout=0.0))
        yield


def check_trainable(s):
    jcfg, _, params, _, _, port = s
    want = set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, m: np.zeros(p.shape, np.float32) if m else None, params,
        trainable_mask(params, jcfg.pet))))
    got = set(apply_freezing(port, port.cfg.pet))
    assert got == want and got


def check_lockstep_per_step(s, task="vqa"):
    """``check_lockstep`` with each port step started from the JAX state
    before it (parameters, moments, count): the per-step loss and
    gradient norm within 1e-5 relative and the parameters after it within
    rtol 1e-3, atol 1e-5 * max|p|. Chip phase 6c's remedy for a step
    whose fp32 rounding Adam amplifies across steps."""
    jcfg, jmodel, params, jbatch, tbatch, _ = s
    ti = TASKS.index(task)
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, TASKS)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    _, T = _models(jcfg)
    model = load_flax_params(T(port_cfg(jcfg), device="cpu"), params)
    named = apply_freezing(model, model.cfg.pet)
    opt = build_optimizer(named, **OPT)
    step = make_train_step(model, opt, TASKS, device="cpu")
    for k in range(3):
        adam = next(x for x in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(x, HFAdamWState))
            if isinstance(x, HFAdamWState))
        before = flax_to_state_dict(jax.device_get(state.params))
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(before[n])
        opt.load_state_dict({
            "count": int(adam.count), "master": {},
            "mu": flax_to_state_dict(jax.device_get(adam.mu)),
            "nu": flax_to_state_dict(jax.device_get(adam.nu))})
        state, m = jstep(state, frozen, jbatch, jax.random.PRNGKey(0), ti)
        out = step(tbatch, None, ti)
        np.testing.assert_allclose(float(out["loss"]), float(m["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {k}")
        np.testing.assert_allclose(float(out["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad norm, step {k}")
        want = flax_to_state_dict(jax.device_get(state.params))
        for name, p in named.items():
            w = want[name].numpy()
            np.testing.assert_allclose(
                p.detach().numpy(), w, rtol=1e-3,
                atol=max(1e-8, 1e-5 * np.abs(w).max()),
                err_msg=f"{name}, step {k}")


def recipe_tests(names):
    """The module-scoped fixture and the four tests of the module
    docstring over ``names``, for a test module to take into its namespace
    (``globals().update(recipe_tests(...))``)."""
    @pytest.fixture(scope="module", params=names)
    def recipe(request):
        return request.param, setup_cfg(recipe_cfg(request.param))

    def test_trainable_set_matches_jax(recipe):
        check_trainable(recipe[1])

    def test_train_lockstep_with_jax(recipe):
        name, s = recipe
        if name == "hyperformer":
            check_lockstep_per_step(s)
        else:
            check_lockstep(s, "vqa", TASKS)

    def test_beam5_tokens_match_jax(recipe):
        name, s = recipe
        check_beam5(s, BEAM_TASK.get(name, "caption"), TASKS)

    def test_forward_and_loss_match_jax(recipe):
        name, s = recipe
        # the hyperformer's logits: see tests/test_torch_pet_hyperformer.py
        keys = ("loss",) if name == "hyperformer" else ("loss", "logits")
        for task in TASKS:
            check_forward(s, task, TASKS, keys)

    return {k: v for k, v in locals().items() if k != "names"}


globals().update(recipe_tests(["single_adapter", "single_lradapter",
                               "lradapter_shared_samplers", "single_lora",
                               "single_prompt"]))
