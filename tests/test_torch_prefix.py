"""Prefix tuning, the visual prefix and the LM-head adapter in the port
against the JAX package, on CPU.

* The modules alone (vlpet_tpu_torch/pet/prefix.py ``AttnPrefixController``
  and ``ResidualVisualPrefix``, pet/modules.py ``OutputParallelAdapterLayer``)
  against the JAX ones on the JAX parameters carried by
  vlpet_tpu_torch.convert: every layer's k and v (slot 2i and 2i + 1 of the
  flat projection), the adapter's output, within 1e-6 (1 + max|jax|).
* Three recipes on the tiny BART of tests/test_torch_pet_recipes.py (d 32,
  2+2 layers, 4 heads, FFN 64, vocab 512; fp32, dropout 0), parsed with
  tests/test_pet_variants.py's BASE flags by the JAX CLI, weights spread by
  tests/test_torch_gates.py ``setup_cfg``: ``attn_prefix`` (the flags of
  tests/test_pet_variants.py::test_attn_prefix_trains_and_generates:
  encoder prefix 5, decoder prefix 4, mid_dim 16), ``vis_prefix``
  (``--use_vis_prefix``: tests/test_pet_variants.py::
  test_visual_prefix_encoder) and ``lm_head_adapter``. One JAX 3-step run a
  recipe in the module fixture (tests/test_torch_ablation_recipes.py
  ``jax_run``); per recipe the trainable set, the port's lockstep with that
  run (loss and gradient norm 1e-5 relative, parameters rtol 1e-3, atol
  1e-5 * max|p|), the teacher-forced loss and logits (1e-5 (1 + max|jax|)),
  beam-5 and greedy tokens identical to the JAX seq2seq_generate,
  LAST.npz both ways bit for bit, and the port's init against the JAX
  initializers by distribution at d 128 (tests/test_torch_pet_init.py).
* The cached decode (``check_cached_logits``): the
  port's decode steps from the cache that ``prefill_kvs`` fills against the
  JAX teacher-forced logits on the same inputs, within 1e-5
  (1 + max|jax|) -- tests/test_pet_variants.py::test_attn_prefix_cache_parity
  as a port-vs-JAX lockstep.
* The visual prefix leaves the encoder's output at the text's length and
  the LM-head adapter keeps ``use_fused_ce`` off the fused route (the
  head counts as unfrozen: vlpet_tpu/models/vlbart.py:230-236).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pet_variants import BASE
from test_torch_ablation_recipes import (check_last_npz, check_lockstep_with,
                                         jax_run)
from test_torch_gates import check_beam5, check_forward, setup_cfg
from test_torch_pet_init import WIDTH, check_init
from test_torch_pet_recipes import TASKS, TINY, check_trainable
from vlpet_tpu.cli.param import build_model_config, parse_args
from vlpet_tpu.config import BartConfig
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch.convert import load_flax_params
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.models import vlbart as tvlbart
from vlpet_tpu_torch.pet.modules import PetContext

torch.set_num_threads(2)  # several xdist workers share the host

RECIPES = {
    "attn_prefix": ["--use_attn_prefix", "--encoder_prompt_len", "5",
                    "--decoder_prompt_len", "4", "--mid_dim", "16"],
    "vis_prefix": ["--use_vis_prefix"],
    "lm_head_adapter": ["--use_lm_head_adapter"],
}
GEN_KEYS = ("input_ids", "attention_mask", "vis_feats", "boxes")


def bart_cfg(flags, **backbone):
    """The JAX config of ``flags`` (after BASE) on the tiny BART."""
    cfg = build_model_config(parse_args(BASE + flags), TASKS, vocab_size=512)
    return dataclasses.replace(cfg, backbone=BartConfig(**{**TINY,
                                                           **backbone}))


def check_greedy(s, task="caption", tasks=TASKS):
    """Greedy tokens identical to the JAX seq2seq_generate."""
    jcfg, jmodel, params, jbatch, tbatch, port = s
    ti = tasks.index(task)
    want = np.asarray(jgen.seq2seq_generate(
        jmodel, {"params": params}, **{k: jbatch[k] for k in GEN_KEYS},
        ctx=JCtx(task=task, task_idx=ti), num_beams=1, max_length=8))
    with torch.no_grad():
        got = tgen.seq2seq_generate(port, **{k: tbatch[k] for k in GEN_KEYS},
                                    ctx=PetContext(task=task, task_idx=ti),
                                    num_beams=1, max_length=8)
    np.testing.assert_array_equal(got.numpy(), want)


def check_cached_logits(s, task="caption", tasks=TASKS):
    """The port's decode steps, position P + t on the cache whose first P
    slots ``prefill_kvs`` wrote, against the JAX teacher-forced logits of
    the same decoder inputs."""
    jcfg, jmodel, params, jbatch, tbatch, port = s
    ti = tasks.index(task)
    targets = np.asarray(jbatch["target_ids"])
    dec = np.where(targets < 0, jcfg.backbone.pad_token_id,
                   targets).astype(np.int32)
    want = np.asarray(jmodel.apply(
        {"params": params}, **{k: jbatch[k] for k in GEN_KEYS},
        decoder_input_ids=jnp.asarray(dec),
        ctx=JCtx(task=task, task_idx=ti))["logits"])
    ctx = PetContext(task=task, task_idx=ti)
    B, T = dec.shape
    dec_t = torch.from_numpy(dec).long()
    with torch.no_grad():
        enc, mask = port.encode(*(tbatch[k] for k in GEN_KEYS), ctx=ctx)
        consts = port.init_decode(enc, ctx)
        prefill = port.prefill_kvs(B, ctx)
        P = prefill[0][0].shape[1] if prefill is not None else 0
        cache = tgen.init_self_cache(port.cfg, B, T + P, device="cpu")
        for layer, (k, v) in zip(cache, prefill or ()):
            layer["k"][:P] = k.transpose(0, 1)
            layer["v"][:P] = v.transpose(0, 1)
        steps = []
        for t in range(T):
            logits, cache = port.decode_step(dec_t[:, t:t + 1], mask, consts,
                                             cache, t + P, ctx)
            steps.append(logits)
    got = torch.stack(steps, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    return P


def recipe_suite(cfg_of, names, beam_task=None):
    """The module-scoped fixture (the JAX config ``cfg_of(name)``, one JAX
    run a recipe) and the per-recipe tests of the module docstring over
    ``names``, for a test module to take into its namespace
    (``globals().update(recipe_suite(...))``). ``beam_task`` maps a
    recipe to the task of its decode checks (caption by default)."""
    beam_task = beam_task or {}

    @pytest.fixture(scope="module", params=names)
    def recipe(request):
        s = setup_cfg(cfg_of(request.param))
        return request.param, s, jax_run(s)

    def test_trainable_set_matches_jax(recipe):
        check_trainable(recipe[1])

    def test_train_lockstep_with_jax(recipe):
        check_lockstep_with(recipe[1], recipe[2])

    def test_forward_and_loss_match_jax(recipe):
        for task in TASKS:
            check_forward(recipe[1], task, TASKS)

    def test_beam5_tokens_match_jax(recipe):
        check_beam5(recipe[1], beam_task.get(recipe[0], "caption"), TASKS)

    def test_greedy_tokens_match_jax(recipe):
        check_greedy(recipe[1], beam_task.get(recipe[0], "caption"))

    def test_cached_decode_matches_jax_teacher_forcing(recipe):
        check_cached_logits(recipe[1], beam_task.get(recipe[0], "caption"))

    def test_last_npz_round_trips_between_the_packages(recipe, tmp_path):
        check_last_npz(recipe[1], tmp_path)

    return {k: v for k, v in locals().items()
            if k not in ("names", "cfg_of", "beam_task")}


globals().update(recipe_suite(lambda name: bart_cfg(RECIPES[name]),
                              list(RECIPES)))


@pytest.mark.parametrize("name", list(RECIPES))
def test_port_init_matches_the_jax_initializers(name):
    check_init(bart_cfg(RECIPES[name], **WIDTH))


def _module_pair(kind: str):
    """(JAX module, its init args, the port module, call args) of one
    of the three modules at d 32, 4 heads, 3 layers."""
    from vlpet_tpu.pet import modules as jmod
    from vlpet_tpu.pet import prefix as jpre
    from vlpet_tpu_torch.pet import modules as tmod
    from vlpet_tpu_torch.pet import prefix as tpre

    d, L, H = 32, 3, 4
    rng = np.random.default_rng(1)
    if kind == "attn_prefix":
        return (jpre.AttnPrefixController(5, L, H, d, mid_dim=16),
                (2,), tpre.AttnPrefixController(5, L, d, mid_dim=16,
                                                device="cpu"), (2,))
    x = rng.normal(size=(2, 6, 16 if kind == "vis_prefix" else d)
                   ).astype(np.float32)
    if kind == "vis_prefix":
        return (jpre.ResidualVisualPrefix(16, L, H, d), (jnp.asarray(x),),
                tpre.ResidualVisualPrefix(16, L, d, device="cpu"),
                (torch.from_numpy(x),))
    return (jmod.OutputParallelAdapterLayer(d, 50, init_std=0.02),
            (jnp.asarray(x),),
            tmod.OutputParallelAdapterLayer(d, 50, device="cpu"),
            (torch.from_numpy(x),))


@pytest.mark.parametrize("kind", ["attn_prefix", "vis_prefix",
                                  "output_adapter"])
def test_module_matches_jax(kind):
    jm, jargs, tm, targs = _module_pair(kind)
    params = jm.init(jax.random.PRNGKey(3), *jargs)["params"]
    # spread the init so that every slot differs
    params = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).normal(
            size=a.shape).astype(np.float32) * 0.3, jax.device_get(params))
    want = jm.apply({"params": params}, *jargs)
    tm = load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*targs)
    if kind == "output_adapter":
        want, got = [np.asarray(want)], [got.numpy()]
    else:  # per layer (k, v): (B, P, H, Dh) in JAX, (B, P, H*Dh) here
        want = [np.asarray(t).reshape(t.shape[:2] + (-1,))
                for kv in want for t in kv]
        got = [t.numpy() for kv in got for t in kv]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * (1 + np.abs(w).max()))


def test_visual_prefix_keeps_the_text_length():
    """tests/test_pet_variants.py::test_visual_prefix_encoder on the port:
    the encoder's output and joint mask span the text alone, the visual
    features reach the logits, and the encoder output is the JAX one."""
    s = setup_cfg(bart_cfg(RECIPES["vis_prefix"]))
    jcfg, jmodel, params, jbatch, tbatch, port = s
    from vlpet_tpu.models.vlbart import VLBart as J

    want, _ = jmodel.apply({"params": params},
                           *(jbatch[k] for k in GEN_KEYS), method=J.encode)
    with torch.no_grad():
        enc, mask = port.encode(*(tbatch[k] for k in GEN_KEYS))
        L = tbatch["input_ids"].shape[1]
        assert enc.shape[1] == L and mask.shape[1] == L
        args = [tbatch[k] for k in GEN_KEYS]
        a = port(*args, labels=tbatch["target_ids"])["logits"]
        args[2] = args[2] + 1.0
        b = port(*args, labels=tbatch["target_ids"])["logits"]
    assert not torch.allclose(a, b)
    w = np.asarray(want)
    np.testing.assert_allclose(enc.numpy(), w, rtol=0,
                               atol=1e-5 * (1 + np.abs(w).max()))


def test_lm_head_adapter_keeps_the_dense_loss(monkeypatch):
    """Under ``use_fused_ce`` the LM-head adapter's model takes the dense
    route: logits in the output, the fused loss never called, the loss
    the JAX one."""
    jcfg = dataclasses.replace(bart_cfg(RECIPES["lm_head_adapter"]),
                               use_fused_ce=True)
    s = setup_cfg(jcfg)
    assert s[5].cfg.use_fused_ce

    def refuse(*a, **k):
        raise AssertionError("the fused CE ran under the LM-head adapter")

    monkeypatch.setattr(tvlbart, "fused_linear_ce", refuse)
    monkeypatch.setattr(tvlbart, "fused_linear_ce_plain", refuse)
    check_forward(s, "vqa", TASKS)
