"""The hooks whose output lands in a split tensor, under the port's tensor
parallelism on the CPU, against the JAX package (rule 1 of
vlpet_tpu_torch/parallel/mesh.py: the hook's parameters whole, its whole
output, the rank's head or hidden columns behind ``copy_to_model``).

Each family is a recipe on the tiny BART of tests/test_torch_pet_recipes.py
(d 32, 2+2 layers, 4 heads, FFN 64, vocab 512; fp32, dropout 0, LoRA
dropout 0), weights spread by tests/test_torch_gates.py ``setup_cfg``:

* LoRA (``single_lora``: q / v through ``LoRADense`` with the base's rows
  split and ``lora_B``'s columns taken in the forward; the trainable
  q/k/v biases split), the attention prefixes (encoder and decoder) and
  the visual prefix at (data, model) = (1, 2), (2, 2) and (1, 4);
* the decoder input prompt on BART and T5 (the T5 relative bias over
  P + T sliced to the rank's heads), the cross IA3 with the decoder FFN's
  IA3 (the FFN's plain chain at the hidden's column base), the multihead
  VPA with the key parallel adapter, the pair VPA, the sequential value
  adapter with its residual gate, and the decoder's multihead adapters
  with the key-value adapter, at (1, 2).

Per family and layout: 3 vqa steps against the JAX make_train_step on the
whole batch -- loss and gradient norm within 1e-5 relative a step, the
trainable tensors (gathered whole) within rtol 1e-3, atol 1e-5 max|p|,
every rank bit for bit, each split tensor 1/M of its whole; and for
LoRA, the prefixes and the decoder prompts, beam-5 and greedy caption
tokens at (1, 2) identical to the JAX seq2seq_generate. The ranks
(tests/torch_dist_ranks.py) import no JAX.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pet_variants import BASE, VARIANTS
from test_torch_ablation_recipes import (PORT_RECIPES, ablation_cfg,
                                         lambda_z_of)
from test_torch_decoder_prompt import prompt_cfg
from test_torch_gates import port_cfg, setup_cfg
from test_torch_pet_recipes import (TASKS, TINY, no_lora_dropout,
                                    recipe_cfg)
from test_torch_prefix import RECIPES as PREFIX_RECIPES, bart_cfg
from torch_dist_ranks import tp_ranks
from vlpet_tpu.cli.param import build_model_config, parse_args
from vlpet_tpu.config import BartConfig
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.parallel.launch import run_ranks
from vlpet_tpu_torch.parallel.mesh import split_plan

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
LAYOUTS = [(1, 2), (2, 2), (1, 4)]  # (data, model)
SPAWN_TIMEOUT_S = 150
GEN_KEYS = ("input_ids", "attention_mask", "vis_feats", "boxes")


def _flags_cfg(*names):
    """The tiny BART with the flags of the named recipes together."""
    flags = sum((PORT_RECIPES[n] if n in PORT_RECIPES else VARIANTS[n]
                 for n in names), [])
    cfg = build_model_config(parse_args(BASE + flags), TASKS, vocab_size=512)
    return dataclasses.replace(cfg, backbone=BartConfig(**TINY))


# family -> (its JAX config, its layouts, whether its tokens are checked)
FAMILIES = {
    "lora": (lambda: recipe_cfg("single_lora"), LAYOUTS, True),
    "attn_prefix": (lambda: bart_cfg(PREFIX_RECIPES["attn_prefix"]),
                    LAYOUTS, True),
    "vis_prefix": (lambda: bart_cfg(PREFIX_RECIPES["vis_prefix"]), LAYOUTS,
                   False),
    "decoder_prompt": (lambda: prompt_cfg("bart"), LAYOUTS[:1], True),
    "decoder_prompt_t5": (lambda: prompt_cfg("t5"), LAYOUTS[:1], True),
    "ia3": (lambda: ablation_cfg("ia3"), LAYOUTS[:1], False),
    "mh_vpa_key": (lambda: _flags_cfg("mh_vpa", "key_parallel"),
                   LAYOUTS[:1], False),
    "pair_vpa": (lambda: ablation_cfg("pair_vpa"), LAYOUTS[:1], False),
    "sequential_va_gate": (lambda: ablation_cfg("sequential_va_gate"),
                           LAYOUTS[:1], False),
    "decoder_mh_kv_adapter": (lambda: ablation_cfg("decoder_mh_kv_adapter"),
                              LAYOUTS[:1], False),
}


def jax_steps(s, opt=OPT, task="vqa"):
    """K steps of the JAX make_train_step on the whole batch (the
    recipe's lambda_z under track_z): (losses, grad norms, the trainable
    tensors after them by port name)."""
    jcfg, jmodel, params, jbatch, _, _ = s
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **opt)
    jstep = jmake_step(jmodel, tx, TASKS, lambda_z=lambda_z_of(jcfg))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    losses, norms = [], []
    for _ in range(K):
        state, m = jstep(state, frozen, jbatch, jax.random.PRNGKey(0),
                         TASKS.index(task))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, flax_to_state_dict(jax.device_get(state.params))


def jax_tokens(s, task="caption"):
    """The JAX beam-5 and greedy tokens of ``setup_cfg``'s state."""
    jcfg, jmodel, params, jbatch, _, _ = s
    ctx = JCtx(task=task, task_idx=TASKS.index(task))
    return {n: np.asarray(jgen.seq2seq_generate(
        jmodel, {"params": params}, **{k: jbatch[k] for k in GEN_KEYS},
        ctx=ctx, num_beams=n, max_length=8)) for n in (5, 1)}


def spawn(cases_by_layout, gen_by_layout=None):
    """tp_ranks of each layout's train (and generation) cases, the
    layouts' process groups spawned at once: {layout: the ranks'
    results}."""
    gen_by_layout = gen_by_layout or {}

    def run(layout):
        data, model = layout
        return run_ranks(
            tp_ranks, data * model,
            [dict(c, model_axis=model) for c in cases_by_layout[layout]],
            [dict(c, model_axis=model)
             for c in gen_by_layout.get(layout, ())],
            timeout=SPAWN_TIMEOUT_S)

    layouts = sorted(cases_by_layout)
    with ThreadPoolExecutor(len(layouts)) as pool:
        return dict(zip(layouts, pool.map(run, layouts)))


def case_of(s, task="vqa", **kw):
    """The ranks' arguments for ``setup_cfg``'s state ``s``."""
    jcfg, _, _, _, tbatch, port = s
    return dict(cfg=port_cfg(jcfg), state=port.state_dict(),
                batch={k: v.numpy() for k, v in tbatch.items()},
                tasks=TASKS, task=task, **kw)


def families_run(families, opt=OPT, setup=setup_cfg, jax_fn=jax_steps):
    """For each family (name -> (JAX config, layouts, tokens?[, more
    arguments of its train cases])): the JAX run (``jax_fn(s, opt)``, or
    None where it returns None), the JAX tokens where checked, the port
    model, and every layout's ranks in one spawn a layout."""
    want, tokens, ports, cases, gens = {}, {}, {}, {}, {}
    for name, (cfg_fn, layouts, toks, *more) in families.items():
        s = setup(cfg_fn())
        want[name] = jax_fn(s, opt)
        ports[name] = s[-1]
        extra = dict(lora_dropout0=True, lambda_z=lambda_z_of(s[0]),
                     **(more[0] if more else {}))
        for layout in layouts:
            cases.setdefault(layout, []).append(dict(
                case_of(s, steps=K, opt=opt, **extra), name=name))
        if toks:
            tokens[name] = jax_tokens(s)
            gens.setdefault((1, 2), []).append(dict(
                case_of(s, task="caption", lora_dropout0=True), name=name))
    names = {layout: [c.pop("name") for c in cs]
             for layout, cs in cases.items()}
    gen_names = [c.pop("name") for c in gens.get((1, 2), [])]
    ranks = spawn(cases, gens)
    return want, tokens, ports, names, gen_names, ranks


def check_family(run, name, layout):
    """``name``'s 3 steps at ``layout`` against the JAX run (module
    docstring); each split tensor 1/M of the whole on every rank."""
    want, _, ports, names, _, ranks = run
    losses, norms, params = want[name]
    rs = [r["train"][names[layout].index(name)] for r in ranks[layout]]
    got = rs[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5)
    assert set(got["params"]) == set(params)
    for n, w in params.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got["params"][n].numpy(), w, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(w).max()), err_msg=n)
    for other in rs[1:]:
        assert other["losses"] == got["losses"]
        for n, p in got["params"].items():
            assert torch.equal(other["params"][n], p), n
    M = layout[1]
    port = ports[name]
    plan = split_plan(port, M)
    assert plan
    for r in rs:
        for n, p in port.named_parameters():
            frac = M if n in plan else 1
            assert np.prod(r["shapes"][n]) * frac == p.numel(), n


@pytest.fixture(scope="module")
def pet_run(no_lora_dropout):
    return families_run(FAMILIES)


@pytest.mark.parametrize("name,layout", [
    (n, lay) for n, (_, lays, _) in FAMILIES.items() for lay in lays],
    ids=lambda x: x if isinstance(x, str) else f"{x[0]}x{x[1]}")
def test_tp_hook_family_matches_jax(pet_run, name, layout):
    check_family(pet_run, name, layout)


def check_tokens(run, name):
    _, tokens, _, _, gen_names, ranks = run
    want = tokens[name]
    for beams in (5, 1):
        assert len(np.unique(want[beams][:, 1:])) > 2  # not degenerate
        for r in ranks[(1, 2)]:
            got = r["generate"][gen_names.index(name)][beams].numpy()
            np.testing.assert_array_equal(got, want[beams],
                                          err_msg=f"{name} beam {beams}")


@pytest.mark.parametrize("name", [n for n, f in FAMILIES.items() if f[2]])
def test_tp_tokens_match_jax(pet_run, name):
    check_tokens(pet_run, name)


def test_lora_splits_its_base_and_keeps_lora_whole(pet_run):
    """LoRA's base q / v rows split (design (a): the sharding report says
    so), ``lora_A`` / ``lora_B`` whole on every rank."""
    _, _, ports, names, _, ranks = pet_run
    port = ports["lora"]
    plan = split_plan(port, 2)
    assert any(n.endswith("q_proj.base.weight") for n in plan)
    assert any(n.endswith("v_proj.base.bias") for n in plan)
    assert not any("lora_" in n for n in plan)
    shapes = ranks[(1, 2)][1]["train"][names[(1, 2)].index("lora")]["shapes"]
    for n, p in port.named_parameters():
        if "lora_" in n:
            assert shapes[n] == tuple(p.shape), n
