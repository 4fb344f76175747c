"""The PET baselines' modules in the port against the JAX package, module
by module, on CPU: the JAX module's parameters (its init, spread as
tests/test_torch_gates.py spreads them: norm scales 1 + N(0, 0.1), the rest
N(0, 0.2), so zero-initialised leaves matter) are carried to the port's
module by vlpet_tpu_torch.convert, strict, and both run on the same input;
every output within 1e-5 (1 + max|jax|).

* LowRankDense, shared and per task;
* PHMDense in each branch: factorized W with its own rule, full W with a
  factorized rule, a shared rule passed in, per-task W and rule, per-task W
  with the rule shared over tasks, and the model-shared W, factorized or
  full;
* HyperComplexAdapter with its own weights and with the model-root W and
  rule; LowRankAdapter per task;
* AdapterController of each kind (bottleneck, Compacter, low-rank), with
  and without the pre/post LayerNorms, sequential and parallel;
* LoRADense shared and per task;
* InputPrompts, PromptController single and per task;
* TaskEmbeddingController (with and without ``train_task_embeddings``),
  both hypernet controllers (with the cross-attention block and the
  LayerNorm generators) and MetaLayersAdapterController with the
  conditional LayerNorms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.pet.hypernet as jh
import vlpet_tpu.pet.modules as jm
import vlpet_tpu.pet.prompts as jp
import vlpet_tpu_torch.pet.hypernet as th
import vlpet_tpu_torch.pet.modules as tm
import vlpet_tpu_torch.pet.prompts as tp
from vlpet_tpu.config import (AdapterSpec, HyperformerSpec, LoraSpec,
                              PromptSpec)
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict

torch.set_num_threads(2)  # several xdist workers share the host

D, TASKS = 16, ("vqa", "gqa", "caption")


def _port(spec):
    """A JAX spec dataclass as the port's own."""
    return getattr(pc, type(spec).__name__)(**dataclasses.asdict(spec))


def _spread(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)),
        jax.device_get(params))


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()))


def run(jmod, jargs, tmod, targs, jkw=None, tkw=None):
    """Init ``jmod`` on ``jargs``, spread, load into ``tmod`` (strict) and
    compare the outputs."""
    jkw, tkw = jkw or {}, tkw or {}
    params = _spread(jmod.init(jax.random.PRNGKey(0), *jargs,
                               **jkw).get("params", {}))
    want = jmod.apply({"params": params}, *jargs, **jkw)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmod(*targs, **tkw)
    _close(got, want)
    return params


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shared", [True, False])
def test_low_rank_dense(shared):
    x = _x(2, 5, D)
    run(jm.LowRankDense(D, 12, rank=2, n_tasks=3, shared=shared),
        (jnp.asarray(x), 2),
        tm.LowRankDense(D, 12, rank=2, n_tasks=3, shared=shared,
                        device="cpu"), (t(x), 2))


SPEC = AdapterSpec(d_model=D, reduction_factor=4, tasks=TASKS,
                   kind="compacter", hypercomplex_division=4, phm_rank=2)
# (label, spec overrides, shared, W_shared: None / "factorized" / "full",
#  rule passed in)
PHM_CASES = [
    ("factorized W, own rule", dict(shared_phm_rule=False), True, None, False),
    ("full W, factorized rule", dict(factorized_phm=False,
                                     factorized_phm_rule=True,
                                     shared_phm_rule=False), True, None,
     False),
    ("shared rule passed in", dict(factorized_phm=False), True, None, True),
    ("per task", dict(shared_phm_rule=False), False, None, False),
    ("per task, rule over tasks", dict(shared_phm_rule=False,
                                       shared_phm_rule_over_tasks=True),
     False, None, False),
    ("model W factorized", dict(shared_W_phm=True), True, "factorized", True),
    ("model W full", dict(shared_W_phm=True, factorized_phm=False), True,
     "full", True),
]


@pytest.mark.parametrize("label,over,shared,wkind,rule_in", PHM_CASES,
                         ids=[c[0] for c in PHM_CASES])
def test_phm_dense(label, over, shared, wkind, rule_in):
    spec = dataclasses.replace(SPEC, **over)
    pd, ip, op, r = 4, D // 4, 8 // 4, spec.phm_rank
    rule = _x(pd, pd, pd, seed=2) if rule_in else None
    W = None
    if wkind == "factorized":
        W = (_x(pd, ip, r, seed=3), _x(pd, r, op, seed=4))
    elif wkind == "full":
        W = _x(pd, ip, op, seed=3)
    x = _x(2, 5, D)
    jW = (tuple(map(jnp.asarray, W)) if isinstance(W, tuple)
          else None if W is None else jnp.asarray(W))
    tW = (tuple(map(t, W)) if isinstance(W, tuple)
          else None if W is None else t(W))
    run(jm.PHMDense(D, 8, spec, n_tasks=3, shared=shared),
        (jnp.asarray(x), 1), tm.PHMDense(
            D, 8, _port(spec), n_tasks=3, shared=shared, own_W=W is None,
            own_rule=not rule_in, device="cpu"), (t(x), 1),
        jkw=dict(phm_rule=None if rule is None else jnp.asarray(rule),
                 W_shared=jW),
        tkw=dict(phm_rule=None if rule is None else t(rule), W_shared=tW))


@pytest.mark.parametrize("root", [False, True])
def test_hypercomplex_adapter(root):
    spec = dataclasses.replace(SPEC, shared_phm_rule=root, shared_W_phm=root,
                               share_up_sampler=True)
    rule = _x(4, 4, 4, seed=2) if root else None
    W = ({"down": (_x(4, D // 4, 2, seed=3), _x(4, 2, 1, seed=4)),
          "up": (_x(4, 1, 2, seed=5), _x(4, 2, D // 4, seed=6))}
         if root else None)
    x = _x(2, 5, D)
    jkw = dict(phm_rule=None if rule is None else jnp.asarray(rule),
               phm_W=None if W is None else jax.tree_util.tree_map(
                   jnp.asarray, W))
    tkw = dict(phm_rule=None if rule is None else t(rule),
               phm_W=None if W is None else {k: tuple(map(t, v))
                                             for k, v in W.items()})
    run(jm.HyperComplexAdapter(spec), (jnp.asarray(x), 2),
        tm.HyperComplexAdapter(_port(spec), device="cpu",
                               phm_W_dims=(D, 4) if root else None),
        (t(x), 2), jkw=jkw, tkw=tkw)


def test_low_rank_adapter_per_task():
    spec = dataclasses.replace(SPEC, kind="lowrank", low_rank_rank=2)
    x = _x(2, 5, D)
    run(jm.LowRankAdapter(spec), (jnp.asarray(x), 1),
        tm.LowRankAdapter(_port(spec), device="cpu"), (t(x), 1))


@pytest.mark.parametrize("kind", ["bottleneck", "compacter", "lowrank"])
@pytest.mark.parametrize("norms", [False, True])
@pytest.mark.parametrize("parallel", [False, True])
def test_adapter_controller(kind, norms, parallel):
    spec = dataclasses.replace(
        SPEC, kind=kind, add_layer_norm_before_adapter=norms,
        add_layer_norm_after_adapter=norms, use_parallel_adapter=parallel,
        use_scaling_factor=True, scaling_factor=0.5)
    rule = _x(4, 4, 4, seed=2)
    x, y = _x(2, 5, D), _x(2, 5, D, seed=7)
    jctx = jm.PetContext(task="caption", task_idx=2, phm_rule=jnp.asarray(rule))
    tctx = tm.PetContext(task="caption", task_idx=2, phm_rule=t(rule))
    run(jm.AdapterController(spec, init_std=0.02),
        (jnp.asarray(x), jctx, jnp.asarray(y) if parallel else None),
        tm.AdapterController(_port(spec), device="cpu"),
        (t(x), tctx, t(y) if parallel else None))


@pytest.mark.parametrize("single", [True, False])
def test_lora_dense(single):
    spec = LoraSpec(lora_dim=4, lora_alpha=8.0, lora_dropout=0.1,
                    tasks=TASKS, use_single_lora=single)
    x = _x(2, 5, D)
    # deterministic: the JAX layer draws no dropout, the port's no seed
    run(jm.LoRADense(D, 12, spec, init_std=0.02), (jnp.asarray(x), 2),
        tm.LoRADense(D, 12, _port(spec), device="cpu"), (t(x), 2))


def test_input_prompts():
    spec = PromptSpec(prompt_len=6, mid_dim=10, tasks=TASKS)
    run(jp.InputPrompts(spec, D, init_std=0.02), (3,),
        tp.InputPrompts(_port(spec), D, init_std=0.02, device="cpu"), (3,))


@pytest.mark.parametrize("single", [True, False])
def test_prompt_controller(single):
    spec = PromptSpec(prompt_len=6, mid_dim=10, tasks=TASKS,
                      use_single_prompt=single)
    jmod = jp.PromptController(spec, D, init_std=0.02)
    tmod = tp.PromptController(_port(spec), D, init_std=0.02, device="cpu")
    params = run(jmod, (3, 1), tmod, (3, 1))
    assert set(params) == ({"prompts"} if single
                           else {f"prompts_{k}" for k in TASKS})
    for ti in range(3):  # every task's prompt from the same weights
        _close(tmod(3, ti), jmod.apply({"params": params}, 3, ti))


HSPEC = HyperformerSpec(task_embedding_dim=24, projected_task_embedding_dim=8,
                        hidden_dim=12)


@pytest.mark.parametrize("train", [False, True])
def test_task_embedding_controller(train):
    spec = dataclasses.replace(HSPEC, train_task_embeddings=train)
    run(jh.TaskEmbeddingController(spec, TASKS), (2,),
        th.TaskEmbeddingController(_port(spec), TASKS, device="cpu"), (2,))


@pytest.mark.parametrize("one", [False, True])
@pytest.mark.parametrize("norms", [False, True])
def test_hypernet_controllers(one, norms):
    kw = dict(d_model=D, reduction_factor=4, num_layers=3,
              include_cross_attention=True,
              add_layer_norm_before_adapter=norms,
              add_layer_norm_after_adapter=norms)
    jcls, tcls = ((jh.AdapterLayersOneHyperNetController,
                   th.AdapterLayersOneHyperNetController) if one else
                  (jh.AdapterLayersHyperNetController,
                   th.AdapterLayersHyperNetController))
    emb = _x(HSPEC.task_embedding_dim)
    run(jcls(HSPEC, **kw), (jnp.asarray(emb), 2),
        tcls(_port(HSPEC), device="cpu", **kw), (t(emb), 2))


@pytest.mark.parametrize("norms", [False, True])
def test_meta_layers_adapter_controller(norms):
    down = D // 4
    w = {"up": (_x(D, down, seed=2), _x(D, seed=3)),
         "down": (_x(down, D, seed=4), _x(down, seed=5)),
         "pre": (_x(D, seed=6), _x(D, seed=7)),
         "post": (_x(D, seed=8), _x(D, seed=9))}

    def weights(mod, cast):
        ln = lambda k: mod.LayerNormWeights(*map(cast, w[k]))
        return mod.AdapterWeights(
            up=mod.SamplerWeights(*map(cast, w["up"])),
            down=mod.SamplerWeights(*map(cast, w["down"])),
            pre_norm=ln("pre") if norms else None,
            post_norm=ln("post") if norms else None)

    kw = dict(add_layer_norm_before_adapter=norms,
              add_layer_norm_after_adapter=norms)
    x = _x(2, 5, D)
    run(jh.MetaLayersAdapterController(d_model=D, **kw),
        (jnp.asarray(x), weights(jh, jnp.asarray)),
        th.MetaLayersAdapterController(**kw), (t(x), weights(th, t)))
