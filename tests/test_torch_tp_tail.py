"""The replicated stream, the model-level flags and the raw-image path under
the port's tensor parallelism on the CPU (rules 1 and 3 of
vlpet_tpu_torch/parallel/mesh.py), against the JAX package, and the walk
over every PetConfig flag.

* At (data, model) = (1, 2), 3 vqa steps against the JAX make_train_step
  on the whole batch (fp32, dropout 0; test_torch_tensor_parallel.py's
  tolerances: loss and gradient norm 1e-5 relative a step, the trainable
  tensors rtol 1e-3, atol 1e-5 max|p|, every rank bit for bit, split
  tensors 1/M): the
  serial adapter with trained LayerNorms and the z regularizer
  (``track_z``), Compacter, the encoder input prompt, the LM-head
  adapter, the standalone gate, the decoder's down-dim adapters with
  their cross gate, the low-rank visual projector, the T5 serial
  adapter; the classifier (the answer head on the whole decoder state,
  the BCE step); ``remat`` "full" (the recompute replays each layer's
  all-reduces); the raw-image path (tests/test_torch_raw_path.py's tiny
  CLIP "RN_tiny" trunk, whole on every rank, with --use_vis_adapter, B
  4, the JAX make_raw_train_step).
* ``remat`` "full" and "dots" at dropout 0.1 (every BART site) at (1, 2):
  losses and trainable tensors bit for bit those of "none" at (1, 2).
* The hyperformer at (1, 2) against one process of the port (the JAX
  hypernet's 1024-term fp32 sum drifts from fp64 6.5x further than the
  port's: tests/test_torch_pet_hyperformer.py holds it step by step).
* Every boolean PetConfig field on, its sizes at their defaults (and
  ``classifier``, ``remat``, ``vis.use_vis_prefix``), on BART and T5:
  wherever one process builds the model, ``check_tensor_parallel`` and
  ``shard_model`` at M 2 take it and ``sharding_report`` gives every
  rule-matched parameter a reason; wherever one process refuses it, so
  does ``check_tensor_parallel``.

The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_raw_path as raw_test
import vlpet_tpu.vision.clip as jclip
from test_pet_variants import VARIANTS
from test_torch_ablation_recipes import ablation_cfg
from test_torch_decoder_prompt import t5_cfg
from test_torch_pet_recipes import TASKS, recipe_cfg
from test_torch_prefix import RECIPES as PREFIX_RECIPES, bart_cfg
from test_torch_tp_pet import (LAYOUTS, OPT, case_of, check_family,
                               families_run, jax_steps)
from torch_dist_ranks import TINY_RN, run_steps
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.parallel.mesh import (Layout, check_tensor_parallel,
                                           shard_model, sharding_report)
import vlpet_tpu_torch.vision.clip as tclip

torch.set_num_threads(2)  # several xdist workers share the host

RAW = dict(vis_backbone="RN_tiny", image_size=raw_test.IMG,
           vis_adapter_type=raw_test.ADAPTER, vis_reduction_factor=2)
N_ANSWERS = 5


def _drop(cfg, rate=0.1):
    """``cfg`` at every BART dropout ``rate``."""
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dropout=rate, attention_dropout=rate,
        activation_dropout=rate))


def _large():
    return ablation_cfg("vlpet_large_gating_add")


FAMILIES = {
    "track_z": (lambda: ablation_cfg("track_z"), LAYOUTS[:1], False),
    "compacter": (lambda: recipe_cfg("single_compacter"), LAYOUTS[:1],
                  False),
    "encoder_prompt": (lambda: recipe_cfg("single_prompt"), LAYOUTS[:1],
                       False),
    "lm_head_adapter": (lambda: bart_cfg(PREFIX_RECIPES["lm_head_adapter"]),
                        LAYOUTS[:1], False),
    "standalone_gating": (lambda: ablation_cfg("standalone_gating"),
                          LAYOUTS[:1], False),
    "decoder_adapters": (lambda: ablation_cfg("decoder_adapters"),
                         LAYOUTS[:1], False),
    "lowrank_visual_projector": (
        lambda: ablation_cfg("lowrank_visual_projector"), LAYOUTS[:1], False),
    "t5_adapter": (lambda: t5_cfg(VARIANTS["single_adapter"]), LAYOUTS[:1],
                   False),
    "classifier": (lambda: dataclasses.replace(
        _large(), classifier=True, num_answers=N_ANSWERS), LAYOUTS[:1],
        False),
    "remat_full": (lambda: dataclasses.replace(_large(), remat="full"),
                   LAYOUTS[:1], False),
    "raw": (raw_test._jax_cfg, LAYOUTS[:1], False, dict(raw=RAW)),
    # the port against itself (``PORT_ONLY``)
    "hyperformer": (lambda: recipe_cfg("hyperformer"), LAYOUTS[:1], False),
    "drop_none": (lambda: _drop(_large()), LAYOUTS[:1], False),
    "drop_remat_full": (lambda: dataclasses.replace(_drop(_large()),
                                                    remat="full"),
                        LAYOUTS[:1], False),
    "drop_remat_dots": (lambda: dataclasses.replace(_drop(_large()),
                                                    remat="dots"),
                        LAYOUTS[:1], False),
}
PORT_ONLY = ("hyperformer", "drop_none", "drop_remat_full", "drop_remat_dots")


def setup(jcfg):
    """tests/test_torch_gates.py ``setup_cfg``'s tuple: the raw model's
    from tests/test_torch_raw_path.py (its batch of 64-px images); the
    classifier's batch with answer scores ``target``."""
    from test_torch_gates import setup_cfg

    if jcfg.pet.use_vis_adapter:
        jmodel, variables, port = raw_test._models(jcfg)
        b = raw_test._batch(np.random.default_rng(2), 64)
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        return (jcfg, jmodel, variables, jbatch, raw_test._torch_batch(b),
                port)
    s = setup_cfg(jcfg)
    if jcfg.classifier:
        jcfg, jmodel, params, jbatch, tbatch, port = s
        target = np.random.default_rng(5).uniform(
            size=(tbatch["input_ids"].shape[0], N_ANSWERS)).astype(np.float32)
        jbatch = dict(jbatch, target=jnp.asarray(target))
        tbatch = dict(tbatch, target=torch.from_numpy(target))
        s = (jcfg, jmodel, params, jbatch, tbatch, port)
    return s


def jax_fn(s, opt):
    """The JAX 3 steps (none for ``PORT_ONLY``'s configurations: the
    test's own run stands in); the raw path's by make_raw_train_step."""
    jcfg = s[0]
    if jcfg.pet.use_hyperformer or getattr(jcfg.backbone, "dropout", 0) > 0:
        return None
    if not jcfg.pet.use_vis_adapter:
        return jax_steps(s, opt)
    _, jmodel, variables, jbatch, _, _ = s
    params, stats = variables["params"], variables["batch_stats"]
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **opt)
    step = raw_test.jstep_fn(jmodel, tx, TASKS)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    losses, norms = [], []
    for _ in range(3):
        state, m = step(state, frozen, stats, jbatch, jax.random.PRNGKey(0),
                        0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, flax_to_state_dict(jax.device_get(state.params))


@pytest.fixture(scope="module")
def tail_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jclip._RESNET_CONFIGS, "RN_tiny", TINY_RN)
        mp.setitem(tclip._RESNET_CONFIGS, "RN_tiny", TINY_RN)
        run = families_run(FAMILIES, setup=setup, jax_fn=jax_fn)
        s = setup(FAMILIES["hyperformer"][0]())
        one = run_steps(**case_of(s, steps=3, opt=OPT))
    return run, one


@pytest.mark.parametrize("name", [n for n in FAMILIES if n not in PORT_ONLY])
def test_tp_family_matches_jax(tail_run, name):
    run, _ = tail_run
    check_family(run, name, (1, 2))
    if name == "raw":  # the trunk whole on every rank
        _, _, ports, names, _, ranks = run
        shapes = ranks[(1, 2)][1]["train"][names[(1, 2)].index(name)]["shapes"]
        for n, p in ports[name].named_parameters():
            if n.startswith("vis_encoder."):
                assert shapes[n] == tuple(p.shape), n


def _ranks_of(run, name):
    _, _, _, names, _, ranks = run
    return [r["train"][names[(1, 2)].index(name)] for r in ranks[(1, 2)]]


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_equals_none_bit_for_bit_split(tail_run, mode):
    run, _ = tail_run
    none = _ranks_of(run, "drop_none")
    for r, ref in zip(_ranks_of(run, f"drop_remat_{mode}"), none):
        assert r["losses"] == ref["losses"] and r["norms"] == ref["norms"]
        for n, p in ref["params"].items():
            assert torch.equal(r["params"][n], p), n
    assert none[0]["losses"] == none[1]["losses"]


def test_hyperformer_split_equals_one_process(tail_run):
    run, one = tail_run
    for r in _ranks_of(run, "hyperformer"):
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["norms"], one["norms"], rtol=1e-5)
        for n, w in one["params"].items():
            np.testing.assert_allclose(
                r["params"][n].numpy(), w.numpy(), rtol=1e-3,
                atol=max(1e-8, 1e-5 * w.abs().max().item()), err_msg=n)


# --- every flag ---------------------------------------------------------------

def _tiny(t5: bool):
    if t5:
        return pc.VLModelConfig(
            backbone=pc.T5Config(vocab_size=64, d_model=64, d_kv=16, d_ff=64,
                                 num_layers=1, num_decoder_layers=1,
                                 num_heads=4),
            vis=pc.VisConfig(feat_dim=16, n_boxes=4))
    return pc.VLModelConfig(
        backbone=pc.BartConfig(vocab_size=64, d_model=64, encoder_layers=1,
                               decoder_layers=1, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=64,
                               decoder_ffn_dim=64,
                               max_position_embeddings=64),
        vis=pc.VisConfig(feat_dim=16, n_boxes=4))


def _flag_cfgs(t5: bool):
    """(label, config) for every boolean PetConfig field on, and the
    model-level flags."""
    base = _tiny(t5)
    pet = pc.PetConfig(tasks=TASKS)
    out = []
    for f in dataclasses.fields(pc.PetConfig):
        if isinstance(getattr(pet, f.name), bool):
            out.append((f.name, dataclasses.replace(base, pet=dataclasses.replace(
                pet, **{f.name: not getattr(pet, f.name)}))))
    base = dataclasses.replace(base, pet=pet)
    out += [("classifier", dataclasses.replace(base, classifier=True,
                                               num_answers=3)),
            ("remat_full", dataclasses.replace(base, remat="full")),
            ("remat_dots", dataclasses.replace(base, remat="dots")),
            ("vis.use_vis_prefix", dataclasses.replace(
                base, vis=dataclasses.replace(base.vis, use_vis_prefix=True))),
            ("scan_layers", dataclasses.replace(base, scan_layers=True))]
    return out


@pytest.mark.parametrize("t5", [False, True], ids=["bart", "t5"])
def test_every_flag_one_process_builds_runs_split(t5):
    refused, built = [], []
    for label, cfg in _flag_cfgs(t5):
        try:
            model = (VLT5 if t5 else VLBart)(cfg, device="meta")
        except NotImplementedError:
            refused.append(label)
            with pytest.raises(NotImplementedError):
                check_tensor_parallel(cfg)
            continue
        built.append(label)
        check_tensor_parallel(cfg)
        report = sharding_report(model, 2)
        assert all(why for _, _, _, why in report), label
        assert any(sharded for _, _, sharded, _ in report), label
        shard_model(model, Layout(data=1, model=2, model_index=1))
        assert model.tp.size == 2, label
    assert "scan_layers" in refused
    assert len(built) >= (60 if t5 else 100), built
    assert t5 or refused == ["scan_layers"], refused
