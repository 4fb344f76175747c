"""The VL-PET-small, -middleX, -middleY gates and the full d x d GateLargeX
in the port against the JAX package, on the BART backbone, on CPU
(tests/test_torch_gates_t5.py runs the same checks on T5 with these
helpers).

Tiny configurations, fp32, dropout 0.0: BART as
``__graft_entry__._flagship_cfg(tiny=True)`` (d 64, 2+2 layers, vocab 128)
with ``vlpet_recipe(variant, r 16, 4 heads)``; "largeX" is the recipe
without a gate plus ``use_encoder_adapter_gating_large_x``. The JAX init is
spread to a scale where every gate matters (norm scales 1 + N(0, 0.1), the
rest N(0, 0.2)) and carried to the port by vlpet_tpu_torch.convert. The
batch has a ragged padding mask, so the small gate's mean over all L tokens
includes padded ones, as the JAX mean does. Per gate:

* the teacher-forced per-token loss and logits within 1e-5 (1 + max|jax|);
* a 3-step lockstep of the port's make_train_step against
  vlpet_tpu/train/steps.py make_train_step (vqa): per-step loss and
  gradient norm within 1e-5 relative, trainable parameters within rtol
  1e-3, atol 1e-5 * max|p| (chip_smoke.py phase 6's tolerances), frozen
  ones unchanged;
* beam-5 tokens identical to the JAX seq2seq_generate;
* the trainable set, by name, equal to the JAX freezing engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models import generate as tgen
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
TASKS = ("vqa", "gqa", "nlvr", "caption")
B, L_TXT, L_TGT = 4, 6, 4
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
VARIANTS = ["small", "middleX", "middleY", "largeX"]
GATE_KEYS = {"small": "gating_small_xy_cat", "middleX": "gating_middle_xy_add",
             "middleY": "gating_middle_ia3", "largeX": "gating_large_x"}


def jax_pet(variant: str, t5: bool, r: int):
    if variant == "largeX":
        return dataclasses.replace(
            vlpet_recipe("none", r=r, num_heads=4, tasks=TASKS, t5=t5),
            use_encoder_adapter_gating_large_x=True)
    return vlpet_recipe(variant, r=r, num_heads=4, gate_dim=r, tasks=TASKS,
                        t5=t5)


def jax_cfg(backbone: str, variant: str) -> VLModelConfig:
    if backbone == "bart":
        from __graft_entry__ import _flagship_cfg

        cfg, _ = _flagship_cfg(tiny=True)
        return dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, dropout=0.0),
            pet=jax_pet(variant, False, 16))
    return VLModelConfig(
        backbone=T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_decoder_layers=2, num_heads=4,
                          dropout_rate=0.0),
        vis=VisConfig(feat_dim=16, n_boxes=4), pet=jax_pet(variant, True, 8))


def port_cfg(jcfg) -> pc.VLModelConfig:
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    bk = pc.T5Config if jcfg.is_t5 else pc.BartConfig
    return pc.VLModelConfig(backbone=bk(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _models(jcfg):
    if jcfg.is_t5:
        from vlpet_tpu.models.t5 import VLT5 as J
        from vlpet_tpu_torch.models.t5 import VLT5 as T
    else:
        from vlpet_tpu.models.vlbart import VLBart as J
        from vlpet_tpu_torch.models.vlbart import VLBart as T
    return J, T


def setup(backbone: str, variant: str):
    """(jcfg, jmodel, params, jbatch, tbatch, port model) from one seed."""
    return setup_cfg(jax_cfg(backbone, variant))


def setup_cfg(jcfg):
    """``setup`` for a given JAX config."""
    J, T = _models(jcfg)
    rng = np.random.default_rng(0)
    V, nb, fd = jcfg.backbone.vocab_size, jcfg.vis.n_boxes, jcfg.vis.feat_dim
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, L_TXT - 2:] = 0
    mask[3, L_TXT - 1:] = 0
    targets = rng.integers(3, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100
    batch = dict(input_ids=rng.integers(3, V, (B, L_TXT)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B, nb, fd)).astype(np.float32),
                 boxes=rng.uniform(size=(B, nb, 4)).astype(np.float32),
                 target_ids=targets,
                 scores=rng.uniform(0.3, 1.0, B).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = J(jcfg)
    # every leaf is drawn anew, so the init's shapes are all it needs
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jbatch["input_ids"], jbatch["attention_mask"],
        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
        labels=jbatch["target_ids"], ctx=JCtx())["params"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), shapes)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    port = load_flax_params(T(port_cfg(jcfg), device="cpu"), params)
    return jcfg, jmodel, params, jbatch, tbatch, port


def check_forward(s, task="vqa", tasks=TASKS, keys=("loss", "logits")):
    jcfg, jmodel, params, jbatch, tbatch, port = s
    ti = tasks.index(task)
    want = jmodel.apply({"params": params}, jbatch["input_ids"],
                        jbatch["attention_mask"],
                        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
                        labels=jbatch["target_ids"],
                        ctx=JCtx(task=task, task_idx=ti))
    with torch.no_grad():
        got = port(tbatch["input_ids"], tbatch["attention_mask"],
                   tbatch["vis_feats"], tbatch["boxes"],
                   labels=tbatch["target_ids"],
                   ctx=PetContext(task=task, task_idx=ti))
    for key in keys:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()),
                                   err_msg=key)


def check_lockstep(s, task="vqa", tasks=TASKS):
    jcfg, jmodel, params, jbatch, tbatch, _ = s
    ti = tasks.index(task)
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, tasks)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    want_losses, want_norms = [], []
    for _ in range(K):
        state, m = jstep(state, frozen, jbatch, jax.random.PRNGKey(0), ti)
        want_losses.append(float(m["loss"]))
        want_norms.append(float(m["grad_norm"]))
    want_params = flax_to_state_dict(jax.device_get(state.params))

    _, T = _models(jcfg)
    model = load_flax_params(T(port_cfg(jcfg), device="cpu"), params)
    named = apply_freezing(model, model.cfg.pet)
    assert set(named) == set(want_params)
    frozen_before = {n: p.detach().clone()
                     for n, p in model.named_parameters() if n not in named}
    step = make_train_step(model, build_optimizer(named, **OPT), tasks,
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(K):
        out = step(tbatch, gen, ti)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for name, p in named.items():
        want = want_params[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(want).max()), err_msg=name)
    for name, p in model.named_parameters():
        if name in frozen_before:
            assert torch.equal(p, frozen_before[name]), name


def check_beam5(s, task="caption", tasks=TASKS):
    jcfg, jmodel, params, jbatch, tbatch, port = s
    ti = tasks.index(task)
    keys = ("input_ids", "attention_mask", "vis_feats", "boxes")
    want = np.asarray(jgen.seq2seq_generate(
        jmodel, {"params": params}, **{k: jbatch[k] for k in keys},
        ctx=JCtx(task=task, task_idx=ti), num_beams=5, max_length=8))
    with torch.no_grad():
        got = tgen.seq2seq_generate(port, **{k: tbatch[k] for k in keys},
                                    ctx=PetContext(task=task, task_idx=ti),
                                    num_beams=5, max_length=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, 1:])) > 2  # not a degenerate decode


def check_trainable_set(s, variant):
    jcfg, _, params, _, _, port = s
    want = set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, m: np.zeros(p.shape, np.float32) if m else None, params,
        trainable_mask(params, jcfg.pet))))
    got = set(apply_freezing(port, port.cfg.pet))
    assert got == want
    gated = {n for n in got if GATE_KEYS[variant] in n}
    if jcfg.is_t5 and variant == "largeX":
        assert not gated  # the JAX T5 builds no GateLargeX
    else:
        assert gated


@pytest.fixture(scope="module", params=VARIANTS)
def bart_gate(request):
    return request.param, setup("bart", request.param)


def test_bart_gate_forward_and_loss_match_jax(bart_gate):
    check_forward(bart_gate[1])


def test_bart_gate_train_lockstep_with_jax(bart_gate):
    check_lockstep(bart_gate[1])


def test_bart_gate_beam5_tokens_match_jax(bart_gate):
    check_beam5(bart_gate[1])


def test_bart_gate_trainable_set_matches_jax(bart_gate):
    check_trainable_set(bart_gate[1], bart_gate[0])
