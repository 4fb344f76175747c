"""The port's T5 training step against the JAX package, on CPU.

A tiny T5 (2+2 layers, d 32, 4 heads, vocab 80, as tests/test_torch_t5.py)
with visual features (4 boxes of 16-d) and VL-PET-large at r 8 with the T5
recipe flags, in both forms: relu FFN with the tied head, and the
gated-gelu FFN with an untied lm_head. Checked:

* the trainable set, by name, equals the JAX freezing engine's for both
  forms (the RMSNorm scales under unfreeze_encoder_layer_norms, the
  multihead adapters and gates, the decoder VPA; relative_attention_bias,
  shared and lm_head frozen), and at full width (config.t5_cfg, both
  forms) the trainable share equals the JAX package's (jax.eval_shape on
  the JAX side, device="meta" on the port's);
* a 3-step lockstep of vlpet_tpu_torch.train.steps.make_train_step against
  vlpet_tpu.train.steps.make_train_step, tasks vqa and caption, fp32, from
  the same seeded weights (flax params spread to a scale where every
  adapter and gate contributes, carried by vlpet_tpu_torch.convert): per
  step loss and gradient norm within 1e-5 relative, trainable parameters
  within rtol 1e-3, atol 1e-5 * max|p| (tests/test_training_parity.py's
  lockstep tolerance), frozen parameters unchanged;
* at dropout 0.1 the training forward draws exactly ``dropout_sites``
  seeds, one per site.

The lockstep runs at dropout 0.0: off the TPU the JAX T5 draws flax
nn.Dropout masks on the attention probabilities and the FFN hidden, which
no port reproduces, so whole-model parity at rate > 0 holds only kernels
against plain twins, on the card (chip_smoke.py phase 6c); the dropout of
every kernel is held against the JAX kernels in
tests/test_torch_t5_train_ops.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.models.t5 import VLT5 as JVLT5
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import (split_params, trainable_mask,
                                      trainable_report as jreport)
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models import t5 as tt5
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.train.freezing import apply_freezing, trainable_report
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
TASKS = ("vqa", "gqa", "nlvr", "caption")
B, L_TXT, L_TGT, N_BOX, FEAT = 4, 6, 4, 4, 16
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)
FORMS = ["relu_tied", "gated_untied"]


def _jax_cfg(gated: bool, dropout: float = 0.0) -> VLModelConfig:
    extra = (dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False)
             if gated else {})
    return VLModelConfig(
        backbone=T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_decoder_layers=2, num_heads=4,
                          dropout_rate=dropout, **extra),
        vis=VisConfig(feat_dim=FEAT, n_boxes=N_BOX),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS,
                         t5=True))


def _port_cfg(jcfg) -> pc.VLModelConfig:
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.T5Config(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _spread(params, rng):
    """Every leaf at a seeded scale where the zero-init ups, the adapters
    and the gates all contribute: norm scales 1 + N(0, 0.1), everything
    else N(0, 0.2)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if path[-1].key == "scale" else 0.0)
                         + rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if path[-1].key == "scale" else 0.2)), params)


def _batch(rng, V):
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, L_TXT - 2:] = 0
    targets = rng.integers(2, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100  # padded labels
    return dict(input_ids=rng.integers(2, V, (B, L_TXT)).astype(np.int32),
                attention_mask=mask,
                vis_feats=rng.normal(size=(B, N_BOX, FEAT)).astype(np.float32),
                boxes=rng.uniform(size=(B, N_BOX, 4)).astype(np.float32),
                target_ids=targets,
                scores=rng.uniform(0.3, 1.0, B).astype(np.float32))


@pytest.fixture(scope="module", params=FORMS)
def t5_lockstep(request):
    jcfg = _jax_cfg(gated=request.param == "gated_untied")
    rng = np.random.default_rng(0)
    batch = _batch(rng, jcfg.backbone.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLT5(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jbatch["input_ids"], jbatch["attention_mask"],
        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
        labels=jbatch["target_ids"], ctx=JCtx())["params"])
    params = _spread(params, rng)
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    trainable, _ = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, TASKS)
    return jcfg, params, jbatch, tbatch, tx, jstep


def _jax_run(jcfg, params, jbatch, tx, step, task_idx):
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, trainable),
                              tx)
    losses, norms = [], []
    for _ in range(K):
        state, metrics = step(state, frozen, jbatch, jax.random.PRNGKey(0),
                              task_idx)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, flax_to_state_dict(jax.device_get(state.params))


@pytest.mark.parametrize("task", ["vqa", "caption"])
def test_t5_train_step_lockstep_with_jax(t5_lockstep, task):
    jcfg, params, jbatch, tbatch, tx, jstep = t5_lockstep
    task_idx = TASKS.index(task)
    want_losses, want_norms, want_params = _jax_run(jcfg, params, jbatch, tx,
                                                    jstep, task_idx)

    model = load_flax_params(VLT5(_port_cfg(jcfg), device="cpu"), params)
    trainable = apply_freezing(model, model.cfg.pet)
    assert set(trainable) == set(want_params)
    frozen_before = {n: p.detach().clone()
                     for n, p in model.named_parameters()
                     if n not in trainable}
    step = make_train_step(model, build_optimizer(trainable, **OPT), TASKS,
                           device="cpu")
    generator = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(K):
        out = step(tbatch, generator, task_idx)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))

    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for name, p in trainable.items():
        want = want_params[name].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-3,
            atol=max(1e-8, 1e-5 * np.abs(want).max()), err_msg=name)
    for name, p in model.named_parameters():
        if name in frozen_before:
            assert torch.equal(p, frozen_before[name]), name


@pytest.mark.parametrize("form", FORMS)
def test_t5_trainable_set_matches_jax_freezing(form):
    """By name, on the tiny model: the port's apply_freezing selects what
    the JAX trainable_mask selects; the relative bias, the embedding and
    the head stay frozen, and every block's RMSNorm scales train."""
    jcfg = _jax_cfg(gated=form == "gated_untied")
    jmodel = JVLT5(jcfg)
    kw = dict(vis_feats=jnp.zeros((1, N_BOX, FEAT)),
              boxes=jnp.zeros((1, N_BOX, 4)),
              labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx())
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 3), jnp.int32),
        jnp.ones((1, 3), jnp.int32), **kw))["params"]
    want = set(flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, m: np.zeros(p.shape, np.float32) if m else None, params,
        trainable_mask(params, jcfg.pet))))
    model = VLT5(_port_cfg(jcfg), device="meta")
    got = set(apply_freezing(model, model.cfg.pet))
    assert got == want
    assert not any("relative_attention_bias" in n or n.endswith("shared")
                   or n.startswith("lm_head") for n in got)
    assert {n for n in got if n.endswith("layer_norm.scale")} == {
        n for n, _ in model.named_parameters()
        if ".encoder." in n and n.endswith("layer_norm.scale")}
    assert any("cross_attn.attn_value_parallel_adapter" in n for n in got)
    assert any("adapter_multihead" in n for n in got)
    assert any("gating_large_x_lowrank" in n for n in got)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_trainable_share_at_full_width_matches_jax(gated):
    """config.t5_cfg at full width: the trainable and total parameter
    counts of the port equal the JAX package's."""
    cfg = pc.t5_cfg(gated=gated)
    jcfg = _jax_cfg_of(cfg)
    jmodel = JVLT5(jcfg)
    kw = dict(vis_feats=jnp.zeros((1, cfg.vis.n_boxes, cfg.vis.feat_dim)),
              boxes=jnp.zeros((1, cfg.vis.n_boxes, 4)),
              labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx())
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 3), jnp.int32),
        jnp.ones((1, 3), jnp.int32), **kw))["params"]
    want = jreport(params, trainable_mask(params, jcfg.pet))
    got = trainable_report(VLT5(cfg, device="meta"), cfg.pet)
    assert (got["trainable"], got["total"]) == (want["trainable"],
                                                 want["total"])
    assert 0.0 < got["percentage"] < 10.0


def _jax_cfg_of(cfg: pc.VLModelConfig) -> VLModelConfig:
    """The port's config as the JAX package's (an asdict round trip)."""
    from vlpet_tpu.config import PetConfig

    d = dataclasses.asdict(cfg)
    return VLModelConfig(backbone=T5Config(**d.pop("backbone")),
                         vis=VisConfig(**d.pop("vis")),
                         pet=PetConfig(**d.pop("pet")), **d)


@pytest.mark.parametrize("form", FORMS)
def test_t5_training_forward_uses_every_dropout_site_once(form, monkeypatch):
    """At dropout 0.1 one training forward draws ``dropout_sites`` seeds
    and consumes every one of them; the loss is finite and its gradient
    reaches every trainable parameter."""
    jcfg = _jax_cfg(gated=form == "gated_untied", dropout=0.1)
    model = VLT5(_port_cfg(jcfg), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    trainable = apply_freezing(model, model.cfg.pet)
    drawn = []

    class Recording(tt5.DropoutSeeds):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            drawn.append(self)

    monkeypatch.setattr(tt5, "DropoutSeeds", Recording)
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v)
             for k, v in _batch(np.random.default_rng(1), 80).items()}
    out = model(batch["input_ids"], batch["attention_mask"],
                batch["vis_feats"], batch["boxes"],
                labels=batch["target_ids"], deterministic=False,
                generator=torch.Generator().manual_seed(3), reduce_loss=True)
    (seeds,) = drawn
    assert seeds.seeds.numel() == model.dropout_sites() == 4 + 4 * 2 + 6 * 2
    assert seeds.used == seeds.seeds.numel()
    assert torch.isfinite(out["loss"])
    grads = torch.autograd.grad(out["loss"], list(trainable.values()),
                                allow_unused=True)
    assert all(g is not None for g in grads)
