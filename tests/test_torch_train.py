"""The port's training step in lockstep with the JAX package's, on CPU.

The tiny flagship configuration (BART + VL-PET-large,
__graft_entry__._flagship_cfg(tiny=True)) with dropout 0.0 -- off the TPU
the JAX ResidualDropoutLayerNorm draws jax.random.bernoulli masks, which no
port can reproduce; dropout parity is held at the op level
(tests/test_torch_train_ops.py) -- fp32, batch 4. The same seeded weights
go to both (flax params -> vlpet_tpu_torch.convert), and each framework
runs K = 3 steps of make_train_step + build_optimizer (clip 5, HF AdamW,
linear warmup). Per step the loss and the gradient norm agree within 1e-5
relative; after K steps the trainable parameters agree within the repo's
lockstep tolerance (rtol 1e-3, atol 1e-5 * max|p|,
tests/test_training_parity.py) and the frozen ones are unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import split_params, trainable_mask
from vlpet_tpu.train.optim import build_optimizer as jbuild_optimizer
from vlpet_tpu.train.steps import TrainState, make_train_step as jmake_step
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models.vlbart import VLBart, shift_tokens_right
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)  # several xdist workers share the host

K = 3
B, L_TXT, L_TGT = 4, 6, 4
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)


def _port_cfg(jcfg):
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.BartConfig(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


@pytest.fixture(scope="module")
def lockstep():
    jcfg, tasks = _flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, dropout=0.0))
    rng = np.random.default_rng(0)
    V, nb, fd = jcfg.backbone.vocab_size, jcfg.vis.n_boxes, jcfg.vis.feat_dim
    mask = np.ones((B, L_TXT), np.int32)
    mask[1, 4:] = 0
    targets = rng.integers(3, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100  # padded labels
    batch = dict(input_ids=rng.integers(3, V, (B, L_TXT)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B, nb, fd)).astype(np.float32),
                 boxes=rng.uniform(size=(B, nb, 4)).astype(np.float32),
                 target_ids=targets,
                 scores=rng.uniform(0.3, 1.0, B).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JVLBart(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jbatch["input_ids"], jbatch["attention_mask"],
        vis_feats=jbatch["vis_feats"], boxes=jbatch["boxes"],
        labels=jbatch["target_ids"], ctx=JCtx())["params"])
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    # one jitted JAX step for the module (one compile per static task)
    trainable, _ = split_params(params, trainable_mask(params, jcfg.pet))
    tx = jbuild_optimizer(trainable, **OPT)
    jstep = jmake_step(jmodel, tx, tasks)
    return jcfg, tasks, jmodel, params, jbatch, tbatch, tx, jstep


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
def test_train_step_lockstep_with_jax(lockstep, task):
    jcfg, tasks, jmodel, params, jbatch, tbatch, tx, jstep = lockstep
    task_idx = tasks.index(task)
    want_losses, want_norms, want_params = _jax_run(jcfg, params, jbatch, tx,
                                                    jstep, task_idx)

    model = load_flax_params(VLBart(_port_cfg(jcfg), device="cpu"), params)
    trainable = apply_freezing(model, model.cfg.pet)
    assert set(trainable) == set(want_params)
    frozen_before = {n: p.detach().clone()
                     for n, p in model.named_parameters()
                     if n not in trainable}
    step = make_train_step(model, build_optimizer(trainable, **OPT), tasks,
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


def test_forward_loss_and_shift_match_jax(lockstep):
    """The deterministic teacher-forced forward: per-token loss and logits
    within 1e-5, decoder inputs equal."""
    from vlpet_tpu.models.vlbart import shift_tokens_right as jshift

    jcfg, tasks, jmodel, params, jbatch, tbatch, _, _ = lockstep
    b = jcfg.backbone
    np.testing.assert_array_equal(
        shift_tokens_right(tbatch["target_ids"], b.pad_token_id,
                           b.decoder_start_token_id).numpy(),
        np.asarray(jshift(jbatch["target_ids"], b.pad_token_id,
                          b.decoder_start_token_id)))
    want = jmodel.apply({"params": params}, jbatch["input_ids"],
                        jbatch["attention_mask"], vis_feats=jbatch["vis_feats"],
                        boxes=jbatch["boxes"], labels=jbatch["target_ids"],
                        ctx=JCtx(task="caption", task_idx=3))
    model = load_flax_params(VLBart(_port_cfg(jcfg), device="cpu"), params)
    with torch.no_grad():
        got = model(tbatch["input_ids"], tbatch["attention_mask"],
                    tbatch["vis_feats"], tbatch["boxes"],
                    labels=tbatch["target_ids"],
                    ctx=PetContext(task="caption", task_idx=3))
    for key in ("loss", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
