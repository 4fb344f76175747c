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
tests/test_training_parity.py) and the frozen ones are unchanged. A tiny
video-shaped case (the video tasks, 8 frames of 16-d features with zero
boxes, 24 text tokens, task tvqa) runs the same lockstep, and the port's
full-width video configuration is held against the one the JAX video CLI
builds from scripts/video-text/VL-PET-large.sh.
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
L_TXT_VIDEO = 24
OPT = dict(lr=1e-3, total_steps=4, warmup_ratio=0.1)


def _port_cfg(jcfg):
    """The JAX config as the port's own (a dataclasses.asdict round trip)."""
    d = dataclasses.asdict(jcfg)
    return pc.VLModelConfig(backbone=pc.BartConfig(**d.pop("backbone")),
                            vis=pc.VisConfig(**d.pop("vis")),
                            pet=pc.PetConfig(**d.pop("pet")), **d)


def _setup(jcfg, tasks, L_txt, zero_boxes=False):
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, dropout=0.0))
    rng = np.random.default_rng(0)
    V, nb, fd = jcfg.backbone.vocab_size, jcfg.vis.n_boxes, jcfg.vis.feat_dim
    mask = np.ones((B, L_txt), np.int32)
    mask[1, L_txt - 2:] = 0
    targets = rng.integers(3, V, (B, L_TGT)).astype(np.int32)
    targets[2, 2:] = -100  # padded labels
    batch = dict(input_ids=rng.integers(3, V, (B, L_txt)).astype(np.int32),
                 attention_mask=mask,
                 vis_feats=rng.normal(size=(B, nb, fd)).astype(np.float32),
                 boxes=(np.zeros((B, nb, 4), np.float32) if zero_boxes else
                        rng.uniform(size=(B, nb, 4)).astype(np.float32)),
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


@pytest.fixture(scope="module")
def lockstep():
    return _setup(*_flagship_cfg(tiny=True), L_TXT)


@pytest.fixture(scope="module")
def video_lockstep():
    """The tiny flagship backbone with the video tasks and video-shaped
    inputs: 24 text tokens + 8 frames of 16-d features, zero boxes."""
    from vlpet_tpu.cli.multitask_video import VIDEO_TASKS
    from vlpet_tpu.config import VisConfig, vlpet_recipe

    jcfg, _ = _flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(
        jcfg, vis=VisConfig(feat_dim=16, n_boxes=8),
        pet=vlpet_recipe("large", r=16, num_heads=4, gate_dim=16,
                         tasks=VIDEO_TASKS))
    return _setup(jcfg, VIDEO_TASKS, L_TXT_VIDEO, zero_boxes=True)


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


def _check_lockstep(setup, task):
    jcfg, tasks, jmodel, params, jbatch, tbatch, tx, jstep = setup
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


@pytest.mark.parametrize("task", ["vqa", "caption"])
def test_train_step_lockstep_with_jax(lockstep, task):
    _check_lockstep(lockstep, task)


def test_video_train_step_lockstep_with_jax(video_lockstep):
    _check_lockstep(video_lockstep, "tvqa")


def test_video_cfg_is_the_video_cli_config():
    """video_cfg() equals, field for field, what the JAX video CLI
    (vlpet_tpu/cli/multitask_video.py) builds from the flags of
    scripts/video-text/VL-PET-large.sh at r 96, 4 heads, gate 96, VPA 96,
    lr 7e-4: the parsed arguments, feat_dim forced to 512, the video
    tasks."""
    from vlpet_tpu.cli.multitask_video import VIDEO_TASKS
    from vlpet_tpu.cli.param import build_model_config, parse_args

    argv = ("--optim adamw --warmup_ratio 0.1 --clip_grad_norm 5 --lr 7e-4 "
            "--epochs 20 --backbone facebook/bart-base --num_beams 5 "
            "--batch_size 50 --valid_batch_size 50 --reduction_factor 8 "
            "--use_tasks_prompts --tasks tvqa,how2qa,tvc,yc2c "
            "--feature_type RN101 --n_boxes 64 --image_size (224,224) "
            "--use_adapter --use_single_adapter --no_encoder_adapter "
            "--use_adapter_down_dim --use_encoder_adapter_down_multihead "
            "--adapter_down_dim 96 --encoder_adapter_multihead_num_head 4 "
            "--use_encoder_adapter_gating_large_x_lowrank "
            "--adapter_gating_down_dim 96 --unfreeze_encoder_layer_norms "
            "--no_decoder_adapter "
            "--use_decoder_enc_attn_value_parallel_adapter_down_dim "
            "--decoder_enc_attn_value_parallel_adapter_down_dim 96").split()
    args = parse_args(argv)
    args.feat_dim = 512  # as multitask_video.main forces it
    want = build_model_config(args, VIDEO_TASKS)
    got = pc.video_cfg()
    assert pc.VIDEO_TASKS == VIDEO_TASKS
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert pc.video_cfg("bfloat16").dtype == "bfloat16"


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
