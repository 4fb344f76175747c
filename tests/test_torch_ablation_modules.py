"""The modules of the VL-PET ablations in the port against the JAX package,
module by module, on CPU, with tests/test_torch_pet_modules.py ``run``
(the JAX init spread -- norm scales 1 + N(0, 0.1), the rest N(0, 0.2) --
carried to the port strict; every output within 1e-5 (1 + max|jax|)):

* the multihead adapters of the four shapes (down, up, down-up, pair);
* the low-rank visual projector with and without its gate, residual
  connection and individual norms, T5's RMSNorm form; the expand
  projector with and without its LayerNorm, on (B, N, feat) and (B, feat)
  features;
* the standalone gate's (gate, pre-sigmoid) pair;
* one BART encoder layer under the LayerNorm gate, the L2 gate (on the
  attention sublayer too under ``no_encoder_attn_adapter``), the
  standalone gate in both forms and the pair adapter under the low-rank
  gate;
* ``lambda_z``: the step's loss with the z penalty (single_adapter.sh's
  flags with ``--track_z``, the tiny BART of
  tests/test_torch_ablation_recipes.py) and its gradient for every
  trainable parameter, against ``jax.value_and_grad`` of the JAX step's
  loss (vlpet_tpu/train/steps.py:79-98), at the recipe's 1e-3 and at 1;
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.models.bart as jb
import vlpet_tpu.models.visual as jv
import vlpet_tpu.pet.modules as jm
import vlpet_tpu_torch.models.bart as tb
import vlpet_tpu_torch.models.visual as tv
import vlpet_tpu_torch.pet.modules as tm
from test_torch_ablation_recipes import ablation_cfg
from test_torch_gates import port_cfg, setup_cfg
from test_torch_pet_modules import _spread, _x, run, t
from vlpet_tpu import config as jc
from vlpet_tpu.models.heads import task_loss as jtask_loss
from vlpet_tpu.train.freezing import (merge_params, split_params,
                                      trainable_mask)
from vlpet_tpu_torch import config as pc
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models.heads import task_loss
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.steps import z_penalty

torch.set_num_threads(2)  # several xdist workers share the host

D = 16
MULTIHEAD = {"down": (jm.MultiheadDownAdapter, tm.MultiheadDownAdapter),
             "up": (jm.MultiheadUpAdapter, tm.MultiheadUpAdapter),
             "down_up": (jm.MultiheadDownUpAdapter, tm.MultiheadDownUpAdapter),
             "pair": (jm.MultiheadPairAdapter, tm.MultiheadPairAdapter)}

@pytest.mark.parametrize("shape", MULTIHEAD)
def test_multihead_adapter(shape):
    J, T = MULTIHEAD[shape]
    x = _x(2, 5, D)
    params = run(J(d_model=D, down_dim=8, num_heads=4, init_std=0.02),
                 (jnp.asarray(x),), T(D, 8, 4, device="cpu"), (t(x),))
    if shape == "pair":  # block-diagonal: one (r/h, d/h) block a head
        assert params["up_kernel"].shape == (4, 2, 4)


def _vis(**kw):
    return jc.VisConfig(feat_dim=12, n_boxes=4, visual_projector_down_dim=8,
                        visual_projector_multihead_num_head=4,
                        visual_projector_gating_down_dim=6, **kw)


def _vis_args(n=4, B=2):
    feats, pos = _x(B, n, 12, seed=3), _x(B, n, 4, seed=4)
    table = _x(40, D, seed=5)
    return feats, pos, table


@pytest.mark.parametrize("gate,residual,individual,t5", [
    (False, False, True, False), (True, False, True, False),
    (True, True, False, False), (True, True, True, True)])
def test_lowrank_visual_embedding(gate, residual, individual, t5):
    vis = _vis(use_lowrank_visual_projector=True,
               use_visual_projector_gating_large_x_lowrank=gate,
               use_visual_projector_residual_connection=residual,
               individual_vis_layer_norm=individual)
    feats, pos, table = _vis_args()
    run(jv.LowRankVisualEmbedding(vis, D, init_std=None if t5 else 0.02,
                                  t5_style_ln=t5),
        tuple(map(jnp.asarray, (feats, pos, table))),
        tv.LowRankVisualEmbedding(pc.VisConfig(**dataclasses.asdict(vis)), D,
                                  device="cpu", t5_style_ln=t5),
        tuple(map(t, (feats, pos, table))))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_expand_visual_embedding(norm, flat):
    vis = _vis(expand_vis_embedding=True, n_image_tokens=3,
               use_vis_layer_norm=norm)
    feats, pos, table = _vis_args()
    if flat:
        feats = feats[:, 0]
    got = run(jv.ExpandVisualEmbedding(vis, D, init_std=0.02),
              tuple(map(jnp.asarray, (feats, pos, table))),
              tv.ExpandVisualEmbedding(pc.VisConfig(**dataclasses.asdict(vis)),
                                       D, device="cpu"),
              tuple(map(t, (feats, pos, table))))
    assert ("layer_norm" in got) == norm


def test_standalone_gate_returns_the_pre_sigmoid():
    x = _x(2, 5, D)
    kw = dict(return_pre_sigmoid=True)
    run(jm.GateLargeXLowRank(D, 8, init_std=0.02), (jnp.asarray(x),),
        tm.GateLargeXLowRank(D, 8, device="cpu"), (t(x),), kw, kw)


MH = dict(use_adapter_down_dim=True, adapter_down_dim=8,
          encoder_adapter_multihead_num_head=4)
LAYER_CASES = {
    "layernorm": dict(use_encoder_adapter_down_multihead=True,
                      use_encoder_adapter_gating_layernorm=True, **MH),
    "l2norm": dict(use_encoder_adapter_down_multihead=True,
                   use_encoder_adapter_gating_l2norm=True, **MH),
    # the norms are not kept off the attention sublayer
    # (the small gate is: L2 on the attention sublayer, the small gate on
    # the FFN's)
    "l2norm_no_attn": dict(use_encoder_adapter_gating_l2norm=True,
                           use_encoder_adapter_gating_small_xy_cat=True,
                           no_encoder_attn_adapter=True),
    "standalone": dict(use_encoder_gating_large_x_lowrank=True,
                       gating_down_dim=8),
    "standalone_add_x2": dict(
        use_encoder_gating_large_x_lowrank=True, gating_down_dim=8,
        use_encoder_gating_large_x_lowrank_add_x2_deltay=True),
    "pair_gated": dict(use_encoder_adapter_down_up_pair_multihead=True,
                       use_encoder_adapter_gating_large_x_lowrank=True,
                       adapter_gating_down_dim=8, **MH),
}


@pytest.mark.parametrize("case", LAYER_CASES)
def test_encoder_layer_gating(case):
    jcfg = jc.VLModelConfig(
        backbone=jc.BartConfig(vocab_size=64, d_model=D, encoder_layers=1,
                               decoder_layers=1, encoder_attention_heads=4,
                               decoder_attention_heads=4, encoder_ffn_dim=32,
                               decoder_ffn_dim=32, dropout=0.0),
        pet=jc.PetConfig(**LAYER_CASES[case]))
    h = jnp.asarray(_x(2, 6, D))
    mask = np.zeros((2, 1, 1, 6), np.float32)
    mask[1, ..., 4:] = -1e9
    ctx = jm.PetContext()
    layer = jb.BartEncoderLayer(jcfg)
    params = _spread(layer.init(jax.random.PRNGKey(0), h, jnp.asarray(mask),
                                ctx)["params"])
    want = layer.apply({"params": params}, h, jnp.asarray(mask), ctx)
    port = tb.BartEncoderLayer(port_cfg(jcfg), device="cpu")
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(t(h), t(mask), tm.PetContext())
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * (1 + np.abs(w).max()))
    if case == "l2norm_no_attn":
        assert port.gate("attn")[0] == "use_encoder_adapter_gating_l2norm"
        assert port.gate("ff")[0] == "use_encoder_adapter_gating_small_xy_cat"


@pytest.mark.parametrize("lambda_z", [None, 1.0])
def test_lambda_z_value_and_gradient_match_jax(lambda_z):
    jcfg = ablation_cfg("track_z")
    if lambda_z is not None:
        jcfg = dataclasses.replace(jcfg, pet=dataclasses.replace(
            jcfg.pet, lambda_z=lambda_z))
    lam = jcfg.pet.lambda_z
    _, jmodel, params, jbatch, tbatch, port = setup_cfg(jcfg)
    trainable, frozen = split_params(params, trainable_mask(params, jcfg.pet))

    def jax_loss(tr):
        out, inter = jmodel.apply(
            {"params": merge_params(tr, frozen)}, jbatch["input_ids"],
            jbatch["attention_mask"], vis_feats=jbatch["vis_feats"],
            boxes=jbatch["boxes"], labels=jbatch["target_ids"],
            ctx=jm.PetContext(task="vqa", task_idx=0), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["intermediates"])
        loss = jtask_loss("vqa", out["loss"], jbatch["target_ids"],
                          jbatch["scores"])
        zs = [z for path, z in jax.tree_util.tree_flatten_with_path(inter)[0]
              if any(str(getattr(k, "key", k)) == "z" for k in path)]
        reg = sum(jnp.mean(jnp.square(z.astype(jnp.float32)))
                  for z in zs) / len(zs)
        return loss + lam * reg, (reg, jnp.asarray(len(zs)))

    (jl, (jreg, nz)), jg = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(trainable)
    named = apply_freezing(port, port.cfg.pet)
    ctx = tm.PetContext(task="vqa", task_idx=0, zs=[])
    out = port(tbatch["input_ids"], tbatch["attention_mask"],
               tbatch["vis_feats"], tbatch["boxes"],
               labels=tbatch["target_ids"], ctx=ctx, deterministic=False)
    pen = z_penalty(ctx.zs)
    loss = task_loss("vqa", out["loss"], tbatch["target_ids"],
                     tbatch["scores"]) + lam * pen
    grads = torch.autograd.grad(loss, list(named.values()))
    # the serial adapters after every sublayer: 2 + 2 encoder, 3 + 3
    # decoder (add_adapter_cross_attn)
    assert len(ctx.zs) == int(nz) == 10
    np.testing.assert_allclose(float(pen.detach()), float(jreg), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jg))
    for (name, _), g in zip(named.items(), grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()),
                                   err_msg=name)
