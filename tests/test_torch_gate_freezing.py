"""Freezing and re-init of the VL-PET gates in the port against the JAX
package, on CPU.

* The published Params(%) at BART-base width: 2.98 % for VL-PET-small,
  -middleX and -middleY and 4.16 % for -large (BASELINE.md;
  tests/test_freezing.py pins the JAX side), the port's model built on
  ``device="meta"``, its trainable and total counts equal to the JAX
  package's (jax.eval_shape).
* ``train/freezing.py weight_initialization`` against
  vlpet_tpu/train/freezing.py ``weight_initialization`` for every rule it
  has (ia3 one-init, the multihead and large-gate up zero-inits, the
  cross-attention VPA up zero-init, the small and middle gate zero-inits,
  middle-Y's one- and zero-init, and one-init over zero-init when both are
  set), on the tiny BART and T5 of tests/test_torch_gates.py: from the same
  spread weights, every tensor equal, and at least one changed.
* ``init_weights`` of both port models ends in ``weight_initialization``:
  applying it again changes nothing (the rules of the former T5-only
  ``_ZERO_INIT_RULES`` included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gates import _models, jax_cfg, port_cfg, setup
from vlpet_tpu.config import BartConfig, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.models.vlbart import VLBart as JVLBart
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import (trainable_mask, trainable_report as
                                      jreport, weight_initialization as jinit)
from vlpet_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.train.freezing import (trainable_report,
                                            weight_initialization)

torch.set_num_threads(2)  # several xdist workers share the host

TASKS = ("vqa", "gqa", "nlvr", "caption")

# (flag, gate variant whose model has the tensors the rule matches)
RULES = [
    ("use_encoder_attn_value_ia3_one_init", "middleY"),
    ("use_encoder_multihead_up_zero_init", "large"),
    ("use_encoder_gating_large_x_lowrank_up_zero_init", "large"),
    ("use_decoder_enc_vpa_up_zero_init", "small"),
    ("use_encoder_gating_small_up_zero_init", "small"),
    ("use_encoder_gating_middle_up_zero_init", "middleX"),
    ("use_encoder_gating_middle_ia3_one_init", "middleY"),
    ("use_encoder_gating_middle_ia3_zero_init", "middleY"),
    ("use_encoder_gating_middle_ia3_one_init,"
     "use_encoder_gating_middle_ia3_zero_init", "middleY"),
]


@pytest.mark.parametrize("variant,expected", [
    ("small", 2.98), ("middleX", 2.98), ("middleY", 2.98), ("large", 4.16)])
def test_published_share_on_meta_matches_jax(variant, expected):
    pet = vlpet_recipe(variant, r=96, num_heads=4, gate_dim=96, tasks=TASKS)
    jcfg = VLModelConfig(backbone=BartConfig(),
                         vis=VisConfig(feat_dim=2048, n_boxes=36), pet=pet)
    jmodel = JVLBart(jcfg)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), jnp.int32), vis_feats=jnp.ones((1, 36, 2048)),
        boxes=jnp.zeros((1, 36, 4)), labels=jnp.ones((1, 2), jnp.int32),
        ctx=JCtx()))["params"]
    want = jreport(params, trainable_mask(params, pet))
    cfg = port_cfg(jcfg)
    got = trainable_report(VLBart(cfg, device="meta"), cfg.pet)
    assert (got["trainable"], got["total"]) == (want["trainable"],
                                                 want["total"])
    assert abs(got["percentage"] - expected) < 0.05


def _with(jcfg, flags: str):
    return dataclasses.replace(jcfg, pet=dataclasses.replace(
        jcfg.pet, **{f: True for f in flags.split(",")}))


@pytest.mark.parametrize("backbone", ["bart", "t5"])
@pytest.mark.parametrize("flags,variant", RULES)
def test_weight_initialization_matches_jax(backbone, flags, variant):
    jcfg0, _, params, _, _, _ = setup(backbone, variant)
    jcfg = _with(jcfg0, flags)
    want = flax_to_state_dict(jinit(params, jcfg.pet))
    _, T = _models(jcfg)
    model = load_flax_params(T(port_cfg(jcfg), device="cpu"), params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    weight_initialization(model, model.cfg.pet)
    changed = 0
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(),
                                      err_msg=name)
        changed += not torch.equal(p, before[name])
    assert changed


@pytest.mark.parametrize("backbone", ["bart", "t5"])
@pytest.mark.parametrize("variant", ["small", "middleX", "middleY", "large"])
def test_init_weights_applies_every_reinit(backbone, variant):
    """Every re-init flag set: after ``init_weights`` the rules hold (a
    second ``weight_initialization`` is a no-op), the gate vectors and
    zero-inits took their values, the rest is random."""
    flags = ",".join(f for f, _ in RULES[:-1])
    jcfg = _with(jax_cfg(backbone, variant), flags)
    _, T = _models(jcfg)
    model = T(port_cfg(jcfg), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    weight_initialization(model, model.cfg.pet)
    for name, p in model.named_parameters():
        assert torch.equal(p, after[name]), name
        if "gating_middle_ia3" in name:
            assert torch.all(p == 1.0), name  # one-init wins over zero-init
        if "gating_small_xy_cat" in name or "gating_middle_xy_add" in name:
            assert torch.all(p == 0.0), name
    assert model.model.shared.std() > 0
