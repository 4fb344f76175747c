"""The VL-PET ablation flags on the port's T5 against the JAX T5, on CPU.

* The low-rank visual projector (with its gate) under VL-PET-large on a
  tiny T5 (d 32, 2+2 layers, 4 heads, FFN 64, vocab 80; fp32, dropout 0;
  tests/test_torch_ablation_recipes.py's helpers, one JAX run for the
  fixture): the trainable set, a 3-step vqa lockstep within 1e-5
  relative, beam-5 tokens, LAST.npz both ways; and its init at d 128 by
  distribution (tests/test_torch_pet_init.py's rules).
* The JAX T5 reads none of the BART-only flags
  (vlpet_models.vlbart.BART_ONLY_PET_FLAGS, ``expand_vis_embedding``):
  the port's T5 refuses each at build, naming the JAX T5.
* ``use_decoder_self_attn_value_parallel_adapter_down_dim``, which the
  JAX T5 reads and never calls: no parameter in either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ablation_recipes import (check_last_npz, check_lockstep_with,
                                         jax_run)
from test_torch_gates import _models, check_beam5, port_cfg, setup_cfg
from test_torch_pet_init import check_init
from test_torch_pet_recipes import TASKS, check_trainable
from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models.t5 import check_t5_supported
from vlpet_tpu_torch.models.vlbart import BART_ONLY_PET_FLAGS

torch.set_num_threads(2)  # several xdist workers share the host

TINY = dict(vocab_size=80, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4, dropout_rate=0.0)


def lowrank_t5_cfg(**backbone):
    return VLModelConfig(
        backbone=T5Config(**{**TINY, **backbone}),
        vis=VisConfig(feat_dim=16, n_boxes=4,
                      use_lowrank_visual_projector=True,
                      visual_projector_down_dim=8,
                      visual_projector_multihead_num_head=4,
                      use_visual_projector_gating_large_x_lowrank=True,
                      visual_projector_gating_down_dim=8),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS,
                         t5=True))


@pytest.fixture(scope="module")
def lowrank_t5():
    s = setup_cfg(lowrank_t5_cfg())
    return s, jax_run(s)


def test_t5_lowrank_projector_trainable_set_matches_jax(lowrank_t5):
    s = lowrank_t5[0]
    check_trainable(s)
    assert any("visual_projector_multihead_down_kernel" in n
               for n in s[5].state_dict())


def test_t5_lowrank_projector_lockstep_with_jax(lowrank_t5):
    check_lockstep_with(*lowrank_t5)


def test_t5_lowrank_projector_beam5_tokens_match_jax(lowrank_t5):
    check_beam5(lowrank_t5[0], "caption", TASKS)


def test_t5_lowrank_projector_last_npz_round_trips(lowrank_t5, tmp_path):
    check_last_npz(lowrank_t5[0], tmp_path)


def test_t5_lowrank_projector_init_matches_the_jax_initializers():
    check_init(lowrank_t5_cfg(d_model=128, d_kv=32, d_ff=256, num_layers=1,
                              num_decoder_layers=1, vocab_size=512))


def _with(cfg, **flags):
    pet = {k: v for k, v in flags.items() if hasattr(cfg.pet, k)}
    vis = {k: v for k, v in flags.items() if k not in pet}
    return dataclasses.replace(cfg, pet=dataclasses.replace(cfg.pet, **pet),
                               vis=dataclasses.replace(cfg.vis, **vis))


@pytest.mark.parametrize("flag", BART_ONLY_PET_FLAGS
                         + ("expand_vis_embedding",))
def test_t5_refuses_the_bart_only_flags(flag):
    cfg = port_cfg(lowrank_t5_cfg())
    check_t5_supported(cfg)
    with pytest.raises(NotImplementedError, match="JAX T5"):
        check_t5_supported(_with(cfg, **{flag: True}))


def test_t5_decoder_self_value_adapter_builds_nothing():
    flag = dict(use_decoder_self_attn_value_parallel_adapter_down_dim=True,
                decoder_self_attn_value_parallel_adapter_down_dim=8)
    jcfg = _with(lowrank_t5_cfg(), **flag)
    J, T = _models(jcfg)
    ids = jnp.ones((1, 4), jnp.int32)
    params = J(jcfg).init(
        jax.random.PRNGKey(0), ids, ids, vis_feats=jnp.ones((1, 4, 16)),
        boxes=jnp.zeros((1, 4, 4)), labels=ids[:, :2], ctx=JCtx())["params"]
    want = set(flax_to_state_dict(jax.device_get(params)))
    got = set(T(port_cfg(jcfg), device="cpu").state_dict())
    plain = set(T(port_cfg(lowrank_t5_cfg()), device="cpu").state_dict())
    assert got == want == plain
