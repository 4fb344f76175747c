"""LoRA in the port beyond the model lockstep
(tests/test_torch_pet_recipes.py), on CPU.

* The dropout of ``LoRADense``: the mask it applies to its input equals
  vlpet_tpu/ops/hashdrop.py ``keep_mask`` for the seed bit for bit, kept
  elements scaled by 1 / (1 - rate); a LoRA VLBart's training forward hands
  LoRA's q and v one seed each (``dropout_sites`` counts them, at BART
  dropout 0 too) and its eval forward and decode draw no mask.
* vlpet_tpu_torch/pet/lora.py against vlpet_tpu/pet/lora.py on the same
  spread parameters: ``LoRAEmbedding``, ``LoRAMergedLinear`` (enabled and
  disabled blocks) and ``LoRAConv2d`` (SAME at strides 1 and 2, VALID)
  within 1e-5 (1 + max|jax|); ``merge_lora`` / ``unmerge_lora`` /
  ``strip_lora`` on a tiny LoRA VLBart's state_dict, shared and per task,
  against the JAX functions on the flax tree, and the merged, stripped
  weights in a model built without LoRA give the LoRA model's logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlpet_tpu.pet.lora as jl
import vlpet_tpu_torch.pet.lora as tl
from test_torch_gates import port_cfg, setup_cfg
from test_torch_pet_modules import _close, _spread, _x, run, t
from test_torch_pet_recipes import TASKS, recipe_cfg
from vlpet_tpu.ops.hashdrop import keep_mask as jkeep_mask
from vlpet_tpu_torch.config import LoraSpec
from vlpet_tpu_torch.convert import flax_to_state_dict
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import hashdrop
from vlpet_tpu_torch.pet.modules import LoRADense, PetContext

torch.set_num_threads(2)  # several xdist workers share the host


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_lora_dropout_mask_is_the_hash_mask(rate):
    r = 8
    layer = LoRADense(r, r, LoraSpec(lora_dim=r, lora_alpha=float(r),
                                     lora_dropout=rate), device="cpu")
    with torch.no_grad():  # base 0, A = B = I, alpha / r = 1: y = drop(x)
        layer.base.weight.zero_()
        layer.base.bias.zero_()
        layer.lora_A.copy_(torch.eye(r))
        layer.lora_B.copy_(torch.eye(r))
    x = torch.ones(3, 40, r)
    seed = torch.tensor([1234567], dtype=torch.int32)
    with torch.no_grad():
        y = layer(x, 0, seed)
        assert torch.equal(layer(x, 0), x)  # no seed: no mask
    want = np.asarray(jkeep_mask((3, 40, r), jnp.uint32(0), jnp.uint32(1234567),
                                 rate))
    np.testing.assert_array_equal((y != 0).numpy(), want)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    assert torch.equal(y[y != 0], scale.expand(int(want.sum())))


@pytest.fixture(scope="module")
def lora_model():
    s = setup_cfg(recipe_cfg("single_lora", dropout=0.0))
    return s


def test_lora_dropout_sites_and_no_mask_at_eval(lora_model, monkeypatch):
    jcfg, _, params, _, tbatch, port = lora_model
    b = jcfg.backbone
    assert port.lora_drops()
    assert port.dropout_sites() == (2 + 2 * b.encoder_layers
                                    + 3 * b.decoder_layers
                                    + 2 * b.encoder_layers
                                    + 4 * b.decoder_layers)
    drawn, used = [], []
    orig_init, orig_next = hashdrop.DropoutSeeds.__init__, \
        hashdrop.DropoutSeeds.next

    def init(self, n, generator, device):
        drawn.append(n)
        orig_init(self, n, generator, device)

    def nxt(self):
        used.append(1)
        return orig_next(self)

    masks = []
    orig_mask = hashdrop.keep_mask
    monkeypatch.setattr(hashdrop.DropoutSeeds, "__init__", init)
    monkeypatch.setattr(hashdrop.DropoutSeeds, "next", nxt)
    monkeypatch.setattr(hashdrop, "keep_mask",
                        lambda *a, **k: masks.append(1) or orig_mask(*a, **k))
    args = (tbatch["input_ids"], tbatch["attention_mask"],
            tbatch["vis_feats"], tbatch["boxes"])
    with torch.no_grad():
        port(*args, labels=tbatch["target_ids"], ctx=PetContext())
        from vlpet_tpu_torch.models.generate import seq2seq_generate
        seq2seq_generate(port, input_ids=args[0], attention_mask=args[1],
                         vis_feats=args[2], boxes=args[3], num_beams=2,
                         max_length=4)
    assert not drawn and not masks  # eval and decode: no seed, no mask
    with torch.no_grad():
        port(*args, labels=tbatch["target_ids"], ctx=PetContext(),
             deterministic=False, generator=torch.Generator().manual_seed(0))
    # one draw of every site; at BART dropout 0 only LoRA's 12 sites mask
    assert drawn == [port.dropout_sites()] and len(used) == drawn[0]
    assert len(masks) == 2 * b.encoder_layers + 4 * b.decoder_layers


def test_lora_embedding():
    ids = np.array([[1, 2, 3], [4, 5, 19]])
    run(jl.LoRAEmbedding(num_embeddings=20, features=8, r=4, lora_alpha=8),
        (jnp.asarray(ids),),
        tl.LoRAEmbedding(20, 8, r=4, lora_alpha=8, device="cpu"),
        (torch.from_numpy(ids),))


@pytest.mark.parametrize("enable", [(True, False, True), (False, True, False)])
def test_lora_merged_linear(enable):
    x = _x(3, 5, 16)
    run(jl.LoRAMergedLinear(in_dim=16, out_dim=24, r=2, lora_alpha=4,
                            enable_lora=enable), (jnp.asarray(x),),
        tl.LoRAMergedLinear(16, 24, r=2, lora_alpha=4, enable_lora=enable,
                            device="cpu"), (t(x),))


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_lora_conv2d(stride, padding):
    x = _x(2, 9, 7, 3)
    kw = dict(kernel_size=3, r=2, lora_alpha=4, stride=stride,
              padding=padding)
    run(jl.LoRAConv2d(in_channels=3, out_channels=5, **kw), (jnp.asarray(x),),
        tl.LoRAConv2d(3, 5, device="cpu", **kw), (t(x),))


@pytest.mark.parametrize("single", [True, False])
def test_merge_unmerge_strip_match_jax(single):
    jcfg = recipe_cfg("single_lora")
    if not single:
        jcfg = dataclasses.replace(jcfg, pet=dataclasses.replace(
            jcfg.pet, use_single_lora=False))
    jcfg, _, params, _, tbatch, port = setup_cfg(jcfg)
    alpha, ti = jcfg.pet.lora_alpha, None if single else 1
    sd = flax_to_state_dict(params)
    merged = tl.merge_lora(sd, alpha, ti)
    _close(merged, flax_to_state_dict(jl.merge_lora(params, alpha, ti)))
    assert set(merged) == set(sd)
    back = tl.unmerge_lora(merged, alpha, ti)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k].numpy(), rtol=0,
                                   atol=1e-6)
    stripped = tl.strip_lora(merged)
    want = flax_to_state_dict(jl.strip_lora(jl.merge_lora(params, alpha, ti)))
    assert set(stripped) == set(want)
    _close([stripped[k] for k in sorted(want)], [want[k] for k in sorted(want)])
    # the merged weights without LoRA: the LoRA model's logits
    plain = VLBart(port_cfg(dataclasses.replace(jcfg, pet=dataclasses.replace(
        jcfg.pet, use_lora=False))), device="cpu")
    plain.load_state_dict(stripped, strict=True)
    args = (tbatch["input_ids"], tbatch["attention_mask"],
            tbatch["vis_feats"], tbatch["boxes"])
    ctx = PetContext(task=TASKS[ti or 0], task_idx=ti or 0)
    with torch.no_grad():
        want = port(*args, labels=tbatch["target_ids"], ctx=ctx)["logits"]
        got = plain(*args, labels=tbatch["target_ids"], ctx=ctx)["logits"]
    _close(got, want.numpy())
