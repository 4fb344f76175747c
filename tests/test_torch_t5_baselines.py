"""The PET baselines on the port's T5 against the JAX T5, on CPU.

Each recipe is a tests/test_pet_variants.py VARIANTS entry parsed with its
BASE flags (backbone t5-base) by the JAX CLI, on the tiny T5 of
tests/test_torch_ablation_t5.py (d 32, 2+2 layers, 4 heads, FFN 64, vocab
80; fp32, dropout 0): the serial adapter, Compacter (its own rule and W,
and the model-root W of ``compacter_shared_W``), the low-rank adapter,
LoRA (on T5 no module: the "bias" leaves train), the encoder prompt and
the hyperformer. Weights spread by tests/test_torch_gates.py
``setup_cfg``; one JAX 3-step run a recipe. Per recipe
(tests/test_torch_prefix.py ``recipe_suite``): the trainable set, the
3-step vqa lockstep (loss and gradient norm 1e-5 relative, parameters
rtol 1e-3, atol 1e-5 * max|p|), the teacher-forced loss and logits, beam-5
and greedy tokens identical to the JAX seq2seq_generate (the
hyperformer's on vqa: its caption decode repeats one token in both
packages), the cached decode against the JAX teacher forcing, LAST.npz
both ways; and the port's init by distribution at d 128. The flags the
JAX T5 does not read are refused at build.
"""

import dataclasses

import pytest
import torch

from test_pet_variants import VARIANTS
from test_torch_decoder_prompt import T5_WIDTH, t5_cfg
from test_torch_gates import _models, port_cfg
from test_torch_pet_init import check_init
from test_torch_prefix import recipe_suite
from vlpet_tpu_torch.models.t5 import check_t5_supported
from vlpet_tpu_torch.models.vlbart import T5_UNREAD_FLAGS

torch.set_num_threads(2)  # several xdist workers share the host

RECIPES = ("single_adapter", "single_compacter", "compacter_shared_W",
           "single_lradapter", "single_lora", "single_prompt", "hyperformer")


def baseline_cfg(name: str, **backbone):
    return t5_cfg(VARIANTS[name], **backbone)


globals().update(recipe_suite(baseline_cfg, list(RECIPES),
                              beam_task={"hyperformer": "vqa"}))


@pytest.mark.parametrize("name", RECIPES)
def test_port_init_matches_the_jax_initializers(name):
    check_init(baseline_cfg(name, **T5_WIDTH))


def test_lora_builds_no_module_on_t5():
    """``use_lora`` on T5: no LoRA parameter, and the relative bias
    trains (the JAX T5's "bias" rule)."""
    from vlpet_tpu_torch.train.freezing import apply_freezing

    jcfg = baseline_cfg("single_lora")
    _, T = _models(jcfg)
    model = T(port_cfg(jcfg), device="cpu")
    assert not [n for n, _ in model.named_parameters() if "lora" in n]
    named = apply_freezing(model, model.cfg.pet)
    assert any(n.endswith("relative_attention_bias") for n in named)


@pytest.mark.parametrize("flag", T5_UNREAD_FLAGS)
def test_t5_refuses_the_flags_it_does_not_read(flag):
    cfg = port_cfg(baseline_cfg("single_adapter"))
    check_t5_supported(cfg)
    where = "vis" if hasattr(cfg.vis, flag) else "pet"
    bad = dataclasses.replace(cfg, **{where: dataclasses.replace(
        getattr(cfg, where), **{flag: True})})
    with pytest.raises(NotImplementedError, match="JAX T5"):
        check_t5_supported(bad)
