"""The decoder input prompt (``decoder_prompt_len`` without
``use_attn_prefix``) in the port against the JAX package, on BART and T5,
on CPU: tests/test_pet_variants.py::test_decoder_input_prompt_cache_parity
and ::test_decoder_input_prompt_generation as port-vs-JAX locksteps.

Recipes (the flags after tests/test_pet_variants.py's BASE, parsed by the
JAX CLI): ``bart`` and ``t5`` -- prompt 4, mid_dim 16, one prompt shared by
the tasks -- on the tiny BART of tests/test_torch_pet_recipes.py and the
tiny T5 of tests/test_torch_ablation_t5.py (d 32, 2+2 layers, 4 heads, FFN
64; fp32, dropout 0), and ``bart_per_task``, one prompt a task
(``prompts_vqa``, ``prompts_caption``). Weights spread by
tests/test_torch_gates.py ``setup_cfg``; one JAX 3-step run a recipe.
Per recipe (tests/test_torch_prefix.py ``recipe_suite``): the trainable
set, the 3-step lockstep, the teacher-forced loss and logits, beam-5 and
greedy tokens identical to the JAX seq2seq_generate, the port's decode
steps from the cache its dry run prefilled (positions P + t) against the
JAX teacher-forced logits, LAST.npz both ways; and the port's init by
distribution at d 128.
"""

import dataclasses

import pytest
import torch

from test_pet_variants import BASE
from test_torch_ablation_t5 import TINY as T5_TINY
from test_torch_pet_init import WIDTH, check_init
from test_torch_pet_recipes import TASKS
from test_torch_prefix import bart_cfg, recipe_suite
from vlpet_tpu.cli.param import build_model_config, parse_args
from vlpet_tpu.config import T5Config

torch.set_num_threads(2)  # several xdist workers share the host

PROMPT = ["--decoder_prompt_len", "4", "--mid_dim", "16"]
T5_BASE = [a if a != "facebook/bart-base" else "t5-base" for a in BASE]
T5_WIDTH = dict(d_model=128, d_kv=32, d_ff=256, num_layers=1,
                num_decoder_layers=1, vocab_size=512)


def t5_cfg(flags, **backbone):
    """The JAX config of ``flags`` (after BASE, backbone t5-base) on the
    tiny T5."""
    cfg = build_model_config(parse_args(T5_BASE + flags), TASKS,
                             vocab_size=32128)
    return dataclasses.replace(cfg, backbone=T5Config(**{**T5_TINY,
                                                         **backbone}))


def prompt_cfg(name: str, wide: bool = False):
    if name == "t5":
        return t5_cfg(PROMPT + ["--use_single_prompt"],
                      **(T5_WIDTH if wide else {}))
    flags = PROMPT + ([] if name == "bart_per_task" else
                      ["--use_single_prompt"])
    return bart_cfg(flags, **(WIDTH if wide else {}))


globals().update(recipe_suite(prompt_cfg, ["bart", "t5", "bart_per_task"]))


@pytest.mark.parametrize("name", ["bart", "t5"])
def test_port_init_matches_the_jax_initializers(name):
    check_init(prompt_cfg(name, wide=True))
