"""The port's own init of every VL-PET ablation recipe of
tests/test_torch_ablation_recipes.py and tests/test_torch_ablation_decoder.py
against the JAX package's initializers, on CPU, by distribution, with
tests/test_torch_pet_init.py's rules and widths (d 128, 1+1 layers): the
multihead adapters' per-head kernels normal(0, 0.02) and zero biases, the
IA3 vectors normal(0, 0.02), the LayerNorm gate's ones and zeros, the
low-rank visual projector's and the gates' normal kernels. And each
recipe's argv through the port's ``cli/param.py``: the JAX CLI's config.
"""

import dataclasses

import pytest
import torch

from test_torch_ablation_recipes import PORT_RECIPES, ablation_cfg
from test_torch_pet_init import WIDTH, check_init

torch.set_num_threads(2)  # several xdist workers share the host

# the recipes of the ablations: VARIANTS' and the port's own
RECIPES = ("mh_up", "mh_down_up", "mh_pair", "gating_layernorm",
           "gating_l2norm", "standalone_gating", "standalone_gating_add_x2",
           "vlpet_large_gating_add", "lowrank_visual_projector", "ia3",
           "key_parallel", "sequential_va", "decoder_adapters",
           "decoder_mh_kv_adapter") + tuple(PORT_RECIPES)


@pytest.mark.parametrize("name", RECIPES)
def test_ablation_init_matches_the_jax_initializers(name):
    cfg = ablation_cfg(name)
    check_init(dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, **WIDTH)))


@pytest.mark.parametrize("name", RECIPES)
def test_port_cli_builds_the_jax_config(name):
    """The port's cli/param.py turns each recipe's argv into the JAX
    CLI's config, field for field: cli.multitask needs no new argument."""
    from test_pet_variants import BASE, VARIANTS
    from test_torch_ablation_recipes import TASKS
    from vlpet_tpu.cli import param as jparam
    from vlpet_tpu_torch.cli import param as tparam

    argv = BASE + PORT_RECIPES.get(name, VARIANTS.get(name, []))
    want = jparam.build_model_config(jparam.parse_args(argv), TASKS, 512)
    got = tparam.build_model_config(tparam.parse_args(argv), TASKS, 512)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
