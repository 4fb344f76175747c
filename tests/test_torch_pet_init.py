"""The port's own init of each PET baseline against the JAX package's
initializers, on CPU.

Each recipe of tests/test_torch_pet_recipes.py at d 128 (FFN 256, 1+1
layers, vocab 512): the JAX model's ``init`` and the port's
``init_weights`` draw their own numbers, so they are held by
distribution; the JAX side takes the recipe's re-inits
(vlpet_tpu/train/freezing.py ``weight_initialization``), which the port's
``init_weights`` ends with. Parameters are grouped by name with the layer index dropped
(``layers_0`` and ``layers_1`` pool). Per group:

* all zeros in JAX (``lora_B``, every zero-initialised bias) -> exactly
  zero in the port; all ones (LayerNorm scales) -> exactly one;
* otherwise nonzero, and, where the group has >= 256 elements, a uniform
  group (max|x| < 1.9 std) stays inside the JAX bound and fills it, and a
  group of >= 4096 elements has the JAX std within 5 %.
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gates import _models, port_cfg
from test_torch_pet_recipes import RECIPES, recipe_cfg
from vlpet_tpu.pet.modules import PetContext as JCtx
from vlpet_tpu.train.freezing import weight_initialization
from vlpet_tpu_torch.convert import flax_to_state_dict

torch.set_num_threads(2)  # several xdist workers share the host

WIDTH = dict(d_model=128, encoder_layers=1, decoder_layers=1,
             encoder_ffn_dim=256, decoder_ffn_dim=256)


def _groups(named):
    out = collections.defaultdict(list)
    for name, a in named.items():
        out[re.sub(r"layers_\d+", "layers_#", name)].append(
            np.asarray(a, np.float64).ravel())
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.mark.parametrize("name", RECIPES)
def test_port_init_matches_the_jax_initializers(name):
    check_init(recipe_cfg(name, **WIDTH))


def check_init(jcfg):
    """The port's init of ``jcfg``'s model against the JAX init, by the
    rules of the module docstring."""
    J, T = _models(jcfg)
    v = jcfg.vis
    params = jax.device_get(J(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
        jnp.ones((1, 4), jnp.int32), vis_feats=jnp.ones((1, v.n_boxes,
                                                          v.feat_dim)),
        boxes=jnp.zeros((1, v.n_boxes, 4)),
        labels=jnp.ones((1, 2), jnp.int32), ctx=JCtx())["params"])
    # the recipe's re-inits, which the port's init_weights ends with
    params = weight_initialization(params, jcfg.pet)
    port = T(port_cfg(jcfg), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    want = _groups(flax_to_state_dict(params))
    got = _groups({n: p.detach() for n, p in port.named_parameters()})
    assert set(got) == set(want)
    for k, a in want.items():
        b = got[k]
        if not a.any():
            assert not b.any(), k
        elif (a == 1).all():
            assert (b == 1).all(), k
        else:
            assert b.any(), k
            if a.size >= 256 and np.abs(a).max() < 1.9 * a.std():
                # the max of n uniform draws falls short of the bound by
                # about bound / n
                bound = np.abs(a).max() * (1 + 6.0 / a.size)
                assert np.abs(b).max() <= bound, k
                assert np.abs(b).max() >= 0.98 * np.abs(a).max(), k
            if a.size >= 4096:
                assert abs(b.std() / a.std() - 1) < 0.05, k
