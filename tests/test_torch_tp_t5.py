"""The port's tensor parallelism on a tiny T5 on the CPU, against the JAX
package: ranks spawned over gloo, each holding its heads of every
attention (and its rows of the relative bias where it is used) and its
hidden columns of every FFN.

* A tiny T5 + VL-PET-large (the T5 recipe: zero-init ups, gating scale
  0.3), relu / tied (F1 / F2) and gated / untied (F3 / F4), dropout 0,
  fp32, global batch 8, K = 3 caption steps at (data, model) = (1, 2),
  (2, 2) and (1, 4) against the JAX make_train_step on one device: the
  loss and the gradient norm within 1e-5 relative, the trainable tensors
  within the lockstep's rtol 1e-3, atol 1e-5 * max|p|, every rank bit for
  bit; each rank's q/k/v/o and wi/wo 1/M of the whole.
* Beam-5 and greedy tokens at (1, 2) identical to the port's one process
  (whose tokens tests/test_torch_t5.py holds to the JAX model's).

The weights are the JAX model's random init (std 0.2; the zero-init ups
drawn too). The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_distributed import _batch
from test_torch_gates import port_cfg, setup_cfg
from test_torch_tensor_parallel import (K, LAYOUTS, OPT, TASKS, check_step,
                                        jax_steps, spawn_layouts)
from torch_dist_ranks import generate
from vlpet_tpu.config import T5Config, VisConfig, VLModelConfig, vlpet_recipe

torch.set_num_threads(2)  # several xdist workers share the host

SPLIT = (r"\.(q|k|v|o)\.weight$", r"\.wi(_0|_1)?\.weight$", r"\.wo\.weight$")


def jax_t5(gated: bool) -> VLModelConfig:
    return VLModelConfig(
        backbone=T5Config(vocab_size=80, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_decoder_layers=2, num_heads=4,
                          dropout_rate=0.0,
                          feed_forward_proj="gated-gelu" if gated else "relu",
                          tie_word_embeddings=not gated),
        vis=VisConfig(feat_dim=16, n_boxes=4),
        pet=vlpet_recipe("large", r=8, num_heads=4, gate_dim=8, tasks=TASKS,
                         t5=True))


@pytest.fixture(scope="module")
def t5():
    """Per configuration (relu, gated): the JAX run, the port's model and
    its cases; the ranks' runs at every layout, with generation at
    (1, 2)."""
    want, ports, cases, gens = [], [], [], []
    for gated in (False, True):
        jcfg = jax_t5(gated)
        _, jmodel, params, _, _, port = setup_cfg(jcfg)
        batch = _batch(80, 4, 16, seed=1)
        case = dict(cfg=port_cfg(jcfg), state=port.state_dict(), batch=batch,
                    tasks=TASKS, task="caption")
        want.append(jax_steps(jmodel, jcfg, params, batch, "caption"))
        ports.append(port)
        cases.append(dict(case, steps=K, opt=OPT))
        gens.append(case)
    ranks = spawn_layouts(cases, LAYOUTS[1:])
    ranks.update(spawn_layouts(cases, LAYOUTS[:1], gens))
    return want, ports, gens, ranks


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated"])
def test_t5_tp_step_matches_jax(t5, layout, gated):
    want, ports, _, ranks = t5
    shapes = check_step(ranks[layout], want[int(gated)], int(gated),
                        layout[1])
    whole = {n: tuple(p.shape) for n, p in ports[int(gated)]
             .named_parameters()}
    n_split = 0
    for name, shape in shapes.items():
        if any(re.search(p, name) for p in SPLIT):
            n_split += 1
            assert np.prod(shape) * layout[1] == np.prod(whole[name]), name
        elif "relative_attention_bias" in name or "shared" in name:
            assert shape == whole[name], name
    ffn = 3 if gated else 2
    assert n_split == 2 * (4 + ffn) + 2 * (8 + ffn)  # 2 + 2 blocks


@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated"])
def test_t5_tp_tokens_match_one_process(t5, gated):
    _, _, gens, ranks = t5
    one = generate(**gens[int(gated)])
    for beams in (5, 1):
        assert len(np.unique(one[beams][:, 1:].numpy())) > 2
        for r in ranks[LAYOUTS[0]]:
            got = r["generate"][int(gated)][beams]
            assert torch.equal(got, one[beams]), beams
