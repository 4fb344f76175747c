"""Generation under the port's tensor parallelism on the CPU: two ranks
spawned over gloo, each holding half the heads of every attention and
half the hidden columns of every FFN (a (1, 2) mesh), decode the whole
batch.

* The tiny flagship (BART + VL-PET-large, the JAX model's random init):
  beam-5 and greedy tokens identical to the JAX model's, unfused and with
  ``use_fused_beam`` (D2's plain twin on the CPU). The caches and the
  precomputed cross K/V hold each rank's heads; the logits, and so the
  beams, are the same on both ranks.

The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gates import port_cfg
from test_torch_tensor_parallel import TASKS, spawn_layouts, tiny_flagship
from vlpet_tpu.models import generate as jgen
from vlpet_tpu.pet.modules import PetContext as JCtx

torch.set_num_threads(2)  # several xdist workers share the host

KEYS = ("input_ids", "attention_mask", "vis_feats", "boxes")


@pytest.fixture(scope="module")
def decoded():
    """The JAX tokens of the flagship and the ranks' tokens of every case
    at (1, 2)."""
    jcfg, jmodel, params, port, batch = tiny_flagship()
    ctx = JCtx(task="caption", task_idx=TASKS.index("caption"))
    want = {n: np.asarray(jgen.seq2seq_generate(
        jmodel, {"params": params},
        **{k: jnp.asarray(batch[k]) for k in KEYS}, ctx=ctx, num_beams=n,
        max_length=8)) for n in (5, 1)}
    cfg = port_cfg(jcfg)
    cases = [dict(cfg=c, state=port.state_dict(), batch=batch, tasks=TASKS,
                  task="caption")
             for c in (cfg, dataclasses.replace(cfg, use_fused_beam=True))]
    ranks = spawn_layouts([], [(1, 2)], cases)[(1, 2)]
    return want, cases, ranks


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("beams", [5, 1])
def test_bart_tokens_match_jax(decoded, beams, fused):
    want, _, ranks = decoded
    assert len(np.unique(want[beams][:, 1:])) > 2  # not a degenerate decode
    for r in ranks:
        got = r["generate"][int(fused)][beams].numpy()
        np.testing.assert_array_equal(got, want[beams])
