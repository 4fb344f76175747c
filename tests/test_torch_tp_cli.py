"""The four CLIs under ``--distributed --mesh_model_axis 2`` on the CPU:
two ranks spawned over gloo form a (1, 2) mesh, split the tiny BART's
heads and FFN columns, and feed the same data shard.

multitask (train and evaluate vqa + caption, one epoch), multitask_infer
on its LAST.npz (whole tensors, cut to each rank's shards on load),
multitask_video (tvqa) and single_task (vqa), each on synthetic data
with the VL-PET-large flags: both ranks take the (1, 2) layout and the
same examples, hold half of every q/k/v, out_proj, fc1 and fc2, and run
the same number of steps; rank 0 alone writes the checkpoints, LAST.npz
and the metrics.

The ranks (tests/torch_dist_ranks.py) import no JAX.
"""

import numpy as np
import pytest
import torch

from torch_dist_ranks import cli_ranks
from vlpet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)  # several xdist workers share the host

SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLIs' WhitespaceTokenizer ids words by str hash: one
    PYTHONHASHSEED makes the ranks agree."""
    out = str(tmp_path_factory.mktemp("tp_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONHASHSEED", "0")
        return run_ranks(cli_ranks, 2, out, ["--mesh_model_axis", "2"],
                         timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", ["multitask", "multitask_infer",
                                  "multitask_video", "single_task"])
def test_cli_tensor_parallel(cli, name):
    r0, r1 = (r[name] for r in cli)
    assert r0["layout"] == r1["layout"] == (1, 2)
    assert r0["world"] == r1["world"] == 2
    assert r0["step"] == r1["step"]
    assert r0["seen"] == r1["seen"]  # one data shard, both model ranks
    if name == "multitask_infer":
        assert r0["seen"] == []
    else:
        assert r0["seen"]
        assert set(r0["writes"]) == {"checkpoint", "LAST.npz"}
        assert {"LAST.npz", "ckpt", "metrics.jsonl"} <= set(r0["files"])
    assert r1["writes"] == [] and not r1["logs"] and r0["logs"]
    for n, shape in r0["shapes"].items():
        if n.endswith(("q_proj.weight", "v_proj.weight", "out_proj.weight",
                       "fc1.weight", "fc2.weight")):
            whole = 32 * 64 if "fc" in n else 32 * 32
            assert np.prod(shape) * 2 == whole, (n, shape)
        assert r1["shapes"][n] == shape
