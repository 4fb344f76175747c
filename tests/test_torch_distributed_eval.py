"""The port's multi-process layer on the CPU, beside the training step of
test_torch_distributed.py: two ranks spawned over gloo
(vlpet_tpu_torch.parallel.launch.run_ranks) against one process.

* Sharded evaluation (tests/torch_dist_ranks.py ``evaluate_all``, a tiny
  BART + VL-PET-large): beam-5 caption and greedy vqa ``predict``,
  ``predict_nlvr``, over 7 examples a task (shards of 4 and 3), merged on
  every rank: the same answer for every question id as one process --
  the tokens identical, as tests/test_eval_sharding.py asks of JAX -- and
  the same evaluator scores.
* ``maybe_initialize_distributed``'s triggers (vlpet_tpu_torch/parallel/
  multihost.py), with ``init_process_group`` mocked, as
  tests/test_multihost_init.py holds JAX's: nothing without the flag or
  torchrun's environment, the topology from the flags, from the
  environment (the rank's card cuda:LOCAL_RANK, nccl), idempotent.
* A checkpoint written at world 2 after one epoch (rank 0 alone writes
  it) restores at world 1, and the second epoch ends where an
  uninterrupted world-1 run of two epochs ends (fp32 round-off: the
  global batch is the same examples, fixed-length padded).
* The per-epoch task-order check raises on every rank when one rank's
  order differs.
* The four CLIs with ``--distributed`` at world 2 on synthetic data:
  multitask (train and evaluate vqa + caption), multitask_infer on its
  LAST.npz, multitask_video (tvqa) and single_task (vqa). The ranks train
  on disjoint examples, rank 0 alone writes checkpoints, LAST.npz and
  metrics.

The ranks import no JAX. Each spawn has its own time limit.
"""

import os
from types import SimpleNamespace

import pytest
import torch

import vlpet_tpu_torch.parallel.multihost as mh
from torch_dist_ranks import (eval_cli_ranks, evaluate_all, tiny_trainer,
                              train_caption)
from vlpet_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(2)  # several xdist workers share the host

SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Two ranks: evaluation, one epoch checkpointed, the order check, then
    the four CLIs. The CLIs' WhitespaceTokenizer ids words by str hash:
    one PYTHONHASHSEED makes the ranks agree."""
    ckpt = str(tmp_path_factory.mktemp("dist_ckpt"))
    cli = str(tmp_path_factory.mktemp("dist_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONHASHSEED", "0")
        res = run_ranks(eval_cli_ranks, 2, ckpt, cli,
                        timeout=SPAWN_TIMEOUT_S)
    return ckpt, res


@pytest.fixture(scope="module")
def ranks(spawned):
    ckpt, res = spawned
    return ckpt, [r["eval"] for r in res]


@pytest.fixture(scope="module")
def cli(spawned):
    return [r["cli"] for r in spawned[1]]


@pytest.fixture(scope="module")
def one_process():
    return evaluate_all(tiny_trainer())


@pytest.mark.parametrize("task", ["caption", "vqa"])
def test_sharded_predict_equals_one_process(ranks, one_process, task):
    _, res = ranks
    want = one_process[task]
    for r in res:
        got = r["eval"][task]
        assert got["quesid2ans"] == want["quesid2ans"]
        assert len(got["quesid2ans"]) == 7
        assert sorted(got["predictions"]) == sorted(want["predictions"])
        assert r["eval"]["scores"][task] == one_process["scores"][task]


def test_sharded_nlvr_equals_one_process(ranks, one_process):
    _, res = ranks
    for r in res:
        assert r["eval"]["nlvr"] == one_process["nlvr"]
    assert len(one_process["nlvr"]) == 7


@pytest.fixture
def init_calls(monkeypatch):
    """maybe_initialize_distributed with init_process_group (and the
    card's set_device) recorded instead of run."""
    calls = []
    monkeypatch.setattr(mh, "_DIST_INITIALIZED", False)
    monkeypatch.setattr(mh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    return calls


def _args(**kw):
    base = dict(distributed=False, coordinator_address=None,
                num_processes=None, process_id=None, local_rank=-1,
                device="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


def test_init_noop_without_flag_or_env(init_calls):
    assert not mh.maybe_initialize_distributed(_args(), env={})
    assert init_calls == []


def test_init_from_flags(init_calls):
    assert mh.maybe_initialize_distributed(
        _args(distributed=True, coordinator_address="10.0.0.1:8476",
              num_processes=4, process_id=2), env={})
    assert init_calls == [("gloo", dict(init_method="tcp://10.0.0.1:8476",
                                        world_size=4, rank=2))]


def test_init_from_torchrun_env(init_calls):
    """torchrun's environment alone: the rank's card and nccl."""
    args = _args(device="cuda")
    env = {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h",
           "MASTER_PORT": "1234", "LOCAL_RANK": "1"}
    assert mh.maybe_initialize_distributed(args, env=env)
    assert init_calls == [("set_device", "cuda:1"),
                          ("nccl", dict(init_method="tcp://h:1234",
                                        world_size=4, rank=3))]
    assert args.device == "cuda:1"


def test_init_is_idempotent(init_calls):
    assert mh.maybe_initialize_distributed(_args(distributed=True), env={})
    assert not mh.maybe_initialize_distributed(_args(distributed=True),
                                               env={})
    assert init_calls == [("gloo", dict(init_method="tcp://127.0.0.1:29500",
                                        world_size=1, rank=0))]


def test_cli_parses_topology_flags():
    from vlpet_tpu_torch.cli.param import parse_args

    args = parse_args(["--distributed", "--coordinator_address", "h:1",
                       "--num_processes", "2", "--process_id", "1",
                       "--local_rank", "1"])
    assert args.distributed and args.coordinator_address == "h:1"
    assert (args.num_processes, args.process_id, args.local_rank) == (2, 1, 1)
    assert mh.host_shard() == (0, 1)  # no process group here


def test_world2_checkpoint_resumes_at_world1(ranks, tmp_path, capsys):
    """One epoch at world 2 (batch 2 a rank), restored at world 1 (batch
    4) for the second, ends where two epochs at world 1 end."""
    out, res = ranks
    assert [r["lead"] for r in res] == [True, False]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["4.pt"]
    for name, p in res[0]["epoch1"].items():  # the ranks' state agrees
        assert torch.equal(res[1]["epoch1"][name], p), name

    resumed = tiny_trainer(output_dir=out, lr=1e-2, total_steps=8)
    assert resumed.restore() == 4
    assert "start afresh" in capsys.readouterr().out
    got = train_caption(resumed, epochs=2, batch_size=4)
    straight = tiny_trainer(output_dir=str(tmp_path), lr=1e-2, total_steps=8)
    want = train_caption(straight, epochs=2, batch_size=4)
    assert resumed.step == straight.step == 8
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-5, atol=1e-6)


def test_task_order_mismatch_raises_on_every_rank(ranks):
    _, res = ranks
    for r in res:
        assert "task order" in r["order_check"]


@pytest.mark.parametrize("name", ["multitask", "multitask_infer",
                                  "multitask_video", "single_task"])
def test_cli_distributed_world2(cli, name):
    r0, r1 = (r[name] for r in cli)
    assert r0["world"] == r1["world"] == 2
    assert r0["step"] == r1["step"]
    if name == "multitask_infer":
        assert r0["seen"] == r1["seen"] == []
    else:  # disjoint shards of the train split, both ranks training
        assert r0["seen"] and r1["seen"]
        assert not set(r0["seen"]) & set(r1["seen"])
        assert set(r0["writes"]) == {"checkpoint", "LAST.npz"}
        assert {"LAST.npz", "ckpt", "metrics.jsonl"} <= set(r0["files"])
    assert r1["writes"] == [] and not r1["logs"] and r0["logs"]
