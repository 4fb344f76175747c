"""Multi-process helpers, ported from vlpet_tpu/parallel/multihost.py: the
process group, per-process data shards and cross-process result merging.

The reference runs one torch DDP process per GPU: DistributedSampler hands
each rank a disjoint slice (caption_clip_data.py:372-377) and evaluation
gathers the ranks' results. Here each process holds one card
(``cuda:LOCAL_RANK``), feeds its own disjoint Loader shard
(shard=rank, num_shards=world), and the training step sums the ranks'
gradients (train/steps.py); evaluation merges the ranks' Python results
through a gloo group on the CPU, so that pickles never ride on NCCL.

Under tensor parallelism (parallel/mesh.py) the data shards are the data
axis's, not the processes': ``data_shard`` and ``data_parts`` count them.

Launch:  torchrun --nproc_per_node N -m vlpet_tpu_torch.cli.multitask
--distributed [--mesh_model_axis M] <flags>
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_DIST_INITIALIZED = False
_OBJECT_GROUP = None  # the gloo group of all_gather_objects
DEFAULT_PORT = 29500  # torch's default MASTER_PORT


def _launcher_env(env) -> bool:
    """torchrun's (and torch.distributed.launch's) environment."""
    return "RANK" in env and "WORLD_SIZE" in env


def maybe_initialize_distributed(args=None, env=None,
                                 backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` from the CLI's flags or the
    launcher's environment (the reference's every entry:
    src/multitask.py:633-635 ``dist.init_process_group('nccl')``).

    Triggers (either):
    * ``--distributed``: the topology from ``--coordinator_address``
      (host:port) / ``--num_processes`` / ``--process_id`` where given,
      else from the launcher's environment, else one process on
      127.0.0.1:29500;
    * torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
      ``MASTER_PORT``, ``LOCAL_RANK``).

    The process takes the card ``cuda:LOCAL_RANK`` (``--local_rank`` where
    the environment has none; 0 by default): ``args.device`` "cuda"
    becomes that card. The backend is ``backend``, else nccl on a card and
    gloo on the CPU (``args.device``). Idempotent; returns True when it
    initialised the group. A run with neither trigger touches nothing."""
    global _DIST_INITIALIZED, _OBJECT_GROUP
    if _DIST_INITIALIZED or dist.is_initialized():
        return False
    env = os.environ if env is None else env
    if not (getattr(args, "distributed", False) or _launcher_env(env)):
        return False
    addr = getattr(args, "coordinator_address", None)
    if not addr:
        addr = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                f"{env.get('MASTER_PORT', DEFAULT_PORT)}")
    world = getattr(args, "num_processes", None) or env.get("WORLD_SIZE", 1)
    rank = getattr(args, "process_id", None)
    if rank is None:
        rank = env.get("RANK", 0)
    local = env.get("LOCAL_RANK")
    if local is None:
        local = max(getattr(args, "local_rank", None) or 0, 0)
    device = torch.device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", int(local))
        torch.cuda.set_device(device)
        if args is not None:
            args.device = str(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(world), rank=int(rank))
    _DIST_INITIALIZED, _OBJECT_GROUP = True, None
    return True


def host_shard() -> tuple:
    """(rank, world size) of this process: the Loader's (shard,
    num_shards); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def data_shard() -> tuple:
    """(data index, data-axis size) of this process in the current mesh
    (parallel/mesh.py): the Loader's (shard, num_shards) and the step's
    place in the global batch. The ranks of one model group share a data
    index, so they feed the same examples; ``host_shard`` without a
    tensor-parallel mesh."""
    from vlpet_tpu_torch.parallel.mesh import current_layout

    layout = current_layout()
    return layout.data_index, layout.data


def data_parts(obj: Any) -> List[Any]:
    """``all_gather_objects`` of one object a data shard: the objects of
    model index 0 of each data group, in data order (the other model
    ranks hold copies of their group's)."""
    from vlpet_tpu_torch.parallel.mesh import current_layout

    return all_gather_objects(obj)[::current_layout().model]


def _object_group():
    """The group that moves pickles: the default one when it is gloo,
    else a gloo group over the same ranks, made once (every rank reaches
    here together: all_gather_objects is collective)."""
    global _OBJECT_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _OBJECT_GROUP is None:
        _OBJECT_GROUP = dist.new_group(backend="gloo")
    return _OBJECT_GROUP


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object per process, in rank order; [obj] in one
    process without touching a collective."""
    rank, world = host_shard()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj, group=_object_group())
    return out


def barrier() -> None:
    """Every process waits for all (on the CPU group); a no-op in one
    process."""
    if host_shard()[1] > 1:
        dist.barrier(group=_object_group())


def merge_predict_results(results: List[dict]) -> dict:
    """Merge per-process Trainer.predict outputs (disjoint shards)."""
    merged = {"quesid2ans": {}, "predictions": [], "targets": []}
    for r in results:
        merged["quesid2ans"].update(r.get("quesid2ans", {}))
        merged["predictions"].extend(r.get("predictions", []))
        merged["targets"].extend(r.get("targets", []))
    return merged
