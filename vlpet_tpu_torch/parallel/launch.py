"""Run a function on N local processes, one rank each: torchrun's role for
code that starts its own ranks (the data-parallel tests on the CPU,
chip_smoke.py's phase 9 on one card).

Each rank is a spawned process that takes torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), joins the process group
through ``multihost.maybe_initialize_distributed`` -- the CLIs' own entry
-- runs ``fn(rank, world, *args)`` and hands its return value back through
a file. The function must live in a module that the child can import
(spawn re-imports it).
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vlpet_tpu_torch.parallel.multihost import maybe_initialize_distributed


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int,
               device: str, backend: Optional[str], out_dir: str,
               args: tuple) -> None:
    # every rank of a one-card run shares the card (LOCAL_RANK 0)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank % cards if cards else rank))
    torch.set_num_threads(1)  # the ranks share the host's cores
    maybe_initialize_distributed(SimpleNamespace(device=device,
                                                 distributed=True),
                                 backend=backend)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"{rank}.pt"))


def run_ranks(fn: Callable, world: int, *args, device: str = "cpu",
              backend: Optional[str] = None,
              timeout: float = 120.0) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group on ``device`` ("cpu", or "cuda": rank r on card r modulo
    the cards), over ``backend`` (gloo on the CPU, nccl on cards, by
    default), one CPU thread each; returns the ranks' return values in
    rank order (``fn`` returns its tensors on the CPU). Raises when a rank
    raises, and kills every rank and raises TimeoutError when the run
    outlasts ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, free_port(), device, backend,
                              out_dir, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world)]
