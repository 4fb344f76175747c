"""Profiling and timing helpers, ported from vlpet_tpu/utils/profiling.py.

* ``device_sync(x)``: wait for the card (``torch.cuda.synchronize`` where a
  tensor of ``x`` lies on a CUDA device; nothing on the CPU) and return the
  first element of the first tensor as a float, as the JAX helper does;
* ``trace(logdir)``: ``torch.profiler.profile`` over the block, the card's
  kernels included when CUDA is there, written as a Chrome trace
  (``<logdir>/trace.json``, which chrome://tracing and Perfetto read);
* ``StepTimer``: examples per second over the steps since the last reset,
  timed by CUDA events on the card and by the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List, Optional

import torch


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def device_sync(tree: Any = None) -> float:
    """Wait for everything queued on the CUDA devices of ``tree``'s tensors
    (the current device when ``tree`` holds none and CUDA is there); the
    CPU needs no wait. Returns the first element of the first tensor as a
    float (0.0 without one)."""
    leaves = _tensors(tree)
    devices = {t.device for t in leaves if t.is_cuda}
    if not leaves and torch.cuda.is_available():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for dev in devices:
        torch.cuda.synchronize(dev)
    if not leaves:
        return 0.0
    return float(leaves[0].detach().reshape(-1)[0].float())


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (CPU activity, and the CUDA
    kernels when CUDA is there) and write ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


class StepTimer:
    """Throughput meter: ``step(batch_size)`` per step, ``rate()`` reads
    examples per second since the last ``reset``. On a CUDA ``device`` the
    span runs between two CUDA events (``rate`` waits for the second);
    otherwise on the host clock, after ``device_sync(sync_tree)``."""

    def __init__(self, device: Optional[torch.device] = None):
        dev = torch.device(device) if device is not None else None
        self.cuda = dev is not None and dev.type == "cuda"
        self.reset()

    def reset(self) -> None:
        self.examples = 0
        self.steps = 0
        self.t0 = time.perf_counter()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def step(self, batch_size: int) -> None:
        self.examples += batch_size
        self.steps += 1

    def seconds(self, sync_tree: Optional[Any] = None) -> float:
        """Seconds since the last reset (the card's, on a CUDA device)."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self.start.elapsed_time(end) / 1e3
        if sync_tree is not None:
            device_sync(sync_tree)
        return time.perf_counter() - self.t0

    def rate(self, sync_tree: Optional[Any] = None) -> float:
        return self.examples / max(self.seconds(sync_tree), 1e-9)
