"""Multitask mixing (reference: src/multitask_data.py:5-66).

Epoch schedule = concat of [task]*len(loader) (roundrobin) or a balanced
count, shuffled with random.Random(epoch); __next__ pops a task and pulls
the next batch from that task's iterator. The reference pops from the END
of the shuffled list — preserved for schedule parity.

The port's own copy of vlpet_tpu/data/multitask.py.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional


class MultitaskLoader:
    def __init__(self, loaders: List, shuffle: bool = True,
                 sampling: str = "roundrobin",
                 n_batches: Optional[int] = None, verbose: bool = False):
        self.loaders = loaders
        self.task2len = {ld.task: len(ld) for ld in loaders}
        self.task2loader = {ld.task: ld for ld in loaders}
        self.shuffle = shuffle
        self.sampling = sampling
        self.n_batches = n_batches
        self.verbose = verbose
        self.epoch_tasks: List[str] = []
        self.set_epoch(0)

    def set_epoch(self, epoch: int):
        for ld in self.loaders:
            ld.set_epoch(epoch)
        if self.sampling == "roundrobin":
            epoch_tasks = []
            for task, ld in self.task2loader.items():
                epoch_tasks.extend([task] * len(ld))
        elif self.sampling == "balanced":
            n = (self.n_batches if self.n_batches is not None
                 else sum(self.task2len.values()) // len(self.loaders))
            epoch_tasks = []
            for task in self.task2loader:
                epoch_tasks.extend([task] * n)
        else:
            raise ValueError(self.sampling)
        if self.shuffle:
            random.Random(epoch).shuffle(epoch_tasks)
        self.epoch_tasks = epoch_tasks

    def __iter__(self):
        self._iters = {t: iter(ld) for t, ld in self.task2loader.items()}
        self._remaining = list(self.epoch_tasks)
        return self

    def __next__(self) -> Dict:
        while self._remaining:
            task = self._remaining.pop()
            try:
                return next(self._iters[task])
            except StopIteration:
                # balanced sampling can exhaust a short loader; restart it
                self._iters[task] = iter(self.task2loader[task])
                try:
                    return next(self._iters[task])
                except StopIteration:
                    continue
        raise StopIteration

    def __len__(self):
        return len(self.epoch_tasks)
