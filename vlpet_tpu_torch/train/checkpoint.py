"""Checkpoints, ported from vlpet_tpu/train/checkpoint.py.

``CheckpointManager`` keeps the resumable train state -- the trainable
tensors, the optimizer state, the step and the dropout generator's state
-- as one ``torch.save`` file a step under its directory
(``<output>/ckpt/<step>.pt``), the newest two kept, as the JAX package's
orbax manager keeps them. A file is written under a temporary name and
renamed, so a run killed while saving leaves the previous one whole.

``save_params_npz`` / ``load_params_npz`` are the weights-only export in
the JAX package's own npz format: one array a parameter under its
"/"-joined flax path, fp32, Dense kernels as (in, out). A LAST.npz written
by either package loads into the other; the load is strict=False (it fills
what matches by name and shape, leaves the rest and counts what it filled).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vlpet_tpu_torch.convert import flax_leaves, flax_to_state_dict
from vlpet_tpu_torch.parallel.mesh import shard_state_dict

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (the newest when None), or None
        when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=False)


def save_params_npz(named: Mapping[str, torch.Tensor], path: str,
                    heads: Optional[Mapping[str, int]] = None) -> None:
    """Weights-only export (the reference's LAST.pth analog) of port
    tensors by name, in the JAX package's npz layout (a CLIP trunk's
    tensors under their flax leaves: ``convert.flax_leaves``, with the
    attention tensors' head counts ``heads``, ``convert.attention_heads``
    of the model)."""
    heads = heads or {}
    flat = {"/".join(p): a for name, t in named.items()
            for p, a in flax_leaves(name, t, heads=heads.get(name))}
    np.savez(path, **flat)


@torch.no_grad()
def load_params_npz(path: str, module: torch.nn.Module
                    ) -> Tuple[torch.nn.Module, int]:
    """strict=False-style load into ``module`` in place (reference:
    utils.py:63-71 load_state_dict semantics): the file's flax tree is
    converted to port names and layouts (``convert.flax_to_state_dict``),
    and every parameter whose name it holds with the same shape takes
    the array (cast to its dtype); the rest keep their values. A
    tensor-parallel model (parallel/mesh.py shard_model) takes its
    shards of the file's whole tensors. Returns (module, count
    filled)."""
    data = np.load(path)
    tree: Dict[str, Any] = {}
    for key in data.files:
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = data[key]
    sd = shard_state_dict(flax_to_state_dict(tree), module)
    loaded = 0
    for name, p in module.named_parameters():
        if name in sd and sd[name].shape == p.shape:
            p.copy_(sd[name])
            loaded += 1
    return module, loaded
