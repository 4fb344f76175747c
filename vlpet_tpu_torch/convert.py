"""flax parameters -> port state_dict.

Takes the nested dict of arrays that ``model.init(...)["params"]`` gives
(after ``jax.device_get``; numpy arrays, or anything ``np.asarray`` reads)
and maps it onto a port module by the flax path:

* ``kernel`` leaves (Dense / TaskDense, (in, out) or per-task
  (T, in, out)) become ``weight`` with the last two axes swapped: (out, in)
  or (T, out, in);
* every other leaf keeps its name and shape (LayerNorm ``scale``/``bias``,
  embeddings, ``final_logits_bias``, the multihead per-head
  ``down_kernel``/``down_bias``).

It raises on any flax leaf it cannot place and on any port parameter left
unset, so a renamed or missing module never loads silently.
``flax_to_state_dict`` also reads a partial tree, such as the trainable
subtree of the JAX train step (None where a parameter is frozen), and then
names only the leaves it holds.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into port state_dict names/layouts;
    None leaves (parameters left out of a partial tree) are skipped."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: tuple) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            if val is None:
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr, key = np.swapaxes(arr, -1, -2), "weight"
            out[".".join(prefix + (key,))] = torch.tensor(
                np.ascontiguousarray(arr))

    walk(params, ())
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a flax parameter tree into ``module`` (cast to each parameter's
    dtype and device). Raises on unplaced leaves, unset parameters and shape
    mismatches."""
    sd = flax_to_state_dict(params)
    own = module.state_dict()
    unplaced = sorted(set(sd) - set(own))
    unset = sorted(set(own) - set(sd))
    if unplaced or unset:
        raise ValueError(f"flax tree does not match the port module:\n"
                         f"  flax leaves not placed: {unplaced}\n"
                         f"  port parameters unset: {unset}")
    bad = [f"{k}: flax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
           for k in sd if sd[k].shape != own[k].shape]
    if bad:
        raise ValueError("shape mismatch:\n  " + "\n  ".join(bad))
    module.load_state_dict(sd, strict=True)
    return module
