"""Configuration of the port.

The dataclasses are those of ``vlpet_tpu.config``, the one framework-free
module the port shares with the JAX package (importing it loads neither jax
nor any other part of ``vlpet_tpu``). Everything in the port, and every
script that drives it, takes its configuration from here.
"""

from __future__ import annotations

from vlpet_tpu.config import (AdapterSpec, BartConfig, PetConfig, VisConfig,
                              VLModelConfig, vlpet_recipe)

__all__ = ["AdapterSpec", "BartConfig", "PetConfig", "VisConfig",
           "VLModelConfig", "vlpet_recipe", "FLAGSHIP_TASKS", "flagship_cfg"]

FLAGSHIP_TASKS = ("vqa", "gqa", "nlvr", "caption")


def flagship_cfg(dtype: str = "float32") -> VLModelConfig:
    """BART-base + VL-PET-large at full width, the configuration of
    ``__graft_entry__._flagship_cfg``: the published recipe
    (scripts/image-text/VL-PET-large.sh: r 96, 4 heads, gate 96), multitask
    image-text (``FLAGSHIP_TASKS``), 36 boxes of 2048-d features."""
    pet = vlpet_recipe("large", r=96, num_heads=4, gate_dim=96,
                       tasks=FLAGSHIP_TASKS)
    return VLModelConfig(backbone=BartConfig(),
                         vis=VisConfig(feat_dim=2048, n_boxes=36), pet=pet,
                         dtype=dtype)
