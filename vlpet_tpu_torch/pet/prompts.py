"""Prompt tuning, ported from vlpet_tpu/pet/prompts.py: learned prefix
tokens reparameterised through an MLP (``InputPrompts``), one shared or one
per task (``PromptController``). The encoder prepends them to its input
embeddings (models/bart.py ``JointEncoder``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import PromptSpec
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.pet.modules import TaskDense, normal_


class InputPrompts(nn.Module):
    """``prefix_embedding`` (P, d) -> mlp_in -> tanh -> mlp_out, broadcast
    over the batch (vlpet_tpu/pet/prompts.py:23). The table's init is
    normal(0, init_std), or normal(0, 1) without an init_std; the two
    dense layers take the model's generic init."""

    def __init__(self, spec: PromptSpec, d_model: int,
                 init_std: Optional[float] = None, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.init_std = init_std
        self.prefix_embedding = nn.Parameter(torch.empty(
            (spec.prompt_len, d_model), dtype=dtype,
            device=resolve_device(device)))
        kw = dict(dtype=dtype, device=device)
        self.mlp_in = TaskDense(d_model, spec.mid_dim, **kw)
        self.mlp_out = TaskDense(spec.mid_dim, d_model, **kw)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.prefix_embedding, self.init_std or 1.0, g)

    def forward(self, bsz: int) -> torch.Tensor:
        prompt = self.mlp_out(torch.tanh(self.mlp_in(self.prefix_embedding)))
        return prompt[None].expand((bsz,) + prompt.shape)


class PromptController(nn.Module):
    """One ``InputPrompts`` named ``prompts`` under ``use_single_prompt``
    (or one task), else one ``prompts_{task}`` per task, picked by the
    static task index (vlpet_tpu/pet/prompts.py:44)."""

    def __init__(self, spec: PromptSpec, d_model: int,
                 init_std: Optional[float] = None, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        kw = dict(init_std=init_std, dtype=dtype, device=device)
        self.single = spec.use_single_prompt or len(spec.tasks) == 1
        self.names = (["prompts"] if self.single
                      else [f"prompts_{t}" for t in spec.tasks])
        for name in self.names:
            self.add_module(name, InputPrompts(spec, d_model, **kw))

    def forward(self, bsz: int, task_idx: int = 0) -> torch.Tensor:
        return getattr(self, self.names[0 if self.single else task_idx])(bsz)
