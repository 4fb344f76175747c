"""PET modules used by the VL-PET-large decode path, ported from
vlpet_tpu/pet/modules.py.

Parameter names follow the flax tree (TaskDense ``weight``/``bias`` for
flax ``kernel``/``bias``; the multihead per-head ``down_kernel``/
``down_bias`` keep their names and shapes), so vlpet_tpu_torch.convert is
a rename plus transposes. Activation math runs in the module's compute
dtype, as in the JAX package; parameters are created in that dtype too
(the JAX modules cast their fp32 params at every use, which gives the same
values).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import AdapterSpec
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.ops.activations import gelu, gelu_new


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """HF ACT2FN names: gelu (erf), gelu_new (tanh), relu, swish/silu,
    tanh, sigmoid."""
    name = name.lower()
    table = {"gelu_new": gelu_new, "gelu": gelu, "relu": torch.relu,
             "swish": F.silu, "silu": F.silu, "tanh": torch.tanh,
             "sigmoid": torch.sigmoid}
    if name not in table:
        raise ValueError(f"unknown activation: {name}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class PetContext:
    """Per-call PET state: the static task routing of the JAX package.
    (The Compacter/hyperformer fields are not on the ported slice.)"""

    task: str = "default"
    task_idx: int = 0


class TaskDense(nn.Module):
    """Linear layer with an optional leading task axis: ``weight`` is
    (out, in) when shared, (n_tasks, out, in) otherwise, picked by the
    static task index."""

    def __init__(self, in_dim: int, out_dim: int, n_tasks: int = 1,
                 shared: bool = True, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.in_dim, self.out_dim, self.shared = in_dim, out_dim, shared
        lead = () if shared else (n_tasks,)
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.weight = nn.Parameter(torch.empty(lead + (out_dim, in_dim), **kw))
        self.bias = (nn.Parameter(torch.empty(lead + (out_dim,), **kw))
                     if use_bias else None)

    def wb(self, task_idx: int = 0):
        """(weight (out, in), bias) of the task, for callers that fuse
        several projections into one GEMM."""
        if self.shared:
            return self.weight, self.bias
        return (self.weight[task_idx],
                self.bias[task_idx] if self.bias is not None else None)

    def forward(self, x: torch.Tensor, task_idx: int = 0) -> torch.Tensor:
        w, b = self.wb(task_idx)
        return F.linear(x.to(w.dtype), w, b)


class BottleneckAdapter(nn.Module):
    """down -> act -> up; returns the delta (the combination lives in
    AdapterController)."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        n_tasks = len(spec.tasks)
        down_shared = (spec.use_single_adapter or spec.share_down_sampler
                       or n_tasks == 1)
        up_shared = (spec.use_single_adapter or spec.share_up_sampler
                     or n_tasks == 1)
        self.act = get_activation(spec.non_linearity)
        self.down_sampler = TaskDense(spec.d_model, spec.down_dim, n_tasks,
                                      down_shared, dtype=dtype, device=device)
        self.up_sampler = TaskDense(spec.down_dim, spec.d_model, n_tasks,
                                    up_shared, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, task_idx: int = 0) -> torch.Tensor:
        return self.up_sampler(self.act(self.down_sampler(x, task_idx)),
                               task_idx)


class AdapterController(nn.Module):
    """Task-routed bottleneck adapter: sequential out = scale*A(x) + x,
    parallel out = scale*A(x) + y (y the wrapped projection's output; the
    VPA form)."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if spec.kind != "bottleneck" or spec.track_z:
            raise NotImplementedError(
                f"adapter kind {spec.kind!r} / track_z is not ported")
        if spec.add_layer_norm_before_adapter or spec.add_layer_norm_after_adapter:
            raise NotImplementedError("adapter layer norms are not ported")
        self.spec = spec
        self.adapters = BottleneckAdapter(spec, dtype=dtype, device=device)

    def forward(self, inputs: torch.Tensor, ctx: PetContext,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.spec
        out = self.adapters(inputs, ctx.task_idx)
        if s.use_scaling_factor:
            out = out * s.scaling_factor
        if s.use_parallel_adapter:
            if y is None:
                raise ValueError("parallel adapter needs the wrapped output y")
            return out + y
        return out + inputs


class MultiheadDownAdapter(nn.Module):
    """h heads of d -> r/h (concat) -> act -> one up r -> d; returns the
    delta. Stored per head (h, d, r/h) like the reference; applied as one
    fused (d, r) GEMM."""

    def __init__(self, d_model: int, down_dim: int, num_heads: int,
                 non_linearity: str = "gelu_new", dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if down_dim % num_heads:
            raise ValueError(f"down_dim {down_dim} not divisible by "
                             f"{num_heads} heads")
        self.d, self.r, self.h = d_model, down_dim, num_heads
        rh = down_dim // num_heads
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.down_kernel = nn.Parameter(torch.empty((num_heads, d_model, rh),
                                                    **kw))
        self.down_bias = nn.Parameter(torch.empty((num_heads, rh), **kw))
        self.act = get_activation(non_linearity)
        self.up = TaskDense(down_dim, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (h, d, rh) -> (d, h*rh): concat_i(x W_i + b_i) == x W_fused + b_fused
        w = self.down_kernel.permute(1, 0, 2).reshape(self.d, self.r)
        z = x @ w + self.down_bias.reshape(self.r)
        return self.up(self.act(z))


class GateLargeXLowRank(nn.Module):
    """VL-PET-large gate G = sigmoid(U gelu_new(D x))."""

    def __init__(self, d_model: int, gating_down_dim: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.down = TaskDense(d_model, gating_down_dim, dtype=dtype,
                              device=device)
        self.up = TaskDense(gating_down_dim, d_model, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor, return_pre_sigmoid: bool = False):
        pre = self.up(gelu_new(self.down(x)))
        gate = torch.sigmoid(pre)
        if return_pre_sigmoid:
            return gate, pre
        return gate
