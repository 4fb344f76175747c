"""PET modules, ported from vlpet_tpu/pet/modules.py: the task-routed
dense layer; the adapters of the serial-adapter baselines (the bottleneck
adapter, Compacter's ``HyperComplexAdapter`` over ``PHMDense``, the
``LowRankAdapter`` over ``LowRankDense``) and their ``AdapterController``
with its optional LayerNorms (also the VPA, KPA, sequential and down-dim
adapters of VL-PET and its ablations); LoRA's task-routed ``LoRADense``;
the four multihead adapter shapes (down, up, down-up, pair), and the four
granularity gates (VL-PET-large's low-rank gate, -small's per-example and
-middleX's per-token scalar gates, -middleY's vector, also the IA3
vectors) plus the full d x d GateLargeX.

``track_z``: the three adapter kinds append their bottleneck activation z
to ``PetContext.zs`` when the call's context holds a list there (the train
step's ``lambda_z`` regularizer, vlpet_tpu/pet/modules.py:380, :407,
:477); nothing is kept on a module between calls.

Parameter names follow the flax tree (TaskDense ``weight``/``bias`` for
flax ``kernel``/``bias``; every other leaf -- the multihead per-head
``down_kernel``/``down_bias``, ``W``, ``W_left``, ``W_right``, ``b``,
``phm_rule``, ``lora_A``, ``lora_B`` -- keeps its name and shape), so
vlpet_tpu_torch.convert is a rename plus transposes and the freezing
substrings match as in JAX. Activation math runs in the module's compute
dtype, as in the JAX package; parameters are created in that dtype too
(the JAX modules cast their fp32 params at every use, which gives the same
values). A module whose parameters the JAX package initialises other than
normal(0, init_std) / zero biases has ``init_params(generator)``, which
``VLBart.init_weights`` calls after its generic pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import AdapterSpec, LoraSpec, PetConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm
from vlpet_tpu_torch.ops.activations import gelu, gelu_new
from vlpet_tpu_torch.ops.hashdrop import hash_dropout
from vlpet_tpu_torch.parallel.tensor import ModelShard, copy_to_model


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


# ---------------------------------------------------------------------------
# Initialisers of the JAX package (vlpet_tpu/pet/modules.py:80-125), in place
# ---------------------------------------------------------------------------


def normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=g, device=g.device) * std)


def uniform_(p: torch.Tensor, lo: float, hi: float,
             g: torch.Generator) -> None:
    p.copy_(lo + (hi - lo) * torch.rand(p.shape, generator=g,
                                        device=g.device))


def glorot_uniform_gain2_(p: torch.Tensor, g: torch.Generator) -> None:
    """xavier_uniform with gain sqrt(2) over the last two dims."""
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (p.shape[-2] + p.shape[-1]))
    uniform_(p, -bound, bound, g)


def glorot_normal_gain2_(p: torch.Tensor, g: torch.Generator) -> None:
    normal_(p, math.sqrt(2.0) * math.sqrt(2.0 / (p.shape[-2] + p.shape[-1])),
            g)


@dataclasses.dataclass(frozen=True, eq=False)
class PetContext:
    """Per-call PET state (vlpet_tpu/pet/modules.py:147): the static task
    routing; the model-shared Compacter rule ``phm_rule`` and slow weights
    ``phm_W`` ({"down": W, "up": W}, W a tensor or a (W_left, W_right)
    pair), which ``VLBart`` injects; and ``block_adapters``, the current
    layer's hypernet-generated adapter weights (pet/hypernet.py); ``zs``,
    where a list, collects the bottleneck activations of the adapters
    whose spec has ``track_z``, in call order. ``example_base`` and
    ``global_batch`` place a data-parallel rank's batch in the step's
    global batch (its first example, the global row count; 0 and None in
    one process): the dropout seeds fold by them (``DropoutSeeds``) and
    ``vis.sparse_sample`` draws the global scores (``sparse_scores``)."""

    task: str = "default"
    task_idx: int = 0
    phm_rule: Optional[torch.Tensor] = None
    phm_W: Any = None
    block_adapters: Any = None
    zs: Optional[List[torch.Tensor]] = None
    example_base: int = 0
    global_batch: Optional[int] = None

    def for_layer(self, block_adapters) -> "PetContext":
        return dataclasses.replace(self, block_adapters=block_adapters)


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


class LowRankDense(nn.Module):
    """W = W_left @ W_right, rank-k (vlpet_tpu/pet/modules.py:232); applied
    as (x @ W_left) @ W_right + b."""

    def __init__(self, in_dim: int, out_dim: int, rank: int = 1,
                 n_tasks: int = 1, shared: bool = True, use_bias: bool = True,
                 w_init: str = "glorot-uniform", dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.shared, self.w_init = shared, w_init
        lead = () if shared else (n_tasks,)
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.dtype = dtype
        self.W_left = nn.Parameter(torch.empty(lead + (in_dim, rank), **kw))
        self.W_right = nn.Parameter(torch.empty(lead + (rank, out_dim), **kw))
        self.b = (nn.Parameter(torch.empty(lead + (out_dim,), **kw))
                  if use_bias else None)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        init = (glorot_uniform_gain2_ if self.w_init == "glorot-uniform"
                else glorot_normal_gain2_)
        init(self.W_left, g)
        init(self.W_right, g)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor, task_idx: int = 0) -> torch.Tensor:
        y = ((x.to(self.dtype) @ _task(self.W_left, self.shared, task_idx))
             @ _task(self.W_right, self.shared, task_idx))
        b = _task(self.b, self.shared, task_idx)
        return y + b if b is not None else y


def _task(p: Optional[torch.Tensor], shared: bool, task_idx: int):
    return p if p is None or shared else p[task_idx]


class PHMDense(nn.Module):
    """Parameterized-hypercomplex linear layer of Compacter
    (vlpet_tpu/pet/modules.py:263): y = x . (sum_r rule[r] (x) W[r]) + b,
    computed by the JAX package's two contractions, ``...ik,rko->...rio``
    then ``...rio,rij->...jo``, over x viewed as (..., pd, in/pd) -- never
    the materialised Kronecker sum.

    ``own_W`` False: the layer owns no slow weight and takes the model's
    shared one (``W_shared`` at the call, shared_W_phm). ``own_rule``
    False: the rule comes in as ``phm_rule`` (shared_phm_rule). An owned
    W is (pd, in/pd, out/pd) or, with ``factorized_phm``, W_left (pd,
    in/pd, rank) and W_right (pd, rank, out/pd), each with a leading task
    axis unless ``shared``; an owned rule is (pd, pd, pd) (or its
    ``factorized_phm_rule`` pair) with a task axis unless ``shared`` or
    ``shared_phm_rule_over_tasks``."""

    def __init__(self, in_dim: int, out_dim: int, spec: AdapterSpec,
                 n_tasks: int = 1, shared: bool = True, use_bias: bool = True,
                 own_W: bool = True, own_rule: bool = True,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        pd = spec.hypercomplex_division
        if in_dim % pd or out_dim % pd:
            raise ValueError(f"({in_dim}, {out_dim}) not divisible by "
                             f"hypercomplex_division {pd}")
        self.spec, self.shared, self.dtype = spec, shared, dtype
        self.in_dim, self.out_dim, self.pd = in_dim, out_dim, pd
        self.rule_shared = shared or spec.shared_phm_rule_over_tasks
        lead = () if shared else (n_tasks,)
        kw = dict(dtype=dtype, device=resolve_device(device))
        ip, op = in_dim // pd, out_dim // pd
        if own_W and spec.factorized_phm:
            self.W_left = nn.Parameter(torch.empty(
                lead + (pd, ip, spec.phm_rank), **kw))
            self.W_right = nn.Parameter(torch.empty(
                lead + (pd, spec.phm_rank, op), **kw))
        elif own_W:
            self.W = nn.Parameter(torch.empty(lead + (pd, ip, op), **kw))
        if own_rule:
            rlead = () if self.rule_shared else (n_tasks,)
            if spec.factorized_phm_rule:
                self.phm_rule_left = nn.Parameter(torch.empty(
                    rlead + (pd, pd, 1), **kw))
                self.phm_rule_right = nn.Parameter(torch.empty(
                    rlead + (pd, 1, pd), **kw))
            else:
                self.phm_rule = nn.Parameter(torch.empty(rlead + (pd, pd, pd),
                                                         **kw))
        self.b = (nn.Parameter(torch.empty(lead + (out_dim,), **kw))
                  if use_bias else None)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        s = self.spec
        for name in ("W", "W_left", "W_right"):
            if hasattr(self, name):
                glorot_uniform_gain2_(getattr(self, name), g)
        for name in ("phm_rule", "phm_rule_left", "phm_rule_right"):
            if hasattr(self, name):
                if s.phm_c_init == "normal":
                    normal_(getattr(self, name), s.phm_init_range, g)
                else:  # flax uniform(scale=0.02): U[0, 0.02)
                    uniform_(getattr(self, name), 0.0, 0.02, g)
        if self.b is not None:
            self.b.zero_()

    def _W(self, task_idx: int, W_shared) -> torch.Tensor:
        dt = self.dtype
        if W_shared is not None:
            if isinstance(W_shared, tuple):
                wl, wr = W_shared
                return torch.einsum("rip,rpo->rio", wl.to(dt), wr.to(dt))
            return W_shared.to(dt)
        if hasattr(self, "W_left"):
            return torch.einsum(
                "rip,rpo->rio", _task(self.W_left, self.shared, task_idx),
                _task(self.W_right, self.shared, task_idx))
        if not hasattr(self, "W"):
            raise ValueError("this PHMDense owns no W: pass W_shared")
        return _task(self.W, self.shared, task_idx)

    def _rule(self, task_idx: int) -> torch.Tensor:
        if hasattr(self, "phm_rule_left"):
            return torch.einsum(
                "rio,roj->rij",
                _task(self.phm_rule_left, self.rule_shared, task_idx),
                _task(self.phm_rule_right, self.rule_shared, task_idx))
        if not hasattr(self, "phm_rule"):
            raise ValueError("this PHMDense owns no rule: pass phm_rule")
        return _task(self.phm_rule, self.rule_shared, task_idx)

    def forward(self, x: torch.Tensor, task_idx: int = 0,
                phm_rule: Optional[torch.Tensor] = None,
                W_shared: Any = None) -> torch.Tensor:
        W = self._W(task_idx, W_shared)
        rule = (phm_rule if phm_rule is not None
                else self._rule(task_idx)).to(self.dtype)
        lead = x.shape[:-1]
        xr = x.to(self.dtype).reshape(lead + (self.pd, self.in_dim // self.pd))
        t = torch.einsum("...ik,rko->...rio", xr, W)
        y = torch.einsum("...rio,rij->...jo", t, rule).reshape(
            lead + (self.out_dim,))
        if self.b is not None:
            y = y + _task(self.b, self.shared, task_idx)
        return y


class BottleneckAdapter(nn.Module):
    """down -> act -> up; returns the delta (the combination lives in
    AdapterController)."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        n_tasks = len(spec.tasks)
        down_shared, up_shared = _sampler_sharing(spec)
        self.act = get_activation(spec.non_linearity)
        self.down_sampler = TaskDense(spec.d_model, spec.down_dim, n_tasks,
                                      down_shared, dtype=dtype, device=device)
        self.up_sampler = TaskDense(spec.down_dim, spec.d_model, n_tasks,
                                    up_shared, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, task_idx: int = 0,
                zs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        return self.up_sampler(_track(self.act(self.down_sampler(x, task_idx)),
                                      zs), task_idx)


def _track(z: torch.Tensor, zs: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """z, appended to ``zs`` where that is a list (track_z)."""
    if zs is not None:
        zs.append(z)
    return z


def _sampler_sharing(spec: AdapterSpec) -> Tuple[bool, bool]:
    """(down shared, up shared) over the tasks, for every adapter kind
    (reference: src/adapters/adapter_controller.py:69-77)."""
    one = spec.use_single_adapter or len(spec.tasks) == 1
    return one or spec.share_down_sampler, one or spec.share_up_sampler


class LowRankAdapter(nn.Module):
    """Rank-factorized bottleneck adapter (vlpet_tpu/pet/modules.py:387):
    its bottleneck is always d_model // reduction_factor, as the
    reference's."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        n_tasks = len(spec.tasks)
        down = spec.d_model // spec.reduction_factor
        down_shared, up_shared = _sampler_sharing(spec)
        kw = dict(rank=spec.low_rank_rank, n_tasks=n_tasks,
                  w_init=spec.low_rank_w_init, dtype=dtype, device=device)
        self.act = get_activation(spec.non_linearity)
        self.down_sampler = LowRankDense(spec.d_model, down,
                                         shared=down_shared, **kw)
        self.up_sampler = LowRankDense(down, spec.d_model, shared=up_shared,
                                       **kw)

    def forward(self, x: torch.Tensor, task_idx: int = 0,
                zs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        return self.up_sampler(_track(self.act(self.down_sampler(x, task_idx)),
                                      zs), task_idx)


def shared_phm_W_dims(pet: PetConfig, d_model: int) -> Optional[Tuple[int, int]]:
    """(in, out) of the model-shared Compacter down weight (the up one is
    its reverse), or None when the model has none."""
    if not (pet.use_compacter and pet.shared_W_phm):
        return None
    down = (pet.adapter_down_dim if pet.use_adapter_down_dim
            else d_model // pet.reduction_factor)
    return d_model, down


def make_shared_phm_W(module: nn.Module, pet: PetConfig, d_model: int,
                      dtype=torch.float32, device: Device = "cuda") -> None:
    """Register the model-root Compacter slow weights on ``module``
    (vlpet_tpu/pet/modules.py:414): ``phm_W_down`` (pd, d/pd, down/pd) and
    ``phm_W_up`` (pd, down/pd, d/pd), or with ``factorized_phm`` their
    ``_left`` / ``_right`` factors of rank ``phm_rank``."""
    d, down = shared_phm_W_dims(pet, d_model)
    pd, rank = pet.hypercomplex_division, pet.phm_rank
    kw = dict(dtype=dtype, device=resolve_device(device))
    for prefix, i, o in (("phm_W_down", d, down), ("phm_W_up", down, d)):
        ip, op = i // pd, o // pd
        if pet.factorized_phm:
            module.register_parameter(f"{prefix}_left", nn.Parameter(
                torch.empty((pd, ip, rank), **kw)))
            module.register_parameter(f"{prefix}_right", nn.Parameter(
                torch.empty((pd, rank, op), **kw)))
        else:
            module.register_parameter(prefix, nn.Parameter(
                torch.empty((pd, ip, op), **kw)))


def shared_phm_W(module: nn.Module, pet: PetConfig) -> Dict[str, Any]:
    """{"down": W, "up": W} of ``make_shared_phm_W``'s parameters, a W a
    tensor or a (W_left, W_right) pair (``PetContext.phm_W``)."""
    def get(prefix):
        if pet.factorized_phm:
            return (getattr(module, f"{prefix}_left"),
                    getattr(module, f"{prefix}_right"))
        return getattr(module, prefix)
    return {"down": get("phm_W_down"), "up": get("phm_W_up")}


def _phm_w_dims(W: Any, pd: int) -> Tuple[int, int]:
    """(in_dim, out_dim) implied by a shared phm W (full or factorized)."""
    if isinstance(W, tuple):
        return W[0].shape[1] * pd, W[1].shape[2] * pd
    return W.shape[1] * pd, W.shape[2] * pd


class HyperComplexAdapter(nn.Module):
    """Compacter adapter: PHM down -> act -> PHM up
    (vlpet_tpu/pet/modules.py:447). ``phm_W_dims`` is
    ``shared_phm_W_dims``: the samplers take the model-shared slow weights
    (and own none) where their dims match the root's, as in JAX."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda",
                 phm_W_dims: Optional[Tuple[int, int]] = None):
        super().__init__()
        n_tasks = len(spec.tasks)
        down_shared, up_shared = _sampler_sharing(spec)
        self.spec = spec
        self.root_W = (spec.shared_W_phm and phm_W_dims is not None
                       and tuple(phm_W_dims) == (spec.d_model, spec.down_dim))
        kw = dict(spec=spec, n_tasks=n_tasks, own_W=not self.root_W,
                  own_rule=not spec.shared_phm_rule, dtype=dtype,
                  device=device)
        self.act = get_activation(spec.non_linearity)
        self.down_sampler = PHMDense(spec.d_model, spec.down_dim,
                                     shared=down_shared, **kw)
        self.up_sampler = PHMDense(spec.down_dim, spec.d_model,
                                   shared=up_shared, **kw)

    def forward(self, x: torch.Tensor, task_idx: int = 0,
                phm_rule: Optional[torch.Tensor] = None,
                phm_W: Any = None,
                zs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        s = self.spec
        rule = phm_rule if s.shared_phm_rule else None
        if s.shared_phm_rule and rule is None:
            raise ValueError("shared_phm_rule: the context holds no phm_rule")
        W_down = W_up = None
        if self.root_W:
            if phm_W is None:
                raise ValueError("shared_W_phm: the context holds no phm_W")
            pd = s.hypercomplex_division
            if _phm_w_dims(phm_W["down"], pd) != (s.d_model, s.down_dim):
                raise ValueError("shared phm W does not match the sampler")
            W_down, W_up = phm_W["down"], phm_W["up"]
        z = _track(self.act(self.down_sampler(x, task_idx, rule, W_down)), zs)
        return self.up_sampler(z, task_idx, rule, W_up)


class AdapterController(nn.Module):
    """Task-routed adapter (vlpet_tpu/pet/modules.py:484) of one of three
    kinds, the spec's: "bottleneck", "compacter" (``HyperComplexAdapter``,
    reading ``ctx.phm_rule`` / ``ctx.phm_W``) or "lowrank"
    (``LowRankAdapter``); optional LayerNorms ``pre_layer_norm`` on the
    adapter's input and ``post_layer_norm`` on its scaled output.
    Sequential out = scale*A(x) + x, parallel out = scale*A(x) + y (y the
    wrapped projection's output; the VPA form). Under the spec's
    ``track_z`` the adapter's z goes to ``ctx.zs``."""

    def __init__(self, spec: AdapterSpec, dtype=torch.float32,
                 device: Device = "cuda",
                 phm_W_dims: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.spec = spec
        kw = dict(dtype=dtype, device=device)
        if spec.add_layer_norm_before_adapter:
            self.pre_layer_norm = LayerNorm(spec.d_model, **kw)
        if spec.kind == "compacter":
            self.adapters = HyperComplexAdapter(spec, phm_W_dims=phm_W_dims,
                                                **kw)
        elif spec.kind == "lowrank":
            self.adapters = LowRankAdapter(spec, **kw)
        elif spec.kind == "bottleneck":
            self.adapters = BottleneckAdapter(spec, **kw)
        else:
            raise ValueError(f"unknown adapter kind {spec.kind!r}")
        if spec.add_layer_norm_after_adapter:
            self.post_layer_norm = LayerNorm(spec.d_model, **kw)

    def forward(self, inputs: torch.Tensor, ctx: PetContext,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.spec
        z = inputs
        if s.add_layer_norm_before_adapter:
            z = self.pre_layer_norm(z)
        zs = ctx.zs if s.track_z else None
        if s.kind == "compacter":
            out = self.adapters(z, ctx.task_idx, ctx.phm_rule, ctx.phm_W, zs)
        else:
            out = self.adapters(z, ctx.task_idx, zs)
        if s.use_scaling_factor:
            out = out * s.scaling_factor
        if s.add_layer_norm_after_adapter:
            out = self.post_layer_norm(out)
        if s.use_parallel_adapter:
            if y is None:
                raise ValueError("parallel adapter needs the wrapped output y")
            return out + y
        return out + inputs


class OutputParallelAdapterLayer(nn.Module):
    """The LM-head adapter (vlpet_tpu/pet/modules.py:520):
    ``adapter_down_sampler`` d -> d/16, gelu_new, ``adapter_up_sampler``
    d/16 -> vocab; its output is added to the logits. fp32 parameters and
    arithmetic, as the JAX module (built without a dtype) has them."""

    def __init__(self, d_model: int, output_dim: int,
                 non_linearity: str = "gelu_new", device: Device = "cuda"):
        super().__init__()
        down = d_model // 16
        self.act = get_activation(non_linearity)
        self.adapter_down_sampler = TaskDense(d_model, down, device=device)
        self.adapter_up_sampler = TaskDense(down, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.adapter_up_sampler(self.act(self.adapter_down_sampler(x)))


def per_head_param(h: int, fan_in: int, out: int, dtype,
                   device) -> nn.Parameter:
    """An uninitialised (h, fan_in, out) per-head kernel."""
    return nn.Parameter(torch.empty((h, fan_in, out), dtype=dtype,
                                    device=resolve_device(device)))


def fuse_heads(w: torch.Tensor) -> torch.Tensor:
    """Per-head (h, i, o) -> one (i, h*o): concat_j(x W_j) == x W_fused."""
    h, i, o = w.shape
    return w.permute(1, 0, 2).reshape(i, h * o)


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
        self.down_kernel = per_head_param(num_heads, d_model, rh, dtype, device)
        self.down_bias = nn.Parameter(torch.empty(
            (num_heads, rh), dtype=dtype, device=resolve_device(device)))
        self.act = get_activation(non_linearity)
        self.up = TaskDense(down_dim, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x @ fuse_heads(self.down_kernel) + self.down_bias.reshape(self.r)
        return self.up(self.act(z))


class MultiheadUpAdapter(nn.Module):
    """One down d -> r (``down``, a TaskDense) -> act -> h heads of
    r -> d/h (concat), stored per head as ``up_kernel`` (h, r, d/h) and
    ``up_bias`` (h, d/h) (vlpet_tpu/pet/modules.py:577); returns the
    delta."""

    def __init__(self, d_model: int, down_dim: int, num_heads: int,
                 non_linearity: str = "gelu_new", dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.d, self.r, self.h = d_model, down_dim, num_heads
        dh = d_model // num_heads
        self.down = TaskDense(d_model, down_dim, dtype=dtype, device=device)
        self.act = get_activation(non_linearity)
        self.up_kernel = per_head_param(num_heads, down_dim, dh, dtype, device)
        self.up_bias = nn.Parameter(torch.empty(
            (num_heads, dh), dtype=dtype, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.act(self.down(x))
        return z @ fuse_heads(self.up_kernel) + self.up_bias.reshape(self.d)


class MultiheadDownUpAdapter(nn.Module):
    """h downs d -> r/h (concat) -> act -> h ups r -> d/h (concat), each up
    reading the whole r-wide activation (vlpet_tpu/pet/modules.py:603):
    ``down_kernel`` (h, d, r/h), ``up_kernel`` (h, r, d/h) and their
    biases, applied as two fused GEMMs; returns the delta."""

    def __init__(self, d_model: int, down_dim: int, num_heads: int,
                 non_linearity: str = "gelu_new", dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if down_dim % num_heads or d_model % num_heads:
            raise ValueError(f"({d_model}, {down_dim}) not divisible by "
                             f"{num_heads} heads")
        self.d, self.r, self.h = d_model, down_dim, num_heads
        rh, dh = down_dim // num_heads, d_model // num_heads
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.down_kernel = per_head_param(num_heads, d_model, rh, dtype, device)
        self.down_bias = nn.Parameter(torch.empty((num_heads, rh), **kw))
        self.up_kernel = per_head_param(num_heads, down_dim, dh, dtype, device)
        self.up_bias = nn.Parameter(torch.empty((num_heads, dh), **kw))
        self.act = get_activation(non_linearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.act(x @ fuse_heads(self.down_kernel)
                     + self.down_bias.reshape(self.r))
        return z @ fuse_heads(self.up_kernel) + self.up_bias.reshape(self.d)


class MultiheadPairAdapter(nn.Module):
    """h independent pairs d -> r/h -> d/h (vlpet_tpu/pet/modules.py:631):
    one fused down GEMM, then a block-diagonal up, head j's r/h
    activations through its own ``up_kernel[j]`` (h, r/h, d/h) -- the JAX
    package's per-head einsum ``...hr,hro->...ho``, not one (r, d)
    product; returns the delta."""

    def __init__(self, d_model: int, down_dim: int, num_heads: int,
                 non_linearity: str = "gelu_new", dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if down_dim % num_heads or d_model % num_heads:
            raise ValueError(f"({d_model}, {down_dim}) not divisible by "
                             f"{num_heads} heads")
        self.d, self.r, self.h = d_model, down_dim, num_heads
        rh, dh = down_dim // num_heads, d_model // num_heads
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.down_kernel = per_head_param(num_heads, d_model, rh, dtype, device)
        self.down_bias = nn.Parameter(torch.empty((num_heads, rh), **kw))
        self.up_kernel = per_head_param(num_heads, rh, dh, dtype, device)
        self.up_bias = nn.Parameter(torch.empty((num_heads, dh), **kw))
        self.act = get_activation(non_linearity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.act(x @ fuse_heads(self.down_kernel)
                     + self.down_bias.reshape(self.r))
        zh = z.reshape(z.shape[:-1] + (self.h, self.r // self.h))
        y = torch.einsum("...hr,hro->...ho", zh, self.up_kernel) + self.up_bias
        return y.reshape(x.shape[:-1] + (self.d,))


# the encoder's multihead adapter shapes, by flag, in the JAX elif order
# (vlpet_tpu/models/bart.py:528-541)
MULTIHEAD_ADAPTERS = (
    ("use_encoder_adapter_down_multihead", MultiheadDownAdapter),
    ("use_encoder_adapter_up_multihead", MultiheadUpAdapter),
    ("use_encoder_adapter_down_up_multihead", MultiheadDownUpAdapter),
    ("use_encoder_adapter_down_up_pair_multihead", MultiheadPairAdapter),
)


class GateLargeXLowRank(nn.Module):
    """VL-PET-large gate G = sigmoid(U gelu_new(D x))."""

    def __init__(self, d_model: int, gating_down_dim: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.down = TaskDense(d_model, gating_down_dim, dtype=dtype,
                              device=device)
        self.up = TaskDense(gating_down_dim, d_model, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor = None,
                return_pre_sigmoid: bool = False):
        pre = self.up(gelu_new(self.down(x)))
        gate = torch.sigmoid(pre)
        if return_pre_sigmoid:
            return gate, pre
        return gate


class GateLargeX(nn.Module):
    """Full d x d gate from the block input: G = sigmoid(W x)
    (vlpet_tpu/pet/modules.py:668)."""

    def __init__(self, d_model: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.proj = TaskDense(d_model, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor = None) -> torch.Tensor:
        return torch.sigmoid(self.proj(x))


class GateSmallXYCat(nn.Module):
    """VL-PET-small gate: one scalar per example, sigmoid(W [x; y]) meaned
    over all L tokens, padding included, as the JAX mean does
    (vlpet_tpu/pet/modules.py:706); (B, 1, 1)."""

    def __init__(self, d_model: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.proj = TaskDense(2 * d_model, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        g = torch.sigmoid(self.proj(torch.cat([x, y], dim=-1)))
        return g.mean(dim=-2, keepdim=True)


class GateMiddleXYAdd(nn.Module):
    """VL-PET-middleX gate: one scalar per token, sigmoid(W (x + y))
    (vlpet_tpu/pet/modules.py:722); (B, L, 1)."""

    def __init__(self, d_model: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.proj = TaskDense(d_model, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.proj(x + y))


class IA3Vector(nn.Module):
    """The learned d-vector of VL-PET-middleY (vlpet_tpu/pet/modules.py:737):
    one fp32 parameter named ``param_name``; init normal(0, 0.02)."""

    def __init__(self, dim: int, param_name: str = "ia3",
                 device: Device = "cuda"):
        super().__init__()
        self.param_name = param_name
        self.register_parameter(param_name, nn.Parameter(
            torch.empty(dim, device=resolve_device(device))))

    def forward(self) -> torch.Tensor:
        return getattr(self, self.param_name)


def build_gate(cls, d_model: int, pet, dtype=torch.float32,
               device: Device = "cuda") -> nn.Module:
    """An encoder granularity gate of class ``cls`` (an entry of a
    backbone's GATES table), built as both JAX backbones build it:
    middle-Y's vector under the flax name ``gating_middle_ia3``, the
    low-rank gate at ``pet.adapter_gating_down_dim``. Every gate but the
    IA3Vector is called as gate(x, y), x the sublayer's input and y its
    output; GateLargeX and GateLargeXLowRank read x alone."""
    if cls is IA3Vector:
        return IA3Vector(d_model, "gating_middle_ia3", device=device)
    if cls is GateLargeXLowRank:
        return cls(d_model, pet.adapter_gating_down_dim, dtype=dtype,
                   device=device)
    return cls(d_model, dtype=dtype, device=device)


class LoRADense(nn.Module):
    """Dense with a LoRA delta (vlpet_tpu/pet/modules.py:756):
    y = base(x) + dropout(x) @ A @ B * (alpha / r). ``base`` is a
    TaskDense; ``lora_A`` (in, r) and ``lora_B`` (r, out) carry a leading
    task axis, picked by the static task index, unless ``use_single_lora``
    (or one task). The dropout is the hash mask of ops/hashdrop.py at
    ``rate`` (the spec's ``lora_dropout``), drawn only when a training call
    hands the layer its seed (one ``DropoutSeeds`` site a call); the JAX
    layer draws it with jax.random. Under tensor parallelism (``shard_``)
    the base holds the rank's output rows (heads), ``lora_A`` and
    ``lora_B`` stay whole, and the forward takes ``lora_B``'s columns of
    the rank's heads: both enter the shard through ``copy_to_model``, so
    their gradients come back whole on every rank."""

    tp: Optional[ModelShard] = None

    def __init__(self, in_dim: int, out_dim: int, spec: LoraSpec,
                 use_bias: bool = True, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        n_tasks = 1 if spec.use_single_lora else len(spec.tasks)
        self.shared = n_tasks == 1
        self.in_dim, self.dtype = in_dim, dtype
        self.rate = spec.lora_dropout
        self.scale = spec.lora_alpha / spec.lora_dim
        self.base = TaskDense(in_dim, out_dim, use_bias=use_bias, dtype=dtype,
                              device=device)
        lead = () if self.shared else (n_tasks,)
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.lora_A = nn.Parameter(torch.empty(lead + (in_dim, spec.lora_dim),
                                               **kw))
        self.lora_B = nn.Parameter(torch.empty(lead + (spec.lora_dim, out_dim),
                                               **kw))

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        """A: torch's kaiming_uniform(a=sqrt(5)) on (r, in), U(+-1/sqrt(in));
        B: zeros (the base keeps the generic init)."""
        bound = 1.0 / math.sqrt(self.in_dim)
        uniform_(self.lora_A, -bound, bound, g)
        self.lora_B.zero_()

    def shard_(self, shard: ModelShard, whole_heads: int,
               head_dim: int) -> None:
        """Take the rank's ``whole_heads`` / M heads of ``head_dim`` columns
        (parallel/mesh.py shard_model has cut the base's rows)."""
        self.tp, self.heads = shard, (whole_heads, head_dim)

    def forward(self, x: torch.Tensor, task_idx: int = 0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        base = self.base(x)
        a = _task(self.lora_A, self.shared, task_idx)
        b = _task(self.lora_B, self.shared, task_idx)
        if self.tp is not None:
            a = copy_to_model(a, self.tp)
            b = self.tp.columns(b, *self.heads)
        xz = x
        if seed is not None and self.rate > 0.0:
            xz = hash_dropout(x, seed, self.rate)
        delta = (xz.to(self.dtype) @ a) @ b
        return base + delta * self.scale
