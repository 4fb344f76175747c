"""Hyperformer hypernetworks, ported from vlpet_tpu/pet/hypernet.py: they
generate each layer's adapter weights (and conditional-LayerNorm weights)
from a task embedding and a layer embedding (and, in the one-hypernet
form, a block-type embedding).

One controller per stack (``adapter_layers_hyper_net``); its per-layer
weights reach the layers through ``PetContext.block_adapters`` and are
applied by ``MetaLayersAdapterController`` (``adapter_hypernet``, which
has no parameters). Every generator is a dense layer with the JAX
package's ``_hyper_dense`` init, normal(0, 1e-2) and a zero bias; the task,
layer and block-type tables are normal(0, 1). Dense kernels are
``weight`` (out, in), as everywhere in the port (vlpet_tpu_torch.convert).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import HyperformerSpec
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm
from vlpet_tpu_torch.pet.modules import TaskDense, get_activation, normal_


class SamplerWeights(NamedTuple):
    weight: torch.Tensor  # (out, in), the F.linear convention
    bias: torch.Tensor


class LayerNormWeights(NamedTuple):
    weight: torch.Tensor
    bias: torch.Tensor


class AdapterWeights(NamedTuple):
    up: SamplerWeights
    down: SamplerWeights
    pre_norm: Optional[LayerNormWeights] = None
    post_norm: Optional[LayerNormWeights] = None


class BlockAdapterWeights(NamedTuple):
    feed_forward: AdapterWeights
    self_attention: AdapterWeights
    cross_attention: Optional[AdapterWeights] = None


class HyperDense(TaskDense):
    """``_hyper_dense`` (vlpet_tpu/pet/hypernet.py:60): a dense layer with
    normal(0, 1e-2) weights and a zero bias."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__(in_dim, out_dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.weight, 1e-2, g)
        self.bias.zero_()


class TaskHyperNet(nn.Module):
    """fc1 -> relu -> fc2 over the flattened embedding
    (vlpet_tpu/pet/hypernet.py:66); fp32, as the JAX module runs."""

    def __init__(self, spec: HyperformerSpec, input_dim: int,
                 device: Device = "cuda"):
        super().__init__()
        self.fc1 = HyperDense(input_dim, spec.hidden_dim, device=device)
        self.fc2 = HyperDense(spec.hidden_dim,
                              spec.projected_task_embedding_dim,
                              device=device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(emb.reshape(-1)))).reshape(-1)


class LayerNormHyperNet(nn.Module):
    """Conditional-LayerNorm weight and bias from an embedding
    (vlpet_tpu/pet/hypernet.py:82); fp32."""

    def __init__(self, spec: HyperformerSpec, input_dim: int,
                 device: Device = "cuda"):
        super().__init__()
        p = spec.projected_task_embedding_dim
        self.weight_generator = HyperDense(p, input_dim, device=device)
        self.bias_generator = HyperDense(p, input_dim, device=device)

    def forward(self, emb: torch.Tensor) -> LayerNormWeights:
        return LayerNormWeights(self.weight_generator(emb),
                                self.bias_generator(emb))


class TaskEmbeddingController(nn.Module):
    """``task_to_embeddings`` (n_tasks, task_embedding_dim), normal(0, 1),
    indexed by the static task, projected by a TaskHyperNet under
    ``train_task_embeddings`` (vlpet_tpu/pet/hypernet.py:99)."""

    def __init__(self, spec: HyperformerSpec, tasks, device: Device = "cuda"):
        super().__init__()
        self.spec = spec
        self.task_to_embeddings = nn.Parameter(torch.empty(
            (len(tasks), spec.task_embedding_dim),
            device=resolve_device(device)))
        if spec.train_task_embeddings:
            self.task_hyper_net = TaskHyperNet(spec, spec.task_embedding_dim,
                                               device=device)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.task_to_embeddings, 1.0, g)

    def forward(self, task_idx: int) -> torch.Tensor:
        emb = self.task_to_embeddings[task_idx]
        if self.spec.train_task_embeddings:
            emb = self.task_hyper_net(emb)
        return emb


class AdapterWeightGenerator(nn.Module):
    """(weight (input_dim, output_dim), bias (input_dim,)) of one sampler
    (vlpet_tpu/pet/hypernet.py:116): ``weight`` is the sampler's F.linear
    weight, (out, in) = (input_dim, output_dim)."""

    def __init__(self, spec: HyperformerSpec, input_dim: int, output_dim: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        p = spec.projected_task_embedding_dim
        self.input_dim, self.output_dim = input_dim, output_dim
        kw = dict(dtype=dtype, device=device)
        self.weight_generator = HyperDense(p, input_dim * output_dim, **kw)
        self.bias_generator = HyperDense(p, input_dim, **kw)

    def forward(self, emb: torch.Tensor) -> SamplerWeights:
        w = self.weight_generator(emb)
        return SamplerWeights(w.reshape(self.input_dim, self.output_dim),
                              self.bias_generator(emb))


class AdapterLayersHyperNetController(nn.Module):
    """'unique_hyper_net' (vlpet_tpu/pet/hypernet.py:135): one hypernet per
    stack generating, per layer, the feed-forward and self-attention (and,
    with ``include_cross_attention``, cross-attention) adapters' weights
    from [task embedding; layer embedding]."""

    PARTS = ("feed_forward", "self_attention", "cross_attention")

    def __init__(self, spec: HyperformerSpec, d_model: int,
                 reduction_factor: int, num_layers: int = 6,
                 include_cross_attention: bool = False,
                 add_layer_norm_before_adapter: bool = False,
                 add_layer_norm_after_adapter: bool = False,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.spec = spec
        self.parts = self.PARTS[:3 if include_cross_attention else 2]
        self.pre, self.post = (add_layer_norm_before_adapter,
                               add_layer_norm_after_adapter)
        down = d_model // reduction_factor
        self.layer_id_embeddings = nn.Parameter(torch.empty(
            (num_layers, spec.task_embedding_dim),
            device=resolve_device(device)))
        self.task_hypernet = TaskHyperNet(spec, 2 * spec.task_embedding_dim,
                                          device=device)
        if spec.unique_hyper_net_layer_norm:
            self.LayerNorm = LayerNorm(spec.projected_task_embedding_dim,
                                       eps=1e-6, device=device)
        kw = dict(dtype=dtype, device=device)
        for part in self.parts:
            self.add_module(f"{part}_up_sampler_hyper_net",
                            AdapterWeightGenerator(spec, d_model, down, **kw))
            self.add_module(f"{part}_down_sampler_hyper_net",
                            AdapterWeightGenerator(spec, down, d_model, **kw))
            if self.pre:
                self.add_module(f"{part}_pre_layernorm_hypernet",
                                LayerNormHyperNet(spec, d_model, device=device))
            if self.post:
                self.add_module(f"{part}_post_layernorm_hypernet",
                                LayerNormHyperNet(spec, d_model, device=device))

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.layer_id_embeddings, 1.0, g)

    def _gen(self, part: str, emb: torch.Tensor) -> AdapterWeights:
        pre = post = None
        if self.pre:
            pre = getattr(self, f"{part}_pre_layernorm_hypernet")(emb)
        if self.post:
            post = getattr(self, f"{part}_post_layernorm_hypernet")(emb)
        return AdapterWeights(
            up=getattr(self, f"{part}_up_sampler_hyper_net")(emb),
            down=getattr(self, f"{part}_down_sampler_hyper_net")(emb),
            pre_norm=pre, post_norm=post)

    def forward(self, task_embedding: torch.Tensor,
                layer_id: int) -> BlockAdapterWeights:
        emb = torch.cat([task_embedding.reshape(-1),
                         self.layer_id_embeddings[layer_id].reshape(-1)])
        emb = self.task_hypernet(emb)
        if self.spec.unique_hyper_net_layer_norm:
            emb = self.LayerNorm(emb)
        return BlockAdapterWeights(*(self._gen(part, emb)
                                     for part in self.parts))


class AdapterLayersOneHyperNetController(nn.Module):
    """'efficient_unique_hyper_net' (vlpet_tpu/pet/hypernet.py:201): one
    generator for every block, told apart by a block-type embedding
    (``adapters_block_type``: 0 feed-forward, 1 self-attention, 2
    cross-attention)."""

    def __init__(self, spec: HyperformerSpec, d_model: int,
                 reduction_factor: int, num_layers: int = 6,
                 include_cross_attention: bool = False,
                 add_layer_norm_before_adapter: bool = False,
                 add_layer_norm_after_adapter: bool = False,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.spec = spec
        self.n_parts = 3 if include_cross_attention else 2
        down = d_model // reduction_factor
        dev = resolve_device(device)
        t = spec.task_embedding_dim
        self.layer_id_embeddings = nn.Parameter(torch.empty((num_layers, t),
                                                            device=dev))
        self.adapters_block_type = nn.Parameter(torch.empty((3, t),
                                                            device=dev))
        self.task_hypernet = TaskHyperNet(spec, 3 * t, device=device)
        if spec.unique_hyper_net_layer_norm:
            self.LayerNorm = LayerNorm(spec.projected_task_embedding_dim,
                                       eps=1e-6, device=device)
        kw = dict(dtype=dtype, device=device)
        self.up_sampler_hyper_net = AdapterWeightGenerator(spec, d_model, down,
                                                           **kw)
        self.down_sampler_hyper_net = AdapterWeightGenerator(spec, down,
                                                             d_model, **kw)
        self.pre = add_layer_norm_before_adapter
        self.post = add_layer_norm_after_adapter
        if self.pre:
            self.pre_layernorm_hypernet = LayerNormHyperNet(spec, d_model,
                                                            device=device)
        if self.post:
            self.post_layernorm_hypernet = LayerNormHyperNet(spec, d_model,
                                                             device=device)

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        normal_(self.layer_id_embeddings, 1.0, g)
        normal_(self.adapters_block_type, 1.0, g)

    def forward(self, task_embedding: torch.Tensor,
                layer_id: int) -> BlockAdapterWeights:
        def gen(block_type: int) -> AdapterWeights:
            emb = self.task_hypernet(torch.cat([
                task_embedding.reshape(-1),
                self.layer_id_embeddings[layer_id].reshape(-1),
                self.adapters_block_type[block_type].reshape(-1)]))
            if self.spec.unique_hyper_net_layer_norm:
                emb = self.LayerNorm(emb)
            return AdapterWeights(
                up=self.up_sampler_hyper_net(emb),
                down=self.down_sampler_hyper_net(emb),
                pre_norm=self.pre_layernorm_hypernet(emb) if self.pre else None,
                post_norm=(self.post_layernorm_hypernet(emb) if self.post
                           else None))

        return BlockAdapterWeights(*(gen(i) for i in range(self.n_parts)))


def stack_hypernet(cfg, num_layers: int, include_cross_attention: bool,
                   dtype=torch.float32, device: Device = "cuda") -> nn.Module:
    """The per-stack controller the JAX BART builds
    (vlpet_tpu/models/bart.py:899-916, :1119-1133): the one-hypernet form
    under ``efficient_unique_hyper_net``, else one hypernet per stack."""
    p = cfg.pet
    cls = (AdapterLayersOneHyperNetController if p.efficient_unique_hyper_net
           else AdapterLayersHyperNetController)
    return cls(p.hyperformer_spec(), cfg.d_model, p.reduction_factor,
               num_layers=num_layers,
               include_cross_attention=include_cross_attention,
               add_layer_norm_before_adapter=p.add_layer_norm_before_adapter,
               add_layer_norm_after_adapter=p.add_layer_norm_after_adapter,
               dtype=dtype, device=device)


class MetaLayersAdapterController(nn.Module):
    """Applies hypernet-generated adapter weights
    (vlpet_tpu/pet/hypernet.py:236): out = x + up(act(down(z))), z the
    input or its conditional LayerNorm, the output optionally
    conditionally normed before the residual. No parameters."""

    def __init__(self, non_linearity: str = "gelu_new",
                 add_layer_norm_before_adapter: bool = False,
                 add_layer_norm_after_adapter: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.act = get_activation(non_linearity)
        self.pre, self.post = (add_layer_norm_before_adapter,
                               add_layer_norm_after_adapter)
        self.dtype = dtype

    @staticmethod
    def _cond_layer_norm(x: torch.Tensor, w: LayerNormWeights) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * w.weight + w.bias

    def forward(self, x: torch.Tensor, weights: AdapterWeights) -> torch.Tensor:
        dt = self.dtype
        z = self._cond_layer_norm(x, weights.pre_norm) if self.pre else x
        down = z.to(dt) @ weights.down.weight.to(dt).t() + weights.down.bias
        out = (self.act(down) @ weights.up.weight.to(dt).t()
               + weights.up.bias)
        if self.post:
            out = self._cond_layer_norm(out, weights.post_norm)
        return out + x
