"""Tensor parallelism's boundaries: Megatron's column and row splits over
the 'model' axis of the mesh (parallel/mesh.py), around the hand kernels.

A rank of a model group holds whole heads of every split attention and
whole columns of every split FFN hidden, so the kernels take whole local
tensors (A1, A6 and the long backward at H/M heads, F1-F4 at F/M hidden
columns). Two autograd Functions mark where a tensor crosses the split:

* ``copy_to_model``: where a replicated tensor enters a shard (the input
  of a column-parallel projection, and every whole tensor whose columns a
  rank takes: the value hooks' outputs, the residual states): the
  identity forward, the gradient summed over the model group backward, so
  every tensor on the replicated stream gets its whole gradient on every
  rank;
* ``reduce_from_model``: where a shard's partial sums leave it (the
  outputs of the row-parallel out_proj / o and fc2 / wo): summed over the
  model group forward, the identity backward.

The sums run in fp32 whatever the tensors' dtype: a bf16 partial rounds
once on its rank, the sum once back to bf16, and no backend is asked to
reduce bf16. Only ``all_reduce`` is used, never a gather of device
tensors: the one-card lane runs its model groups over gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the model axis: ``size`` ranks in its model
    group ``group``, this one at ``index``."""

    size: int = 1
    index: int = 0
    group: Any = None

    def local(self, whole: int) -> int:
        """This rank's part of ``whole`` (heads, hidden columns)."""
        return whole // self.size

    def base(self, whole: int) -> int:
        """The first of this rank's ``local(whole)`` in the whole."""
        return self.index * self.local(whole)

    def columns(self, x: torch.Tensor, whole: int,
                unit: int = 1) -> torch.Tensor:
        """This rank's columns of a replicated ``x`` whose last dim holds
        ``whole`` units of ``unit`` elements (heads of Dh), behind
        ``copy_to_model``: its gradient comes back whole."""
        return copy_to_model(x, self).narrow(
            -1, self.base(whole) * unit, self.local(whole) * unit)


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a fresh fp32 tensor."""
    buf = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_fp32(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group."""
    return _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of the model group's ``x``, in fp32; the gradient passes
    through."""
    return _ReduceFromModel.apply(x, shard.group)


def end_of_shard(y: torch.Tensor, bias: Optional[torch.Tensor],
                 shard: ModelShard) -> torch.Tensor:
    """A shard's partial output ``y`` (an FFN's, whose kernel added a
    zero b2, or a row-parallel product's) summed over the model group,
    plus ``bias`` once, in fp32, rounded to y's dtype once."""
    out = reduce_from_model(y, shard)
    if bias is not None:
        out = out + bias.float()
    return out.to(y.dtype)


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], shard: ModelShard
                 ) -> torch.Tensor:
    """A row-parallel linear layer: this rank's input columns ``x`` (..,
    in/M) through its ``weight`` (out, in/M) columns, then
    ``end_of_shard``."""
    return end_of_shard(torch.nn.functional.linear(x.to(weight.dtype),
                                                   weight), bias, shard)
