"""The ('data', 'model') layout of the processes and the tensor-parallel
placement of the backbone, ported from vlpet_tpu/parallel/mesh.py.

The JAX package builds a jax.sharding.Mesh and lets GSPMD place the
frozen backbone by ``_PARAM_RULES``. Here one process is one rank of a
torch.distributed group: rank r sits at data index r // M and model index
r % M (the row-major ``reshape(data, model)`` of the JAX mesh), with one
process group per model group (the M ranks of a data index) and one per
data group (the ranks of a model index). The batch shards over 'data'
(parallel/multihost.py ``data_shard``; the step's gradient all-reduce runs
over the data group); the backbone splits over 'model' in Megatron's
column / row form (parallel/tensor.py):

* q/k/v (BART's q_proj / k_proj / v_proj with their biases, T5's q / k /
  v) keep the rows of the rank's heads, out_proj / o the matching input
  columns (row-parallel: partial outputs summed, out_proj's bias added
  once after the sum);
* fc1 / wi / wi_0 / wi_1 (and fc1's bias) keep the rows of the rank's
  hidden columns, fc2 / wo the matching input columns (fc2's bias once
  after the sum; the FFN kernels hash the hidden's global columns).

Kept whole on every rank: ``shared`` (the embedding and the tied LM head)
and an untied ``lm_head`` -- whole by design, where the JAX rules split
d_model and GSPMD sums partial logits: the port's C1 / C2 and T1 stream
the whole vocabulary against whole hidden rows, and BART's 50265 rows
divide by neither 2 nor 4 -- the classifier's answer head (its fc1 / fc2
match the FFN rules; it reads the whole decoder state), T5's
``relative_attention_bias`` (sliced to the rank's heads where it is
used), every LayerNorm / RMSNorm, every PET module and the CLIP trunk of
the raw-image path (no name of it matches a rule, as in the JAX package).
LoRA's ``q_proj.base`` / ``v_proj.base`` split like the other
projections (a rule the JAX package lacks: GSPMD leaves them whole):
q/k/v keep one shape on every path, and ``lora_B``, whole, gives the rank
its head columns in the forward. The results are one device's, as in the
JAX package; only the placement differs.

Every configuration the port builds in one process runs split, by three
rules:

1. A hook whose output lands in a split tensor keeps its parameters whole
   and computes its whole output (a prefix's K/V, an adapter's delta, an
   IA3 vector) from replicated inputs; ``ModelShard.columns`` gives the
   rank its head or hidden columns behind ``copy_to_model``, so the
   hook's gradient comes back whole, the same on every rank.
2. A trainable tensor that is itself split (BitFit's q/k/v and fc1
   biases, the weights under ``unfreeze_language_model``) trains as its
   shard: its gradient, Adam moments and master copy are the rank's
   rows or columns; the clip norm sums the split tensors' squares over
   the model group in fp32 and counts the replicated ones once
   (train/optim.py); checkpoints gather them whole and restores cut them
   again (``gather_state_dict`` / ``shard_state_dict``).
3. Everything else -- adapters, gates, hypernets, prompts, the LM-head
   adapter, the answer head, LayerNorms, the CLIP trunk -- lives on the
   replicated stream: whole inputs, whole outputs, whole gradients, since
   every consumer downstream enters a shard through ``copy_to_model``.

A unit (an attention, an FFN) whose heads or hidden width the model axis
does not divide stays whole, as ``param_shardings`` falls back to
replication. ``check_tensor_parallel`` refuses what one process refuses
(``scan_layers``, ``vis_use_transformer``, T5's unread flags); the model
is built whole from its seed, loaded, then sharded (``shard_model``);
checkpoints and LAST.npz hold whole tensors (``gather_state_dict``) and
shard again after reading (``shard_state_dict``), so a run resumes under
another layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from vlpet_tpu_torch.parallel.tensor import ModelShard


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1 = all remaining processes
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh as this process sees it: the axes' sizes, its indices on
    them and its two groups (None: the default group, or a group of
    one)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shard(self) -> ModelShard:
        """This rank's place on the model axis."""
        return ModelShard(self.model, self.model_index, self.model_group)


_LAYOUT: Optional[Layout] = None  # the layout of build_mesh's last call
_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}  # by (world, model)


def build_mesh(cfg: MeshConfig = MeshConfig(), verbose: bool = True
               ) -> Layout:
    """The layout of this process group (one process: a 1 x 1 layout) and
    its groups, made once per shape; it becomes the current layout
    (``current_layout``). Every rank calls it together (``new_group`` is
    collective). A model axis that does not divide the process count
    falls back to 1, as the JAX Trainer's does; rank 0 prints one line
    then (``verbose``)."""
    global _LAYOUT
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    # the JAX Trainer's rule (vlpet_tpu/train/trainer.py:137)
    model = max(1, cfg.model)
    model = model if world % model == 0 else 1
    if model != max(1, cfg.model) and verbose and rank == 0:
        print(f"mesh_model_axis {cfg.model} does not divide {world} "
              f"process(es): the model axis is 1 (the backbone is not split)")
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    data_group = model_group = None
    if model > 1:
        if (world, model) not in _GROUPS:
            # every rank makes every group, in the same order
            models = [dist.new_group(list(range(d * model, (d + 1) * model)))
                      for d in range(data)]
            datas = [dist.new_group(list(range(m, world, model)))
                     for m in range(model)]
            _GROUPS[(world, model)] = (models, datas)
        models, datas = _GROUPS[(world, model)]
        model_group, data_group = models[rank // model], datas[rank % model]
    _LAYOUT = Layout(data, model, rank // model, rank % model, data_group,
                     model_group)
    return _LAYOUT


def current_layout() -> Layout:
    """The layout of the last ``build_mesh``; without one, the data axis
    over every process and a model axis of 1."""
    if _LAYOUT is not None:
        return _LAYOUT
    if dist.is_available() and dist.is_initialized():
        return Layout(data=dist.get_world_size(),
                      data_index=dist.get_rank())
    return Layout()


# --- the placement rules ----------------------------------------------------

# (param-name regex, the dim split, the unit it belongs to): torch weights
# are (out, in) where flax kernels are (in, out), so each dim flips
# (``.base``: LoRA's base projection, module docstring)
_PARAM_RULES: Tuple[Tuple[str, int, str], ...] = (
    (r"(self_attn|encoder_attn|cross_attn)\.(q_proj|k_proj|v_proj|q|k|v)"
     r"(\.base)?\.weight$", -2, "attn"),
    (r"(self_attn|encoder_attn|cross_attn)\.(q_proj|k_proj|v_proj)"
     r"(\.base)?\.bias$", -1, "attn"),
    (r"(self_attn|encoder_attn|cross_attn)\.(out_proj|o)\.weight$", -1,
     "attn"),
    (r"(^|\.)fc1\.weight$|\.wi(_0|_1)?\.weight$", -2, "ffn"),
    (r"(^|\.)fc1\.bias$", -1, "ffn"),
    (r"(^|\.)fc2\.weight$|\.wo\.weight$", -1, "ffn"),
)
# rule-matched in the JAX package, whole here by design (module docstring)
WHOLE_BY_DESIGN = (r"(^|\.)shared$", r"(^|\.)lm_head\.weight$")


def _units(model: torch.nn.Module) -> Dict[str, Tuple[str, int]]:
    """Every unit the rules split, by module name: (kind, whole count) --
    an attention's heads, an FFN's hidden width (its owner: a BART layer,
    a T5 block)."""
    from vlpet_tpu_torch.models.bart import BartAttention
    from vlpet_tpu_torch.models.t5 import T5Attention

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (BartAttention, T5Attention)):
            out[name] = ("attn", mod.whole_heads)
        elif hasattr(mod, "ffn_width"):
            out[name] = ("ffn", mod.ffn_width)
    return out


def _owner(name: str, units) -> Optional[str]:
    mod = name.replace(".base.", ".").rsplit(".", 2)[0]  # <unit>.<dense>.<leaf>
    return mod if mod in units else None


def param_plan(model: torch.nn.Module, model_axis: int
               ) -> List[Tuple[str, Optional[int], str]]:
    """Every rule-matched parameter of ``model`` (by its whole shapes) as
    (name, the dim split or None, why): "split" ("split, trains" where it
    is trainable; LoRA's base says so), "indivisible" (its unit's heads or
    hidden width do not divide by the model axis; it stays whole, as
    ``param_shardings`` falls back) or "whole by design" (``shared``, an
    untied ``lm_head``, a rule-matched name outside every attention and
    FFN: the answer head's)."""
    units = _units(model)
    rules = [(re.compile(p), d) for p, d, _ in _PARAM_RULES]
    whole = [re.compile(p) for p in WHOLE_BY_DESIGN]
    out = []
    for name, param in model.named_parameters():
        if any(p.search(name) for p in whole):
            out.append((name, None, "whole by design"))
            continue
        dim = next((d for p, d in rules if p.search(name)), None)
        if dim is None:
            continue
        unit = _owner(name, units)
        if unit is None:
            out.append((name, None, "whole by design"))
        elif units[unit][1] % model_axis:
            out.append((name, None, "indivisible"))
        else:
            why = "split"
            if ".base." in name:
                why += " (LoRA's base rows; lora_B's columns in the forward)"
            out.append((name, dim, why + (", trains" if param.requires_grad
                                          else "")))
    return out


def split_plan(model: torch.nn.Module, model_axis: int) -> Dict[str, int]:
    """The split parameters of ``param_plan``: {name: the dim split}."""
    return {n: d for n, d, why in param_plan(model, model_axis)
            if why.startswith("split")}


def split_names(model: torch.nn.Module) -> frozenset:
    """The names of a sharded model's split parameters (none unsharded)."""
    shard = getattr(model, "tp", None)
    return frozenset(split_plan(model, shard.size) if shard is not None
                     else ())


def sharding_report(model: torch.nn.Module, model_axis: int
                    ) -> List[Tuple[str, Optional[int], bool, str]]:
    """For every rule-matched parameter: (name, the dim split or None,
    whether it splits over a model axis of ``model_axis`` > 1, why) --
    the counterpart of the JAX ``sharding_report``: a rule-matched family
    that stays whole must say why."""
    return [(n, d, d is not None and model_axis > 1, why)
            for n, d, why in param_plan(model, model_axis)]


def check_tensor_parallel(cfg) -> None:
    """Raise NotImplementedError where one process would: a model axis > 1
    refuses nothing that the port builds (models/vlbart.py
    ``check_supported``, models/t5.py ``check_t5_supported``)."""
    from vlpet_tpu_torch.models.t5 import check_t5_supported
    from vlpet_tpu_torch.models.vlbart import check_supported

    (check_t5_supported if cfg.is_t5 else check_supported)(cfg)


# --- placing the model and its state dicts -------------------------------------

def _narrow(t: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    whole = t.shape[dim]
    return t.narrow(dim, shard.base(whole), shard.local(whole))


@torch.no_grad()
def shard_model(model: torch.nn.Module, layout: Layout) -> torch.nn.Module:
    """Place a whole model on this rank's shard of the model axis, in
    place: every "split" parameter of ``param_plan`` keeps its rows or
    columns (a fresh tensor each), every split unit takes the shard
    (``tp``) and its local sizes. ``model.tp`` is the shard. A model axis
    of 1 changes nothing. Raises NotImplementedError where one process
    would (``check_tensor_parallel``)."""
    if layout.model == 1:
        return model
    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is sharded already")
    check_tensor_parallel(model.cfg)
    shard = layout.shard
    plan = split_plan(model, layout.model)
    for name, p in model.named_parameters():
        if name in plan:
            p.data = _narrow(p.data, plan[name], shard).clone()
    units = _units(model)
    split = {_owner(n, units) for n in plan}
    for name, mod in model.named_modules():
        if name in split:
            mod.shard_(shard)
    model.tp = shard
    return model


def shard_state_dict(sd: Mapping[str, torch.Tensor], model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """A whole state dict (by ``model``'s names) cut to this rank's shards
    of ``model``'s placement; unchanged for an unsharded model."""
    shard = getattr(model, "tp", None)
    if shard is None:
        return dict(sd)
    plan = split_plan(model, shard.size)
    return {n: (_narrow(t, plan[n], shard) if n in plan
                and t.shape != model.get_parameter(n).shape else t)
            for n, t in sd.items()}


def gather_state_dict(named: Mapping[str, torch.Tensor],
                      model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's shards (by ``model``'s names) as whole tensors, on every
    rank of the model group: each shard in its place in zeros, summed over
    the group in fp32 (exact: one nonzero term an element), back in its
    dtype. Collective over the model group; unchanged for an unsharded
    model."""
    shard = getattr(model, "tp", None)
    if shard is None:
        return dict(named)
    plan = split_plan(model, shard.size)
    out = {}
    for n, t in named.items():
        if n not in plan:
            out[n] = t
            continue
        dim = plan[n] % t.dim()
        shape = list(t.shape)
        shape[dim] *= shard.size
        buf = torch.zeros(shape, dtype=torch.float32, device=t.device)
        buf.narrow(dim, shard.index * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(buf, group=shard.group)
        out[n] = buf.to(t.dtype)
    return out
