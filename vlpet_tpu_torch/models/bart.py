"""BART encoder/decoder with the VL-PET hooks, ported from
vlpet_tpu/models/bart.py.

Ported: the joint encoder (text + visual concat, the encoder prompt before
the text) with the multihead adapter (down, up, down-up or pair) and the
VL-PET granularity gate (small, middleX, middleY, large, the full d x d
GateLargeX, the LayerNorm or L2 norm; the standalone gate) after each
sublayer; the teacher-forcing decoder of training (causal self-attention,
cross-attention over the encoder states with the value and key hooks on
its K/V: the VPA and its ablations; the decoder's down-dim and multihead
adapters; the FFN's IA3); the incremental decoder (greedy and
reorder-free beam); the PET
baselines' hooks: serial adapters (bottleneck, Compacter, low-rank) after
each sublayer of both stacks, LoRA on every q and v projection, the
hyperformer's generated adapters; prefix tuning (the encoder's and the
decoder's per-layer K/V prefixes), the visual prefix and the decoder input
prompt; and the training-time dropout: the
embedding dropout, the residual dropout before each post-LN, LoRA's input
dropout, the attention probabilities' (``attention_dropout``, inside A1 /
A6 / the long backward) and the FFN hidden's (``activation_dropout``,
inside F1 / F2), all from the hash mask of ops/hashdrop.py with one seed
per site (``DropoutSeeds``; a layer's sites: ``layer_sites``). Each layer
of a training pass runs under ``cfg.remat`` (``run_layer``: "full"
recomputes the layer in the backward, "dots" all but its matrix
products).
Layers are registered as ``layers_{i}`` like the flax tree. Branches of the
hook surface that the port does not cover raise NotImplementedError when
the model is built (models/vlbart.py check_supported).

Kernel call sites: every attention but the beam self-attention goes through
ops.attention.fused_attention (A1 forward; A6 or, at the video path's long
sequences, the long backward, as ops.attention.backward_route picks), every
FFN through ops.ffn.fused_ffn (F1, F2) unless the language model trains,
``use_fused_ffn`` is off or the layer has the decoder FFN's IA3, every
dropping residual LayerNorm through
ops.fused_ln.fused_dropout_add_ln (L1, L2), beam self-attention through
ops.decode.beam_decode_attend (D1) or, with ``use_fused_beam``,
ops.decode.beam_decode_attend_update (D2, which also writes the cache
slot), every other decode-step KV write through
ops.cache_update.cache_slots_update (U1, K and V in one launch), each
picked by ops.route (the plain twins inside ``ops.plain_twins()``).

Tensor parallelism (parallel/mesh.py ``shard_model``): a sharded
attention holds its rank's heads (``shard_``: q/k/v rows, out_proj's input
columns; A1 / A6 / the long backward at H/M heads with the dropout seed
moved by ``fold_heads``), a sharded layer its rank's FFN hidden columns
(F1 / F2 at F/M columns with the hidden's column base and whole width, a
zero b2); the replicated stream enters a shard through
``copy_to_model`` and leaves it through ``reduce_from_model`` with the
bias added once (parallel/tensor.py). A hook whose whole output lands in
a split tensor gives the rank its head or hidden columns behind
``copy_to_model`` (rule 1 of parallel/mesh.py): LoRA's ``lora_B``
columns, the prefixes' K/V, the cross hooks' outputs, the decoder FFN's
IA3 vector (whose layer takes the plain chain at the hidden's column
base).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vlpet_tpu_torch.config import PromptSpec, VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm, layer_norm
from vlpet_tpu_torch.models.visual import (downsample_vis,
                                           joint_attention_mask,
                                           sparse_sample, sparse_scores,
                                           visual_embedding_class)
from vlpet_tpu_torch.ops import route
from vlpet_tpu_torch.ops.attention import (fused_attention,
                                           fused_attention_reference)
from vlpet_tpu_torch.ops.cache_update import (cache_slots_update,
                                              cache_slots_update_reference)
from vlpet_tpu_torch.ops.decode import (beam_cross_attend, beam_decode_attend,
                                        beam_decode_attend_reference,
                                        beam_decode_attend_update,
                                        beam_decode_attend_update_reference,
                                        decode_attend)
from vlpet_tpu_torch.ops.ffn import ffn_reference, fused_ffn
from vlpet_tpu_torch.ops.fused_ln import (fused_dropout_add_ln,
                                          fused_dropout_add_ln_reference)
from vlpet_tpu_torch.ops.hashdrop import (DropoutSeeds, fold_heads,
                                          hash_dropout)
from vlpet_tpu_torch.parallel.tensor import (ModelShard, copy_to_model,
                                             end_of_shard, row_parallel)
from vlpet_tpu_torch.pet.hypernet import (MetaLayersAdapterController,
                                          stack_hypernet)
from vlpet_tpu_torch.pet.modules import (MULTIHEAD_ADAPTERS,
                                         AdapterController, GateLargeX,
                                         GateLargeXLowRank, GateMiddleXYAdd,
                                         GateSmallXYCat, IA3Vector, LoRADense,
                                         MultiheadDownAdapter,
                                         MultiheadPairAdapter, PetContext,
                                         TaskDense, build_gate,
                                         get_activation, shared_phm_W_dims)
from vlpet_tpu_torch.pet.prefix import (AttnPrefixController,
                                        ResidualVisualPrefix)
from vlpet_tpu_torch.pet.prompts import PromptController

NEG_INF = -1e9  # additive-mask constant of the JAX package

Cache = Dict[str, torch.Tensor]


def compute_dtype(cfg: VLModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def expand_mask(mask: torch.Tensor, tgt_len: int,
                dtype: torch.dtype) -> torch.Tensor:
    """[B, S] -> additive [B, 1, T, S]."""
    B, S = mask.shape
    m = mask[:, None, None, :].expand(B, 1, tgt_len, S).to(dtype)
    return (1.0 - m) * NEG_INF


def write_slot(cache: Cache, k: torch.Tensor, v: torch.Tensor,
               pos: int) -> None:
    """This step's K and V (B rows of H*Dh) into slot ``pos`` of the
    time-major (L, B, H*Dh) caches, in place, through one U1 launch for
    both (or its plain twin): each cache is U1's N = 1 case, viewed as
    (1, L, B, H*Dh)."""
    kc, vc = cache["k"], cache["v"]
    view, slot = (1,) + kc.shape, (1,) + kc.shape[1:]
    route(cache_slots_update, cache_slots_update_reference)(
        (kc.view(view), vc.view(view)), (k.reshape(slot), v.reshape(slot)),
        pos)


def _seed(seeds: Optional[DropoutSeeds],
          per_example: int) -> Optional[torch.Tensor]:
    """The next dropout site's seed, folded to this process's examples
    (``per_example``: the elements an example owns in the site's mask,
    ``DropoutSeeds.next_for``), or None when not dropping."""
    return seeds.next_for(per_example) if seeds is not None else None


def _per_example(x: torch.Tensor) -> int:
    """The elements an example owns in a batch-major x (B, ...)."""
    return x.shape[1:].numel()


def _rate_seed(seeds: Optional[DropoutSeeds], rate: float,
               per_example: int):
    """(rate, seed) of a site that exists only where its rate is above 0
    (BART's attention and activation dropout): (0.0, None) off training
    or at rate 0, else the rate and the next seed (folded as ``_seed``)."""
    if seeds is None or rate <= 0.0:
        return 0.0, None
    return rate, seeds.next_for(per_example)


def layer_sites(cfg: VLModelConfig, n_attention: int) -> int:
    """Dropout seeds one layer with ``n_attention`` attention sublayers
    takes in a training step: per attention sublayer LoRA's q and v input
    dropout (where LoRA drops), the probabilities' (where
    ``attention_dropout`` > 0) and the residual's; the FFN's hidden
    (where ``activation_dropout`` > 0) and residual."""
    b, p = cfg.backbone, cfg.pet
    lora = 2 if p.use_lora and p.lora_spec().lora_dropout > 0.0 else 0
    probs = 1 if b.attention_dropout > 0.0 else 0
    hidden = 1 if b.activation_dropout > 0.0 else 0
    return n_attention * (1 + lora + probs) + 1 + hidden


def _dots_saveable():
    """Selective checkpointing's contexts for ``remat="dots"``: the outputs
    of the matrix products are saved, everything else -- the hand kernels,
    which are no aten op, included -- is recomputed in the backward, as
    jax.checkpoint_policies.dots_saveable does with a pallas_call."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def run_layer(remat: str, fn, h: torch.Tensor,
              seeds: Optional[DropoutSeeds], n_sites: int) -> torch.Tensor:
    """fn(h, layer_seeds) for one layer of a training pass, under the
    per-layer rematerialisation ``remat`` (vlpet_tpu/models/bart.py:73):
    "none" keeps every activation; "full" saves the layer's input and
    recomputes the layer in the backward; "dots" saves the matrix
    products' outputs and recomputes the rest. The layer's ``n_sites``
    seeds are drawn here, before the checkpoint, and handed in as a
    tensor: the recomputation takes the same masks. Without autograd the
    layer runs as it is."""
    seed_t = seeds.take(n_sites) if seeds is not None else None

    def body(h: torch.Tensor, seed_t: Optional[torch.Tensor]):
        own = (DropoutSeeds.of(seed_t, seeds.example_base)
               if seed_t is not None else None)
        out = fn(h, own)
        if own is not None and own.used != n_sites:
            raise RuntimeError(f"a layer took {own.used} dropout seeds, "
                               f"{n_sites} drawn for it")
        return out

    if remat == "none" or not torch.is_grad_enabled():
        return body(h, seed_t)
    if remat == "full":
        return checkpoint(body, h, seed_t, use_reentrant=False)
    if remat == "dots":
        return checkpoint(body, h, seed_t, use_reentrant=False,
                          context_fn=_dots_saveable)
    raise ValueError(f"unknown remat policy: {remat!r}")


def _embedding_dropout(h: torch.Tensor, seeds: Optional[DropoutSeeds],
                       rate: float) -> torch.Tensor:
    """A stack's embedding dropout; its site takes a seed whenever the
    step draws seeds (a LoRA model draws them at BART dropout 0 too)."""
    seed = _seed(seeds, _per_example(h))
    return hash_dropout(h, seed, rate) if seed is not None and rate else h


class ResidualDropoutLayerNorm(nn.Module):
    """LayerNorm(residual + dropout(h)), the post-LN sublayer epilogue, with
    fp32 fast-variance statistics as in the JAX module; params
    ``scale``/``bias`` (fp32). Without a seed (eval, or rate 0) the plain
    form runs, as the JAX module does off the TPU; with one, the fused
    dropout + add + LayerNorm (L1/L2 on CUDA, its plain twin otherwise)."""

    def __init__(self, dim: int, dtype: torch.dtype, rate: float = 0.0,
                 device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.rate = dtype, rate
        self.scale = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, h: torch.Tensor, residual: torch.Tensor,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        if seed is None or self.rate == 0.0:
            return layer_norm(residual + h, self.scale, self.bias, self.dtype)
        fn = route(fused_dropout_add_ln, fused_dropout_add_ln_reference)
        return fn(h, residual, self.scale, self.bias, seed, self.rate)


def shard_ffn(layer: nn.Module, shard: ModelShard, ups: Tuple[str, ...],
              down: str, buffers: Tuple[str, ...] = ()) -> None:
    """Mark an FFN's owner as holding its rank's hidden columns: the up
    projections ``ups`` keep their rows, ``down`` its input columns
    (parallel/mesh.py shard_model has cut the weights), the hidden-wide
    ``buffers`` their columns."""
    local = shard.local(layer.ffn_width)
    layer.tp = shard
    for name in ups:
        getattr(layer, name).out_dim = local
    getattr(layer, down).in_dim = local
    for name in buffers:
        setattr(layer, name, getattr(layer, name).narrow(
            -1, shard.base(layer.ffn_width), local).clone())


def _ffn(layer: nn.Module, x: torch.Tensor, act: str,
         seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
    """fc1 -> act -> (dropout) -> fc2 of a layer: through F1/F2 (or their
    plain twin), or the plain chain when ``use_fused_ffn`` is off or the
    language model trains (the kernels have no weight gradient), as in the
    JAX package. In training (``seeds``) at ``activation_dropout`` > 0 the
    hidden is dropped with the hash mask of the site's seed: inside F1 /
    F2 (their hidden-dropout mode; the plain chain, ``ffn_reference``, the
    same mask). A decoder layer with the FFN's IA3 vector
    (``decoder_ff_ia3_mod``) scales the hidden between act and fc2, h * g
    (h + h * g under ``use_decoder_ff_ia3_add``), then drops it
    (``hash_dropout``): the plain chain always, as the JAX package leaves
    fused_ffn there (vlpet_tpu/models/bart.py:842-859). A sharded layer
    (``layer.tp``) runs its hidden columns: the kernels' mask at its
    column base of the whole width, a zero b2, fc2's bias once after the
    ranks' sum."""
    c, tp = layer.cfg, layer.tp
    rate, seed = _rate_seed(seeds, c.backbone.activation_dropout,
                            _per_example(x) // x.shape[-1]
                            * layer.ffn_width)
    ia3 = layer._modules.get("decoder_ff_ia3_mod")
    if ia3 is not None:
        g, cols = ia3(), {}
        if tp is not None:
            # rule 1 (parallel/mesh.py): the whole vector, the rank's hidden
            # columns of it; the mask at the columns' base of the whole width
            x, g = copy_to_model(x, tp), tp.columns(g, layer.ffn_width)
            cols = dict(col_base=tp.base(layer.ffn_width),
                        width=layer.ffn_width)
        h = get_activation(act)(layer.fc1(x))
        g = g.to(h.dtype)
        h = h + h * g if c.pet.use_decoder_ff_ia3_add else h * g
        if seed is not None:
            h = hash_dropout(h, seed, rate, **cols)
        if tp is None:
            return layer.fc2(h)
        return row_parallel(h, layer.fc2.weight, layer.fc2.bias, tp)
    fn = (route(fused_ffn, ffn_reference)
          if c.use_fused_ffn and not c.pet.unfreeze_language_model
          else ffn_reference)
    b2, cols = layer.fc2.bias, {}
    if tp is not None:
        x, b2 = copy_to_model(x, tp), torch.zeros_like(b2)
        cols = dict(col_base=tp.base(layer.ffn_width), width=layer.ffn_width)
    y = fn(x.reshape(-1, x.shape[-1]), layer.fc1.weight, layer.fc1.bias,
           layer.fc2.weight, b2, act, rate, seed, **cols)
    if tp is not None:
        y = end_of_shard(y, layer.fc2.bias, tp)
    return y.reshape(x.shape)


class BartAttention(nn.Module):
    """Multi-head attention in one of three roles: 'enc_self' (full
    sequence), 'dec_self' (causal over the target sequence in training,
    incremental over the KV cache in decoding) and 'cross' (over the
    encoder states, or over precomputed cross K/V in decoding).
    ``num_heads`` is the heads this rank holds: all of them
    (``whole_heads``) unless ``shard_`` gave it a model-axis shard
    (``tp``)."""

    tp: Optional[ModelShard] = None

    def __init__(self, cfg: VLModelConfig, embed_dim: int, num_heads: int,
                 role: str, device: Device = "cuda"):
        super().__init__()
        p = cfg.pet
        self.cfg, self.role = cfg, role
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.whole_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = self.head_dim ** -0.5
        dt = compute_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        # LoRA: q_proj and v_proj are LoRADense on all three roles
        # (vlpet_tpu/models/bart.py:177-183), routed by task
        self.lora = p.use_lora
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, LoRADense(embed_dim, embed_dim,
                                            p.lora_spec(), **kw)
                            if self.lora and name != "k_proj"
                            else TaskDense(embed_dim, embed_dim, **kw))
        self.out_proj = TaskDense(embed_dim, embed_dim, **kw)
        self._hooks(p, embed_dim, kw)

    def _hooks(self, p, d: int, kw) -> None:
        """The value and key hooks (vlpet_tpu/models/bart.py:195-257), in
        the JAX elif order, under the JAX names. On the cross role: one
        value hook (the VPA ``attn_value_parallel_adapter``, the sequential
        ``enc_attn_value_sequential_adapter``, the IA3 ``value_ia3``, or a
        multihead or pair VPA ``attn_value_parallel_adapter_multihead``),
        the key parallel adapter ``attn_key_parallel_adapter`` and, under
        the residual connection, the value gate. The self roles' value
        flags (``use_encoder_attn_value_ia3``,
        ``use_decoder_self_attn_value_ia3``,
        ``use_encoder_attn_value_parallel_adapter_down_dim``,
        ``use_decoder_self_attn_value_parallel_adapter_down_dim``) build
        nothing: the JAX package defines their modules in ``setup`` and
        never calls them (value hooks fire only on the cross path), so
        flax creates no parameters for them."""
        ac = dict(phm_W_dims=shared_phm_W_dims(p, d), **kw)
        multihead_vpa = self._multihead_vpa(p)
        if self.role == "cross":
            if p.use_decoder_enc_attn_value_parallel_adapter_down_dim:
                scaling = (
                    p.decoder_enc_attn_value_parallel_adapter_scaling_factor
                    if p.use_decoder_enc_attn_value_parallel_adapter_scaling
                    else None)
                spec = p.down_dim_spec(
                    d, p.decoder_enc_attn_value_parallel_adapter_down_dim,
                    parallel=True, scaling=scaling)
                self.attn_value_parallel_adapter = AdapterController(spec,
                                                                     **ac)
            elif p.use_decoder_enc_attn_value_sequential_adapter_down_dim:
                self.enc_attn_value_sequential_adapter = AdapterController(
                    p.down_dim_spec(
                        d, p.decoder_enc_attn_value_sequential_adapter_down_dim),
                    **ac)
            elif p.use_decoder_enc_attn_value_ia3:
                self.value_ia3 = IA3Vector(d, "attn_value_ia3",
                                           device=kw["device"])
            elif multihead_vpa is not None:
                self.attn_value_parallel_adapter_multihead = multihead_vpa(
                    d, p.decoder_enc_attn_value_parallel_adapter_down_dim,
                    p.decoder_enc_attn_value_parallel_adapter_multihead_num_head,
                    **kw)
            if p.use_decoder_enc_attn_key_parallel_adapter_down_dim:
                self.attn_key_parallel_adapter = AdapterController(
                    p.down_dim_spec(
                        d, p.decoder_enc_attn_key_parallel_adapter_down_dim,
                        parallel=True), **ac)
            # the residual's gate: the sequential adapter's, else the VPA's
            for kind in ("sequential", "parallel"):
                flag = (f"decoder_enc_attn_value_{kind}_adapter_gating_"
                        f"large_x_lowrank")
                if (p.use_decoder_enc_attn_value_residual_connection
                        and getattr(p, "use_" + flag)):
                    self.add_module(
                        f"enc_attn_value_{kind}_adapter_gating_large_x",
                        GateLargeXLowRank(d, getattr(p, flag + "_down_dim"),
                                          **kw))
                    break

    def shard_(self, shard: ModelShard) -> None:
        """Hold this rank's heads of the model axis (parallel/mesh.py
        shard_model has cut q/k/v's rows and out_proj's columns)."""
        self.tp = shard
        self.num_heads = shard.local(self.whole_heads)
        inner = self.num_heads * self.head_dim
        for name in ("q_proj", "k_proj", "v_proj"):
            dense = getattr(self, name)
            if isinstance(dense, LoRADense):
                dense.shard_(shard, self.whole_heads, self.head_dim)
                dense = dense.base
            dense.out_dim = inner
        self.out_proj.in_dim = inner

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input on its way into this rank's heads."""
        return x if self.tp is None else copy_to_model(x, self.tp)

    def _cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's head columns of a whole (B, S, H*Dh) tensor, behind
        ``copy_to_model``."""
        return self.tp.columns(x, self.whole_heads, self.head_dim)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """out_proj: row-parallel on a sharded attention."""
        if self.tp is None:
            return self.out_proj(out)
        return row_parallel(out, self.out_proj.weight, self.out_proj.bias,
                            self.tp)

    def _probs_seed(self, seeds: Optional[DropoutSeeds], per_example: int):
        """(rate, seed) of the probabilities' dropout site; a sharded
        attention's seed moved to its first head (``fold_heads``)."""
        rate, seed = _rate_seed(seeds, self.cfg.backbone.attention_dropout,
                                per_example)
        if seed is not None and self.tp is not None:
            seed = fold_heads(seed, self.tp.base(self.whole_heads))
        return rate, seed

    @staticmethod
    def _multihead_vpa(p):
        """The multihead VPA's class (down, or pair), or None."""
        v = "use_decoder_enc_attn_value_parallel_adapter_down"
        if getattr(p, v + "_multihead"):
            return MultiheadDownAdapter
        if getattr(p, v + "_up_pair_multihead"):
            return MultiheadPairAdapter
        return None

    def fused_qkv(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The q/k/v projections as one (3d, d) weight and (3d,) bias; None
        under LoRA, whose q and v take the unfused path as in JAX
        (``fuse_qkv``, vlpet_tpu/models/bart.py:416)."""
        if self.lora:
            return None
        return (torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight], dim=0),
                torch.cat([self.q_proj.bias, self.k_proj.bias,
                           self.v_proj.bias]))

    def _proj(self, mod: nn.Module, h: torch.Tensor, ctx: PetContext,
              seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """A q/v projection; a LoRADense is routed by task and, in
        training, takes the next dropout seed (one site a call)."""
        if isinstance(mod, LoRADense):
            seed = _seed(seeds, _per_example(h)) if mod.rate > 0.0 else None
            return mod(h, ctx.task_idx, seed)
        return mod(h)

    def _qkv(self, h: torch.Tensor, ctx: PetContext, qkv=None,
             seeds: Optional[DropoutSeeds] = None):
        """q (scaled after its bias), k, v. Without LoRA in one (d, 3d)
        GEMM (``qkv`` is ``fused_qkv()`` when the caller built it once for
        many steps); with LoRA three projections, q's then v's dropout
        seed drawn in that order."""
        if self.lora:
            q = self._proj(self.q_proj, h, ctx, seeds) * self.scaling
            k = self.k_proj(h)
            return q, k, self._proj(self.v_proj, h, ctx, seeds)
        W, b = qkv if qkv is not None else self.fused_qkv()
        q, k, v = F.linear(h.to(W.dtype), W, b).split(
            self.num_heads * self.head_dim, dim=-1)
        return q * self.scaling, k.contiguous(), v.contiguous()

    def compute_cross_kv(self, kv_states: torch.Tensor, ctx: PetContext,
                         seeds: Optional[DropoutSeeds] = None):
        """Cross K/V (B, S, H*Dh) with LoRA's v and the hooks
        (vlpet_tpu/models/bart.py:303-330): the key parallel adapter on k;
        on v the VPA (on the raw states, added to v), the sequential
        adapter (replacing v), IA3 (v * g, or v + v * g), or the multihead
        / pair VPA (v + A(states)); then, under the residual connection, v
        times its gate where there is one, plus the states in v's dtype.
        Computed once per sequence: the training pass and the decode
        precompute both come here. On a sharded attention K/V hold the
        rank's heads, and every whole term of a hook (an adapter's output,
        IA3's vector, the gate, the residual states) gives k or v its head
        columns behind ``copy_to_model``, so the hook's gradient comes back
        whole."""
        p, mods, tp = self.cfg.pet, self._modules, self.tp
        # a split attention takes each hook's whole output, then its head
        # columns (rule 1 of parallel/mesh.py): a parallel adapter's alone
        # (plus a zero: the same sum as the adapter's own y + out), the
        # sequential adapter's, IA3's vector, the multihead / pair VPA's
        # delta
        cols = (lambda t: t) if tp is None else self._cols
        kv_in = self._enter(kv_states)
        k = self.k_proj(kv_in)
        if "attn_key_parallel_adapter" in mods:
            k = k + cols(self.attn_key_parallel_adapter(kv_states, ctx,
                                                        y=k.new_zeros(())))
        v = self._proj(self.v_proj, kv_in, ctx, seeds)
        if "attn_value_parallel_adapter" in mods:
            v = v + cols(self.attn_value_parallel_adapter(kv_states, ctx,
                                                          y=v.new_zeros(())))
        elif "enc_attn_value_sequential_adapter" in mods:
            v = cols(self.enc_attn_value_sequential_adapter(kv_states, ctx))
        elif "value_ia3" in mods:
            # the JAX product promotes a bf16 v to fp32; the port keeps v's
            # dtype, the attention's (the same values in fp32)
            g = cols(self.value_ia3()).to(v.dtype)
            v = v + v * g if p.use_decoder_enc_attn_value_ia3_add else v * g
        elif "attn_value_parallel_adapter_multihead" in mods:
            v = v + cols(self.attn_value_parallel_adapter_multihead(kv_states))
        if p.use_decoder_enc_attn_value_residual_connection:
            gate = (mods.get("enc_attn_value_sequential_adapter_gating_large_x")
                    or mods.get("enc_attn_value_parallel_adapter_gating_large_x"))
            if gate is not None:
                v = v * cols(gate(kv_states))
            v = cols(kv_states).to(v.dtype) + v
        return k, v

    def forward(self, hidden_states: torch.Tensor, ctx: PetContext,
                attention_mask: Optional[torch.Tensor] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache: Optional[Cache] = None, decode_pos: Optional[int] = None,
                beam_anc: Optional[torch.Tensor] = None, qkv=None,
                kv_states: Optional[torch.Tensor] = None,
                seeds: Optional[DropoutSeeds] = None,
                prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Returns (attn_output, cache). The decode cache is updated IN PLACE
        at slot ``decode_pos`` (the JAX package returns a new buffer; here
        the preallocated one is reused): by U1 before the attend, or by D2
        inside it on the ``use_fused_beam`` beam path
        (vlpet_tpu/models/bart.py:442-455). Training: 'dec_self' without a
        cache is causal over the target sequence; 'cross' without
        ``cross_kv`` projects ``kv_states`` (the encoder output). ``seeds``
        (training) feed LoRA's dropout. ``prefix_kv`` (B, P, H*Dh) each,
        on a self role over a whole sequence: prefix-tuning K/V before the
        own (vlpet_tpu/models/bart.py:483-485; a sharded attention takes
        their head columns); the encoder's mask then has
        the P columns already, and the causal triangle's offset S - L opens
        them to every query of the decoder. In training at
        ``attention_dropout`` > 0 the probabilities are dropped with the
        hash mask of the site's seed, drawn after the projections' (A1 and
        A6 or the long backward in their dropout mode; JAX:
        vlpet_tpu/models/bart.py:355-377)."""
        B, L, _ = hidden_states.shape
        H, Dh = self.num_heads, self.head_dim
        attend = route(fused_attention, fused_attention_reference)
        x = self._enter(hidden_states)
        if self.role == "cross":
            q = self._proj(self.q_proj, x, ctx, seeds) * self.scaling
            if cross_kv is None:
                cross_kv = self.compute_cross_kv(kv_states, ctx, seeds)
            k, v = cross_kv
            if k.shape[0] != B:  # beam-shared encoder K/V
                out = beam_cross_attend(q.reshape(B * L, 1, H, Dh), k, v,
                                        attention_mask, attend)
                return self._out(out.reshape(B, L, -1)), cache
            m = attention_mask.float()
            rate, seed = self._probs_seed(seeds, L * k.shape[1])
            return self._out(attend(q, k, v, m, H, False, None, rate,
                                    seed)), cache
        q, k, v = self._qkv(x, ctx, qkv, seeds)
        if prefix_kv is not None:
            pk, pv = prefix_kv
            if self.tp is not None:  # rule 1: the whole prefix's heads
                pk, pv = self._cols(pk), self._cols(pv)
            k = torch.cat([pk.to(k.dtype), k], dim=1)
            v = torch.cat([pv.to(v.dtype), v], dim=1)
        if self.role == "enc_self":
            m = attention_mask.float()
            rate, seed = self._probs_seed(seeds, L * k.shape[1])
            return self._out(attend(q, k, v, m, H, False, None, rate,
                                    seed)), cache
        if cache is None:
            # teacher forcing: the triangle in-kernel, a zero padding mask
            m = torch.zeros((1, 1, 1, k.shape[1]), dtype=torch.float32,
                            device=q.device)
            rate, seed = self._probs_seed(seeds, L * k.shape[1])
            return self._out(attend(q, k, v, m, H, True, None, rate,
                                    seed)), cache
        q4 = q.reshape(B, 1, H, Dh)
        if beam_anc is not None and self.cfg.use_fused_beam:
            # D2: attend over the slots before decode_pos plus the own new
            # K/V, and write the slot, in one launch
            fn = route(beam_decode_attend_update,
                       beam_decode_attend_update_reference)
            out = fn(q4, cache["k"], cache["v"], k, v, beam_anc, decode_pos)
            return self._out(out), cache
        write_slot(cache, k, v, decode_pos)
        if beam_anc is not None:
            fn = route(beam_decode_attend, beam_decode_attend_reference)
            out = fn(q4, cache["k"], cache["v"], beam_anc, decode_pos)
        else:
            out = decode_attend(q4, cache["k"], cache["v"], attention_mask)
        return self._out(out), cache


class BartEncoderLayer(nn.Module):
    """Post-LN encoder layer with the hook chain after each sublayer
    (vlpet_tpu/models/bart.py:543-610), in JAX's order: the serial adapter
    (an AdapterController ``attn_adapter`` / ``ff_adapter`` of the
    bottleneck, Compacter or low-rank kind, with the optional per-sublayer
    scaling) or h + A(h), A the multihead adapter of the recipe's shape
    (``MULTIHEAD_ADAPTERS``: down, up, down-up or pair); then the first of
    ``GATES`` whose flag is set -- h * G with G from GateLargeX(x1),
    GateLargeXLowRank(x1), GateSmallXYCat(x1, h) or GateMiddleXYAdd(x1, h)
    (x1 the sublayer input; h + G under ``use_encoder_adapter_gating_add``),
    middle-Y's h + h * v (h + 1 + v under the add flag), or h normalised
    by a LayerNorm or by its L2 norm; then the standalone gate
    (``use_encoder_gating_large_x_lowrank``: G, dy = GateLargeXLowRank(x1)
    with its pre-sigmoid dy, dy + h * G, or (dy + h) * G under
    ``_add_x2_deltay``); then the hyperformer adapter (``adapter_hypernet``)
    with the layer's generated weights (``ctx.block_adapters``); then the
    optional gating scale. Under ``no_encoder_attn_adapter`` neither the
    serial adapter, nor a gate other than the two norms, nor the standalone
    gate sits on the attention sublayer."""

    # (flag, module suffix, class, whether no_encoder_attn_adapter keeps it
    # off the attention sublayer) in the JAX elif order
    # (vlpet_tpu/models/bart.py:566-588); L2 has no module
    GATES = (
        ("use_encoder_adapter_gating_large_x", "adapter_gating_large_x",
         GateLargeX, True),
        ("use_encoder_adapter_gating_large_x_lowrank",
         "adapter_gating_large_x_lowrank", GateLargeXLowRank, True),
        ("use_encoder_adapter_gating_small_xy_cat",
         "adapter_gating_small_xy_cat", GateSmallXYCat, True),
        ("use_encoder_adapter_gating_middle_xy_add",
         "adapter_gating_middle_xy_add", GateMiddleXYAdd, True),
        ("use_encoder_adapter_gating_middle_ia3_add",
         "adapter_gating_middle_ia3_add", IA3Vector, True),
        ("use_encoder_adapter_gating_layernorm", "adapter_gating_layernorm",
         LayerNorm, False),
        ("use_encoder_adapter_gating_l2norm", None, None, False),
    )

    tp: Optional[ModelShard] = None  # the FFN's hidden-column shard

    def shard_(self, shard: ModelShard) -> None:
        """Hold this rank's FFN hidden columns (``shard_ffn``)."""
        shard_ffn(self, shard, ("fc1",), "fc2")

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        p, b = cfg.pet, cfg.backbone
        d = b.d_model
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.self_attn = BartAttention(cfg, d, b.encoder_attention_heads,
                                       "enc_self", device=device)
        self.self_attn_layer_norm = ResidualDropoutLayerNorm(
            d, dt, b.dropout, device=device)
        self.fc1 = TaskDense(d, b.encoder_ffn_dim, **kw)
        self.fc2 = TaskDense(b.encoder_ffn_dim, d, **kw)
        self.ffn_width = b.encoder_ffn_dim
        self.final_layer_norm = ResidualDropoutLayerNorm(d, dt, b.dropout,
                                                         device=device)
        self.serial = ((p.use_adapter or p.use_compacter or p.use_lradapter)
                       and not p.no_encoder_adapter)
        self.multihead = next((cls for flag, cls in MULTIHEAD_ADAPTERS
                               if getattr(p, flag)), None)
        if p.use_hyperformer:
            self.adapter_hypernet = MetaLayersAdapterController(
                add_layer_norm_before_adapter=p.add_layer_norm_before_adapter,
                add_layer_norm_after_adapter=p.add_layer_norm_after_adapter,
                dtype=dt)
        for prefix in ("attn", "ff"):
            if self._serial(prefix):
                spec = p.adapter_spec(d)
                if getattr(p, f"use_encoder_{prefix}_adapter_scaling"):
                    spec = dataclasses.replace(
                        spec, use_scaling_factor=True, scaling_factor=getattr(
                            p, f"encoder_{prefix}_adapter_scaling_factor"))
                self.add_module(f"{prefix}_adapter", AdapterController(
                    spec, phm_W_dims=shared_phm_W_dims(p, d), **kw))
            elif self.multihead is not None:
                self.add_module(f"{prefix}_adapter_multihead", self.multihead(
                    d, p.adapter_down_dim, p.encoder_adapter_multihead_num_head,
                    **kw))
            gate = self.gate(prefix)
            if gate is not None and gate[2] is not None:
                _, suffix, cls, _ = gate
                self.add_module(f"encoder_{prefix}_{suffix}",
                                LayerNorm(d, **kw) if cls is LayerNorm
                                else build_gate(cls, d, p, **kw))
            if self._standalone(prefix):
                self.add_module(f"encoder_{prefix}_gating_large_x_lowrank",
                                GateLargeXLowRank(d, p.gating_down_dim, **kw))

    def _attn_off(self, prefix: str) -> bool:
        return prefix == "attn" and self.cfg.pet.no_encoder_attn_adapter

    def gate(self, prefix: str):
        """The ``GATES`` entry on sublayer ``prefix``, or None."""
        return next((g for g in self.GATES if getattr(self.cfg.pet, g[0])
                     and not (g[3] and self._attn_off(prefix))), None)

    def _serial(self, prefix: str) -> bool:
        return self.serial and not self._attn_off(prefix)

    def _standalone(self, prefix: str) -> bool:
        return (self.cfg.pet.use_encoder_gating_large_x_lowrank
                and not self._attn_off(prefix))

    def _hooks(self, h: torch.Tensor, residual: torch.Tensor, prefix: str,
               ctx: PetContext, block_w) -> torch.Tensor:
        p = self.cfg.pet
        if self._serial(prefix):
            h = getattr(self, f"{prefix}_adapter")(h, ctx)
        elif self.multihead is not None:
            h = h + getattr(self, f"{prefix}_adapter_multihead")(h)
        gate = self.gate(prefix)
        if gate is not None:
            _, suffix, cls, _ = gate
            mod = self._modules.get(f"encoder_{prefix}_{suffix}")
            if cls is None:  # L2: a clip, not an added eps
                h = h / torch.linalg.vector_norm(
                    h, dim=-1, keepdim=True).clamp_min(1e-12)
            elif cls is LayerNorm:
                h = mod(h)
            elif cls is IA3Vector:
                g = mod()
                if p.use_encoder_adapter_gating_add:
                    h = h + torch.ones_like(h) + g
                else:
                    h = h + h * g.to(h.dtype)
            else:
                g = mod(residual, h)
                h = (h + g) if p.use_encoder_adapter_gating_add else h * g
        if self._standalone(prefix):
            g, dy = getattr(self, f"encoder_{prefix}_gating_large_x_lowrank")(
                residual, return_pre_sigmoid=True)
            h = ((dy + h) * g
                 if p.use_encoder_gating_large_x_lowrank_add_x2_deltay
                 else dy + h * g)
        if p.use_hyperformer and block_w is not None:
            h = self.adapter_hypernet(h, block_w)
        if p.use_encoder_gating_scaling:
            h = h * p.encoder_gating_scaling_factor
        return h

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                ctx: PetContext, seeds: Optional[DropoutSeeds] = None,
                prefix_kv=None) -> torch.Tensor:
        block = ctx.block_adapters
        residual = hidden_states
        h, _ = self.self_attn(hidden_states, ctx, attention_mask=attention_mask,
                              seeds=seeds, prefix_kv=prefix_kv)
        h = self._hooks(h, residual, "attn", ctx,
                        block.self_attention if block is not None else None)
        hidden_states = self.self_attn_layer_norm(
            h, residual, _seed(seeds, _per_example(h)))

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function,
                 seeds)
        h = self._hooks(h, residual, "ff", ctx,
                        block.feed_forward if block is not None else None)
        hidden_states = self.final_layer_norm(
            h, residual, _seed(seeds, _per_example(h)))
        if self.dtype != torch.float32:
            clamp = torch.finfo(self.dtype).max - 1000
            hidden_states = torch.clamp(hidden_states, -clamp, clamp)
        return hidden_states


class BartDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention (the value
    and key hooks on its K/V), FFN (IA3 on its hidden under
    ``use_decoder_ff_ia3``); each sublayer's output goes through the
    first adapter of ``ADAPTERS[part]`` that the layer has -- the serial
    adapter (``self_attn_adapter``, ``enc_attn_adapter`` under
    ``add_adapter_cross_attn``, ``ff_adapter``), the down-dim adapter
    (``decoder_*_adapter``; the cross one then times its gate on the
    sublayer input, ``decoder_enc_attn_adapter_gating_large_x``) or h +
    the multihead down adapter (``*_adapter_multihead``) -- and then the
    hyperformer adapter (``adapter_hypernet``, the layer's generated
    weights in ``ctx.block_adapters``) before its LayerNorm
    (vlpet_tpu/models/bart.py:710-869). The key-value adapter
    (``decoder_enc_attn_key_value_adapter``) runs on the encoder states
    before both K and V (``kv_states``). ``forward`` is the incremental
    decode step (self-attention over the cache, cross-attention over
    precomputed K/V); ``teacher_force`` the training pass over the whole
    target sequence."""

    # sublayer (a field of BlockAdapterWeights) -> its adapters, in the JAX
    # elif order: serial, down-dim, multihead
    ADAPTERS = {"self_attention": ("self_attn_adapter",
                                   "decoder_self_attn_adapter",
                                   "self_attn_adapter_multihead"),
                "cross_attention": ("enc_attn_adapter",
                                    "decoder_enc_attn_adapter",
                                    "enc_attn_adapter_multihead"),
                "feed_forward": ("ff_adapter", "decoder_ff_adapter",
                                 "ff_adapter_multihead")}

    tp: Optional[ModelShard] = None  # the FFN's hidden-column shard

    def shard_(self, shard: ModelShard) -> None:
        """Hold this rank's FFN hidden columns (``shard_ffn``)."""
        shard_ffn(self, shard, ("fc1",), "fc2")

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        d = b.d_model
        self.cfg = cfg
        dt = compute_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.self_attn = BartAttention(cfg, d, b.decoder_attention_heads,
                                       "dec_self", device=device)
        self.encoder_attn = BartAttention(cfg, d, b.decoder_attention_heads,
                                          "cross", device=device)
        self.self_attn_layer_norm = ResidualDropoutLayerNorm(
            d, dt, b.dropout, device=device)
        self.encoder_attn_layer_norm = ResidualDropoutLayerNorm(
            d, dt, b.dropout, device=device)
        self.final_layer_norm = ResidualDropoutLayerNorm(d, dt, b.dropout,
                                                         device=device)
        self.fc1 = TaskDense(d, b.decoder_ffn_dim, **kw)
        self.fc2 = TaskDense(b.decoder_ffn_dim, d, **kw)
        self.ffn_width = b.decoder_ffn_dim
        p = cfg.pet
        ac = dict(phm_W_dims=shared_phm_W_dims(p, d), **kw)
        serial = ((p.use_adapter or p.use_compacter or p.use_lradapter)
                  and not p.no_decoder_adapter)
        # one adapter a sublayer, the first the JAX elif reaches: flax
        # creates no parameters for a module its forward never calls
        for part, (name, down_dim, multihead) in self.ADAPTERS.items():
            flag = f"use_{down_dim}_down_dim"
            if serial and (part != "cross_attention"
                           or p.add_adapter_cross_attn):
                self.add_module(name, AdapterController(p.adapter_spec(d),
                                                        **ac))
            elif getattr(p, flag):
                self.add_module(down_dim, AdapterController(p.down_dim_spec(
                    d, getattr(p, flag[4:])), **ac))
                gate = "decoder_enc_attn_adapter_gating_large_x_lowrank"
                if part == "cross_attention" and getattr(p, "use_" + gate):
                    self.decoder_enc_attn_adapter_gating_large_x = (
                        GateLargeXLowRank(d, getattr(p, gate + "_down_dim"),
                                          **kw))
            elif p.use_decoder_adapter_down_multihead and not serial:
                self.add_module(multihead, MultiheadDownAdapter(
                    d, p.adapter_down_dim, p.decoder_adapter_multihead_num_head,
                    **kw))
        if p.use_decoder_enc_attn_key_value_adapter_down_dim:
            self.decoder_enc_attn_key_value_adapter = AdapterController(
                p.down_dim_spec(
                    d, p.decoder_enc_attn_key_value_adapter_down_dim), **ac)
        if p.use_decoder_ff_ia3:
            self.decoder_ff_ia3_mod = IA3Vector(b.decoder_ffn_dim,
                                                "decoder_ff_ia3", device=device)
        if p.use_hyperformer:
            self.adapter_hypernet = MetaLayersAdapterController(
                add_layer_norm_before_adapter=p.add_layer_norm_before_adapter,
                add_layer_norm_after_adapter=p.add_layer_norm_after_adapter,
                dtype=dt)

    def _adapt(self, h: torch.Tensor, part: str, ctx: PetContext,
               residual: torch.Tensor) -> torch.Tensor:
        """Sublayer ``part``'s output (``residual`` its input) through its
        adapter, then the hyperformer adapter, where the layer has them."""
        mods = self._modules
        name, down_dim, multihead = self.ADAPTERS[part]
        if name in mods:
            h = mods[name](h, ctx)
        elif down_dim in mods:
            h = mods[down_dim](h, ctx)
            gate = mods.get(f"{down_dim}_gating_large_x")
            if gate is not None:
                h = h * gate(residual)
        elif multihead in mods:
            h = h + mods[multihead](h)
        block = ctx.block_adapters
        if block is not None and getattr(block, part) is not None:
            h = self.adapter_hypernet(h, getattr(block, part))
        return h

    def kv_states(self, encoder_hidden_states: torch.Tensor,
                  ctx: PetContext) -> torch.Tensor:
        """The states the cross-attention's K and V read: the encoder's,
        through the key-value adapter where the layer has one."""
        kv = self._modules.get("decoder_enc_attn_key_value_adapter")
        return (kv(encoder_hidden_states, ctx) if kv is not None
                else encoder_hidden_states)

    def forward(self, hidden_states: torch.Tensor, ctx: PetContext,
                self_mask: Optional[torch.Tensor],
                cross_mask: Optional[torch.Tensor],
                cross_kv: Tuple[torch.Tensor, torch.Tensor], cache: Cache,
                decode_pos: int, beam_anc: Optional[torch.Tensor],
                self_qkv: Tuple[torch.Tensor, torch.Tensor]):
        residual = hidden_states
        h, cache = self.self_attn(hidden_states, ctx, attention_mask=self_mask,
                                  cache=cache, decode_pos=decode_pos,
                                  beam_anc=beam_anc, qkv=self_qkv)
        h = self._adapt(h, "self_attention", ctx, residual)
        hidden_states = self.self_attn_layer_norm(h, residual)

        residual = hidden_states
        h, _ = self.encoder_attn(hidden_states, ctx, attention_mask=cross_mask,
                                 cross_kv=cross_kv)
        h = self._adapt(h, "cross_attention", ctx, residual)
        hidden_states = self.encoder_attn_layer_norm(h, residual)

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function)
        h = self._adapt(h, "feed_forward", ctx, residual)
        hidden_states = self.final_layer_norm(h, residual)
        return hidden_states, cache

    def teacher_force(self, hidden_states: torch.Tensor, ctx: PetContext,
                      encoder_hidden_states: Optional[torch.Tensor],
                      cross_mask: Optional[torch.Tensor],
                      seeds: Optional[DropoutSeeds], prefix_kv=None,
                      prompt_len: int = 0) -> torch.Tensor:
        """The training pass over the whole target sequence (B, T, d).
        ``prefix_kv``: the layer's attention prefix before the causal
        keys. ``prompt_len`` P: the first P rows are the decoder input
        prompt, which the cross block leaves as they were (the reference's
        dry run has no encoder states, vlpet_tpu/models/bart.py:829-837).
        Without ``encoder_hidden_states`` the cross block is skipped: that
        dry run itself (``BartDecoder.prefill_kvs``)."""
        residual = hidden_states
        h, _ = self.self_attn(hidden_states, ctx, seeds=seeds,
                              prefix_kv=prefix_kv)
        h = self._adapt(h, "self_attention", ctx, residual)
        hidden_states = self.self_attn_layer_norm(
            h, residual, _seed(seeds, _per_example(h)))

        if encoder_hidden_states is not None:
            residual = hidden_states
            # the cross K/V through compute_cross_kv's path (kv_states,
            # then BartAttention.compute_cross_kv), LoRA's q seed before v's
            h, _ = self.encoder_attn(
                hidden_states, ctx, attention_mask=cross_mask,
                kv_states=self.kv_states(encoder_hidden_states, ctx),
                seeds=seeds)
            h = self._adapt(h, "cross_attention", ctx, residual)
            hidden_states = self.encoder_attn_layer_norm(
                h, residual, _seed(seeds, _per_example(h)))
            if prompt_len:
                hidden_states = torch.cat([residual[:, :prompt_len],
                                           hidden_states[:, prompt_len:]], 1)

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function,
                 seeds)
        h = self._adapt(h, "feed_forward", ctx, residual)
        return self.final_layer_norm(h, residual,
                                     _seed(seeds, _per_example(h)))

    def compute_cross_kv(self, encoder_hidden_states: torch.Tensor,
                         ctx: PetContext):
        """The decode precompute of the cross K/V: the training pass's
        path (``kv_states``, then BartAttention.compute_cross_kv)."""
        return self.encoder_attn.compute_cross_kv(
            self.kv_states(encoder_hidden_states, ctx), ctx)


def prompt_controller(cfg: VLModelConfig, prompt_len: int,
                      init_std: Optional[float], dtype,
                      device: Device) -> PromptController:
    """The PromptController of an encoder or decoder prompt of
    ``prompt_len`` (vlpet_tpu/models/bart.py:948-953, :1133-1139; T5's
    with init_std None, vlpet_tpu/models/t5.py:606-614, :730-737)."""
    p = cfg.pet
    return PromptController(
        PromptSpec(prompt_len=prompt_len, mid_dim=p.mid_dim,
                   use_single_prompt=p.use_single_prompt, tasks=p.tasks),
        cfg.d_model, init_std=init_std, dtype=dtype, device=device)


class JointEncoder(nn.Module):
    """BART encoder + visual concat. Sequence layout [prompt; text; vis]:
    the encoder prompt (``prompt_modules``, ``encoder_prompt_len`` > 0)
    goes before the text after the text's positions are added, and takes
    layernorm_embedding with it (before the concat with vis, unless
    share_vis_lang_layer_norm); the joint mask is ones over the prompt ++
    text-mask ++ vis-mask (vlpet_tpu/models/bart.py:945-958). Under
    ``use_hyperformer`` the stack's ``adapter_layers_hyper_net`` generates
    each layer's adapter weights from the task embedding.

    Prefixes (vlpet_tpu/models/bart.py:959-980, :1029-1050): under
    ``use_vis_prefix`` the visual features (downsampled as configured)
    become each layer's K/V prefix (``visual_embedding`` is a
    ResidualVisualPrefix), nothing joins the sequence and the joint mask
    is the text's, while the attention mask takes the visual mask's
    columns on the left; else, under ``use_attn_prefix``, the
    ``encoder_prompt_len`` learned prefixes
    (``encoder_prefix_embedding``) take the prompt's place, with P
    always-open mask columns."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b, v = cfg.backbone, cfg.vis
        p = cfg.pet
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        self.embed_positions = nn.Parameter(
            torch.empty((b.max_position_embeddings + 2, b.d_model),
                        device=resolve_device(device)))
        if v.use_vis_prefix and not v.no_vis:
            self.visual_embedding = ResidualVisualPrefix(
                v.feat_dim, b.encoder_layers, b.d_model, dtype=dt,
                device=device)
        elif not v.no_vis:
            self.visual_embedding = visual_embedding_class(v)(
                v, b.d_model, dtype=dt, device=device)
        self.layernorm_embedding = LayerNorm(b.d_model, dtype=dt, device=device)
        if p.use_attn_prefix and p.encoder_prompt_len > 0:
            self.encoder_prefix_embedding = AttnPrefixController(
                p.encoder_prompt_len, b.encoder_layers, b.d_model,
                mid_dim=p.mid_dim, init_std=b.init_std, dtype=dt,
                device=device)
        elif p.encoder_prompt_len > 0:
            self.prompt_modules = prompt_controller(
                cfg, p.encoder_prompt_len, b.init_std, dt, device)
        if p.use_hyperformer:
            self.adapter_layers_hyper_net = stack_hypernet(
                cfg, b.encoder_layers, False, dtype=dt, device=device)
        self.n_layers = b.encoder_layers
        for i in range(b.encoder_layers):
            self.add_module(f"layers_{i}", BartEncoderLayer(cfg, device=device))

    def layers(self) -> List[BartEncoderLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.n_layers)]

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                shared_embedding: torch.Tensor,
                vis_feats: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                img_order_ids: Optional[torch.Tensor] = None,
                obj_order_ids: Optional[torch.Tensor] = None,
                vis_attention_mask: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None,
                seeds: Optional[DropoutSeeds] = None,
                task_embedding: Optional[torch.Tensor] = None,
                sparse_generator: Optional[torch.Generator] = None,
                sparse: bool = False):
        """Returns (hidden_states, joint_attention_mask [B, L_joint]).
        ``seeds`` (training) drives the embedding dropout, each layer's
        sites (``layer_sites``) and LoRA's dropout; ``task_embedding`` (the
        hyperformer's) feeds the stack's hypernet. ``sparse`` (a training
        call under ``vis.sparse_sample``): the visual tokens are
        subsampled to ``n_boxes`` (``sparse_sample``) with scores drawn
        from ``sparse_generator`` (vlpet_tpu/models/bart.py:1003-1006).
        Each layer runs under ``cfg.remat`` (``run_layer``)."""
        b, v = self.cfg.backbone, self.cfg.vis
        dt = self.dtype
        ctx = ctx or PetContext()
        B, L = input_ids.shape
        embed_scale = (b.d_model ** 0.5) if b.scale_embedding else 1.0
        h = shared_embedding[input_ids].to(dt) * embed_scale
        h = h + self.embed_positions[2:2 + L].to(dt)[None]
        mods = self._modules
        if "prompt_modules" in mods:
            prefix = self.prompt_modules(B, ctx.task_idx)
            h = torch.cat([prefix, h], dim=1)
            attention_mask = torch.cat([attention_mask.new_ones(
                (B, prefix.shape[1])), attention_mask], dim=1)
        prefix_kvs = None
        if v.use_vis_prefix and not v.no_vis and vis_feats is not None:
            vf = vis_feats
            if v.oneddownsample or v.downsample:
                vf = downsample_vis((vis_feats, boxes), v.n_boxes,
                                    oned=v.oneddownsample)[0]
            prefix_kvs = self.visual_embedding(vf)
            if vis_attention_mask is None:
                vis_attention_mask = attention_mask.new_ones(vf.shape[:2])
            h = self.layernorm_embedding(h)
            mask = attention_mask
            # the visual mask's columns before the text's
            prefix_mask = expand_mask(vis_attention_mask, 1, dt)
        elif not v.no_vis and vis_feats is not None:
            vis_embeds = self.visual_embedding.tokens(
                vis_feats, boxes, shared_embedding, img_order_ids,
                obj_order_ids)
            if sparse:
                n, base = vis_embeds.shape[0], ctx.example_base
                scores = sparse_scores(
                    (ctx.global_batch or n, vis_embeds.shape[1]),
                    sparse_generator, h.device)[base:base + n]
                vis_embeds = sparse_sample(vis_embeds, v.n_boxes, scores)
            if v.share_vis_lang_layer_norm:
                h = self.layernorm_embedding(torch.cat([h, vis_embeds], dim=1))
            else:
                h = torch.cat([self.layernorm_embedding(h), vis_embeds], dim=1)
            mask = joint_attention_mask(attention_mask, vis_embeds.shape[1],
                                        vis_attention_mask)
        else:
            h = self.layernorm_embedding(h)
            mask = attention_mask
        h = _embedding_dropout(h, seeds, b.dropout)
        # length-collapsed (B, 1, 1, S) additive mask
        attn_mask = expand_mask(mask, 1, dt)
        if prefix_kvs is not None:
            attn_mask = torch.cat([prefix_mask, attn_mask], dim=-1)
        elif "encoder_prefix_embedding" in mods:
            prefix_kvs = self.encoder_prefix_embedding(B)
            attn_mask = torch.cat([attn_mask.new_zeros(
                (B, 1, 1, prefix_kvs[0][0].shape[1])), attn_mask], dim=-1)
        hypernet = mods.get("adapter_layers_hyper_net")
        n_sites = layer_sites(self.cfg, 1)
        for i, layer in enumerate(self.layers()):
            block = (hypernet(task_embedding, i) if hypernet is not None
                     else None)
            lctx = ctx.for_layer(block)
            pkv = prefix_kvs[i] if prefix_kvs is not None else None
            h = run_layer(self.cfg.remat,
                          lambda x, s, layer=layer, lctx=lctx, pkv=pkv:
                          layer(x, attn_mask, lctx, s, pkv), h, seeds,
                          n_sites)
        return h, mask


class BartDecoder(nn.Module):
    """BART decoder stack: ``forward`` is one incremental decode step,
    ``teacher_force`` the training pass. Under ``use_hyperformer`` the
    stack's ``adapter_layers_hyper_net`` generates each layer's adapter
    weights (cross-attention's under ``add_adapter_cross_attn``):
    ``block_adapters`` once per generation, held in the decode constants,
    and in every training pass.

    ``decoder_prompt_len`` P > 0 builds one of two things
    (vlpet_tpu/models/bart.py:1117-1143): under ``use_attn_prefix`` the
    per-layer attention prefixes (``decoder_prefix_embedding``), whose
    P keys sit before the causal ones, the positions then starting at
    2 + P; otherwise the decoder input prompt (``prompt_modules``),
    whose P rows go before the inputs, with positions over P + T, are
    left alone by the cross block and are dropped at the end. Either
    way generation prefills the first P cache slots (``prefill_kvs``)
    and decodes from slot P."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b, p = cfg.backbone, cfg.pet
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        self.embed_positions = nn.Parameter(
            torch.empty((b.max_position_embeddings + 2, b.d_model),
                        device=resolve_device(device)))
        self.layernorm_embedding = LayerNorm(b.d_model, dtype=dt, device=device)
        if p.decoder_prompt_len > 0 and p.use_attn_prefix:
            self.decoder_prefix_embedding = AttnPrefixController(
                p.decoder_prompt_len, b.decoder_layers, b.d_model,
                mid_dim=p.mid_dim, init_std=b.init_std, dtype=dt,
                device=device)
        elif p.decoder_prompt_len > 0:
            self.prompt_modules = prompt_controller(
                cfg, p.decoder_prompt_len, b.init_std, dt, device)
        if cfg.pet.use_hyperformer:
            self.adapter_layers_hyper_net = stack_hypernet(
                cfg, b.decoder_layers, cfg.pet.add_adapter_cross_attn,
                dtype=dt, device=device)
        self.n_layers = b.decoder_layers
        for i in range(b.decoder_layers):
            self.add_module(f"layers_{i}", BartDecoderLayer(cfg, device=device))

    def layers(self) -> List[BartDecoderLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.n_layers)]

    def block_adapters(self, task_embedding: Optional[torch.Tensor]) -> Tuple:
        """Each layer's hypernet-generated adapter weights (None per layer
        without the hyperformer)."""
        hypernet = self._modules.get("adapter_layers_hyper_net")
        return tuple(hypernet(task_embedding, i) if hypernet is not None
                     else None
                     for i in range(self.n_layers))

    def forward(self, input_ids: torch.Tensor, shared_embedding: torch.Tensor,
                encoder_attention_mask: torch.Tensor, ctx: PetContext,
                cross_kvs: Tuple, cache: Tuple[Cache, ...], decode_pos: int,
                beam_anc: Optional[torch.Tensor], self_qkvs: Tuple,
                blocks: Tuple):
        """One decode step: input_ids (B, 1) at position ``decode_pos``.
        ``beam_anc`` (B_true, K, L_cache) switches self-attention to the
        reorder-free beam path; input rows are then beam-major (B_true*K)
        and cross_kvs / encoder_attention_mask stay at B_true rows.
        ``self_qkvs`` is ``fused_self_qkvs()`` and ``blocks``
        ``block_adapters()``, both built once per sequence.
        Returns (hidden (B, 1, d), cache)."""
        b = self.cfg.backbone
        dt = self.dtype
        embed_scale = (b.d_model ** 0.5) if b.scale_embedding else 1.0
        h = shared_embedding[input_ids].to(dt) * embed_scale
        h = h + self.embed_positions[decode_pos + 2].to(dt)[None, None]
        self_mask = None
        if beam_anc is None:
            max_len = cache[0]["k"].shape[0]
            j = torch.arange(max_len, device=h.device)[None, None, None, :]
            self_mask = torch.where(j <= decode_pos, 0.0, NEG_INF).to(dt)
        h = self.layernorm_embedding(h)
        cross_mask = expand_mask(encoder_attention_mask, 1, dt)
        for layer, kv, c, qkv, block in zip(self.layers(), cross_kvs, cache,
                                            self_qkvs, blocks):
            h, _ = layer(h, ctx.for_layer(block), self_mask, cross_mask, kv, c,
                         decode_pos, beam_anc, qkv)
        return h, cache

    def teacher_force(self, input_ids: torch.Tensor,
                      shared_embedding: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      encoder_attention_mask: torch.Tensor, ctx: PetContext,
                      seeds: Optional[DropoutSeeds] = None,
                      task_embedding: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Training: the whole target sequence input_ids (B, T) at positions
        2 + t, causal self-attention, cross-attention over the encoder
        states (vlpet_tpu/models/bart.py:1186-1305), after the decoder
        input prompt or behind the attention prefix (the class docstring).
        Returns (B, T, d)."""
        b = self.cfg.backbone
        dt = self.dtype
        B, T = input_ids.shape
        embed_scale = (b.d_model ** 0.5) if b.scale_embedding else 1.0
        h = shared_embedding[input_ids].to(dt) * embed_scale
        mods = self._modules
        P_in = P_off = 0
        if "prompt_modules" in mods:
            prompt = self.prompt_modules(B, ctx.task_idx).to(dt)
            P_in = prompt.shape[1]
            h = torch.cat([prompt, h], dim=1)
        prefix_kvs = None
        if "decoder_prefix_embedding" in mods:
            prefix_kvs = self.decoder_prefix_embedding(B)
            P_off = prefix_kvs[0][0].shape[1]
        h = h + self.embed_positions[2 + P_off:2 + P_off + P_in + T].to(dt)[None]
        h = self.layernorm_embedding(h)
        h = _embedding_dropout(h, seeds, b.dropout)
        cross_mask = expand_mask(encoder_attention_mask, 1, dt)
        n_sites = layer_sites(self.cfg, 2)
        for i, (layer, block) in enumerate(zip(
                self.layers(), self.block_adapters(task_embedding))):
            lctx = ctx.for_layer(block)
            pkv = prefix_kvs[i] if prefix_kvs is not None else None
            h = run_layer(self.cfg.remat,
                          lambda x, s, layer=layer, lctx=lctx, pkv=pkv:
                          layer.teacher_force(x, lctx, encoder_hidden_states,
                                              cross_mask, s, pkv, P_in),
                          h, seeds, n_sites)
        return h[:, P_in:] if P_in else h

    def prefill_kvs(self, batch_size: int, ctx: PetContext,
                    task_embedding: Optional[torch.Tensor] = None):
        """Per layer the (k, v), each (B, P, H*Dh), that generation writes
        into the first P cache slots, or None without decoder prefixes or
        prompts: the attention prefixes themselves
        (vlpet_tpu/models/bart.py:1307 ``prefix_cache_init``), or the
        decoder input prompt's self-attention K/V from the reference's dry
        run (``compute_prompt_kvs``, :1316): the prompt at positions
        0..P-1 through every layer without its cross block. A sharded
        decoder's are its heads' (the caches' width)."""
        mods = self._modules
        if "decoder_prefix_embedding" in mods:
            kvs = self.decoder_prefix_embedding(batch_size)
            attn = self.layers()[0].self_attn
            if attn.tp is None:
                return kvs
            return tuple((attn._cols(k), attn._cols(v)) for k, v in kvs)
        if "prompt_modules" not in mods:
            return None
        dt = self.dtype
        h = self.prompt_modules(batch_size, ctx.task_idx).to(dt)
        h = h + self.embed_positions[2:2 + h.shape[1]].to(dt)[None]
        h = self.layernorm_embedding(h)
        kvs = []
        for layer, block in zip(self.layers(),
                                self.block_adapters(task_embedding)):
            lctx = ctx.for_layer(block)
            _, k, v = layer.self_attn._qkv(h, lctx)
            kvs.append((k, v))
            h = layer.teacher_force(h, lctx, None, None, None)
        return tuple(kvs)

    def compute_cross_kvs(self, encoder_hidden_states: torch.Tensor,
                          ctx: PetContext):
        """Per-layer cross-attention K/V (VPA included), once per sequence."""
        return tuple(layer.compute_cross_kv(encoder_hidden_states, ctx)
                     for layer in self.layers())

    def fused_self_qkvs(self):
        """Per-layer fused self-attention QKV weight and bias (None per
        layer under LoRA)."""
        return tuple(layer.self_attn.fused_qkv() for layer in self.layers())
