"""T5 encoder/decoder with the VL-PET-large hooks and the VLT5 glue, for
training and evaluation, ported from vlpet_tpu/models/t5.py.

Semantics kept from the JAX module:

* pre-norm blocks (RMSNorm): y = sublayer(RMSNorm(x)); the encoder hooks act
  on y and the gate reads the PRE-norm block input x;
* no query scaling (the init absorbs 1/sqrt(d_kv));
* the relative position bias lives in block 0 of each stack (parameter
  ``relative_attention_bias`` (buckets, H)) and is shared by every block;
* the joint encoder's block-diagonal bias: text-text pairs get the T5 bias,
  any pair with a visual token 0; the padding mask stays a separate
  (B, 1, 1, S) term, so the (B, H, S, S) sum never exists;
* the cross-attention VPA acts inside the V projection on the raw encoder
  states; the decoder's self-attention has no hook;
* the tied LM head with the d_model**-0.5 rescale, or an untied ``lm_head``
  (t5-v1.1) without it; no vocab pad.

Training (``VLT5.forward`` with ``deterministic=False``): hash dropout
(ops/hashdrop.py) at rate ``dropout_rate`` on the embeddings, on every
residual branch and on the final states of both stacks, on the attention
probabilities inside A1/A6 and on the FFN hidden inside F1-F4, one seed per
site per step drawn from the caller's generator in the order of
``VLT5.dropout_sites``; the loss is vlpet_tpu/models/t5.py:1030-1067's
(for the tied, frozen head ``fused_linear_ce`` on the rescaled states
with ``use_fused_ce``, else ``linear_ce`` in bf16; otherwise CE on the fp32
logits). A trainable ``relative_attention_bias`` (unfreeze_language_model,
unfreeze_bias, unfreeze_encoder_bias, unfreeze_decoder_bias) takes its
gradient through the attention kernels' dbias (ops.attention, A6 and the
long backward), then through the plain bucket gather and the sum over the
blocks that share it. The video shape (S 604, ``config.t5_video_cfg``)
trains through the long backward with the bias and the dropout.

The PET baselines of the JAX T5: serial adapters (bottleneck, Compacter
with the model-root rule and slow weights, low-rank) after each sublayer
of both stacks, the hyperformer's generated adapters (a hypernet per
stack, the task embedding at the model), the encoder prompt before the
joint sequence (the relative bias then spans prompt and text) and the
decoder input prompt (its rows before the inputs, untouched by the cross
block, dropped at the end; generation prefills its dry-run K/V). LoRA on
T5 builds no module: the JAX T5 has none, and ``use_lora`` only makes the
"bias" leaves (the relative bias among them) trainable, which the freezing
rules do. Under ``cfg.classifier`` the answer head of models/vlbart.py
(``AnswerHead``, std ``initializer_factor`` * 0.02) sits on the last
decoder state (``classify``, ``forward``'s "answer_logits"); a training
call under ``vis.sparse_sample`` subsamples the visual tokens. What the
port lacks raises NotImplementedError at build: the configurations
models/vlbart.py check_supported rejects and the flags the JAX T5 does not
read (``check_t5_supported``).

Kernel call sites, each picked by ops.route (the plain twins inside
``ops.plain_twins()``): every attention but the beam self-attention through
ops.attention.fused_attention (A1, with the relative bias as its per-head
``bias``), beam self-attention through ops.decode.beam_decode_attend (D1,
with the bias row) or, with ``use_fused_beam``, the fused attend and slot
write ops.decode.beam_decode_attend_update (D2), every other decode-step
KV write through ops.cache_update.cache_slots_update (U1, K and V in one
launch), the tied frozen head's loss through ops.fused_ce.fused_linear_ce
(C1, backward C2) with ``use_fused_ce``, the relu FFN through
ops.ffn.fused_ffn (F1, zero biases; backward F2) and the gated-gelu FFN
through ops.ffn.fused_gated_ffn (F3, backward F4), unless ``use_fused_ffn`` is off or the language model
trains (the FFN kernels have no weight gradient). Parameter names are
the flax tree's (``blocks_{i}``, ``shared``, ``lm_head``), so
vlpet_tpu_torch.convert carries the weights across unchanged.

Tensor parallelism (parallel/mesh.py ``shard_model``) as in models/bart.py:
a sharded T5Attention holds its rank's heads (q/k/v rows, o's columns;
the relative bias sliced to them where it is built; the VPA's output
added to v's head columns behind ``copy_to_model``), a sharded T5Block its
FFN hidden columns (F1 / F2 relu, F3 / F4 gated, at the hidden's column
base and whole width), wo and o row-parallel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.bart import (NEG_INF, _per_example, _seed,
                                         compute_dtype, expand_mask,
                                         prompt_controller, shard_ffn,
                                         write_slot)
from vlpet_tpu_torch.models.generate import topk_lse
from vlpet_tpu_torch.models.norm import RMSNorm
from vlpet_tpu_torch.models.visual import (LowRankVisualEmbedding,
                                           joint_attention_mask,
                                           sparse_sample, sparse_scores,
                                           visual_embedding_class)
from vlpet_tpu_torch.models.vlbart import (BART_ONLY_PET_FLAGS,
                                           T5_UNREAD_FLAGS, AnswerHead,
                                           check_supported,
                                           shift_tokens_right)
from vlpet_tpu_torch.ops import route
from vlpet_tpu_torch.ops.attention import (fused_attention,
                                           fused_attention_reference)
from vlpet_tpu_torch.ops.ce import (cross_entropy_with_ignore, linear_ce,
                                    mean_or_per_token)
from vlpet_tpu_torch.ops.decode import (beam_cross_attend, beam_decode_attend,
                                        beam_decode_attend_reference,
                                        beam_decode_attend_update,
                                        beam_decode_attend_update_reference,
                                        decode_attend)
from vlpet_tpu_torch.ops.fused_ce import (fused_linear_ce,
                                          fused_linear_ce_plain)
from vlpet_tpu_torch.ops.ffn import (ffn_reference, fused_ffn,
                                     fused_gated_ffn, gated_ffn_reference)
from vlpet_tpu_torch.ops.hashdrop import (DropoutSeeds, fold_heads,
                                          hash_dropout)
from vlpet_tpu_torch.parallel.tensor import (ModelShard, copy_to_model,
                                             end_of_shard, row_parallel)
from vlpet_tpu_torch.pet.hypernet import (MetaLayersAdapterController,
                                          TaskEmbeddingController,
                                          stack_hypernet)
from vlpet_tpu_torch.pet.modules import (AdapterController, GateLargeXLowRank,
                                         GateMiddleXYAdd, GateSmallXYCat,
                                         IA3Vector, MultiheadDownAdapter,
                                         PetContext, TaskDense, build_gate,
                                         glorot_uniform_gain2_,
                                         make_shared_phm_W, normal_,
                                         shared_phm_W, shared_phm_W_dims)
from vlpet_tpu_torch.train.freezing import weight_initialization

Cache = Dict[str, torch.Tensor]


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Mesh-TF bucketing (vlpet_tpu/models/t5.py:64), int64 in and out."""
    ret = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (relative_position > 0).long() * num_buckets
        n = relative_position.abs()
    else:
        n = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    large = (torch.log(torch.clamp(n, min=1).float() / max_exact)
             / math.log(max_distance / max_exact)
             * (num_buckets - max_exact)).to(torch.int32).long()
    large = torch.clamp(max_exact + large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    """T5 attention in one of three roles: 'enc_self', 'dec_self'
    (causal over the target sequence, or incremental over the KV cache)
    and 'cross' (over the encoder states or precomputed cross K/V).
    ``num_heads``: the heads this rank holds (``whole_heads`` unless
    ``shard_`` gave it a model-axis shard ``tp``)."""

    tp: Optional[ModelShard] = None

    def __init__(self, cfg: VLModelConfig, role: str,
                 has_relative_attention_bias: bool = False,
                 device: Device = "cuda"):
        super().__init__()
        b, p = cfg.backbone, cfg.pet
        self.cfg, self.role = cfg, role
        self.num_heads, self.head_dim = b.num_heads, b.d_kv
        self.whole_heads = b.num_heads
        self.dtype = dt = compute_dtype(cfg)
        inner = b.num_heads * b.d_kv
        kw = dict(use_bias=False, dtype=dt, device=device)
        self.q = TaskDense(b.d_model, inner, **kw)
        self.k = TaskDense(b.d_model, inner, **kw)
        self.v = TaskDense(b.d_model, inner, **kw)
        self.o = TaskDense(inner, b.d_model, **kw)
        self.has_vpa = (role == "cross" and
                        p.use_decoder_enc_attn_value_parallel_adapter_down_dim)
        if self.has_vpa:
            spec = p.down_dim_spec(
                b.d_model, p.decoder_enc_attn_value_parallel_adapter_down_dim,
                parallel=True)
            self.attn_value_parallel_adapter = AdapterController(
                spec, dtype=dt, device=device)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Parameter(torch.empty(
                (b.relative_attention_num_buckets, b.num_heads),
                device=resolve_device(device)))

    def shard_(self, shard: ModelShard) -> None:
        """Hold this rank's heads of the model axis (parallel/mesh.py
        shard_model has cut q/k/v's rows and o's columns; the relative
        bias stays whole)."""
        self.tp = shard
        self.num_heads = shard.local(self.whole_heads)
        inner = self.num_heads * self.head_dim
        for mod in (self.q, self.k, self.v):
            mod.out_dim = inner
        self.o.in_dim = inner

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp is None else copy_to_model(x, self.tp)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.o(out)
        return row_parallel(out, self.o.weight, None, self.tp)

    def _bias(self, rel: torch.Tensor) -> torch.Tensor:
        """(1, H, *rel.shape) bias of relative positions ``rel`` (key minus
        query), rounded to the compute dtype as the JAX module does; the
        rank's heads of a sharded attention."""
        b = self.cfg.backbone
        buckets = relative_position_bucket(
            rel, bidirectional=self.role != "dec_self",
            num_buckets=b.relative_attention_num_buckets,
            max_distance=b.relative_attention_max_distance)
        table = self.relative_attention_bias
        if self.tp is not None:
            table = self.tp.columns(table, self.whole_heads)
        values = table[buckets]  # (q, k, H)
        return values.permute(2, 0, 1)[None].to(self.dtype)

    def compute_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        """(1, H, q_len, k_len) relative bias."""
        dev = self.relative_attention_bias.device
        return self._bias(torch.arange(k_len, device=dev)[None, :]
                          - torch.arange(q_len, device=dev)[:, None])

    def compute_bias_row(self, pos: int, k_len: int) -> torch.Tensor:
        """(1, H, 1, k_len) decoder bias for the query at ``pos``."""
        dev = self.relative_attention_bias.device
        return self._bias(torch.arange(k_len, device=dev)[None, :] - pos)

    def compute_cross_kv(self, kv_states: torch.Tensor, ctx: PetContext):
        """Cross K/V (B, S, H*Dh), the VPA included (on the raw encoder
        states): computed once per sequence. A sharded attention's VPA
        output gives v its head columns behind ``copy_to_model``."""
        kv_in = self._enter(kv_states)
        k = self.k(kv_in)
        v = self.v(kv_in)
        if self.has_vpa:  # its output alone, plus a zero: y + out's sum
            out = self.attn_value_parallel_adapter(kv_states, ctx,
                                                   y=v.new_zeros(()))
            v = v + (out if self.tp is None else self.tp.columns(
                out, self.whole_heads, self.head_dim))
        return k, v

    def forward(self, hidden_states: torch.Tensor, ctx: PetContext,
                mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, causal: bool = False,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                kv_states: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                decode_pos: Optional[int] = None,
                beam_anc: Optional[torch.Tensor] = None, rate: float = 0.0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: additive (B, 1, 1, S) padding mask (enc_self, cross).
        ``bias``: the relative bias, (1, H, L, S) for a whole sequence, or
        at a decode step the (1, H, 1, L_cache) row (beam) or row plus the
        causal mask (greedy). The decode cache is updated IN PLACE at slot
        ``decode_pos``. ``rate`` > 0 (training, whole sequences): dropout
        of the probabilities, driven by ``seed`` (a sharded attention's
        moved to its first head). The bias of a sharded attention holds its
        heads (``_bias``)."""
        B, L, _ = hidden_states.shape
        H, Dh = self.num_heads, self.head_dim
        attend = route(fused_attention, fused_attention_reference)
        if seed is not None and self.tp is not None:
            seed = fold_heads(seed, self.tp.base(self.whole_heads))
        x = self._enter(hidden_states)
        q = self.q(x)  # no scaling (T5)
        if self.role == "cross":
            k, v = (cross_kv if cross_kv is not None
                    else self.compute_cross_kv(kv_states, ctx))
            if k.shape[0] != B:  # beam-shared encoder K/V
                out = beam_cross_attend(q.reshape(B * L, 1, H, Dh), k, v,
                                        mask, attend)
                return self._out(out.reshape(B, L, -1))
            return self._out(attend(q, k, v, mask.float(), H, False, None,
                                    rate, seed))
        k = self.k(x)
        v = self.v(x)
        if cache is None:
            if mask is None:  # teacher-forced decoder: no padding mask
                mask = torch.zeros((1, 1, 1, L), dtype=torch.float32,
                                   device=q.device)
            return self._out(attend(q, k, v, mask.float(), H, causal, bias,
                                    rate, seed))
        q4 = q.reshape(B, 1, H, Dh)
        if beam_anc is not None and self.cfg.use_fused_beam:
            # D2 (vlpet_tpu/models/t5.py:196-211): the own row gets the
            # distance-0 bias, the cache side the bias row; the own bias is
            # the row's column decode_pos, a view (D2 reads it by stride)
            fn = route(beam_decode_attend_update,
                       beam_decode_attend_update_reference)
            out = fn(q4, cache["k"], cache["v"], k, v, beam_anc, decode_pos,
                     bias[0, :, 0, decode_pos], bias)
            return self._out(out)
        write_slot(cache, k, v, decode_pos)
        if beam_anc is not None:
            fn = route(beam_decode_attend, beam_decode_attend_reference)
            out = fn(q4, cache["k"], cache["v"], beam_anc, decode_pos, bias)
        else:
            out = decode_attend(q4, cache["k"], cache["v"], bias_row=bias)
        return self._out(out)


class T5EncoderHooks(nn.Module):
    """The encoder hook chain on a sublayer's output y (vlpet_tpu/models/
    t5.py:312-388): the serial adapter (``{prefix}_adapter``, an
    AdapterController of the bottleneck, Compacter or low-rank kind, unless
    ``no_encoder_adapter``) or y + MultiheadDownAdapter(y) (scaled as
    configured); then the hyperformer adapter (``adapter_hypernet``) with
    the layer's generated weights; then one gate with x the pre-norm block
    input -- y * G with G from GateLargeXLowRank(x), GateSmallXYCat(x, y) or
    GateMiddleXYAdd(x, y), or middle-Y's y + y * v -- then the gating
    scale. As in the JAX T5 (and unlike BART): no GateLargeX, no ``_add``
    form of the gates, no ``no_encoder_attn_adapter`` check and the
    hypernet before the gate. Registered as ``attn_hooks`` /
    ``ff_hooks``."""

    # (flag, module suffix, class) in the JAX elif order
    GATES = (
        ("use_encoder_adapter_gating_large_x_lowrank",
         "adapter_gating_large_x_lowrank", GateLargeXLowRank),
        ("use_encoder_adapter_gating_small_xy_cat",
         "adapter_gating_small_xy_cat", GateSmallXYCat),
        ("use_encoder_adapter_gating_middle_xy_add",
         "adapter_gating_middle_xy_add", GateMiddleXYAdd),
        ("use_encoder_adapter_gating_middle_ia3_add",
         "adapter_gating_middle_ia3_add", IA3Vector),
    )

    def __init__(self, cfg: VLModelConfig, prefix: str,
                 device: Device = "cuda"):
        super().__init__()
        p = cfg.pet
        d = cfg.d_model
        self.cfg, self.prefix = cfg, prefix
        kw = dict(dtype=compute_dtype(cfg), device=device)
        if ((p.use_adapter or p.use_compacter or p.use_lradapter)
                and not p.no_encoder_adapter):
            self.add_module(f"{prefix}_adapter", AdapterController(
                p.adapter_spec(d), phm_W_dims=shared_phm_W_dims(p, d), **kw))
        elif p.use_encoder_adapter_down_multihead:
            self.add_module(f"{prefix}_adapter_multihead", MultiheadDownAdapter(
                d, p.adapter_down_dim, p.encoder_adapter_multihead_num_head,
                **kw))
        if p.use_hyperformer:
            self.adapter_hypernet = _meta_adapter(p, kw["dtype"])
        self.gate = next(((suffix, cls) for flag, suffix, cls in self.GATES
                          if getattr(p, flag)), None)
        if self.gate is not None:
            suffix, cls = self.gate
            self.add_module(f"encoder_{prefix}_{suffix}",
                            build_gate(cls, d, p, **kw))

    def forward(self, y: torch.Tensor, x_pre_norm: torch.Tensor,
                ctx: PetContext, block_w=None) -> torch.Tensor:
        p, mods = self.cfg.pet, self._modules
        serial = mods.get(f"{self.prefix}_adapter")
        multihead = mods.get(f"{self.prefix}_adapter_multihead")
        if serial is not None:
            y = serial(y, ctx)
        elif multihead is not None:
            delta = multihead(y)
            if p.use_encoder_adapter_scaling:
                delta = delta * p.encoder_adapter_scaling_factor
            if p.use_encoder_x2_scaling:
                y = y * p.encoder_x2_scaling_factor
            y = y + delta
        if block_w is not None:
            y = self.adapter_hypernet(y, block_w)
        if self.gate is not None:
            suffix, cls = self.gate
            mod = getattr(self, f"encoder_{self.prefix}_{suffix}")
            if cls is IA3Vector:
                y = y + y * mod().to(y.dtype)
            else:
                y = y * mod(x_pre_norm, y)
        if p.use_encoder_gating_scaling:
            y = y * p.encoder_gating_scaling_factor
        return y


def _meta_adapter(p, dtype) -> MetaLayersAdapterController:
    return MetaLayersAdapterController(
        add_layer_norm_before_adapter=p.add_layer_norm_before_adapter,
        add_layer_norm_after_adapter=p.add_layer_norm_after_adapter,
        dtype=dtype)


class T5Block(nn.Module):
    """Pre-norm block: self-attention [+ cross-attention] + FFN, with the
    encoder hooks after each encoder sublayer and the bf16 clamp at the
    end (vlpet_tpu/models/t5.py:391). A decoder block's sublayer outputs
    go through its serial adapters (``attn_adapter``, ``enc_attn_adapter``
    under ``add_adapter_cross_attn``, ``ff_adapter``; none under
    ``no_decoder_adapter``) and then the hyperformer adapter
    (``adapter_hypernet``), in the JAX order (:524-570)."""

    tp: Optional[ModelShard] = None  # the FFN's hidden-column shard

    def __init__(self, cfg: VLModelConfig, is_decoder: bool = False,
                 has_relative_attention_bias: bool = False,
                 device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        self.cfg, self.is_decoder = cfg, is_decoder
        self.dtype = dt = compute_dtype(cfg)
        self.gated = b.feed_forward_proj == "gated-gelu"
        norm = dict(eps=b.layer_norm_epsilon, dtype=dt, device=device)
        self.self_attn = T5Attention(cfg, "dec_self" if is_decoder
                                     else "enc_self",
                                     has_relative_attention_bias, device)
        self.self_attn_layer_norm = RMSNorm(b.d_model, **norm)
        if is_decoder:
            self.cross_attn = T5Attention(cfg, "cross", device=device)
            self.cross_attn_layer_norm = RMSNorm(b.d_model, **norm)
        self.ff_layer_norm = RMSNorm(b.d_model, **norm)
        kw = dict(use_bias=False, dtype=dt, device=device)
        if self.gated:
            self.wi_0 = TaskDense(b.d_model, b.d_ff, **kw)
            self.wi_1 = TaskDense(b.d_model, b.d_ff, **kw)
        else:
            self.wi = TaskDense(b.d_model, b.d_ff, **kw)
            # the relu kernel's zero biases, as vlpet_tpu/models/t5.py:495
            dev = resolve_device(device)
            self.register_buffer("zero_b1", torch.zeros(b.d_ff, device=dev),
                                 persistent=False)
            self.register_buffer("zero_b2",
                                 torch.zeros(b.d_model, device=dev),
                                 persistent=False)
        self.wo = TaskDense(b.d_ff, b.d_model, **kw)
        self.ffn_width = b.d_ff
        p = cfg.pet
        if not is_decoder:
            self.attn_hooks = T5EncoderHooks(cfg, "attn", device)
            self.ff_hooks = T5EncoderHooks(cfg, "ff", device)
        else:
            if ((p.use_adapter or p.use_compacter or p.use_lradapter)
                    and not p.no_decoder_adapter):
                names = (("attn_adapter", "enc_attn_adapter", "ff_adapter")
                         if p.add_adapter_cross_attn
                         else ("attn_adapter", "ff_adapter"))
                for name in names:
                    self.add_module(name, AdapterController(
                        p.adapter_spec(b.d_model),
                        phm_W_dims=shared_phm_W_dims(p, b.d_model), dtype=dt,
                        device=device))
            if p.use_hyperformer:
                self.adapter_hypernet = _meta_adapter(p, dt)

    def shard_(self, shard: ModelShard) -> None:
        """Hold this rank's FFN hidden columns (models/bart.py
        ``shard_ffn``)."""
        if self.gated:
            shard_ffn(self, shard, ("wi_0", "wi_1"), "wo")
        else:
            shard_ffn(self, shard, ("wi",), "wo", buffers=("zero_b1",))

    def _ff(self, x: torch.Tensor, rate: float = 0.0,
            seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The FFN with its hidden dropout: the kernels (F1/F2 relu, F3/F4
        gated) unless ``use_fused_ffn`` is off or the language model trains
        (the kernels give no weight gradient), as BART's ``_ffn``; a
        sharded block's hidden columns, wo row-parallel."""
        c, tp = self.cfg, self.tp
        fused = c.use_fused_ffn and not c.pet.unfreeze_language_model
        cols = {}
        if tp is not None:
            x = copy_to_model(x, tp)
            cols = dict(col_base=tp.base(self.ffn_width),
                        width=self.ffn_width)
        x2 = x.reshape(-1, x.shape[-1])
        if self.gated:
            fn = (route(fused_gated_ffn, gated_ffn_reference) if fused
                  else gated_ffn_reference)
            y = fn(x2, self.wi_0.weight, self.wi_1.weight, self.wo.weight,
                   "gelu_new", rate, seed, **cols)
        else:
            fn = route(fused_ffn, ffn_reference) if fused else ffn_reference
            y = fn(x2, self.wi.weight, self.zero_b1, self.wo.weight,
                   self.zero_b2, "relu", rate, seed, **cols)
        if tp is not None:
            y = end_of_shard(y, None, tp)
        return y.reshape(x.shape)

    def _adapt(self, y: torch.Tensor, name: str, block, part: str,
               ctx: PetContext) -> torch.Tensor:
        """A decoder sublayer's output through its serial adapter ``name``
        and the hyperformer adapter with ``part`` of the block's weights,
        where the block has them."""
        adapter = self._modules.get(name)
        if adapter is not None:
            y = adapter(y, ctx)
        if block is not None and getattr(block, part) is not None:
            y = self.adapter_hypernet(y, getattr(block, part))
        return y

    def _res_drop(self, y: torch.Tensor,
                  seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """Residual-branch hash dropout (vlpet_tpu/models/t5.py:460)."""
        if seeds is None:
            return y
        return hash_dropout(y, seeds.next_for(_per_example(y)),
                            self.cfg.backbone.dropout_rate)

    def forward(self, hidden_states: torch.Tensor, ctx: PetContext,
                mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, causal: bool = False,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache: Optional[Cache] = None,
                decode_pos: Optional[int] = None,
                beam_anc: Optional[torch.Tensor] = None,
                seeds: Optional[DropoutSeeds] = None,
                prompt_len: int = 0) -> torch.Tensor:
        """``seeds`` (training) drives, in this order, the self-attention's
        probability and residual dropout, the cross-attention's (decoder),
        and the FFN's hidden and residual dropout. ``ctx.block_adapters``:
        the layer's hypernet-generated adapter weights. ``prompt_len`` P:
        the first P rows are the decoder input prompt, which the cross
        block leaves as they were (vlpet_tpu/models/t5.py:552-558)."""
        rate = self.cfg.backbone.dropout_rate if seeds is not None else 0.0
        block = ctx.block_adapters
        x = hidden_states
        y = self.self_attn(self.self_attn_layer_norm(x), ctx, mask=mask,
                           bias=bias, causal=causal, cache=cache,
                           decode_pos=decode_pos, beam_anc=beam_anc,
                           rate=rate, seed=_seed(seeds, x.shape[1] ** 2))
        if not self.is_decoder:
            y = self.attn_hooks(y, x, ctx,
                                block.self_attention if block else None)
        else:
            y = self._adapt(y, "attn_adapter", block, "self_attention", ctx)
        h = x + self._res_drop(y, seeds)
        if self.is_decoder and (encoder_hidden_states is not None
                                or cross_kv is not None):
            x = h
            S = (encoder_hidden_states if encoder_hidden_states is not None
                 else cross_kv[0]).shape[1]
            y = self.cross_attn(self.cross_attn_layer_norm(x), ctx,
                                mask=cross_mask, cross_kv=cross_kv,
                                kv_states=encoder_hidden_states, rate=rate,
                                seed=_seed(seeds, x.shape[1] * S))
            y = self._adapt(y, "enc_attn_adapter", block, "cross_attention",
                            ctx)
            h = x + self._res_drop(y, seeds)
            if prompt_len:
                h = torch.cat([x[:, :prompt_len], h[:, prompt_len:]], 1)
        x = h
        y = self._ff(self.ff_layer_norm(x), rate,
                     _seed(seeds, x.shape[1] * self.cfg.backbone.d_ff))
        if not self.is_decoder:
            y = self.ff_hooks(y, x, ctx, block.feed_forward if block else None)
        else:
            y = self._adapt(y, "ff_adapter", block, "feed_forward", ctx)
        h = x + self._res_drop(y, seeds)
        if self.dtype != torch.float32:
            clamp = torch.finfo(self.dtype).max - 1000
            h = torch.clamp(h, -clamp, clamp)
        return h


def _blocks(module: nn.Module, n: int) -> List[T5Block]:
    return [getattr(module, f"blocks_{i}") for i in range(n)]


def _layer_blocks(hypernet, task_embedding, n: int) -> Tuple:
    """Each layer's hypernet-generated adapter weights (None per layer
    without a hypernet)."""
    return tuple(hypernet(task_embedding, i) if hypernet is not None
                 else None for i in range(n))


class T5JointEncoder(nn.Module):
    """T5 encoder over [prompt; text; visual] tokens with the
    block-diagonal relative bias (vlpet_tpu/models/t5.py:580): the encoder
    prompt (``prompt_modules``) goes before the text and the text's
    relative bias spans both; under ``use_hyperformer`` the stack's
    ``adapter_layers_hyper_net`` generates each block's adapter weights."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b, v, p = cfg.backbone, cfg.vis, cfg.pet
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        if p.encoder_prompt_len > 0:
            # init_std None: a normal(0, 1) table, torch-default denses
            self.prompt_modules = prompt_controller(
                cfg, p.encoder_prompt_len, None, dt, device)
        if p.use_hyperformer:
            self.adapter_layers_hyper_net = stack_hypernet(
                cfg, b.num_layers, False, dtype=dt, device=device)
        self.n_layers = b.num_layers
        for i in range(b.num_layers):
            self.add_module(f"blocks_{i}", T5Block(
                cfg, is_decoder=False, has_relative_attention_bias=i == 0,
                device=device))
        self.final_layer_norm = RMSNorm(b.d_model, eps=b.layer_norm_epsilon,
                                        dtype=dt, device=device)
        if not v.no_vis:
            self.visual_embedding = visual_embedding_class(v)(
                v, b.d_model, dtype=dt, device=device, t5_style_ln=True)

    def blocks(self) -> List[T5Block]:
        return _blocks(self, self.n_layers)

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
        ``seeds`` (training) drives the embedding dropout, every block's
        sites and the dropout of the final states. ``sparse`` (a training
        call under ``vis.sparse_sample``): the visual tokens are
        subsampled to ``n_boxes`` with scores from ``sparse_generator``
        (vlpet_tpu/models/t5.py:667-670)."""
        v = self.cfg.vis
        rate = self.cfg.backbone.dropout_rate
        dt = self.dtype
        ctx = ctx or PetContext()
        B = input_ids.shape[0]
        h = shared_embedding[input_ids].to(dt)
        if "prompt_modules" in self._modules:
            prefix = self.prompt_modules(B, ctx.task_idx).to(dt)
            h = torch.cat([prefix, h], dim=1)
            attention_mask = torch.cat([attention_mask.new_ones(
                (B, prefix.shape[1])), attention_mask], dim=1)
        L = h.shape[1]
        mask = attention_mask
        if not v.no_vis and vis_feats is not None:
            vis_embeds = self.visual_embedding.tokens(
                vis_feats, boxes, shared_embedding, img_order_ids,
                obj_order_ids)
            if sparse:
                n, base = vis_embeds.shape[0], ctx.example_base
                scores = sparse_scores(
                    (ctx.global_batch or n, vis_embeds.shape[1]),
                    sparse_generator, h.device)[base:base + n]
                vis_embeds = sparse_sample(vis_embeds, v.n_boxes, scores)
            h = torch.cat([h, vis_embeds], dim=1)
            mask = joint_attention_mask(attention_mask, vis_embeds.shape[1],
                                        vis_attention_mask)
        if seeds is not None:
            h = hash_dropout(h, seeds.next_for(_per_example(h)), rate)
        # the (B, 1, 1, S) padding mask stays apart from the (1, H, S, S)
        # bias: text-text pairs get the T5 bias, pairs with a visual token 0
        pad_mask = expand_mask(mask, 1, dt).float()
        blocks = self.blocks()
        text_bias = blocks[0].self_attn.compute_bias(L, L)
        S = h.shape[1]
        bias = torch.zeros((1, text_bias.shape[1], S, S), dtype=dt,
                           device=h.device)
        bias[:, :, :L, :L] = text_bias
        bias = bias.float()  # the kernels take fp32: the same dt values
        for blk, block in zip(blocks, _layer_blocks(
                self._modules.get("adapter_layers_hyper_net"),
                task_embedding, self.n_layers)):
            h = blk(h, ctx.for_layer(block), mask=pad_mask, bias=bias,
                    seeds=seeds)
        h = self.final_layer_norm(h)
        if seeds is not None:
            h = hash_dropout(h, seeds.next_for(_per_example(h)), rate)
        return h, mask


class T5Decoder(nn.Module):
    """T5 decoder stack: ``forward`` is one incremental decode step,
    ``teacher_force`` the whole target sequence. The decoder input prompt
    (``prompt_modules``, ``decoder_prompt_len`` P) goes before the inputs
    in training, its rows at relative positions 0..P-1 and left alone by
    the cross block, and is dropped before the final norm; generation
    prefills its dry-run K/V (``prefill_kvs``) and decodes from P
    (vlpet_tpu/models/t5.py:753-873). Under ``use_hyperformer`` the stack's
    ``adapter_layers_hyper_net`` generates each block's adapter weights
    (``block_adapters``: once per generation, and in every training
    pass)."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b, p = cfg.backbone, cfg.pet
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        if p.decoder_prompt_len > 0:
            self.prompt_modules = prompt_controller(
                cfg, p.decoder_prompt_len, None, dt, device)
        if p.use_hyperformer:
            self.adapter_layers_hyper_net = stack_hypernet(
                cfg, b.num_decoder_layers, p.add_adapter_cross_attn,
                dtype=dt, device=device)
        self.n_layers = b.num_decoder_layers
        for i in range(b.num_decoder_layers):
            self.add_module(f"blocks_{i}", T5Block(
                cfg, is_decoder=True, has_relative_attention_bias=i == 0,
                device=device))
        self.final_layer_norm = RMSNorm(b.d_model, eps=b.layer_norm_epsilon,
                                        dtype=dt, device=device)

    def blocks(self) -> List[T5Block]:
        return _blocks(self, self.n_layers)

    def block_adapters(self, task_embedding: Optional[torch.Tensor]) -> Tuple:
        return _layer_blocks(self._modules.get("adapter_layers_hyper_net"),
                             task_embedding, self.n_layers)

    def forward(self, input_ids: torch.Tensor, shared_embedding: torch.Tensor,
                encoder_attention_mask: torch.Tensor, ctx: PetContext,
                cross_kvs: Tuple, cache: Tuple[Cache, ...], decode_pos: int,
                beam_anc: Optional[torch.Tensor] = None,
                layer_blocks: Optional[Tuple] = None) -> torch.Tensor:
        """One decode step: input_ids (B, 1) at ``decode_pos``. With
        ``beam_anc`` (B_true, K, L_cache) the self-attention takes the
        reorder-free beam path (its ancestry carries the causal limit and
        the bias row rides through D1); greedy adds the causal mask to the
        bias row. ``layer_blocks``: ``block_adapters()``, built once per
        sequence. Returns hidden (B, 1, d)."""
        dt = self.dtype
        h = shared_embedding[input_ids].to(dt)
        blocks = self.blocks()
        max_len = cache[0]["k"].shape[0]
        # the kernels take fp32: the dt-rounded row, built once per step
        self_bias = blocks[0].self_attn.compute_bias_row(decode_pos,
                                                         max_len).float()
        if beam_anc is None:
            j = torch.arange(max_len, device=h.device)[None, None, None, :]
            self_bias = self_bias + torch.where(j <= decode_pos, 0.0, NEG_INF)
        cross_mask = expand_mask(encoder_attention_mask, 1, dt)
        for blk, kv, c, block in zip(blocks, cross_kvs, cache,
                                     layer_blocks or (None,) * len(blocks)):
            h = blk(h, ctx.for_layer(block), bias=self_bias,
                    cross_mask=cross_mask, cross_kv=kv, cache=c,
                    decode_pos=decode_pos, beam_anc=beam_anc)
        return self.final_layer_norm(h)

    def teacher_force(self, input_ids: torch.Tensor,
                      shared_embedding: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      encoder_attention_mask: torch.Tensor,
                      ctx: PetContext,
                      seeds: Optional[DropoutSeeds] = None,
                      task_embedding: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The whole target sequence (B, T), after the decoder input
        prompt: the relative bias plus the causal triangle, in-kernel, and
        cross-attention over the encoder states. ``seeds`` (training)
        drives the embedding dropout, every block's sites and the dropout
        of the final states. Returns (B, T, d)."""
        dt = self.dtype
        rate = self.cfg.backbone.dropout_rate
        B = input_ids.shape[0]
        h = shared_embedding[input_ids].to(dt)
        P = 0
        if "prompt_modules" in self._modules:
            prompt = self.prompt_modules(B, ctx.task_idx).to(dt)
            P = prompt.shape[1]
            h = torch.cat([prompt, h], dim=1)
        if seeds is not None:
            h = hash_dropout(h, seeds.next_for(_per_example(h)), rate)
        blocks = self.blocks()
        T = h.shape[1]
        bias = blocks[0].self_attn.compute_bias(T, T).float()
        cross_mask = expand_mask(encoder_attention_mask, 1, dt)
        for blk, block in zip(blocks, self.block_adapters(task_embedding)):
            h = blk(h, ctx.for_layer(block), bias=bias, causal=True,
                    encoder_hidden_states=encoder_hidden_states,
                    cross_mask=cross_mask, seeds=seeds, prompt_len=P)
        h = self.final_layer_norm(h[:, P:] if P else h)
        if seeds is not None:
            h = hash_dropout(h, seeds.next_for(_per_example(h)), rate)
        return h

    def compute_cross_kvs(self, encoder_hidden_states: torch.Tensor,
                          ctx: PetContext):
        """Per-block cross-attention K/V (VPA included), once per sequence."""
        return tuple(blk.cross_attn.compute_cross_kv(encoder_hidden_states, ctx)
                     for blk in self.blocks())

    def prefill_kvs(self, batch_size: int, ctx: PetContext,
                    task_embedding: Optional[torch.Tensor] = None):
        """Per block the self-attention (k, v), each (B, P, H*Dh), of the
        decoder input prompt's dry run (vlpet_tpu/models/t5.py:843
        ``compute_prompt_kvs``): the prompt through every block without
        its cross section, causal, with the relative bias over P; or None
        without a decoder prompt."""
        if "prompt_modules" not in self._modules:
            return None
        h = self.prompt_modules(batch_size, ctx.task_idx).to(self.dtype)
        blocks = self.blocks()
        P = h.shape[1]
        bias = blocks[0].self_attn.compute_bias(P, P).float()
        kvs = []
        for blk, block in zip(blocks, self.block_adapters(task_embedding)):
            x = blk.self_attn_layer_norm(h)  # T5 projects the normed input
            kvs.append((blk.self_attn.k(x), blk.self_attn.v(x)))
            h = blk(h, ctx.for_layer(block), bias=bias, causal=True)
        return tuple(kvs)


class T5DecodeConsts(NamedTuple):
    """The loop invariants of one generation, built once by
    ``VLT5.init_decode``: per decoder block the cross-attention K/V
    (B, S, H*Dh) and the hypernet-generated adapter weights (None without
    the hyperformer), and the LM-head weight as fp32."""
    cross_kvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    blocks: Tuple
    logits_weight: torch.Tensor


class VLT5Model(nn.Module):
    """Encoder-decoder glue: shared embedding, joint encoder, decoder and,
    under ``use_hyperformer``, the task embedding (``shared_task_embed``,
    vlpet_tpu/models/t5.py:887-900)."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        self.shared = nn.Parameter(torch.empty((b.vocab_size, b.d_model),
                                               device=resolve_device(device)))
        self.encoder = T5JointEncoder(cfg, device=device)
        self.decoder = T5Decoder(cfg, device=device)
        if cfg.pet.use_hyperformer:
            self.shared_task_embed = TaskEmbeddingController(
                cfg.pet.hyperformer_spec(), cfg.pet.tasks, device=device)

    def task_embedding(self, ctx: PetContext) -> Optional[torch.Tensor]:
        embed = self._modules.get("shared_task_embed")
        return embed(ctx.task_idx) if embed is not None else None


def check_t5_supported(cfg: VLModelConfig) -> None:
    """``check_supported``, and the flags the JAX T5 does not read: it
    would build the model without them. They are the BART-only VL-PET
    flags (``BART_ONLY_PET_FLAGS``, ``expand_vis_embedding``) and the
    prefix and LM-head flags (``T5_UNREAD_FLAGS``: ``use_attn_prefix``,
    under which the JAX T5 still builds the input prompts,
    ``use_vis_prefix``, ``use_lm_head_adapter``)."""
    check_supported(cfg)
    bad = [f for f in BART_ONLY_PET_FLAGS + T5_UNREAD_FLAGS
           if getattr(cfg.pet, f, False) or getattr(cfg.vis, f, False)]
    if cfg.vis.expand_vis_embedding:
        bad.append("expand_vis_embedding")
    if bad:
        raise NotImplementedError(
            f"BART-only, not read by the JAX T5 (vlpet_tpu/models/t5.py): "
            f"{', '.join(bad)}")


class VLT5(nn.Module):
    """Seq2seq LM head over VLT5Model (vlpet_tpu/models/t5.py:930). Built
    on the card unless ``device`` says otherwise. ``forward`` trains
    (``deterministic=False``, with autograd) or evaluates; the generation
    methods run without autograd."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        if not cfg.is_t5:
            raise ValueError("VLT5 needs a T5 backbone; build VLBart")
        check_t5_supported(cfg)
        dev = resolve_device(device)
        b = cfg.backbone
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.model = VLT5Model(cfg, device=dev)
        if not b.tie_word_embeddings:
            # flax nn.Dense without a dtype: fp32 params, fp32 product
            self.lm_head = TaskDense(b.d_model, b.vocab_size, use_bias=False,
                                     device=dev)
        # Compacter's model-shared rule and slow weights
        # (vlpet_tpu/models/t5.py:949-971)
        p = cfg.pet
        if p.use_compacter and p.shared_phm_rule:
            pd = p.hypercomplex_division
            self.phm_rule = nn.Parameter(torch.empty(
                (pd, pd, pd), dtype=self.dtype, device=dev))
        if p.use_compacter and p.shared_W_phm:
            make_shared_phm_W(self, p, b.d_model, dtype=self.dtype,
                              device=dev)
        if cfg.classifier:  # vlpet_tpu/models/t5.py:956-965
            self.answer_head = AnswerHead(b.d_model, cfg.num_answers,
                                          b.initializer_factor * 0.02,
                                          device=dev)
        self.eval()

    def _ctx(self, ctx: Optional[PetContext]) -> PetContext:
        """The call's PetContext with Compacter's model-shared rule and
        slow weights injected (vlpet_tpu/models/t5.py:973-979)."""
        ctx = ctx or PetContext()
        p = self.cfg.pet
        if p.use_compacter and p.shared_phm_rule and ctx.phm_rule is None:
            ctx = dataclasses.replace(ctx, phm_rule=self.phm_rule)
        if p.use_compacter and p.shared_W_phm and ctx.phm_W is None:
            ctx = dataclasses.replace(ctx, phm_W=shared_phm_W(self, p))
        return ctx

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VLT5":
        """Seeded random init with the JAX package's T5 scheme: normal
        with the Mesh-TF std of each backbone matrix (q f*(d*d_kv)^-0.5;
        k, v, wi f*d^-0.5; o f*inner^-0.5; wo f*d_ff^-0.5; the relative
        bias f*d^-0.5; ``shared`` and ``lm_head`` f), RMSNorm scales 1, the
        image-order table normal(0, 0.02), and the torch Linear default
        U(+-1/sqrt(fan_in)) for the visual projections and the PET modules,
        normal(0, 0.02) for middle-Y's vector, LayerNorm biases 0; then the
        PET modules' own initialisers (``init_params``: Compacter, the
        low-rank adapter, the prompt tables' normal(0, 1), the hypernets)
        and Compacter's root weights (normal(0, phm_init_range) rule,
        glorot slow weights); then the recipe's re-inits
        (train/freezing.py ``weight_initialization``)."""
        b = self.cfg.backbone
        f, d, inner = b.initializer_factor, b.d_model, b.num_heads * b.d_kv
        std = {"q": f * (d * b.d_kv) ** -0.5, "k": f * d ** -0.5,
               "v": f * d ** -0.5, "o": f * inner ** -0.5,
               "wi": f * d ** -0.5, "wi_0": f * d ** -0.5,
               "wi_1": f * d ** -0.5, "wo": f * b.d_ff ** -0.5,
               "relative_attention_bias": f * d ** -0.5, "shared": f,
               "lm_head": f, "img_order_embedding": 0.02,
               "gating_middle_ia3": 0.02}
        fan_in = {}
        for mname, mod in self.named_modules():
            if isinstance(mod, TaskDense):
                for leaf in ("weight", "bias"):
                    fan_in[f"{mname}.{leaf}"] = mod.in_dim
            elif isinstance(mod, MultiheadDownAdapter):
                for leaf in ("down_kernel", "down_bias"):
                    fan_in[f"{mname}.{leaf}"] = mod.d
            elif isinstance(mod, LowRankVisualEmbedding):
                fan_in[f"{mname}.visual_projector_multihead_down_kernel"] = (
                    mod.vis.feat_dim)
        pending = set()
        for name, p in self.named_parameters():
            parts = name.split(".")
            key = parts[-2] if parts[-1] == "weight" else parts[-1]
            if parts[-1] == "scale":
                p.fill_(1.0)
            elif key == "visual_projector_multihead_down_bias":
                p.zero_()  # flax zeros (vlpet_tpu/models/visual.py:212)
            elif key in std and not (key in ("q", "k", "v", "o") and
                                     parts[-3] not in ("self_attn",
                                                       "cross_attn")):
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std[key])
            elif name in fan_in:
                bound = fan_in[name] ** -0.5
                p.copy_((torch.rand(p.shape, generator=generator,
                                    device=generator.device) * 2 - 1) * bound)
            elif parts[-1] == "bias":  # a LayerNorm's
                p.zero_()
            else:
                pending.add(name)
        for mname, m in self.named_modules():
            if hasattr(m, "init_params"):
                m.init_params(generator)
                pending -= {f"{mname}.{n}" if mname else n
                            for n, _ in m.named_parameters(recurse=False)}
        pet = self.cfg.pet
        for name, p in self.named_parameters(recurse=False):
            if name == "phm_rule":
                normal_(p, pet.phm_init_range, generator)
            elif name.startswith("phm_W_"):
                glorot_uniform_gain2_(p, generator)
            pending.discard(name)
        if pending:
            raise ValueError(f"no initialiser for {sorted(pending)}")
        weight_initialization(self, pet)
        return self

    def logits_weight(self) -> torch.Tensor:
        """The LM-head weight as fp32: the tied ``shared`` rounded to the
        compute dtype, or the untied fp32 ``lm_head``."""
        if self.cfg.backbone.tie_word_embeddings:
            return self.model.shared.to(self.dtype).float()
        return self.lm_head.weight.float()

    def _logits(self, dec_out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """fp32 logits (vlpet_tpu/models/t5.py:981): tied, the rescaled
        compute-dtype states times the compute-dtype weight in fp32; untied,
        the states in fp32 times the fp32 ``lm_head``."""
        b = self.cfg.backbone
        if b.tie_word_embeddings:
            dec_out = dec_out * (b.d_model ** -0.5)
        return dec_out.float() @ w.t()

    # --- training ------------------------------------------------------------

    def dropout_sites(self) -> int:
        """Dropout seeds one training step draws, consumed in this order:
        the encoder's embedding dropout; per encoder block the
        self-attention's probabilities and residual, the FFN's hidden and
        residual; the encoder's final states; the decoder's embedding
        dropout; per decoder block the self-attention's probabilities and
        residual, the cross-attention's, the FFN's hidden and residual; the
        decoder's final states."""
        b = self.cfg.backbone
        return 4 + 4 * b.num_layers + 6 * b.num_decoder_layers

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                vis_feats: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                decoder_input_ids: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None, deterministic: bool = True,
                labels: Optional[torch.Tensor] = None, img_order_ids=None,
                obj_order_ids=None, vis_attention_mask=None,
                generator: Optional[torch.Generator] = None,
                reduce_loss: bool = False) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (vlpet_tpu/models/t5.py:1006-1067) on
        ``decoder_input_ids`` or on ``labels`` shifted right. Returns
        {"logits", "encoder_last_hidden_state"} and, with labels, "loss":
        per-token (B, T) fp32, or the mean over valid tokens when
        ``reduce_loss``. ``deterministic=False`` trains: autograd on,
        dropout with one seed per site drawn from ``generator``
        (``dropout_sites``); otherwise no autograd. On the bf16 linear_ce
        route "logits" is the bf16 copy the loss keeps; on the
        ``use_fused_ce`` route (``_ce``) the output has no "logits": the
        fused loss never forms them (under jit the JAX package's logits
        there are dead code; eagerly they would be the (B, T, V) fp32
        tensor the flag exists to avoid)."""
        b = self.cfg.backbone
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("forward needs labels or decoder_input_ids")
            decoder_input_ids = shift_tokens_right(
                labels, b.pad_token_id, b.decoder_start_token_id)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not deterministic):
            enc, joint_mask, dec = self._run(
                input_ids, attention_mask, decoder_input_ids, vis_feats, boxes,
                ctx, deterministic, generator, img_order_ids, obj_order_ids,
                vis_attention_mask)
            out = {"encoder_last_hidden_state": enc}
            if "answer_head" in self._modules:
                out["answer_logits"] = self.answer_head(dec[:, -1])
            if labels is None:
                out["logits"] = self._logits(dec, self.logits_weight())
            else:
                out["loss"], logits = self._ce(dec, labels, reduce_loss)
                if logits is not None:
                    out["logits"] = logits
            return out

    def _run(self, input_ids, attention_mask, decoder_input_ids, vis_feats,
             boxes, ctx, deterministic: bool, generator, img_order_ids=None,
             obj_order_ids=None, vis_attention_mask=None):
        """(encoder states, joint mask, decoder states) of one teacher-forced
        pass; a training one (``deterministic`` False) draws the step's
        dropout seeds, then ``vis.sparse_sample``'s scores, from
        ``generator``."""
        ctx = self._ctx(ctx)
        seeds = None
        if not deterministic and self.cfg.backbone.dropout_rate > 0:
            seeds = DropoutSeeds(self.dropout_sites(), generator,
                                 input_ids.device)
            seeds.example_base = ctx.example_base
        task_embedding = self.model.task_embedding(ctx)
        enc, joint_mask = self.model.encoder(
            input_ids, attention_mask, self.model.shared,
            vis_feats=vis_feats, boxes=boxes, img_order_ids=img_order_ids,
            obj_order_ids=obj_order_ids,
            vis_attention_mask=vis_attention_mask, ctx=ctx, seeds=seeds,
            task_embedding=task_embedding, sparse_generator=generator,
            sparse=self.cfg.vis.sparse_sample and not deterministic)
        dec = self.model.decoder.teacher_force(
            decoder_input_ids, self.model.shared, enc, joint_mask, ctx,
            seeds, task_embedding)
        return enc, joint_mask, dec

    def classify(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 vis_feats: Optional[torch.Tensor] = None,
                 boxes: Optional[torch.Tensor] = None,
                 img_order_ids=None, obj_order_ids=None,
                 ctx: Optional[PetContext] = None, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The classifier head's forward (vlpet_tpu/models/t5.py:1070-1085):
        one ``decoder_start_token_id`` (= pad) a row through the decoder,
        the answer logits (B, num_answers) fp32 of its state; autograd on
        only when training (``deterministic`` False), as ``forward``."""
        B = input_ids.shape[0]
        dec_ids = torch.full((B, 1), self.cfg.backbone.decoder_start_token_id,
                             dtype=torch.long, device=input_ids.device)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not deterministic):
            _, _, dec = self._run(input_ids, attention_mask, dec_ids,
                                  vis_feats, boxes, ctx, deterministic,
                                  generator, img_order_ids, obj_order_ids)
            return self.answer_head(dec[:, -1])

    def _ce(self, dec_out: torch.Tensor, labels: torch.Tensor,
            reduce_loss: bool):
        """(loss, logits or None), routed as
        vlpet_tpu/models/t5.py:1030-1067. The tied, frozen head takes
        ``fused_linear_ce`` (C1/C2) on the rescaled states with a zero bias
        under ``use_fused_ce``, in bf16 and fp32 alike, and then no logits
        exist (None); else, in bf16, ``linear_ce`` (one bf16 logits copy).
        Otherwise -- the gated/untied head ignores the flag, as in JAX --
        CE over the fp32 logits."""
        b, p = self.cfg.backbone, self.cfg.pet
        head_frozen = (b.tie_word_embeddings and not p.unfreeze_lm_head
                       and not p.unfreeze_language_model)
        B, T = labels.shape
        if head_frozen and (self.cfg.use_fused_ce
                            or dec_out.dtype == torch.bfloat16):
            x2 = (dec_out * (b.d_model ** -0.5)).reshape(B * T, -1)
            zero_b = torch.zeros(b.vocab_size, dtype=torch.float32,
                                 device=dec_out.device)
            if self.cfg.use_fused_ce:
                fn = route(fused_linear_ce, fused_linear_ce_plain)
                nll, _ = fn(x2, self.model.shared, zero_b, labels.reshape(-1))
                logits = None
            else:
                nll, logits = linear_ce(x2, self.model.shared, zero_b,
                                        labels.reshape(-1))
                logits = logits.reshape(B, T, -1)
            return mean_or_per_token(nll.reshape(B, T), labels,
                                     reduce_loss), logits
        logits = self._logits(dec_out, self.logits_weight())
        return cross_entropy_with_ignore(logits, labels, reduce_loss), logits

    # --- generation-facing methods ------------------------------------------

    @torch.no_grad()
    def encode(self, input_ids, attention_mask, vis_feats=None, boxes=None,
               img_order_ids=None, obj_order_ids=None, vis_attention_mask=None,
               ctx: Optional[PetContext] = None):
        ctx = self._ctx(ctx)
        return self.model.encoder(input_ids, attention_mask, self.model.shared,
                                  vis_feats=vis_feats, boxes=boxes,
                                  img_order_ids=img_order_ids,
                                  obj_order_ids=obj_order_ids,
                                  vis_attention_mask=vis_attention_mask,
                                  ctx=ctx,
                                  task_embedding=self.model.task_embedding(ctx))

    @torch.no_grad()
    def init_decode(self, encoder_hidden_states,
                    ctx: Optional[PetContext] = None) -> T5DecodeConsts:
        """The cross-attention K/V (B, S, H*Dh) of every decoder block, its
        hypernet-generated adapter weights (the JAX package regenerates
        them every step: the same values) and the fp32 LM-head weight."""
        ctx = self._ctx(ctx)
        decoder = self.model.decoder
        return T5DecodeConsts(
            decoder.compute_cross_kvs(encoder_hidden_states, ctx),
            decoder.block_adapters(self.model.task_embedding(ctx)),
            self.logits_weight())

    @torch.no_grad()
    def prefill_kvs(self, batch_size: int,
                    ctx: Optional[PetContext] = None):
        """Per decoder block the (k, v) (B, P, H*Dh) of the decoder input
        prompt's dry run (``T5Decoder.prefill_kvs``), or None."""
        ctx = self._ctx(ctx)
        return self.model.decoder.prefill_kvs(
            batch_size, ctx, self.model.task_embedding(ctx))

    @torch.no_grad()
    def decode_step(self, decoder_input_ids, joint_mask,
                    consts: T5DecodeConsts, cache, decode_pos: int,
                    ctx: Optional[PetContext] = None, beam_anc=None):
        """One decode step -> (logits (B, V) f32, cache)."""
        dec_out = self.model.decoder(decoder_input_ids, self.model.shared,
                                     joint_mask, self._ctx(ctx),
                                     consts.cross_kvs, cache, decode_pos,
                                     beam_anc, consts.blocks)
        return self._logits(dec_out[:, -1, :], consts.logits_weight), cache

    @torch.no_grad()
    def decode_step_topk(self, decoder_input_ids, joint_mask,
                         consts: T5DecodeConsts, cache, decode_pos: int,
                         k: int, ctx: Optional[PetContext] = None,
                         beam_anc=None):
        """Decode step -> (top_vals (B, k) f32, top_toks (B, k) int32,
        lse (B,) f32, cache), through T1 (or its plain twin)."""
        logits, cache = self.decode_step(decoder_input_ids, joint_mask,
                                         consts, cache, decode_pos, ctx,
                                         beam_anc)
        vals, toks, lse = topk_lse(logits, k)
        return vals, toks, lse, cache
