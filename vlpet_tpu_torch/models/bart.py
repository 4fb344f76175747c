"""BART encoder/decoder with the VL-PET-large hooks, ported from
vlpet_tpu/models/bart.py.

Ported: the joint encoder (text + visual concat) with the multihead down
adapter and low-rank gate after each sublayer; the teacher-forcing decoder
of training (causal self-attention, cross-attention over the encoder
states with the value-parallel adapter on V); the incremental decoder
(greedy and reorder-free beam); and the training-time dropout: the
embedding dropout and the residual dropout before each post-LN, all from
the hash mask of ops/hashdrop.py with one seed per site (``DropoutSeeds``).
Layers are registered as ``layers_{i}`` like the flax tree. Branches of the
hook surface that the slice does not cover raise NotImplementedError when
the model is built (models/vlbart.py check_supported).

Kernel call sites: every attention but the beam self-attention goes through
ops.attention.fused_attention (A1 forward; A6 or, at the video path's long
sequences, the long backward, as ops.attention.backward_route picks), every
FFN through
ops.ffn.fused_ffn (F1, F2) unless the language model trains or
``use_fused_ffn`` is off, every dropping residual LayerNorm through
ops.fused_ln.fused_dropout_add_ln (L1, L2), beam self-attention through
ops.decode.beam_decode_attend (D1) or, with ``use_fused_beam``,
ops.decode.beam_decode_attend_update (D2, which also writes the cache
slot), every other decode-step KV write through
ops.cache_update.cache_slots_update (U1, K and V in one launch), each
picked by ops.route (the plain twins inside ``ops.plain_twins()``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm, layer_norm
from vlpet_tpu_torch.models.visual import (VisualEmbedding,
                                           joint_attention_mask)
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
from vlpet_tpu_torch.ops.hashdrop import DropoutSeeds, hash_dropout
from vlpet_tpu_torch.pet.modules import (AdapterController, GateLargeXLowRank,
                                         MultiheadDownAdapter, PetContext,
                                         TaskDense)

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


def _seed(seeds: Optional[DropoutSeeds]) -> Optional[torch.Tensor]:
    """The next dropout site's seed, or None when not dropping."""
    return seeds.next() if seeds is not None else None


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


def _ffn(layer: nn.Module, x: torch.Tensor, act: str) -> torch.Tensor:
    """fc1 -> act -> fc2 of a layer: through F1/F2 (or their plain twin),
    or the plain chain when ``use_fused_ffn`` is off or the language model
    trains (the kernels have no weight gradient), as in the JAX package."""
    c = layer.cfg
    fn = (route(fused_ffn, ffn_reference)
          if c.use_fused_ffn and not c.pet.unfreeze_language_model
          else ffn_reference)
    y = fn(x.reshape(-1, x.shape[-1]), layer.fc1.weight, layer.fc1.bias,
           layer.fc2.weight, layer.fc2.bias, act)
    return y.reshape(x.shape)


class BartAttention(nn.Module):
    """Multi-head attention in one of three roles: 'enc_self' (full
    sequence), 'dec_self' (causal over the target sequence in training,
    incremental over the KV cache in decoding) and 'cross' (over the
    encoder states, or over precomputed cross K/V in decoding)."""

    def __init__(self, cfg: VLModelConfig, embed_dim: int, num_heads: int,
                 role: str, device: Device = "cuda"):
        super().__init__()
        p = cfg.pet
        self.cfg, self.role = cfg, role
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = self.head_dim ** -0.5
        dt = compute_dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.q_proj = TaskDense(embed_dim, embed_dim, **kw)
        self.k_proj = TaskDense(embed_dim, embed_dim, **kw)
        self.v_proj = TaskDense(embed_dim, embed_dim, **kw)
        self.out_proj = TaskDense(embed_dim, embed_dim, **kw)
        self.has_vpa = (role == "cross" and
                        p.use_decoder_enc_attn_value_parallel_adapter_down_dim)
        if self.has_vpa:
            scaling = (p.decoder_enc_attn_value_parallel_adapter_scaling_factor
                       if p.use_decoder_enc_attn_value_parallel_adapter_scaling
                       else None)
            spec = p.down_dim_spec(
                embed_dim, p.decoder_enc_attn_value_parallel_adapter_down_dim,
                parallel=True, scaling=scaling)
            self.attn_value_parallel_adapter = AdapterController(spec, **kw)

    def fused_qkv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The q/k/v projections as one (3d, d) weight and (3d,) bias."""
        return (torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight], dim=0),
                torch.cat([self.q_proj.bias, self.k_proj.bias,
                           self.v_proj.bias]))

    def _qkv_fused(self, h: torch.Tensor, qkv=None):
        """q/k/v in one (d, 3d) GEMM; q is scaled after its bias. ``qkv``
        is ``fused_qkv()`` when the caller built it once for many steps."""
        W, b = qkv if qkv is not None else self.fused_qkv()
        q, k, v = F.linear(h.to(W.dtype), W, b).split(self.embed_dim, dim=-1)
        return q * self.scaling, k.contiguous(), v.contiguous()

    def compute_cross_kv(self, kv_states: torch.Tensor, ctx: PetContext):
        """Cross K/V (B, S, H*Dh), the VPA included: computed once per
        sequence."""
        k = self.k_proj(kv_states)
        v = self.v_proj(kv_states)
        if self.has_vpa:
            v = self.attn_value_parallel_adapter(kv_states, ctx, y=v)
        return k, v

    def forward(self, hidden_states: torch.Tensor, ctx: PetContext,
                attention_mask: Optional[torch.Tensor] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache: Optional[Cache] = None, decode_pos: Optional[int] = None,
                beam_anc: Optional[torch.Tensor] = None, qkv=None,
                kv_states: Optional[torch.Tensor] = None):
        """Returns (attn_output, cache). The decode cache is updated IN PLACE
        at slot ``decode_pos`` (the JAX package returns a new buffer; here
        the preallocated one is reused): by U1 before the attend, or by D2
        inside it on the ``use_fused_beam`` beam path
        (vlpet_tpu/models/bart.py:442-455). Training: 'dec_self' without a
        cache is causal over the target sequence; 'cross' without
        ``cross_kv`` projects ``kv_states`` (the encoder output)."""
        B, L, _ = hidden_states.shape
        H, Dh = self.num_heads, self.head_dim
        attend = route(fused_attention, fused_attention_reference)
        if self.role == "cross":
            q = self.q_proj(hidden_states) * self.scaling
            if cross_kv is None:
                cross_kv = self.compute_cross_kv(kv_states, ctx)
            k, v = cross_kv
            if k.shape[0] != B:  # beam-shared encoder K/V
                out = beam_cross_attend(q.reshape(B * L, 1, H, Dh), k, v,
                                        attention_mask, attend)
                return self.out_proj(out.reshape(B, L, -1)), cache
            m = attention_mask.float()
            return self.out_proj(attend(q, k, v, m, H)), cache
        q, k, v = self._qkv_fused(hidden_states, qkv)
        if self.role == "enc_self":
            m = attention_mask.float()
            return self.out_proj(attend(q, k, v, m, H)), cache
        if cache is None:
            # teacher forcing: the triangle in-kernel, a zero padding mask
            m = torch.zeros((1, 1, 1, L), dtype=torch.float32,
                            device=q.device)
            return self.out_proj(attend(q, k, v, m, H, causal=True)), cache
        q4 = q.reshape(B, 1, H, Dh)
        if beam_anc is not None and self.cfg.use_fused_beam:
            # D2: attend over the slots before decode_pos plus the own new
            # K/V, and write the slot, in one launch
            fn = route(beam_decode_attend_update,
                       beam_decode_attend_update_reference)
            out = fn(q4, cache["k"], cache["v"], k, v, beam_anc, decode_pos)
            return self.out_proj(out), cache
        write_slot(cache, k, v, decode_pos)
        if beam_anc is not None:
            fn = route(beam_decode_attend, beam_decode_attend_reference)
            out = fn(q4, cache["k"], cache["v"], beam_anc, decode_pos)
        else:
            out = decode_attend(q4, cache["k"], cache["v"], attention_mask)
        return self.out_proj(out), cache


class BartEncoderLayer(nn.Module):
    """Post-LN encoder layer with the VL-PET-large hook chain after each
    sublayer: h + MultiheadDownAdapter(h), then h * GateLargeXLowRank(x1)
    (x1 the sublayer input), then the optional gating scale."""

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
        self.final_layer_norm = ResidualDropoutLayerNorm(d, dt, b.dropout,
                                                         device=device)
        for prefix in ("attn", "ff"):
            if p.use_encoder_adapter_down_multihead:
                self.add_module(f"{prefix}_adapter_multihead",
                                MultiheadDownAdapter(
                                    d, p.adapter_down_dim,
                                    p.encoder_adapter_multihead_num_head, **kw))
            if self._gated(prefix):
                self.add_module(
                    f"encoder_{prefix}_adapter_gating_large_x_lowrank",
                    GateLargeXLowRank(d, p.adapter_gating_down_dim, **kw))

    def _gated(self, prefix: str) -> bool:
        p = self.cfg.pet
        return (p.use_encoder_adapter_gating_large_x_lowrank
                and not (prefix == "attn" and p.no_encoder_attn_adapter))

    def _hooks(self, h: torch.Tensor, residual: torch.Tensor,
               prefix: str) -> torch.Tensor:
        p = self.cfg.pet
        if p.use_encoder_adapter_down_multihead:
            h = h + getattr(self, f"{prefix}_adapter_multihead")(h)
        if self._gated(prefix):
            gate = getattr(
                self, f"encoder_{prefix}_adapter_gating_large_x_lowrank")(residual)
            h = (h + gate) if p.use_encoder_adapter_gating_add else h * gate
        if p.use_encoder_gating_scaling:
            h = h * p.encoder_gating_scaling_factor
        return h

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                ctx: PetContext,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        residual = hidden_states
        h, _ = self.self_attn(hidden_states, ctx, attention_mask=attention_mask)
        h = self._hooks(h, residual, "attn")
        hidden_states = self.self_attn_layer_norm(h, residual, _seed(seeds))

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function)
        h = self._hooks(h, residual, "ff")
        hidden_states = self.final_layer_norm(h, residual, _seed(seeds))
        if self.dtype != torch.float32:
            clamp = torch.finfo(self.dtype).max - 1000
            hidden_states = torch.clamp(hidden_states, -clamp, clamp)
        return hidden_states


class BartDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention (VPA on V),
    FFN. ``forward`` is the incremental decode step (self-attention over
    the cache, cross-attention over precomputed K/V); ``teacher_force`` the
    training pass over the whole target sequence."""

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
        hidden_states = self.self_attn_layer_norm(h, residual)

        residual = hidden_states
        h, _ = self.encoder_attn(hidden_states, ctx, attention_mask=cross_mask,
                                 cross_kv=cross_kv)
        hidden_states = self.encoder_attn_layer_norm(h, residual)

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function)
        hidden_states = self.final_layer_norm(h, residual)
        return hidden_states, cache

    def teacher_force(self, hidden_states: torch.Tensor, ctx: PetContext,
                      encoder_hidden_states: torch.Tensor,
                      cross_mask: torch.Tensor,
                      seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """The training pass over the whole target sequence (B, T, d)."""
        residual = hidden_states
        h, _ = self.self_attn(hidden_states, ctx)
        hidden_states = self.self_attn_layer_norm(h, residual, _seed(seeds))

        residual = hidden_states
        h, _ = self.encoder_attn(hidden_states, ctx, attention_mask=cross_mask,
                                 kv_states=encoder_hidden_states)
        hidden_states = self.encoder_attn_layer_norm(h, residual,
                                                     _seed(seeds))

        residual = hidden_states
        h = _ffn(self, hidden_states, self.cfg.backbone.activation_function)
        return self.final_layer_norm(h, residual, _seed(seeds))

    def compute_cross_kv(self, encoder_hidden_states: torch.Tensor,
                         ctx: PetContext):
        return self.encoder_attn.compute_cross_kv(encoder_hidden_states, ctx)


class JointEncoder(nn.Module):
    """BART encoder + visual concat. Sequence layout [text; vis]; text
    embeddings get layernorm_embedding before the concat (unless
    share_vis_lang_layer_norm); the joint mask is text-mask ++ vis-mask."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b, v = cfg.backbone, cfg.vis
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        self.embed_positions = nn.Parameter(
            torch.empty((b.max_position_embeddings + 2, b.d_model),
                        device=resolve_device(device)))
        if not v.no_vis:
            self.visual_embedding = VisualEmbedding(v, b.d_model, dtype=dt,
                                                    device=device)
        self.layernorm_embedding = LayerNorm(b.d_model, dtype=dt, device=device)
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
                seeds: Optional[DropoutSeeds] = None):
        """Returns (hidden_states, joint_attention_mask [B, L_joint]).
        ``seeds`` (training) drives the embedding dropout and the residual
        dropout of every layer."""
        b, v = self.cfg.backbone, self.cfg.vis
        dt = self.dtype
        ctx = ctx or PetContext()
        L = input_ids.shape[1]
        embed_scale = (b.d_model ** 0.5) if b.scale_embedding else 1.0
        h = shared_embedding[input_ids].to(dt) * embed_scale
        h = h + self.embed_positions[2:2 + L].to(dt)[None]
        if not v.no_vis and vis_feats is not None:
            vis_embeds = self.visual_embedding.tokens(
                vis_feats, boxes, shared_embedding, img_order_ids,
                obj_order_ids)
            if v.share_vis_lang_layer_norm:
                h = self.layernorm_embedding(torch.cat([h, vis_embeds], dim=1))
            else:
                h = torch.cat([self.layernorm_embedding(h), vis_embeds], dim=1)
            mask = joint_attention_mask(attention_mask, vis_embeds.shape[1],
                                        vis_attention_mask)
        else:
            h = self.layernorm_embedding(h)
            mask = attention_mask
        if seeds is not None:
            h = hash_dropout(h, seeds.next(), b.dropout)
        # length-collapsed (B, 1, 1, S) additive mask
        attn_mask = expand_mask(mask, 1, dt)
        for layer in self.layers():
            h = layer(h, attn_mask, ctx, seeds)
        return h, mask


class BartDecoder(nn.Module):
    """BART decoder stack: ``forward`` is one incremental decode step,
    ``teacher_force`` the training pass."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        self.embed_positions = nn.Parameter(
            torch.empty((b.max_position_embeddings + 2, b.d_model),
                        device=resolve_device(device)))
        self.layernorm_embedding = LayerNorm(b.d_model, dtype=dt, device=device)
        self.n_layers = b.decoder_layers
        for i in range(b.decoder_layers):
            self.add_module(f"layers_{i}", BartDecoderLayer(cfg, device=device))

    def layers(self) -> List[BartDecoderLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.n_layers)]

    def forward(self, input_ids: torch.Tensor, shared_embedding: torch.Tensor,
                encoder_attention_mask: torch.Tensor, ctx: PetContext,
                cross_kvs: Tuple, cache: Tuple[Cache, ...], decode_pos: int,
                beam_anc: Optional[torch.Tensor], self_qkvs: Tuple):
        """One decode step: input_ids (B, 1) at position ``decode_pos``.
        ``beam_anc`` (B_true, K, L_cache) switches self-attention to the
        reorder-free beam path; input rows are then beam-major (B_true*K)
        and cross_kvs / encoder_attention_mask stay at B_true rows.
        ``self_qkvs`` is ``fused_self_qkvs()``, built once per sequence.
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
        for layer, kv, c, qkv in zip(self.layers(), cross_kvs, cache,
                                     self_qkvs):
            h, _ = layer(h, ctx, self_mask, cross_mask, kv, c, decode_pos,
                         beam_anc, qkv)
        return h, cache

    def teacher_force(self, input_ids: torch.Tensor,
                      shared_embedding: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      encoder_attention_mask: torch.Tensor, ctx: PetContext,
                      seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """Training: the whole target sequence input_ids (B, T) at positions
        2 + t, causal self-attention, cross-attention over the encoder
        states (vlpet_tpu/models/bart.py:1204-1210). Returns (B, T, d)."""
        b = self.cfg.backbone
        dt = self.dtype
        T = input_ids.shape[1]
        embed_scale = (b.d_model ** 0.5) if b.scale_embedding else 1.0
        h = shared_embedding[input_ids].to(dt) * embed_scale
        h = h + self.embed_positions[2:2 + T].to(dt)[None]
        h = self.layernorm_embedding(h)
        if seeds is not None:
            h = hash_dropout(h, seeds.next(), b.dropout)
        cross_mask = expand_mask(encoder_attention_mask, 1, dt)
        for layer in self.layers():
            h = layer.teacher_force(h, ctx, encoder_hidden_states, cross_mask,
                                    seeds)
        return h

    def compute_cross_kvs(self, encoder_hidden_states: torch.Tensor,
                          ctx: PetContext):
        """Per-layer cross-attention K/V (VPA included), once per sequence."""
        return tuple(layer.compute_cross_kv(encoder_hidden_states, ctx)
                     for layer in self.layers())

    def fused_self_qkvs(self):
        """Per-layer fused self-attention QKV weight and bias."""
        return tuple(layer.self_attn.fused_qkv() for layer in self.layers())
