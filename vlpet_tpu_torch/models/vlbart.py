"""VLBart: vision-augmented BART seq2seq with PET, ported from
vlpet_tpu/models/vlbart.py.

Training: ``forward`` runs the encoder and the teacher-forcing decoder on
labels shifted right and returns the per-token loss (and the logits), with
the JAX package's loss routing (``_ce``). Generation is staged as in the JAX
package: ``encode`` once, ``init_decode`` precomputes what every step
reuses (each decoder layer's cross-attention K/V with the VPA included, its
fused self-attention QKV weight, the fp32 LM-head weight), and
``decode_step_topk`` is the per-token step driven by
vlpet_tpu_torch.models.generate.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.bart import BartDecoder, JointEncoder, compute_dtype
from vlpet_tpu_torch.models.generate import topk_lse
from vlpet_tpu_torch.ops import route
from vlpet_tpu_torch.ops.ce import (cross_entropy_with_ignore, linear_ce,
                                    mean_or_per_token)
from vlpet_tpu_torch.ops.fused_ce import fused_linear_ce, fused_linear_ce_plain
from vlpet_tpu_torch.ops.hashdrop import DropoutSeeds
from vlpet_tpu_torch.pet.modules import PetContext

# PetConfig flags whose code paths the port does not have. Each must be off
# (False / 0); the freezing and post-init override flags only shape training
# and weight init, so they do not appear here.
_UNPORTED_PET_FLAGS = (
    "use_compacter", "use_lradapter", "use_hyperformer", "use_lora",
    "encoder_prompt_len", "decoder_prompt_len", "use_attn_prefix",
    "use_lm_head_adapter",
    "use_encoder_adapter_up_multihead", "use_encoder_adapter_down_up_multihead",
    "use_encoder_adapter_down_up_pair_multihead",
    "use_decoder_adapter_down_multihead",
    "use_encoder_adapter_gating_large_x", "use_encoder_adapter_gating_small_xy_cat",
    "use_encoder_adapter_gating_middle_xy_add",
    "use_encoder_adapter_gating_middle_ia3_add",
    "use_encoder_adapter_gating_layernorm", "use_encoder_adapter_gating_l2norm",
    "use_encoder_gating_large_x_lowrank",
    "use_decoder_enc_attn_key_parallel_adapter_down_dim",
    "use_decoder_enc_attn_key_value_adapter_down_dim",
    "use_decoder_enc_attn_adapter_down_dim",
    "use_decoder_enc_attn_value_sequential_adapter_down_dim",
    "use_decoder_enc_attn_value_residual_connection",
    "use_decoder_enc_attn_value_parallel_adapter_down_multihead",
    "use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead",
    "use_decoder_self_attn_value_parallel_adapter_down_dim",
    "use_decoder_self_attn_adapter_down_dim", "use_decoder_ff_adapter_down_dim",
    "use_encoder_attn_value_parallel_adapter_down_dim",
    "use_decoder_enc_attn_value_ia3", "use_decoder_self_attn_value_ia3",
    "use_decoder_ff_ia3", "use_encoder_attn_value_ia3",
)
_UNPORTED_VIS_FLAGS = ("use_vis_prefix", "expand_vis_embedding",
                       "use_lowrank_visual_projector", "vis_use_transformer")


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """Decoder inputs from labels (vlpet_tpu/models/vlbart.py:34): shift
    right, put decoder_start first, replace -100 with pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def check_supported(cfg: VLModelConfig) -> None:
    """Raise NotImplementedError for any configuration the port does not
    implement, rather than ignoring it. Both backbones share the list and
    both train and evaluate. What raises here: the classifier answer head,
    ``scan_layers``, ``remat`` other than "none", and the PET and visual
    flags of ``_UNPORTED_PET_FLAGS`` / ``_UNPORTED_VIS_FLAGS`` and serial
    adapters. What is unported only on a training call raises there:
    ``lambda_z`` (train/steps.py) and ``vis.sparse_sample`` (models/t5.py
    ``VLT5._check_trainable``). A trainable T5 ``relative_attention_bias``
    trains (its dbias comes from A6 or the long backward), and the long
    backward takes the T5 video sites' bias and probability dropout.

    Accepted: ``use_fused_ce`` (C1/C2 on a frozen head, ``VLBart._ce``,
    ``VLT5._ce``) and ``use_fused_beam`` (D2 on the beam path). Not read by
    the port: use_pallas_attention (TPU kernel routing; on CUDA the port
    runs its kernels)."""
    if cfg.classifier:
        raise NotImplementedError("the classifier answer head is not ported")
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers (stacked layer params) is not "
                                  "ported; convert an unstacked tree")
    if cfg.remat != "none":
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported")
    p, v = cfg.pet, cfg.vis
    bad = [f for f in _UNPORTED_PET_FLAGS if getattr(p, f)]
    bad += [f for f in _UNPORTED_VIS_FLAGS if getattr(v, f)]
    if p.use_adapter and not (p.no_encoder_adapter and p.no_decoder_adapter):
        bad.append("use_adapter (serial adapters)")
    if bad:
        raise NotImplementedError(f"not ported: {', '.join(bad)}")


class DecodeConsts(NamedTuple):
    """The loop-invariant tensors of one generation, built once by
    ``VLBart.init_decode``: per decoder layer the cross-attention K/V
    (B, S, H*Dh) and the fused self-attention QKV (weight, bias), and the
    LM-head weight as fp32."""
    cross_kvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    self_qkvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    logits_weight: torch.Tensor


class VLBartModel(nn.Module):
    """Encoder-decoder glue: shared embedding, joint encoder, decoder."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        self.cfg = cfg
        self.shared = nn.Parameter(torch.empty((b.vocab_size, b.d_model),
                                               device=resolve_device(device)))
        self.encoder = JointEncoder(cfg, device=device)
        self.decoder = BartDecoder(cfg, device=device)

    def encode(self, input_ids, attention_mask, vis_feats=None, boxes=None,
               img_order_ids=None, obj_order_ids=None, vis_attention_mask=None,
               ctx: Optional[PetContext] = None):
        return self.encoder(input_ids, attention_mask, self.shared,
                            vis_feats=vis_feats, boxes=boxes,
                            img_order_ids=img_order_ids,
                            obj_order_ids=obj_order_ids,
                            vis_attention_mask=vis_attention_mask,
                            ctx=ctx or PetContext())

    def decode(self, decoder_input_ids, joint_mask, ctx,
               consts: DecodeConsts, cache, decode_pos: int, beam_anc=None):
        return self.decoder(decoder_input_ids, self.shared, joint_mask,
                            ctx or PetContext(), consts.cross_kvs, cache,
                            decode_pos, beam_anc, consts.self_qkvs)

    def compute_cross_kvs(self, encoder_hidden_states, ctx: PetContext):
        return self.decoder.compute_cross_kvs(encoder_hidden_states, ctx)


class VLBart(nn.Module):
    """Seq2seq LM head over VLBartModel: logits tied to the shared
    embedding plus ``final_logits_bias``. Built on the card unless
    ``device`` says otherwise (raises on a host without CUDA)."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        if cfg.is_t5:
            raise ValueError("VLBart needs a BART backbone; build "
                             "models.t5.VLT5 for T5")
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.model = VLBartModel(cfg, device=dev)
        self.final_logits_bias = nn.Parameter(
            torch.zeros((1, cfg.backbone.vocab_size), device=dev))
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VLBart":
        """Seeded random init with the JAX package's scheme: normal(0,
        init_std) for dense kernels and embeddings, zeros for biases, ones
        for LayerNorm scales."""
        std = self.cfg.backbone.init_std
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std)
        return self

    def logits_weight(self) -> torch.Tensor:
        """The tied LM-head weight rounded to the compute dtype, as fp32."""
        return self.model.shared.to(self.dtype).float()

    def _logits(self, dec_out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """fp32 logits: the compute-dtype operands multiplied in fp32 (the
        exact value of a bf16 GEMM with fp32 accumulation and output); ``w``
        is ``logits_weight()``."""
        return dec_out.float() @ w.t() + self.final_logits_bias

    # --- training ------------------------------------------------------------

    def dropout_sites(self) -> int:
        """Dropout seeds one training step draws, consumed in this order:
        the encoder's embedding dropout; per encoder layer the
        self-attention and the FFN residual dropout; the decoder's
        embedding dropout; per decoder layer the self-attention, the
        cross-attention and the FFN residual dropout."""
        b = self.cfg.backbone
        return 2 + 2 * b.encoder_layers + 3 * b.decoder_layers

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                vis_feats: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                img_order_ids=None, obj_order_ids=None,
                vis_attention_mask=None, decoder_input_ids=None,
                reduce_loss: bool = False) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (vlpet_tpu/models/vlbart.py:193-218).
        Returns {"logits", "encoder_last_hidden_state"} and, with labels,
        "loss": per-token (B, T) fp32, or the mean over valid tokens when
        ``reduce_loss``. ``deterministic=False`` applies dropout with one
        seed per site drawn from ``generator`` (``dropout_sites``). On the
        bf16 linear_ce route "logits" is the bf16 copy the loss keeps; on
        the ``use_fused_ce`` route (``_ce``) the output has no "logits":
        the fused loss never forms them (under jit the JAX package's logits
        there are dead code; eagerly they would be the (B, T, V) fp32
        tensor, 1 GB at B 500, that the flag exists to avoid)."""
        b = self.cfg.backbone
        ctx = ctx or PetContext()
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("forward needs labels or decoder_input_ids")
            decoder_input_ids = shift_tokens_right(
                labels, b.pad_token_id, b.decoder_start_token_id)
        seeds = None
        if not deterministic:
            if (b.attention_dropout > 0 or b.activation_dropout > 0
                    or self.cfg.vis.sparse_sample):
                raise NotImplementedError(
                    "attention_dropout / activation_dropout > 0 and "
                    "vis.sparse_sample are not ported")
            if b.dropout > 0:
                seeds = DropoutSeeds(self.dropout_sites(), generator,
                                     input_ids.device)
        enc, joint_mask = self.model.encoder(
            input_ids, attention_mask, self.model.shared, vis_feats=vis_feats,
            boxes=boxes, img_order_ids=img_order_ids,
            obj_order_ids=obj_order_ids,
            vis_attention_mask=vis_attention_mask, ctx=ctx, seeds=seeds)
        dec = self.model.decoder.teacher_force(
            decoder_input_ids, self.model.shared, enc, joint_mask, ctx, seeds)
        out = {"encoder_last_hidden_state": enc}
        if labels is None:
            out["logits"] = self._logits(dec, self.logits_weight())
        else:
            out["loss"], logits = self._ce(dec, labels, reduce_loss)
            if logits is not None:
                out["logits"] = logits
        return out

    def _ce(self, dec_out: torch.Tensor, labels: torch.Tensor,
            reduce_loss: bool):
        """(loss, logits or None), routed as
        vlpet_tpu/models/vlbart.py:220-260 with a frozen LM head:
        ``fused_linear_ce`` (C1/C2, no logits: None) under
        ``use_fused_ce``, in bf16 and fp32 alike, else ``linear_ce`` (one
        bf16 logits copy) in bf16; otherwise ``cross_entropy_with_ignore``
        over the fp32 logits. The JAX package's row-tile and backend tests
        (``pick_row_tile``, ``jax.default_backend()``) are TPU artefacts
        and are dropped."""
        p = self.cfg.pet
        head_frozen = not p.unfreeze_lm_head and not p.unfreeze_language_model
        B, T = labels.shape
        if head_frozen and (self.cfg.use_fused_ce
                            or dec_out.dtype == torch.bfloat16):
            args = (dec_out.reshape(B * T, -1), self.model.shared,
                    self.final_logits_bias[0], labels.reshape(-1))
            if self.cfg.use_fused_ce:
                nll, _ = route(fused_linear_ce, fused_linear_ce_plain)(*args)
                logits = None
            else:
                nll, logits = linear_ce(*args)
                logits = logits.reshape(B, T, -1)
            return mean_or_per_token(nll.reshape(B, T), labels,
                                     reduce_loss), logits
        logits = self._logits(dec_out, self.logits_weight())
        return cross_entropy_with_ignore(logits, labels, reduce_loss), logits

    # --- generation-facing methods ------------------------------------------

    def encode(self, input_ids, attention_mask, vis_feats=None, boxes=None,
               img_order_ids=None, obj_order_ids=None, vis_attention_mask=None,
               ctx: Optional[PetContext] = None):
        return self.model.encode(input_ids, attention_mask, vis_feats, boxes,
                                 img_order_ids, obj_order_ids,
                                 vis_attention_mask, ctx)

    def init_decode(self, encoder_hidden_states,
                    ctx: Optional[PetContext] = None) -> DecodeConsts:
        """What every decode step reuses: the cross-attention K/V
        (B, S, H*Dh) of every decoder layer and the other loop invariants."""
        return DecodeConsts(
            self.model.compute_cross_kvs(encoder_hidden_states,
                                         ctx or PetContext()),
            self.model.decoder.fused_self_qkvs(), self.logits_weight())

    def decode_step(self, decoder_input_ids, joint_mask, consts: DecodeConsts,
                    cache, decode_pos: int, ctx: Optional[PetContext] = None,
                    beam_anc=None):
        """One decode step -> (logits (B, V) f32, cache)."""
        dec_out, cache = self.model.decode(decoder_input_ids, joint_mask, ctx,
                                           consts, cache, decode_pos, beam_anc)
        return self._logits(dec_out[:, -1, :], consts.logits_weight), cache

    def decode_step_topk(self, decoder_input_ids, joint_mask,
                         consts: DecodeConsts, cache, decode_pos: int, k: int,
                         ctx: Optional[PetContext] = None, beam_anc=None):
        """Decode step -> (top_vals (B, k) f32, top_toks (B, k) int32,
        lse (B,) f32, cache): per-row top-k of the raw logits plus the row
        logsumexp, through kernel 4 (or its plain twin)."""
        logits, cache = self.decode_step(decoder_input_ids, joint_mask,
                                         consts, cache, decode_pos, ctx,
                                         beam_anc)
        vals, toks, lse = topk_lse(logits, k)
        return vals, toks, lse, cache
