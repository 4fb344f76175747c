"""VLBart: vision-augmented BART seq2seq with PET, ported from
vlpet_tpu/models/vlbart.py.

Training: ``forward`` runs the encoder and the teacher-forcing decoder on
labels shifted right and returns the per-token loss (and the logits), with
the JAX package's loss routing (``_ce``). Generation is staged as in the JAX
package: ``encode`` once, ``init_decode`` precomputes what every step
reuses (each decoder layer's cross-attention K/V with LoRA's v and the VPA
included, its fused self-attention QKV weight, its hypernet-generated
adapter weights, the fp32 LM-head weight), and ``decode_step_topk`` is the
per-token step driven by vlpet_tpu_torch.models.generate.

The model root holds what the JAX VLBart keeps there: Compacter's shared
``phm_rule`` and slow weights (``phm_W_*``), injected into every call's
PetContext (``_ctx``), the hyperformer's ``shared_task_embed`` and, under
``cfg.classifier``, the answer head (``AnswerHead``: ``classify`` and
``forward``'s "answer_logits").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.bart import (BartDecoder, JointEncoder,
                                         compute_dtype, layer_sites)
from vlpet_tpu_torch.models.generate import topk_lse
from vlpet_tpu_torch.models.norm import LayerNorm
from vlpet_tpu_torch.ops import route
from vlpet_tpu_torch.ops.ce import (cross_entropy_with_ignore, linear_ce,
                                    mean_or_per_token)
from vlpet_tpu_torch.ops.fused_ce import fused_linear_ce, fused_linear_ce_plain
from vlpet_tpu_torch.ops.hashdrop import DropoutSeeds
from vlpet_tpu_torch.pet.hypernet import TaskEmbeddingController
from vlpet_tpu_torch.pet.modules import (OutputParallelAdapterLayer,
                                         PetContext, TaskDense,
                                         get_activation,
                                         glorot_uniform_gain2_,
                                         make_shared_phm_W, normal_,
                                         shared_phm_W)
from vlpet_tpu_torch.train.freezing import weight_initialization

# VisConfig flags whose code paths the port does not have: each must be
# off. vis_use_transformer is read by no model of the JAX package either
# (only its config and CLI carry it).
_UNPORTED_VIS_FLAGS = ("vis_use_transformer",)
# the prefix and LM-head flags, which the JAX T5 does not read (its
# generation takes the decoder input prompt even under use_attn_prefix):
# the port's T5 refuses them (models/t5.py check_t5_supported)
T5_UNREAD_FLAGS = ("use_attn_prefix", "use_vis_prefix", "use_lm_head_adapter")
# the VL-PET ablation flags that only the BART backbone reads (the JAX T5
# ignores them; the port's T5 refuses them, models/t5.py
# check_t5_supported)
BART_ONLY_PET_FLAGS = (
    "track_z",
    "use_encoder_adapter_up_multihead", "use_encoder_adapter_down_up_multihead",
    "use_encoder_adapter_down_up_pair_multihead",
    "use_decoder_adapter_down_multihead",
    "use_encoder_adapter_gating_layernorm", "use_encoder_adapter_gating_l2norm",
    "use_encoder_gating_large_x_lowrank",
    "use_decoder_enc_attn_key_parallel_adapter_down_dim",
    "use_decoder_enc_attn_key_value_adapter_down_dim",
    "use_decoder_enc_attn_adapter_down_dim",
    "use_decoder_enc_attn_value_sequential_adapter_down_dim",
    "use_decoder_enc_attn_value_residual_connection",
    "use_decoder_enc_attn_value_parallel_adapter_down_multihead",
    "use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead",
    "use_decoder_self_attn_adapter_down_dim", "use_decoder_ff_adapter_down_dim",
    "use_encoder_attn_value_parallel_adapter_down_dim",
    # (use_decoder_self_attn_value_parallel_adapter_down_dim is read by the
    # JAX T5 too, and builds nothing on either backbone)
    "use_decoder_enc_attn_value_ia3", "use_decoder_self_attn_value_ia3",
    "use_decoder_ff_ia3", "use_encoder_attn_value_ia3",
)


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int) -> torch.Tensor:
    """Decoder inputs from labels (vlpet_tpu/models/vlbart.py:34): shift
    right, put decoder_start first, replace -100 with pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def drops(cfg: VLModelConfig) -> bool:
    """Whether a BART training step draws dropout seeds: any BART dropout
    rate above 0, or LoRA's."""
    b, p = cfg.backbone, cfg.pet
    return (b.dropout > 0 or b.attention_dropout > 0
            or b.activation_dropout > 0
            or (p.use_lora and p.lora_spec().lora_dropout > 0.0))


def dropout_sites(cfg: VLModelConfig) -> int:
    """The seeds of one BART training step (``VLBart.dropout_sites``)."""
    b = cfg.backbone
    return (2 + b.encoder_layers * layer_sites(cfg, 1)
            + b.decoder_layers * layer_sites(cfg, 2))


def check_supported(cfg: VLModelConfig) -> None:
    """Raise NotImplementedError for any configuration the port does not
    implement, rather than ignoring it. Both backbones share the list and
    both train and evaluate. What raises here: ``scan_layers`` (a TPU
    artefact: stacked layer parameters) and the visual flag of
    ``_UNPORTED_VIS_FLAGS``. Every PET flag the JAX package reads builds
    on BART; the flags the JAX T5 does not read (``BART_ONLY_PET_FLAGS``,
    ``T5_UNREAD_FLAGS``, ``expand_vis_embedding``) the T5 model rejects
    itself (models/t5.py). A trainable T5 ``relative_attention_bias``
    trains (its dbias comes from A6 or the long backward), and the long
    backward takes the T5 video sites' bias and probability dropout.

    Accepted: the classifier answer head (``classifier``: ``AnswerHead``,
    ``classify``), ``remat`` "full" and "dots" (BART only, as in JAX:
    models/bart.py ``run_layer``; T5 ignores it, as the JAX T5 does),
    BART's ``attention_dropout`` and ``activation_dropout``,
    ``vis.sparse_sample``, ``use_fused_ce`` (C1/C2 on a frozen head,
    ``VLBart._ce``, ``VLT5._ce``) and ``use_fused_beam`` (D2 on the beam
    path). Not read by the port: use_pallas_attention (TPU kernel routing;
    on CUDA the port runs its kernels)."""
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers (stacked layer params) is not "
                                  "ported; convert an unstacked tree")
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy: {cfg.remat!r}")
    bad = [f for f in _UNPORTED_VIS_FLAGS if getattr(cfg.vis, f)]
    if bad:
        raise NotImplementedError(f"not ported: {', '.join(bad)}")


class DecodeConsts(NamedTuple):
    """The loop-invariant tensors of one generation, built once by
    ``VLBart.init_decode``: per decoder layer the cross-attention K/V
    (B, S, H*Dh), the fused self-attention QKV (weight, bias; None under
    LoRA) and the hypernet-generated adapter weights (None without the
    hyperformer), and the LM-head weight as fp32 (the LM-head adapter,
    where there is one, adds its output to the logits at every step)."""
    cross_kvs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    self_qkvs: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]
    blocks: Tuple
    logits_weight: torch.Tensor


class AnswerHead(nn.Module):
    """The classifier answer head (vlpet_tpu/models/vlbart.py:349-366):
    Linear(d -> 2d) -> GELU (erf) -> LayerNorm(eps 1e-5) -> Linear(2d ->
    num_answers), in fp32 whatever the compute dtype (the JAX TaskDense
    default); parameters ``fc1`` / ``fc2`` (``weight``, ``bias``) and
    ``mlp_layer_norm`` (``scale``, ``bias``) as in the flax tree. Its
    LayerNorm is the plain one with flax's statistics (models/norm.py), not
    L1. ``init_params``: normal(0, ``init_std``) weights, zero biases."""

    def __init__(self, d_model: int, num_answers: int, init_std: float,
                 device: Device = "cuda"):
        super().__init__()
        self.init_std = init_std
        self.fc1 = TaskDense(d_model, 2 * d_model, device=device)
        self.mlp_layer_norm = LayerNorm(2 * d_model, device=device)
        self.fc2 = TaskDense(2 * d_model, num_answers, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            normal_(fc.weight, self.init_std, generator)
            fc.bias.zero_()
        self.mlp_layer_norm.scale.fill_(1.0)
        self.mlp_layer_norm.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = get_activation("gelu")(self.fc1(x.float()))
        return self.fc2(self.mlp_layer_norm(h))


class VLBartModel(nn.Module):
    """Encoder-decoder glue: shared embedding, joint encoder, decoder and,
    under ``use_hyperformer``, the task embedding (``shared_task_embed``,
    vlpet_tpu/models/vlbart.py:50-68)."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        b = cfg.backbone
        self.cfg = cfg
        self.shared = nn.Parameter(torch.empty((b.vocab_size, b.d_model),
                                               device=resolve_device(device)))
        self.encoder = JointEncoder(cfg, device=device)
        self.decoder = BartDecoder(cfg, device=device)
        if cfg.pet.use_hyperformer:
            self.shared_task_embed = TaskEmbeddingController(
                cfg.pet.hyperformer_spec(), cfg.pet.tasks, device=device)

    def task_embedding(self, ctx: PetContext) -> Optional[torch.Tensor]:
        embed = self._modules.get("shared_task_embed")
        return embed(ctx.task_idx) if embed is not None else None

    def encode(self, input_ids, attention_mask, vis_feats=None, boxes=None,
               img_order_ids=None, obj_order_ids=None, vis_attention_mask=None,
               ctx: Optional[PetContext] = None):
        ctx = ctx or PetContext()
        return self.encoder(input_ids, attention_mask, self.shared,
                            vis_feats=vis_feats, boxes=boxes,
                            img_order_ids=img_order_ids,
                            obj_order_ids=obj_order_ids,
                            vis_attention_mask=vis_attention_mask,
                            ctx=ctx, task_embedding=self.task_embedding(ctx))

    def decode(self, decoder_input_ids, joint_mask, ctx,
               consts: DecodeConsts, cache, decode_pos: int, beam_anc=None):
        return self.decoder(decoder_input_ids, self.shared, joint_mask,
                            ctx or PetContext(), consts.cross_kvs, cache,
                            decode_pos, beam_anc, consts.self_qkvs,
                            consts.blocks)

    def compute_cross_kvs(self, encoder_hidden_states, ctx: PetContext):
        return self.decoder.compute_cross_kvs(encoder_hidden_states, ctx)

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                vis_feats=None, boxes=None, img_order_ids=None,
                obj_order_ids=None, vis_attention_mask=None,
                ctx: Optional[PetContext] = None,
                seeds: Optional[DropoutSeeds] = None,
                sparse_generator: Optional[torch.Generator] = None,
                sparse: bool = False):
        """The teacher-forced pass (vlpet_tpu/models/vlbart.py:100-111):
        (decoder states, encoder states, joint mask). ``seeds`` (training)
        drive the dropout sites, ``sparse`` the visual subsample
        (``JointEncoder.forward``)."""
        ctx = ctx or PetContext()
        task_embedding = self.task_embedding(ctx)
        enc, joint_mask = self.encoder(
            input_ids, attention_mask, self.shared, vis_feats=vis_feats,
            boxes=boxes, img_order_ids=img_order_ids,
            obj_order_ids=obj_order_ids,
            vis_attention_mask=vis_attention_mask, ctx=ctx, seeds=seeds,
            task_embedding=task_embedding, sparse_generator=sparse_generator,
            sparse=sparse)
        dec = self.decoder.teacher_force(decoder_input_ids, self.shared, enc,
                                         joint_mask, ctx, seeds,
                                         task_embedding)
        return dec, enc, joint_mask


def seeded_init(module: nn.Module, cfg: VLModelConfig,
                generator: torch.Generator) -> None:
    """The JAX package's BART init scheme on ``module``, in place:
    normal(0, init_std) for dense kernels, embeddings and middle-Y's
    vector, zeros for biases, ones for LayerNorm scales; the PET modules'
    own initialisers (``init_params``: LoRA, Compacter, the low-rank
    adapter, the prompts, the hypernets, the answer head) and Compacter's
    root weights (normal(0, phm_init_range) rule, glorot slow weights);
    then the recipe's re-inits (train/freezing.py
    ``weight_initialization``)."""
    std = cfg.backbone.init_std
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf.endswith("bias"):
            p.zero_()
        else:
            normal_(p, std, generator)
    for m in module.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
    for name, p in module.named_parameters(recurse=False):
        if name == "phm_rule":
            normal_(p, cfg.pet.phm_init_range, generator)
        elif name.startswith("phm_W_"):
            glorot_uniform_gain2_(p, generator)
    weight_initialization(module, cfg.pet)


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
        p = cfg.pet
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.model = VLBartModel(cfg, device=dev)
        self.final_logits_bias = nn.Parameter(
            torch.zeros((1, cfg.backbone.vocab_size), device=dev))
        # Compacter's model-shared rule and slow weights
        # (vlpet_tpu/models/vlbart.py:140-153)
        if p.use_compacter and p.shared_phm_rule:
            pd = p.hypercomplex_division
            self.phm_rule = nn.Parameter(torch.empty(
                (pd, pd, pd), dtype=self.dtype, device=dev))
        if p.use_compacter and p.shared_W_phm:
            make_shared_phm_W(self, p, cfg.d_model, dtype=self.dtype,
                              device=dev)
        if p.use_lm_head_adapter:  # vlpet_tpu/models/vlbart.py:128-131
            self.output_adapter = OutputParallelAdapterLayer(
                cfg.d_model, cfg.backbone.vocab_size, device=dev)
        if cfg.classifier:  # vlpet_tpu/models/vlbart.py:132-138
            self.answer_head = AnswerHead(cfg.d_model, cfg.num_answers,
                                          cfg.backbone.init_std, device=dev)
        self.eval()

    def _ctx(self, ctx: Optional[PetContext]) -> PetContext:
        """The call's PetContext with Compacter's model-shared rule and
        slow weights injected (vlpet_tpu/models/vlbart.py:155-164)."""
        ctx = ctx or PetContext()
        p = self.cfg.pet
        if p.use_compacter and p.shared_phm_rule and ctx.phm_rule is None:
            ctx = dataclasses.replace(ctx, phm_rule=self.phm_rule)
        if p.use_compacter and p.shared_W_phm and ctx.phm_W is None:
            ctx = dataclasses.replace(ctx, phm_W=shared_phm_W(self, p))
        return ctx

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VLBart":
        """Seeded random init with the JAX package's scheme
        (``seeded_init``)."""
        seeded_init(self, self.cfg, generator)
        return self

    def logits_weight(self) -> torch.Tensor:
        """The tied LM-head weight rounded to the compute dtype, as fp32."""
        return self.model.shared.to(self.dtype).float()

    def _logits(self, dec_out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """fp32 logits: the compute-dtype operands multiplied in fp32 (the
        exact value of a bf16 GEMM with fp32 accumulation and output); ``w``
        is ``logits_weight()``. The LM-head adapter's fp32 output is added
        (vlpet_tpu/models/vlbart.py:185-190)."""
        logits = dec_out.float() @ w.t() + self.final_logits_bias
        adapter = self._modules.get("output_adapter")
        if adapter is not None:
            logits = logits + adapter(dec_out).float()
        return logits

    # --- training ------------------------------------------------------------

    def lora_drops(self) -> bool:
        """Whether LoRA's q and v projections drop their input in training."""
        p = self.cfg.pet
        return p.use_lora and p.lora_spec().lora_dropout > 0.0

    def dropout_sites(self) -> int:
        """Dropout seeds one training step draws, consumed in this order:
        the encoder's embedding dropout; per encoder layer (LoRA's q and v
        input dropout, where LoRA drops), (the self-attention's
        probabilities, where ``attention_dropout`` > 0), the
        self-attention's residual, (the FFN's hidden, where
        ``activation_dropout`` > 0) and the FFN's residual; the decoder's
        embedding dropout; per decoder layer (LoRA's self-attention q and
        v), (the self-attention's probabilities), its residual, (LoRA's
        cross-attention q and v), (the cross-attention's probabilities),
        its residual, (the FFN's hidden) and its residual
        (models/bart.py ``layer_sites``; each layer's drawn before the
        layer runs, ``run_layer``)."""
        return dropout_sites(self.cfg)

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
        ``reduce_loss``; under ``cfg.classifier`` also "answer_logits", the
        answer head on the last decoder state (:212-213).
        ``deterministic=False`` applies dropout with one seed per site
        drawn from ``generator`` (``dropout_sites``). On the
        bf16 linear_ce route "logits" is the bf16 copy the loss keeps; on
        the ``use_fused_ce`` route (``_ce``) the output has no "logits":
        the fused loss never forms them (under jit the JAX package's logits
        there are dead code; eagerly they would be the (B, T, V) fp32
        tensor, 1 GB at B 500, that the flag exists to avoid)."""
        b = self.cfg.backbone
        ctx = self._ctx(ctx)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("forward needs labels or decoder_input_ids")
            decoder_input_ids = shift_tokens_right(
                labels, b.pad_token_id, b.decoder_start_token_id)
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
             boxes, ctx: PetContext, deterministic: bool, generator,
             img_order_ids=None, obj_order_ids=None,
             vis_attention_mask=None):
        """(encoder states, joint mask, decoder states) of one teacher-forced
        pass; a training one (``deterministic`` False) draws the step's
        dropout seeds, then ``vis.sparse_sample``'s scores, from
        ``generator``."""
        seeds = None
        if not deterministic and drops(self.cfg):
            seeds = DropoutSeeds(self.dropout_sites(), generator,
                                 input_ids.device)
            seeds.example_base = ctx.example_base
        dec, enc, joint_mask = self.model(
            input_ids, attention_mask, decoder_input_ids, vis_feats, boxes,
            img_order_ids, obj_order_ids, vis_attention_mask, ctx, seeds,
            generator, self.cfg.vis.sparse_sample and not deterministic)
        return enc, joint_mask, dec

    def classify(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 vis_feats: Optional[torch.Tensor] = None,
                 boxes: Optional[torch.Tensor] = None,
                 img_order_ids=None, obj_order_ids=None,
                 ctx: Optional[PetContext] = None, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The classifier head's forward (vlpet_tpu/models/vlbart.py:330-346):
        one ``decoder_start_token_id`` a row through the decoder, the
        answer logits (B, num_answers) fp32 of its state. Training
        (``deterministic`` False) drops as ``forward`` does."""
        B = input_ids.shape[0]
        dec_ids = torch.full((B, 1), self.cfg.backbone.decoder_start_token_id,
                             dtype=torch.long, device=input_ids.device)
        _, _, dec = self._run(input_ids, attention_mask, dec_ids, vis_feats,
                              boxes, self._ctx(ctx), deterministic, generator,
                              img_order_ids, obj_order_ids)
        return self.answer_head(dec[:, -1])

    def _ce(self, dec_out: torch.Tensor, labels: torch.Tensor,
            reduce_loss: bool):
        """(loss, logits or None), routed as
        vlpet_tpu/models/vlbart.py:220-260 with a frozen LM head:
        ``fused_linear_ce`` (C1/C2, no logits: None) under
        ``use_fused_ce``, in bf16 and fp32 alike, else ``linear_ce`` (one
        bf16 logits copy) in bf16; otherwise ``cross_entropy_with_ignore``
        over the fp32 logits. The JAX package's row-tile and backend tests
        (``pick_row_tile``, ``jax.default_backend()``) are TPU artefacts
        and are dropped. The LM-head adapter counts as an unfrozen head
        (vlpet_tpu/models/vlbart.py:230-236): the dense route, no C1 / C2."""
        p = self.cfg.pet
        head_frozen = (not p.use_lm_head_adapter and not p.unfreeze_lm_head
                       and not p.unfreeze_language_model)
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
                                 vis_attention_mask, self._ctx(ctx))

    def init_decode(self, encoder_hidden_states,
                    ctx: Optional[PetContext] = None) -> DecodeConsts:
        """What every decode step reuses: the cross-attention K/V
        (B, S, H*Dh) of every decoder layer, the hypernet's adapter weights
        (the JAX package regenerates them every step: the same values) and
        the other loop invariants."""
        ctx = self._ctx(ctx)
        return DecodeConsts(
            self.model.compute_cross_kvs(encoder_hidden_states, ctx),
            self.model.decoder.fused_self_qkvs(),
            self.model.decoder.block_adapters(self.model.task_embedding(ctx)),
            self.logits_weight())

    def prefill_kvs(self, batch_size: int,
                    ctx: Optional[PetContext] = None):
        """Per decoder layer the (k, v) (B, P, H*Dh) of the first P cache
        slots -- the decoder's attention prefixes or its input prompt's
        dry-run K/V (``BartDecoder.prefill_kvs``) -- or None."""
        ctx = self._ctx(ctx)
        return self.model.decoder.prefill_kvs(
            batch_size, ctx, self.model.task_embedding(ctx))

    def decode_step(self, decoder_input_ids, joint_mask, consts: DecodeConsts,
                    cache, decode_pos: int, ctx: Optional[PetContext] = None,
                    beam_anc=None):
        """One decode step -> (logits (B, V) f32, cache)."""
        dec_out, cache = self.model.decode(decoder_input_ids, joint_mask,
                                           self._ctx(ctx), consts, cache,
                                           decode_pos, beam_anc)
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
