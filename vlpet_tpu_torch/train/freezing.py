"""Freezing engine, ported from vlpet_tpu/train/freezing.py.

The reference's name-driven selective unfreeze (reference:
src/trainer_base.py:268-542): everything is frozen, then additive
substring rules over the parameter's dotted path unfreeze what the PET
recipe trains. The port's ``named_parameters()`` names are the flax paths
(vlpet_tpu_torch/convert.py; a Dense ``kernel`` is ``weight`` here, which
no rule reads), so the rules below are the JAX package's, rule for rule,
and select the same tensors. ``apply_freezing`` sets ``requires_grad``.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from vlpet_tpu_torch.config import PetConfig

# module names that are AdapterController instances (reference isinstance
# check at trainer_base.py:393-397)
_CONTROLLER_NAMES = (
    "attn_adapter", "ff_adapter", "self_attn_adapter", "enc_attn_adapter",
    "decoder_self_attn_adapter", "decoder_enc_attn_adapter", "decoder_ff_adapter",
    "decoder_enc_attn_key_value_adapter", "attn_value_parallel_adapter",
    "attn_key_parallel_adapter", "enc_attn_value_sequential_adapter",
)
_CONTROLLER_RE = re.compile(r"(^|\.)(" + "|".join(_CONTROLLER_NAMES) + r")\.")

# buffers: never trainable (the reference registers them as buffers)
_BUFFER_RE = re.compile(r"final_logits_bias")


def _is_layer_norm(name: str) -> bool:
    return "layer_norm" in name or "layernorm" in name


def path_is_trainable(name: str, pet: PetConfig) -> bool:
    """Substring trainability decision for one parameter path."""
    return _decide(name, pet)


def _decide(name: str, pet: PetConfig) -> bool:
    if _BUFFER_RE.search(name):
        return False
    t = False
    if not pet.freeze_vis_emb and "visual_embedding" in name:
        t = True
    if pet.unfreeze_language_model:
        # lm_head/shared + every encoder/decoder param
        if ("lm_head" in name or "shared" in name
                or ".encoder." in name or ".decoder." in name):
            t = True
    if pet.unfreeze_lm_head and ("lm_head" in name or name.endswith("shared")
                                 or ".shared" in name):
        t = True
    if pet.use_lora and ("lora" in name or "bias" in name):
        t = True
    if (pet.encoder_prompt_len > 0 or pet.decoder_prompt_len > 0) \
            and ("prompt_modules" in name or "prefix_embedding" in name):
        t = True
    if pet.use_vis_adapter and "vis_encoder" in name and re.search(
            r"(front|middle|back|transition)_adapter", name):
        t = True
    if pet.unfreeze_vis_encoder and "vis_encoder" in name:
        t = True
    if pet.unfreeze_vis_last_layer and "vis_encoder" in name and "layer4" in name:
        t = True
    if pet.unfreeze_layer_norms and _is_layer_norm(name):
        t = True
    if pet.unfreeze_batch_norms and "batch_norm" in name:
        t = True
    if (pet.use_adapter or pet.use_compacter or pet.use_lradapter) \
            and _CONTROLLER_RE.search(name):
        t = True
    if pet.use_lm_head_adapter and "output_adapter" in name:
        t = True
    if pet.use_hyperformer and ("shared_task_embed" in name
                                or "adapter_layers_hyper_net" in name):
        t = True
    if pet.use_compacter and "phm_rule" in name and pet.learn_phm:
        t = True
    if pet.use_compacter and "phm_W_" in name:
        t = True  # model-shared Compacter slow weights (shared_W_phm)
    if pet.unfreeze_encoder_layer_norms and "encoder." in name and _is_layer_norm(name):
        t = True
    if pet.unfreeze_decoder_layer_norms and "decoder." in name and _is_layer_norm(name):
        t = True
    if pet.unfreeze_decoder_input_layer_norms and "decoder." in name \
            and "layernorm_embedding" in name:
        t = True
    if pet.unfreeze_decoder_self_attn_layer_norms and "decoder." in name \
            and "self_attn_layer_norm" in name:
        t = True
    if pet.unfreeze_decoder_encoder_attn_layer_norms and "decoder." in name \
            and "encoder_attn_layer_norm" in name:
        t = True
    if pet.unfreeze_decoder_ff_layer_norms and "decoder." in name \
            and "final_layer_norm" in name:
        t = True
    if pet.unfreeze_bias and "bias" in name:
        t = True
    if pet.unfreeze_encoder_bias and "encoder." in name and "bias" in name:
        t = True
    if pet.unfreeze_decoder_bias and "decoder." in name and "bias" in name:
        t = True
    if (pet.use_encoder_adapter_gating_large_x
            or pet.use_encoder_adapter_gating_large_x_lowrank
            or pet.use_encoder_gating_large_x_lowrank
            or pet.use_decoder_enc_attn_adapter_gating_large_x_lowrank
            or pet.use_encoder_adapter_gating_small_xy_cat
            or pet.use_encoder_adapter_gating_middle_xy_add
            or pet.use_encoder_adapter_gating_middle_ia3_add) and "gating" in name:
        t = True
    if (pet.use_decoder_enc_attn_value_parallel_adapter_down_dim
            or pet.use_decoder_enc_attn_key_parallel_adapter_down_dim
            or pet.use_decoder_enc_attn_key_value_adapter_down_dim
            or pet.use_decoder_enc_attn_adapter_down_dim
            or pet.use_decoder_enc_attn_value_sequential_adapter_down_dim
            or pet.use_encoder_attn_value_parallel_adapter_down_dim
            or pet.use_encoder_adapter_down_multihead
            or pet.use_encoder_adapter_up_multihead
            or pet.use_encoder_adapter_down_up_multihead
            or pet.use_encoder_adapter_down_up_pair_multihead
            or pet.use_decoder_enc_attn_value_parallel_adapter_down_multihead
            or pet.use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead
            or pet.use_decoder_self_attn_value_parallel_adapter_down_dim
            or pet.use_decoder_self_attn_adapter_down_dim
            or pet.use_decoder_ff_adapter_down_dim
            or pet.use_decoder_adapter_down_multihead) and "adapter" in name:
        t = True
    if (pet.use_decoder_enc_attn_value_ia3 or pet.use_encoder_attn_value_ia3
            or pet.use_decoder_self_attn_value_ia3
            or pet.use_decoder_ff_ia3) and "ia3" in name:
        t = True
    return t


def apply_freezing(model: torch.nn.Module,
                   pet: PetConfig) -> Dict[str, torch.nn.Parameter]:
    """Set ``requires_grad`` on every parameter by the rules above; returns
    the trainable parameters by name, in ``named_parameters()`` order."""
    trainable = {}
    for name, p in model.named_parameters():
        p.requires_grad_(_decide(name, pet))
        if p.requires_grad:
            trainable[name] = p
    return trainable


def trainable_report(model: torch.nn.Module, pet: PetConfig) -> Dict:
    """The reference's trainable-parameter accounting
    (trainer_base.py:237-266): percentage = trainable / total * 100, with
    buffers (final_logits_bias) excluded from both."""
    total = trainable = 0
    for name, p in model.named_parameters():
        if _BUFFER_RE.search(name):
            continue
        total += p.numel()
        if _decide(name, pet):
            trainable += p.numel()
    return {"total": total, "trainable": trainable,
            "percentage": 100.0 * trainable / max(total, 1)}
