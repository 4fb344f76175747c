"""BART sequence-classification and extractive-QA heads, ported from
vlpet_tpu/models/bart_heads.py (reference: modeling_bart.py:1791-1812,
:2651-2840). Both run over the port's VLBartModel core with text only (no
visual inputs), so every attention, FFN and dropping LayerNorm of the pass
goes through the kernels of models/bart.py.

The heads' dense layers are fp32 (flax nn.Dense's parameters; the product
promotes the compute-dtype states), named as the flax tree:
``classification_head.dense`` / ``.out_proj`` and ``qa_outputs``.
``init_weights`` is the JAX package's BART scheme (models/vlbart.py
``seeded_init``). ``deterministic=False`` drops as ``VLBart.forward``
does, one seed per site drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.vlbart import (VLBartModel, dropout_sites, drops,
                                           seeded_init)
from vlpet_tpu_torch.ops.hashdrop import DropoutSeeds
from vlpet_tpu_torch.pet.modules import PetContext, TaskDense


class BartClassificationHead(nn.Module):
    """dense -> tanh -> out_proj (vlpet_tpu/models/bart_heads.py:27, whose
    two dropouts take ``pooler_dropout`` from a ``classifier_dropout`` the
    BART config does not have: rate 0, the identity)."""

    def __init__(self, inner_dim: int, num_classes: int,
                 device: Device = "cuda"):
        super().__init__()
        self.dense = TaskDense(inner_dim, inner_dim, device=device)
        self.out_proj = TaskDense(inner_dim, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(torch.tanh(self.dense(x.float())))


class _TextHead(nn.Module):
    """The VLBartModel core and its training-time seeds."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__()
        if cfg.is_t5:
            raise ValueError("the BART heads need a BART backbone")
        self.cfg = cfg
        self.model = VLBartModel(cfg, device=resolve_device(device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        seeded_init(self, self.cfg, generator)
        return self

    def _decode(self, input_ids, attention_mask, decoder_input_ids, ctx,
                deterministic: bool, generator):
        """(decoder states, decoder input ids: the input by default)."""
        ctx = ctx or PetContext()
        seeds = None
        if not deterministic and drops(self.cfg):
            seeds = DropoutSeeds(dropout_sites(self.cfg), generator,
                                 input_ids.device)
            seeds.example_base = ctx.example_base
        if decoder_input_ids is None:
            decoder_input_ids = input_ids
        dec, _, _ = self.model(input_ids, attention_mask, decoder_input_ids,
                               ctx=ctx, seeds=seeds)
        return dec, decoder_input_ids


class BartForSequenceClassification(_TextHead):
    """Pools the decoder state at the LAST <eos> of each row and classifies
    (vlpet_tpu/models/bart_heads.py:45-99). ``decoder_input_ids`` defaults
    to the input; a row with no <eos> pools to NaN, as the JAX module does
    (its data-dependent raise cannot exist under jit)."""

    def __init__(self, cfg: VLModelConfig, num_labels: int = 3,
                 device: Device = "cuda"):
        super().__init__(cfg, device)
        self.classification_head = BartClassificationHead(
            cfg.backbone.d_model, num_labels, device=resolve_device(device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                decoder_input_ids: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        dec, dec_ids = self._decode(input_ids, attention_mask,
                                    decoder_input_ids, ctx, deterministic,
                                    generator)
        T = dec_ids.shape[1]
        pos = torch.arange(T, device=dec_ids.device)[None, :]
        is_eos = dec_ids == self.cfg.backbone.eos_token_id
        last_eos = torch.where(is_eos, pos, -1).amax(dim=1)  # (B,)
        pooled = torch.gather(dec, 1, last_eos.clamp_min(0)[:, None, None]
                              .expand(-1, 1, dec.shape[-1]))[:, 0]
        pooled = torch.where((last_eos >= 0)[:, None], pooled,
                             torch.full_like(pooled, float("nan")))
        logits = self.classification_head(pooled)
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = F.cross_entropy(logits.float(), labels.long())
        return out


class BartForQuestionAnswering(_TextHead):
    """Span extraction: start and end logits over the decoder states
    (vlpet_tpu/models/bart_heads.py:102-149). Positions outside [0, T]
    are clamped to the ignored index T; the loss is the mean of the start
    and end CEs over the rows not ignored."""

    def __init__(self, cfg: VLModelConfig, device: Device = "cuda"):
        super().__init__(cfg, device)
        self.qa_outputs = TaskDense(cfg.backbone.d_model, 2,
                                    device=resolve_device(device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                decoder_input_ids: Optional[torch.Tensor] = None,
                start_positions: Optional[torch.Tensor] = None,
                end_positions: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        dec, _ = self._decode(input_ids, attention_mask, decoder_input_ids,
                              ctx, deterministic, generator)
        logits = self.qa_outputs(dec.float())  # (B, T, 2)
        start, end = logits[..., 0], logits[..., 1]
        out = {"start_logits": start, "end_logits": end}
        if start_positions is not None and end_positions is not None:
            T = start.shape[1]

            def ce(lg, pos):
                pos = pos.long().clamp(0, T)  # T: the ignored index
                valid = pos < T
                logp = torch.log_softmax(lg.float(), dim=-1)
                picked = logp.gather(1, pos.clamp(max=T - 1)[:, None])[:, 0]
                return (-torch.where(valid, picked, 0.0).sum()
                        / valid.sum().clamp(min=1))

            out["loss"] = 0.5 * (ce(start, start_positions)
                                 + ce(end, end_positions))
        return out
