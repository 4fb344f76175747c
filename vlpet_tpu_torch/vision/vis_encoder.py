"""Raw-image path: the CLIP trunk runs inside the model forward, ported from
vlpet_tpu/vision/vis_encoder.py.

Reference: src/vis_encoder.py (get_vis_encoder) + VLBart.vis_forward
(src/modeling_bart.py:1604-1620) -- with --feature_type raw_<backbone> the
batch carries raw images and the visual features are computed on the fly,
optionally end-to-end trainable (--unfreeze_vis_encoder /
--use_vis_adapter). The trunk (``vis_encoder``) and the VL model (``vl``)
live in one module, so the freezing engine sees ``vis_encoder.*`` names and
one backward runs through both. The VL model's hand-written kernels serve
the raw path at its joint lengths; the trunk is plain PyTorch
(vision/clip.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from vlpet_tpu_torch.config import VLModelConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.bart import compute_dtype
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.vision.clip import RAW_FEAT_DIMS, CLIPVisualEncoder


class RawInputVLModel(nn.Module):
    """CLIP visual trunk + VLBart / VLT5 in one module.

    ``forward`` and the generation protocol (``encode``, ``init_decode``,
    ``prefill_kvs``, ``decode_step``, ``decode_step_topk``) take the
    images, (B, 3, H, W) or the NLVR pair (B, 2, 3, H, W), in the
    vis_feats slot, so the train step and models/generate.py run
    unchanged; the boxes are zeros (reference: vis_forward sets vis_pos
    zeros). With
    ``vis_pooling_output`` the pooled (B, 1, output_dim) vector is the
    one visual token: it fits the feature projection only where
    ``cfg.vis.feat_dim`` is the trunk's output_dim, and raises otherwise,
    as the JAX model does. Built on the card unless ``device`` says
    otherwise."""

    def __init__(self, cfg: VLModelConfig, vis_backbone: str = "RN101",
                 image_size: int = 224,
                 vis_adapter_type: Optional[str] = None,
                 vis_reduction_factor: int = 2, use_bn: bool = True,
                 vis_pooling_output: bool = False, device: Device = "cuda"):
        super().__init__()
        from vlpet_tpu_torch.models.t5 import VLT5
        from vlpet_tpu_torch.models.vlbart import VLBart

        dev = resolve_device(device)
        self.cfg = cfg
        self.vis_pooling_output = vis_pooling_output
        self.vis_encoder = CLIPVisualEncoder(
            backbone=vis_backbone, image_size=image_size,
            adapter_type=vis_adapter_type,
            reduction_factor=vis_reduction_factor, use_bn=use_bn,
            dtype=compute_dtype(cfg), device=dev)
        self.vl = (VLT5 if cfg.is_t5 else VLBart)(cfg, device=dev)
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RawInputVLModel":
        """The VL model's seeded init (with the recipe's re-inits), then
        the trunk's (``CLIPVisualEncoder.init_weights``)."""
        self.vl.init_weights(generator)
        self.vis_encoder.init_weights(generator)
        return self

    def vis_forward(self, images: torch.Tensor):
        """(B, 3, H, W) -> single-image features, or (B, n, 3, H, W) ->
        n-image features laid out as n * V_L tokens per example with
        img_order_ids 0..n-1 and tiled obj_order_ids (the NLVR two-image
        layout; reference: nlvr_model.py:17-45 flattens (B, 2, ...) ->
        (2B, ...) through the trunk and views the features back to
        (B, 2 * V_L, -1)).

        Returns (feats, boxes, img_order_ids, obj_order_ids); the order ids
        are None for one image, (1, n * V_L) for n."""
        n_images = images.shape[1] if images.dim() == 5 else 1
        B = images.shape[0]
        if n_images > 1:
            images = images.reshape((B * n_images,) + images.shape[2:])
        grid, pooled = self.vis_encoder(images)
        feats = pooled if self.vis_pooling_output else grid
        img_order_ids = obj_order_ids = None
        if n_images > 1:
            V_L = feats.shape[1]
            feats = feats.reshape(B, n_images * V_L, feats.shape[-1])
            ids = torch.arange(n_images, device=feats.device)
            img_order_ids = ids.repeat_interleave(V_L)[None]
            obj_order_ids = torch.arange(V_L, device=feats.device).repeat(
                n_images)[None]
        # the trunk's tokens as a fresh contiguous tensor for the encoder
        feats = feats.contiguous()
        boxes = torch.zeros(feats.shape[:2] + (4,), dtype=feats.dtype,
                            device=feats.device)
        return feats, boxes, img_order_ids, obj_order_ids

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                vis_feats: torch.Tensor, boxes=None,
                labels: Optional[torch.Tensor] = None,
                ctx: Optional[PetContext] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                img_order_ids=None, obj_order_ids=None,
                vis_attention_mask=None,
                decoder_input_ids: Optional[torch.Tensor] = None,
                reduce_loss: bool = False) -> Dict[str, Any]:
        """The trunk on the images in the ``vis_feats`` slot, then the VL
        model's forward on its features (``VLBart.forward`` /
        ``VLT5.forward``), so train/steps.py make_train_step and the
        Trainer's scoring take this model as they take the VL model.
        ``boxes`` is not read (the trunk's boxes are zeros); the trunk's
        order ids stand where the batch has none."""
        feats, fboxes, f_img, f_obj = self.vis_forward(vis_feats)
        return self.vl(input_ids, attention_mask, vis_feats=feats,
                       boxes=fboxes,
                       img_order_ids=(f_img if img_order_ids is None
                                      else img_order_ids),
                       obj_order_ids=(f_obj if obj_order_ids is None
                                      else obj_order_ids),
                       vis_attention_mask=vis_attention_mask, labels=labels,
                       decoder_input_ids=decoder_input_ids, ctx=ctx,
                       deterministic=deterministic, generator=generator,
                       reduce_loss=reduce_loss)

    # --- generation-facing methods (models/generate.py protocol) ------------

    @torch.no_grad()
    def encode(self, input_ids, attention_mask, vis_feats, boxes=None,
               img_order_ids=None, obj_order_ids=None, vis_attention_mask=None,
               ctx: Optional[PetContext] = None):
        """Images ride in the vis_feats slot of the generation protocol
        (``vis_feats`` holds the images): the trunk runs here, then the
        joint encoder."""
        feats, fboxes, f_img, f_obj = self.vis_forward(vis_feats)
        return self.vl.encode(input_ids, attention_mask, feats, fboxes,
                              f_img if img_order_ids is None else img_order_ids,
                              f_obj if obj_order_ids is None else obj_order_ids,
                              vis_attention_mask, ctx)

    def init_decode(self, encoder_hidden_states,
                    ctx: Optional[PetContext] = None):
        return self.vl.init_decode(encoder_hidden_states, ctx)

    def prefill_kvs(self, batch_size: int, ctx: Optional[PetContext] = None):
        return self.vl.prefill_kvs(batch_size, ctx)

    def decode_step(self, decoder_input_ids, joint_mask, consts, cache,
                    decode_pos: int, ctx: Optional[PetContext] = None,
                    beam_anc=None):
        return self.vl.decode_step(decoder_input_ids, joint_mask, consts,
                                   cache, decode_pos, ctx, beam_anc)

    def decode_step_topk(self, decoder_input_ids, joint_mask, consts, cache,
                         decode_pos: int, k: int,
                         ctx: Optional[PetContext] = None, beam_anc=None):
        return self.vl.decode_step_topk(decoder_input_ids, joint_mask, consts,
                                        cache, decode_pos, k, ctx, beam_anc)


def raw_feat_dim(backbone: str) -> int:
    """feat_dim per raw backbone (reference: multitask.py:648-660)."""
    return RAW_FEAT_DIMS[backbone]
