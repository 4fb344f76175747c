"""Visual embedding and grid downsampling for the joint encoder, ported
from vlpet_tpu/models/visual.py (VisualEmbedding, _pos_with_area,
downsample_vis). The low-rank and expand projectors are not on the ported
slice. With ``t5_style_ln`` (the T5 joint encoder) the visual embedding's
norms are RMSNorm with eps 1e-6 (vlpet_tpu/models/visual.py:141-144)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import VisConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm, RMSNorm
from vlpet_tpu_torch.pet.modules import TaskDense


def adaptive_max_pool_grid(x: torch.Tensor, out_hw) -> torch.Tensor:
    """AdaptiveMaxPool2d over a square token grid: (B, g*g, D) ->
    (B, s_h*s_w, D)."""
    B, L, D = x.shape
    g = int(round(L ** 0.5))
    if g * g != L:
        raise ValueError(f"grid length {L} is not square")
    xg = x.reshape(B, g, g, D).permute(0, 3, 1, 2)
    pooled = F.adaptive_max_pool2d(xg, out_hw)
    return pooled.permute(0, 2, 3, 1).reshape(B, -1, D)


def adaptive_max_pool_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """AdaptiveMaxPool1d along the token axis: (B, L, D) -> (B, out_len, D)."""
    return F.adaptive_max_pool1d(x.transpose(1, 2), out_len).transpose(1, 2)


def downsample_vis(vis_inputs: tuple, n_boxes: int, oned: bool = False) -> tuple:
    """Pool grid features to n_boxes tokens; NLVR 4-tuples pool each of the
    paired images and re-concatenate."""

    def pool(feats):
        if oned:
            return adaptive_max_pool_1d(feats, n_boxes)
        s = int(round(n_boxes ** 0.5))
        return adaptive_max_pool_grid(feats, (s, s))

    if len(vis_inputs) == 4:
        feats, boxes, img_order_ids, obj_order_ids = vis_inputs
        B, L, _ = feats.shape
        half = L // 2
        pooled = pool(torch.cat([feats[:, :half], feats[:, half:]], dim=0))
        feats = torch.cat([pooled[:B], pooled[B:]], dim=1)
        n = feats.shape[1] // 2

        def trim(a):
            return torch.cat([a[:, :half][:, :n], a[:, half:][:, :n]], dim=1)

        return feats, trim(boxes), trim(img_order_ids), trim(obj_order_ids)
    feats = pool(vis_inputs[0])
    return feats, vis_inputs[1][:, :feats.shape[1]]


def _pos_with_area(pos: torch.Tensor) -> torch.Tensor:
    """pos (B, N, 4) as (x1, x2, y1, y2) -> append the box area."""
    height = pos[:, :, 3] - pos[:, :, 2]
    width = pos[:, :, 1] - pos[:, :, 0]
    return torch.cat([pos, (height * width)[..., None]], dim=2)


class VisualEmbedding(nn.Module):
    """Linear(feat -> d) (+LN) + box-position embedding (+LN) + image-order
    embedding + object-order embedding read from the tail of the text
    embedding table."""

    def __init__(self, vis: VisConfig, d_model: int,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda",
                 t5_style_ln: bool = False):
        super().__init__()
        self.vis, self.dtype = vis, dtype
        kw = dict(dtype=dtype, device=device)
        self.feat_embedding = TaskDense(vis.feat_dim, d_model, **kw)
        self.absolute_vis_pos_embedding = TaskDense(vis.pos_dim + 1, d_model,
                                                    **kw)

        def norm():
            if t5_style_ln:
                return RMSNorm(d_model, eps=1e-6, **kw)
            return LayerNorm(d_model, **kw)

        individual = vis.use_vis_layer_norm and vis.individual_vis_layer_norm
        if individual:
            self.feat_layer_norm = norm()
            self.absolute_vis_pos_layer_norm = norm()
        if vis.use_vis_layer_norm and not vis.individual_vis_layer_norm:
            self.layer_norm = norm()
        if vis.use_vis_order_embedding:
            self.img_order_embedding = nn.Parameter(
                torch.empty((vis.n_images, d_model),
                            device=resolve_device(device)))

    def forward(self, feats: torch.Tensor, pos: torch.Tensor,
                embedding_table: torch.Tensor,
                img_order_ids: Optional[torch.Tensor] = None,
                obj_order_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        v = self.vis
        N = feats.shape[1]
        individual = v.use_vis_layer_norm and v.individual_vis_layer_norm
        feat_embedding = self.feat_embedding(feats)
        if individual:
            feat_embedding = self.feat_layer_norm(feat_embedding)
        abs_pos = self.absolute_vis_pos_embedding(
            _pos_with_area(pos.to(self.dtype)))
        if individual:
            abs_pos = self.absolute_vis_pos_layer_norm(abs_pos)
        if v.use_vis_order_embedding:
            dev = feats.device
            if img_order_ids is None:
                img_order_ids = torch.zeros((1, N), dtype=torch.long, device=dev)
            if obj_order_ids is None:
                obj_order_ids = torch.arange(N, device=dev)[None]
            img = self.img_order_embedding[img_order_ids]
            # reverse-index into the tail of the text vocabulary
            obj = embedding_table[embedding_table.shape[0] - obj_order_ids - 1]
            vis = (feat_embedding + abs_pos + img.to(self.dtype)
                   + obj.to(self.dtype))
        else:
            vis = feat_embedding + abs_pos
        if v.use_vis_layer_norm and not v.individual_vis_layer_norm:
            vis = self.layer_norm(vis)
        return vis

    def tokens(self, vis_feats: torch.Tensor, boxes: torch.Tensor,
               embedding_table: torch.Tensor,
               img_order_ids: Optional[torch.Tensor] = None,
               obj_order_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The joint encoder's visual tokens: features, boxes and order ids
        downsampled as the config asks, then embedded."""
        v = self.vis
        vis_inputs = (vis_feats, boxes)
        if img_order_ids is not None:
            vis_inputs = (vis_feats, boxes, img_order_ids, obj_order_ids)
        if v.oneddownsample or v.downsample:
            vis_inputs = downsample_vis(vis_inputs, v.n_boxes,
                                        oned=v.oneddownsample)
        io = vis_inputs[2] if len(vis_inputs) == 4 else img_order_ids
        oo = vis_inputs[3] if len(vis_inputs) == 4 else obj_order_ids
        return self(vis_inputs[0], vis_inputs[1], embedding_table,
                    img_order_ids=io, obj_order_ids=oo)


def joint_attention_mask(attention_mask: torch.Tensor, n_vis: int,
               vis_attention_mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """[text mask; visual mask] (B, L + n_vis); all visual tokens are kept
    unless ``vis_attention_mask`` says otherwise."""
    if vis_attention_mask is None:
        vis_attention_mask = torch.ones(
            (attention_mask.shape[0], n_vis), dtype=attention_mask.dtype,
            device=attention_mask.device)
    return torch.cat([attention_mask, vis_attention_mask], dim=1)
