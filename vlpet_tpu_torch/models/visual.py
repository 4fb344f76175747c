"""Visual embedding and grid downsampling for the joint encoder, ported
from vlpet_tpu/models/visual.py (VisualEmbedding, LowRankVisualEmbedding,
ExpandVisualEmbedding, _pos_with_area, downsample_vis, sparse_sample). With
``t5_style_ln`` (the T5 joint encoder) the visual embedding's norms are
RMSNorm with eps 1e-6 (vlpet_tpu/models/visual.py:141-144).
``visual_embedding_class`` picks the projector a config asks for."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.config import VisConfig
from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import LayerNorm, RMSNorm
from vlpet_tpu_torch.ops.activations import gelu_new
from vlpet_tpu_torch.pet.modules import TaskDense, fuse_heads, per_head_param


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


def sparse_scores(shape, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """The (B, L) uniform scores of ``sparse_sample``, drawn from the
    training step's generator. A data-parallel rank draws them for the
    global batch and keeps its own rows (``PetContext.example_base``,
    ``global_batch``), as one process on the whole batch draws them."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device if generator is not None
                      else device).to(device)


def sparse_sample(feats: torch.Tensor, out_len: int,
                  scores: torch.Tensor) -> torch.Tensor:
    """A random sorted subsample of ``out_len`` of the (B, L, D) tokens at
    train time (vlpet_tpu/models/visual.py:107-115): the tokens of the
    ``out_len`` lowest ``scores`` (B, L) of each row, in their order. The
    JAX function draws its scores from its rng; here the caller hands them
    in (``sparse_scores``)."""
    order = torch.argsort(scores, dim=-1, stable=True)
    idx = torch.sort(order[:, :out_len], dim=-1).values
    return torch.gather(feats, 1,
                        idx[..., None].expand(-1, -1, feats.shape[-1]))


def _pos_with_area(pos: torch.Tensor) -> torch.Tensor:
    """pos (B, N, 4) as (x1, x2, y1, y2) -> append the box area."""
    height = pos[:, :, 3] - pos[:, :, 2]
    width = pos[:, :, 1] - pos[:, :, 0]
    return torch.cat([pos, (height * width)[..., None]], dim=2)


class _Tokens:
    """The joint encoder's entry to a visual projector: ``tokens``."""

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


class VisualEmbedding(_Tokens, nn.Module):
    """Linear(feat -> d) (+LN) + box-position embedding (+LN) + image-order
    embedding + object-order embedding read from the tail of the text
    embedding table."""

    FEAT_NORM = "feat_layer_norm"  # the feature projection's own norm

    def __init__(self, vis: VisConfig, d_model: int,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda",
                 t5_style_ln: bool = False):
        super().__init__()
        self.vis, self.dtype = vis, dtype
        kw = dict(dtype=dtype, device=device)
        self._projector(vis, d_model, kw)
        self.absolute_vis_pos_embedding = TaskDense(vis.pos_dim + 1, d_model,
                                                    **kw)

        def norm():
            if t5_style_ln:
                return RMSNorm(d_model, eps=1e-6, **kw)
            return LayerNorm(d_model, **kw)

        individual = vis.use_vis_layer_norm and vis.individual_vis_layer_norm
        if individual:
            self.add_module(self.FEAT_NORM, norm())
            self.absolute_vis_pos_layer_norm = norm()
        if vis.use_vis_layer_norm and not vis.individual_vis_layer_norm:
            self.layer_norm = norm()
        if vis.use_vis_order_embedding:
            self.img_order_embedding = nn.Parameter(
                torch.empty((vis.n_images, d_model),
                            device=resolve_device(device)))

    def _projector(self, vis: VisConfig, d_model: int, kw) -> None:
        self.feat_embedding = TaskDense(vis.feat_dim, d_model, **kw)

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        """The features' d-wide embedding, before the feature norm."""
        return self.feat_embedding(feats)

    def forward(self, feats: torch.Tensor, pos: torch.Tensor,
                embedding_table: torch.Tensor,
                img_order_ids: Optional[torch.Tensor] = None,
                obj_order_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        v = self.vis
        N = feats.shape[1]
        individual = v.use_vis_layer_norm and v.individual_vis_layer_norm
        feat_embedding = self.project(feats)
        if individual:
            feat_embedding = self._modules[self.FEAT_NORM](feat_embedding)
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


class LowRankVisualEmbedding(VisualEmbedding):
    """VL-PET's lightweight visual projector
    (vlpet_tpu/models/visual.py:186): ``VisualEmbedding`` with the
    feature projection replaced by h heads of feat -> x/h (concat;
    ``visual_projector_multihead_down_kernel`` (h, feat, x/h) and its
    bias, one fused GEMM) -> gelu_new -> up x -> d
    (``visual_projector_multihead_up``), optionally times a low-rank
    sigmoid gate on the raw features (feat -> g -> d, the
    ``visual_projector_gating_large_x_down`` / ``_up`` pair; with the
    residual flag e + e * gate); its individual feature norm is
    ``visual_projector_layer_norm``."""

    FEAT_NORM = "visual_projector_layer_norm"

    def _projector(self, vis: VisConfig, d_model: int, kw) -> None:
        h, x = vis.visual_projector_multihead_num_head, \
            vis.visual_projector_down_dim
        if x % h:
            raise ValueError(f"visual_projector_down_dim {x} not divisible "
                             f"by {h} heads")
        self.visual_projector_multihead_down_kernel = per_head_param(
            h, vis.feat_dim, x // h, kw["dtype"], kw["device"])
        self.visual_projector_multihead_down_bias = nn.Parameter(torch.empty(
            (h, x // h), dtype=kw["dtype"],
            device=resolve_device(kw["device"])))
        self.visual_projector_multihead_up = TaskDense(x, d_model, **kw)
        if vis.use_visual_projector_gating_large_x_lowrank:
            g = vis.visual_projector_gating_down_dim
            self.visual_projector_gating_large_x_down = TaskDense(
                vis.feat_dim, g, **kw)
            self.visual_projector_gating_large_x_up = TaskDense(g, d_model,
                                                                **kw)

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        v = self.vis
        x = feats.to(self.dtype)
        z = x @ fuse_heads(self.visual_projector_multihead_down_kernel) \
            + self.visual_projector_multihead_down_bias.reshape(-1)
        e = self.visual_projector_multihead_up(gelu_new(z))
        if v.use_visual_projector_gating_large_x_lowrank:
            gate = torch.sigmoid(self.visual_projector_gating_large_x_up(
                gelu_new(self.visual_projector_gating_large_x_down(feats))))
            e = e + e * gate if v.use_visual_projector_residual_connection \
                else e * gate
        return e


class ExpandVisualEmbedding(_Tokens, nn.Module):
    """One feature -> ``n_image_tokens`` tokens
    (vlpet_tpu/models/visual.py:268): ``feat_embedding`` feat -> d *
    n_image_tokens, each feature's output read as n_image_tokens d-wide
    tokens, then ``layer_norm`` (a LayerNorm on both backbones' JAX
    module) under ``use_vis_layer_norm``. Boxes and order ids are not
    read."""

    def __init__(self, vis: VisConfig, d_model: int,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.vis, self.dtype, self.d = vis, dtype, d_model
        kw = dict(dtype=dtype, device=device)
        self.feat_embedding = TaskDense(vis.feat_dim,
                                        d_model * vis.n_image_tokens, **kw)
        if vis.use_vis_layer_norm:
            self.layer_norm = LayerNorm(d_model, **kw)

    def forward(self, feats: torch.Tensor, pos: torch.Tensor,
                embedding_table: torch.Tensor,
                img_order_ids: Optional[torch.Tensor] = None,
                obj_order_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if feats.ndim == 2:
            feats = feats[:, None, :]
        out = self.feat_embedding(feats.to(self.dtype))
        out = out.reshape(feats.shape[0], -1, self.d)
        if self.vis.use_vis_layer_norm:
            out = self.layer_norm(out)
        return out


def visual_embedding_class(vis: VisConfig):
    """The projector of a config, in the JAX package's order: expand, then
    low-rank (vlpet_tpu/models/bart.py:991-997; the T5, which refuses the
    expand projector, vlpet_tpu/models/t5.py:601)."""
    if vis.expand_vis_embedding:
        return ExpandVisualEmbedding
    if vis.use_lowrank_visual_projector:
        return LowRankVisualEmbedding
    return VisualEmbedding


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
