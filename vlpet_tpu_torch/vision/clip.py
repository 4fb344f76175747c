"""CLIP visual encoders, ported from vlpet_tpu/vision/clip.py: the
ModifiedResNet trunk (with the conv VisualAdapters) and the ViT, and the
grid-feature wrapper of the raw-image path.

Reference: src/clip/model.py (Bottleneck :9, VisualAdapter :178,
AttentionPool2d :119, ModifiedResNet :222, VisualTransformer :344) and
src/vis_encoder.py:254-322 (CLIPResNetEncoder).

Layout: NCHW, as PyTorch's convolutions take it; the parameter names are
OpenAI CLIP's visual state dict (``layer1.0.conv1``, ``attnpool.q_proj``,
``transformer.resblocks.0.attn.in_proj_weight``), so ``clip_import`` is
close to a plain load. The JAX package's NHWC grid flattens to tokens in
(h, w) order, and so does this one (``flatten(2)`` of NCHW, then the
channel axis last). Convolutions, the trunk's attention and its
BatchNorms run as plain PyTorch: the JAX package computes them outside any
Pallas kernel.

BatchNorm (``BatchNorm2d`` here) always normalizes with its running
statistics, in train mode too, and never updates them: the JAX trunk's
BatchNorms run with ``use_running_average`` (the train step never asks for
batch statistics), the reference's frozen-encoder usage.

Parameters: convolution and dense weights (and dense biases) in the
compute dtype, as the port keeps its dense layers; BatchNorm and
LayerNorm parameters, the BatchNorm statistics and the positional and
class embeddings in fp32 (the compute-dtype copy is taken where they are
used, as the JAX modules cast them).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.norm import layer_norm

BN_EPS = 1e-5  # flax BatchNorm's default


class BatchNorm2d(nn.Module):
    """Inference-mode BatchNorm over NCHW: (x - mean) / sqrt(var + eps) *
    weight + bias with fp32 statistics and parameters, in fp32 arithmetic,
    the output in the input's dtype (flax's BatchNorm promotes the same
    way). ``F.batch_norm`` with ``training=False`` takes a bf16 input with
    fp32 parameters, and its autograd keeps only the input. Parameters
    ``weight`` / ``bias`` and buffers ``running_mean`` / ``running_var``
    (OpenAI CLIP's names, without num_batches_tracked)."""

    def __init__(self, dim: int, device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))
        self.register_buffer("running_mean", torch.zeros(dim, device=dev))
        self.register_buffer("running_var", torch.ones(dim, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            momentum=0.0, eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = None,
          dtype=torch.float32, device: Device = "cuda") -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if padding is None else padding,
                     bias=False, dtype=dtype, device=resolve_device(device))


class VisualAdapter(nn.Module):
    """Conv1x1 bottleneck (down -> BN -> ReLU -> up -> BN) or basic conv
    adapter (reference: clip/model.py:178-218). Returns the delta."""

    def __init__(self, input_dim: int, output_dim: int,
                 adapter_kind: str = "bottleneck", reduction_factor: int = 16,
                 use_bn: bool = True, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.kind, self.use_bn = adapter_kind, use_bn
        kw = dict(dtype=dtype, device=device)
        if adapter_kind == "bottleneck":
            down = input_dim // reduction_factor
            self.down_sampler = _conv(input_dim, down, 1, **kw)
            self.up_sampler = _conv(down, output_dim, 1, **kw)
            if use_bn:
                self.bn1 = BatchNorm2d(down, device=device)
                self.bn2 = BatchNorm2d(output_dim, device=device)
        elif adapter_kind == "basic":
            self.conv = _conv(input_dim, output_dim, 1, **kw)
            if use_bn:
                self.bn = BatchNorm2d(output_dim, device=device)
        else:
            raise NotImplementedError(adapter_kind)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "bottleneck":
            z = self.down_sampler(x)
            if self.use_bn:
                z = self.bn1(z)
            out = self.up_sampler(F.relu(z))
            return self.bn2(out) if self.use_bn else out
        out = self.conv(x)
        return self.bn(out) if self.use_bn else out


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k <= 1 else F.avg_pool2d(x, k, stride=k)


class Bottleneck(nn.Module):
    """CLIP anti-aliased ResNet bottleneck with optional adapters
    (reference: clip/model.py:9-117). Adapter positions: front (input ->
    planes, added pre-ReLU around conv1), middle (around conv2), back
    (around conv3), transition (after the residual add). The downsample
    path is ``downsample.{-1 avg pool, 0 conv, 1 BN}``, OpenAI's
    Sequential."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 adapter_type: Optional[str] = None,
                 reduction_factor: int = 16, use_bn: bool = True,
                 dtype=torch.float32, expansion: int = 4,
                 device: Device = "cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = planes * expansion
        self.stride, self.use_bn = stride, use_bn
        self.pos = adapter_type.split("-")[0] if adapter_type else ""
        kind = adapter_type.split("-")[1] if adapter_type else ""

        def adapter(i, o):
            return VisualAdapter(i, o, kind, reduction_factor, use_bn, **kw)

        self.conv1 = _conv(inplanes, planes, 1, **kw)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, **kw)
        self.bn2 = BatchNorm2d(planes, device=device)
        self.conv3 = _conv(planes, out, 1, **kw)
        self.bn3 = BatchNorm2d(out, device=device)
        if "front" in self.pos:
            self.front_adapter = adapter(inplanes, planes)
        if "middle" in self.pos:
            self.middle_adapter = adapter(planes, planes)
        if "back" in self.pos:
            self.back_adapter = adapter(planes, out)
        if "transition" in self.pos:
            self.transition_adapter = adapter(out, out)
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", _conv(inplanes, out, 1, **kw)),
                ("1", BatchNorm2d(out, device=device))]))

    def _with_adapter(self, name: str, h, bn, x_in):
        """bn(h) with the ``name`` adapter of ``x_in`` added (after the BN
        with use_bn, before it without)."""
        if name not in self.pos:
            return bn(h)
        a = getattr(self, f"{name}_adapter")(x_in)
        return a + bn(h) if self.use_bn else bn(a + h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self._with_adapter("front", self.conv1(x), self.bn1, x))
        out = F.relu(self._with_adapter("middle", self.conv2(out), self.bn2,
                                        out))
        out = avg_pool(out, self.stride)
        out = self._with_adapter("back", self.conv3(out), self.bn3, out)
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        out = F.relu(out + identity)
        if "transition" in self.pos:
            out = F.relu(self.transition_adapter(out) + out)
        return out


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 (jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(in_size: int, out_size: int,
                  device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of jax.image.resize(.., "cubic")
    along one axis (jax/_src/image/scale.py compute_weight_mat): half-pixel
    centres, the kernel widened by in/out when shrinking (antialias),
    columns normalized to sum 1, samples outside the input zeroed."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv \
        - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32,
                                       device=device)[:, None]).abs() \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(pos: torch.Tensor, new_len: int) -> torch.Tensor:
    """Bicubic grid resize keeping the CLS slot (vis_encoder.py:271-274),
    with jax.image.resize's cubic kernel (Keys, a = -0.5, antialiased when
    shrinking), not torch's bicubic (a = -0.75): one weight matrix per grid
    axis, contracted in fp32."""
    old_len = pos.shape[0]
    if old_len == new_len:
        return pos
    old_g = int(round((old_len - 1) ** 0.5))
    new_g = int(round((new_len - 1) ** 0.5))
    grid = pos[1:].float().reshape(old_g, old_g, -1)
    w = cubic_weights(old_g, new_g, pos.device)
    grid = torch.einsum("hwc,hy,wx->yxc", grid, w, w)
    return torch.cat([pos[:1], grid.reshape(new_g * new_g, -1).to(pos.dtype)])


class AttentionPool2d(nn.Module):
    """QKV attention pooling (reference: clip/model.py:119-155): the mean
    token, with the positional embedding added (resized when the grid
    differs from ``num_positions``), queries all tokens; multihead
    softmax attention, then ``c_proj``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, num_positions: int = 50,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty((num_positions, embed_dim), device=dev))
        kw = dict(dtype=dtype, device=dev)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.v_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, output_dim)."""
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, H*W, C), (h, w) order
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pos = self.positional_embedding
        if pos.shape[0] != tokens.shape[1]:
            pos = resize_pos_embed(pos, tokens.shape[1])
        tokens = tokens + pos[None].to(tokens.dtype)
        hd = C // self.num_heads
        q = self.q_proj(tokens[:, :1]).view(B, 1, self.num_heads, hd)
        k = self.k_proj(tokens).view(B, -1, self.num_heads, hd)
        v = self.v_proj(tokens).view(B, -1, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, 1, C)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP ResNet trunk (reference: clip/model.py:222-293): the 3-conv
    stem, four residual stages, the attention pool. Returns (grid NCHW,
    pooled)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 adapter_type: Optional[str] = None,
                 reduction_factor: int = 16, use_bn: bool = True,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        w = width
        self.conv1 = _conv(3, w // 2, 3, stride=2, **kw)
        self.bn1 = BatchNorm2d(w // 2, device=device)
        self.conv2 = _conv(w // 2, w // 2, 3, **kw)
        self.bn2 = BatchNorm2d(w // 2, device=device)
        self.conv3 = _conv(w // 2, w, 3, **kw)
        self.bn3 = BatchNorm2d(w, device=device)
        inplanes = w
        for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers),
                                               start=1):
            planes = w * mult
            stride = 1 if stage == 1 else 2
            seq = []
            for b in range(blocks):
                seq.append(Bottleneck(inplanes, planes, stride if b == 0 else 1,
                                      adapter_type, reduction_factor, use_bn,
                                      **kw))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(
            w * 32, heads, output_dim,
            num_positions=(input_resolution // 32) ** 2 + 1, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = avg_pool(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x, self.attnpool(x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class _LayerNorm(nn.Module):
    """flax LayerNorm's numerics (models/norm.py layer_norm: fp32 fast
    variance, eps 1e-5) under OpenAI's parameter names weight / bias."""

    def __init__(self, dim: int, dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.dtype)


class MultiheadAttention(nn.Module):
    """Self-attention with torch nn.MultiheadAttention's parameters
    (``in_proj_weight`` (3D, D), ``in_proj_bias``, ``out_proj``) and flax
    MultiHeadDotProductAttention's arithmetic: the query scaled by
    1/sqrt(Dh) before the product, softmax in the compute dtype."""

    def __init__(self, d_model: int, n_head: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(
            torch.empty((3 * d_model, d_model), dtype=dtype, device=dev))
        self.in_proj_bias = nn.Parameter(
            torch.zeros(3 * d_model, dtype=dtype, device=dev))
        self.out_proj = nn.Linear(d_model, d_model, dtype=dtype, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.n_head
        q, k, v = (t.view(B, L, self.n_head, hd) for t in
                   F.linear(x, self.in_proj_weight,
                            self.in_proj_bias).split(D, dim=-1))
        q = q / math.sqrt(hd)
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, D)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_1 = _LayerNorm(d_model, **kw)
        self.attn = MultiheadAttention(d_model, n_head, **kw)
        self.ln_2 = _LayerNorm(d_model, **kw)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4, dtype=dtype,
                               device=resolve_device(device))),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model, dtype=dtype,
                                 device=resolve_device(device)))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.resblocks = nn.Sequential(*[
            ResidualAttentionBlock(width, heads, dtype, device)
            for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


class VisualTransformer(nn.Module):
    """CLIP ViT trunk; returns (grid tokens (B, g*g, C), pooled CLS)
    (reference: clip/model.py:344-381 -- the fork returns ln_post over all
    tokens, no final projection: OpenAI's ``proj`` is not a parameter
    here)."""

    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.width = dtype, width
        # flax's "SAME" padding is none when the patch divides the image
        self.conv1 = _conv(3, width, patch_size, stride=patch_size,
                           padding=0, dtype=dtype, device=dev)
        n_pos = (input_resolution // patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(width, device=dev))
        self.positional_embedding = nn.Parameter(
            torch.empty((n_pos, width), device=dev))
        self.ln_pre = _LayerNorm(width, dtype, dev)
        self.transformer = Transformer(width, layers, heads, dtype, dev)
        self.ln_post = _LayerNorm(width, dtype, dev)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv1(x.to(self.dtype))
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, g*g, width), (h, w) order
        # the fp32 class embedding promotes the concat to fp32, as in JAX;
        # ln_pre gives the compute dtype
        cls = self.class_embedding.expand(B, 1, self.width)
        x = torch.cat([cls, x.float()], dim=1)
        pos = self.positional_embedding
        if pos.shape[0] != x.shape[1]:
            pos = resize_pos_embed(pos, x.shape[1])
        x = self.ln_pre(x + pos[None])
        x = self.ln_post(self.transformer(x))
        return x[:, 1:], x[:, 0]


_RESNET_CONFIGS = {
    "RN50": dict(layers=(3, 4, 6, 3), width=64, output_dim=1024),
    "RN101": dict(layers=(3, 4, 23, 3), width=64, output_dim=512),
    "RN50x4": dict(layers=(4, 6, 10, 6), width=80, output_dim=640),
}
_VIT_CONFIGS = {
    "ViT-B/32": dict(patch_size=32, width=768, layers=12, heads=12,
                     output_dim=512),
    "ViT-B/16": dict(patch_size=16, width=768, layers=12, heads=12,
                     output_dim=512),
}


class CLIPVisualEncoder(nn.Module):
    """The raw-image feature extractor (= reference CLIPResNetEncoder,
    vis_encoder.py:254-322): grid features (B, H*W, C) + pooled (B, 1, C).
    The trunk is ``visual`` (OpenAI's ``visual.`` prefix)."""

    def __init__(self, backbone: str = "RN101", image_size: int = 224,
                 adapter_type: Optional[str] = None,
                 reduction_factor: int = 16, use_bn: bool = True,
                 dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.backbone = backbone
        if backbone.startswith("RN"):
            c = _RESNET_CONFIGS[backbone]
            self.visual = ModifiedResNet(
                layers=c["layers"], output_dim=c["output_dim"],
                heads=c["width"] * 32 // 64, input_resolution=image_size,
                width=c["width"], adapter_type=adapter_type,
                reduction_factor=reduction_factor, use_bn=use_bn,
                dtype=dtype, device=device)
        else:
            c = _VIT_CONFIGS[backbone]
            self.visual = VisualTransformer(
                input_resolution=image_size, patch_size=c["patch_size"],
                width=c["width"], layers=c["layers"], heads=c["heads"],
                output_dim=c["output_dim"], dtype=dtype, device=device)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, 3, H, W) -> (grid (B, H'*W', C), pooled (B, 1, C'))."""
        grid, pooled = self.visual(images)
        if grid.dim() == 4:  # ResNet: NCHW -> tokens in (h, w) order
            grid = grid.flatten(2).transpose(1, 2)
        return grid, pooled[:, None, :]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPVisualEncoder":
        """flax's initializers, by distribution: lecun-normal (truncated
        normal, fan-in) convolution and dense weights, zero dense biases,
        BatchNorm and LayerNorm weight 1 / bias 0 with statistics mean 0 /
        var 1, the attention pool's positional embedding normal /
        sqrt(embed_dim), the ViT's class and positional embeddings
        width^-0.5 * normal."""
        init_clip_weights(self, generator)
        return self


def lecun_normal_(p: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at +-2 std, std
    sqrt(1 / fan_in) / 0.8796 (the truncation's own std)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    p.copy_(t * std)


@torch.no_grad()
def init_clip_weights(module: nn.Module, g: torch.Generator) -> None:
    """Seeded init of every CLIP trunk module under ``module`` (see
    ``CLIPVisualEncoder.init_weights``)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), g)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, g)
            m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], g)
            m.in_proj_bias.zero_()
        elif isinstance(m, (BatchNorm2d, _LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, AttentionPool2d):
            p = m.positional_embedding
            p.copy_(torch.randn(p.shape, generator=g, device=p.device)
                    / p.shape[1] ** 0.5)
        elif isinstance(m, VisualTransformer):
            for p in (m.class_embedding, m.positional_embedding):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device)
                        * m.width ** -0.5)


def get_vis_encoder(backbone: str = "RN101", image_size: int = 224,
                    adapter_type: Optional[str] = None,
                    reduction_factor: int = 16, use_bn: bool = True,
                    dtype=torch.float32,
                    device: Device = "cuda") -> CLIPVisualEncoder:
    """Factory matching the reference's get_vis_encoder (vis_encoder.py:88)."""
    return CLIPVisualEncoder(backbone=backbone, image_size=image_size,
                             adapter_type=adapter_type,
                             reduction_factor=reduction_factor, use_bn=use_bn,
                             dtype=dtype, device=device)


# feat dims per raw backbone (reference: multitask.py:648-660)
RAW_FEAT_DIMS = {"RN50": 2048, "RN101": 2048, "RN50x4": 2560,
                 "ViT-B/32": 768, "ViT-B/16": 768}
