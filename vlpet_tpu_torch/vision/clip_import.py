"""OpenAI CLIP visual state dict -> the port's CLIP trunk, ported from
vlpet_tpu/vision/clip_import.py.

Replaces the reference's jit-checkpoint patching loader (reference:
src/clip/clip.py:73-160). Works offline from a local state dict (a torch
``.pt``, the state dict of a torchscript archive, or a ``.safetensors``
file read by ``models.hf_import.load_torch_state_dict``). Only the visual
trunk is mapped (the reference deletes the text transformer,
vis_encoder.py:259): keys outside ``visual.`` are not read.

The port's trunk carries OpenAI's names and layouts (vision/clip.py), so a
key fills the tensor of the same name under the trunk, cast to its dtype;
what the JAX importer transposes and splits is a copy here. The attention
pool's positional embedding (also in the (1, N, C) form of a patched
wrapper) is resized to the configured grid with the JAX package's cubic
kernel (``clip.resize_pos_embed``, vlpet_tpu/vision/clip_import.py:112-116).
The ViT's positional embedding is not resized, as in the JAX importer: at
another image size it keeps its init.

The report is the JAX importer's, key for key: ``filled`` holds a key once
for each tensor it filled -- three times for ``attn.in_proj_weight`` and
``attn.in_proj_bias``, which the JAX importer splits into query, key and
value -- and ``skipped`` the ``visual.`` keys it has no rule for. A key
whose rule names a tensor the trunk lacks, or one of another shape, is in
neither list; so are ``num_batches_tracked`` and the unused ``proj``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from vlpet_tpu_torch.vision.clip import resize_pos_embed

_STAT = r"(weight|bias|running_mean|running_var)"


def _rule(k: str, has_attention: bool) -> Optional[Tuple[str, int]]:
    """(the trunk tensor's name, how many JAX leaves it fills) for the key
    ``k`` (``visual.`` stripped), ("", 0) for a key the JAX importer passes
    over in silence, or None for one it lists as skipped."""
    m = re.match(r"(conv\d|bn\d)\." + _STAT, k)
    if m:
        mod, leaf = m.groups()
        return f"{mod}.{'weight' if mod.startswith('conv') else leaf}", 1
    m = re.match(r"layer(\d)\.(\d+)\.(.*)", k)
    if m:
        stage, blk, rest = m.groups()
        base = f"layer{stage}.{blk}."
        cm = re.match(r"(conv\d)\.weight", rest)
        if cm:
            return base + cm.group(1) + ".weight", 1
        bm = re.match(r"(bn\d)\." + _STAT, rest)
        if bm:
            return base + ".".join(bm.groups()), 1
        dm = re.match(r"downsample\.(0|1|-1)\." + _STAT, rest)
        if dm:
            idx, leaf = dm.groups()
            if idx == "0":
                return base + "downsample.0.weight", 1
            if idx == "1":
                return base + f"downsample.1.{leaf}", 1
            return "", 0
        return None
    m = re.match(r"attnpool\.(positional_embedding|(?:q|k|v|c)_proj\."
                 r"(?:weight|bias))", k)
    if m:
        return "attnpool." + m.group(1), 1
    if k in ("class_embedding", "positional_embedding", "conv1.weight",
             "ln_pre.weight", "ln_pre.bias", "ln_post.weight",
             "ln_post.bias"):
        return k, 1
    if k == "proj":  # unused by the grid-feature wrapper
        return "", 0
    m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)", k)
    if m:
        blk, rest = m.groups()
        base = f"transformer.resblocks.{blk}."
        lm = re.match(r"(ln_1|ln_2)\.(weight|bias)", rest)
        if lm:
            return base + ".".join(lm.groups()), 1
        mm = re.match(r"mlp\.(c_fc|c_proj)\.(weight|bias)", rest)
        if mm:
            return base + "mlp." + ".".join(mm.groups()), 1
        if not has_attention:
            return None
        if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
            return base + rest, 3
        if rest in ("attn.out_proj.weight", "attn.out_proj.bias"):
            return base + rest, 1
        return None
    return None


@torch.no_grad()
def load_clip_state_dict(encoder: torch.nn.Module,
                         state_dict: Dict[str, Any], strict: bool = False
                         ) -> Dict[str, List[str]]:
    """Fill ``encoder`` (a CLIPVisualEncoder, or a module whose trunk is
    ``visual``) in place from an OpenAI CLIP state dict. Returns the
    report {"filled": [...], "skipped": [...]}; with ``strict`` raises
    on a skipped key."""
    own = encoder.visual.state_dict()
    has_attention = any(".attn.in_proj_weight" in n for n in own)
    filled: List[str] = []
    skipped: List[str] = []
    for key, val in state_dict.items():
        if not key.startswith("visual.") or key.endswith("num_batches_tracked"):
            continue
        k = key[len("visual."):]
        rule = _rule(k, has_attention)
        if rule is None:
            skipped.append(key)
            continue
        name, leaves = rule
        if name not in own:
            continue
        v = torch.as_tensor(val).detach().to("cpu", torch.float32)
        if name == "attnpool.positional_embedding":
            if v.dim() == 3 and v.shape[0] == 1:
                v = v[0]  # wrapper-patched (1, N, C) form
            if v.shape != own[name].shape:
                v = resize_pos_embed(v, own[name].shape[0])
        if v.shape != own[name].shape:
            continue
        own[name].copy_(v.to(own[name].dtype))
        filled.extend([key] * leaves)
    if strict and skipped:
        raise ValueError(f"unmapped CLIP keys: {skipped}")
    return {"filled": filled, "skipped": skipped}
