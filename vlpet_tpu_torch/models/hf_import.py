"""HF checkpoint -> port parameters, ported from
vlpet_tpu/models/hf_import.py.

Replaces the reference's ``from_pretrained`` weight loading (reference:
src/trainer_base.py:224-235, which loads facebook/bart-base / t5-base
with strict-minus-ignore-keys). Works offline from a torch state dict (a
local ``pytorch_model.bin`` / ``.pt`` through ``torch.load``, a
``.safetensors`` file through the reader below, or an in-memory HF
model's ``state_dict()``). PET and visual-embedding parameters keep their
init, as the reference's strict=False load leaves them.

The port keeps HF's (out, in) Linear layout, so a tensor is copied where
the JAX importer transposes it. ``bart_hf_to_port`` / ``t5_hf_to_port``
fill a VLBart / VLT5 in place and return the JAX importer's report:
``filled`` (the port names filled, in order) and ``skipped`` (the
checkpoint keys without a rule). A key whose rule names a tensor the model
lacks is in neither list (T5's ``lm_head.weight`` on a tied model); a
shape that differs raises, except along a vocabulary axis (``_set``).

``load_torch_state_dict`` reads ``.safetensors`` with its own reader
(``read_safetensors``: an 8-byte little-endian header length, a JSON
header of dtype, shape and byte offsets per tensor, then the raw
little-endian buffers), so the ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().cpu()


@torch.no_grad()
def _set(own: Dict[str, torch.Tensor], name: str, value: torch.Tensor,
         filled: List[str], hf_key: str,
         grow_axis: Optional[int] = None) -> bool:
    """Copy a checkpoint tensor onto the model tensor ``name`` (cast to its
    dtype). ``grow_axis`` marks the vocab-carrying tensors (the shared
    embedding, T5's untied lm_head, final_logits_bias): when the model's
    vocabulary is larger along that axis (the tokenizer added
    <vis_extra_id_*> / <extra_id_*> specials; the reference calls
    resize_token_embeddings, multitask.py:59-67), the checkpoint rows fill
    the leading slice and the added rows keep the model's init. Returns
    False when the model has no tensor ``name``."""
    if name not in own:
        return False
    cur = own[name]
    cs, vs = tuple(cur.shape), tuple(value.shape)
    if cs != vs:
        ok = (grow_axis is not None and len(cs) == len(vs)
              and cs[grow_axis] > vs[grow_axis]
              and all(c == v for i, (c, v) in enumerate(zip(cs, vs))
                      if i != grow_axis))
        if not ok:
            raise ValueError(f"shape mismatch for {hf_key} -> {name}: "
                             f"{vs} vs {cs}")
        cur = cur[tuple(slice(0, v) for v in vs)]
    cur.copy_(value.to(cur.dtype))
    filled.append(name)
    return True


def _linear(own, base: str, w, filled, hf_key, lora: bool) -> None:
    """A Linear weight onto ``base``; under LoRA the frozen ``base`` of the
    LoRA layer, where the model has one (vlpet_tpu/models/hf_import.py:75)."""
    name = base + (".base.weight" if lora else ".weight")
    if name not in own and lora:
        name = base + ".weight"
    _set(own, name, w, filled, hf_key)


def bart_hf_to_port(state_dict: Dict[str, Any], model: torch.nn.Module,
                    strict: bool = False) -> Dict[str, List[str]]:
    """Fill a VLBart (in place) from a (VL)Bart HF state dict: the shared
    embedding, the learned positions (offset rows included), every layer's
    projections and LayerNorms, final_logits_bias. lm_head is tied to the
    shared embedding and skipped (the reference's _keys_to_ignore). Returns
    the report; with ``strict`` raises on a skipped key."""
    own = model.state_dict()
    lora = "model.encoder.layers_0.self_attn.q_proj.base.weight" in own
    filled: List[str] = []
    skipped: List[str] = []

    for key, val in state_dict.items():
        v = _tensor(val)
        k = re.sub(r"^model\.", "", key)
        if k in ("shared.weight", "encoder.embed_tokens.weight",
                 "decoder.embed_tokens.weight"):
            _set(own, "model.shared", v, filled, key, grow_axis=0)
            continue
        if k == "lm_head.weight":
            continue  # tied
        if k == "final_logits_bias":
            _set(own, "final_logits_bias", v, filled, key, grow_axis=1)
            continue
        m = re.match(r"(encoder|decoder)\.(.*)", k)
        if not m:
            skipped.append(key)
            continue
        stack, rest = m.group(1), m.group(2)
        base = f"model.{stack}"
        if rest == "embed_positions.weight":
            _set(own, base + ".embed_positions", v, filled, key)
            continue
        if rest.startswith("layernorm_embedding."):
            leaf = "scale" if rest.endswith("weight") else "bias"
            _set(own, f"{base}.layernorm_embedding.{leaf}", v, filled, key)
            continue
        lm = re.match(r"layers\.(\d+)\.(.*)", rest)
        if lm:
            layer = f"{base}.layers_{lm.group(1)}"
            sub = lm.group(2)
            pm = re.match(r"(self_attn|encoder_attn)\.(q_proj|k_proj|v_proj|"
                          r"out_proj)\.(weight|bias)", sub)
            if pm:
                attn, proj, leaf = pm.groups()
                is_lora = lora and proj in ("q_proj", "v_proj")
                tgt = f"{layer}.{attn}.{proj}"
                if leaf == "weight":
                    _linear(own, tgt, v, filled, key, is_lora)
                else:
                    name = tgt + (".base.bias" if is_lora else ".bias")
                    if name not in own:
                        name = tgt + ".bias"
                    _set(own, name, v, filled, key)
                continue
            nm = re.match(r"(self_attn_layer_norm|encoder_attn_layer_norm|"
                          r"final_layer_norm)\.(weight|bias)", sub)
            if nm:
                ln, leaf = nm.groups()
                leaf = "scale" if leaf == "weight" else "bias"
                _set(own, f"{layer}.{ln}.{leaf}", v, filled, key)
                continue
            fm = re.match(r"(fc1|fc2)\.(weight|bias)", sub)
            if fm:
                fc, leaf = fm.groups()
                if leaf == "weight":
                    _linear(own, f"{layer}.{fc}", v, filled, key, False)
                else:
                    _set(own, f"{layer}.{fc}.bias", v, filled, key)
                continue
        skipped.append(key)

    if strict and skipped:
        raise ValueError(f"unmapped HF keys: {skipped}")
    return {"filled": filled, "skipped": skipped}


def t5_hf_to_port(state_dict: Dict[str, Any], model: torch.nn.Module,
                  strict: bool = False) -> Dict[str, List[str]]:
    """Fill a VLT5 (in place) from a (VL)T5 HF state dict: the shared
    embedding, the untied lm_head (gated T5), every block's projections,
    relative bias, RMSNorm scales and FFN weights. Returns the report."""
    own = model.state_dict()
    filled: List[str] = []
    skipped: List[str] = []

    for key, val in state_dict.items():
        v = _tensor(val)
        k = re.sub(r"^(model|transformer)\.", "", key)
        if k in ("shared.weight", "encoder.embed_tokens.weight",
                 "decoder.embed_tokens.weight"):
            _set(own, "model.shared", v, filled, key, grow_axis=0)
            continue
        if k == "lm_head.weight":
            _set(own, "lm_head.weight", v, filled, key, grow_axis=0)
            continue
        m = re.match(r"(encoder|decoder)\.(.*)", k)
        if not m:
            skipped.append(key)
            continue
        stack, rest = m.group(1), m.group(2)
        base = f"model.{stack}"
        if rest == "final_layer_norm.weight":
            _set(own, base + ".final_layer_norm.scale", v, filled, key)
            continue
        bm = re.match(r"block\.(\d+)\.layer\.(\d+)\.(.*)", rest)
        if not bm:
            skipped.append(key)
            continue
        blk, sub_idx, sub = (f"{base}.blocks_{bm.group(1)}", int(bm.group(2)),
                             bm.group(3))
        # layer 0 = self-attn, layer 1 = cross (dec) / ff (enc), layer 2 =
        # ff (dec)
        if sub_idx == 0:
            mod = "self_attn"
        elif stack == "decoder" and sub_idx == 1:
            mod = "cross_attn"
        else:
            mod = "ff"
        am = re.match(r"(SelfAttention|EncDecAttention)\.(q|k|v|o)\.weight",
                      sub)
        if am:
            _set(own, f"{blk}.{mod}.{am.group(2)}.weight", v, filled, key)
            continue
        if sub.endswith("relative_attention_bias.weight"):
            _set(own, f"{blk}.{mod}.relative_attention_bias", v, filled, key)
            continue
        if sub == "layer_norm.weight":
            _set(own, f"{blk}.{mod}_layer_norm.scale", v, filled, key)
            continue
        dm = re.match(r"DenseReluDense\.(wi|wi_0|wi_1|wo)\.weight", sub)
        if dm:  # wi / wo live directly on the block
            _set(own, f"{blk}.{dm.group(1)}.weight", v, filled, key)
            continue
        skipped.append(key)

    if strict and skipped:
        raise ValueError(f"unmapped HF keys: {skipped}")
    return {"filled": filled, "skipped": skipped}


# safetensors dtype names -> (numpy dtype of the raw little-endian
# buffer, the torch dtype it is viewed as)
_ST_DTYPES = {"F64": ("<f8", torch.float64), "F32": ("<f4", torch.float32),
              "F16": ("<f2", torch.float16), "BF16": ("<i2", torch.bfloat16),
              "I64": ("<i8", torch.int64), "I32": ("<i4", torch.int32),
              "I16": ("<i2", torch.int16), "I8": ("i1", torch.int8),
              "U8": ("u1", torch.uint8), "BOOL": ("u1", torch.bool)}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        start = 8 + n
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        np_dtype, dtype = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        arr = np.array(raw[start + lo:start + hi]).view(np_dtype)
        t = torch.from_numpy(arr.reshape(info["shape"]))
        out[name] = t.view(dtype) if dtype in (torch.bfloat16,
                                               torch.bool) else t
    return out


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a local checkpoint without network access: ``.safetensors``
    through ``read_safetensors``, anything else (``.bin``, ``.pt``)
    through ``torch.load`` (vlpet_tpu/models/hf_import.py:232-239)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)
