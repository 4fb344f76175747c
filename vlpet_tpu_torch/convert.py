"""flax parameters <-> port state_dict.

Takes the nested dict of arrays that ``model.init(...)["params"]`` gives
(after ``jax.device_get``; numpy arrays, or anything ``np.asarray`` reads)
and maps it onto a port module by the flax path:

* ``kernel`` leaves (Dense / TaskDense, (in, out) or per-task
  (T, in, out)) become ``weight`` with the last two axes swapped: (out, in)
  or (T, out, in);
* every other leaf keeps its name and shape (LayerNorm ``scale``/``bias``,
  embeddings, ``final_logits_bias``, the multihead per-head
  ``down_kernel``/``down_bias``).

So the classifier's ``answer_head`` (``fc1`` / ``fc2`` kernels transposed,
``mlp_layer_norm`` scale and bias) crosses both ways by these rules.

It raises on any flax leaf it cannot place and on any port parameter left
unset, so a renamed or missing module never loads silently.
``flax_to_state_dict`` also reads a partial tree, such as the trainable
subtree of the JAX train step (None where a parameter is frozen), and then
names only the leaves it holds. ``flax_path`` and ``to_flax_array`` are
the inverse direction: a port name and tensor as the flax path and array
(a ``weight`` back to a ``kernel`` with its last two axes swapped).

The CLIP trunk (``vis_encoder`` of the raw-image model, or a trunk module
converted alone with ``vision=True``) takes OpenAI CLIP's names and
PyTorch's layouts in the port (vlpet_tpu_torch/vision/clip.py), so its
leaves are renamed and re-laid out, with the ``batch_stats`` collection
beside the parameters:

* flax ``layer1_0`` / ``resblocks_3`` / ``downsample_conv`` /
  ``downsample_bn`` are ``layer1.0`` / ``transformer.resblocks.3`` /
  ``downsample.0`` / ``downsample.1``; a block's ``c_fc`` / ``c_proj``
  sit under ``mlp.``; the attention's ``out`` is ``out_proj``;
* convolution kernels go from HWIO to OIHW, dense kernels are transposed;
* a BatchNorm's or LayerNorm's ``scale`` is ``weight``; the statistics
  ``mean`` / ``var`` are the ``running_mean`` / ``running_var`` buffers;
* flax MultiHeadDotProductAttention's per-head query / key / value kernels
  (D, H, Dh) and biases (H, Dh) are one ``in_proj_weight`` (3D, D) and
  ``in_proj_bias`` (3D,); its out kernel (H, Dh, D) is ``out_proj.weight``.

``flax_leaves`` maps one port tensor back to its flax leaves (three for
``in_proj_*``, one otherwise).
"""

from __future__ import annotations

from collections.abc import Mapping
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


VIS_ROOT = "vis_encoder"  # the raw-image model's trunk (vision/vis_encoder.py)
_QKV = ("query", "key", "value")

# flax -> port renames of the trunk's path segments, on "."-joined paths
# with a trailing "."; _TO_FLAX undoes them
_TO_PORT = ((re.compile(r"(^|\.)layer(\d)_(\d+)\."), r"\1layer\2.\3."),
            (re.compile(r"(^|\.)resblocks_(\d+)\.(c_fc|c_proj)\."),
             r"\1resblocks_\2.mlp.\3."),
            (re.compile(r"(^|\.)resblocks_(\d+)\."),
             r"\1transformer.resblocks.\2."),
            (re.compile(r"(^|\.)downsample_conv\."), r"\1downsample.0."),
            (re.compile(r"(^|\.)downsample_bn\."), r"\1downsample.1."),
            (re.compile(r"(^|\.)attn\.out\."), r"\1attn.out_proj."))
_TO_FLAX = ((re.compile(r"(^|\.)layer(\d)\.(\d+)\."), r"\1layer\2_\3."),
            (re.compile(r"(^|\.)transformer\.resblocks\.(\d+)\."),
             r"\1resblocks_\2."),
            (re.compile(r"(^|\.)resblocks_(\d+)\.mlp\."), r"\1resblocks_\2."),
            (re.compile(r"(^|\.)downsample\.0\."), r"\1downsample_conv."),
            (re.compile(r"(^|\.)downsample\.1\."), r"\1downsample_bn."),
            (re.compile(r"(^|\.)attn\.out_proj\."), r"\1attn.out."))
_STAT_TO_PORT = {"mean": "running_mean", "var": "running_var"}


def _rename(module_path: str, rules) -> str:
    s = module_path + "."
    for pat, rep in rules:
        s = pat.sub(rep, s)
    return s[:-1]


def _walk_leaves(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk_leaves(val, prefix + (key,))
        elif val is not None:
            yield prefix + (key,), val


def vision_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax CLIP trunk tree (and its batch statistics) as port names and
    layouts, each name after ``prefix`` (module docstring). None leaves are
    skipped; a partial tree names only the leaves it holds."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    for path, val in _walk_leaves(params):
        arr = np.asarray(val)
        mod, leaf = ".".join(path[:-1]), path[-1]
        if len(path) >= 3 and path[-3] == "attn" and path[-2] in _QKV:
            # query / key / value -> one in_proj tensor, after all three
            qkv.setdefault((".".join(path[:-2]), leaf), {})[path[-2]] = arr
            continue
        if leaf == "kernel":
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:  # attention out (H, Dh, D) -> (D, H*Dh)
                arr = arr.reshape(-1, arr.shape[-1]).T
            else:
                arr = arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        name = _rename(mod, _TO_PORT) + "." + leaf if mod else leaf
        out[prefix + name] = torch.tensor(np.ascontiguousarray(arr))
    for (attn, leaf), parts in qkv.items():
        if set(parts) != set(_QKV):
            raise ValueError(f"{attn}: query / key / value incomplete "
                             f"({sorted(parts)})")
        if leaf == "kernel":  # (D, H, Dh) each -> (3D, D)
            arr = np.concatenate([parts[n].reshape(parts[n].shape[0], -1).T
                                  for n in _QKV])
        else:  # (H, Dh) each -> (3D,)
            arr = np.concatenate([parts[n].reshape(-1) for n in _QKV])
        name = _rename(attn, _TO_PORT) + ".in_proj_" + (
            "weight" if leaf == "kernel" else "bias")
        out[prefix + name] = torch.tensor(np.ascontiguousarray(arr))
    for path, val in _walk_leaves(batch_stats or {}):
        name = _rename(".".join(path[:-1]), _TO_PORT)
        out[prefix + name + "." + _STAT_TO_PORT[path[-1]]] = torch.tensor(
            np.ascontiguousarray(np.asarray(val)))
    return out


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                       vision: bool = False) -> Dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into port state_dict names/layouts;
    None leaves (parameters left out of a partial tree) are skipped. The
    subtree under ``vis_encoder`` (the whole tree with ``vision``) is a
    CLIP trunk, converted with ``batch_stats`` by ``vision_state_dict``."""
    if vision:
        return vision_state_dict(params, batch_stats)
    out: Dict[str, torch.Tensor] = {}
    if VIS_ROOT in params:
        out.update(vision_state_dict(params[VIS_ROOT],
                                     (batch_stats or {}).get(VIS_ROOT),
                                     prefix=VIS_ROOT + "."))

    def walk(tree: Mapping, prefix: tuple) -> None:
        for key, val in tree.items():
            if not prefix and key == VIS_ROOT:
                continue
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            if val is None:
                continue
            arr = np.asarray(val)
            if key == "kernel":
                arr, key = np.swapaxes(arr, -1, -2), "weight"
            out[".".join(prefix + (key,))] = torch.tensor(
                np.ascontiguousarray(arr))

    walk(params, ())
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None,
                     vision: bool = False) -> torch.nn.Module:
    """Copy a flax parameter tree (and a CLIP trunk's batch statistics)
    into ``module`` (cast to each tensor's dtype and device); a
    tensor-parallel module (parallel/mesh.py shard_model) takes its
    shards of the tree's whole tensors (``shard_state_dict``). Raises on
    unplaced leaves, unset parameters or buffers and shape mismatches."""
    from vlpet_tpu_torch.parallel.mesh import shard_state_dict

    sd = shard_state_dict(flax_to_state_dict(params, batch_stats, vision),
                          module)
    own = module.state_dict()
    unplaced = sorted(set(sd) - set(own))
    unset = sorted(set(own) - set(sd))
    if unplaced or unset:
        raise ValueError(f"flax tree does not match the port module:\n"
                         f"  flax leaves not placed: {unplaced}\n"
                         f"  port parameters unset: {unset}")
    bad = [f"{k}: flax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
           for k in sd if sd[k].shape != own[k].shape]
    if bad:
        raise ValueError("shape mismatch:\n  " + "\n  ".join(bad))
    module.load_state_dict(sd, strict=True)
    return module


def flax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """A port parameter name as its flax path, and whether the array's last
    two axes swap on the way (a ``weight``, which is a flax ``kernel``).
    Outside the CLIP trunk only: a trunk tensor's leaves are
    ``flax_leaves``'."""
    parts = tuple(name.split("."))
    if parts[-1] == "weight":
        return parts[:-1] + ("kernel",), True
    return parts, False


def _vision_part(name: str, vision: bool) -> Optional[Tuple[str, str]]:
    """(prefix, the name inside the trunk) of a trunk tensor, else None."""
    if vision:
        return "", name
    if name.startswith(VIS_ROOT + "."):
        return VIS_ROOT + ".", name[len(VIS_ROOT) + 1:]
    return None


def attention_heads(module: torch.nn.Module) -> Dict[str, int]:
    """The head count of every trunk attention tensor of ``module`` by
    name (``in_proj_*`` and ``out_proj.weight`` of each
    vision.clip.MultiheadAttention): what ``flax_leaves`` needs to lay
    them out per head."""
    from vlpet_tpu_torch.vision.clip import MultiheadAttention

    out = {}
    for mname, m in module.named_modules():
        if isinstance(m, MultiheadAttention):
            for leaf in ("in_proj_weight", "in_proj_bias", "out_proj.weight"):
                out[f"{mname}.{leaf}" if mname else leaf] = m.n_head
    return out


def flax_leaves(name: str, t: torch.Tensor, vision: bool = False,
                heads: Optional[int] = None
                ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """A port tensor as its flax leaves: [(flax path, fp32 array)] -- three
    for a trunk's ``in_proj_*``, one otherwise (``to_flax_array`` outside
    the trunk). A trunk buffer's path is its ``batch_stats`` path. A trunk
    attention tensor needs its head count ``heads``
    (``attention_heads``)."""
    vis = _vision_part(name, vision)
    if vis is None:
        return [(flax_path(name)[0], to_flax_array(name, t))]
    arr = t.detach().float().cpu().numpy()
    prefix, inner = vis
    mod, _, leaf = inner.rpartition(".")
    fmod = tuple(p for p in (prefix + _rename(mod, _TO_FLAX)).split(".") if p)
    if leaf in ("in_proj_weight", "in_proj_bias"):
        D = arr.shape[-1] if leaf == "in_proj_weight" else arr.shape[0] // 3
        heads = _need_heads(name, heads)
        out = []
        for n, part in zip(_QKV, np.split(arr, 3, axis=0)):
            if leaf == "in_proj_weight":  # (D, D) -> (D, H, Dh)
                part = part.T.reshape(D, heads, D // heads)
                out.append((fmod + (n, "kernel"), part))
            else:
                out.append((fmod + (n, "bias"), part.reshape(heads, -1)))
        return [(p, np.ascontiguousarray(a)) for p, a in out]
    if leaf in ("running_mean", "running_var"):
        return [(fmod + (leaf[len("running_"):],), arr)]
    if leaf == "weight":
        if arr.ndim == 4:  # OIHW -> HWIO
            return [(fmod + ("kernel",),
                     np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))]
        if arr.ndim == 2:
            if fmod[-2:-1] == ("attn",) and fmod[-1] == "out":
                heads = _need_heads(name, heads)
                return [(fmod + ("kernel",), np.ascontiguousarray(
                    arr.T.reshape(heads, -1, arr.shape[0])))]
            return [(fmod + ("kernel",), np.ascontiguousarray(arr.T))]
        return [(fmod + ("scale",), arr)]
    return [(fmod + (leaf,), arr)]


def _need_heads(name: str, heads: Optional[int]) -> int:
    if heads is None:
        raise ValueError(f"{name}: a trunk attention tensor needs its head "
                         f"count (convert.attention_heads)")
    return heads


def to_flax_array(name: str, t: torch.Tensor) -> np.ndarray:
    """A port tensor as the flax leaf of ``flax_path(name)``: fp32 (the
    JAX package keeps fp32 parameters), a kernel's axes swapped back."""
    arr = t.detach().float().cpu().numpy()
    if flax_path(name)[1]:
        arr = np.swapaxes(arr, -1, -2)
    return np.ascontiguousarray(arr)
