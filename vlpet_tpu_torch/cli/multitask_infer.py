"""Inference-only entry of the port (reference: src/multitask_infer.py;
vlpet_tpu/cli/multitask_infer.py): load a trained export
(--load_trained_model_path <npz>, the JAX package's LAST.npz format) and
run the evaluation; also the gate-heatmap dump (--use_store_gate_large
--store_gate_path, reference: my_transformers/modeling_bart.py:1200-1205).
The BART encoder's gate activations are captured by forward hooks on the
gate modules and written as ``{task}_{name}.npy`` under the names of the
JAX dump (the flax ``sow`` at vlpet_tpu/models/bart.py:592); T5, which
sows no gate there, dumps none here either.

``--distributed`` (or torchrun's environment) evaluates on one process
per card (parallel/multihost.py): each process predicts its shard of the
split, the results are merged and rank 0 prints the whole split's
scores; the gate dump runs on rank 0's first batch (on its model group's
ranks under ``--mesh_model_axis``, which split the backbone:
parallel/mesh.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vlpet_tpu_torch.cli.multitask import (build_loaders,
                                           require_stable_word_ids)
from vlpet_tpu_torch.cli.param import build_model_config, parse_args
from vlpet_tpu_torch.data.tokenization import effective_vocab_size, get_tokenizer
from vlpet_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from vlpet_tpu_torch.parallel.multihost import maybe_initialize_distributed


def gate_modules(model):
    """(dump name, module) of every gate whose activation the JAX BART
    sows: per encoder layer and sublayer, the gate G that multiplies (or
    is added to) the sublayer output -- middle-Y's vector and the two
    norms are not one."""
    from vlpet_tpu_torch.models.bart import BartEncoderLayer
    from vlpet_tpu_torch.models.norm import LayerNorm
    from vlpet_tpu_torch.pet.modules import IA3Vector

    out = []
    for name, layer in model.named_modules():
        if not isinstance(layer, BartEncoderLayer):
            continue
        for prefix in ("attn", "ff"):
            gate = layer.gate(prefix)
            if gate is None or gate[2] in (None, IA3Vector, LayerNorm):
                continue
            out.append((f"{name.replace('.', '_')}_encoder_{prefix}_gate_[0]",
                        getattr(layer, f"encoder_{prefix}_{gate[1]}")))
    return out


@torch.no_grad()
def dump_gates(trainer, loader, store_path: str, write: bool = True):
    """Run one batch through the model capturing the gate activations (the
    reference's heatmap dump); ``write`` False runs the forward only (a
    model-axis peer of the writing rank)."""
    from vlpet_tpu_torch.pet.modules import PetContext
    from vlpet_tpu_torch.train.trainer import array_batch

    if write:
        os.makedirs(store_path, exist_ok=True)
    batch = next(iter(loader))
    arr = array_batch(batch, trainer.device)
    ctx = PetContext(task=loader.task, task_idx=trainer.task_idx(loader.task))
    captured = {}
    handles = [mod.register_forward_hook(
        lambda m, i, o, name=name: captured.__setitem__(name, o))
        for name, mod in gate_modules(trainer.model)]
    try:
        trainer.model(arr["input_ids"], arr["attention_mask"],
                      vis_feats=arr.get("vis_feats"), boxes=arr.get("boxes"),
                      labels=arr.get("target_ids"), ctx=ctx,
                      deterministic=True)
    finally:
        for h in handles:
            h.remove()
    if not write:
        return
    for name, t in captured.items():
        np.save(os.path.join(store_path, f"{loader.task}_{name}.npy"),
                t.float().cpu().numpy())
    print(f"stored {len(captured)} gate tensors to {store_path}")


def main(argv=None, device=None):
    args = parse_args(argv)
    if device is not None:
        args.device = str(device)
    maybe_initialize_distributed(args)
    build_mesh(MeshConfig(model=args.mesh_model_axis))
    args.test_only = True
    tasks = tuple(t for t in args.tasks.split(",") if t) or ("vqa",)
    tokenizer, added = get_tokenizer(args.backbone, args.tokenizer_path)
    require_stable_word_ids(args, tokenizer)
    cfg = build_model_config(args, tasks,
                             vocab_size=effective_vocab_size(tokenizer, added))
    val_loaders = build_loaders(args, tasks, tokenizer, args.valid, "val")

    from vlpet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, tasks, lr=args.lr, total_steps=1,
                      tokenizer=tokenizer, output_dir=args.output,
                      backbone_ckpt=args.backbone_ckpt,
                      load=args.load_trained_model_path or args.load,
                      mesh_model_axis=args.mesh_model_axis,
                      device=args.device)
    if args.use_store_gate_large and args.store_gate_path:
        # a split backbone's forward takes its whole model group
        if trainer.lead or trainer.layout.model > 1:
            for loader in val_loaders:
                dump_gates(trainer, loader, args.store_gate_path,
                           write=trainer.lead)
        return trainer
    for loader in val_loaders:
        scores = trainer.evaluate(loader, num_beams=args.num_beams,
                                  max_length=args.gen_max_length)
        if trainer.lead:
            print(loader.task, scores)
    return trainer


if __name__ == "__main__":
    main()
