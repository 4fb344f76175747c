"""Single-task entry points of the port (reference: src/{vqa,gqa,nlvr,
caption}.py and src/{tvqa,how2qa,tvc,yc2c}.py; vlpet_tpu/cli/single_task.py
-- the same Trainer pattern for one task each).

Run:  python -m vlpet_tpu_torch.cli.single_task <task> <flags>
with <task> one of vqa, gqa, nlvr, caption (image tasks: the loaders of
``cli.multitask``) or tvqa, how2qa, tvc, yc2c (video tasks: the loaders of
``data.video``, ``feat_dim`` 512). ``--device cpu`` runs on the CPU, the
default is the card. As in the JAX entry point, the Trainer takes the
default AdamW eps and betas and ``--backbone_ckpt`` (a local HF state
dict), and it is the feature Trainer: under a raw_* feature type the
batches carry images that no trunk reads (the JAX entry point's behaviour;
``cli.multitask`` runs the raw path). ``--classifier`` builds the answer
head with ``num_answers`` as configured, as the JAX entry point does (it
does not size it to the answer vocabulary): on vqa the loaders carry the
answer scores and the step trains the head, elsewhere nothing reads it.
``--distributed`` (or torchrun's environment) runs one process per card
over torch.distributed (parallel/multihost.py): every process reads its
own shard of each split, ``--batch_size`` is per process (the global
batch is the world size times it), and rank 0 alone writes the output.
``--mesh_model_axis`` M > 1 runs tensor parallelism as well
(parallel/mesh.py): the processes form a (world / M, M) mesh, each model
group of M processes splits the backbone's heads and FFN columns and
reads one data shard (the global batch is world / M times
``--batch_size``); an M that does not divide the world size falls back to
1, as in the JAX package. Only the VL-PET recipes run split.
"""

from __future__ import annotations

import sys
import time

from vlpet_tpu_torch.cli.multitask import build_loaders, require_stable_word_ids
from vlpet_tpu_torch.cli.multitask_video import run
from vlpet_tpu_torch.cli.param import build_model_config, parse_args
from vlpet_tpu_torch.data.tokenization import (effective_vocab_size,
                                               get_tokenizer)
from vlpet_tpu_torch.data.video import (VIDEO_CAP_TASKS, VIDEO_QA_TASKS,
                                        build_video_loader)
from vlpet_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from vlpet_tpu_torch.parallel.multihost import maybe_initialize_distributed

IMAGE_TASKS = ("vqa", "gqa", "nlvr", "caption")


def main(task: str, argv=None, device=None):
    """Train ``task`` (or with ``--test_only`` / ``--infer_only`` evaluate
    it) on ``device`` (default ``--device``, itself "cuda" by default).
    Returns (trainer, history), or the trainer after an evaluation-only
    run."""
    args = parse_args(argv)
    if device is not None:
        args.device = str(device)
    maybe_initialize_distributed(args)
    build_mesh(MeshConfig(model=args.mesh_model_axis))
    if task in IMAGE_TASKS and args.feature_type.startswith("raw_"):
        print(f"single_task {task}: --feature_type {args.feature_type} "
              f"images are not read here (as in the JAX entry point); "
              f"cli.multitask runs the raw path")
    args.tasks = task
    tasks = (task,)
    if task in VIDEO_QA_TASKS or task in VIDEO_CAP_TASKS:
        args.feat_dim = 512
    tokenizer, added = get_tokenizer(args.backbone, args.tokenizer_path)
    require_stable_word_ids(args, tokenizer)
    cfg = build_model_config(args, tasks,
                             vocab_size=effective_vocab_size(tokenizer, added))

    t0 = time.time()
    if task in IMAGE_TASKS:
        train_loaders = build_loaders(args, tasks, tokenizer, args.train, "train")
        val_loaders = build_loaders(args, tasks, tokenizer, args.valid, "val")
    else:
        train_loaders = [build_video_loader(task, args, tokenizer, args.train,
                                            "train", args.data_root)]
        val_loaders = [build_video_loader(task, args, tokenizer, args.valid,
                                          "val", args.data_root)]
    return run(args, tasks, tokenizer, cfg, train_loaders, val_loaders,
               time.time() - t0)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
