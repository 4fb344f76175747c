"""Video-text multitask entry point of the port (reference:
src/multitask_video.py; vlpet_tpu/cli/multitask_video.py).

Reproduces: tvqa+how2qa+tvc+yc2c on CLIP-ViT frame features (feat_dim forced
to 512, reference: multitask_video.py:738), n_boxes=64 time-resized frames,
qa-predict + caption-predict evaluation (:628-723): each epoch QA greedy to
length 20 and captions beam 5 to length 40; ``--test_only`` /
``--infer_only`` evaluate with ``--num_beams`` and ``--gen_max_length``.

Run:  python -m vlpet_tpu_torch.cli.multitask_video --tasks tvqa,how2qa,tvc,yc2c ...
(the flags of scripts/video-text/*.sh; ``--device cpu`` runs on the CPU,
the default is the card). Without ``--data_root`` the data are synthetic
(``--synthetic_examples`` per task). As in the JAX video CLI, the Trainer
takes the default AdamW eps and betas whatever ``--adam_eps`` /
``--adam_beta1`` / ``--adam_beta2`` say, and ``--feature_type`` is not
read; ``--backbone_ckpt`` loads a local HF BART / T5 state dict. As in
the JAX video CLI, ``--classifier`` builds the answer head (``num_answers``
as configured) and nothing reads it: the video loaders carry no answer
scores, so the steps take the LM loss and the evaluation generates.
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

import time

from vlpet_tpu_torch.cli.multitask import require_stable_word_ids
from vlpet_tpu_torch.cli.param import build_model_config, parse_args
from vlpet_tpu_torch.data.multitask import MultitaskLoader
from vlpet_tpu_torch.data.tokenization import (effective_vocab_size,
                                               get_tokenizer)
from vlpet_tpu_torch.data.video import build_video_loader
from vlpet_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from vlpet_tpu_torch.parallel.multihost import maybe_initialize_distributed

VIDEO_TASKS = ("tvqa", "how2qa", "tvc", "yc2c")


def main(argv=None, device=None):
    """Train (or with ``--test_only`` / ``--infer_only`` evaluate) on
    ``device`` (default ``--device``, itself "cuda" by default). Returns
    (trainer, history), or the trainer after an evaluation-only run."""
    args = parse_args(argv)
    if device is not None:
        args.device = str(device)
    maybe_initialize_distributed(args)
    build_mesh(MeshConfig(model=args.mesh_model_axis))
    args.feat_dim = 512  # CLIP-ViT frame features (reference: :738)
    tasks = tuple(t for t in args.tasks.split(",") if t) or VIDEO_TASKS
    tokenizer, added = get_tokenizer(args.backbone, args.tokenizer_path)
    require_stable_word_ids(args, tokenizer)
    cfg = build_model_config(args, tasks,
                             vocab_size=effective_vocab_size(tokenizer, added))

    t0 = time.time()
    train_loaders = [build_video_loader(t, args, tokenizer, args.train,
                                        "train", args.data_root)
                     for t in tasks]
    val_loaders = [build_video_loader(t, args, tokenizer, args.valid, "val",
                                      args.data_root)
                   for t in tasks]
    return run(args, tasks, tokenizer, cfg, train_loaders, val_loaders,
               time.time() - t0, sampling=args.multitask_sampling)


def run(args, tasks, tokenizer, cfg, train_loaders, val_loaders,
        data_s: float, sampling: str = "roundrobin"):
    """The JAX video entry points' Trainer run, shared with
    ``cli.single_task``: train (or evaluate, under ``--test_only`` /
    ``--infer_only``) with the default AdamW eps and betas, as the JAX
    entry points build their Trainer; print the resume and the final state
    digest. Returns (trainer, history), or the trainer after an
    evaluation-only run."""
    mt = MultitaskLoader(train_loaders, sampling=sampling)
    total_steps = max(1, len(mt) * args.epochs)

    from vlpet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(
        cfg, tasks, lr=args.lr, total_steps=total_steps,
        warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm, seed=args.seed,
        output_dir=args.output, tokenizer=tokenizer,
        backbone_ckpt=args.backbone_ckpt, load=args.load,
        mesh_model_axis=args.mesh_model_axis,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        device=args.device)
    trainer.logger.log({"data_build_seconds": data_s})
    if args.resume:
        t1 = time.time()
        step = trainer.restore()
        if step is not None:
            t2 = time.time()
            digest = trainer.state_digest()  # every rank: it gathers
            if trainer.lead:
                print(f"resumed from step {step} in {t2 - t1:.3f} s; "
                      f"state digest {digest}")

    if args.infer_only or args.test_only:
        for loader in val_loaders:
            scores = trainer.evaluate(loader, num_beams=args.num_beams,
                                      max_length=args.gen_max_length)
            if trainer.lead:
                print(loader.task, scores)
        return trainer

    history = trainer.train(mt, epochs=args.epochs, val_loaders=val_loaders)
    digest = trainer.state_digest()  # every rank: it gathers
    if trainer.lead:
        print(f"saved at step {trainer.step}; state digest {digest}")
    return trainer, history


if __name__ == "__main__":
    main()
