"""Image-text multitask entry point of the port (reference:
src/multitask.py; vlpet_tpu/cli/multitask.py).

Reproduces the reference's run layout: per-task batch-size scaling
(gqa bs·100/60, nlvr bs·20/60, caption bs·50/60 — multitask.py:682-695),
task prompts ("vqa: " etc. — :697-706), roundrobin multitask training, and
per-epoch VQA/GQA/NLVR/caption eval.

Run:  python -m vlpet_tpu_torch.cli.multitask --tasks vqa,gqa,nlvr,caption ...
(the flags of scripts/image-text/*.sh; ``--device cpu`` runs on the CPU,
the default is the card). Without ``--data_root`` the data are synthetic
(``--synthetic_examples`` per task). ``--feature_type raw_<backbone>``
(raw_RN101, ...) reads ``<data_root>/images`` and runs the CLIP trunk inside
the train step (``--image_size``, ``--use_vis_adapter``, ``--clip_ckpt``);
``--backbone_ckpt`` loads a local HF BART / T5 state dict.
``--classifier`` trains the answer head on vqa (the vqa loaders carry the
answer scores over ``load_ans2label``'s vocabulary, ``num_answers`` its
size) and answers vqa by its argmax.
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

Run on N cards:  torchrun --nproc_per_node N -m vlpet_tpu_torch.cli.multitask
--distributed [--mesh_model_axis M] <flags>
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from typing import Dict, List, Tuple

from vlpet_tpu_torch.cli.param import build_model_config, parse_args
from vlpet_tpu_torch.data.datasets import (
    TASK_PROMPTS,
    DatasetConfig,
    Loader,
    TaskDataset,
    build_image_text_dataset,
    synthetic_task_data,
)
from vlpet_tpu_torch.data.features import (
    ImageFolderSource,
    MonolithicH5Source,
    PackedFeatureSource,
    PerImageH5Source,
)
from vlpet_tpu_torch.data.multitask import MultitaskLoader
from vlpet_tpu_torch.data.tokenization import (
    WhitespaceTokenizer,
    effective_vocab_size,
    get_tokenizer,
)
from vlpet_tpu_torch.evalsuite import (
    COCOCaptionEvaluator,
    GQAEvaluator,
    NLVR2Evaluator,
    VQAEvaluator,
)
from vlpet_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from vlpet_tpu_torch.parallel.multihost import (data_shard,
                                                maybe_initialize_distributed)

# per-task batch scaling (reference: multitask.py:682-695)
BATCH_SCALE = {"vqa": 1.0, "gqa": 100 / 60, "nlvr": 20 / 60, "caption": 50 / 60}
# per-task max text lengths (reference: multitask.py:683-695)
TEXT_LEN = {"vqa": 20, "gqa": 20, "nlvr": 30, "caption": 40}
GEN_LEN = {"vqa": 10, "gqa": 10, "nlvr": 10, "caption": 40}


def task_batch_size(task: str, base: int) -> int:
    return max(1, int(base * BATCH_SCALE.get(task, 1.0)))


def parse_image_size(s) -> int:
    """--image_size is reference-format: '(448,448)' or an int string."""
    if isinstance(s, int):
        return s
    digits = [int(x) for x in re.findall(r"\d+", str(s))]
    return digits[0] if digits else 224


def feature_source_for(args, task: str):
    """Pick the loader family by --feature_type (reference: multitask.py:638-680):
    'butd' → monolithic h5 with boxes; 'raw_*' → raw images (on-the-fly CLIP
    trunk inside the train step, vision.vis_encoder.RawInputVLModel); else →
    per-image clip-feature h5 (or a packed mmap if present)."""
    root = args.data_root
    if root is None:
        return None
    if args.feature_type.startswith("raw_"):
        return ImageFolderSource(
            os.path.join(root, "images"),
            image_size=parse_image_size(getattr(args, "image_size", 224)))
    packed = os.path.join(root, f"{task}_features")
    if os.path.exists(packed + ".npy"):
        return PackedFeatureSource(packed)
    if args.feature_type == "butd":
        return MonolithicH5Source(os.path.join(root, f"{task}_obj36.h5"))
    return PerImageH5Source(os.path.join(root, "clip_features",
                                         args.feature_type))


def load_ans2label(args) -> Dict[str, int]:
    """Topk answer vocabulary for the classifier head (reference:
    vqa_data.py trainval_ans2label.json). With no data_root (synthetic
    runs) a small fixed vocabulary is used."""
    if args.data_root:
        import json

        path = os.path.join(args.data_root, "trainval_ans2label.json")
        with open(path) as f:
            return json.load(f)
    return {a: i for i, a in enumerate(["yes", "no", "0", "1", "2", "3"])}


def make_evaluator(task: str, examples: List[Dict]):
    if task == "vqa":
        id2datum = {e.get("question_id"): e for e in examples}
        id2gt = {e.get("question_id"): e for e in examples if "answers" in e}
        return VQAEvaluator(id2datum, id2gt)
    if task == "gqa":
        return GQAEvaluator({e.get("question_id"): e for e in examples})
    if task == "nlvr":
        id2uid = {e["identifier"]: e.get("uid", i)
                  for i, e in enumerate(examples)}
        return NLVR2Evaluator(examples, id2uid,
                              {e.get("uid", i): e for i, e in enumerate(examples)})
    if task == "caption":
        return COCOCaptionEvaluator()
    return None


def require_stable_word_ids(args, tokenizer) -> None:
    """The WhitespaceTokenizer fallback ids a word by Python's str hash,
    which is seeded anew in every process unless PYTHONHASHSEED fixes it:
    weights or a checkpoint trained in one process would meet other token
    ids in the next. Refuse to restore one (``--resume``, ``--load``,
    ``--load_trained_model_path``) under the fallback without a fixed
    seed."""
    if not isinstance(tokenizer, WhitespaceTokenizer):
        return
    restoring = [flag for flag, on in (
        ("--resume", args.resume), ("--load", args.load),
        ("--load_trained_model_path", args.load_trained_model_path)) if on]
    if restoring and not os.environ.get("PYTHONHASHSEED", "").isdigit():
        raise ValueError(
            f"{', '.join(restoring)} with the WhitespaceTokenizer fallback "
            f"(no --tokenizer_path) needs PYTHONHASHSEED set to an integer, "
            f"the same in every run: its word ids are str hashes")


def build_loaders(args, tasks: Tuple[str, ...], tokenizer, split: str,
                  mode: str) -> List[Loader]:
    loaders = []
    for task in tasks:
        cfg = DatasetConfig(
            task=task,
            max_text_length=TEXT_LEN.get(task, args.max_text_length),
            gen_max_length=GEN_LEN.get(task, args.gen_max_length),
            n_boxes=args.n_boxes, feat_dim=int(args.feat_dim),
            prompt=TASK_PROMPTS.get(task, "") if args.use_tasks_prompts else "",
            post_prompt=args.post_prompt,
            raw_label=args.raw_label, answer_normalize=args.answer_normalize,
            classifier=bool(args.classifier and task == "vqa"),
            ans2label=(load_ans2label(args) if args.classifier
                       and task == "vqa" else None),
            use_vision=args.use_vision and not args.no_vis)
        if args.data_root:
            source = feature_source_for(args, task)
            split_json = os.path.join(args.data_root, f"{task}_{split}.json")
            ds = build_image_text_dataset(
                task, split_json, source, tokenizer, cfg, mode=mode,
                topk=int(args.train_topk if mode == "train" else args.valid_topk),
                seed=args.seed)
        else:
            n = args.synthetic_examples or 64
            grid = None
            if args.downsample:
                grid = int(math.isqrt(args.n_boxes)) * 2  # pre-pool grid
            examples, source = synthetic_task_data(
                task, n, n_boxes=args.n_boxes, feat_dim=int(args.feat_dim),
                grid=grid, seed=args.seed)
            ds = TaskDataset(cfg, examples, source, tokenizer, mode=mode,
                             seed=args.seed)
        bs = task_batch_size(task, args.batch_size if mode == "train"
                             else args.valid_batch_size)
        # per-data-shard disjoint shards (the reference's
        # DistributedSampler role, caption_clip_data.py:372-377); the eval
        # shards too, which Trainer.predict merges across the processes
        shard, num_shards = data_shard()
        loaders.append(Loader(ds, bs, shuffle=(mode == "train"),
                              drop_last=(mode == "train"),
                              evaluator=make_evaluator(task, ds.examples),
                              shard=shard, num_shards=num_shards))
    return loaders


def main(argv=None, device=None):
    """Train (or with ``--test_only`` / ``--infer_only`` evaluate) on
    ``device`` (default ``--device``, itself "cuda" by default). Returns
    (trainer, history), or the trainer after an evaluation-only run."""
    args = parse_args(argv)
    if device is not None:
        args.device = str(device)
    maybe_initialize_distributed(args)
    build_mesh(MeshConfig(model=args.mesh_model_axis))
    tasks = tuple(t for t in args.tasks.split(",") if t) or ("vqa",)
    tokenizer, added = get_tokenizer(args.backbone, args.tokenizer_path)
    require_stable_word_ids(args, tokenizer)
    cfg = build_model_config(args, tasks,
                             vocab_size=effective_vocab_size(tokenizer, added))
    if args.classifier:  # vlpet_tpu/cli/multitask.py:175-179
        cfg = dataclasses.replace(cfg, num_answers=len(load_ans2label(args)))

    t0 = time.time()
    train_loaders = build_loaders(args, tasks, tokenizer, args.train, "train")
    val_loaders = build_loaders(args, tasks, tokenizer, args.valid, "val")
    data_s = time.time() - t0
    mt = MultitaskLoader(train_loaders, sampling=args.multitask_sampling)
    total_steps = max(1, len(mt) * args.epochs)

    from vlpet_tpu_torch.train.trainer import Trainer

    raw_kw = {}
    if args.feature_type.startswith("raw_"):
        # 'raw_RN101' etc. -- CLIP trunk inside the model
        # (multitask.py:648-660)
        raw_kw = dict(raw_vis_backbone=args.feature_type[len("raw_"):],
                      image_size=parse_image_size(args.image_size),
                      vis_adapter_type=args.vis_adapter_type,
                      vis_pooling_output=args.vis_pooling_output,
                      clip_ckpt=getattr(args, "clip_ckpt", None))
    trainer = Trainer(
        cfg, tasks, lr=args.lr, total_steps=total_steps,
        warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm, adam_eps=args.adam_eps,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        seed=args.seed, output_dir=args.output, tokenizer=tokenizer,
        backbone_ckpt=args.backbone_ckpt, load=args.load,
        mesh_model_axis=args.mesh_model_axis,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        device=args.device, **raw_kw)
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
        if args.load_trained_model_path:
            from vlpet_tpu_torch.train.checkpoint import load_params_npz

            load_params_npz(args.load_trained_model_path, trainer.model)
        for loader in val_loaders:
            scores = trainer.evaluate(loader, num_beams=args.num_beams,
                                      max_length=args.gen_max_length)
            if not trainer.lead:
                continue
            print(loader.task, scores)
            if loader.task == "caption":
                print(f"[caption metric basis] {COCOCaptionEvaluator.BASIS}")
        return trainer

    history = trainer.train(mt, epochs=args.epochs, val_loaders=val_loaders)
    digest = trainer.state_digest()  # every rank: it gathers
    if trainer.lead:
        print(f"saved at step {trainer.step}; state digest {digest}")
    return trainer, history


if __name__ == "__main__":
    main()
