"""Video-text datasets: TVQA / How2QA (multiple-choice QA) and TVC / YC2C
(clip captioning).

Reference: src/video/tvqa_data.py (prompt construction :180-215 — the input
is "[Subs] ... [Q] q [TS] (ts) [Choices] a0: ... a4: ..." and the target is
"a{answer_idx}"), src/video/tvc_data.py / yc2c_data.py (captioning on
CLIP-ViT frame features), frame features resized along time to n_boxes=64
(tvqa_data.py:34-47 — handled by NpzVideoSource/resize_time_axis).

The port's own copy of vlpet_tpu/data/video.py.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vlpet_tpu_torch.data.datasets import DatasetConfig, Loader, TaskDataset
from vlpet_tpu_torch.data.features import DictFeatureSource, NpzVideoSource
from vlpet_tpu_torch.evalsuite.video import TVCEvaluator, TVQAEvaluator
from vlpet_tpu_torch.parallel.multihost import data_shard

VIDEO_QA_TASKS = ("tvqa", "how2qa")
VIDEO_CAP_TASKS = ("tvc", "yc2c")


def build_qa_prompt(datum: Dict, subtitles: Optional[Dict] = None,
                    n_options: int = 5) -> str:
    """TVQA-style prompt (reference: tvqa_data.py:180-207)."""
    vid = datum.get("vid_name", "")
    subs = ""
    if subtitles and vid in subtitles:
        subs = " ".join(t["text"].strip() for t in subtitles[vid])
    subs = f"[Subs] {subs}"
    choices = " ".join(f"a{i}: {str(datum.get(f'a{i}', '')).strip('. ')}."
                       for i in range(n_options))
    parts = [subs, f"[Q] {str(datum.get('q', '')).strip()}",
             f"[TS] ({datum.get('ts', '')})", f"[Choices] {choices}"]
    return " ".join(parts)


def load_video_qa(task: str, ann_path: str,
                  subtitles_path: Optional[str] = None,
                  topk: int = -1) -> Tuple[List[Dict], List[str]]:
    """Parse tvqa/how2qa jsonl annotations into TaskDataset examples.
    Returns (examples, show_types)."""
    subtitles = None
    if subtitles_path and os.path.exists(subtitles_path):
        with open(subtitles_path) as f:
            subtitles = json.load(f)
    examples = []
    types = set()
    with open(ann_path) as f:
        for line in f:
            d = json.loads(line)
            ex = {
                "img_id": d["vid_name"],
                "question_id": d.get("qid", len(examples)),
                "type": d.get("show_name", task),
                "sent": build_qa_prompt(d, subtitles),
            }
            if "answer_idx" in d:
                ex["answer"] = f"a{d['answer_idx']}"
            types.add(ex["type"])
            examples.append(ex)
            if 0 < topk <= len(examples):
                break
    return examples, sorted(types)


def load_video_caption(task: str, ann_path: str, topk: int = -1,
                       mode: str = "train") -> List[Dict]:
    """Parse tvc/yc2c jsonl: one (clip, desc) pair per train item; all descs
    as eval targets (reference: tvc_data.py)."""
    examples = []
    with open(ann_path) as f:
        for line in f:
            d = json.loads(line)
            descs = [x["desc"] if isinstance(x, dict) else x
                     for x in d.get("descs", [d.get("desc", "")])]
            base = {"img_id": d["vid_name"],
                    "question_id": d.get("clip_id", len(examples)),
                    "sent": f"[TS] ({d.get('ts', '')})"}
            if mode == "train":
                for desc in descs:
                    examples.append({**base, "sent_target": desc})
            else:
                examples.append({**base, "targets": descs})
            if 0 < topk <= len(examples):
                break
    return examples


def build_video_loader(task: str, args, tokenizer, split: str, mode: str,
                       data_root: Optional[str] = None) -> Loader:
    """Build a video-task Loader; synthetic when no data_root."""
    cfg = DatasetConfig(
        task=task, max_text_length=600 if task in VIDEO_QA_TASKS else 77,
        gen_max_length=args.gen_max_length, n_boxes=args.n_boxes,
        feat_dim=int(args.feat_dim), prompt="", use_vision=True)
    if data_root:
        source = NpzVideoSource(
            os.path.join(data_root, "vis_features", task, "clip-vit"),
            n_frames=args.n_boxes)
        ann = os.path.join(data_root, "ann", task, f"{task}_{split}.jsonl")
        if task in VIDEO_QA_TASKS:
            subs = os.path.join(data_root, "ann", task, "subtitles.json")
            examples, types = load_video_qa(task, ann, subs,
                                            topk=int(args.train_topk))
            evaluator = TVQAEvaluator(examples, types)
        else:
            examples = load_video_caption(task, ann, mode=mode)
            evaluator = TVCEvaluator()
    else:
        examples, source, evaluator = synthetic_video_data(
            task, args.synthetic_examples or 16, n_frames=args.n_boxes,
            feat_dim=int(args.feat_dim), seed=args.seed)
    ds = TaskDataset(cfg, examples, source, tokenizer, mode=mode,
                     seed=args.seed)
    # per-data-shard disjoint shards (the reference's DistributedSampler
    # role); the eval shards too, which Trainer.predict merges
    shard, num_shards = data_shard()
    return Loader(ds, args.batch_size if mode == "train" else args.valid_batch_size,
                  shuffle=(mode == "train"), drop_last=(mode == "train"),
                  evaluator=evaluator, shard=shard, num_shards=num_shards)


def synthetic_video_data(task: str, n: int, n_frames: int = 64,
                         feat_dim: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = {}
    examples = []
    types = ["showA", "showB"]
    for i in range(n):
        vid = f"{task}_vid_{i}"
        feats[vid] = rng.normal(size=(n_frames, feat_dim)).astype(np.float32)
        if task in VIDEO_QA_TASKS:
            d = {"vid_name": vid, "q": "what happened", "ts": "0.0-3.0",
                 **{f"a{k}": f"option {k}" for k in range(5)}}
            examples.append({
                "img_id": vid, "question_id": i, "type": types[i % 2],
                "sent": build_qa_prompt(d),
                "answer": f"a{int(rng.integers(0, 5))}"})
        else:
            desc = f"clip {i} does something"
            examples.append({"img_id": vid, "question_id": i,
                             "sent": "[TS] (0.0-3.0)", "sent_target": desc,
                             "targets": [desc]})
    if task in VIDEO_QA_TASKS:
        evaluator = TVQAEvaluator(examples, types)
    else:
        evaluator = TVCEvaluator()
    return examples, DictFeatureSource(feats), evaluator


# ---------------------------------------------------------------------------
# Matching variant (reference: src/video/tvqa_matching_data.py,
# video_matching_model.py): each multiple-choice question expands to 5
# (question, candidate) rows scored "true"/"false"; prediction = argmax of
# the true-score across a question's rows.
# ---------------------------------------------------------------------------


def expand_matching_examples(examples: List[Dict],
                             n_options: int = 5) -> List[Dict]:
    """QA examples (with a0..a4 inside 'options' or prompt-built 'sent') →
    one row per candidate with binary targets."""
    rows = []
    for ex in examples:
        options = ex.get("options")
        for i in range(n_options):
            cand = (options[i] if options is not None
                    else f"a{i}")
            sent = f"{ex['sent']} A: {str(cand).strip('. ')}."
            rows.append({
                "img_id": ex["img_id"],
                "question_id": f"{ex['question_id']}/a{i}",
                "group_id": ex["question_id"],
                "candidate": f"a{i}",
                "sent": sent,
                "answer": ("true" if ex.get("answer") == f"a{i}" else "false"),
                "type": ex.get("type", ""),
            })
    return rows


class MatchingEvaluator:
    """Argmax-over-candidates accuracy for the matching formulation."""

    def __init__(self, examples: List[Dict], types: Optional[List[str]] = None):
        self.gt = {e["question_id"]: e.get("answer") for e in examples}
        self.types = types or []
        self.type_of = {e["question_id"]: e.get("type", "") for e in examples}

    def evaluate(self, group_scores: Dict) -> Dict[str, float]:
        """group_scores: {group_id: {candidate: true_score}}."""
        correct = 0
        n = 0
        for gid, scores in group_scores.items():
            if gid not in self.gt or self.gt[gid] is None:
                continue
            pred = max(scores.items(), key=lambda kv: kv[1])[0]
            correct += int(pred == self.gt[gid])
            n += 1
        return {"overall": correct / max(n, 1)}
