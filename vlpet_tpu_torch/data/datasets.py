"""Per-task datasets + loader.

Reference semantics preserved:
* VQA train targets sampled from the soft-label distribution with the
  sampled score attached for loss weighting (reference:
  src/vqa_clip_data.py:265-295);
* task prompts prepended to the question/sentence (reference:
  src/multitask.py:697-706 — "vqa: ", "gqa: ", "nlvr: ", "caption: ");
* NLVR pairs two images into 2·V_L visual tokens with img_order_ids 0/1 and
  duplicated obj_order_ids (reference: src/nlvr_model.py:39-44);
* collation pads input/target ids with pad→-100 target masking (reference:
  src/vqa_clip_data.py:300-390).

TPU-first: collation pads to FIXED per-task shapes (max_text_length /
gen_max_length / n_boxes) so every batch of a task hits the same compiled
step — the reference pads to batch max, which would retrigger XLA
compilation per shape.

The port's own copy of vlpet_tpu/data/datasets.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

TASK_PROMPTS = {"vqa": "vqa: ", "gqa": "gqa: ", "nlvr": "nlvr: ",
                "caption": "caption: "}


@dataclasses.dataclass
class DatasetConfig:
    task: str
    max_text_length: int = 20
    gen_max_length: int = 10
    n_boxes: int = 36
    feat_dim: int = 2048
    prompt: str = ""
    post_prompt: str = ""  # appended after the sentence (param.py:215)
    use_vision: bool = True
    pad_to_max: bool = True  # fixed shapes for jit stability
    raw_label: bool = False
    answer_normalize: bool = False
    # classifier head: dense score targets over the topk answer vocabulary
    # (reference: vqa_clip_data.py:229-233, vqa_model.py classifier)
    classifier: bool = False
    ans2label: Optional[Dict[str, int]] = None


class TaskDataset:
    """examples: list of dicts.
      vqa:     img_id, sent, question_id, label {ans: score} (train+eval)
      gqa:     img_id, sent, question_id, label
      nlvr:    img_ids [id0, id1], sent, uid, identifier, label (0/1)
      caption: img_id, sent (train target), targets (eval refs)
      video*:  clip_id (as img_id), sent, question_id/answer fields
    """

    def __init__(self, cfg: DatasetConfig, examples: List[Dict],
                 feature_source, tokenizer, mode: str = "train",
                 seed: int = 0):
        self.cfg = cfg
        self.examples = examples
        self.source = feature_source
        self.tokenizer = tokenizer
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.examples)

    def _encode(self, text: str, max_len: int) -> List[int]:
        return self.tokenizer.encode(text, max_length=max_len, truncation=True)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        cfg = self.cfg
        d = self.examples[idx]
        out: Dict[str, Any] = {"task": cfg.task}

        if cfg.use_vision:
            if getattr(self.source, "is_raw", False):
                # raw_* path: the batch carries preprocessed images; the CLIP
                # trunk runs inside the model (RawInputVLModel)
                if cfg.task == "nlvr":
                    # two preprocessed images per example, stacked to
                    # (2, H, W, 3); the trunk runs on both inside the step
                    # (reference: nlvr_raw_data.py:132-144 stacks img0/img1,
                    # nlvr_model.py:17-24 flattens (B,2,...)→(2B,...))
                    i0, i1 = _nlvr_img_ids(d)
                    out["images"] = np.stack([self.source.get(i0)[0],
                                              self.source.get(i1)[0]])
                else:
                    out["images"], _ = self.source.get(d["img_id"])
            elif cfg.task == "nlvr":
                i0, i1 = _nlvr_img_ids(d)
                f0, b0 = self.source.get(i0)
                f1, b1 = self.source.get(i1)
                out["vis_feats"] = np.concatenate([f0, f1], axis=0)
                out["boxes"] = np.concatenate([b0, b1], axis=0)
                n = f0.shape[0]
                out["img_order_ids"] = np.concatenate(
                    [np.zeros(n, np.int32), np.ones(n, np.int32)])
                out["obj_order_ids"] = np.concatenate(
                    [np.arange(n, dtype=np.int32)] * 2)
            else:
                feats, boxes = self.source.get(d["img_id"])
                out["vis_feats"] = feats
                out["boxes"] = boxes

        sent = d.get("sent") or d.get("question")
        out["sent"] = sent
        out["input_ids"] = self._encode(f"{cfg.prompt}{sent}{cfg.post_prompt}",
                                        cfg.max_text_length)
        out["question_id"] = d.get("question_id", d.get("uid", idx))
        if "is_topk_optimal" in d:
            out["is_topk_optimal"] = d["is_topk_optimal"]

        # targets
        if cfg.task == "vqa" and cfg.classifier and "label" in d:
            # dense score vector over the topk answer vocabulary
            # (reference: vqa_clip_data.py:229-233)
            assert cfg.ans2label is not None, "classifier needs ans2label"
            target = np.zeros(len(cfg.ans2label), np.float32)
            for ans, score in (d.get("label") or {}).items():
                if ans in cfg.ans2label:
                    target[cfg.ans2label[ans]] = score
            out["target"] = target
            out["answer"] = (max(d["label"].items(), key=lambda kv: kv[1])[0]
                             if d.get("label") else "")
        elif cfg.task == "vqa" and cfg.raw_label and "answers" in d:
            # sample uniformly from the 10 raw annotator answers
            # (reference: vqa_clip_data.py:235-265)
            answers = d["answers"]
            answer = answers[int(self.rng.integers(len(answers)))]
            if isinstance(answer, dict):
                answer = answer["answer"]
            if cfg.answer_normalize:
                from vlpet_tpu_torch.evalsuite.vqa import normalize_answer

                answer = normalize_answer(answer)
            out["answer"] = answer
            out["score"] = float(len(answers) > 0)
            out["all_answers"] = [a["answer"] if isinstance(a, dict) else a
                                  for a in answers]
            out["target_ids"] = self._encode(answer, cfg.gen_max_length)
        elif cfg.task == "vqa" and "label" in d and d["label"]:
            answers, scores = zip(*d["label"].items())
            ssum = float(sum(scores))
            if ssum == 0:
                answer, score = "", 0.0
            else:
                probs = [s / ssum for s in scores]
                choice = int(self.rng.multinomial(1, probs).argmax())
                answer, score = answers[choice], scores[choice]
            out["answer"] = answer
            out["score"] = float(score)
            out["all_answers"] = list(answers)
            out["target_ids"] = self._encode(answer, cfg.gen_max_length)
        elif cfg.task in ("gqa",) and "label" in d and d["label"]:
            answer = max(d["label"].items(), key=lambda kv: kv[1])[0]
            out["answer"] = answer
            out["target_ids"] = self._encode(answer, cfg.gen_max_length)
        elif cfg.task == "nlvr":
            out["label"] = int(d["label"])
            out["target_ids"] = self._encode(
                "true" if int(d["label"]) == 1 else "false", cfg.gen_max_length)
            out["identifier"] = d.get("identifier", "")
        elif "answer" in d:  # video QA style
            out["answer"] = d["answer"]
            out["target_ids"] = self._encode(str(d["answer"]), cfg.gen_max_length)
        elif "sent_target" in d or cfg.task in ("caption", "tvc", "yc2c"):
            tgt = d.get("sent_target", sent)
            out["target_ids"] = self._encode(tgt, cfg.gen_max_length)
        if "targets" in d:
            out["targets"] = d["targets"]
        return out

    # ------------------------------------------------------------------
    def collate(self, batch: List[Dict]) -> Dict[str, Any]:
        cfg = self.cfg
        pad = self.tokenizer.pad_token_id
        B = len(batch)
        in_len = (cfg.max_text_length if cfg.pad_to_max
                  else max(len(e["input_ids"]) for e in batch))
        input_ids = np.full((B, in_len), pad, np.int32)
        attention_mask = np.zeros((B, in_len), np.int32)
        for i, e in enumerate(batch):
            ids = e["input_ids"][:in_len]
            input_ids[i, :len(ids)] = ids
            attention_mask[i, :len(ids)] = 1
        out: Dict[str, Any] = {"input_ids": input_ids,
                               "attention_mask": attention_mask,
                               "task": cfg.task}
        if "target_ids" in batch[0]:
            t_len = (cfg.gen_max_length if cfg.pad_to_max
                     else max(len(e["target_ids"]) for e in batch))
            target_ids = np.full((B, t_len), -100, np.int32)
            for i, e in enumerate(batch):
                ids = e["target_ids"][:t_len]
                target_ids[i, :len(ids)] = ids
            out["target_ids"] = target_ids
        if cfg.use_vision and "images" in batch[0]:
            out["images"] = _stack_f32(batch, "images")
        elif cfg.use_vision:
            # preallocated fill — np.stack + astype made two full copies of
            # the ~30 MB feature batch (the collate hot spot on the 1-core
            # host: scripts/bench_input_pipeline.py)
            out["vis_feats"] = _stack_f32(batch, "vis_feats")
            out["boxes"] = _stack_f32(batch, "boxes")
            if "img_order_ids" in batch[0]:
                out["img_order_ids"] = np.stack([e["img_order_ids"] for e in batch])
                out["obj_order_ids"] = np.stack([e["obj_order_ids"] for e in batch])
        if "target" in batch[0]:  # classifier dense score targets
            out["target"] = np.stack([e["target"] for e in batch])
        if "score" in batch[0]:
            out["scores"] = np.asarray([e.get("score", 0.0) for e in batch],
                                       np.float32)
        for key in ("question_id", "sent", "answer", "all_answers", "label",
                    "identifier", "targets"):
            if key in batch[0]:
                out[key + "s" if not key.endswith("s") else key] = \
                    [e.get(key) for e in batch]
        if "is_topk_optimal" in batch[0]:  # reference keeps the exact name
            out["is_topk_optimal"] = [e.get("is_topk_optimal") for e in batch]
        return out


def _nlvr_img_ids(d: Dict) -> Sequence[str]:
    """NLVR examples carry two image ids: the reference's split jsons use
    'img0'/'img1' keys (reference: nlvr_data.py:130, nlvr_raw_data.py:133);
    synthetic fixtures use an 'img_ids' pair."""
    if "img_ids" in d:
        return d["img_ids"]
    return d["img0"], d["img1"]


def _stack_f32(batch: List[Dict], key: str) -> np.ndarray:
    """One-copy float32 batch stack: rows write straight into the output
    (np.stack(...).astype(np.float32) costs two full passes)."""
    first = np.asarray(batch[0][key])
    out = np.empty((len(batch),) + first.shape, np.float32)
    for i, e in enumerate(batch):
        out[i] = e[key]
    return out


class Loader:
    """Epoch-seeded shuffling batch iterator with .task/.evaluator attributes
    (the reference's DataLoader+DistributedSampler role, reference:
    caption_clip_data.py:354-397). ``shard``/``num_shards`` give per-host
    sharding for multi-process data parallelism."""

    def __init__(self, dataset: TaskDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 evaluator=None, shard: int = 0, num_shards: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.task = dataset.cfg.task
        self.evaluator = evaluator
        self.shard = shard
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        """Batches of this shard: under drop_last the full batches of the
        smallest shard, the same count on every shard (a data-parallel
        step needs every rank's batch); else every example of the shard
        (ceil(shard size / batch size)), so that the merged eval shards
        cover the split."""
        if self.drop_last:
            n = len(self.dataset) // self.num_shards
            return n // self.batch_size
        n = len(range(self.shard, len(self.dataset), self.num_shards))
        return -(-n // self.batch_size)

    def _produce(self) -> Iterator[Dict[str, Any]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.epoch).shuffle(idx)
        idx = idx[self.shard::self.num_shards]
        n_batches = len(self)
        for b in range(n_batches):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) == 0:
                break
            batch = [self.dataset[int(i)] for i in sel]
            yield self.dataset.collate(batch)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        # batches come off a background thread (bounded queue) so feature IO
        # and collation overlap the device step — the DataLoader-workers role
        # of the reference (num_workers, multitask.py:87)
        if self.prefetch <= 0:
            yield from self._produce()
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            try:
                for item in self._produce():
                    q.put(item)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            yield item


# ---------------------------------------------------------------------------
# Real-data builders (json layouts of the reference datasets)
# ---------------------------------------------------------------------------


def build_image_text_dataset(task: str, split_json: str, feature_source,
                             tokenizer, cfg: DatasetConfig,
                             mode: str = "train", topk: int = -1,
                             seed: int = 0) -> TaskDataset:
    """Load a reference-format split json (list of example dicts) into a
    TaskDataset. Works with the Karpathy-split jsons the reference ships for
    VQA/GQA/NLVR/COCO caption (reference: src/*_data.py dataset classes)."""
    import json

    with open(split_json) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("data", list(data.values())[0])
    if topk > 0:
        data = data[:int(topk)]
    return TaskDataset(cfg, data, feature_source, tokenizer, mode=mode,
                       seed=seed)


# ---------------------------------------------------------------------------
# Synthetic data (tests + smoke training without the real corpora)
# ---------------------------------------------------------------------------


def synthetic_task_data(task: str, n: int, n_boxes: int = 36,
                        feat_dim: int = 2048, grid: Optional[int] = None,
                        seed: int = 0):
    """Returns (examples, DictFeatureSource) shaped like the real datasets."""
    from vlpet_tpu_torch.data.features import DictFeatureSource

    rng = np.random.default_rng(seed)
    L = grid * grid if grid else n_boxes
    words = ["red", "blue", "dog", "cat", "ball", "table", "man", "woman",
             "tree", "car"]
    feats = {}
    examples = []
    for i in range(n):
        img_id = f"{task}_img_{i}"
        feats[img_id] = rng.normal(size=(L, feat_dim)).astype(np.float32)
        sent = " ".join(rng.choice(words, 5))
        if task == "vqa":
            examples.append({"img_id": img_id, "sent": f"what is {sent}",
                             "question_id": i,
                             "label": {str(rng.choice(words)): 1.0,
                                       str(rng.choice(words)): 0.3}})
        elif task == "gqa":
            examples.append({"img_id": img_id, "sent": f"is there {sent}",
                             "question_id": i,
                             "label": {str(rng.choice(words)): 1.0}})
        elif task == "nlvr":
            img2 = f"{task}_img2_{i}"
            feats[img2] = rng.normal(size=(L, feat_dim)).astype(np.float32)
            examples.append({"img_ids": [img_id, img2], "sent": sent,
                             "uid": i, "identifier": f"test1-{i // 2}-{i % 2}-0",
                             "label": int(rng.integers(0, 2))})
        elif task == "caption":
            examples.append({"img_id": img_id, "sent": sent,
                             "targets": [sent, sent + " outside"],
                             "question_id": i})
        else:  # video tasks
            examples.append({"img_id": img_id, "sent": f"q: {sent}",
                             "question_id": i, "answer": str(rng.choice(words))})
    return examples, DictFeatureSource(feats)
