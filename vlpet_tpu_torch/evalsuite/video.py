"""Video-task evaluators, the port's own copy of vlpet_tpu/evalsuite/video.py.

Reference: src/video/tvqa_data.py:357-388 (per-show/type accuracy for
TVQA/How2QA) and src/video/tvc_data.py:362-366 (CIDEr-only captioning for
TVC/YC2C)."""

from __future__ import annotations

from typing import Dict, List, Optional

from vlpet_tpu_torch.evalsuite.caption import COCOCaptionEvaluator


class TVQAEvaluator:
    """Multiple-choice QA accuracy, overall + per type/show."""

    def __init__(self, dataset: Optional[List[Dict]] = None,
                 types: Optional[List[str]] = None):
        self.dataset = dataset or []
        self.types = types or []

    def eval(self, preds: List[Dict]) -> Dict[str, float]:
        result_d = {r["question_id"]: r for r in self.dataset}
        type_count = {t: 0 for t in self.types}
        corrects = {t: 0 for t in self.types}
        for r in self.dataset:
            type_count[r["type"]] += 1
        n_correct = 0
        for p in preds:
            gt = result_d[p["question_id"]]
            if p["answer"] == gt["answer"]:
                corrects[gt["type"]] += 1
                n_correct += 1
        out = {t: (corrects[t] / type_count[t] if type_count[t] else 0.0)
               for t in self.types}
        out["overall"] = n_correct / max(len(preds), 1)
        return out


class TVCEvaluator:
    """CIDEr-only caption scoring (reference: tvc_data.py:362-366)."""

    def __init__(self, data=None, types=None):
        self.evaluator = COCOCaptionEvaluator(coco_types=["CIDEr"])

    def evaluate(self, predicts: List[str], answers: List) -> Dict[str, float]:
        return self.evaluator.evaluate(predicts, answers)
