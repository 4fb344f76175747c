"""GQA evaluator (reference: src/gqa_data.py:419-452).

The port's own copy of vlpet_tpu/evalsuite/gqa.py.
"""

from __future__ import annotations

import json
from typing import Dict, Optional


class GQAEvaluator:
    def __init__(self, id2datum: Optional[Dict] = None):
        self.id2datum = id2datum or {}

    def evaluate(self, quesid2ans: Dict) -> float:
        """Label-hit rate weighted by the label score."""
        score = 0.0
        for quesid, ans in quesid2ans.items():
            label = self.id2datum[quesid]["label"]
            if ans in label:
                score += label[ans]
        return score / max(len(quesid2ans), 1)

    def dump_result(self, quesid2ans: Dict, path: str):
        """GQA-challenge submittable json (questionId/prediction)."""
        with open(path, "w") as f:
            json.dump([{"questionId": q, "prediction": a}
                       for q, a in quesid2ans.items()], f, indent=4,
                      sort_keys=True)
