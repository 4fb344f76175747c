"""NLVR2 evaluator: accuracy + consistency
(reference: src/nlvr_data.py:394-471, following the official
lil-lab/nlvr2 metrics: consistency groups share an identifier with the
pair-index field blanked).

The port's own copy of vlpet_tpu/evalsuite/nlvr.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class NLVR2Evaluator:
    def __init__(self, data: Optional[List[Dict]] = None,
                 identifier2uid: Optional[Dict] = None,
                 id2datum: Optional[Dict] = None):
        self.data = data or []
        self.identifier2uid = identifier2uid or {}
        self.id2datum = id2datum or {}

    def evaluate_train(self, quesid2ans: Dict) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            if ans == self.id2datum[quesid]["label"]:
                score += 1
        return score / max(len(quesid2ans), 1)

    def evaluate(self, quesid2ans: Dict) -> Dict[str, float]:
        """accuracy + consistency. Identifier format: split-setid-pairid-sentid;
        a consistency group blanks the pair index (field 2)."""
        num_correct = 0.0
        consistency: Dict[str, bool] = {}
        for example in self.data:
            parts = example["identifier"].split("-")
            parts[2] = ""
            group = "-".join(parts)
            consistency.setdefault(group, True)
            uid = self.identifier2uid[example["identifier"]]
            if int(quesid2ans[uid]) == int(example["label"]):
                num_correct += 1.0
            else:
                consistency[group] = False
        n = max(len(self.data), 1)
        accuracy = num_correct / n
        n_groups = max(len(consistency), 1)
        consistency_score = sum(consistency.values()) / n_groups
        return {"accuracy": accuracy * 100.0,
                "consistency": consistency_score * 100.0}

    def dump_result(self, quesid2ans: Dict, path: str):
        with open(path, "w") as f:
            for uid, ans in quesid2ans.items():
                idt = self.id2datum[uid]["identifier"]
                f.write("%s,%s\n" % (idt, "True" if int(ans) == 1 else "False"))
