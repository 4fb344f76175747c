"""Official VQAv2 accuracy evaluation.

Reference: src/vqa_data.py:483-693, itself the official GT-Vision-Lab VQA
toolkit normalization (contraction map, digit/article maps, punctuation
stripping) — that normalization is the published VQA evaluation *spec*, so
the tables below necessarily carry the same content.

The port's own copy of vlpet_tpu/evalsuite/vqa.py.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
              "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
              "nine": "9", "ten": "10"}

ARTICLES = ["a", "an", "the"]

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
         "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    ans = process_punctuation(ans)
    ans = process_digit_article(ans)
    return ans.replace(",", "")


class VQAEvaluator:
    """quesid → answer accuracy.

    * ``evaluate``: topk-label soft-score accuracy (reference: vqa_data.py:539)
    * ``evaluate_raw``: official min(#matching/3, 1) accuracy over 10 human
      answers (reference: vqa_data.py:569-638)
    """

    def __init__(self, id2datum: Optional[Dict] = None,
                 id2datum_gt: Optional[Dict] = None):
        self.id2datum = id2datum or {}
        self.id2datum_gt = id2datum_gt or {}

    def evaluate(self, quesid2ans: Dict) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            label = self.id2datum[quesid]["label"]
            if ans in label:
                score += label[ans]
        return score / max(len(quesid2ans), 1)

    def evaluate_raw(self, quesid2ans: Dict, is_topk_optimal=None) -> Dict:
        acc_qa = []
        per_qtype: Dict[str, list] = {}
        per_atype: Dict[str, list] = {}
        for quesid, res_ans in quesid2ans.items():
            quesid = int(quesid)
            datum = self.id2datum.get(quesid, {})
            if is_topk_optimal is not None and \
                    datum.get("is_topk_optimal") is not None and \
                    datum["is_topk_optimal"] != is_topk_optimal:
                continue
            gt = self.id2datum_gt[quesid]
            res_ans = res_ans.replace("\n", " ").replace("\t", " ").strip()
            res_ans = process_punctuation(res_ans)
            res_ans = process_digit_article(res_ans)
            answers = [dict(a) for a in gt["answers"]]
            if len(set(a["answer"] for a in answers)) > 1:
                for a in answers:
                    a["answer"] = process_punctuation(a["answer"])
            accs = []
            for i, _ in enumerate(answers):
                others = answers[:i] + answers[i + 1:]
                matching = [a for a in others if a["answer"] == res_ans]
                accs.append(min(1.0, len(matching) / 3.0))
            acc = sum(accs) / len(accs)
            acc_qa.append(acc)
            per_qtype.setdefault(gt.get("question_type", ""), []).append(acc)
            per_atype.setdefault(gt.get("answer_type", ""), []).append(acc)
        if not acc_qa:
            return {"overall": 0, "perQuestionType": {}, "perAnswerType": {}}
        rnd = lambda xs: round(100.0 * sum(xs) / len(xs), 2)
        return {"overall": rnd(acc_qa),
                "perQuestionType": {k: rnd(v) for k, v in per_qtype.items()},
                "perAnswerType": {k: rnd(v) for k, v in per_atype.items()}}

    def dump_result(self, quesid2ans: Dict, path: str):
        with open(path, "w") as f:
            json.dump([{"question_id": q, "answer": a}
                       for q, a in quesid2ans.items()], f, indent=4,
                      sort_keys=True)
