"""Task evaluators of the port: VQA / GQA / NLVR2 / COCO caption / video
(TVQA / How2QA accuracy, TVC / YC2C CIDEr), copies of vlpet_tpu/evalsuite/.
The caption metrics (BLEU / ROUGE-L / CIDEr-D) are pure Python; METEOR and
SPICE are reported as None."""

from vlpet_tpu_torch.evalsuite.vqa import VQAEvaluator
from vlpet_tpu_torch.evalsuite.gqa import GQAEvaluator
from vlpet_tpu_torch.evalsuite.nlvr import NLVR2Evaluator
from vlpet_tpu_torch.evalsuite.caption import (COCOCaptionEvaluator, cider_d,
                                               corpus_bleu, rouge_l)
from vlpet_tpu_torch.evalsuite.video import TVQAEvaluator, TVCEvaluator
