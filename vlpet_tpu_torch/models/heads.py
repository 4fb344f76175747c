"""Per-task losses, ported from vlpet_tpu/models/heads.py: the
score-weighted masked mean of VQA, the masked mean of GQA / NLVR / video QA
and the reduced CE of captioning, dispatched on the static task name, and
the classifier head's BCE over the answer vocabulary."""

from __future__ import annotations

from typing import Optional

import torch

TASK_LOSSES = {
    "vqa": "vqa",
    "gqa": "qa",
    "nlvr": "qa",
    "caption": "caption",
    "tvqa": "qa",
    "how2qa": "qa",
    "tvc": "qa",
    "yc2c": "qa",
}


def masked_mean_per_example(per_token_loss: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """CE summed over valid tokens / their count, per example (B,)."""
    mask = (labels != -100).float()
    return (per_token_loss * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)


def classifier_bce_loss(answer_logits: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    """Mean element-wise BCE with logits over (B, num_answers) score
    targets, in fp32 (vlpet_tpu/models/heads.py:76; torch's
    BCEWithLogitsLoss with its default reduction): max(x, 0) - x t +
    log1p(exp(-|x|))."""
    x, t = answer_logits.float(), target.float()
    return (x.clamp_min(0.0) - x * t
            + torch.log1p(torch.exp(-x.abs()))).mean()


def task_loss(task: str, per_token_loss: torch.Tensor, labels: torch.Tensor,
              scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar loss of one task's batch (vlpet_tpu/models/heads.py:87)."""
    kind = TASK_LOSSES.get(task, "qa")
    if kind == "vqa":
        if scores is None:
            raise ValueError("the vqa loss needs the answer scores")
        return (masked_mean_per_example(per_token_loss, labels)
                * scores).mean()
    if kind == "caption":
        valid = (labels != -100).float()
        return per_token_loss.sum() / valid.sum().clamp(min=1.0)
    return masked_mean_per_example(per_token_loss, labels).mean()
