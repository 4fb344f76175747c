"""The training step, ported from vlpet_tpu/train/steps.py:make_train_step.

Reference control flow: src/multitask.py:229-300 -- forward, task loss,
backward, clip 5, AdamW, linear schedule. The task is static per call (the
JAX package compiles one step per task). Gradients are taken only for the
trainable parameters (the ones the optimizer holds; ``apply_freezing``
cleared ``requires_grad`` on the rest), so the frozen backbone gets no
gradient buffers and no optimizer state.

Dropout seeds come from the explicit ``generator``: the model draws one
int32 seed per dropout site per step, in one call, in the fixed order of
``VLBart.dropout_sites`` (vlpet_tpu_torch/models/vlbart.py). The JAX
package derives its seeds by splitting a flax PRNG key; the port does not
reproduce that split, so the two take the same masks only when the
seeds are handed to both (the op-level tests do so).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.heads import task_loss
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.optim import HFAdamW


def make_train_step(model, optimizer: HFAdamW, tasks: Sequence[str],
                    lambda_z: float = 0.0,
                    device: Device = "cuda") -> Callable:
    """Returns train_step(batch, generator, task_idx) -> {"loss",
    "grad_norm"} (fp32 scalar tensors; nothing syncs with the host).

    ``batch`` holds input_ids, attention_mask, vis_feats, boxes, target_ids
    (labels, -100 = ignore) and, for vqa, scores; optionally
    img_order_ids, obj_order_ids, vis_attention_mask. The model must lie on
    ``device``. ``lambda_z`` > 0 (the adapter-activation L2 regularizer of
    the reference, vlpet_tpu/train/steps.py:79-98) is not ported."""
    if lambda_z > 0:
        raise NotImplementedError("lambda_z > 0 (the adapter z regularizer) "
                                  "is not ported")
    dev = resolve_device(device)
    bad = {p.device.type for p in model.parameters()} - {dev.type}
    if bad:
        raise ValueError(f"model parameters on {sorted(bad)}, step on "
                         f"{dev.type}")
    params = optimizer.params

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   task_idx: int) -> Dict[str, torch.Tensor]:
        task = tasks[task_idx]
        ctx = PetContext(task=task, task_idx=task_idx)
        out = model(batch["input_ids"], batch["attention_mask"],
                    batch.get("vis_feats"), batch.get("boxes"),
                    labels=batch["target_ids"], ctx=ctx, deterministic=False,
                    generator=generator,
                    img_order_ids=batch.get("img_order_ids"),
                    obj_order_ids=batch.get("obj_order_ids"),
                    vis_attention_mask=batch.get("vis_attention_mask"))
        loss = task_loss(task, out["loss"], batch["target_ids"],
                         batch.get("scores"))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a trainable parameter the task does not reach gets a zero
        # gradient, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grad_norm = optimizer.step(grads)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step
