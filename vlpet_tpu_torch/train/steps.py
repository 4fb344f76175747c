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

Data parallelism (one process per card, parallel/multihost.py): where a
process group is up, each rank takes its contiguous share of the global
batch, every rank's share of the same size (the train Loaders' drop_last
shards give it), and the step equals one process on the concatenation
of the ranks' batches. Each rank's loss is its numerator over the
global denominator: the caption loss's token sum over the global count
of valid tokens (one small all-reduce, started before the forward), every
other term its own mean over the world size; the dropout seeds fold to
the rank's examples (``PetContext.example_base``). The trainable
gradients and the loss go into one fp32 bucket, summed by one
all-reduce a step on the device; then the clip by the global norm and the
update run on every rank alike, as in one process. (DDP's reducer hooks
``.backward()``; this step takes ``torch.autograd.grad``.)

Under tensor parallelism (parallel/mesh.py) every count above is the
data axis's: a rank's share is its data index's, the all-reduces run over
its data group, and the ranks of a model group -- which hold the whole
gradients of the replicated trainables already (parallel/tensor.py) --
take the same batch. A trainable that is itself split (BitFit's q/k/v and
fc1 biases, the weights of full fine-tuning) trains as the rank's shard,
and the clip takes the whole tensors' norm (``HFAdamW.shard_norm``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from vlpet_tpu_torch.device import Device, resolve_device
from vlpet_tpu_torch.models.heads import (TASK_LOSSES, classifier_bce_loss,
                                          task_loss)
from vlpet_tpu_torch.parallel.mesh import current_layout, split_names
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.optim import HFAdamW


class GradAccumulator:
    """optax.MultiSteps(every_k_schedule=k) over the optimizer: each
    micro-batch's gradients join a running mean (Welford's update, as
    optax's ``use_grad_mean``), and every k-th call hands the mean of the k
    to the optimizer (one clipped AdamW update) and starts over."""

    def __init__(self, params: Sequence[torch.Tensor], k: int):
        self.k = k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]

    @torch.no_grad()
    def add(self, grads) -> Optional[list]:
        """Fold in one micro-batch; the mean of the k on the k-th call,
        else None."""
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g.float() - a) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step:
            return None
        mean = [a.clone() for a in self.acc]
        for a in self.acc:
            a.zero_()
        return mean

    def state_dict(self) -> Dict:
        return {"mini_step": self.mini_step, "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.mini_step = int(state["mini_step"])
        for a, b in zip(self.acc, state["acc"]):
            a.copy_(b)


def z_penalty(zs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over the recorded adapter activations of mean(z^2), in
    fp32 (vlpet_tpu/train/steps.py:88-97; the reference's
    multitask.py:242-256)."""
    return sum(z.float().square().mean() for z in zs) / len(zs)


def all_reduce_grads(grads, loss: torch.Tensor, group=None):
    """(summed gradients, summed loss) over ``group`` (the data group; the
    default group when None): the gradients (fp32 views of one bucket)
    and the loss in one all-reduce on the device."""
    bucket = torch.cat([g.float().reshape(-1) for g in grads]
                       + [loss.detach().float().reshape(1)])
    dist.all_reduce(bucket, group=group)
    out, off = [], 0
    for g in grads:
        out.append(bucket[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out, bucket[-1]


def make_train_step(model, optimizer: HFAdamW, tasks: Sequence[str],
                    lambda_z: float = 0.0, device: Device = "cuda",
                    accumulation_steps: int = 1) -> Callable:
    """Returns train_step(batch, generator, task_idx) -> {"loss",
    "grad_norm"} (fp32 scalar tensors; nothing syncs with the host).
    ``accumulation_steps`` k > 1 updates the parameters every k-th call with
    the mean of the k gradients (``GradAccumulator``, held as
    ``train_step.accumulator``); "grad_norm" is then the micro-batch's, as
    the JAX step reports it.

    ``batch`` holds input_ids, attention_mask, vis_feats, boxes, target_ids
    (labels, -100 = ignore) and, for vqa, scores; optionally
    img_order_ids, obj_order_ids, vis_attention_mask. A batch that carries
    ``target`` (the classifier's (B, num_answers) answer scores) trains
    the answer head: ``model.classify`` on one decoder start token, the
    BCE over the answer vocabulary (vlpet_tpu/train/steps.py:56-71). The
    raw-image path's model (vision/vis_encoder.py RawInputVLModel) takes
    its images, (B, 3, H, W) or the NLVR pair (B, 2, 3, H, W), as
    vis_feats with no boxes, and
    runs the CLIP trunk inside the step (vlpet_tpu/train/steps.py:158-189);
    the trunk's BatchNorms keep their running statistics. The model must
    lie on ``device``. ``lambda_z`` > 0 adds the reference's
    adapter-activation L2 regularizer (vlpet_tpu/train/steps.py:79-98):
    lambda_z times the mean over the adapters that record their z
    (``track_z``, ``PetContext.zs``) of mean(z^2), in fp32; a model with
    no such adapter adds nothing. Under a process group (the module
    docstring) "loss" and "grad_norm" are the global batch's, the same on
    every rank, as the JAX step reports them under a mesh."""
    dev = resolve_device(device)
    bad = {p.device.type for p in model.parameters()} - {dev.type}
    if bad:
        raise ValueError(f"model parameters on {sorted(bad)}, step on "
                         f"{dev.type}")
    params = optimizer.params
    if getattr(model, "tp", None) is not None:
        optimizer.shard_norm(split_names(model), model.tp.group)
    parallel = dist.is_available() and dist.is_initialized()
    layout = current_layout()
    rank, world, group = layout.data_index, layout.data, layout.data_group

    def share(x: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's equal share as its part of the global
        mean."""
        return x / world if world > 1 else x

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   task_idx: int) -> Dict[str, torch.Tensor]:
        task = tasks[task_idx]
        b = batch["input_ids"].shape[0]
        ctx = PetContext(task=task, task_idx=task_idx,
                         zs=[] if lambda_z > 0 else None,
                         example_base=rank * b,
                         global_batch=world * b if world > 1 else None)
        classify = (batch.get("target") is not None
                    and hasattr(model, "classify"))
        valid = None  # the global count of valid caption tokens
        if (parallel and not classify
                and TASK_LOSSES.get(task, "qa") == "caption"):
            valid = (batch["target_ids"] != -100).sum().float()
            pending = dist.all_reduce(valid, group=group, async_op=True)
        # the raw-image model (no ``classify``) takes the LM loss whatever
        # the batch carries, as the JAX raw step does
        if classify:
            logits = model.classify(
                batch["input_ids"], batch["attention_mask"],
                batch.get("vis_feats"), batch.get("boxes"),
                img_order_ids=batch.get("img_order_ids"),
                obj_order_ids=batch.get("obj_order_ids"), ctx=ctx,
                deterministic=False, generator=generator)
            loss = share(classifier_bce_loss(logits, batch["target"]))
        else:
            out = model(batch["input_ids"], batch["attention_mask"],
                        batch.get("vis_feats"), batch.get("boxes"),
                        labels=batch["target_ids"], ctx=ctx,
                        deterministic=False, generator=generator,
                        img_order_ids=batch.get("img_order_ids"),
                        obj_order_ids=batch.get("obj_order_ids"),
                        vis_attention_mask=batch.get("vis_attention_mask"))
            if valid is not None:
                pending.wait()
                loss = out["loss"].sum() / valid.clamp(min=1.0)
            else:
                loss = share(task_loss(task, out["loss"], batch["target_ids"],
                                       batch.get("scores")))
            if ctx.zs:
                loss = loss + lambda_z * share(z_penalty(ctx.zs))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a trainable parameter the task does not reach gets a zero
        # gradient, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if parallel:
            grads, loss = all_reduce_grads(grads, loss, group)
        if accumulator is None:
            grad_norm = optimizer.step(grads)
        else:
            grad_norm = optimizer.norm(grads)
            mean = accumulator.add(grads)
            if mean is not None:
                optimizer.step(mean)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    accumulator = (GradAccumulator(params, accumulation_steps)
                   if accumulation_steps > 1 else None)
    train_step.accumulator = accumulator
    return train_step
