"""Optimizer and schedule, ported from vlpet_tpu/train/optim.py.

Reference: src/trainer_base.py:627-732 -- AdamW with no-decay groups
(params whose name contains 'bias', and LayerNorm weights), linear warmup
over warmup_ratio * total_steps then linear decay to 0, and
clip_grad_norm 5 first (src/multitask.py:279-300).

``HFAdamW`` is transformers' AdamW rule exactly, as the JAX package's
``hf_adamw`` is, and NOT ``torch.optim.AdamW``: eps is added to sqrt(nu)
before the bias correction, which rides in the step size, and the decoupled
weight decay is applied after the Adam update, to the updated parameter,
scaled by the scheduled lr. Moments (and an fp32 master copy of a
parameter kept in a lower precision) exist only for the trainable
parameters it is given.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

import torch


def decay_mask(named_params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True = apply weight decay. No decay for biases and LayerNorm weights
    (reference no_decay = ['bias', 'LayerNorm.weight']; the LayerNorm weight
    is ``scale`` here, as in flax)."""

    def decide(name: str) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        if "bias" in leaf:
            return False
        if leaf == "scale" and re.search(r"layer_norm|layernorm", name):
            return False
        return True

    return {name: decide(name) for name in named_params}


def linear_warmup_schedule(lr: float, total_steps: int,
                           warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """Step -> lr: linear 0 -> lr over the warmup steps, then lr -> 0 over
    the rest (optax.join_schedules of two linear_schedules)."""
    warmup = max(1, int(total_steps * warmup_ratio))
    decay = max(1, total_steps - warmup)

    def schedule(step: int) -> float:
        if step < warmup:
            return (0.0 - lr) * (1.0 - step / warmup) + lr
        return lr * (1.0 - min(step - warmup, decay) / decay)

    return schedule


class HFAdamW:
    """transformers.optimization.AdamW over named parameters, with the
    global-norm clip of ``build_optimizer`` in front (``clip`` <= 0: none).
    ``step(grads)`` takes the gradients in the parameters' order, updates
    the parameters in place and returns the global norm of the gradients
    before the clip, as an fp32 scalar tensor (no host sync)."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, clip: float = 0.0):
        self.names: List[str] = list(named_params)
        self.params = list(named_params.values())
        self.decay = decay_mask(named_params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.count = 0
        # fp32 master copies of lower-precision parameters: the update is
        # computed and kept in fp32, the parameter gets its rounding
        self.master = [p.detach().float() if p.dtype != torch.float32 else p
                       for p in self.params]
        self.mu = [torch.zeros_like(m) for m in self.master]
        self.nu = [torch.zeros_like(m) for m in self.master]

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        grads = [g.float() for g in grads]
        norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
        if self.clip > 0:
            # optax.clip_by_global_norm: g / norm * clip where norm >= clip
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        t = float(self.count)
        b1, b2 = self.b1, self.b2
        step_size = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
        for name, p, m32, mu, nu, g in zip(self.names, self.params,
                                           self.master, self.mu, self.nu,
                                           grads):
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_((1.0 - b2) * g * g)
            upd = -step_size * mu / (nu.sqrt() + self.eps)
            if self.weight_decay > 0.0 and self.decay[name]:
                # decay the post-adam-update parameter (reference order)
                upd = upd - lr * self.weight_decay * (m32 + upd)
            m32.add_(upd)
            if m32 is not p:
                p.copy_(m32)
        return norm


def hf_adamw(named_params: Dict[str, torch.nn.Parameter],
             schedule: Callable[[int], float], b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-6,
             weight_decay: float = 0.01) -> HFAdamW:
    """HF AdamW without a clip (vlpet_tpu/train/optim.py:54)."""
    return HFAdamW(named_params, schedule, b1, b2, eps, weight_decay)


def build_optimizer(named_params: Dict[str, torch.nn.Parameter], *,
                    lr: float, total_steps: int, warmup_ratio: float = 0.1,
                    weight_decay: float = 0.01, adam_beta1: float = 0.9,
                    adam_beta2: float = 0.999, adam_eps: float = 1e-6,
                    clip_grad_norm: float = 5.0, schedule=None) -> HFAdamW:
    """clip_by_global_norm(clip_grad_norm) then HF AdamW with the no-decay
    groups and the linear warmup schedule (vlpet_tpu/train/optim.py:102)."""
    sched = schedule or linear_warmup_schedule(lr, total_steps, warmup_ratio)
    return HFAdamW(named_params, sched, adam_beta1, adam_beta2, adam_eps,
                   weight_decay, clip_grad_norm or 0.0)
