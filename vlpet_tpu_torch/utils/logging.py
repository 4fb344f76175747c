"""Metrics logging + running meters.

Reference: wandb was load-bearing on rank 0 (reference: src/multitask.py:
173-184, 344-468) and LossMeter kept a running mean (src/utils.py:40-60).
Here: console + JSONL always; wandb only if importable and enabled.

The port's own copy of vlpet_tpu/utils/logging.py.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Optional


class LossMeter:
    """Running mean over a deque (reference: src/utils.py:40-60)."""

    def __init__(self, maxlen: int = 100):
        self.vals = collections.deque(maxlen=maxlen)

    def update(self, v: float):
        self.vals.append(float(v))

    @property
    def val(self) -> float:
        return sum(self.vals) / len(self.vals) if self.vals else 0.0

    def __len__(self):
        return len(self.vals)

    def __repr__(self):
        return f"{self.val:.4f}"


class MetricsLogger:
    def __init__(self, output_dir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "vlpet_tpu", run_name: str = "", config=None,
                 verbose: bool = True):
        self.verbose = verbose
        self.jsonl = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name or None,
                           config=config)
                self.wandb = wandb
            except ImportError:
                if verbose:
                    print("wandb not available; logging to console/jsonl only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}),
               **{k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                      else v) for k, v in metrics.items()}}
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)
        if self.verbose:
            parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in rec.items() if k != "ts")
            print(parts)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        if self.wandb:
            self.wandb.finish()
