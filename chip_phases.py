"""Run the training phases of a checkout's ``chip_smoke.py`` on one CUDA
card, for comparing two trees on one card in one run.

    python3 chip_phases.py ROOT [PHASE ...]

ROOT is the root of a checkout (this tree: ``.``; an earlier commit: a
``git archive`` of it unpacked into a git-ignored directory). The script
imports ROOT's ``chip_smoke`` and ``vlpet_tpu_torch``, builds ROOT's
kernels, and runs the named phases in the order given (default: all, in
the order below). 3b, 3e, 3f and 3g hold the training path's, the T5
training path's, the opt-in paths' and the trainable-bias kernels against
their plain twins and print one line per case (the kernel's, the plain
twin's and the library call's times and the bound); 7, 7b, 7c, 7d and 7e
time the bf16 train steps (image-text, video, T5, use_fused_ce, T5 video
and t5_full_ft; 7d needs 7 and 7c before it, 7e needs 7b and 7c). Run
parent, change, change, parent to see the spread beside the change.
Exits nonzero without a card. Imports torch, the standard library and
ROOT's port only.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

# phase -> (chip_smoke function, whether it takes the card's name)
PHASES = {"3b": ("phase_train_kernels", False),
          "3e": ("phase_t5_train_kernels", False),
          "3f": ("phase_fused_kernels", False),
          "3g": ("phase_bias_grad_kernels", False),
          "7": ("phase_train_bench", True),
          "7b": ("phase_video_train_bench", True),
          "7c": ("phase_t5_train_bench", True),
          "7d": ("phase_fused_ce_bench", True),
          "7e": ("phase_bias_train_bench", True)}


def main(argv) -> int:
    if not argv or any(p not in PHASES for p in argv[1:]):
        raise SystemExit(f"usage: chip_phases.py ROOT [{' '.join(PHASES)}]")
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: torch.cuda.is_available() is False -- "
                         "this script needs a CUDA card")
    import chip_smoke

    from vlpet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(f"tree {root}: card {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"  built in {time.perf_counter() - t0:.2f} s", flush=True)
    rep = chip_smoke.Report()
    for p in argv[1:] or list(PHASES):
        print(f"phase {p} of {root.name}", flush=True)
        name, takes_card = PHASES[p]
        getattr(chip_smoke, name)(card if takes_card else rep)
    print(f"tree {root} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
