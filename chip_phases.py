"""Run chosen phases of a checkout's ``chip_smoke.py`` on one CUDA card,
for comparing two trees on one card in one run.

    python3 chip_phases.py ROOT [PHASE ...] [--profile]

ROOT is the root of a checkout (this tree: ``.``; an earlier commit: a
``git archive`` of it unpacked into a git-ignored directory). The script
imports ROOT's ``chip_smoke`` and ``vlpet_tpu_torch``, builds ROOT's
kernels, and runs the named phases in the order given (default: all, in
the order below). 3, 3b, 3d, 3e, 3f and 3g hold the decode path's, the
training path's, the T5 eval path's, the T5 training path's, the opt-in
paths' and the trainable-bias kernels against their plain twins and
print one line per case (the kernel's, the plain twin's and the library
call's times and the bound); 3h times F1 and C1 at their paths' rows, 3i
F3 and F4 at theirs, 3j F2 at its own and U1's K+V write, 3k D1 and D2
at theirs, 3l T1 and T2 at theirs, 3m L1 and L2 at theirs (each case's
per-call, back-to-back and device times). A phase that ROOT's
``chip_smoke`` lacks (3h-3m in a tree older than it) is taken from this tree's ``chip_smoke`` and run on ROOT's
port, so an earlier tree's kernels are timed at the same cases. 5, 5b, 5c and 5e
time the bf16 beam-5 evals (image-text, video, T5 and T5 gated, T5
video; 5b and 5e first hold fp32 tokens kernels vs plain), 5d the
use_fused_beam evals (BART and T5; it needs 5 and 5c before it); 7, 7b,
7c, 7d and 7e time the bf16 train steps (image-text, video, T5,
use_fused_ce, T5 video and t5_full_ft; 7d needs 7 and 7c before it, 7e
needs 7b and 7c). ``--profile`` adds each bench run's device time and
launches by kernel family, read for every tree by this tree's
chip_smoke.profile_run. After each phase the card's peak allocated
memory over the phase is printed (for trees whose phases do not print
their own). Run parent, change, change, parent to see the spread beside
the change. Exits nonzero without a card. Imports
torch, the standard library and ROOT's port only.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

# phase -> (chip_smoke function, whether it takes the card's name)
PHASES = {"3": ("phase_kernels", False),
          "3b": ("phase_train_kernels", False),
          "3d": ("phase_t5_kernels", False),
          "3e": ("phase_t5_train_kernels", False),
          "3f": ("phase_fused_kernels", False),
          "3g": ("phase_bias_grad_kernels", False),
          "3h": ("phase_ffn_ce_sites", False),
          "3i": ("phase_gated_ffn_sites", False),
          "3j": ("phase_ffn_bwd_sites", False),
          "3k": ("phase_beam_sites", False),
          "3l": ("phase_topk_sites", False),
          "3m": ("phase_ln_sites", False),
          "5": ("phase_decode_bench", True),
          "5b": ("phase_video_eval", True),
          "5c": ("phase_t5_eval", True),
          "5d": ("phase_fused_beam_bench", True),
          "5e": ("phase_t5_video_eval", True),
          "7": ("phase_train_bench", True),
          "7b": ("phase_video_train_bench", True),
          "7c": ("phase_t5_train_bench", True),
          "7d": ("phase_fused_ce_bench", True),
          "7e": ("phase_bias_train_bench", True)}
HERE = Path(__file__).resolve().parent


def this_trees_smoke():
    """This tree's chip_smoke, loaded under another name: its phases then
    call whichever vlpet_tpu_torch is already imported (ROOT's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    phases = [a for a in argv[1:] if a != "--profile"]
    if not argv or any(p not in PHASES for p in phases):
        raise SystemExit(f"usage: chip_phases.py ROOT [{' '.join(PHASES)}] "
                         f"[--profile]")
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: torch.cuda.is_available() is False -- "
                         "this script needs a CUDA card")
    import chip_smoke

    from vlpet_tpu_torch.ops import _build

    if "--profile" in argv:  # both trees' runs read by the same profiler
        chip_smoke.profile_run = this_trees_smoke().profile_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(f"tree {root}: card {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"  built in {time.perf_counter() - t0:.2f} s", flush=True)
    reports = {}
    for p in phases or list(PHASES):
        name, takes_card = PHASES[p]
        smoke = chip_smoke
        if not hasattr(smoke, name):
            smoke = this_trees_smoke()
            print(f"phase {p} of {root.name} (this tree's phase on "
                  f"{root.name}'s port)", flush=True)
        else:
            print(f"phase {p} of {root.name}", flush=True)
        rep = reports.setdefault(smoke.__name__, smoke.Report())
        torch.cuda.reset_peak_memory_stats()
        getattr(smoke, name)(card if takes_card else rep)
        print(f"phase {p} of {root.name}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    print(f"tree {root} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
