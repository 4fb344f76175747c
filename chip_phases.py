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
per-call, back-to-back and device times), 3n A1, A6 and the long
backward at the prompt baseline's sites, 3o every kernel at the video
scripts' sites (S 664 / 704 / 141 / 181, 20 targets, B 50), 3p every
kernel at the raw-image path's sites (RN101 grid: S 69 / 118 / 216, B
500). A phase that ROOT's
``chip_smoke`` lacks (3h-3m in a tree older than it) is taken from this tree's ``chip_smoke`` and run on ROOT's
port, so an earlier tree's kernels are timed at the same cases. 5, 5b, 5c and 5e
time the bf16 beam-5 evals (image-text, video, T5 and T5 gated, T5
video; 5b and 5e first hold fp32 tokens kernels vs plain), 5d the
use_fused_beam evals (BART and T5; it needs 5 and 5c before it); 7, 7b,
7c, 7d and 7e time the bf16 train steps (image-text, video, T5,
use_fused_ce, T5 video and t5_full_ft; 7d needs 7 and 7c before it, 7e
needs 7b and 7c), 7f the PET baselines' (their scripts' configs on
BART-base: train steps, and the LoRA, prompt and hyperformer evals); 6g
holds the PET baselines' fp32 train steps and tokens kernels vs plain, 6h
the video scripts' (VL-PET-large tvqa and tvc, single_prompt tvqa); 7g
times the ten video scripts' bf16 train steps (B 50, tvqa) and
VL-PET-large's tvc step and greedy / beam-5 evals; 6i holds the raw path's
fp32 train steps and tokens kernels vs plain and the checkpoint importers
at full shape; 7h times the CLIP trunks, the raw train steps and evals
and the feature extractor, 7i (not in the smoke's run) the raw
--use_vis_adapter step under the Trainer's cuDNN settings and under
cuDNN's autotuner; 6j holds the VL-PET ablation flags' fp32 train
steps (and, for the families that reach the decode, the tokens) kernels
vs plain, 7j times their bf16 train steps and four beam-5 evals; 6k holds
A1 and A6 at the prefixes' sites and the remaining PET flags' (prefixes,
decoder prompts, the LM-head adapter, the T5 baselines) fp32 train steps
and tokens kernels vs plain, 7k times their bf16 train steps and beam-5
evals; 6l holds BART's attention and activation dropout at their kernel
sites, the classifier's, the dropouts', remat's and sparse_sample's fp32
train steps and the BART heads kernels vs plain, 7l times the
classifier's, the dropouts' and remat's bf16 train steps; 8 runs
the image-text
CLI (VL-PET-small, bf16, B 500, train, eval each epoch, resume), 8b the
prompt script's (two epochs) and 8c the video CLI (VL-PET-large.sh, two
epochs, resume) and single_task tvqa (single_prompt.sh), 8d the
extractor + CLI on features with --backbone_ckpt (resume) and the raw
CLI with --clip_ckpt, 8e the CLI with --classifier (VL-PET-large.sh,
one epoch, resume), in child processes of ROOT's chip_smoke; 9 the
data-parallel ranks on the one card (world 1 over NCCL, world 2 over
gloo: train steps against one process, the merged beam-5 tokens); 10 the
tensor-parallel ranks ((1, 2) and (1, 4) meshes over gloo: F1-F4 at a
column base against their twins, train steps -- the VL-PET recipes,
LoRA, full fine-tuning and ten PET / model-level families -- tokens, a
BitFit checkpoint resumed in one process, and launches against one
process); 9+10 both, their ranks spawned at once, as the
smoke runs them.
``--profile`` adds each bench run's device time and launches by kernel
family, read for every tree by this tree's
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

# phase -> (chip_smoke function, what it takes: the report "rep", the
# card's name "card", both ("rep card"), or nothing)
PHASES = {"3": ("phase_kernels", "rep"),
          "3b": ("phase_train_kernels", "rep"),
          "3d": ("phase_t5_kernels", "rep"),
          "3e": ("phase_t5_train_kernels", "rep"),
          "3f": ("phase_fused_kernels", "rep"),
          "3g": ("phase_bias_grad_kernels", "rep"),
          "3h": ("phase_ffn_ce_sites", "rep"),
          "3i": ("phase_gated_ffn_sites", "rep"),
          "3j": ("phase_ffn_bwd_sites", "rep"),
          "3k": ("phase_beam_sites", "rep"),
          "3l": ("phase_topk_sites", "rep"),
          "3m": ("phase_ln_sites", "rep"),
          "3n": ("phase_prompt_sites", "rep"),
          "3o": ("phase_video_script_sites", "rep"),
          "3p": ("phase_raw_sites", "rep"),
          "5": ("phase_decode_bench", "card"),
          "5b": ("phase_video_eval", "card"),
          "5c": ("phase_t5_eval", "card"),
          "5d": ("phase_fused_beam_bench", "card"),
          "5e": ("phase_t5_video_eval", "card"),
          "6g": ("phase_pet_parity", None),
          "6h": ("phase_video_script_parity", None),
          "6i": ("phase_raw_parity", None),
          "6j": ("phase_ablation_parity", None),
          "6k": ("phase_pet_flag_parity", "rep"),
          "6l": ("phase_tail_parity", "rep"),
          "7": ("phase_train_bench", "card"),
          "7b": ("phase_video_train_bench", "card"),
          "7c": ("phase_t5_train_bench", "card"),
          "7d": ("phase_fused_ce_bench", "card"),
          "7e": ("phase_bias_train_bench", "card"),
          "7f": ("phase_pet_bench", "card"),
          "7g": ("phase_video_script_bench", "card"),
          "7h": ("phase_raw_bench", "card"),
          "7i": ("phase_raw_cudnn", "card"),
          "7j": ("phase_ablation_bench", "card"),
          "7k": ("phase_pet_flag_bench", "card"),
          "7l": ("phase_tail_bench", "card"),
          "8": ("phase_cli_rehearsal", "card"),
          "8b": ("phase_cli_prompt", "card"),
          "8c": ("phase_cli_video", "card"),
          "8d": ("phase_cli_raw", "card"),
          "8e": ("phase_cli_classifier", "card"),
          "9": ("phase_data_parallel", "card"),
          "10": ("phase_tensor_parallel", "rep card"),
          "9+10": ("phase_parallel", "rep card")}
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
        name, takes = PHASES[p]
        smoke = chip_smoke
        if not hasattr(smoke, name):
            smoke = this_trees_smoke()
            print(f"phase {p} of {root.name} (this tree's phase on "
                  f"{root.name}'s port)", flush=True)
        else:
            print(f"phase {p} of {root.name}", flush=True)
        rep = reports.setdefault(smoke.__name__, smoke.Report())
        torch.cuda.reset_peak_memory_stats()
        getattr(smoke, name)(*{"card": (card,), "rep": (rep,),
                               "rep card": (rep, card)}.get(takes, ()))
        print(f"phase {p} of {root.name}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    print(f"tree {root} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
