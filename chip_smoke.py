"""Smoke run of the PyTorch port (vlpet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # --profile: device-time breakdowns

Phases (each prints its own lines; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the CUDA kernels from vlpet_tpu_torch/csrc with nvcc (sm_90a);
  3. the decode path's kernels vs their plain PyTorch twins at its shapes,
     bf16 and fp32, with median times from CUDA events;
  3b. the training path's kernels vs their plain twins (the backward ones
     vs autograd of the plain forward) at its shapes, bf16 and fp32:
     attention forward + backward at the encoder (B 500, L = S = 56,
     padding mask), decoder-self (L = S = 10, causal) and cross (L 10,
     S 56) sites, FFN forward + backward at N 28000 and 5000, dropout +
     add + LayerNorm forward + backward at N 28000 and 5000, rate 0.1 and
     0.0 (the fp32 dropout mask held bit for bit against keep_mask);
  3c. the video path's long attention, bf16 and fp32, ragged padding
     masks: A1 forward (output and row logsumexp) and the long backward vs
     the plain version and autograd of it at the encoder (B 50, L = S =
     604), cross (B 50, L 10, S 604) and S 1024 (B 16) sites, one causal
     L = S = 604 case and L = S = 65 (a 1-row last tile), the bf16 long
     backward run twice and bitwise equal; then the long backward and A6
     timed side by side at
     the image-text encoder shape (B 500, L = S = 56), a record only; then
     every other kernel of the video paths at the shapes they give it, bf16
     (beam cross-attention L 5 and greedy L 1 over S 604, decoder
     self-attention and A6,
     FFN and LayerNorm kernels at 50 x 604, 50 x 10 and 250 rows, beam
     self-attention over 20 slots, top-k over 250 rows);
  4. fp32 decode parity: BART-base + VL-PET-large at full width, seeded
     random weights, batch 8, beam 5 (then greedy) to length 40, through
     the kernels and through the plain path: the token sequences must be
     identical. (a) all 6+6 layers at the JAX init scale; (b) 1+1 layers
     with weights at a scale that decodes varied tokens;
  5. the decode bench shape in bf16: batch 500 (20 text tokens + 36 boxes
     of 2048-d features), beam 5 to length 40; examples/s and launches per
     kernel (the decode path's main-path run);
  5b. video eval (BART-base + VL-PET-large, 540 text tokens + 64 frames of
     512-d features, S 604): fp32 beam-5 and greedy tokens identical
     kernels vs plain at B 4 to length 20, as phase 4 (a) and (b), then
     the bf16 beam 5 to length 20 at B 50: examples/s and launches (the
     video eval path's main-path run);
  6. fp32 train-step parity: full width, batch 8, task vqa, dropout 0.1,
     K = 3 steps through the kernels, then 3 through the plain twins from
     the same weights and generator seed: per-step loss and gradient norm
     within 1e-5 relative, trainable parameters within rtol 1e-3, atol
     1e-5 * max|p| (tests/test_training_parity.py's lockstep tolerance);
  6b. fp32 video train-step parity as phase 6: full width, batch 2, S 604,
     task tvqa, dropout 0.1, 3 steps kernels vs plain;
  7. the train bench shape in bf16: batch 500, 20 text + 36 boxes, 10
     targets, vqa, dropout 0.1, lr 1e-3, clip 5: 3 warm-up steps, then 10
     timed steps with one sync; examples/s, launches per kernel per step
     (the training path's main-path run), peak memory;
  7b. the video train step in bf16: batch 50, 540 text + 64 frames, 10
     targets, tvqa, dropout 0.1, lr 7e-4, clip 5, as phase 7 (the video
     training path's main-path run); then one bf16 step through the
     kernels and one through the plain twins from the same state (weights
     and dropout seeds): losses within 1e-2 relative, the gradient norms'
     ratio printed;
  3d. (run after 3c) the T5 eval path's kernels vs plain, bf16 and fp32:
     A1 with the per-head relative bias at B 300, L = S = 56 (ragged
     padding mask; SDPA with attn_mask = bias + mask as the yardstick), its
     row logsumexp and the causal form, the beam cross-attention L 5 over
     S 56; D1 with the bias row at B 300, K 5, 40 slots; F1 relu (zero
     biases) and F3, the gated-gelu FFN (D 768, F 2048), at 16800 (300 x
     56) and 1500 (300 x 5) rows;
  4c. (run after 5b) fp32 T5 decode parity, T5-base + VL-PET-large
     (``t5_cfg``: relu FFN, tied head) and its gated-gelu variant on the
     t5-v1.1-base dimensions (``t5_cfg(gated=True)``: F3, untied head):
     beam 5 and greedy to length 40 at batch 8, kernels vs plain, tokens
     identical; (a) 12+12 layers at the JAX package's T5 init (ups zero as
     the recipe sets them), (b) 1+1 layers at std 0.2;
  5c. the T5 eval shape in bf16 for both: batch 300 (the recipe's
     valid_batch_size; 20 text tokens + 36 boxes of 2048-d, S 56), beam 5
     to length 40; examples/s and launches per kernel (the t5_eval and
     t5_gated_eval main-path runs);
  3e. (run after 3d) the T5 training path's kernels vs their plain twins
     (the backward ones vs autograd of the plain forward), bf16 and fp32,
     at rate 0.1 and 0.0 with a fixed seed: A1 and A6 with the relative
     bias at the encoder (B 300, L = S = 56, ragged padding mask), with
     bias and the causal triangle at the decoder self-attention (L = S =
     10) and at the cross-attention (L 10 over S 56); F1/F2 relu (F 3072,
     zero biases) and F3/F4 gated-gelu (F 2048) at 16800 (300 x 56) and
     3000 (300 x 10) rows; then, fp32, every kernel's dropout mask bit for
     bit against ops/hashdrop.py (one-hot values or picking weights make
     each dropped element an exact zero of an output);
  6c. fp32 T5 train-step parity for both T5 configurations: full width,
     12+12 layers at the T5 init (the zero-init ups at normal(0, 0.02)),
     batch 8, dropout 0.1, lr 3e-4, 3 steps each of vqa and caption, each
     step taken through the plain twins and through the kernels from the
     same state: loss and gradient norm within 1e-5 relative, every
     tensor's update within 1e-3 of the plain one in the L2 norm
     (``train_parity_per_step``);
  7c. the T5 train step in bf16 for both: batch 300, 20 text tokens + 36
     boxes (S 56), 10 targets, vqa, dropout 0.1, lr 3e-4, clip 5, as phase
     7 (the t5_train and t5_gated_train main-path runs);
  3f. (run after 3e) the opt-in paths' kernels and the slot write vs their
     plain twins, bf16 and fp32: C1/C2, the streamed linear + CE, at the
     BART train shape (N 5000, D 768, V 50265, random bias) and the T5 tied
     one (N 3000, V 32100, x at the d^-0.5 rescale, zero bias), 10% of the
     labels -100 (loss, lse; dx vs autograd of the plain forward; library
     F.linear + F.cross_entropy, and the logits GEMM alone); D2, the fused
     beam attend + slot write, at B 500, K 5, L 40, pos 0, 20, 39 and at
     B 300 with the bias row (the output, the written slot, every other
     slot bit for bit); U1's K+V write (one launch for a layer's two
     caches) at both beam caches, exact;
  4d. (run after 5c) fp32 beam-5 and greedy tokens with use_fused_beam,
     BART (6+6) and T5 relu/tied (12+12) at batch 8 to length 40, the init
     scale: kernels vs plain identical, D2 on every beam step and D1 never,
     and the fused path's tokens identical to the unfused path's;
  5d. the bf16 beam-5 evals of phases 5 and 5c with use_fused_beam (BART B
     500, T5 relu/tied B 300, length 40): examples/s beside the unfused
     runs (the decode_fused_beam and t5_eval_fused_beam main-path runs);
  6d. (run after 6c) fp32 train-step parity with use_fused_ce: BART B 8,
     vqa as phase 6 and caption as phase 6c; T5 relu/tied B 8, vqa and
     caption as phase 6c; then one step of the fused route vs the dense
     route from the same state, loss and gradient norm within 1e-5
     relative;
  7d. the bf16 train steps of phases 7 and 7c with use_fused_ce: examples/s,
     peak memory and launches beside the dense route (the train_fused_ce
     and t5_train_fused_ce main-path runs);
  3g. (run after 3f) the backwards' T5 video and trainable-bias modes vs
     autograd of the plain forward, bf16 and fp32, rate 0.1: the long
     backward with the relative bias and dropout at the T5 video encoder
     (B 50, L = S = 604), cross-attention (L 10 over S 604), S 1024 (B 16)
     and causal L = S = 604; dbias from A6 at the T5 encoder (B 300,
     L = S = 56) and decoder self-attention (B 300, L = S = 10, causal)
     and from the long backward at the video encoder -- dq, dk, dv and
     dbias checked, every dbias case run twice and bitwise equal; the
     library yardstick SDPA's autograd (bias gradient included) at rate 0;
     at the long sites also A1's output and row logsumexp with the same
     terms, and every long backward run twice, bitwise equal; then A1's and
     the long backward's dropout masks bit for bit at the T5 video encoder,
     bf16 and fp32 (every query row, the ragged 64-row and 64-key tiles
     included);
  3h. (run after 3g) F1 and C1 in bf16 at the rows their paths give them:
     F1 at N 1 and 2501 (ragged), 250 (video beam), 1500 (T5 beam, relu),
     2500 (BART beam), 16800 (T5 train, relu, rate 0.1) and 28000 (BART
     encoder), each against its plain twin and against fp32 arithmetic on
     its inputs, twice bitwise equal, with the split count it took; the
     cost of re-laying W1 and W2 out; F1's dropout mask bit for bit in
     bf16 at a split (N 1500) and an unsplit (N 16800) row count; C1 at
     the BART and T5 sites, T5 at N 2999 and D 512 and 1024, loss and lse
     against the plain twin, twice bitwise equal (chip_phases.py runs
     this phase on an earlier tree's kernels too);
  3i. (run after 3h) F3 and F4 in bf16 at the rows their paths give them
     (D 768, F 2048, gelu_new): F3 at N 1 and 1501 (ragged), 1500 (T5
     beam), 3000 (rate 0.1) and 16800 (rate 0 and 0.1), F4 at N 2999
     (ragged), 3000 and 16800 at rate 0.1 and 16800 at rate 0, each
     against its plain twin and against fp32 arithmetic on its inputs
     (F4's with dh0 and dh1 rounded where the kernel rounds them), twice
     bitwise equal, with its split count and bound; the cost of the two
     weight re-lays; both dropout masks bit for bit in bf16 at a split (N
     1500) and an unsplit (N 16800) row count (chip_phases.py runs this
     phase on an earlier tree's kernels too);
  3j. (run after 3i) F2 in bf16 at the rows its paths give it (D 768, F
     3072): N 1 and 2501 (ragged), 500 (video decoder), 3000 (T5 decoder,
     relu, rate 0.1), 5000 (BART decoder), 16800 (T5 encoder, relu, rate 0
     and 0.1), 28000 (BART encoder) and 30200 (video encoder), each against
     its plain twin and against fp32 arithmetic on its inputs (dx with ds
     rounded where the kernel rounds it, db1, db2), twice bitwise equal,
     with its split count and bound; F2's bf16 dropout mask bit for bit
     at a split (N 3000) and an unsplit (N 16800) row count; U1's K+V
     write at the BART and T5 beam caches, bf16 and fp32, exact, against
     two cache[pos].copy_ calls (chip_phases.py runs this phase on an
     earlier tree's kernels too);
  3k. (run after 3j) D1 and D2 in bf16 at the rows their paths give them
     (K 5, H 12, Dh 64): BART B 500, L 40 at pos 0, 20 and 39; T5 B 300
     with the bias row in T5's strided layout (D2: and its column pos as
     the own bias) at pos 39; the video eval B 50, L 20 at pos 19; L 160
     at pos 159 (B 50, more slots than the kernel stages at once); each
     under the uniform ancestry and a beam-tree one (every step each beam
     picks a random parent). Each against its plain twin, against fp32
     arithmetic on its own inputs (p rounded to bf16 where the kernel
     rounds it), twice bitwise equal, D2's slot pos written exactly and
     every other slot unchanged; each prints the per-call event time, the
     time per launch of 20 back to back, the device time per launch
     (torch.profiler), the plain twin's, SDPA's and the bound with the
     distinct rows its ancestry reads (chip_phases.py runs this phase on
     an earlier tree's kernels too);
  3l. (run after 3k) T1 and T2, the exact top-k + logsumexp, on fp32
     logits at the sites their paths give them: beam 5 at BART R 2500 and
     the video eval's R 250 (V 50265), T5 R 1500 at V 32100 (relu, tied)
     and 32128 (gated, untied), k 10; k 1 at R 2500 (T2's row) and the
     greedy rows, BART R 500 and T5 R 300; k 16 at R 1 and 2501; short
     vocabularies (R 2501 V 1001 k 10, R 7 V 37 k 16). Each on randn logits, ties (2000 levels) and rows half -inf
     with row 0 all -inf: values and indices exactly the stable sort's,
     lse within TOPK_LSE_TOL, twice bitwise equal; per-call,
     back-to-back and device times, the plain twin's, the two calls
     torch.topk + torch.logsumexp and the bound (chip_phases.py runs this
     phase on an earlier tree's kernel too);
  3m. (run after 3l) L1 and L2, the fused dropout + add + LayerNorm
     forward and backward, at the sites their paths give them (LN_SITES):
     the image-text step's N 28000 and 5000 and the video step's N 30200
     and 500, D 768, bf16, rate 0.1 and 0; ragged N 28001 and 1; D 1024 at
     N 5000; D 100 at N 61 (bf16 rows of 200 bytes: the second route,
     "scalar") and an h one element off 16 bytes at N 28000 ("scalar"
     again, several rows a warp); fp32 at N 28000. Each against its plain
     twin (L2 against autograd of it), bf16 twice bitwise equal (dgamma
     and dbeta too), the bf16 dropout mask of L2 by _expect_zeros (dh
     zero where keep_mask drops, nonzero where kept and dres is nonzero);
     the route taken, the per-call, back-to-back and device times (by
     kernel), the plain twin's, the two calls F.layer_norm(res + h) (L2:
     its autograd) at rate 0 and the bound (chip_phases.py runs this
     phase on an earlier tree's kernels too);
  5e. (run after 5d) the T5 video eval (config.t5_video_cfg): fp32 beam-5
     and greedy tokens kernels vs plain at B 4 to length 20, as 5b, then
     bf16 beam 5 to length 20 at B 50 (the t5_video_eval main-path run);
  6e. (run after 6d) fp32 per-step train parity as 6c, dropout 0.1, 3
     steps, with a second plain reference (the plain twins with T5's FFN
     input product in fp64; the kernels' step must agree with one of the
     two: ``train_parity_per_step``): T5 video B 2 S 604; T5 with
     unfreeze_language_model B 8, vqa and caption; T5 BitFit
     (unfreeze_bias) B 8; T5 video BitFit B 2 (the t5_bitfit and
     t5_video_bitfit main-path runs); relative_attention_bias's own
     updates printed by name;
  7e. (run after 7d) the bf16 T5 video train step (B 50, S 604, vqa) and
     t5_full_ft (unfreeze_language_model, B 300) as phase 7c: examples/s,
     ms/step, peak memory and launches beside phases 7b and 7c (the
     t5_video_train and t5_full_ft main-path runs); the T5 video step then
     one bf16 step kernels vs plain, as 7b.
Routes: each kernel-vs-plain line of A1, A6, the long backward, L1 and
L2 prints the route it launched (ops/attention.py forward_route for A1
and the long backward, a6_route for A6: "tc", the tensor-core kernels,
for bf16 at Dh 64 -- and, for A6, L, S <= 64; "fma" otherwise;
ops/fused_ln.py ln_plan for L1 and L2: "vec", 16-byte rows, or
"scalar"), every bf16 bench run (5-5e, 7-7e) must launch A1, A6 and the
long backward on "tc" only and L1 and L2 on "vec" only, and the kernels'
JSON record gives their main-path launches per route. Every bf16 A6 and C2
case runs twice and must be bitwise equal; 3e also holds A6's dropout mask
bit for bit in bf16; 3f adds bf16 C2 at a ragged N (2999) and at D 512
and 1024.
The last lines are the smoke's wall time, the card, the kernels' JSON
record and the result line {"ok": true, "device": {...}}.

Tolerances of the kernel-vs-plain checks: |kernel - plain| <= tol * (1 +
|plain|), 1e-5 fp32 (the kernels only reorder fp32 sums) and 2e-2 bf16
(the kernels keep fp32 where the plain path rounds to bf16 between ops:
probabilities, hidden activations; a few bf16 ulps of O(1) values). The
backward checks hold |kernel - plain| <= tol * (1 + max|plain|) instead:
their outputs include column sums over all N rows (db1, db2, dgamma,
dbeta), whose rounding is set by the magnitudes summed, not by the
(possibly cancelled) sum, and in bf16 the plain path rounds intermediates
far larger than an output element (attention's dp = do . v^T, the FFN's
dh = dy . W2), so the error follows the tensor's scale, not each
element.

Imports: torch, the standard library and the port (vlpet_tpu_torch) only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from vlpet_tpu_torch.config import (FLAGSHIP_TASKS, VIDEO_TASKS, flagship_cfg,
                                    t5_cfg, t5_video_cfg, video_cfg)
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import (_build, attention, cache_update, decode, ffn,
                                 fused_ce, fused_ln, plain_twins, topk)
from vlpet_tpu_torch.ops.hashdrop import keep_mask
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOPK_LSE_TOL = 1e-5  # top-k values and indices must match exactly
# phase 3d: a bf16 FFN kernel against fp32 arithmetic on its own inputs,
# max |err| / max |ref|: the output's bf16 rounding alone is up to 2^-8 of
# a value (half an ulp of 7 mantissa bits), plus a margin for the order of
# the fp32 sums
BF16_FFN_RTOL = 5e-3
# phase 3k: an output element of a bf16 beam attend against fp32 arithmetic
# on its own inputs (p rounded where the kernel rounds it) within 2^-7 (one
# bf16 ulp, relative) of |ref| + pmax vmax: the output's own rounding (a
# flip where the two fp32 sums straddle a boundary), and one probability
# of its row rounded the other way (two fp32 quotients on either side of a
# boundary: at most an ulp of the row's largest p, times the largest |v|)
BEAM_FP32_RTOL = 2.0 ** -7
# phase 4: at the last beam step at least this share of the cache slots is
# read from another beam's row (hypotheses move between parents), and in
# phase 4b every row holds at least this many distinct token ids
MIN_ROUTED_SHARE = 0.5
MIN_DISTINCT_PER_ROW = 4
# phase 6: per-step loss and gradient norm, relative; trainable parameters
TRAIN_METRIC_RTOL = 1e-5
# phases 7b and 7e: one bf16 step through the kernels against one through
# the plain twins from the same state, loss relative (the two round the
# probabilities and hidden activations to bf16 at other places)
BF16_STEP_RTOL = 1e-2
PARAM_RTOL, PARAM_ATOL_SCALE = 1e-3, 1e-5

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): bf16
# tensor cores, fp32 outside them (the fp32 kernels must not round to TF32)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# name -> (source, the TPU kernel(s) it replaces, main paths that launch
# it). A1 also serves the per-head and query-strip forwards
# (vlpet_tpu/ops/attention.py:543, :825) on the video paths. The entries
# of MODES are a kernel's modes (T5's dropout, the bias in the backward,
# relu in F2, dbias), counted by the wrapper, or the wrapper's mode counter,
# that they name, and timed in phases 3e and 3g.
DECODE, TRAIN = ("decode", "video_eval"), ("train", "video_train")
T5 = ("t5_eval", "t5_gated_eval")
T5_TRAIN = ("t5_train", "t5_gated_train")
FUSED_CE = ("train_fused_ce", "t5_train_fused_ce")
FUSED_BEAM = ("decode_fused_beam", "t5_eval_fused_beam")
# the T5 video and trainable-bias paths: the bf16 runs of phases 5e and 7e,
# and the fp32 BitFit runs of phase 6e (the only runs of the long
# backward's dbias: no run script trains T5's bias at the video shape)
T5V_EVAL, T5V_TRAIN, FULL_FT = "t5_video_eval", "t5_video_train", "t5_full_ft"
BITFIT, T5V_BITFIT = "t5_bitfit", "t5_video_bitfit"
KERNELS = {
    "fused_attention": ("vlpet_tpu_torch/csrc/attention.cu",
                        "vlpet_tpu/ops/attention.py:408",
                        DECODE + TRAIN + T5 + (T5V_EVAL, T5V_TRAIN, FULL_FT)),
    "fused_attention_bwd": ("vlpet_tpu_torch/csrc/attention_bwd.cu",
                            "vlpet_tpu/ops/attention.py:1082",
                            TRAIN + (T5V_TRAIN, FULL_FT)),
    "fused_attention_bwd_long": ("vlpet_tpu_torch/csrc/attention_bwd_long.cu",
                                 "vlpet_tpu/ops/attention.py:641, "
                                 "vlpet_tpu/ops/attention.py:918",
                                 ("video_train", T5V_TRAIN)),
    "fused_ffn": ("vlpet_tpu_torch/csrc/ffn.cu", "vlpet_tpu/ops/ffn.py:240",
                  DECODE + TRAIN + ("t5_eval", T5V_EVAL, T5V_TRAIN)),
    "fused_ffn_bwd": ("vlpet_tpu_torch/csrc/ffn.cu",
                      "vlpet_tpu/ops/ffn.py:195", TRAIN + (T5V_TRAIN,)),
    "fused_dropout_add_ln": ("vlpet_tpu_torch/csrc/fused_ln.cu",
                             "vlpet_tpu/ops/fused_ln.py:251", TRAIN),
    "fused_dropout_add_ln_bwd": ("vlpet_tpu_torch/csrc/fused_ln.cu",
                                 "vlpet_tpu/ops/fused_ln.py:270", TRAIN),
    "beam_decode_attend": ("vlpet_tpu_torch/csrc/beam_attend.cu",
                           "vlpet_tpu/ops/decode.py:174",
                           DECODE + T5 + (T5V_EVAL,)),
    "topk_lse": ("vlpet_tpu_torch/csrc/topk.cu", "vlpet_tpu/ops/topk.py:159",
                 DECODE + T5 + (T5V_EVAL,)),
    "fused_gated_ffn": ("vlpet_tpu_torch/csrc/ffn.cu",
                        "vlpet_tpu/ops/ffn.py:334", ("t5_gated_eval",)),
    "fused_gated_ffn_bwd": ("vlpet_tpu_torch/csrc/ffn.cu",
                            "vlpet_tpu/ops/ffn.py:354", ("t5_gated_train",)),
    "fused_attention +bias +dropout": ("vlpet_tpu_torch/csrc/attention.cu",
                                       "vlpet_tpu/ops/attention.py:408",
                                       T5_TRAIN + (T5V_TRAIN, FULL_FT)),
    "fused_attention_bwd +bias +dropout": (
        "vlpet_tpu_torch/csrc/attention_bwd.cu",
        "vlpet_tpu/ops/attention.py:1082", T5_TRAIN + (T5V_TRAIN, FULL_FT)),
    "fused_attention_bwd +dbias": (
        "vlpet_tpu_torch/csrc/attention_bwd.cu",
        "vlpet_tpu/ops/attention.py:1082", (FULL_FT, BITFIT, T5V_BITFIT)),
    "fused_attention_bwd_long +bias +dropout": (
        "vlpet_tpu_torch/csrc/attention_bwd_long.cu",
        "vlpet_tpu/ops/attention.py:641, vlpet_tpu/ops/attention.py:918",
        (T5V_TRAIN,)),
    "fused_attention_bwd_long +dbias": (
        "vlpet_tpu_torch/csrc/attention_bwd_long.cu",
        "vlpet_tpu/ops/attention.py:641", (T5V_BITFIT,)),
    "fused_ffn relu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                "vlpet_tpu/ops/ffn.py:175",
                                ("t5_train", T5V_TRAIN)),
    "fused_ffn_bwd relu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                    "vlpet_tpu/ops/ffn.py:195",
                                    ("t5_train", T5V_TRAIN)),
    "fused_gated_ffn +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                 "vlpet_tpu/ops/ffn.py:334",
                                 ("t5_gated_train",)),
    "fused_linear_ce": ("vlpet_tpu_torch/csrc/fused_ce.cu",
                        "vlpet_tpu/ops/fused_ce.py:115", FUSED_CE),
    "fused_linear_ce_bwd": ("vlpet_tpu_torch/csrc/fused_ce.cu",
                            "vlpet_tpu/ops/fused_ce.py:147", FUSED_CE),
    "beam_decode_attend_update": ("vlpet_tpu_torch/csrc/beam_attend.cu",
                                  "vlpet_tpu/ops/decode.py:249", FUSED_BEAM),
    "cache_slot_update": ("vlpet_tpu_torch/csrc/cache_update.cu",
                          "vlpet_tpu/ops/cache_update.py:31", DECODE + T5),
}
MODES = {"fused_attention +bias +dropout": "fused_attention",
         "fused_attention_bwd +bias +dropout": "fused_attention_bwd",
         "fused_attention_bwd +dbias": "fused_attention_bwd.dbias",
         "fused_attention_bwd_long +bias +dropout": "fused_attention_bwd_long",
         "fused_attention_bwd_long +dbias": "fused_attention_bwd_long.dbias",
         "fused_ffn relu +dropout": "fused_ffn",
         "fused_ffn_bwd relu +dropout": "fused_ffn_bwd",
         "fused_gated_ffn +dropout": "fused_gated_ffn"}
# the run whose launch count the kernels' JSON record reports: the first of
# these that launches the kernel
MAIN_PATH_ORDER = ("train", "decode", "video_train", "video_eval", "t5_eval",
                   "t5_gated_eval", "t5_train", "t5_gated_train") + FUSED_CE \
    + FUSED_BEAM + (T5V_EVAL, T5V_TRAIN, FULL_FT, BITFIT, T5V_BITFIT)
# per main-path run: examples/s, and for a train run ms/step and peak GiB
RUNS = {}


def wrapper_of(key: str) -> str:
    """The wrapper whose launch count a record entry reads."""
    return MODES.get(key, key)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "n/a"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes moved at the memory rate and the operations at the peak
    rate for the inputs' type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
            scaled: bool = False) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = TOL[dtype] * (1.0 + (want.abs().max() if scaled else want.abs()))
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{name}: kernel disagrees with plain: max |err| "
                             f"{err.max().item():.3e} (tol {TOL[dtype]})")
    return err.max().item()


class Report:
    """Per record entry (a kernel, or one of its MODES): the largest error
    against the plain twin over all the checks, and the times and bound of
    the one timed case."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.timed = {}

    def check(self, key, label, kernel_fn, plain_fn, dtype, timed=False,
              work=None, library_fn=None, iters=20, backward=False):
        """Compare kernel_fn() with plain_fn() (a tensor or a tuple each),
        then time both (and library_fn, one PyTorch call of the same
        function, where there is one). ``work`` = (bytes, operations) of
        the call, for the bound of the timed case; ``backward`` takes the
        tolerance scaled by max|plain| (module docstring)."""
        before = route_counts()
        got = kernel_fn()
        took = routes_taken(before)
        want = plain_fn()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        err = max(compare(f"{key} {label}", g, w, dtype, backward)
                  for g, w in zip(got, want))
        self.err[key] = max(self.err[key], err)
        ms = cuda_ms(kernel_fn, iters)
        pms = cuda_ms(plain_fn, iters)
        lms = cuda_ms(library_fn, iters) if library_fn is not None else None
        lib = f"  library {lms:.4f} ms" if lms is not None else ""
        bms, by = bound(*work, dtype) if work is not None else (None, None)
        bnd = f"  bound {bms:.4f} ms ({by})" if work is not None else ""
        print(f"  {key:24s} {label:34s} max|err| {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {pms:.4f} ms{lib}{bnd}{took}", flush=True)
        if timed:
            self.timed[key] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                   bound_ms=bms, bound_by=by)
        self.last = (ms, pms, lms)
        return ms


def routes_taken(before: dict) -> str:
    """The routes launched since ``before`` (route_counts()), as printed
    after a case: "  route fused_attention tc", or "" for an unrouted
    kernel."""
    now = route_counts()
    took = [k.replace("[", " ").rstrip("]") for k, n in now.items()
            if n > before[k]]
    return f"  route {', '.join(took)}" if took else ""


def randn_fn(g, dev="cuda"):
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    return randn


def padding_mask(g, B: int, S: int) -> torch.Tensor:
    mask = torch.where(torch.rand((B, 1, 1, S), generator=g, device="cuda")
                       < 0.2, -1e9, 0.0)
    mask[..., 0] = 0.0
    return mask


def causal_mask(mask: torch.Tensor, L: int, S: int) -> torch.Tensor:
    """The padding mask plus the causal triangle materialised: what SDPA
    needs to compute a causal site (the kernels build it in-kernel)."""
    hidden = ~attention._causal_allowed(L, S, mask.device)
    return mask + torch.where(hidden, -1e9, 0.0)


def sdpa(q, k, v, mask, H):
    """One PyTorch call of the same attention (the library yardstick; the
    port never calls it): q pre-scaled, so scale 1."""
    B, L, inner = q.shape
    S = k.shape[1]
    heads = [t.view(B, n, H, inner // H).transpose(1, 2)
             for t, n in ((q, L), (k, S), (v, S))]
    return F.scaled_dot_product_attention(*heads, attn_mask=mask.to(q.dtype),
                                          scale=1.0)


def phase_kernels(rep: Report) -> None:
    """The decode path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = randn_fn(g)
    H, Dh = 12, 64
    inner = H * Dh

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16  # the bench paths run bf16
        e = 2 if main else 4
        # attention: encoder self-attention and beam cross-attention
        B, S = 500, 56
        mask = padding_mask(g, B, S)
        k = randn(B, S, inner, dtype=dtype)
        v = randn(B, S, inner, dtype=dtype)
        for L in (56, 5):
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            rep.check("fused_attention", f"{tag} B{B} L{L} S{S} H{H} Dh{Dh}",
                      lambda: attention.fused_attention(q, k, v, mask, H),
                      lambda: attention.fused_attention_reference(q, k, v,
                                                                  mask, H),
                      dtype, timed=main and L == 56,
                      work=(e * 2 * B * (L + S) * inner + 4 * B * S,
                            4 * B * H * L * S * Dh),
                      library_fn=lambda: sdpa(q, k, v, mask, H))
        # FFN: encoder rows (B*56) and beam decode rows (B*K)
        D, Fh = 768, 3072
        w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                              scale=0.02)
        b1, b2 = randn(Fh, dtype=dtype, scale=0.02), randn(D, dtype=dtype,
                                                          scale=0.02)
        for N in (28000, 2500):
            x = randn(N, D, dtype=dtype)
            rep.check("fused_ffn", f"{tag} N{N} D{D} F{Fh} gelu",
                      lambda: ffn.fused_ffn(x, w1, b1, w2, b2, "gelu"),
                      lambda: ffn.ffn_reference(x, w1, b1, w2, b2, "gelu"),
                      dtype, timed=main and N == 28000,
                      work=(e * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                            4 * N * D * Fh),
                      iters=20 if main else 3)
        # beam self-attend over the time-major cache
        K = J = 5
        Lc = 40
        qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
        kc = randn(Lc, B * J, inner, dtype=dtype)
        vc = randn(Lc, B * J, inner, dtype=dtype)
        anc = torch.randint(0, J, (B, K, Lc), generator=g, device="cuda")
        for pos in (0, 13, Lc - 1):
            # cache rows this step's ancestry reads: distinct (b, t, j)
            rows = F.one_hot(anc[:, :, :pos + 1], J).amax(dim=1).sum().item()
            rep.check("beam_decode_attend",
                      f"{tag} B{B} K{K} L{Lc} pos{pos}",
                      lambda: decode.beam_decode_attend(qb, kc, vc, anc, pos),
                      lambda: decode.beam_decode_attend_reference(
                          qb, kc, vc, anc, pos),
                      dtype, timed=main and pos == Lc - 1,
                      work=(e * (2 * B * K * inner + 2 * rows * inner)
                            + anc.element_size() * B * K * (pos + 1),
                            4 * B * K * H * (pos + 1) * Dh),
                      library_fn=beam_sdpa(qb, kc, vc, anc, pos, dtype))

    # top-k + logsumexp on f32 logits, with ties
    R, V = 2500, 50265
    cases = {
        "randn": torch.randn((R, V), generator=g, device="cuda"),
        # 2000 levels over 50265 entries: every top value is tied ~25 ways
        "ties": torch.randint(-1000, 1000, (R, V), generator=g,
                              device="cuda").float() / 100.0,
    }
    for cname, x in cases.items():
        for kk in (1, 10, 16):
            check_topk(rep, cname, x, kk, timed=cname == "randn" and kk == 10)


def beam_sdpa(qb, kc, vc, anc, pos, dtype, bias_row=None):
    """The library yardstick of D1: one SDPA call over every beam's J * L
    candidate slots with the ancestry mask (and the bias row)
    materialised, the layouts prepared outside the timed call; checked
    once against D1's plain twin."""
    B, K, Lc = anc.shape
    H, Dh = qb.shape[-2:]
    J = kc.shape[1] // B
    qh = qb.reshape(B, K, H, Dh).transpose(1, 2)
    kh, vh = (t.reshape(Lc, B, J, H, Dh).permute(1, 3, 2, 0, 4)
              .reshape(B, H, J * Lc, Dh) for t in (kc, vc))
    m = decode.beam_selection_mask(anc, pos, Lc, J).reshape(B, 1, K, J * Lc)
    if bias_row is not None:
        m = m + bias_row.float().reshape(1, H, 1, Lc).repeat(1, 1, 1, J)
    m = m.to(dtype)

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m,
                                              scale=1.0)
    got = call().transpose(1, 2).reshape(B * K, 1, H * Dh)
    compare("beam_decode_attend SDPA yardstick", got,
            decode.beam_decode_attend_reference(qb, kc, vc, anc, pos,
                                                bias_row), dtype)
    return call


def check_topk(rep: Report, cname: str, x: torch.Tensor, kk: int,
               timed: bool = False) -> None:
    """topk_lse on f32 logits x (R, V): indices and values exactly the
    stable sort's, lse within TOPK_LSE_TOL."""
    R, V = x.shape
    got = topk.topk_lse(x, kk)
    want = topk.topk_lse_reference(x, kk)
    torch.cuda.synchronize()
    worst = topk_exact(f"{cname} k={kk}", got, want)
    rep.err["topk_lse"] = max(rep.err["topk_lse"], worst)
    ms = cuda_ms(lambda: topk.topk_lse(x, kk))
    pms = cuda_ms(lambda: topk.topk_lse_reference(x, kk))
    bms, by = bound(4 * R * V + 4 * R * (2 * kk + 1), 4 * R * V,
                    torch.float32)
    if timed:
        rep.timed["topk_lse"] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                     bound_ms=bms, bound_by=by)
    print(f"  {'topk_lse':24s} {f'{cname} R{R} V{V} k{kk}':34s} "
          f"indices exact, lse max|err| {worst:.3e}  "
          f"kernel {ms:.4f} ms  plain {pms:.4f} ms  bound {bms:.4f} ms "
          f"({by})", flush=True)


def topk_exact(label: str, got, want) -> float:
    """Raise unless topk_lse's (vals, toks, lse) ``got`` has the plain
    twin's values and indices exactly and its lse within TOPK_LSE_TOL (-inf
    where the twin's is -inf); returns the largest lse error."""
    (vals, toks, lse), (rv, rt, rl) = got, want
    if not torch.equal(toks, rt) or not torch.equal(vals, rv):
        bad = (toks != rt).any(dim=1).nonzero()[:3].flatten().tolist()
        raise AssertionError(f"topk_lse {label}: indices/values differ from "
                             f"the stable sort, rows {bad}")
    fin = torch.isfinite(rl)
    if not (torch.equal(torch.isfinite(lse), fin)
            and torch.equal(lse[~fin], rl[~fin])):
        raise AssertionError(f"topk_lse {label}: lse not -inf where the "
                             f"plain twin's is")
    err = (lse[fin] - rl[fin]).abs()
    worst = err.max().item() if err.numel() else 0.0
    if bool((err > TOPK_LSE_TOL * (1 + rl[fin].abs())).any()):
        raise AssertionError(f"topk_lse {label}: lse max |err| {worst:.3e}")
    return worst


def _grads_of(fn, inputs, cot):
    """A function that returns the gradients of fn(*inputs) for cotangent
    ``cot`` from one recorded graph (the plain twin of a backward kernel,
    timed without its forward)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def phase_train_kernels(rep: Report) -> None:
    """The training path's shapes: every forward and backward kernel."""
    g = torch.Generator(device="cuda").manual_seed(1)
    randn = randn_fn(g)
    H, Dh = 12, 64
    inner = H * Dh
    B = 500
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16
        e = 2 if main else 4
        sites = (("enc", 56, 56, False, padding_mask(g, B, 56)),
                 ("dec-self", 10, 10, True,
                  torch.zeros((1, 1, 1, 10), device="cuda")),
                 ("cross", 10, 56, False, padding_mask(g, B, 56)))
        for site, L, S, causal, mask in sites:
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            k = randn(B, S, inner, dtype=dtype)
            v = randn(B, S, inner, dtype=dtype)
            do = randn(B, L, inner, dtype=dtype)
            label = f"{tag} {site} B{B} L{L} S{S}" + (" causal" if causal
                                                      else "")
            rep.check("fused_attention", label,
                      lambda: attention.fused_attention(q, k, v, mask, H,
                                                        causal),
                      lambda: attention.fused_attention_reference(
                          q, k, v, mask, H, causal), dtype)
            plain_bwd = _grads_of(
                lambda a, b, c: attention.fused_attention_reference(
                    a, b, c, mask, H, causal), (q, k, v), do)
            lmask = causal_mask(mask, L, S) if causal else mask
            lib_bwd = _grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H),
                                (q, k, v),
                                do.view(B, L, H, Dh).transpose(1, 2))
            seen = (attention._causal_allowed(L, S, "cuda").float().mean()
                    .item() if causal else 1.0)
            rep.check("fused_attention_bwd", label,
                      lambda: attention.fused_attention_bwd(q, k, v, mask, do,
                                                            H, causal),
                      plain_bwd, dtype, timed=main and site == "enc",
                      work=(e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
                            10 * B * H * L * S * Dh * seen),
                      library_fn=lib_bwd, backward=True)
            if main:
                bitwise_repeat("fused_attention_bwd", label,
                               lambda: attention.fused_attention_bwd(
                                   q, k, v, mask, do, H, causal))
        D, Fh = 768, 3072
        w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                              scale=0.02)
        b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
        for N in (28000, 5000):
            x = randn(N, D, dtype=dtype)
            dy = randn(N, D, dtype=dtype)
            iters = 20 if main else 3
            if N == 5000:  # N 28000 is phase 3's
                rep.check("fused_ffn", f"{tag} N{N} D{D} F{Fh} gelu",
                          lambda: ffn.fused_ffn(x, w1, b1, w2, b2, "gelu"),
                          lambda: ffn.ffn_reference(x, w1, b1, w2, b2, "gelu"),
                          dtype, iters=iters,
                          work=(e * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                                4 * N * D * Fh))
            plain_bwd = _grads_of(
                lambda a, c, d: ffn.ffn_reference(a, w1, c, w2, d, "gelu"),
                (x, b1, b2), dy)
            rep.check("fused_ffn_bwd", f"{tag} N{N} D{D} F{Fh} gelu",
                      lambda: ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu"),
                      plain_bwd, dtype, timed=main and N == 28000,
                      work=(e * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                            6 * N * D * Fh), iters=iters, backward=True)
        for N in (28000, 5000):
            h, res, dy = (randn(N, D, dtype=dtype) for _ in range(3))
            gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                                 device="cuda", dtype=torch.int32)
            for rate in (0.1, 0.0):
                label = f"{tag} N{N} D{D} rate {rate}"
                timed = main and N == 28000 and rate > 0
                rep.check("fused_dropout_add_ln", label,
                          lambda: fused_ln.fused_dropout_add_ln(
                              h, res, gamma, beta, seed, rate),
                          lambda: fused_ln.fused_dropout_add_ln_reference(
                              h, res, gamma, beta, seed, rate), dtype,
                          timed=timed,
                          work=(e * 3 * N * D + 4 * (2 * D + 1), 8 * N * D))
                plain_bwd = _grads_of(
                    lambda a, b, c, d: fused_ln.fused_dropout_add_ln_reference(
                        a, b, c, d, seed, rate), (h, res, gamma, beta), dy)
                rep.check("fused_dropout_add_ln_bwd", label,
                          lambda: fused_ln.fused_dropout_add_ln_bwd(
                              h, res, gamma, seed, dy, rate),
                          plain_bwd, dtype, timed=timed,
                          work=(e * 5 * N * D + 4 * (3 * D + 1), 16 * N * D),
                          backward=True)
                if not main and rate > 0:
                    check_ln_mask(h, res, gamma, seed, dy, rate)


def phase_long_attention(rep: Report) -> None:
    """The video path's attention shapes: A1 forward (output and row
    logsumexp) and the long backward vs the plain version and autograd of
    it; SDPA forward and autograd backward as the library yardstick."""
    g = torch.Generator(device="cuda").manual_seed(3)
    randn = randn_fn(g)
    H, Dh = 12, 64
    inner = H * Dh
    # "ragged": L = S = 65, one full 64-row tile and a 1-row one
    sites = (("enc", 50, 604, 604, False), ("cross", 50, 10, 604, False),
             ("enc", 16, 1024, 1024, False), ("causal", 50, 604, 604, True),
             ("ragged", 50, 65, 65, False))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16
        e = 2 if main else 4
        for site, B, L, S, causal in sites:
            mask = padding_mask(g, B, S)
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            k = randn(B, S, inner, dtype=dtype)
            v = randn(B, S, inner, dtype=dtype)
            do = randn(B, L, inner, dtype=dtype)
            label = f"{tag} {site} B{B} L{L} S{S}"
            # the share of (query, key) pairs the causal triangle leaves
            seen = (attention._causal_allowed(L, S, "cuda").float().mean()
                    .item() if causal else 1.0)
            timed = main and site == "enc" and S == 604
            # SDPA takes the causal triangle materialised in its mask
            lmask = causal_mask(mask, L, S) if causal else mask
            rep.check("fused_attention", label + " +lse",
                      lambda: attention.fused_attention_fwd_lse(
                          q, k, v, mask, H, causal),
                      lambda: attention.fused_attention_lse_reference(
                          q, k, v, mask, H, causal), dtype,
                      work=(e * 2 * B * (L + S) * inner + 4 * B * S
                            + 4 * B * H * L, 4 * B * H * L * S * Dh * seen),
                      library_fn=lambda: sdpa(q, k, v, lmask, H))
            out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H,
                                                         causal)
            plain_bwd = _grads_of(
                lambda a, b, c: attention.fused_attention_reference(
                    a, b, c, mask, H, causal), (q, k, v), do)
            lib_bwd = _grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H),
                                (q, k, v),
                                do.view(B, L, H, Dh).transpose(1, 2))
            rep.check("fused_attention_bwd_long", label,
                      lambda: attention.fused_attention_bwd_long(
                          q, k, v, mask, out, lse, do, H, causal),
                      plain_bwd, dtype, timed=timed,
                      work=(e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
                            10 * B * H * L * S * Dh * seen),
                      library_fn=lib_bwd, backward=True)
            del plain_bwd, lib_bwd
            if main:
                bitwise_repeat("fused_attention_bwd_long", label,
                               lambda: attention.fused_attention_bwd_long(
                                   q, k, v, mask, out, lse, do, H, causal))
    # a record for later PRs, not a route: the long backward at the
    # image-text encoder shape, beside A6, which serves it
    B, L = 500, 56
    mask = padding_mask(g, B, L)
    q = randn(B, L, inner, dtype=torch.bfloat16, scale=Dh ** -0.5)
    k, v, do = (randn(B, L, inner, dtype=torch.bfloat16) for _ in range(3))
    out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H)
    long_ms = rep.check(
        "fused_attention_bwd_long", f"bf16 image-text enc B{B} L=S={L}",
        lambda: attention.fused_attention_bwd_long(q, k, v, mask, out, lse,
                                                   do, H),
        lambda: attention.fused_attention_bwd(q, k, v, mask, do, H),
        torch.bfloat16, backward=True)
    a6_ms = cuda_ms(lambda: attention.fused_attention_bwd(q, k, v, mask, do, H))
    print(f"  image-text encoder backward, bf16 B{B} L=S={L}: long backward "
          f"{long_ms:.4f} ms, A6 {a6_ms:.4f} ms (A6 serves this shape)",
          flush=True)


def bitwise_repeat(key: str, label: str, fn) -> None:
    """fn() twice gives bitwise equal outputs (no atomics, fixed-order
    sums)."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{key} {label}: two runs differ")
    print(f"  {key:24s} {label:34s} bitwise equal over two runs",
          flush=True)


def phase_video_kernels(rep: Report) -> None:
    """The other kernels of the video paths at the shapes those paths give
    them (B 50, S 604, 10 targets, beam 5 to length 20), bf16 as the bench
    phases run them: the beam cross-attention (L 5 over S 604), the
    decoder self-attention (L = S = 10, causal) forward and A6 backward, the
    FFN forward and backward and dropout + add + LayerNorm forward and
    backward at the encoder rows (50 x 604) and the decoder rows (50 x 10),
    the FFN forward at the beam rows (250), the beam self-attention over a
    20-slot cache and top-k over 250 rows."""
    g = torch.Generator(device="cuda").manual_seed(4)
    randn = randn_fn(g)
    dtype, B, S, T, K = torch.bfloat16, 50, 604, 10, 5
    H, Dh, D, Fh = 12, 64, 768, 3072
    inner = H * Dh
    it = 5
    mask = padding_mask(g, B, S)
    k, v = randn(B, S, inner, dtype=dtype), randn(B, S, inner, dtype=dtype)
    for L, what in ((K, "beam"), (1, "greedy")):
        q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
        rep.check("fused_attention", f"bf16 {what} cross B{B} L{L} S{S}",
                  lambda: attention.fused_attention(q, k, v, mask, H),
                  lambda: attention.fused_attention_reference(q, k, v, mask,
                                                              H),
                  dtype, iters=it, library_fn=lambda: sdpa(q, k, v, mask, H),
                  work=(2 * 2 * B * (L + S) * inner + 4 * B * S,
                        4 * B * H * L * S * Dh))
    zero = torch.zeros((1, 1, 1, T), device="cuda")
    q, k, v, do = (randn(B, T, inner, dtype=dtype, scale=s)
                   for s in (Dh ** -0.5, 1.0, 1.0, 1.0))
    label = f"bf16 dec-self B{B} L{T} S{T} causal"
    rep.check("fused_attention", label,
              lambda: attention.fused_attention(q, k, v, zero, H, True),
              lambda: attention.fused_attention_reference(q, k, v, zero, H,
                                                          True),
              dtype, iters=it)
    rep.check("fused_attention_bwd", label,
              lambda: attention.fused_attention_bwd(q, k, v, zero, do, H, True),
              _grads_of(lambda a, b, c: attention.fused_attention_reference(
                  a, b, c, zero, H, True), (q, k, v), do),
              dtype, iters=it, backward=True)
    bitwise_repeat("fused_attention_bwd", label,
                   lambda: attention.fused_attention_bwd(q, k, v, zero, do, H,
                                                         True))
    w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                          scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    for N in (B * S, B * T, B * K):
        x, res, dy = (randn(N, D, dtype=dtype) for _ in range(3))
        rep.check("fused_ffn", f"bf16 N{N} D{D} F{Fh} gelu",
                  lambda: ffn.fused_ffn(x, w1, b1, w2, b2, "gelu"),
                  lambda: ffn.ffn_reference(x, w1, b1, w2, b2, "gelu"),
                  dtype, iters=it)
        if N == B * K:  # beam rows: eval only
            continue
        rep.check("fused_ffn_bwd", f"bf16 N{N} D{D} F{Fh} gelu",
                  lambda: ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu"),
                  _grads_of(lambda a, c, d: ffn.ffn_reference(
                      a, w1, c, w2, d, "gelu"), (x, b1, b2), dy),
                  dtype, iters=it, backward=True)
        label = f"bf16 N{N} D{D} rate 0.1"
        rep.check("fused_dropout_add_ln", label,
                  lambda: fused_ln.fused_dropout_add_ln(x, res, gamma, beta,
                                                        seed, 0.1),
                  lambda: fused_ln.fused_dropout_add_ln_reference(
                      x, res, gamma, beta, seed, 0.1), dtype, iters=it)
        rep.check("fused_dropout_add_ln_bwd", label,
                  lambda: fused_ln.fused_dropout_add_ln_bwd(x, res, gamma,
                                                            seed, dy, 0.1),
                  _grads_of(lambda a, b, c, d:
                            fused_ln.fused_dropout_add_ln_reference(
                                a, b, c, d, seed, 0.1),
                            (x, res, gamma, beta), dy),
                  dtype, iters=it, backward=True)
    Lc = 20
    qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
    kc, vc = (randn(Lc, B * K, inner, dtype=dtype) for _ in range(2))
    anc = torch.randint(0, K, (B, K, Lc), generator=g, device="cuda")
    rep.check("beam_decode_attend", f"bf16 B{B} K{K} L{Lc} pos{Lc - 1}",
              lambda: decode.beam_decode_attend(qb, kc, vc, anc, Lc - 1),
              lambda: decode.beam_decode_attend_reference(qb, kc, vc, anc,
                                                          Lc - 1),
              dtype, iters=it)
    check_topk(rep, "randn", torch.randn((B * K, 50265), generator=g,
                                         device="cuda"), 2 * K)


def phase_t5_kernels(rep: Report) -> None:
    """The T5 eval path's shapes (B 300, 20 text + 36 boxes = S 56, beam 5
    to length 40, d 768, 12 heads), bf16 and fp32: A1 with the per-head
    relative bias (rounded to the compute dtype, fed as fp32, as the model
    does) and a ragged padding mask, with its row logsumexp, and causal at
    the teacher-forced decoder's L = S = 10; the beam cross-attention (L 5
    over S 56); D1 with the bias row; F1 relu with zero biases and F3 at the
    encoder rows (B x 56) and the beam rows (B x 5)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    randn = randn_fn(g)
    B, S, K, Lc, T = 300, 56, 5, 40, 10
    H, Dh, D, F1h, F3h = 12, 64, 768, 3072, 2048
    inner = H * Dh
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16
        e = 2 if main else 4
        mask = padding_mask(g, B, S)
        bias = randn(1, H, S, S, dtype=dtype, scale=0.5).float()
        q, k, v = (randn(B, S, inner, dtype=dtype, scale=s)
                   for s in (Dh ** -0.5, 1.0, 1.0))
        work = (e * 2 * B * 2 * S * inner + 4 * B * S + 4 * H * S * S,
                4 * B * H * S * S * Dh)
        rep.check("fused_attention", f"{tag} +bias B{B} L=S={S} H{H}",
                  lambda: attention.fused_attention(q, k, v, mask, H,
                                                    bias=bias),
                  lambda: attention.fused_attention_reference(
                      q, k, v, mask, H, bias=bias),
                  dtype, work=work,
                  library_fn=lambda: sdpa(q, k, v, mask + bias, H))
        rep.check("fused_attention", f"{tag} +bias +lse B{B} L=S={S}",
                  lambda: attention.fused_attention_fwd_lse(
                      q, k, v, mask, H, bias=bias),
                  lambda: attention.fused_attention_lse_reference(
                      q, k, v, mask, H, bias=bias), dtype)
        zero = torch.zeros((1, 1, 1, T), device="cuda")
        bias_t = randn(1, H, T, T, dtype=dtype, scale=0.5).float()
        # q at the attention scale: T5 does not scale q, its init does
        qt, kt, vt = (randn(B, T, inner, dtype=dtype, scale=s)
                      for s in (Dh ** -0.5, 1.0, 1.0))
        rep.check("fused_attention", f"{tag} +bias causal B{B} L=S={T}",
                  lambda: attention.fused_attention(qt, kt, vt, zero, H, True,
                                                    bias_t),
                  lambda: attention.fused_attention_reference(
                      qt, kt, vt, zero, H, True, bias_t), dtype)
        qc = randn(B, K, inner, dtype=dtype, scale=Dh ** -0.5)
        rep.check("fused_attention", f"{tag} beam cross B{B} L{K} S{S}",
                  lambda: attention.fused_attention(qc, k, v, mask, H),
                  lambda: attention.fused_attention_reference(qc, k, v, mask,
                                                              H),
                  dtype, work=(e * 2 * B * (K + S) * inner + 4 * B * S,
                               4 * B * H * K * S * Dh),
                  library_fn=lambda: sdpa(qc, k, v, mask, H))
        qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
        kc, vc = (randn(Lc, B * K, inner, dtype=dtype) for _ in range(2))
        anc = torch.randint(0, K, (B, K, Lc), generator=g, device="cuda")
        row = randn(1, H, 1, Lc, dtype=dtype, scale=0.5).float()
        for pos in (0, 13, Lc - 1):
            rows = F.one_hot(anc[:, :, :pos + 1], K).amax(dim=1).sum().item()
            rep.check("beam_decode_attend",
                      f"{tag} +bias row B{B} K{K} L{Lc} pos{pos}",
                      lambda: decode.beam_decode_attend(qb, kc, vc, anc, pos,
                                                        row),
                      lambda: decode.beam_decode_attend_reference(
                          qb, kc, vc, anc, pos, row),
                      dtype, work=(e * (2 * B * K * inner + 2 * rows * inner)
                                   + anc.element_size() * B * K * (pos + 1)
                                   + 4 * H * (pos + 1),
                                   4 * B * K * H * (pos + 1) * Dh),
                      library_fn=beam_sdpa(qb, kc, vc, anc, pos, dtype, row))
        w1, w2 = (randn(F1h, D, dtype=dtype, scale=0.02),
                  randn(D, F1h, dtype=dtype, scale=0.02))
        z1, z2 = torch.zeros(F1h, device="cuda"), torch.zeros(D, device="cuda")
        w0, wg, wo = (randn(F3h, D, dtype=dtype, scale=0.02),
                      randn(F3h, D, dtype=dtype, scale=0.02),
                      randn(D, F3h, dtype=dtype, scale=0.02))
        for N in (B * S, B * K):
            x = randn(N, D, dtype=dtype)
            iters = 20 if main else 3
            rep.check("fused_ffn", f"{tag} N{N} D{D} F{F1h} relu",
                      lambda: ffn.fused_ffn(x, w1, z1, w2, z2, "relu"),
                      lambda: ffn.ffn_reference(x, w1, z1, w2, z2, "relu"),
                      dtype, work=(e * (2 * N * D + 2 * D * F1h)
                                   + 4 * (F1h + D), 4 * N * D * F1h),
                      iters=iters)
            rep.check("fused_gated_ffn", f"{tag} N{N} D{D} F{F3h} gelu_new",
                      lambda: ffn.fused_gated_ffn(x, w0, wg, wo),
                      lambda: ffn.gated_ffn_reference(x, w0, wg, wo),
                      dtype, timed=main and N == B * S,
                      work=(e * (2 * N * D + 3 * D * F3h), 6 * N * D * F3h),
                      iters=iters)
            if main:
                check_ffn_bf16(f"N{N} D{D} F{F1h} relu",
                               ffn.fused_ffn(x, w1, z1, w2, z2, "relu"),
                               torch.relu(x.float() @ w1.float().t()),
                               w2)
                xf = x.float()
                check_ffn_bf16(f"N{N} D{D} F{F3h} gelu_new gated",
                               ffn.fused_gated_ffn(x, w0, wg, wo),
                               ffn.gelu_new(xf @ w0.float().t())
                               * (xf @ wg.float().t()), wo)
    # top-k + logsumexp at the beam rows (B x K) over both T5 vocabularies
    for V in (32100, 32128):
        check_topk(rep, "randn", torch.randn((B * K, V), generator=g,
                                             device="cuda"), 2 * K)


def check_ffn_bf16(label: str, got: torch.Tensor, hidden: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor = None) -> None:
    """bf16 F1 / F3 against fp32 arithmetic on the same bf16 inputs: the fp32
    ``hidden`` rounded to bf16 where the kernel rounds it, times the output
    weight in fp32 (plus the output bias). max |err| / max |ref| within
    BF16_FFN_RTOL, little more than the bf16 rounding of the output: a
    fault in a few columns fails here that the elementwise 2e-2·(1 +
    |plain|) check could pass."""
    ref = hidden.to(torch.bfloat16).float() @ w_out.float().t()
    if b_out is not None:
        ref = ref + b_out.float()
    check_bf16_vs_fp32(label, got, ref)


def check_bf16_vs_fp32(label: str, got: torch.Tensor, ref: torch.Tensor,
                       allow: torch.Tensor = None) -> None:
    """A bf16 FFN kernel's output against ``ref``, fp32 arithmetic on the
    same bf16 inputs: max |err| / max |ref| within BF16_FFN_RTOL, where
    ``allow`` (elementwise, or None) is first taken off |err|: what fp32
    arithmetic may give either way (ffn_bwd_fp32)."""
    err = (got.float() - ref).abs()
    if allow is not None:
        err = (err - allow).clamp_min(0.0)
    rel = (err.max() / ref.abs().max()).item()
    if not rel <= BF16_FFN_RTOL:
        raise AssertionError(f"bf16 FFN {label}: max |err| / max |ref| "
                             f"{rel:.3e} against fp32 on the same inputs "
                             f"(tol {BF16_FFN_RTOL})")
    print(f"  {'bf16 vs fp32 arithmetic':24s} {label:34s} max|err|/max|ref| "
          f"{rel:.3e}", flush=True)


def check_ln_mask(h, res, gamma, seed, dy, rate) -> None:
    """fp32: the backward kernel's dropout mask, bit for bit, is keep_mask's
    (dh = dres * 1/(1-rate) where kept, 0 where dropped)."""
    dh, dres, _, _ = fused_ln.fused_dropout_add_ln_bwd(h, res, gamma, seed,
                                                       dy, rate)
    keep = keep_mask(h.shape, 0, seed, rate)
    scale = torch.tensor(1.0 / (1.0 - rate), device="cuda")
    want = torch.where(keep, dres * scale, torch.zeros_like(dres))
    if not torch.equal(dh, want):
        bad = (dh != want).sum().item()
        raise AssertionError(f"fused LN dropout mask differs from keep_mask "
                             f"in {bad} elements")
    print(f"  {'fused_dropout_add_ln_bwd':24s} fp32 mask == keep_mask bit for "
          f"bit ({h.shape[0]}x{h.shape[1]}, kept share "
          f"{keep.float().mean().item():.4f})", flush=True)


def phase_t5_train_kernels(rep: Report) -> None:
    """The T5 training path's shapes (B 300, S 56, 10 targets, d 768, 12
    heads), bf16 and fp32, at rate 0.1 and 0.0 with one seed: A1 and A6 at
    the encoder self-attention (relative bias, ragged padding mask), the
    decoder self-attention (bias, causal) and the cross-attention; F1/F2
    relu (zero biases) and F3/F4 gated at the encoder rows (B x 56) and the
    decoder rows (B x 10). Then the dropout masks bit for bit (fp32)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    randn = randn_fn(g)
    B, S, T = 300, 56, 10
    H, Dh, D, F1h, F3h = 12, 64, 768, 3072, 2048
    inner = H * Dh
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16
        e = 2 if main else 4
        enc_mask = padding_mask(g, B, S)
        sites = (("enc", S, S, False, enc_mask, True),
                 ("dec-self", T, T, True,
                  torch.zeros((1, 1, 1, T), device="cuda"), True),
                 ("cross", T, S, False, enc_mask, False))
        for site, L, Sk, causal, mask, has_bias in sites:
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            k, v = (randn(B, Sk, inner, dtype=dtype) for _ in range(2))
            do = randn(B, L, inner, dtype=dtype)
            bias = (randn(1, H, L, Sk, dtype=dtype, scale=0.5).float()
                    if has_bias else None)
            seen = (attention._causal_allowed(L, Sk, "cuda").float().mean()
                    .item() if causal else 1.0)
            lmask = causal_mask(mask, L, Sk) if causal else mask
            if bias is not None:
                lmask = lmask + bias
            nb = 4 * H * L * Sk if has_bias else 0
            for rate in (0.1, 0.0):
                label = (f"{tag} {site} B{B} L{L} S{Sk}"
                         + (" +bias" if has_bias else "")
                         + (" causal" if causal else "") + f" rate {rate}")
                timed = main and site == "enc" and rate > 0
                # SDPA computes the same function only without dropout
                lib = rate == 0.0
                rep.check("fused_attention +bias +dropout", label,
                          lambda: attention.fused_attention(
                              q, k, v, mask, H, causal, bias, rate, seed),
                          lambda: attention.fused_attention_reference(
                              q, k, v, mask, H, causal, bias, rate, seed),
                          dtype, timed=timed,
                          work=(e * 2 * B * (L + Sk) * inner + 4 * B * Sk
                                + nb, 4 * B * H * L * Sk * Dh * seen),
                          library_fn=(lambda: sdpa(q, k, v, lmask, H))
                          if lib else None)
                plain_bwd = _grads_of(
                    lambda a, b, c: attention.fused_attention_reference(
                        a, b, c, mask, H, causal, bias, rate, seed),
                    (q, k, v), do)
                lib_bwd = (_grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H),
                                     (q, k, v),
                                     do.view(B, L, H, Dh).transpose(1, 2))
                           if lib else None)
                rep.check("fused_attention_bwd +bias +dropout", label,
                          lambda: attention.fused_attention_bwd(
                              q, k, v, mask, do, H, causal, bias, rate, seed),
                          plain_bwd, dtype, timed=timed,
                          work=(e * (3 * B * L + 4 * B * Sk) * inner
                                + 4 * B * Sk + nb,
                                10 * B * H * L * Sk * Dh * seen),
                          library_fn=lib_bwd, backward=True)
                if main:
                    bitwise_repeat("fused_attention_bwd +bias +dropout", label,
                                   lambda: attention.fused_attention_bwd(
                                       q, k, v, mask, do, H, causal, bias,
                                       rate, seed))
                del plain_bwd, lib_bwd
        w1, w2 = (randn(F1h, D, dtype=dtype, scale=0.02),
                  randn(D, F1h, dtype=dtype, scale=0.02))
        z1, z2 = torch.zeros(F1h, device="cuda"), torch.zeros(D, device="cuda")
        w0, wg, wo = (randn(F3h, D, dtype=dtype, scale=0.02),
                      randn(F3h, D, dtype=dtype, scale=0.02),
                      randn(D, F3h, dtype=dtype, scale=0.02))
        for N in (B * S, B * T):
            x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
            iters = 20 if main else 3
            for rate in (0.1, 0.0):
                label = f"{tag} N{N} D{D} F{F1h} relu rate {rate}"
                timed = main and N == B * S and rate > 0
                rep.check("fused_ffn relu +dropout", label,
                          lambda: ffn.fused_ffn(x, w1, z1, w2, z2, "relu",
                                                rate, seed),
                          lambda: ffn.ffn_reference(x, w1, z1, w2, z2, "relu",
                                                    rate, seed),
                          dtype, timed=timed,
                          work=(e * (2 * N * D + 2 * D * F1h) + 4 * (F1h + D),
                                4 * N * D * F1h), iters=iters)
                plain_bwd = _grads_of(
                    lambda a, c, d: ffn.ffn_reference(a, w1, c, w2, d, "relu",
                                                      rate, seed),
                    (x, z1, z2), dy)
                rep.check("fused_ffn_bwd relu +dropout", label,
                          lambda: ffn.fused_ffn_bwd(x, dy, w1, z1, w2, "relu",
                                                    rate, seed),
                          plain_bwd, dtype, timed=timed,
                          work=(e * (3 * N * D + 2 * D * F1h)
                                + 4 * (2 * F1h + D), 6 * N * D * F1h),
                          iters=iters, backward=True)
                label = f"{tag} N{N} D{D} F{F3h} gelu_new rate {rate}"
                rep.check("fused_gated_ffn +dropout", label,
                          lambda: ffn.fused_gated_ffn(x, w0, wg, wo,
                                                      "gelu_new", rate, seed),
                          lambda: ffn.gated_ffn_reference(
                              x, w0, wg, wo, "gelu_new", rate, seed),
                          dtype, timed=timed,
                          work=(e * (2 * N * D + 3 * D * F3h),
                                6 * N * D * F3h), iters=iters)
                plain_bwd = _grads_of(
                    lambda a: ffn.gated_ffn_reference(a, w0, wg, wo,
                                                      "gelu_new", rate, seed),
                    (x,), dy)
                rep.check("fused_gated_ffn_bwd", label,
                          lambda: ffn.fused_gated_ffn_bwd(
                              x, dy, w0, wg, wo, "gelu_new", rate, seed),
                          lambda: plain_bwd()[0], dtype, timed=timed,
                          work=(e * (3 * N * D + 3 * D * F3h),
                                10 * N * D * F3h),
                          iters=iters, backward=True)
                del plain_bwd
    check_drop_masks(seed)


def _expect_zeros(name: str, got: torch.Tensor, keep: torch.Tensor,
                  tag: str = "fp32") -> None:
    """got is zero exactly where keep is False."""
    bad = ((got == 0) != ~keep).sum().item()
    if bad:
        raise AssertionError(f"{name}: dropout mask differs from "
                             f"ops/hashdrop.py in {bad} elements")
    print(f"  {name:46s} {tag} mask == hashdrop bit for bit "
          f"({tuple(keep.shape)}, kept share "
          f"{keep.float().mean().item():.4f})", flush=True)


def _picking(rows: int, cols: int, off: int) -> torch.Tensor:
    """(rows, cols) fp32 with W[r, r + off] = 1: x . W^T reads columns
    off .. off + rows of the hidden."""
    w = torch.zeros((rows, cols), device="cuda")
    r = torch.arange(rows, device="cuda")
    w[r, r + off] = 1.0
    return w


@torch.no_grad()
def check_drop_masks(seed: torch.Tensor, rate: float = 0.1) -> None:
    """fp32 (A6 also bf16, its tensor-core route), the T5 training shapes:
    each kernel's dropout mask, bit for bit, is ops/hashdrop.py's. A1 with
    one-hot values (v[j, d] = [d == j], S <= Dh) returns the dropped
    probabilities themselves; A6 with one-hot cotangents returns them in
    dv; the FFN kernels with picking weights
    return columns off .. off + D of the dropped hidden (or of its
    cotangent), at off 0 and F - D."""
    from vlpet_tpu_torch.ops.hashdrop import attention_keep_mask, keep_mask

    g = torch.Generator(device="cuda").manual_seed(7)
    B, H, Dh = 300, 12, 64
    inner = H * Dh
    eye = torch.eye(Dh, device="cuda")
    for L, S, causal in ((56, 56, False), (10, 10, True), (10, 56, False)):
        q = torch.randn((B, L, inner), generator=g, device="cuda") * 0.1
        k = torch.randn((B, S, inner), generator=g, device="cuda")
        mask = torch.zeros((1, 1, 1, S), device="cuda")
        onehot_v = eye[:S].repeat(1, H).expand(B, S, inner).contiguous()
        keep = attention_keep_mask(B, L, S, H, seed, rate, device="cuda")
        if causal:
            keep = keep & attention._causal_allowed(L, S, "cuda")
        out = attention.fused_attention(q, k, onehot_v, mask, H, causal,
                                        rate=rate, seed=seed)
        got = out.view(B, L, H, Dh)[..., :S].permute(0, 2, 1, 3)
        _expect_zeros(f"fused_attention L{L} S{S}", got, keep)
        onehot_do = eye[:L].repeat(1, H).expand(B, L, inner).contiguous()
        for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            _, _, dv = attention.fused_attention_bwd(
                q.to(dt), k.to(dt), k.to(dt), mask, onehot_do.to(dt), H,
                causal, rate=rate, seed=seed)
            got = dv.float().view(B, S, H, Dh)[..., :L].permute(0, 2, 3, 1)
            _expect_zeros(f"fused_attention_bwd L{L} S{S}", got, keep, tag)
    D = 768
    for N in (300 * 56, 300 * 10):
        ones = torch.ones((N, D), device="cuda")
        for Fh in (3072, 2048):
            keep = keep_mask((N, Fh), 0, seed, rate, device="cuda")
            for off in (0, Fh - D):
                pick = _picking(D, Fh, off)       # (D, F): hidden -> D
                spread = pick.t().contiguous()    # (F, D): D -> hidden
                kept = keep[:, off:off + D]
                if Fh == 3072:
                    b1 = torch.full((Fh,), 1.0, device="cuda")
                    z = torch.zeros(D, device="cuda")
                    # h = relu(0 + 1) = 1: y = the dropped hidden columns
                    y = ffn.fused_ffn(ones, torch.zeros((Fh, D), device="cuda"),
                                      b1, pick, z, "relu", rate, seed)
                    _expect_zeros(f"fused_ffn N{N} F{Fh} off{off}", y, kept)
                    # h = x + 1 > 0, dh = dy . W2 = 1: dx = drop(1) columns
                    dx, _, _ = ffn.fused_ffn_bwd(ones, ones, spread, b1, pick,
                                                 "relu", rate, seed)
                    _expect_zeros(f"fused_ffn_bwd N{N} F{Fh} off{off}", dx,
                                  kept)
                else:
                    # h0 = h1 = 3 on the picked columns, 0 elsewhere
                    x3 = 3.0 * ones
                    y = ffn.fused_gated_ffn(x3, spread, spread, pick,
                                            "gelu_new", rate, seed)
                    _expect_zeros(f"fused_gated_ffn N{N} F{Fh} off{off}", y,
                                  kept)
                    dx = ffn.fused_gated_ffn_bwd(x3, ones, spread, spread,
                                                 pick, "gelu_new", rate, seed)
                    _expect_zeros(f"fused_gated_ffn_bwd N{N} F{Fh} off{off}",
                                  dx, kept)


def grad_case(rep: Report, g, dtype, seed, site: str, B: int, L: int,
              S: int, causal: bool, has_bias: bool, bias_grad: bool,
              timed: bool, rate: float = 0.1) -> None:
    """One backward of the T5 training paths at rate ``rate``: the long
    backward where ``backward_route`` says so (from the forward's dropped
    output and row logsumexp), else A6, against autograd of the plain
    forward -- dq, dk, dv and, with ``bias_grad``, dbias. The library
    yardstick is SDPA's autograd with the mask (and bias, and causal
    triangle) materialised, at rate 0 (SDPA has no hash dropout), its bias
    gradient included where the bias trains; a dbias case runs the kernel
    twice and needs bitwise equal results."""
    randn = randn_fn(g)
    H, Dh = 12, 64
    inner = H * Dh
    e = 2 if dtype == torch.bfloat16 else 4
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    mask = (torch.zeros((1, 1, 1, S), device="cuda") if causal and L == S
            and L < 64 else padding_mask(g, B, S))
    q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
    k, v, do = (randn(B, n, inner, dtype=dtype) for n in (S, S, L))
    bias = (randn(1, H, L, S, dtype=dtype, scale=0.5).float() if has_bias
            else None)
    long = attention.backward_route(L, S, Dh, dtype) == "long"
    if long:
        out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H, causal,
                                                     bias, rate, seed)
        key = ("fused_attention_bwd_long +dbias" if bias_grad
               else "fused_attention_bwd_long +bias +dropout")

        def kernel():
            return attention.fused_attention_bwd_long(
                q, k, v, mask, out, lse, do, H, causal, bias, rate, seed,
                bias_grad)
    else:
        key = "fused_attention_bwd +dbias"

        def kernel():
            return attention.fused_attention_bwd(q, k, v, mask, do, H, causal,
                                                 bias, rate, seed, bias_grad)
    leaves = (q, k, v) + ((bias,) if bias_grad else ())
    plain = _grads_of(lambda *a: attention.fused_attention_reference(
        a[0], a[1], a[2], mask, H, causal, a[3] if bias_grad else bias, rate,
        seed), leaves, do)
    lmask = causal_mask(mask, L, S) if causal else mask
    lib_cot = do.view(B, L, H, Dh).transpose(1, 2)
    if has_bias:
        lib = _grads_of(lambda a, b, c, d: sdpa(a, b, c, lmask + d, H),
                        (q, k, v, bias), lib_cot)
    else:
        lib = _grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H), (q, k, v),
                        lib_cot)
    seen = (attention._causal_allowed(L, S, "cuda").float().mean().item()
            if causal else 1.0)
    nb = 4 * H * L * S * (2 if bias_grad else 1) if has_bias else 0
    label = (f"{tag} {site} B{B} L{L} S{S}" + (" +bias" if has_bias else "")
             + (" causal" if causal else "") + f" rate {rate}")
    if long:  # the forward the long backward starts from, same terms
        fmask = lmask + bias if has_bias else lmask
        rep.check("fused_attention +bias +dropout", label + " +lse",
                  lambda: attention.fused_attention_fwd_lse(
                      q, k, v, mask, H, causal, bias, rate, seed),
                  lambda: attention.fused_attention_lse_reference(
                      q, k, v, mask, H, causal, bias, rate, seed),
                  dtype, iters=10,
                  work=(e * 2 * B * (L + S) * inner + 4 * B * S
                        + 4 * B * H * L + (4 * H * L * S if has_bias else 0),
                        4 * B * H * L * S * Dh * seen),
                  library_fn=lambda: sdpa(q, k, v, fmask, H))
    rep.check(key, label, kernel, plain, dtype, timed=timed,
              work=(e * (3 * B * L + 4 * B * S) * inner + 4 * B * S + nb
                    + (e * B * L * inner + 4 * B * H * L if long else 0),
                    10 * B * H * L * S * Dh * seen),
              library_fn=lib, iters=10 if long else 20, backward=True)
    if bias_grad or long or dtype == torch.bfloat16:
        bitwise_repeat(key, label, kernel)
    del plain, lib


def _t5_video_inputs(g, dtype, B: int, L: int, H: int, Dh: int):
    """q (scale 0.1), k and the (1, H, L, L) bias of the T5 video encoder
    drop-mask checks: logits of O(1), so no kept probability rounds to 0."""
    inner = H * Dh
    q = (torch.randn((B, L, inner), generator=g, device="cuda") * 0.1)
    k = torch.randn((B, L, inner), generator=g, device="cuda")
    bias = torch.randn((1, H, L, L), generator=g, device="cuda") * 0.5
    return q.to(dtype), k.to(dtype), bias


@torch.no_grad()
def check_long_fwd_drop_mask(seed: torch.Tensor, dtype,
                             rate: float = 0.1) -> None:
    """The T5 video encoder shape (B 50, L = S = 604), ``dtype``: A1's
    dropout mask, bit for bit, is ops/hashdrop.py's at every query row (the
    rows past 64 and the ragged last 64-row tile included). Values one-hot
    on the keys c0 .. c0 + 64 (v[j, d] = [j - c0 == d]) give out[i, d] =
    the dropped probability of (i, c0 + d) over the row sum, an exact zero
    where the element is dropped; c0 = 540 spans the last full 64-key tile
    and the ragged one."""
    from vlpet_tpu_torch.ops.hashdrop import attention_keep_mask

    g = torch.Generator(device="cuda").manual_seed(10)
    B, L, H, Dh = 50, 604, 12, 64
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    q, k, bias = _t5_video_inputs(g, dtype, B, L, H, Dh)
    mask = torch.zeros((1, 1, 1, L), device="cuda")
    keep = attention_keep_mask(B, L, L, H, seed, rate, device="cuda")
    cols = torch.arange(Dh, device="cuda")
    for c0 in (0, L - Dh):
        v = torch.zeros((B, L, H, Dh), device="cuda", dtype=dtype)
        v[:, c0 + cols, :, cols] = 1.0
        out = attention.fused_attention(q, k, v.view(B, L, H * Dh), mask, H,
                                        False, bias, rate, seed)
        got = out.view(B, L, H, Dh).permute(0, 2, 1, 3).float()  # (B, H, i, d)
        _expect_zeros(f"fused_attention L=S={L} keys {c0}..{c0 + Dh - 1}",
                      got, keep[..., c0:c0 + Dh], tag)


@torch.no_grad()
def check_long_drop_mask(seed: torch.Tensor, dtype, rate: float = 0.1) -> None:
    """The T5 video encoder shape (B 50, L = S = 604), ``dtype``: the long
    backward's dropout mask, bit for bit, is ops/hashdrop.py's. A cotangent
    one-hot on the 64 query rows r0 .. r0 + 64 (do[i, d] = [i - r0 == d])
    gives dv[j, d] = p_drop[r0 + d, j], so each dropped element is an exact
    zero of dv; r0 = 540 spans the last full 64-row tile and the ragged one,
    where a tile-local row index would part from the global one."""
    from vlpet_tpu_torch.ops.hashdrop import attention_keep_mask

    g = torch.Generator(device="cuda").manual_seed(9)
    B, L, H, Dh = 50, 604, 12, 64
    inner = H * Dh
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    q, k, bias = _t5_video_inputs(g, dtype, B, L, H, Dh)
    mask = torch.zeros((1, 1, 1, L), device="cuda")
    out, lse = attention.fused_attention_fwd_lse(q, k, k, mask, H, False,
                                                 bias, rate, seed)
    keep = attention_keep_mask(B, L, L, H, seed, rate, device="cuda")
    rows = torch.arange(Dh, device="cuda")
    for r0 in (0, L - Dh):
        do = torch.zeros((B, L, H, Dh), device="cuda", dtype=dtype)
        do[:, r0 + rows, :, rows] = 1.0
        _, _, dv = attention.fused_attention_bwd_long(
            q, k, k, mask, out, lse, do.view(B, L, inner), H, False, bias,
            rate, seed)
        got = dv.view(B, L, H, Dh).permute(0, 2, 3, 1).float()  # (B, H, d, j)
        _expect_zeros(f"fused_attention_bwd_long rows {r0}..{r0 + Dh - 1}",
                      got, keep[:, :, r0:r0 + Dh], tag)


def phase_bias_grad_kernels(rep: Report) -> None:
    """3g: the backwards' new modes at the T5 video and trainable-bias
    shapes, bf16 and fp32, rate 0.1 with one seed: the long backward with
    the relative bias and dropout at the T5 video encoder (B 50, L = S =
    604, ragged padding) and cross-attention (L 10 over S 604, dropout
    only), at S 1024 (B 16) and causal at L = S = 604; dbias from A6 at
    the T5 encoder (B 300, L = S = 56) and decoder self-attention (B 300,
    L = S = 10, causal) and from the long backward at the video encoder.
    Then the long backward's dropout mask bit for bit (fp32)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    # site, B, L, S, causal, bias, bias_grad
    cases = (("t5 video enc", 50, 604, 604, False, True, False),
             ("t5 video cross", 50, 10, 604, False, False, False),
             ("enc", 16, 1024, 1024, False, True, False),
             ("causal", 50, 604, 604, True, True, False),
             ("t5 enc dbias", 300, 56, 56, False, True, True),
             ("t5 dec-self dbias", 300, 10, 10, True, True, True),
             ("t5 video enc dbias", 50, 604, 604, False, True, True))
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for site, B, L, S, causal, has_bias, bias_grad in cases:
            timed = main and site in ("t5 video enc", "t5 enc dbias",
                                      "t5 video enc dbias")
            grad_case(rep, g, dtype, seed, site, B, L, S, causal, has_bias,
                      bias_grad, timed)
    for dtype in (torch.bfloat16, torch.float32):
        check_long_fwd_drop_mask(seed, dtype)
        check_long_drop_mask(seed, dtype)


def phase_ffn_ce_sites(rep: Report) -> None:
    """3h: F1 and C1 in bf16 at the rows their paths give them. F1 (D 768,
    F 3072): N 1 and 2501 (ragged), 250 (video beam), 1500 (T5 beam, relu,
    zero biases), 2500 (BART beam), 16800 (T5 train, relu, rate 0.1) and
    28000 (BART encoder), each against its plain twin, against fp32
    arithmetic on its inputs (check_ffn_bf16) and twice, bitwise equal;
    then its dropout mask bit for bit at a split and an unsplit row count.
    C1: the BART (N 5000, V 50265) and T5 (N 3000, V 32100) sites, T5 at a
    ragged N 2999 and D 512 and 1024, loss and lse against the plain twin
    (library F.linear + F.cross_entropy), twice, bitwise equal. Only
    fused_ffn, fused_linear_ce and their twins are called, so the phase
    also times an earlier tree's kernels (chip_phases.py)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    randn = randn_fn(g)
    dtype = torch.bfloat16
    D, Fh = 768, 3072
    w1 = randn(Fh, D, dtype=dtype, scale=0.02)
    w2 = randn(D, Fh, dtype=dtype, scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    z1, z2 = torch.zeros(Fh, device="cuda"), torch.zeros(D, device="cuda")
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    acts = {"gelu": F.gelu, "relu": torch.relu}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for site, N, act, biased, rate in (
            ("ragged", 1, "gelu", True, 0.0),
            ("video beam", 250, "gelu", True, 0.0),
            ("t5 beam", 1500, "relu", False, 0.0),
            ("bart beam", 2500, "gelu", True, 0.0),
            ("ragged", 2501, "gelu", True, 0.0),
            ("t5 train", 16800, "relu", False, 0.1),
            ("bart encoder", 28000, "gelu", True, 0.0)):
        x = randn(N, D, dtype=dtype)
        c1, c2 = (b1, b2) if biased else (z1, z2)
        key = "fused_ffn relu +dropout" if rate else "fused_ffn"
        label = f"bf16 {site} N{N} {act}" + (f" rate {rate}" if rate else "")
        if hasattr(ffn, "f1_splits"):
            label += f" S{ffn.f1_splits(N, D, Fh, sms)[0]}"

        def kernel():
            return ffn.fused_ffn(x, w1, c1, w2, c2, act, rate, seed)
        rep.check(key, label, kernel,
                  lambda: ffn.ffn_reference(x, w1, c1, w2, c2, act, rate,
                                            seed),
                  dtype, work=(2 * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                               4 * N * D * Fh))
        hidden = acts[act](x.float() @ w1.float().t() + c1)
        check_ffn_bf16(label, kernel(), ffn._drop_hidden(hidden, rate, seed),
                       w2, c2)
        bitwise_repeat(key, label, lambda: (kernel(),))
        del x, hidden
    if hasattr(ffn, "f1_tiles"):  # W1 and W2 re-laid out, uncached
        wt = torch.empty(2 * Fh * D, dtype=dtype, device="cuda")
        ms = cuda_ms(lambda: _build.launch(
            "vlpet_ffn_w_tiles", w1.data_ptr(), w2.data_ptr(), wt.data_ptr(),
            D, Fh))
        print(f"  {'fused_ffn':24s} {'bf16 W1, W2 re-laid out (9.4 MB)':34s} "
              f"{ms:.4f} ms, once per layer while the weights live",
              flush=True)
    check_ffn_bf16_mask(seed)
    for label, N, Dc, V, xs, bias, ws in (
            ("bart", 5000, 768, 50265, 1.0, True, 0.02),
            ("t5", 3000, 768, 32100, 768 ** -0.5, False, 1.0),
            ("t5 ragged", 2999, 768, 32100, 768 ** -0.5, False, 1.0),
            ("d512", 3000, 512, 32100, 512 ** -0.5, False, 1.0),
            ("d1024", 2999, 1024, 32100, 1024 ** -0.5, False, 1.0)):
        x = randn(N, Dc, dtype=dtype, scale=xs)
        w = randn(V, Dc, dtype=dtype, scale=ws)
        b = randn(V, scale=0.1) if bias else torch.zeros(V, device="cuda")
        labels = torch.randint(0, V, (N,), generator=g, device="cuda")
        labels = torch.where(torch.rand(N, generator=g, device="cuda") < 0.1,
                             -100, labels)
        name = f"bf16 {label} N{N} D{Dc} V{V}"
        bl = b.to(dtype)

        def kernel():
            return fused_ce.fused_linear_ce(x, w, b, labels)
        rep.check("fused_linear_ce", name, kernel,
                  lambda: fused_ce.fused_linear_ce_reference(x, w, b, labels),
                  dtype, work=(2 * (N * Dc + V * Dc) + 4 * V + 16 * N,
                               2 * N * V * Dc),
                  library_fn=lambda: F.cross_entropy(
                      F.linear(x, w, bl).float(), labels, reduction="none"))
        bitwise_repeat("fused_linear_ce", name, kernel)
        del x, w


@torch.no_grad()
def check_ffn_bf16_mask(seed: torch.Tensor, rate: float = 0.1) -> None:
    """bf16 F1's dropout mask, bit for bit, is ops/hashdrop.py's, where the
    hidden is split over blocks (N 1500, the T5 beam rows) and where it is
    not (N 16800, T5 training): W1 = 0 and b1 = 1 make the hidden 1 before
    the dropout, and picking weights return its columns off .. off + D
    (off 0 and F - D) as y, an exact zero where dropped (check_drop_masks'
    construction, in bf16)."""
    D, Fh = 768, 3072
    bf = torch.bfloat16
    zero_w1 = torch.zeros((Fh, D), device="cuda", dtype=bf)
    ones_b1 = torch.ones(Fh, device="cuda")
    z = torch.zeros(D, device="cuda")
    for N in (1500, 16800):
        ones = torch.ones((N, D), device="cuda", dtype=bf)
        keep = keep_mask((N, Fh), 0, seed, rate, device="cuda")
        for off in (0, Fh - D):
            pick = _picking(D, Fh, off).to(bf)
            y = ffn.fused_ffn(ones, zero_w1, ones_b1, pick, z, "relu", rate,
                              seed)
            _expect_zeros(f"fused_ffn N{N} F{Fh} off{off}", y,
                          keep[:, off:off + D], "bf16")


def gated_bwd_fp32(x, dy, w0, w1, wo, rate, seed) -> torch.Tensor:
    """dx of the gated FFN (gelu_new) in fp32 arithmetic on its bf16
    inputs, with dh0 and dh1 rounded to bf16 where F4 (and the TPU kernel,
    vlpet_tpu/ops/ffn.py:372-373) rounds them."""
    xf = x.float()
    h0 = (xf @ w0.float().t()).requires_grad_()
    h1 = xf @ w1.float().t()
    dg = ffn._drop_hidden(dy.float() @ wo.float(), rate, seed)
    with torch.enable_grad():
        a = ffn.gelu_new(h0)
        (da,) = torch.autograd.grad(a, h0, torch.ones_like(a))
    dh0 = (dg * h1 * da).to(torch.bfloat16).float()
    dh1 = (dg * a.detach()).to(torch.bfloat16).float()
    return dh0 @ w0.float() + dh1 @ w1.float()


def phase_gated_ffn_sites(rep: Report) -> None:
    """3i: F3 and F4 in bf16 at the rows their paths give them
    (t5-v1.1-base: D 768, F 2048, gelu_new). F3: N 1 and 1501 (ragged),
    1500 (T5 beam), 3000 (decoder training rows, rate 0.1), 16800 (encoder
    training rows, rate 0 and 0.1); F4: N 2999 (ragged), 3000 and 16800 at
    rate 0.1, 16800 at rate 0. Each against its plain twin, against fp32
    arithmetic on its own inputs (F3 through check_ffn_bf16, F4 against
    gated_bwd_fp32) and twice, bitwise equal; each line gives the split
    count and the bound. Then the cost of the weight re-lays and both
    dropout masks bit for bit at a split and an unsplit row count. Only
    fused_gated_ffn, fused_gated_ffn_bwd and their twins are called (the
    split rule and the re-lays where the port has them), so the phase also
    times an earlier tree's kernels (chip_phases.py)."""
    g = torch.Generator(device="cuda").manual_seed(10)
    randn = randn_fn(g)
    dtype = torch.bfloat16
    D, Fh = 768, 2048
    w0, w1 = (randn(Fh, D, dtype=dtype, scale=0.02) for _ in range(2))
    wo = randn(D, Fh, dtype=dtype, scale=0.02)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def splits(N):
        if not hasattr(ffn, "gated_splits"):
            return ""
        return f" S{ffn.gated_splits(N, D, Fh, sms)[0]}"

    for site, N, rate in (("ragged", 1, 0.0), ("t5 beam", 1500, 0.0),
                          ("ragged", 1501, 0.0), ("dec train", 3000, 0.1),
                          ("encoder", 16800, 0.0), ("encoder", 16800, 0.1)):
        x = randn(N, D, dtype=dtype)
        key = "fused_gated_ffn +dropout" if rate else "fused_gated_ffn"
        label = (f"bf16 {site} N{N}" + (f" rate {rate}" if rate else "")
                 + splits(N))

        def kernel():
            return ffn.fused_gated_ffn(x, w0, w1, wo, "gelu_new", rate, seed)
        rep.check(key, label, kernel,
                  lambda: ffn.gated_ffn_reference(x, w0, w1, wo, "gelu_new",
                                                  rate, seed),
                  dtype, work=(2 * (2 * N * D + 3 * D * Fh), 6 * N * D * Fh))
        xf = x.float()
        hidden = ffn.gelu_new(xf @ w0.float().t()) * (xf @ w1.float().t())
        check_ffn_bf16(label, kernel(), ffn._drop_hidden(hidden, rate, seed),
                       wo)
        bitwise_repeat(key, label, lambda: (kernel(),))
        del x, xf, hidden
    for site, N, rate in (("ragged", 2999, 0.1), ("dec train", 3000, 0.1),
                          ("encoder", 16800, 0.1), ("encoder", 16800, 0.0)):
        x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
        label = f"bf16 {site} N{N} rate {rate}" + splits(N)

        def kernel():
            return ffn.fused_gated_ffn_bwd(x, dy, w0, w1, wo, "gelu_new",
                                           rate, seed)
        plain = _grads_of(lambda a: ffn.gated_ffn_reference(
            a, w0, w1, wo, "gelu_new", rate, seed), (x,), dy)
        rep.check("fused_gated_ffn_bwd", label, kernel, lambda: plain()[0],
                  dtype, work=(2 * (3 * N * D + 3 * D * Fh),
                               10 * N * D * Fh), backward=True)
        check_bf16_vs_fp32(label, kernel(),
                           gated_bwd_fp32(x, dy, w0, w1, wo, rate, seed))
        bitwise_repeat("fused_gated_ffn_bwd", label, lambda: (kernel(),))
        del x, dy, plain
    if hasattr(ffn, "gated_tiles"):  # the re-lays, uncached
        t = torch.empty(3 * Fh * D, dtype=dtype, device="cuda")
        for name, what in (("vlpet_gated_w_tiles", "F3: W0, W1, Wo"),
                           ("vlpet_gated_bwd_tiles", "F4: Wo^T, W0^T, W1^T")):
            ms = cuda_ms(lambda: _build.launch(
                name, w0.data_ptr(), w1.data_ptr(), wo.data_ptr(),
                t.data_ptr(), D, Fh))
            print(f"  {'fused_gated_ffn':24s} "
                  f"{'bf16 ' + what + ' re-laid (9.4 MB)':34s} {ms:.4f} ms, "
                  f"once per layer while the weights live", flush=True)
    check_gated_bf16_mask(seed)


@torch.no_grad()
def check_gated_bf16_mask(seed: torch.Tensor, rate: float = 0.1) -> None:
    """bf16 F3's and F4's dropout masks, bit for bit, are ops/hashdrop.py's
    where the hidden is split over blocks (N 1500) and where it is not (N
    16800): check_drop_masks' picking weights in bf16. W0 = W1 spread the
    input onto hidden columns off .. off + D (x = 3: h0 = h1 = 3 there, 0
    elsewhere) and Wo picks them back; dy = 1 makes dg 1 on them. So y and
    dx are nonzero exactly where the hidden is kept, at off 0 and F - D."""
    D, Fh = 768, 2048
    bf = torch.bfloat16
    for N in (1500, 16800):
        x3 = torch.full((N, D), 3.0, device="cuda", dtype=bf)
        ones = torch.ones((N, D), device="cuda", dtype=bf)
        keep = keep_mask((N, Fh), 0, seed, rate, device="cuda")
        for off in (0, Fh - D):
            pick = _picking(D, Fh, off).to(bf)  # (D, F): hidden -> D
            spread = pick.t().contiguous()      # (F, D): D -> hidden
            kept = keep[:, off:off + D]
            y = ffn.fused_gated_ffn(x3, spread, spread, pick, "gelu_new",
                                    rate, seed)
            _expect_zeros(f"fused_gated_ffn N{N} F{Fh} off{off}", y, kept,
                          "bf16")
            dx = ffn.fused_gated_ffn_bwd(x3, ones, spread, spread, pick,
                                         "gelu_new", rate, seed)
            _expect_zeros(f"fused_gated_ffn_bwd N{N} F{Fh} off{off}", dx,
                          kept, "bf16")


def ffn_bwd_fp32(x, dy, w1, b1, w2, act, rate, seed):
    """((dx, db1, db2), their allowances) of the FFN in fp32
    arithmetic on its bf16 inputs, with ds rounded to bf16 before the dx
    product where F2 (and the TPU kernel, vlpet_tpu/ops/ffn.py:227-231)
    rounds it; db1 from the fp32 ds. relu' jumps at h = 0, and two fp32
    sums of the same D products in other orders can leave h on either side
    of 0 where |h| is within their rounding: there either side is fp32
    arithmetic. So for relu the reference takes relu' from h in fp64, and
    the allowances bound what taking the other side changes at the
    elements with |h| <= 2^-20 (sum_k |x[n, k] W1[f, k]| + |b1[f]|) (16
    units of fp32 rounding of the terms' magnitude): in dx, sum over those
    f of |dh[n, f]| |W1[f, d]|, in db1 the sum over those n of |dh[n, f]|.
    gelu's derivative is smooth: no allowances (None)."""
    dh = ffn._drop_hidden(dy.float() @ w2.float(), rate, seed)
    allow = (None, None, None)
    if act == "relu":
        xd, wd, bd = x.double(), w1.double(), b1.double()
        h = xd @ wd.t() + bd
        amb = h.abs() <= 2.0 ** -20 * (xd.abs() @ wd.abs().t() + bd.abs())
        ds = dh * (h > 0)
        flip = dh.abs() * amb
        allow = (flip @ w1.float().abs() * (1.0 + 2.0 ** -7), flip.sum(0),
                 None)
        print(f"  {'relu kink':24s} {amb.sum().item()} of {amb.numel()} "
              f"elements of h within fp32 rounding of 0", flush=True)
        del xd, wd, h, amb, flip
    else:
        h = (x.float() @ w1.float().t() + b1).requires_grad_()
        with torch.enable_grad():
            a = F.gelu(h)
            (da,) = torch.autograd.grad(a, h, torch.ones_like(a))
        ds = dh * da
    return (ds.to(torch.bfloat16).float() @ w1.float(), ds.sum(0),
            dy.float().sum(0)), allow


def phase_ffn_bwd_sites(rep: Report) -> None:
    """3j: F2 in bf16 at the rows its paths give it (D 768, F 3072): N 1
    and 2501 (ragged), 500 (video decoder), 3000 (T5 decoder, relu, rate
    0.1), 5000 (BART decoder), 16800 (T5 encoder, relu, rate 0 and 0.1),
    28000 (BART encoder) and 30200 (video encoder), gelu with random biases
    or relu with zero ones. Each against its plain twin (autograd of the
    plain forward), against fp32 arithmetic on its own inputs (dx, db1,
    db2: ffn_bwd_fp32) and twice, bitwise equal; each line gives the split
    count and the bound (F2 reads F1's re-laid weights, whose cost 3h
    prints). Then F2's bf16 dropout mask bit for bit at a split (N 3000)
    and an unsplit (N 16800) row count, and U1's K+V write at the BART and
    T5 beam caches, bf16 and fp32. Only fused_ffn_bwd, the slot writes
    and their twins are called, so the phase also times an earlier tree's
    kernels (chip_phases.py)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    randn = randn_fn(g)
    dtype = torch.bfloat16
    D, Fh = 768, 3072
    w1 = randn(Fh, D, dtype=dtype, scale=0.02)
    w2 = randn(D, Fh, dtype=dtype, scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    z1, z2 = torch.zeros(Fh, device="cuda"), torch.zeros(D, device="cuda")
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tc = not hasattr(ffn, "_ROWS")  # not the WMMA F2 (an earlier port)
    for site, N, act, rate in (
            ("ragged", 1, "gelu", 0.0), ("video decoder", 500, "gelu", 0.0),
            ("ragged", 2501, "gelu", 0.0), ("t5 decoder", 3000, "relu", 0.1),
            ("bart decoder", 5000, "gelu", 0.0),
            ("t5 encoder", 16800, "relu", 0.0),
            ("t5 encoder", 16800, "relu", 0.1),
            ("bart encoder", 28000, "gelu", 0.0),
            ("video encoder", 30200, "gelu", 0.0)):
        x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
        c1, c2 = (b1, b2) if act == "gelu" else (z1, z2)
        key = "fused_ffn_bwd relu +dropout" if rate else "fused_ffn_bwd"
        label = (f"bf16 {site} N{N} {act}" + (f" rate {rate}" if rate else "")
                 + (f" S{ffn.f1_splits(N, D, Fh, sms)[0]}" if tc else ""))

        def kernel():
            return ffn.fused_ffn_bwd(x, dy, w1, c1, w2, act, rate, seed)
        plain = _grads_of(lambda a, c, d: ffn.ffn_reference(
            a, w1, c, w2, d, act, rate, seed), (x, c1, c2), dy)
        rep.check(key, label, kernel, plain, dtype,
                  work=(2 * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                        6 * N * D * Fh), backward=True)
        refs, allows = ffn_bwd_fp32(x, dy, w1, c1, w2, act, rate, seed)
        for name, got, ref, allow in zip(("dx", "db1", "db2"), kernel(),
                                         refs, allows):
            check_bf16_vs_fp32(f"{label} {name}", got, ref, allow)
        del refs, allows
        bitwise_repeat(key, label, kernel)
        del x, dy, plain
    check_ffn_bwd_bf16_mask(seed)
    for dt in (torch.bfloat16, torch.float32):
        for rows, label in ((2500, "bart beam"), (1500, "t5 beam")):
            u1_case(rep, g, dt, rows, D, 40, 20, label, timed=False)


@torch.no_grad()
def check_ffn_bwd_bf16_mask(seed: torch.Tensor, rate: float = 0.1) -> None:
    """bf16 F2's dropout mask, bit for bit, is ops/hashdrop.py's where the
    hidden is split over blocks (N 3000, the T5 decoder rows) and where it
    is not (N 16800): check_drop_masks' picking weights in bf16. W1 spreads
    x = 1 onto hidden columns off .. off + D, b1 = 1 keeps relu' at 1, and
    W2 picks dy = 1 back onto them, so dx = drop(dh) . W1 holds the dropped
    columns: an exact zero where dropped, at off 0 and F - D."""
    D, Fh = 768, 3072
    bf = torch.bfloat16
    ones_b1 = torch.ones(Fh, device="cuda")
    for N in (3000, 16800):
        ones = torch.ones((N, D), device="cuda", dtype=bf)
        keep = keep_mask((N, Fh), 0, seed, rate, device="cuda")
        for off in (0, Fh - D):
            pick = _picking(D, Fh, off).to(bf)  # (D, F): hidden -> D
            spread = pick.t().contiguous()      # (F, D): D -> hidden
            dx, _, _ = ffn.fused_ffn_bwd(ones, ones, spread, ones_b1, pick,
                                         "relu", rate, seed)
            _expect_zeros(f"fused_ffn_bwd N{N} F{Fh} off{off}", dx,
                          keep[:, off:off + D], "bf16")


def beam_tree_anc(g, B: int, K: int, Lc: int, pos: int) -> torch.Tensor:
    """The ancestry a beam search holds at step ``pos``: at each step t
    every beam's own row is written into slot t, then (t < pos) every beam
    picks a random parent among the K and takes over its history, as
    models/generate.py beam_generate does with _gather_beams. Slots past
    ``pos`` are never read. int64, (B, K, Lc)."""
    own = torch.arange(K, device="cuda")
    anc = own[None, :, None].expand(B, K, Lc).clone()
    for t in range(pos + 1):
        anc[:, :, t] = own
        if t < pos:
            parents = torch.randint(0, K, (B, K), generator=g, device="cuda")
            anc = torch.gather(anc, 1, parents[:, :, None].expand(B, K, Lc))
    return anc


def beam_attend_fp32(qb, kc, vc, anc, P: int, bias_row, rounds_p: bool,
                     own=None) -> torch.Tensor:
    """D1 (``own`` None: slots t < P = pos + 1) or D2 (``own`` = (k_new,
    v_new, own_bias): slots t < P = pos plus the own row, its products
    rounded to the compute dtype) in fp32 arithmetic on the same inputs:
    each beam's rows gathered through the ancestry, one softmax, the
    probabilities rounded to the compute dtype before P.V where the kernel
    rounds them (``rounds_p``). Returns fp32 (B*K, 1, H*Dh) and, per
    output element, the largest probability of its row times the largest
    |v| it reads (check_beam_fp32's allowance for one flipped p)."""
    B, K, Lc = anc.shape
    H, Dh = qb.shape[-2:]
    J = kc.shape[1] // B
    rows = (torch.arange(B, device="cuda")[:, None, None] * J
            + anc[:, :, :P].long())
    t = torch.arange(P, device="cuda")[None, None, :]
    ks = kc.view(Lc, B * J, H, Dh)[t, rows].float()  # (B, K, P, H, Dh)
    vs = vc.view(Lc, B * J, H, Dh)[t, rows].float()
    q = qb.reshape(B, K, H, Dh)
    s = torch.einsum("bkhd,bkphd->bkhp", q.float(), ks)
    if bias_row is not None:
        s = s + bias_row.float().reshape(H, Lc)[None, None, :, :P]
    if own is None:
        m, e_own = s.amax(-1), None
    else:
        kn, vn, ob = own
        s_own = (q * kn.reshape(B, K, H, Dh)).float().sum(-1)  # (B, K, H)
        if ob is not None:
            s_own = s_own + ob.float()
        m = torch.maximum(s.amax(-1), s_own) if P else s_own
    e = torch.exp(s - m[..., None])
    denom = e.sum(-1)
    if own is not None:
        e_own = torch.exp(s_own - m)
        denom = denom + e_own
    p = e / denom[..., None]
    if rounds_p:
        p = p.to(qb.dtype).float()
    out = torch.einsum("bkhp,bkphd->bkhd", p, vs)
    if own is not None:
        out = out + (e_own / denom)[..., None] * vn.reshape(
            B, K, H, Dh).float()
    pv = (p.amax(-1) if P else torch.zeros_like(m)) * (
        vs.abs().amax(dim=(2, 4)) if P else 0.0)  # (B, K, H)
    return (out.reshape(B * K, 1, H * Dh),
            pv[..., None].expand(B, K, H, Dh).reshape(B * K, 1, H * Dh))


def check_beam_fp32(key: str, label: str, got: torch.Tensor,
                    ref: tuple) -> None:
    """|got - ref| <= BEAM_FP32_RTOL (|ref| + pmax vmax) elementwise, ``ref``
    beam_attend_fp32's (output, pmax vmax): a row read for another beam or
    slot moves an output by p |v - v'|, which the plain twin's 2e-2 (1 +
    |plain|) can miss and this cannot."""
    ref, pv = ref
    err = (got.float() - ref).abs()
    tol = BEAM_FP32_RTOL * (ref.abs() + pv)
    worst = (err / tol).max().item()
    if not torch.isfinite(got).all() or not worst <= 1.0:
        raise AssertionError(f"{key} {label}: against fp32 arithmetic on its "
                             f"inputs, max |err| / tol {worst:.3f}")
    print(f"  {'bf16 vs fp32 arithmetic':24s} {label:34s} max|err|/tol "
          f"{worst:.3f}", flush=True)


def back_to_back_ms(fn, n: int = 20) -> float:
    """Milliseconds per call of ``n`` calls between one event pair (the
    host enqueues while the card runs: the host's share drops out where
    the device is the slower)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


PROFILE_TRIES = 5  # profiled windows device_by_kernel takes at most


def device_by_kernel(fn, n: int = 20) -> dict:
    """Device ms per call of each kernel (by its profiler name) that fn()
    launches, from torch.profiler over ``n`` calls. The profiler now and
    then records no kernel, or only some, of a window (PERF.md §7): a
    window counts only where every kernel of one profiled call appears n
    times as often, else both are profiled again (PROFILE_TRIES in all;
    then this raises)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(calls: int):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type != DeviceType.CPU]
        key = ("self_device_time_total" if events and hasattr(
            events[0], "self_device_time_total") else "self_cuda_time_total")
        return ({ev.key: getattr(ev, key) / 1e3 / calls for ev in events},
                {ev.key: ev.count for ev in events})

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        _, once = window(1)
        by, counts = window(n)
        if once and counts == {k: n * c for k, c in once.items()}:
            return by
    raise AssertionError(f"torch.profiler recorded no complete window of "
                         f"{n} calls in {PROFILE_TRIES} tries")


def device_ms(fn, pick, n: int = 20) -> tuple:
    """(device ms of the kernels whose lower-case name ``pick`` accepts,
    of every kernel of the call) per call, from torch.profiler over ``n``
    calls."""
    by = device_by_kernel(fn, n)
    return (sum(ms for k, ms in by.items() if pick(k.lower())),
            sum(by.values()))


def kernel_name(key: str) -> str:
    """A profiler kernel name without its return type, namespace, template
    arguments and parameters: "void (anonymous
    namespace)::ln_bwd_vec<__nv_bfloat16, 24>(..)" -> "ln_bwd_vec"."""
    head = key.replace("(anonymous namespace)::", "")
    return head.split("<")[0].split("(")[0].split("::")[-1].split(" ")[-1]


def beam_case(rep: Report, g, site: str, B: int, Lc: int, pos: int,
              bias: bool, tree: bool, rounds_p: bool) -> None:
    """D1 and D2 in bf16 at one step (K 5, H 12, Dh 64): against the plain
    twin, against fp32 arithmetic on their own inputs, twice bitwise
    equal; D2's slot ``pos`` written exactly and every other slot
    unchanged, bit for bit. Prints the per-call event time, the
    back-to-back time, the device time, the plain twin's, SDPA's (the
    ancestry mask materialised) and the bound, with the distinct rows
    this ancestry reads."""
    randn = randn_fn(g)
    dtype = torch.bfloat16
    K, H, Dh = 5, 12, 64
    inner = H * Dh
    qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
    kc = randn(Lc, B * K, inner, dtype=dtype)
    vc = randn(Lc, B * K, inner, dtype=dtype)
    kn = randn(B * K, 1, inner, dtype=dtype)
    vn = randn(B * K, 1, inner, dtype=dtype)
    if tree:
        anc = beam_tree_anc(g, B, K, Lc, pos)
    else:
        anc = torch.randint(0, K, (B, K, Lc), generator=g, device="cuda")
        anc[:, :, pos] = torch.arange(K, device="cuda")
    row = own = None
    if bias:  # T5's layout: compute_bias_row's permuted (1, H, 1, L) view
        row = randn(1, Lc, H).permute(2, 0, 1)[None]
        own = row[0, :, 0, pos]
    label = (f"bf16 {site} B{B} L{Lc} pos{pos} "
             f"{'tree' if tree else 'uniform'}")
    for key, P in (("beam_decode_attend", pos + 1),
                   ("beam_decode_attend_update", pos)):
        update = key == "beam_decode_attend_update"
        # distinct (b, t, row) this step reads: each one K and one V row
        rows = (F.one_hot(anc[:, :, :P], K).amax(dim=1).sum().item()
                if P else 0)
        work = (2 * ((6 if update else 2) * B * K * inner + 2 * rows * inner)
                + anc.element_size() * B * K * P
                + (4 * H * (P + update) if bias else 0),
                4 * B * K * H * (pos + 1) * Dh)
        if update:
            kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()

            def kernel():
                return decode.beam_decode_attend_update(qb, kk, vk, kn, vn,
                                                        anc, pos, own, row)

            def plain():
                return decode.beam_decode_attend_update_reference(
                    qb, kp, vp, kn, vn, anc, pos, own, row)
            kernel()
            plain()
            torch.cuda.synchronize()
            others = [t for t in range(Lc) if t != pos]
            for name, got, want, old, new in (("k", kk, kp, kc, kn),
                                              ("v", vk, vp, vc, vn)):
                if not (torch.equal(got[pos], new.reshape(B * K, inner))
                        and torch.equal(got[others], old[others])
                        and torch.equal(got, want)):
                    raise AssertionError(f"{key} {label}: the {name} cache "
                                         f"is not the old one with slot "
                                         f"{pos} written")
            fp32 = beam_attend_fp32(qb, kc, vc, anc, P, row, rounds_p,
                                    (kn, vn, own))
            library = beam_sdpa(qb, kk, vk, anc, pos, dtype, row)
        else:
            def kernel():
                return decode.beam_decode_attend(qb, kc, vc, anc, pos, row)

            def plain():
                return decode.beam_decode_attend_reference(qb, kc, vc, anc,
                                                           pos, row)
            fp32 = beam_attend_fp32(qb, kc, vc, anc, P, row, rounds_p)
            library = beam_sdpa(qb, kc, vc, anc, pos, dtype, row)
        rep.check(key, label, kernel, plain, dtype, work=work,
                  library_fn=library)
        ms, pms, lms = rep.last
        check_beam_fp32(key, label, kernel(), fp32)
        del fp32
        bitwise_repeat(key, label, lambda: (kernel(),))
        b2b = back_to_back_ms(kernel)
        dev, dev_call = device_ms(
            kernel, lambda name: "beam_attend" in name
            and ("update" in name) == update)
        bms, _ = bound(*work, dtype)
        route = (f", route {decode.beam_route(K, Dh, dtype)}"
                 if hasattr(decode, "beam_route") else "")
        print(f"  {key:24s} {label:34s} per call {ms:.4f} ms, back to back "
              f"{b2b:.4f}, device {dev:.4f} (the call's kernels "
              f"{dev_call:.4f}), plain {pms:.4f}, SDPA {lms:.4f}, bound "
              f"{bms:.4f} ({rows} distinct rows){route}", flush=True)


def phase_beam_sites(rep: Report) -> None:
    """3k: D1 and D2 in bf16 at the rows their paths give them (K 5, H 12,
    Dh 64): BART B 500, L 40 at pos 0, 20 and 39; T5 B 300 with the bias
    row (and the own bias: its column pos, for D2) at pos 39, in T5's
    strided layout; the video eval B 50, L 20 at pos 19; and L 160 at pos
    159 (B 50), a cache of more slots than the kernel stages at once. Each
    under the smoke's uniform ancestry and a beam-tree one (beam_tree_anc),
    by beam_case. Only the two wrappers, their twins and
    beam_selection_mask are called, so the phase also times an earlier
    tree's kernels (chip_phases.py); there, whose kernel keeps p in fp32,
    the fp32 arithmetic keeps it too."""
    g = torch.Generator(device="cuda").manual_seed(13)
    rounds_p = hasattr(decode, "beam_plan")
    for site, B, Lc, pos, bias in (("bart", 500, 40, 0, False),
                                   ("bart", 500, 40, 20, False),
                                   ("bart", 500, 40, 39, False),
                                   ("t5 +bias", 300, 40, 39, True),
                                   ("video", 50, 20, 19, False),
                                   ("long", 50, 160, 159, False)):
        for tree in (False, True):
            beam_case(rep, g, site, B, Lc, pos, bias, tree, rounds_p)


# phase 3l: T1 and T2 at the sites their paths give them, (site, R, V, k):
# the beam evals (R = B x 5), T2's row of PERF.md, the greedy evals (R =
# B), k 16 at a ragged R; and two short vocabularies (one group a row)
TOPK_SITES = (("bart beam", 2500, 50265, 10), ("t5 beam relu", 1500, 32100, 10),
              ("t5 beam gated", 1500, 32128, 10),
              ("video beam", 250, 50265, 10), ("T2 row", 2500, 50265, 1),
              ("bart greedy", 500, 50265, 1), ("t5 greedy", 300, 32100, 1),
              ("k16 ragged", 1, 50265, 16), ("k16 ragged", 2501, 50265, 16),
              ("short V", 2501, 1001, 10), ("short V", 7, 37, 16))


def phase_topk_sites(rep: Report) -> None:
    """3l: topk_lse (T1; T2 at k 1) at TOPK_SITES, each on randn logits,
    on check_topk's ties (2000 levels: every top value tied ~25 ways) and
    on rows with half their entries at -inf, row 0 all -inf. Values and
    indices exactly the stable sort's, lse within TOPK_LSE_TOL (-inf where
    the plain twin gives -inf), every case twice bitwise equal. Each prints
    the per-call event time, the time per call of 20 back to back, the
    device time per call (torch.profiler), the plain twin's, the two-call
    yardstick torch.topk + torch.logsumexp (its indices are not compared:
    torch.topk leaves the order of ties unspecified) and the bound. Only
    topk_lse and its twin are called, so chip_phases.py also times an
    earlier tree's kernel here."""
    g = torch.Generator(device="cuda").manual_seed(14)
    for site, R, V, kk in TOPK_SITES:
        randn = torch.randn((R, V), generator=g, device="cuda")
        inputs = {
            "randn": randn,
            "ties": torch.randint(-1000, 1000, (R, V), generator=g,
                                  device="cuda").float() / 100.0,
            "-inf": torch.where(torch.rand((R, V), generator=g, device="cuda")
                                < 0.5, -math.inf, randn),
        }
        inputs["-inf"][0] = -math.inf
        for cname, x in inputs.items():
            topk_case(rep, site, cname, x, kk)
        del inputs, randn


def topk_case(rep: Report, site: str, cname: str, x: torch.Tensor,
              kk: int) -> None:
    R, V = x.shape
    label = f"{site} {cname} R{R} V{V} k{kk}"
    got = topk.topk_lse(x, kk)
    again = topk.topk_lse(x, kk)
    want = topk.topk_lse_reference(x, kk)
    torch.cuda.synchronize()
    worst = topk_exact(label, got, want)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"topk_lse {label}: two runs differ")
    rep.err["topk_lse"] = max(rep.err["topk_lse"], worst)

    def kernel():
        return topk.topk_lse(x, kk)
    ms = cuda_ms(kernel)
    b2b = back_to_back_ms(kernel)
    dev, dev_call = device_ms(kernel, lambda name: "topk" in name)
    pms = cuda_ms(lambda: topk.topk_lse_reference(x, kk))
    two = cuda_ms(lambda: (torch.topk(x, kk), torch.logsumexp(x, dim=-1)))
    bms, by = bound(4 * R * V + 4 * R * (2 * kk + 1), 4 * R * V,
                    torch.float32)
    print(f"  {'topk_lse':24s} {label:42s} exact, lse max|err| {worst:.3e}, "
          f"bitwise twice; per call {ms:.4f} ms, back to back {b2b:.4f}, "
          f"device {dev:.4f} (the call's kernels {dev_call:.4f}), plain "
          f"{pms:.4f}, two calls {two:.4f}, bound {bms:.4f} ({by})",
          flush=True)


# phase 3m: L1 and L2 at the sites their paths give them, (site, N, D,
# dtype, rates, h's offset in elements): the image-text step's encoder (B
# 500 x S 56) and decoder (x 10 targets) rows, the video step's (B 50 x S
# 604, x 10), ragged N, D 1024, the second route twice (a D whose bf16
# rows are not a multiple of 16 bytes; an h not on 16 bytes, at the
# encoder rows, where a warp takes several rows) and fp32 at the encoder
# rows
LN_SITES = (("image enc", 28000, 768, torch.bfloat16, (0.1, 0.0), 0),
            ("image dec", 5000, 768, torch.bfloat16, (0.1, 0.0), 0),
            ("video enc", 30200, 768, torch.bfloat16, (0.1, 0.0), 0),
            ("video dec", 500, 768, torch.bfloat16, (0.1, 0.0), 0),
            ("ragged", 28001, 768, torch.bfloat16, (0.1,), 0),
            ("ragged", 1, 768, torch.bfloat16, (0.1,), 0),
            ("D 1024", 5000, 1024, torch.bfloat16, (0.1,), 0),
            ("D 100", 61, 100, torch.bfloat16, (0.1,), 0),
            ("misaligned", 28000, 768, torch.bfloat16, (0.1,), 1),
            ("fp32 enc", 28000, 768, torch.float32, (0.1,), 0))


def phase_ln_sites(rep: Report) -> None:
    """3m: L1 and L2 (fused_dropout_add_ln and its backward) at LN_SITES,
    by ln_case. Only the two wrappers and their twin are called, so
    chip_phases.py also times an earlier tree's kernels here (route "n/a"
    where its port does not count routes)."""
    g = torch.Generator(device="cuda").manual_seed(15)
    for site, N, D, dtype, rates, offset in LN_SITES:
        for rate in rates:
            ln_case(rep, g, site, N, D, dtype, rate, offset)


def ln_case(rep: Report, g, site: str, N: int, D: int, dtype,
            rate: float, offset: int = 0) -> None:
    """L1 and L2 at one site against the plain twin (the backward against
    its autograd) at TOL, bf16 twice bitwise equal (dgamma and dbeta
    too), bf16 with dropout: L2's mask by _expect_zeros; h a view
    ``offset`` elements into its buffer. Each prints the route taken (the
    second, "scalar", exactly where bf16 rows are not a multiple of 16
    bytes or h is not on 16 bytes), the per-call event time, the time per call of
    20 back to back, the device time per call by kernel (torch.profiler),
    the plain twin's, the two-call yardstick at rate 0 (F.layer_norm(res +
    h) for L1, its autograd for L2: not the same function, so not a
    library row) and the bound."""
    randn = randn_fn(g)
    h = randn(N * D + offset, dtype=dtype)[offset:].view(N, D)
    res, dy = (randn(N, D, dtype=dtype) for _ in range(2))
    gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    label = f"{tag} {site} N{N} D{D} rate {rate}"
    e = h.element_size()
    want_route = "scalar" if D * e % 16 or offset * e % 16 else "vec"
    gl, bl = gamma.to(dtype), beta.to(dtype)

    def fwd():
        return fused_ln.fused_dropout_add_ln(h, res, gamma, beta, seed, rate)

    def bwd():
        return fused_ln.fused_dropout_add_ln_bwd(h, res, gamma, seed, dy,
                                                 rate)
    plain_bwd = _grads_of(
        lambda a, b, c, d: fused_ln.fused_dropout_add_ln_reference(
            a, b, c, d, seed, rate), (h, res, gamma, beta), dy)
    two_bwd = _grads_of(lambda a, b, c, d: F.layer_norm(a + b, (D,), c, d),
                        (res, h, gl, bl), dy)
    cases = (("fused_dropout_add_ln", fwd,
              lambda: fused_ln.fused_dropout_add_ln_reference(
                  h, res, gamma, beta, seed, rate),
              lambda: F.layer_norm(res + h, (D,), gl, bl),
              (e * 3 * N * D + 4 * (2 * D + 1), 8 * N * D), False),
             ("fused_dropout_add_ln_bwd", bwd, plain_bwd, two_bwd,
              (e * 5 * N * D + 4 * (3 * D + 1), 16 * N * D), True))
    for key, kernel, plain, two, work, backward in cases:
        before = route_counts()
        got = kernel()
        took = [k.split("[")[1].rstrip("]") for k, n in route_counts().items()
                if k.startswith(key + "[") and n > before[k]]
        want = plain()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        err = max(compare(f"{key} {label}", a, b, dtype, backward)
                  for a, b in zip(got, want))
        rep.err[key] = max(rep.err[key], err)
        route = took[0] if took else "n/a"
        if took and took != [want_route]:
            raise AssertionError(f"{key} {label}: launched on {took}, "
                                 f"expected {want_route}")
        if dtype == torch.bfloat16:
            bitwise_repeat(key, label,
                           lambda: kernel() if backward else (kernel(),))
        ms = cuda_ms(kernel)
        b2b = back_to_back_ms(kernel)
        by = device_by_kernel(kernel)
        dev = sum(by.values())
        names = ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in by.items())
        pms = cuda_ms(plain)
        tms = cuda_ms(two)
        bms, bby = bound(*work, dtype)
        print(f"  {key:24s} {label:34s} max|err| {err:.3e}, route {route}; "
              f"per call {ms:.4f} ms, back to back {b2b:.4f}, device "
              f"{dev:.4f} ({names}), plain {pms:.4f}, two calls {tms:.4f}, "
              f"bound {bms:.4f} ({bby})", flush=True)
    if dtype == torch.bfloat16 and rate > 0:
        dh, dres, _, _ = bwd()
        keep = keep_mask(h.shape, 0, seed, rate)
        _expect_zeros(f"fused_dropout_add_ln_bwd {label}", dh,
                      keep & (dres != 0), "bf16")


def make_batch(B: int, vocab: int, seed: int, pad: int = 1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, vocab, (B, 20), generator=g, device="cuda")
    mask = torch.ones((B, 20), dtype=torch.long, device="cuda")
    # ragged text lengths: pad the tail of every other example
    mask[1::2, 14:] = 0
    ids = torch.where(mask.bool(), ids, pad)
    return dict(input_ids=ids, attention_mask=mask,
                vis_feats=torch.randn((B, 36, 2048), generator=g, device="cuda"),
                boxes=torch.rand((B, 36, 4), generator=g, device="cuda"))


def make_video_batch(B: int, vocab: int, seed: int, pad: int = 1):
    """The video recipe's inputs: 540 text tokens (every other example
    padded after 400) and 64 frames of 512-d CLIP-ViT features with zero
    boxes, as vlpet_tpu/data/features.py:NpzVideoSource gives them: S 604."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, vocab, (B, 540), generator=g, device="cuda")
    mask = torch.ones((B, 540), dtype=torch.long, device="cuda")
    mask[1::2, 400:] = 0
    ids = torch.where(mask.bool(), ids, pad)
    return dict(input_ids=ids, attention_mask=mask,
                vis_feats=torch.randn((B, 64, 512), generator=g, device="cuda"),
                boxes=torch.zeros((B, 64, 4), device="cuda"))


def add_targets(batch, B: int, vocab: int, seed: int, scores: bool):
    """10 target tokens (padded with -100 on every third example) and, for
    VQA, answer scores."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    targets = torch.randint(3, vocab, (B, 10), generator=g, device="cuda")
    targets[::3, 7:] = -100
    batch["target_ids"] = targets
    if scores:
        batch["scores"] = torch.rand((B,), generator=g, device="cuda")
    return batch


def make_train_batch(B: int, vocab: int, seed: int):
    """The decode batch plus targets and VQA answer scores."""
    return add_targets(make_batch(B, vocab, seed), B, vocab, seed, True)


def make_video_train_batch(B: int, vocab: int, seed: int):
    return add_targets(make_video_batch(B, vocab, seed), B, vocab, seed, False)


def build_model(dtype: str, cfg_fn=flagship_cfg):
    """The model of ``cfg_fn(dtype)`` at full width (BART-base +
    VL-PET-large, image-text or video, or T5), with the JAX package's
    seeded init scheme (BART: normal(0, 0.02) weights; T5: its Mesh-TF
    scheme, ``VLT5.init_weights``)."""
    cfg = cfg_fn(dtype)
    model = (VLT5 if cfg.is_t5 else VLBart)(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(1234))
    return model


def t5_gated_cfg(dtype: str):
    return t5_cfg(dtype, gated=True)


@torch.no_grad()
def spread_weights(model, seed: int):
    """Seeded weights at the scale of tests/test_torch_slice.py: normal(0,
    0.2) everywhere, LayerNorm scales 1 + normal(0, 0.1). At the 0.02 init
    the best hypothesis of each row repeats two or three token ids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=g, device="cuda")
        p.copy_(1.0 + 0.1 * noise if name.endswith(".scale") else 0.2 * noise)
    return model


def wrappers():
    return {"fused_attention": attention.fused_attention,
            "fused_attention_bwd": attention.fused_attention_bwd,
            "fused_attention_bwd_long": attention.fused_attention_bwd_long,
            "fused_ffn": ffn.fused_ffn,
            "fused_ffn_bwd": ffn.fused_ffn_bwd,
            "fused_dropout_add_ln": fused_ln.fused_dropout_add_ln,
            "fused_dropout_add_ln_bwd": fused_ln.fused_dropout_add_ln_bwd,
            "beam_decode_attend": decode.beam_decode_attend,
            "topk_lse": topk.topk_lse,
            "fused_gated_ffn": ffn.fused_gated_ffn,
            "fused_gated_ffn_bwd": ffn.fused_gated_ffn_bwd,
            "fused_linear_ce": fused_ce.fused_linear_ce,
            "fused_linear_ce_bwd": fused_ce.fused_linear_ce_bwd,
            "beam_decode_attend_update": decode.beam_decode_attend_update,
            "cache_slot_update": cache_update.cache_slot_update}


def counters():
    """name -> (wrapper, attribute) of every launch counter: each wrapper's
    ``launches`` and the backwards' dbias mode counters."""
    out = {k: (fn, "launches") for k, fn in wrappers().items()}
    for k in ("fused_attention_bwd", "fused_attention_bwd_long"):
        out[f"{k}.dbias"] = (wrappers()[k], "dbias_launches")
    return out


# the wrappers that count their launches by route -> (the bf16 bench
# route, the second route): A1 and the long backward by
# ops.attention.forward_route, A6 by ops.attention.a6_route, L1 and L2 by
# ops.fused_ln.ln_plan
ROUTED = {"fused_attention": ("tc", "fma"),
          "fused_attention_bwd_long": ("tc", "fma"),
          "fused_attention_bwd": ("tc", "fma"),
          "fused_dropout_add_ln": ("vec", "scalar"),
          "fused_dropout_add_ln_bwd": ("vec", "scalar")}


def _by_route(k: str) -> dict:
    """The wrapper's launches per route ({} where an earlier tree's port
    does not count them: chip_phases.py)."""
    return getattr(wrappers()[k], "launches_by_route", {})


def route_counts() -> dict:
    """"name[route]" -> launches, for the routed wrappers."""
    return {f"{k}[{r}]": n for k in ROUTED for r, n in _by_route(k).items()}


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    for k in ROUTED:
        _by_route(k).update(dict.fromkeys(_by_route(k), 0))


def any_launched() -> bool:
    return any(getattr(fn, attr) for fn, attr in counters().values())


def read_counts(path: str):
    """Launch counts since the last reset; raises if a kernel of ``path``
    (a path of KERNELS) was never launched."""
    got = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    missing = [k for k, (_, _, paths) in KERNELS.items()
               if path in paths and got[wrapper_of(k)] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")
    return {**got, **route_counts()}


def require_tc(path: str, launched: dict) -> None:
    """A bf16 bench run (every Dh 64, every A6 site L, S <= 64, every
    LayerNorm row 16-byte aligned): A1, A6 and the long backward launched
    on the tensor-core route only, L1 and L2 on the vector route only."""
    off = {f"{k}[{second}]": launched[f"{k}[{second}]"]
           for k, (_, second) in ROUTED.items()
           if launched.get(f"{k}[{second}]")}
    if off:
        raise AssertionError(f"{path}: bf16 launches on a second route {off}")


def routed_share(model: VLBart, run):
    """run() while recording, at each beam step, the share of cache slots
    up to the step that a beam reads from another beam's physical row
    (anc[b, k, t] != k). Returns (run's result, the last step's share)."""
    shares = []
    step = model.decode_step_topk

    def spy(tok, joint_mask, consts, cache, pos, k, ctx=None, beam_anc=None):
        if beam_anc is not None:
            own = torch.arange(beam_anc.shape[1], device=beam_anc.device)
            shares.append((beam_anc[:, :, :pos + 1] != own[None, :, None])
                          .float().mean())
        return step(tok, joint_mask, consts, cache, pos, k, ctx, beam_anc)

    model.decode_step_topk = spy
    try:
        out = run()
    finally:
        del model.decode_step_topk
    return out, shares[-1].item()


def parity_run(label: str, model: VLBart, batch, ctx: PetContext,
               max_length: int, min_distinct: int,
               min_routed: float = MIN_ROUTED_SHARE) -> None:
    """Beam 5 and greedy to ``max_length`` through the kernels and through
    the plain twins: the tokens must be identical. Returns the kernels'
    (beam-5, greedy) tokens."""
    with torch.inference_mode():
        enc, _ = model.encode(**batch, ctx=ctx)
        with plain_twins():
            enc_plain, _ = model.encode(**batch, ctx=ctx)
    enc_rel = ((enc - enc_plain).abs().max() / enc_plain.abs().max()).item()

    def beam5():
        return seq2seq_generate(model, **batch, ctx=ctx, num_beams=5,
                                max_length=max_length)

    got, routed = routed_share(model, beam5)
    beam = got
    with plain_twins():
        want = beam5()
    if not torch.equal(got, want):
        rows = (got != want).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: fp32 beam-5 tokens differ between "
                             f"kernels and plain in rows {rows}:\n"
                             f"{got[rows]}\n{want[rows]}")
    per_row = [len(set(r)) for r in got[:, 1:].tolist()]
    if routed < min_routed or min(per_row) < min_distinct:
        raise AssertionError(f"{label}: degenerate beam search: routed share "
                             f"{routed:.3f} (need >= {min_routed}), "
                             f"distinct ids per row {per_row} (need >= "
                             f"{min_distinct}):\n{got}")
    print(f"  {label}: encoder max|kernel - plain| / max|plain| "
          f"{enc_rel:.2e}; beam5 tokens identical (kernel vs plain), "
          f"cache slots read across beams {routed:.3f}, distinct ids per "
          f"row {per_row}", flush=True)
    print(f"    sample: {got[0].tolist()}", flush=True)
    # greedy: L = 1 cross-attention and k = 1 top-k (T2) through the
    # kernels; T2's launches counted over the run
    t2 = topk.topk_lse.launches
    got = seq2seq_generate(model, **batch, ctx=ctx, num_beams=1,
                           max_length=max_length)
    t2 = topk.topk_lse.launches - t2
    with plain_twins():
        want = seq2seq_generate(model, **batch, ctx=ctx, num_beams=1,
                                max_length=max_length)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: fp32 greedy tokens differ between "
                             f"kernels and plain")
    print(f"  {label}: greedy tokens identical (kernel vs plain); top-k "
          f"launches (T2, k = 1) {t2} over {max_length - 1} steps",
          flush=True)
    return beam, got


def phase_parity() -> None:
    ctx = PetContext(task="caption", task_idx=3)
    # (a) the full model at the JAX package's init scale
    model = build_model("float32")
    parity_run("6+6 layers, init std 0.02", model,
               make_batch(8, model.cfg.backbone.vocab_size, seed=7), ctx, 40,
               min_distinct=2)
    # (b) weights at the slice test's scale, which decode varied tokens. At
    # full depth a random model at this scale is chaotic: fp32 round-off
    # of any two summation orders grows to O(1) over the encoder layers,
    # so token parity there would test the random model, not the kernels.
    # One layer each keeps the round-off small and every kernel on the path.
    parity_run("1+1 layers, std 0.2", spread_model(flagship_cfg),
               make_batch(8, model.cfg.backbone.vocab_size, seed=7), ctx, 40,
               min_distinct=MIN_DISTINCT_PER_ROW)


def spread_model(cfg_fn):
    """fp32, one encoder and one decoder layer, weights at std 0.2."""
    cfg = cfg_fn("float32")
    b = cfg.backbone
    one = (dict(num_layers=1, num_decoder_layers=1) if cfg.is_t5
           else dict(encoder_layers=1, decoder_layers=1))
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(b, **one))
    return spread_weights((VLT5 if cfg.is_t5 else VLBart)(cfg, device="cuda"),
                          seed=1234)


def generate_bench(card: str, model: VLBart, batch, ctx: PetContext,
                   max_length: int, path: str, label: str):
    """One warm-up and one timed bf16 beam-5 generate; examples/s and the
    launches of the timed run (the ``path`` main-path run)."""
    V = model.cfg.backbone.vocab_size
    B = batch["input_ids"].shape[0]

    def run():
        return seq2seq_generate(model, **batch, ctx=ctx, num_beams=5,
                                max_length=max_length)

    out = run()  # warm-up: cuBLAS heuristics, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = read_counts(path)
    require_tc(path, launched)
    if out.shape != (B, max_length) or out.dtype != torch.long:
        raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}")
    start = model.cfg.backbone.decoder_start_token_id
    if (not bool(((out >= 0) & (out < V)).all())
            or not bool((out[:, 0] == start).all())):
        raise AssertionError("token ids out of range or missing start token")
    RUNS[path] = dict(ex_s=B / wall, peak_gib=peak)
    print(f"  bf16 B{B} {label}: {B / wall:.2f} examples/s, wall "
          f"{wall:.3f} s on {card}; peak memory {peak:.2f} GiB; launches "
          f"{launched}", flush=True)
    if "--profile" in sys.argv:
        profile_run(run, card, f"{label} generate")
    return launched


def phase_decode_bench(card: str):
    model = build_model("bfloat16")
    return generate_bench(card, model,
                          make_batch(500, model.cfg.backbone.vocab_size,
                                     seed=11),
                          PetContext(task="caption", task_idx=3), 40,
                          "decode", "beam5 len40")


def phase_video_eval(card: str):
    """fp32 token parity at B 4 (as phase 4: the full model at the init
    scale, then 1+1 layers at std 0.2), then the bf16 eval shape at B 50."""
    ctx = PetContext(task="tvqa", task_idx=VIDEO_TASKS.index("tvqa"))
    model = build_model("float32", video_cfg)
    V = model.cfg.backbone.vocab_size
    batch = make_video_batch(4, V, seed=13)
    parity_run("video 6+6 layers, init std 0.02, B4 S604", model, batch, ctx,
               20, min_distinct=2)
    parity_run("video 1+1 layers, std 0.2, B4 S604", spread_model(video_cfg),
               batch, ctx, 20, min_distinct=MIN_DISTINCT_PER_ROW)
    del model
    model = build_model("bfloat16", video_cfg)
    return generate_bench(card, model, make_video_batch(50, V, seed=17), ctx,
                          20, "video_eval", "video S604 beam5 len20")


# (label, configuration, main path) of the two T5 eval paths
T5_CFGS = (("t5", t5_cfg, "t5_eval"),
           ("t5 gated", t5_gated_cfg, "t5_gated_eval"))


def phase_t5_parity() -> None:
    """fp32 beam-5 and greedy tokens, kernels vs plain, at B 8 to length
    40 for both T5 configurations: (a) 12+12 layers at the T5 init, (b) 1+1
    layers at std 0.2."""
    ctx = PetContext(task="caption", task_idx=3)
    for name, cfg_fn, _ in T5_CFGS:
        model = build_model("float32", cfg_fn)
        batch = make_batch(8, model.cfg.backbone.vocab_size, seed=7, pad=0)
        parity_run(f"{name} 12+12 layers, T5 init", model, batch, ctx, 40,
                   min_distinct=2)
        del model
        parity_run(f"{name} 1+1 layers, std 0.2", spread_model(cfg_fn),
                   batch, ctx, 40, min_distinct=MIN_DISTINCT_PER_ROW)


def phase_t5_eval(card: str):
    """The bf16 T5 eval shape, B 300 beam 5 to length 40, for both
    configurations: {main path: launches}."""
    ctx = PetContext(task="caption", task_idx=3)
    launched = {}
    for name, cfg_fn, path in T5_CFGS:
        model = build_model("bfloat16", cfg_fn)
        batch = make_batch(300, model.cfg.backbone.vocab_size, seed=19, pad=0)
        launched[path] = generate_bench(card, model, batch, ctx, 40, path,
                                        f"{name} beam5 len40")
        del model
    return launched


def train_run(model, trainable, batch, steps: int, total_steps: int,
              gen_seed: int, tasks=FLAGSHIP_TASKS, task: str = "vqa",
              lr: float = 1e-3):
    """``steps`` train steps of ``task`` with a fresh optimizer; returns
    the per-step (loss, grad_norm) tensors."""
    opt = build_optimizer(trainable, lr=lr, total_steps=total_steps)
    step = make_train_step(model, opt, tasks)
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    return [step(batch, gen, tasks.index(task)) for _ in range(steps)]


def check_step(i: int, got, want, want2=None) -> str:
    """Step i's loss and gradient norm, kernels vs plain, within
    TRAIN_METRIC_RTOL of the plain step ``want`` (or of the second plain
    reference ``want2``, where given); returns the printed row."""
    for key in ("loss", "grad_norm"):
        x = got[key].item()
        refs = [w[key].item() for w in (want, want2) if w is not None]
        if not math.isfinite(x) or all(abs(x - y) > TRAIN_METRIC_RTOL * abs(y)
                                       for y in refs):
            raise AssertionError(f"train step {i} {key}: kernels {x!r} vs "
                                 f"plain {refs!r}")
    row = (f"{got['loss'].item():.7f}/{want['loss'].item():.7f} "
           f"|g| {got['grad_norm'].item():.6f}/"
           f"{want['grad_norm'].item():.6f}")
    if want2 is not None:
        row += (f" (fp64-fc1 plain {want2['loss'].item():.7f} |g| "
                f"{want2['grad_norm'].item():.6f})")
    return row


def check_params(trainable, after, start) -> float:
    """The kernels' parameters ``after`` against the plain path's (the
    current values of ``trainable``), both updated from ``start``: within
    rtol PARAM_RTOL, atol PARAM_ATOL_SCALE * max|p|. Returns the largest
    |kernel - plain| over the largest update."""
    worst = 0.0
    for n, p in trainable.items():
        want_p = p.detach()
        tol = PARAM_RTOL * want_p.abs() + PARAM_ATOL_SCALE * want_p.abs().max()
        diff = (after[n] - want_p).abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"trainable {n}: kernels vs plain max |diff| "
                                 f"{diff.max().item():.3e}")
        moved = (after[n] - start[n]).abs().max().item()
        worst = max(worst, (diff.max() / max(moved, 1e-30)).item())
    return worst


def check_updates(after, refs, start) -> dict:
    """Per trainable tensor, the kernels' update (``after`` - ``start``)
    against a plain path's (each snapshot of ``refs`` - ``start``):
    |kernel - plain| <= PARAM_RTOL * |plain update| in the L2 norm over the
    tensor, for at least one of the references. Returns {name: the smaller
    ratio}."""
    ratios = {}
    for n, s0 in start.items():
        r = min((after[n] - ref[n]).norm().item()
                / max((ref[n] - s0).norm().item(), 1e-30) for ref in refs)
        if r > PARAM_RTOL:
            raise AssertionError(f"trainable {n}: |kernel - plain| > "
                                 f"{PARAM_RTOL} * |plain update| ({r:.3e}, "
                                 f"L2 over the tensor)")
        ratios[n] = r
    return ratios


def ffn_reference_fp64(x, w1, b1, w2, b2, act="gelu", rate=0.0, seed=None):
    """The plain FFN twin with its first product accumulated in fp64 and
    rounded once: another valid rounding of the same function."""
    h = ffn._ACTS[act][1](F.linear(x.double(), w1.double(),
                                   b1.double()).to(x.dtype))
    return F.linear(ffn._drop_hidden(h, rate, seed), w2.to(x.dtype),
                    b2.to(x.dtype))


@contextlib.contextmanager
def t5_ffn_input_in_fp64():
    """T5's plain FFN (the relu twin, ``models.t5.ffn_reference``) with its
    first product in fp64, for the second plain reference of phase 6e."""
    from vlpet_tpu_torch.models import t5 as t5_module

    saved = t5_module.ffn_reference
    t5_module.ffn_reference = ffn_reference_fp64
    try:
        yield
    finally:
        t5_module.ffn_reference = saved


def snapshot(trainable):
    return {n: p.detach().clone() for n, p in trainable.items()}


@torch.no_grad()
def restore(trainable, values) -> None:
    for n, p in trainable.items():
        p.copy_(values[n])


def train_parity(label: str, cfg_fn, batch_fn, B: int, seed: int, tasks,
                 task: str, lr: float, path: str) -> None:
    """K = 3 fp32 steps through the kernels, then through the plain twins
    from the same weights and generator seed (phase 6's tolerances)."""
    K = 3
    model = build_model("float32", cfg_fn)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    start = snapshot(trainable)
    reset_counts()
    got = train_run(model, trainable, batch, K, K + 1, 5, tasks, task, lr)
    torch.cuda.synchronize()
    launched = {k: n for k, n in read_counts(path).items() if n}
    after = snapshot(trainable)
    restore(trainable, start)
    reset_counts()
    with plain_twins():
        want = train_run(model, trainable, batch, K, K + 1, 5, tasks, task,
                         lr)
    torch.cuda.synchronize()
    if any_launched():
        raise AssertionError("the plain train step launched kernels")
    rows = [check_step(i, a, b) for i, (a, b) in enumerate(zip(got, want))]
    worst = check_params(trainable, after, start)
    print(f"  fp32 {label} dropout 0.1, {K} steps, loss kernel/plain and "
          f"grad norm: {'; '.join(rows)}", flush=True)
    print(f"  {len(trainable)} trainable tensors agree (rtol {PARAM_RTOL}, "
          f"atol {PARAM_ATOL_SCALE} max|p|); largest |kernel - plain| / "
          f"largest update {worst:.2e}; launches {launched}", flush=True)


def train_parity_per_step(label: str, cfg_fn, batch_fn, B: int, seed: int,
                          tasks, task: str, lr: float, path: str,
                          watch: str = None,
                          second_reference: bool = False) -> dict:
    """K = 3 fp32 steps, each taken twice from the same parameters and
    optimizer state -- through the plain twins, then through the kernels
    -- with the same dropout seeds; the next step starts from the plain
    result. Each step's loss and gradient norm within TRAIN_METRIC_RTOL
    (phase 6's), each tensor's update within PARAM_RTOL of the plain
    update in the L2 norm (``check_updates``).

    Why not phase 6's free-running lockstep and elementwise parameter
    check (PERF.md, Findings): at T5-base's 12+12 layers two fp32 paths that
    sum in different orders flip the sign of a few relu pre-activations a
    step, which moves a whole row of the backward by a few percent; Adam
    then turns that, for the elements whose gradients are near zero, into
    parameter differences of the size of the update. Free-running, the
    gradient norms parted by 2.5e-5 by the third step; step by step,
    loss and gradient norm agree to a few 1e-7 but single elements of the
    visual projection still differ by more than phase 6's elementwise
    tolerance. The recipe zero-inits the up projections; at 0 Adam's steps
    are +-lr whatever a gradient's size, so they start at normal(0, 0.02)
    (``unzero``). The update ratios of the tensors whose names end in
    ``watch`` are printed by name. Returns the launches of the kernel
    steps.

    ``second_reference`` (phase 6e) also takes each step through the plain
    twins with T5's FFN input product in fp64 (``t5_ffn_input_in_fp64``),
    and the kernels' step must agree with one of the two plain steps; the
    largest ratio between the two plain steps' updates is printed beside
    the kernels' and the kernels' against the fp32 plain step alone. Why:
    at T5's video shape that perturbation alone, with no kernel on the
    path, parts the two plain steps by more than these tolerances (an
    RMSNorm scale's update by 1.43e-3 of itself), as far as the kernels'
    step parts from the fp32 plain one: a relu pre-activation within an
    fp32 rounding of 0 decides a row of the backward (PERF.md, Findings)."""
    K = 3
    model = build_model("float32", cfg_fn)
    unzero(model)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    opts = [build_optimizer(trainable, lr=lr, total_steps=K + 1)
            for _ in range(3 if second_reference else 2)]
    steps = [make_train_step(model, opt, tasks) for opt in opts]
    task_idx = tasks.index(task)
    rows, worst, floor, launched = [], 0.0, 0.0, {}
    worst_fp32 = 0.0  # against the fp32 plain step alone
    for i in range(K):
        start = snapshot(trainable)
        for opt in opts[1:]:
            for name in ("mu", "nu"):
                for dst, src in zip(getattr(opt, name),
                                    getattr(opts[0], name)):
                    dst.copy_(src)
            opt.count = opts[0].count
        reset_counts()
        with plain_twins():
            want = steps[0](batch, torch.Generator(device="cuda").manual_seed(
                seed + i), task_idx)
            refs = [snapshot(trainable)]
            want2 = None
            if second_reference:
                restore(trainable, start)
                with t5_ffn_input_in_fp64():
                    want2 = steps[2](batch, torch.Generator(
                        device="cuda").manual_seed(seed + i), task_idx)
                refs.append(snapshot(trainable))
        torch.cuda.synchronize()
        if any_launched():
            raise AssertionError("the plain train step launched kernels")
        restore(trainable, start)
        got = steps[1](batch, torch.Generator(device="cuda").manual_seed(
            seed + i), task_idx)
        torch.cuda.synchronize()
        for k, n in read_counts(path).items():
            if n:
                launched[k] = launched.get(k, 0) + n
        rows.append(check_step(i, got, want, want2))
        kernel_after = snapshot(trainable)
        restore(trainable, refs[0])
        ratios = check_updates(kernel_after, refs, start)
        worst = max(worst, max(ratios.values()))
        if second_reference:
            def largest(a, b):
                return max((a[n] - b[n]).norm().item()
                           / max((b[n] - start[n]).norm().item(), 1e-30)
                           for n in start)
            floor = max(floor, largest(refs[1], refs[0]))
            worst_fp32 = max(worst_fp32, largest(kernel_after, refs[0]))
        for n, r in ratios.items():
            if watch is not None and n.endswith(watch):
                print(f"    step {i} {n}: update ratio {r:.2e}", flush=True)
    print(f"  fp32 {label} dropout 0.1, {K} steps each from the plain "
          f"state, loss kernel/plain and grad norm: {'; '.join(rows)}",
          flush=True)
    print(f"  {len(trainable)} trainable tensors: every step's update within "
          f"{PARAM_RTOL} of the plain update (L2 per tensor"
          f"{', either plain reference' if second_reference else ''}), "
          f"largest ratio {worst:.2e}"
          + (f" (against the fp32 plain step alone {worst_fp32:.2e}; "
             f"fp64-fc1 plain vs plain {floor:.2e})" if second_reference
             else "") + f"; launches {launched}", flush=True)
    return launched


def phase_train_parity() -> None:
    train_parity("B8 vqa", flagship_cfg, make_train_batch, 8, 21,
                 FLAGSHIP_TASKS, "vqa", 1e-3, "train")


def phase_video_train_parity() -> None:
    train_parity("video B2 S604 tvqa", video_cfg, make_video_train_batch, 2,
                 23, VIDEO_TASKS, "tvqa", 7e-4, "video_train")


def step_vs_plain(label: str, step, trainable, batch, gen, task_idx) -> None:
    """One bf16 step through the kernels and one through the plain twins
    from the same state (parameters and dropout seeds): the losses within
    BF16_STEP_RTOL relative; the gradient norms' ratio printed."""
    start, gstate = snapshot(trainable), gen.get_state()
    got = step(batch, gen, task_idx)
    loss, gnorm = got["loss"].item(), got["grad_norm"].item()
    restore(trainable, start)
    gen.set_state(gstate)
    with plain_twins():
        want = step(batch, gen, task_idx)
    ploss, pgnorm = want["loss"].item(), want["grad_norm"].item()
    rel = abs(loss - ploss) / abs(ploss)
    if not rel <= BF16_STEP_RTOL:
        raise AssertionError(f"{label}: bf16 loss {loss:.6f} through the "
                             f"kernels, {ploss:.6f} through the plain twins: "
                             f"{rel:.3e} relative (tol {BF16_STEP_RTOL})")
    print(f"  {label}: one bf16 step kernels vs plain from the same state: "
          f"loss {loss:.6f} vs {ploss:.6f} ({rel:.3e} relative, tol "
          f"{BF16_STEP_RTOL}); grad norm {gnorm:.6f} vs {pgnorm:.6f} (ratio "
          f"{gnorm / pgnorm:.6f})", flush=True)


def train_bench(card: str, cfg_fn, batch_fn, B: int, seed: int, tasks,
                task: str, lr: float, path: str, label: str,
                vs_plain: bool = False):
    """3 warm-up steps, then 10 timed steps ending in one sync; the
    launches of the timed steps (the ``path`` main-path run). With
    ``vs_plain``, then one step kernels vs plain (``step_vs_plain``)."""
    warm, timed = 3, 10
    model = build_model("bfloat16", cfg_fn)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    opt = build_optimizer(trainable, lr=lr, total_steps=warm + timed + 1)
    step = make_train_step(model, opt, tasks)
    gen = torch.Generator(device="cuda").manual_seed(9)
    task_idx = tasks.index(task)
    for _ in range(warm):
        out = step(batch, gen, task_idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = step(batch, gen, task_idx)
    loss = out["loss"].item()  # the one sync
    wall = time.perf_counter() - t0
    launched = read_counts(path)
    require_tc(path, launched)
    if not math.isfinite(loss) or not math.isfinite(out["grad_norm"].item()):
        raise AssertionError(f"non-finite loss {loss} / grad norm")
    per_step = {k: n / timed for k, n in launched.items() if n}
    RUNS[path] = dict(ex_s=B * timed / wall, ms_step=wall / timed * 1e3,
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  bf16 B{B} {label} train step: {B * timed / wall:.2f} examples/s "
          f"({wall / timed * 1e3:.2f} ms/step over {timed} steps) on {card}; "
          f"loss {loss:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"per step {per_step}", flush=True)
    if "--profile" in sys.argv:
        profile_run(lambda: step(batch, gen, task_idx)["loss"].item(), card,
                    f"{label} train step")
    if vs_plain:
        step_vs_plain(f"bf16 B{B} {label}", step, trainable, batch, gen,
                      task_idx)
    return launched


def phase_train_bench(card: str):
    return train_bench(card, flagship_cfg, make_train_batch, 500, 31,
                       FLAGSHIP_TASKS, "vqa", 1e-3, "train", "vqa")


def make_t5_train_batch(B: int, vocab: int, seed: int):
    """The T5 decode batch (pad 0) plus targets and VQA answer scores."""
    return add_targets(make_batch(B, vocab, seed, pad=0), B, vocab, seed,
                       True)


# (label, configuration, main path) of the two T5 training paths
T5_TRAIN_CFGS = (("t5", t5_cfg, "t5_train"),
                 ("t5 gated", t5_gated_cfg, "t5_gated_train"))


@torch.no_grad()
def unzero(model, std: float = 0.02) -> None:
    """Every all-zero parameter (the recipe's zero-init up projections) at
    normal(0, std), seeded."""
    g = torch.Generator(device="cuda").manual_seed(99)
    for p in model.parameters():
        if not p.any():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * std)


# the T5 recipe's learning rate (SURVEY.md: bs 300, lr 3e-4)
T5_LR = 3e-4


def phase_t5_train_parity() -> None:
    """Both T5 configurations at 12+12 layers, batch 8, vqa and caption,
    step by step from the plain state (``train_parity_per_step``)."""
    for name, cfg_fn, path in T5_TRAIN_CFGS:
        for task in ("vqa", "caption"):
            train_parity_per_step(f"{name} 12+12 layers B8 {task}", cfg_fn,
                                  make_t5_train_batch, 8, 25, FLAGSHIP_TASKS,
                                  task, T5_LR, path)


def phase_t5_train_bench(card: str):
    """bf16 B 300 for both T5 configurations: {main path: launches}. A1
    launches at 36 sites a step (12 encoder self, 12 decoder self, 12
    cross), A6 at 35: the first decoder block's self-attention reads only
    frozen embeddings and its frozen projections, so nothing there needs a
    gradient; the FFN kernels at 24 each."""
    launched = {}
    for name, cfg_fn, path in T5_TRAIN_CFGS:
        got = train_bench(card, cfg_fn, make_t5_train_batch, 300, 35,
                          FLAGSHIP_TASKS, "vqa", T5_LR, path, name)
        fwd, bwd = (("fused_gated_ffn", "fused_gated_ffn_bwd")
                    if "gated" in path else ("fused_ffn", "fused_ffn_bwd"))
        want = {"fused_attention": 360, "fused_attention_bwd": 350,
                fwd: 240, bwd: 240}
        seen = {k: got[k] for k in want}
        if seen != want:
            raise AssertionError(f"{name}: launches in 10 steps {seen}, "
                                 f"expected {want}")
        launched[path] = got
    return launched


def phase_video_train_bench(card: str):
    launched = train_bench(card, video_cfg, make_video_train_batch, 50, 33,
                           VIDEO_TASKS, "tvqa", 7e-4, "video_train",
                           "video S604 tvqa", vs_plain=True)
    # 6 encoder self-attention and 6 cross-attention sites per step
    if launched["fused_attention_bwd_long"] != 12 * 10:
        raise AssertionError(f"long backward launched "
                             f"{launched['fused_attention_bwd_long']} times "
                             f"in 10 steps, expected 120")
    return launched


def with_flags(cfg_fn, **flags):
    """``cfg_fn`` with the given VLModelConfig fields set."""
    def cfg(dtype: str = "float32"):
        return dataclasses.replace(cfg_fn(dtype), **flags)
    return cfg


def ce_case(rep: Report, label: str, x, w, b, labels, timed: bool) -> None:
    """C1 and C2 at one shape against the plain twin: loss and lse, and dx
    against autograd of the plain forward; the library yardsticks are
    F.linear + F.cross_entropy (forward; autograd of it for the backward),
    and the GEMM alone is printed beside them."""
    dtype = x.dtype
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    N, D = x.shape
    V = w.shape[0]
    e = x.element_size()
    iters = 20 if dtype == torch.bfloat16 else 3
    dloss = torch.rand(N, generator=torch.Generator(device="cuda")
                       .manual_seed(N), device="cuda") + 0.5
    bl = b.to(dtype)

    def library(xx):
        return F.cross_entropy(F.linear(xx, w, bl).float(), labels,
                               reduction="none")

    rep.check("fused_linear_ce", f"{tag} {label} N{N} D{D} V{V}",
              lambda: fused_ce.fused_linear_ce(x, w, b, labels),
              lambda: fused_ce.fused_linear_ce_reference(x, w, b, labels),
              dtype, timed=timed,
              work=(e * (N * D + V * D) + 4 * V + 16 * N, 2 * N * V * D),
              library_fn=lambda: library(x), iters=iters)
    gemm = cuda_ms(lambda: F.linear(x, w), iters)
    print(f"  {'':24s} {f'{tag} {label} the logits GEMM alone':34s} "
          f"{gemm:.4f} ms", flush=True)
    loss, lse = fused_ce.fused_linear_ce(x, w, b, labels)
    if not bool((loss[labels == -100] == 0).all()):
        raise AssertionError("fused_linear_ce: an ignored row has a loss")
    plain = _grads_of(lambda xx: fused_ce.fused_linear_ce_reference(
        xx, w, b, labels)[0], [x], dloss)
    lib = _grads_of(library, [x], dloss)
    rep.check("fused_linear_ce_bwd", f"{tag} {label} N{N} D{D} V{V}",
              lambda: fused_ce.fused_linear_ce_bwd(x, w, b, labels, lse,
                                                   dloss),
              lambda: plain()[0], dtype, timed=timed,
              work=(e * (2 * N * D + V * D) + 4 * V + 16 * N,
                    4 * N * V * D),
              library_fn=lambda: lib()[0], iters=iters, backward=True)
    if dtype == torch.bfloat16:
        bitwise_repeat("fused_linear_ce_bwd", f"{tag} {label} N{N} D{D} V{V}",
                       lambda: (fused_ce.fused_linear_ce_bwd(
                           x, w, b, labels, lse, dloss),))


def c2_case(rep: Report, label: str, x, w, b, labels) -> None:
    """C2 alone, bf16, at a shape no main path gives it (a ragged N, D 512
    or 1024), from the plain forward's lse: dx against the plain twin under
    the backward rule, the library yardstick autograd of F.linear +
    F.cross_entropy, and two runs bitwise equal."""
    N, D = x.shape
    V = w.shape[0]
    dloss = torch.rand(N, generator=torch.Generator(device="cuda")
                       .manual_seed(N), device="cuda") + 0.5
    _, lse = fused_ce.fused_linear_ce_reference(x, w, b, labels)
    bl = b.to(x.dtype)
    lib = _grads_of(lambda xx: F.cross_entropy(F.linear(xx, w, bl).float(),
                                               labels, reduction="none"),
                    [x], dloss)
    name = f"bf16 {label} N{N} D{D} V{V}"

    def kernel():
        return fused_ce.fused_linear_ce_bwd(x, w, b, labels, lse, dloss)
    rep.check("fused_linear_ce_bwd", name, kernel,
              lambda: fused_ce.fused_linear_ce_bwd_reference(
                  x, w, b, labels, lse, dloss), torch.bfloat16,
              work=(2 * (2 * N * D + V * D) + 4 * V + 16 * N, 4 * N * V * D),
              library_fn=lambda: lib()[0], backward=True)
    bitwise_repeat("fused_linear_ce_bwd", name, lambda: (kernel(),))


def d2_case(rep: Report, g, dtype, B: int, H: int, Dh: int, Lc: int,
            pos: int, bias: bool, timed: bool) -> None:
    """D2 at one step against its plain twin: the output, the written slot
    and every other slot of both caches bit for bit unchanged; the library
    yardstick is D1's (SDPA with the ancestry mask materialised) over the
    written cache."""
    randn = randn_fn(g)
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    K = 5
    inner = H * Dh
    e = 2 if dtype == torch.bfloat16 else 4
    qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
    kc0 = randn(Lc, B * K, inner, dtype=dtype)
    vc0 = randn(Lc, B * K, inner, dtype=dtype)
    kn = randn(B * K, 1, inner, dtype=dtype)
    vn = randn(B * K, 1, inner, dtype=dtype)
    anc = torch.randint(0, K, (B, K, Lc), generator=g, device="cuda")
    anc[:, :, pos] = torch.arange(K, device="cuda")
    row = randn(1, H, 1, Lc) if bias else None
    own = row[0, :, 0, pos].contiguous() if bias else None
    kk, vk, kp, vp = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
    decode.beam_decode_attend_update(qb, kk, vk, kn, vn, anc, pos, own, row)
    decode.beam_decode_attend_update_reference(qb, kp, vp, kn, vn, anc, pos,
                                               own, row)
    torch.cuda.synchronize()
    others = [t for t in range(Lc) if t != pos]
    for name, got, plain, old, new in (("k", kk, kp, kc0, kn),
                                       ("v", vk, vp, vc0, vn)):
        if not (torch.equal(got[pos], new.reshape(B * K, inner))
                and torch.equal(got[others], old[others])
                and torch.equal(got, plain)):
            raise AssertionError(f"beam_decode_attend_update {tag} B{B} pos "
                                 f"{pos}: the {name} cache is not the old one "
                                 f"with slot {pos} written")
    rows = (F.one_hot(anc[:, :, :pos], K).amax(dim=1).sum().item()
            if pos else 0)
    label = f"{tag} B{B} K{K} L{Lc} pos{pos}" + (" +bias" if bias else "")
    rep.check("beam_decode_attend_update", label,
              lambda: decode.beam_decode_attend_update(qb, kk, vk, kn, vn, anc,
                                                       pos, own, row),
              lambda: decode.beam_decode_attend_update_reference(
                  qb, kp, vp, kn, vn, anc, pos, own, row),
              dtype, timed=timed,
              work=(e * (6 * B * K * inner + 2 * rows * inner)
                    + anc.element_size() * B * K * pos
                    + (4 * H * (pos + 1) if bias else 0),
                    4 * B * K * H * (pos + 1) * Dh),
              library_fn=beam_sdpa(qb, kk, vk, anc, pos, dtype, row))


def slot_writers():
    """(write, plain): a decode step's K and V slot writes. The pair form,
    one U1 launch (ops.cache_update.cache_slots_update), where the port has
    it; else two one-cache writes (an earlier tree's port, which
    chip_phases.py times with this tree's phases)."""
    if hasattr(cache_update, "cache_slots_update"):
        return (cache_update.cache_slots_update,
                cache_update.cache_slots_update_reference)

    def each(fn):
        return lambda caches, news, pos: [fn(c, n, pos)
                                          for c, n in zip(caches, news)]
    return (each(cache_update.cache_slot_update),
            each(cache_update.cache_slot_update_reference))


def u1_case(rep: Report, g, dtype, rows: int, inner: int, Lc: int, pos: int,
            label: str, timed: bool) -> None:
    """U1 at one layer's K and V decode caches, each viewed as (1, L, rows,
    inner): both slots written exactly, every other slot unchanged bit for
    bit, the plain twin's caches equal, one launch for the pair where the
    port has the pair form; the library yardstick is two
    cache[pos].copy_(new) calls, the bound the pair's bytes."""
    randn = randn_fn(g)
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    caches = [randn(Lc, rows, inner, dtype=dtype) for _ in range(2)]
    news = [randn(rows, inner, dtype=dtype) for _ in range(2)]
    before = [c.clone() for c in caches]
    plain = [c.clone() for c in caches]
    c4 = [c.view(1, Lc, rows, inner) for c in caches]
    p4 = [c.view(1, Lc, rows, inner) for c in plain]
    n3 = [n.view(1, rows, inner) for n in news]
    write, write_plain = slot_writers()
    launches = cache_update.cache_slot_update.launches
    write(c4, n3, pos)
    launches = cache_update.cache_slot_update.launches - launches
    write_plain(p4, n3, pos)
    torch.cuda.synchronize()
    others = [t for t in range(Lc) if t != pos]
    for c, b, p, n in zip(caches, before, plain, news):
        if (not torch.equal(c[pos], n) or not torch.equal(c[others], b[others])
                or not torch.equal(c, p)):
            raise AssertionError(f"cache_slot_update {tag} {label}: not an "
                                 f"exact in-place write of slot {pos}")
    if hasattr(cache_update, "cache_slots_update") and launches != 1:
        raise AssertionError(f"cache_slot_update {tag} {label}: {launches} "
                             f"launches for one K and V write")
    rep.check("cache_slot_update", f"{tag} {label} K+V (1, {Lc}, {rows}, "
              f"{inner}) pos{pos}", lambda: write(c4, n3, pos),
              lambda: write_plain(p4, n3, pos), dtype, timed=timed,
              work=(2 * 2 * caches[0].element_size() * rows * inner, 0),
              library_fn=lambda: [c[pos].copy_(n)
                                  for c, n in zip(caches, news)])
    ms, _, lms = rep.last
    print(f"  {'cache_slot_update':24s} {f'{tag} {label}':34s} {launches} "
          f"launch(es) per K+V write; kernel / two copy_ {ms / lms:.3f}",
          flush=True)


def phase_fused_kernels(rep: Report) -> None:
    """3f: C1/C2 at the BART train shape (N 5000 = 500 x 10, V 50265,
    random fp32 bias) and the T5 tied one (N 3000, V 32100, x at the
    d^-0.5 rescale, zero bias), 10% of the labels -100; D2 at the BART beam
    shape (B 500, K 5, L 40, pos 0, 20, 39) and the T5 one with the bias row
    and the own bias (B 300, pos 39); U1 at both decode caches. bf16 (the
    timed cases) and fp32."""
    g = torch.Generator(device="cuda").manual_seed(6)
    randn = randn_fn(g)
    D = 768
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for label, N, V, xs, bias, ws in (("bart", 5000, 50265, 1.0, True,
                                           0.02),
                                          ("t5", 3000, 32100, D ** -0.5,
                                           False, 1.0)):
            x = randn(N, D, dtype=dtype, scale=xs)
            w = randn(V, D, dtype=dtype, scale=ws)
            b = (randn(V, scale=0.1) if bias
                 else torch.zeros(V, device="cuda"))
            labels = torch.randint(0, V, (N,), generator=g, device="cuda")
            drop = torch.rand(N, generator=g, device="cuda") < 0.1
            labels = torch.where(drop, -100, labels)
            ce_case(rep, label, x, w, b, labels, timed=main and label == "bart")
            del x, w
        # C2's other widths and a ragged N (no multiple of a row block)
        for label, N, Dc in (("t5 ragged", 2999, D), ("d512", 3000, 512),
                             ("d1024", 2999, 1024)) if main else ():
            x = randn(N, Dc, dtype=dtype, scale=Dc ** -0.5)
            w = randn(32100, Dc, dtype=dtype)
            labels = torch.randint(0, 32100, (N,), generator=g, device="cuda")
            labels = torch.where(torch.rand(N, generator=g, device="cuda")
                                 < 0.1, -100, labels)
            c2_case(rep, label, x, w, torch.zeros(32100, device="cuda"),
                    labels)
            del x, w
        for B, H, pos, bias in ((500, 12, 0, False), (500, 12, 20, False),
                                (500, 12, 39, False), (300, 12, 39, True)):
            d2_case(rep, g, dtype, B, H, 64, 40, pos, bias,
                    timed=main and B == 500 and pos == 39)
        for rows, label in ((2500, "bart beam"), (1500, "t5 beam")):
            u1_case(rep, g, dtype, rows, D, 40, 20, label,
                    timed=main and rows == 2500)


def phase_fused_beam_parity() -> None:
    """4d: fp32 beam-5 and greedy tokens with ``use_fused_beam`` at batch 8
    to length 40, BART-base + VL-PET-large (6+6 layers) and T5 relu/tied
    (12+12), at the init scale: kernels vs plain identical (D2 on every
    beam step, D1 never), and the fused path's tokens identical to the
    unfused path's (the same seeded weights without the flag)."""
    ctx = PetContext(task="caption", task_idx=3)
    for name, cfg_fn, pad in (("bart", flagship_cfg, 1), ("t5", t5_cfg, 0)):
        model = build_model("float32", with_flags(cfg_fn, use_fused_beam=True))
        batch = make_batch(8, model.cfg.backbone.vocab_size, seed=7, pad=pad)
        reset_counts()
        beam, greedy = parity_run(f"{name} use_fused_beam, init scale", model,
                                  batch, ctx, 40, min_distinct=2)
        if (decode.beam_decode_attend_update.launches == 0
                or decode.beam_decode_attend.launches):
            raise AssertionError(f"{name} use_fused_beam: D2 launched "
                                 f"{decode.beam_decode_attend_update.launches}"
                                 f", D1 {decode.beam_decode_attend.launches}")
        del model
        base = build_model("float32", cfg_fn)
        for beams, got in ((5, beam), (1, greedy)):
            want = seq2seq_generate(base, **batch, ctx=ctx, num_beams=beams,
                                    max_length=40)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: fp32 {beams}-beam tokens differ "
                                     f"between use_fused_beam and the "
                                     f"unfused path")
        print(f"  {name}: beam-5 and greedy tokens identical, fused path vs "
              f"unfused", flush=True)
        del base


def phase_fused_beam_bench(card: str):
    """5d: the bf16 beam-5 evals of phases 5 and 5c with
    ``use_fused_beam``: BART B 500 and T5 relu/tied B 300 to length 40."""
    ctx = PetContext(task="caption", task_idx=3)
    launched = {}
    for name, cfg_fn, B, seed, pad, path, base in (
            ("bart", flagship_cfg, 500, 11, 1, "decode_fused_beam", "decode"),
            ("t5", t5_cfg, 300, 19, 0, "t5_eval_fused_beam", "t5_eval")):
        model = build_model("bfloat16", with_flags(cfg_fn, use_fused_beam=True))
        batch = make_batch(B, model.cfg.backbone.vocab_size, seed=seed,
                           pad=pad)
        got = generate_bench(card, model, batch, ctx, 40, path,
                             f"{name} use_fused_beam beam5 len40")
        if got["beam_decode_attend"] or got["cache_slot_update"]:
            raise AssertionError(f"{name} use_fused_beam: D1 or U1 launched "
                                 f"on the beam path: {got}")
        print(f"  {name} use_fused_beam {RUNS[path]['ex_s']:.2f} ex/s (D2 "
              f"{got['beam_decode_attend_update']} launches) beside the "
              f"unfused {RUNS[base]['ex_s']:.2f} ex/s (phase "
              f"{'5' if base == 'decode' else '5c'})", flush=True)
        launched[path] = got
        del model
    return launched


def fused_vs_dense(label: str, cfg_fn, batch_fn, B: int, seed: int,
                   task: str, lr: float, unzero_first: bool) -> None:
    """One fp32 step through the kernels with ``use_fused_ce`` and one with
    the dense loss from the same state and dropout seeds: loss and
    gradient norm within TRAIN_METRIC_RTOL."""
    model = build_model("float32", cfg_fn)
    if unzero_first:
        unzero(model)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    start = snapshot(trainable)
    out = {}
    for flag in (True, False):
        restore(trainable, start)
        model.cfg = dataclasses.replace(model.cfg, use_fused_ce=flag)
        opt = build_optimizer(trainable, lr=lr, total_steps=2)
        step = make_train_step(model, opt, FLAGSHIP_TASKS)
        out[flag] = step(batch, torch.Generator(device="cuda").manual_seed(5),
                         FLAGSHIP_TASKS.index(task))
    torch.cuda.synchronize()
    print(f"  fp32 {label}: fused route vs dense route from the same state: "
          f"{check_step(0, out[True], out[False])}", flush=True)


def phase_fused_ce_parity() -> None:
    """6d: fp32 train-step parity with ``use_fused_ce``: BART B 8 vqa as
    phase 6 (3 steps kernels vs plain) and caption as phase 6c (each step
    from the plain state), T5 relu/tied B 8 vqa and caption as phase 6c;
    then one step of the fused route vs the dense route for each. Why BART
    caption takes 6c's check: phase 6's free-running elementwise parameter
    check fails on caption with or without the flag (an up-projection bias
    element 2.3e-8 apart without it, 3.1e-8 with it, against an atol of
    1e-5 max|p|: PERF.md, Findings), while 6c's passes both."""
    bart = with_flags(flagship_cfg, use_fused_ce=True)
    t5 = with_flags(t5_cfg, use_fused_ce=True)
    for task in ("vqa", "caption"):
        check = train_parity if task == "vqa" else train_parity_per_step
        check(f"use_fused_ce B8 {task}", bart, make_train_batch, 8, 21,
              FLAGSHIP_TASKS, task, 1e-3, "train_fused_ce")
        train_parity_per_step(f"t5 use_fused_ce 12+12 layers B8 {task}", t5,
                              make_t5_train_batch, 8, 25, FLAGSHIP_TASKS,
                              task, T5_LR, "t5_train_fused_ce")
        fused_vs_dense(f"bart B8 {task}", bart, make_train_batch, 8, 21,
                       task, 1e-3, False)
        fused_vs_dense(f"t5 B8 {task}", t5, make_t5_train_batch, 8, 25,
                       task, T5_LR, True)


def phase_fused_ce_bench(card: str):
    """7d: the bf16 train steps of phases 7 and 7c with ``use_fused_ce``:
    C1 and C2 once a step each."""
    launched = {}
    for name, cfg_fn, batch_fn, B, seed, lr, path, base in (
            ("vqa use_fused_ce", flagship_cfg, make_train_batch, 500, 31,
             1e-3, "train_fused_ce", "train"),
            ("t5 use_fused_ce", t5_cfg, make_t5_train_batch, 300, 35, T5_LR,
             "t5_train_fused_ce", "t5_train")):
        got = train_bench(card, with_flags(cfg_fn, use_fused_ce=True),
                          batch_fn, B, seed, FLAGSHIP_TASKS, "vqa", lr, path,
                          name)
        if got["fused_linear_ce"] != 10 or got["fused_linear_ce_bwd"] != 10:
            raise AssertionError(f"{name}: C1/C2 launched "
                                 f"{got['fused_linear_ce']}/"
                                 f"{got['fused_linear_ce_bwd']} times in 10 "
                                 f"steps, expected 10 each")
        f, d = RUNS[path], RUNS[base]
        print(f"  {name}: {f['ex_s']:.2f} ex/s, {f['ms_step']:.2f} ms/step, "
              f"peak {f['peak_gib']:.2f} GiB beside the dense route's "
              f"{d['ex_s']:.2f} ex/s, {d['ms_step']:.2f} ms/step, peak "
              f"{d['peak_gib']:.2f} GiB (phase {'7' if base == 'train' else '7c'})",
              flush=True)
        launched[path] = got
    return launched


def with_pet(cfg_fn, **flags):
    """``cfg_fn`` with the given PetConfig fields set."""
    def cfg(dtype: str = "float32"):
        c = cfg_fn(dtype)
        return dataclasses.replace(c, pet=dataclasses.replace(c.pet, **flags))
    return cfg


def make_t5_video_train_batch(B: int, vocab: int, seed: int):
    """The video inputs (pad 0) plus 10 targets and VQA answer scores, as
    scripts/bench_step_variants.py's t5_video_base variant trains task 0
    (vqa) of the T5 recipe's tasks."""
    return add_targets(make_video_batch(B, vocab, seed, pad=0), B, vocab,
                       seed, True)


FULL_FT_CFG = with_pet(t5_cfg, unfreeze_language_model=True)
RAB = "relative_attention_bias"


def phase_t5_video_eval(card: str):
    """5e: the T5 video eval (t5_video_cfg): fp32 beam-5 and greedy tokens
    kernels vs plain at B 4 to length 20, (a) 12+12 layers at the T5 init,
    (b) 1+1 layers at std 0.2; then bf16 beam 5 to length 20 at B 50."""
    ctx = PetContext(task="caption", task_idx=3)
    model = build_model("float32", t5_video_cfg)
    V = model.cfg.backbone.vocab_size
    batch = make_video_batch(4, V, seed=13, pad=0)
    parity_run("t5 video 12+12 layers, T5 init, B4 S604", model, batch, ctx,
               20, min_distinct=2)
    del model
    parity_run("t5 video 1+1 layers, std 0.2, B4 S604",
               spread_model(t5_video_cfg), batch, ctx, 20,
               min_distinct=MIN_DISTINCT_PER_ROW)
    model = build_model("bfloat16", t5_video_cfg)
    return generate_bench(card, model, make_video_batch(50, V, seed=17, pad=0),
                          ctx, 20, T5V_EVAL, "t5 video S604 beam5 len20")


def phase_bias_train_parity() -> dict:
    """6e: fp32 per-step train parity (``train_parity_per_step`` with its
    second plain reference), dropout 0.1, 3 steps: T5 video relu/tied at
    B 2, S 604; T5 with unfreeze_language_model at B 8, vqa and caption; T5
    BitFit (unfreeze_bias) at B 8, vqa; and T5 video BitFit at B 2, the one
    run of the long backward's dbias. relative_attention_bias's own update
    ratios are printed. Returns the BitFit runs' launches."""
    kw = dict(second_reference=True)
    train_parity_per_step("t5 video 12+12 layers B2 S604 vqa", t5_video_cfg,
                          make_t5_video_train_batch, 2, 27, FLAGSHIP_TASKS,
                          "vqa", T5_LR, T5V_TRAIN, **kw)
    kw["watch"] = RAB
    for task in ("vqa", "caption"):
        train_parity_per_step(f"t5 unfreeze_language_model B8 {task}",
                              FULL_FT_CFG, make_t5_train_batch, 8, 25,
                              FLAGSHIP_TASKS, task, T5_LR, FULL_FT, **kw)
    launched = {BITFIT: train_parity_per_step(
        "t5 unfreeze_bias B8 vqa", with_pet(t5_cfg, unfreeze_bias=True),
        make_t5_train_batch, 8, 25, FLAGSHIP_TASKS, "vqa", T5_LR, BITFIT,
        **kw)}
    launched[T5V_BITFIT] = train_parity_per_step(
        "t5 video unfreeze_bias B2 S604 vqa",
        with_pet(t5_video_cfg, unfreeze_bias=True), make_t5_video_train_batch,
        2, 27, FLAGSHIP_TASKS, "vqa", T5_LR, T5V_BITFIT, **kw)
    return launched


def phase_bias_train_bench(card: str):
    """7e: the bf16 T5 video train step (B 50, S 604, vqa) and t5_full_ft
    (unfreeze_language_model, B 300, S 56), timed as phase 7c, beside the
    BART video step (7b) and the PET T5 step (7c). Per step the video step
    launches A1 at 36 sites, the long backward at 24 (12 encoder self, 12
    cross), A6 at 11 (decoder self; the first block's needs no gradient)
    and F1/F2 at 24 each; full fine-tuning A1 and A6 at 36 each (every site
    needs a gradient now), 24 of the A6 launches with dbias (encoder and
    decoder self-attention), and no FFN kernel (the plain chain gives the
    weight gradients)."""
    launched = {}
    for name, cfg_fn, batch_fn, B, seed, path, base, want in (
            ("t5 video S604 vqa", t5_video_cfg, make_t5_video_train_batch, 50,
             33, T5V_TRAIN, "video_train",
             {"fused_attention": 360, "fused_attention_bwd_long": 240,
              "fused_attention_bwd": 110, "fused_ffn": 240,
              "fused_ffn_bwd": 240}),
            ("t5_full_ft", FULL_FT_CFG, make_t5_train_batch, 300, 35, FULL_FT,
             "t5_train",
             {"fused_attention": 360, "fused_attention_bwd": 360,
              "fused_attention_bwd.dbias": 240, "fused_ffn": 0,
              "fused_ffn_bwd": 0})):
        got = train_bench(card, cfg_fn, batch_fn, B, seed, FLAGSHIP_TASKS,
                          "vqa", T5_LR, path, name, vs_plain=path == T5V_TRAIN)
        seen = {k: got[k] for k in want}
        if seen != want:
            raise AssertionError(f"{name}: launches in 10 steps {seen}, "
                                 f"expected {want}")
        f, d = RUNS[path], RUNS[base]
        print(f"  {name}: {f['ex_s']:.2f} ex/s, {f['ms_step']:.2f} ms/step, "
              f"peak {f['peak_gib']:.2f} GiB beside {base}'s {d['ex_s']:.2f} "
              f"ex/s, {d['ms_step']:.2f} ms/step, peak {d['peak_gib']:.2f} "
              f"GiB", flush=True)
        launched[path] = got
    return launched


def profile_run(run, card: str, what: str) -> None:
    """One more run under torch.profiler: device time and launches by
    kernel family, the device idle share of the run's wall time, and the
    top of the per-kernel table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"ffn_fwd": "fused_ffn kernel (F1)",
                "ffn_w_tiles": "fused_ffn kernel (F1)",
                "gated_fwd": "fused_gated_ffn kernel (F3)",
                "gated_w_tiles": "fused_gated_ffn kernel (F3)",
                "gated_bwd": "fused_gated_ffn_bwd kernel (F4)",
                "gated_dy_tiles": "fused_gated_ffn_bwd kernel (F4)",
                # ffn_bwd_tc, ffn_bwd_dy_tiles, ffn_bwd_reduce, ffn_bwd_f32
                "ffn_bwd": "fused_ffn_bwd kernel (F2)",
                "ffn_bias": "fused_ffn_bwd kernel (F2)",
                "attention_fwd": "fused_attention kernel (A1)",
                "attention_bwd": "fused_attention_bwd kernel (A6)",
                "dkdv_kernel": "long attention backward (A3/A5)",
                "dq_kernel": "long attention backward (A3/A5)",
                "dkdv_tc": "long attention backward (A3/A5)",
                "dq_tc": "long attention backward (A3/A5)",
                "delta_kernel": "long attention backward (A3/A5)",
                "ln_fwd": "fused LN forward kernel (L1)",
                "ln_bwd": "fused LN backward kernel (L2)",
                "ln_col": "fused LN backward kernel (L2)",
                "beam_attend_update": "beam_decode_attend_update kernel (D2)",
                "beam_attend": "beam_decode_attend kernel (D1)",
                "ce_fwd": "fused linear + CE forward (C1)",
                "ce_bwd": "fused linear + CE backward (C2)",
                "ce_w_tiles": "fused linear + CE forward (C1)",
                "slot_copy": "cache_slot_update kernel (U1)",
                "topk_lse": "topk_lse kernel (T1)", "gemm": "cuBLAS GEMMs",
                "sm90": "cuBLAS GEMMs", "cutlass": "cuBLAS GEMMs",
                "nvjet": "cuBLAS GEMMs"}
    by_family, launches, busy = {}, {}, 0.0
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    for ev in events:
        dev_us = getattr(ev, key)
        # device-side events only: an aten op's "self device time" repeats
        # the time of the kernels it launched
        if ev.device_type == DeviceType.CPU or dev_us <= 0:
            continue
        busy += dev_us / 1e3
        fam = next((f for pat, f in families.items() if pat in ev.key.lower()),
                   "other kernels and copies")
        by_family[fam] = by_family.get(fam, 0.0) + dev_us / 1e3
        launches[fam] = launches.get(fam, 0) + ev.count
    print(f"  profile of one {what} on {card}: wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}",
          flush=True)
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:32s} {ms:9.2f} ms  {ms / wall_ms:.3f} of wall  "
              f"{launches[fam]} launches")
    print(events.table(sort_by=key, row_limit=25, max_name_column_width=60),
          flush=True)


def main() -> int:
    t_start = time.perf_counter()
    print("phase 1: environment", flush=True)
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- "
                         "this script needs a CUDA card")
    card = nvidia_smi()
    print(f"  card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"  built and loaded {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    print("phase 3: decode-path kernels vs plain", flush=True)
    rep = Report()
    phase_kernels(rep)
    print("phase 3b: training-path kernels vs plain", flush=True)
    phase_train_kernels(rep)
    print("phase 3c: long attention (video path) vs plain", flush=True)
    phase_long_attention(rep)
    phase_video_kernels(rep)
    print("phase 3d: T5 eval-path kernels vs plain", flush=True)
    phase_t5_kernels(rep)
    print("phase 3e: T5 training-path kernels vs plain", flush=True)
    phase_t5_train_kernels(rep)
    print("phase 3f: fused CE, fused beam and slot-write kernels vs plain",
          flush=True)
    phase_fused_kernels(rep)
    print("phase 3g: long backward with bias and dropout, dbias, vs plain",
          flush=True)
    phase_bias_grad_kernels(rep)
    print("phase 3h: F1 and C1 at their paths' rows, bf16", flush=True)
    phase_ffn_ce_sites(rep)
    print("phase 3i: F3 and F4 at their paths' rows, bf16", flush=True)
    phase_gated_ffn_sites(rep)
    print("phase 3j: F2 at its paths' rows, bf16; U1's K+V write",
          flush=True)
    phase_ffn_bwd_sites(rep)
    print("phase 3k: D1 and D2 at their paths' rows, bf16", flush=True)
    phase_beam_sites(rep)
    print("phase 3l: T1 and T2 at their sites, fp32", flush=True)
    phase_topk_sites(rep)
    print("phase 3m: L1 and L2 at their sites", flush=True)
    phase_ln_sites(rep)

    print("phase 4: decode parity, fp32", flush=True)
    phase_parity()

    print("phase 5: decode bench shape, bf16", flush=True)
    launched = {"decode": phase_decode_bench(card)}
    print("phase 5b: video eval, fp32 parity and bf16 bench shape",
          flush=True)
    launched["video_eval"] = phase_video_eval(card)
    print("phase 4c: T5 decode parity, fp32", flush=True)
    phase_t5_parity()
    print("phase 5c: T5 eval shape, bf16", flush=True)
    launched.update(phase_t5_eval(card))
    print("phase 4d: use_fused_beam decode parity, fp32", flush=True)
    phase_fused_beam_parity()
    print("phase 5d: use_fused_beam eval shape, bf16", flush=True)
    launched.update(phase_fused_beam_bench(card))
    print("phase 5e: T5 video eval, fp32 parity and bf16 bench shape",
          flush=True)
    launched[T5V_EVAL] = phase_t5_video_eval(card)

    print("phase 6: train-step parity, fp32", flush=True)
    phase_train_parity()
    print("phase 6b: video train-step parity, fp32", flush=True)
    phase_video_train_parity()
    print("phase 6c: T5 train-step parity, fp32", flush=True)
    phase_t5_train_parity()
    print("phase 6d: use_fused_ce train-step parity, fp32", flush=True)
    phase_fused_ce_parity()
    print("phase 6e: T5 video and trainable-bias train-step parity, fp32",
          flush=True)
    launched.update(phase_bias_train_parity())

    print("phase 7: train bench shape, bf16", flush=True)
    launched["train"] = phase_train_bench(card)
    print("phase 7b: video train step, bf16", flush=True)
    launched["video_train"] = phase_video_train_bench(card)
    print("phase 7c: T5 train step, bf16", flush=True)
    launched.update(phase_t5_train_bench(card))
    print("phase 7d: use_fused_ce train step, bf16", flush=True)
    launched.update(phase_fused_ce_bench(card))
    print("phase 7e: T5 video and t5_full_ft train steps, bf16", flush=True)
    launched.update(phase_bias_train_bench(card))

    missing = [k for k in KERNELS if k not in rep.timed]
    if missing:
        raise AssertionError(f"no timed case for {missing}")
    kernels = []
    for k, (src, replaces, paths) in KERNELS.items():
        by_path = {p: launched[p].get(wrapper_of(k), 0) for p in paths}
        main_path = next(p for p in MAIN_PATH_ORDER if p in paths)
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": by_path[main_path],
                 "launches_by_path": by_path}
        if wrapper_of(k) in ROUTED:  # the main path's launches per route
            entry["launches_by_route"] = {
                r: launched[main_path].get(f"{wrapper_of(k)}[{r}]", 0)
                for r in ROUTED[wrapper_of(k)]}
        kernels.append({**entry, "max_abs_err": rep.err[k], **rep.timed[k]})
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
