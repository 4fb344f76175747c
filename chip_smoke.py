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
     then, bf16, the image-text CLI's (phase 8) other shapes: attention at
     caption's B 416 (L = S = 76; decoder-self L 40, causal; cross L 40,
     S 76) and nlvr's B 166 (L = S = 102; cross L 10, S 102), where A6
     takes its wide tensor-core kernel past L, S 64 (bit for bit on a
     repeat; the long backward timed on the same inputs beside it), and
     F1, F2, L1, L2 at gqa's N 46648 and caption's N 31616 rows;
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
  6f. (run after 6e) the VL-PET-small, -middleX and -middleY gates on
     BART-base at full width (``gate_cfg``: the recipes of
     scripts/image-text/VL-PET-{small,middleX,middleY}.sh), fp32: phase
     6's train-step parity (B 8, vqa, dropout 0.1, 3 steps kernels vs
     plain, phase 6's tolerances), then phase 4 (a)'s beam-5 and greedy
     tokens at B 8 to length 40, kernels vs plain, identical;
  6g. (run after 6f) the PET baselines on BART-base at full width
     (``pet_cfg``: the config the port's CLI builds from each of
     scripts/image-text/{single_adapter,single_compacter,single_lora,
     single_prompt,hyperformer,bitfit,full_finetuning}.sh, lr 1e-3,
     hypercomplex_division 4, lora_dim 4, projected_task_embedding_dim
     64, and single_lradapter: single_adapter.sh with the low-rank
     adapter), fp32: phase 6's train-step parity (B 8, vqa, dropout 0.1,
     LoRA's dropout 0.1, 3 steps kernels vs plain); then, for the adapter,
     Compacter, low-rank, LoRA, prompt and hyperformer recipes (whose
     decode differs from the plain model's), phase 4 (a)'s beam-5 and
     greedy tokens at B 8 to length 40, kernels vs plain, identical;
  7f. (run after 7e) each script's bf16 train step at B 500, vqa (S 56;
     96 with the prompt, whose A6 takes its wide "tc" kernel), as phase 7
     (the pet_<script> main-path runs); then the beam-5 eval of the LoRA,
     prompt and hyperformer scripts at B 500 to length 40, as phase 5
     (the pet_<script>_eval runs);
  3n. (run after 3m) A1, and A6 or the long backward, bf16, at the prompt
     baseline's sites (40 prompt tokens before the text): vqa B 500 L = S
     96 and cross L 10 x S 96, gqa B 833 L = S 96, caption B 416 L = S
     116 and cross L 40 x S 116, nlvr B 166 L = S 142 and cross L 10 x
     S 142 (A6 past 128 rows; the long backward and "fma" until it): vs
     the plain twin and its autograd, bitwise on a repeat, with the route,
     SDPA's time and the bound, and at each A6 site past 64 the long
     backward timed on the same inputs (past 128, the FMA kernel too where
     it fits); then A6's kernels past one tile in every mode
     (``A6_WIDE_MODES``, bf16, B 300, rate 0.1: L = S 96 with the bias,
     and with dbias; L 40 over S 116 with the bias and dbias; causal L =
     S 76; L = S 142 with the bias and dbias; L 20 over S 181; causal L =
     S 200 with the bias and dbias), bitwise on a repeat, and their
     dropout masks bit for bit at L = S 96, L 40 over S 116, causal L = S
     76, L = S 142, L 20 over S 181 and causal L = S 200; then A6 and
     the long backward side by side at ``A6_ROUTE_GRID`` (B 64, L, S from
     1 to 256), the record behind backward_route;
  8. (run last) the image-text CLI, ``python -m vlpet_tpu_torch.cli.multitask``
     in a child process (``chip_smoke.py --cli-child``), with the flags of
     scripts/image-text/VL-PET-small.sh plus --bf16: batch 500 (valid
     500), the four tasks, beam 5, 1000 synthetic examples a task, one
     epoch (11 optimizer steps), each epoch followed by the eval of all
     four tasks; then a second child with --resume restores the saved
     state (its digest bit for bit the first run's) and trains one epoch
     more. Every kernel of the path (A1, A6, F1, F2, L1, L2, D1, T1/T2,
     U1) must launch in the first run (the cli_multitask main-path run);
     prints the wall clock of data building, training (host-clocked
     ms/step and examples/s), each task's eval and the resume;
  8b. (after 8) the same CLI with the flags of
     scripts/image-text/single_prompt.sh plus --bf16: B 500, the four
     tasks, 1000 synthetic examples a task, one epoch, evaluated
     (the cli_single_prompt main-path run: A6 on "tc" only, past 128
     rows at nlvr's L = S = 142 and cross-attention over S 142 among its
     launches); data build, ms/step and each task's eval seconds.
  3o. (run after 3n) every kernel of the ten scripts/video-text/*.sh at
     the shapes they give it (B 50; QA text 600 and captions 77 tokens +
     64 frames: S 664 and 141, 704 and 181 with the prompt; 20 targets),
     bf16: A1 and the long backward or A6 (as backward_route picks: A6
     past 128 rows at the caption sites, S 141 / 181) at the encoders,
     the decoder self-attention, the cross-attention and the decode cross
     sites (L 5 beam, L 1 greedy); fp32 A1 and the long backward at the
     tvqa encoder and cross sites; F1 / F2 and L1 / L2 at N 33200, 35200,
     7050, 9050, 1000 (F1 also at the decode rows 250 and 50), with the
     split and waves of ops/ffn.py f1_splits and the plan of
     ops/fused_ln.py ln_plan; D1 at 40 slots (beam-tree ancestry), U1,
     T1 (R 250) and T2 (R 50): vs the plain twin, bf16 twice bitwise
     equal, with the route, the library call and the bound;
  6h. (run after 6g) the video VL-PET-large recipe (the config
     cli.multitask_video builds from its script) at full width, fp32, B
     2: phase 6's train parity (3 steps from the weights after unzero) of
     tvqa at S 664 and tvc at S 141 (20 targets), single_prompt.sh's tvqa
     at S 704; beam-5 and greedy tokens on tvc (B 4, length 40) and greedy
     on tvqa (B 4, length 20; the init and 1+1 layers at std 0.2),
     kernels vs plain, identical;
  7g. (run after 7f) each video script's bf16 train step at B 50 on tvqa
     (S 664, 704 with the prompt), as phase 7 (the video_<script> runs);
     VL-PET-large's on tvc (S 141, A6 past 128 rows); its greedy tvqa eval to
     length 20 and beam-5 tvc eval to length 40 at B 50;
  8c. (after 8b) ``python -m vlpet_tpu_torch.cli.multitask_video`` with
     VL-PET-large.sh's flags + --bf16, B 50, the four tasks, 250 synthetic
     examples a task, 2 epochs, each evaluated, then --resume (the saved
     state's digest bit for bit); ``python -m
     vlpet_tpu_torch.cli.single_task tvqa`` with single_prompt.sh's flags
     for 1 epoch, whose S 704 sites take the long backward (the cli_video
     and cli_video_single_prompt runs).
  3p. (run after 3o) the raw-image path's kernel sites (the RN101 grid at
     224 px: 49 tokens after 20 text tokens, S 69; NLVR's two images S
     118; 448 px S 216), B 500, bf16, and fp32 for A1 and A6 at S 69: A1
     and A6 at the encoder (S 69, 118 and 216, past 128 rows) and cross
     (L 10, and the caption's L 40, over S 69 and 118) sites, the long
     backward timed beside it, the beam cross-attention L 5
     over S 69; F1, F2, L1 and L2 at N 34500, 59000
     and 108000; D1, U1, T1 and T2 at the raw caption eval (B 500, beam 5
     to length 40): vs the plain twin, bf16 twice bitwise equal, with the
     route, the library call and the bound;
  6i. (run after 6h) the raw path, BART-base + VL-PET-large + RN101 at 224
     px with --use_vis_adapter (middle-bottleneck, reduction 2), fp32,
     from the weights after unzero, under a Trainer run's library
     settings (device.deterministic_kernels): phase 6's train parity over
     3 vqa steps at B 8 (S 69) and one NLVR two-image step at B 4 (S 118,
     its route printed), each also taken again from the same state and
     bit for bit the first, the trunk's BatchNorm statistics unchanged;
     caption
     beam-5 and greedy tokens at B 8 to length 40, kernels vs plain,
     identical. Then the importers at full shape, from seeded state dicts
     whose names and shapes are written out here: OpenAI CLIP RN101 and
     ViT-B/32 at 224 and 448 px (no skipped key; the RN101 attention
     pool's positions resized at 448); HF BART-base (vocabulary 50265)
     through a .safetensors file into a 50365-row model and T5-base
     (32128) through a torch .bin into 32200 rows: every named tensor
     equal to the file's, the added rows at their init;
  7h. (run after 7g) what the raw path costs, bf16: (a) the trunks alone
     (RN50, RN101, ViT-B/32 at 224, RN101 at 448; B 256, forward and
     forward + backward of a pooled-sum loss: images/s, peak GiB); (b) the
     raw VL-PET-large vqa step at B 500 (the largest multiple of 50 that
     fits) under a Trainer run's library settings (cuDNN deterministic,
     no autotuner; ``chip_phases.py`` 7i, not run here, times the adapter
     step under cuDNN's autotuner too) with a frozen trunk,
     --use_vis_adapter (the raw_step run) and --unfreeze_vis_encoder,
     and a raw T5-base step at B 300: ms/step, examples/s, peak GiB, the
     trunk's share of the step (CUDA events around vis_forward); (c) the
     raw caption beam-5 eval at B 500 to length 40 (the raw_eval run) and
     the NLVR two-image scoring at B 166;
     (d) the extractor (RN101, 224 px, fp32) over 2048 seeded images at B
     256, images/s, PackedFeatureSource against a direct forward;
  8d. (after 8c) the user's pipeline on the CLI: the extractor's loop
     writes vqa and caption features for seeded images beside seeded
     annotation json; ``cli.multitask`` with VL-PET-large.sh's flags +
     --bf16 --backbone_ckpt <seeded BART-base .safetensors>, vqa and
     caption, one epoch, evaluated, then --resume bit for bit (the
     cli_features run); the same flags with --feature_type raw_RN101
     --image_size "(224,224)" --clip_ckpt <seeded RN101 .pt>
     --use_vis_adapter on seeded PNGs, vqa and nlvr, two epochs (the
     cli_raw run; the second epoch's ms/step has no first step in it),
     then that run's train loader alone in this process (seconds a
     batch, no step).
  6j. (after 6i) the VL-PET ablation flags (``ABLATIONS``: eleven
     families, each the VL-PET-large recipe with one group of flags
     swapped in at its dims -- the multihead up / down-up / pair adapters,
     the LayerNorm and L2 gates, the standalone gate in both forms, the
     key parallel adapter, the decoder's multihead and key-value
     adapters, the sequential value adapter with the residual and its
     gate, the VPA's residual gate and the multihead and pair VPAs, the
     decoder's down-dim adapters, cross and FFN IA3 with the four value
     flags that build nothing, the low-rank visual projector on BART-base
     and T5-base, single_adapter.sh with track_z and lambda_z 1e-3):
     phase 6c's fp32 per-step train parity from the weights after
     ``unzero`` under phase 6's tolerances (B 8, vqa,
     ``ABL_PARITY_LAYERS``; T5 under 6c's), then for families 4-9
     phase 4 (a)'s beam-5 and greedy caption tokens at B 8, identical;
  7j. (after 7h) each ablation's bf16 vqa train step (B 500, T5-base B
     300; 2 warm-up and 5 timed steps: ms/step, peak GiB) beside
     VL-PET-large's on both backbones, the track_z recipe again at
     lambda_z 0, and the beam-5 caption eval (B 500 to
     length 40) of families 4, 6, 8 and 9 (the abl_* runs); under the
     decoder FFN's IA3 F1 and F2 launch at the encoder's sites only
     (the decoder FFN takes the plain chain, as in the JAX package).
  6k. (after 6j) the remaining PET flags (``PET_FLAGS``: prefix tuning
     with encoder and decoder prefixes of 40, the visual prefix on
     VL-PET-large, the decoder input prompt of 40 on BART-base and
     T5-base, the LM-head adapter on VL-PET-large with use_fused_ce, and
     single_adapter.sh, single_compacter.sh, hyperformer.sh,
     single_prompt.sh, single_lora.sh and the low-rank adapter on T5-base):
     A1 and A6 alone at the causal L 10 over S 50 and the L 56 over S 96
     sites the prefixes make (fp32 B 8, bf16 B 500), then per family 6j's
     per-step train parity and phase 4 (b)'s beam-5 / greedy caption
     tokens (1+1 layers, std 0.2; on T5 the trainable parameters at their
     init);
  7k. (after 7j) each family's bf16 vqa step (B 500, T5-base B 300; 3
     steps after 1) beside VL-PET-large's on both backbones and its
     beam-5 caption eval (B 500 / 300, length 40; the pf_* runs): A6 on
     "tc" everywhere (the wide kernel where a prefix or prompt makes S 96,
     those steps held to the plain step), no C1 / C2 under the LM-head
     adapter, the prefix eval's D1 and U1 launches a step equal to
     VL-PET-large's.
  6l. (after 6k) the last single-card paths, fp32, kernels vs plain:
     first A1 and A6 at rate 0.1 at BART's sites (B 500 bf16 and B 8
     fp32: the encoder's S 56, the causal decoder L 10, the cross L 10
     over S 56, the classify decoder's one token over S 56 and over
     itself), the long backward at rate 0.1 at the video encoder (B 50, S
     604) and F1 / F2 gelu with hidden dropout at N 28000 and 5000; then
     the classifier (``TAIL["cls"]``: BART-base, and T5-base at 2+2
     layers, num_answers 3129), 6j's per-step train parity over 3 vqa
     steps at B 8 and predict_classifier's argmax identical; VL-PET-large
     at attention and activation dropout 0.1, 3 vqa steps at B 8 and one
     tvqa step at B 2, S 604 (the long backward's dropout at BART's
     sites); remat "full" and "dots" against "none" through the kernels
     (loss and every gradient, their largest difference printed); one
     vis.sparse_sample step (49 visual tokens subsampled to 36); a forward
     and backward of each models/bart_heads.py class at BART-base width;
  7l. (after 7k) bf16 vqa steps, B 500 (T5-base B 300; 3 after 1): the
     classifier beside VL-PET-large's LM step on both backbones,
     VL-PET-large at both dropouts 0.1 (beside 0: the LM step), remat
     "full" and "dots" (beside "none"): ms/step, examples/s, peak GiB and
     the launches a step of A1, A6, F1, F2, L1 and L2 (the tail_* runs;
     under remat the forward kernels launch twice a step);
  8e. (after 8d) ``cli.multitask`` with VL-PET-large.sh's flags +
     --classifier --bf16 on vqa, CLS_CLI_EXAMPLES synthetic examples, one
     epoch, the predict_classifier eval, then --resume (the saved state's
     digest bit for bit; the cli_classifier run).
  9. data parallelism on the one card (``phase_data_parallel``): every
     rank a process that vlpet_tpu_torch/parallel/launch.py spawns on
     cuda:0 and that joins its group through the CLIs' init from
     torchrun-style environment. (a) world 1 over NCCL: the bf16 B 500
     vqa step bit for bit the one-process step; (b) world 2 over gloo
     (NCCL refuses two ranks on one card), B 250 a rank of the same
     batch: the loss within BF16_STEP_RTOL of (a)'s; (c) world 2, fp32
     B 16, dropout, attention and activation dropout 0.1: 3 steps, each
     from the one-process run's state, by phase 6c's per-step rule; (d)
     world 2 fp32 beam 5 to length 20, B 4 a rank: the merged tokens
     identical to one process's B 8. Each rank's launches a step equal
     one process's (A1 18, A6 17, F1 12, F2 12, L1 30, L2 29). Two ranks
     sharing one card time nothing about multi-card speed.
  10. tensor parallelism on the one card (``phase_tensor_parallel``):
     the ranks of a (data, model) mesh spawned on cuda:0 over gloo, each
     holding its heads and FFN hidden columns (parallel/mesh.py
     shard_model). (a) (1, 2): the bf16 B 500 vqa step of the full-width
     flagship, the loss within BF16_STEP_RTOL of one process's (the
     tp_train run); (b) (1, 2), fp32 B 16 at every dropout 0.1, 2+2
     layers at full width, 3 steps each from the one-process state by
     phase 6c's rule, BART and gated T5 (F3 / F4 at the column base: the
     tp_t5_gated_train run); (c) (1, 4), fp32 B 16, 2+2 layers (3 heads
     and 768 hidden columns a rank), one step by the same rule; (d)
     (1, 2), fp32 beam 5 with use_fused_beam and greedy, B 4 on both
     ranks, 2+2 layers at full width: tokens identical to one process's
     (tp_decode); (e) in this process, first and alone on the card (it
     times), F1 / F2 (gelu, biases) and F3 / F4 (gelu_new) at a column
     base, bf16, N 28000, D 768, rate 0.1: F1 / F2 at Fh 1536 and 768 of
     3072 (and F1 at the beam rows N 2500), F3 / F4 at Fh 1024 and 512 of
     the gated T5's 2048, against their plain twins, twice bitwise, the
     masks bit for bit (picking weights), the Fh 1536 / 1024 cases timed
     with their bound (the "+colbase" modes); (f) each rank's launches a
     step equal one process's: (a)'s A1, A6, F1, F2, L1, L2 and a bf16
     video step at S 604, B 50, 2+2 layers, the long backward's
     (tp_video_train); (g) (1, 2), bf16 B 500 vqa at full width, one
     step of single_lora.sh's recipe and one of full_finetuning.sh's from
     one process's state: the loss within BF16_STEP_RTOL, the gathered
     trainable tensors bit for bit the same on both ranks, each rank's
     launches one process's (no F1 / F2 under full fine-tuning); (h)
     (1, 2), fp32 B 16 at every dropout 0.1, 2+2 layers at full width, 3
     steps of each ``TP_FAMILIES`` entry from the one-process state by
     phase 6c's rule (a bias added to every key, whose true gradient is
     zero, by phase 6's elementwise rule: ``zero_grad``) -- LoRA (its dropout 0.1), the attention prefixes,
     the visual prefix, the cross and decoder-FFN IA3, the multihead VPA
     with the key parallel adapter, BitFit and full fine-tuning with a
     clip below every step's norm, the classifier, remat "full", the raw
     path on its smallest trunk (RN50, B 4) -- each rank's launches one
     process's; beam-5 and greedy tokens of the LoRA and prefix families
     identical to one process's; (i) a BitFit Trainer at (1, 2), from
     unzero-ed weights in a LAST.npz, writes a checkpoint after 2 steps (its split biases, moments and master
     copies gathered whole); one process restores it (the state digest
     the ranks'), takes 2 more steps and ends where an uninterrupted
     one-process run ends, by phase 6c's rule. (a)+(b)+(g)+half of (h),
     (d)+(f)+(h)'s other half+(i) and (c) are three process groups
     spawned together, and together
     with phase 9's two worlds (``phase_parallel``; each phase alone:
     ``phase_data_parallel``, ``phase_tensor_parallel``). Nothing here
     times tensor-parallel speed.
Each of 3n, 3o, 3p, 6g, 6h, 6i, 6j, 6k, 6l, 7f, 7g, 7h, 7j, 7k, 7l, 8b, 8c,
8d and 8e prints its seconds; 9 and 10 print their own.
Routes: each kernel-vs-plain line of A1, A6, the long backward, L1 and
L2 prints the route it launched (ops/attention.py forward_route for A1
and the long backward, a6_route for A6: "tc", the tensor-core kernels,
for bf16 at Dh 64 -- and, for A6, L, S <= 256; "fma" otherwise;
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

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import random
import re
import shlex
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import torch
import torch.nn.functional as F

from vlpet_tpu_torch.config import (FLAGSHIP_TASKS, VIDEO_TASKS, PetConfig,
                                    flagship_cfg, t5_cfg, t5_video_cfg,
                                    video_cfg, vlpet_recipe)
from vlpet_tpu_torch.data.features import PackedFeatureSource
from vlpet_tpu_torch.device import deterministic_kernels
from vlpet_tpu_torch.models.bart_heads import (BartForQuestionAnswering,
                                               BartForSequenceClassification)
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.heads import task_loss
from vlpet_tpu_torch.models.hf_import import (bart_hf_to_port,
                                              load_torch_state_dict,
                                              t5_hf_to_port)
from vlpet_tpu_torch.models.t5 import VLT5
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import (_build, attention, cache_update, decode, ffn,
                                 fused_ce, fused_ln, plain_twins, topk)
from vlpet_tpu_torch.ops.hashdrop import keep_mask
from vlpet_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                           gather_state_dict, shard_model,
                                           shard_state_dict)
from vlpet_tpu_torch.pet.modules import PetContext
from vlpet_tpu_torch.train.freezing import apply_freezing
from vlpet_tpu_torch.train.optim import build_optimizer
from vlpet_tpu_torch.train.steps import make_train_step
from vlpet_tpu_torch.vision.clip import CLIPVisualEncoder, resize_pos_embed
from vlpet_tpu_torch.vision.clip_import import load_clip_state_dict
from vlpet_tpu_torch.vision.extract import write_features
from vlpet_tpu_torch.vision.vis_encoder import RawInputVLModel

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
# calls of a plain twin's (and a library call's) timed median; the
# kernel's own median takes ``iters`` (20 unless a case says otherwise)
TWIN_ITERS = 3

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
# phase 8: the image-text CLI (train step and beam-5 / greedy eval)
CLI = "cli_multitask"
T5 = ("t5_eval", "t5_gated_eval")
T5_TRAIN = ("t5_train", "t5_gated_train")
FUSED_CE = ("train_fused_ce", "t5_train_fused_ce")
FUSED_BEAM = ("decode_fused_beam", "t5_eval_fused_beam")
# the T5 video and trainable-bias paths: the bf16 runs of phases 5e and 7e,
# and the fp32 BitFit runs of phase 6e (the only runs of the long
# backward's dbias: no run script trains T5's bias at the video shape)
T5V_EVAL, T5V_TRAIN, FULL_FT = "t5_video_eval", "t5_video_train", "t5_full_ft"
BITFIT, T5V_BITFIT = "t5_bitfit", "t5_video_bitfit"
# the PET baselines' scripts (scripts/image-text/*.sh) on BART-base: phase
# 7f's bf16 train steps (PET_TRAIN; full fine-tuning takes the plain FFN
# chain) and beam-5 evals (PET_EVAL), and phase 8b's CLI run of the prompt
# script (CLI_PROMPT, whose nlvr sites take A6 past 128 rows)
PET_SCRIPTS = ("single_adapter", "single_compacter", "single_lora",
               "single_prompt", "hyperformer", "bitfit", "full_finetuning")
PET_TRAIN = tuple(f"pet_{n}" for n in PET_SCRIPTS)
PET_FFN_TRAIN = tuple(p for p in PET_TRAIN if p != "pet_full_finetuning")
PET_EVAL = ("pet_single_lora_eval", "pet_single_prompt_eval",
            "pet_hyperformer_eval")
CLI_PROMPT = "cli_single_prompt"
# the ten video scripts (scripts/video-text/*.sh) on BART-base: phase 7g's
# bf16 train steps at tvqa (S 664, 704 with the prompt; full fine-tuning
# takes the plain FFN chain) and VL-PET-large's at tvc (S 141: A6 past 128
# rows at the encoder and cross-attention), VL-PET-large's greedy tvqa and
# beam-5 tvc evals
# (VS_QA_EVAL, VS_CAP_EVAL); phase 8c's CLI runs: cli.multitask_video with
# VL-PET-large.sh's flags (CLI_VIDEO) and cli.single_task tvqa with
# single_prompt.sh's (CLI_VIDEO_PROMPT, greedy eval only)
VIDEO_GATES = ("VL-PET-small", "VL-PET-middleX", "VL-PET-middleY",
               "VL-PET-large")
VIDEO_SCRIPTS = VIDEO_GATES + ("single_adapter", "single_compacter",
                               "single_lora", "single_prompt", "bitfit",
                               "full_finetuning")
VS_TVQA_TRAIN = tuple(f"video_{n}" for n in VIDEO_SCRIPTS)
VS_TRAIN = VS_TVQA_TRAIN + ("video_VL-PET-large_tvc",)
VS_FFN_TRAIN = tuple(p for p in VS_TRAIN if p != "video_full_finetuning")
VS_QA_EVAL, VS_CAP_EVAL = ("video_VL-PET-large_tvqa_eval",
                           "video_VL-PET-large_tvc_eval")
CLI_VIDEO, CLI_VIDEO_PROMPT = "cli_video", "cli_video_single_prompt"
VS_EVAL_CLI = (VS_QA_EVAL, VS_CAP_EVAL, CLI_VIDEO, CLI_VIDEO_PROMPT)
# the raw-image path (phases 7h and 8d): the raw vqa step with
# --use_vis_adapter (RAW_STEP) and the raw caption beam-5 eval (RAW_EVAL),
# the CLI on extracted features (CLI_FEATURES: vqa and caption) and on raw
# images (CLI_RAW: vqa and nlvr, greedy eval and scoring only)
RAW_STEP, RAW_EVAL = "raw_step", "raw_eval"
CLI_FEATURES, CLI_RAW = "cli_features", "cli_raw"
RAW_TRAIN = (RAW_STEP, CLI_FEATURES, CLI_RAW)
RAW_ALL = (RAW_STEP, RAW_EVAL, CLI_FEATURES, CLI_RAW)
# the VL-PET ablation flags (phases 6j and 7j): name -> (family, the PET
# and visual flags over VL-PET-large's; ABLATIONS below). Phase 7j's bf16
# train steps (ABL_TRAIN on BART-base, ABL_T5_TRAIN on T5-base; the
# track_z recipe also at lambda_z 0, and VL-PET-large itself on both
# backbones for reference) and beam-5 evals (ABL_EVAL)
ABL_BART = ("mh_up", "mh_down_up", "mh_pair", "gating_layernorm",
            "gating_l2norm", "standalone_gating", "standalone_gating_add_x2",
            "key_parallel", "decoder_mh_kv_adapter", "sequential_va",
            "vpa_residual_gate", "mh_vpa", "pair_vpa", "decoder_adapters",
            "ia3", "lowrank_visual_projector", "track_z")
ABL_TRAIN = tuple(f"abl_{n}" for n in ABL_BART) + ("abl_track_z_lambda0",
                                                   "abl_vlpet_large")
ABL_T5_TRAIN = ("abl_t5_lowrank_visual_projector", "abl_t5_vlpet_large")
ABL_DECODE = ("key_parallel", "decoder_mh_kv_adapter", "sequential_va",
              "vpa_residual_gate", "mh_vpa", "pair_vpa", "decoder_adapters",
              "ia3")
ABL_EVAL_NAMES = ("key_parallel", "sequential_va", "decoder_adapters", "ia3")
ABL_EVAL = tuple(f"abl_{n}_eval" for n in ABL_EVAL_NAMES)
# the remaining PET flags (phases 6k and 7k; PET_FLAGS below): bf16 train
# steps on BART-base (PF_TRAIN) and T5-base (PF_T5_TRAIN; the T5 LoRA
# recipe trains the relative bias: PF_DBIAS) and beam-5 evals (PF_EVAL),
# VL-PET-large on both backbones beside them
PF_BART = ("prefix", "vis_prefix", "decoder_prompt", "lm_head_adapter")
PF_T5 = ("t5_decoder_prompt", "t5_single_adapter", "t5_single_compacter",
         "t5_hyperformer", "t5_single_prompt", "t5_single_lora",
         "t5_single_lradapter")
PF_TRAIN = tuple(f"pf_{n}" for n in PF_BART) + ("pf_vlpet_large",)
PF_T5_TRAIN = tuple(f"pf_{n}" for n in PF_T5) + ("pf_t5_vlpet_large",)
PF_DBIAS = ("pf_t5_single_lora",)
PF_EVAL = tuple(f"pf_{n}_eval" for n in PF_BART + PF_T5) + (
    "pf_vlpet_large_eval",)
# the last single-card paths (phases 6l, 7l, 8e; TAIL below): phase 7l's
# bf16 steps on BART-base (TAIL_TRAIN: the LM step, the classifier, both
# dropouts 0.1, remat full and dots; TAIL_DROP the dropping one) and
# T5-base (TAIL_T5_TRAIN), 6l's fp32 video step at both dropouts 0.1
# (TAIL_VIDEO_DROP: the long backward's dropout at BART's sites) and 8e's
# CLI run with --classifier (CLI_CLS: train steps and predict_classifier)
TAIL_DROP, TAIL_VIDEO_DROP, CLI_CLS = ("tail_drop", "tail_video_drop",
                                       "cli_classifier")
TAIL_TRAIN = ("tail_vlpet_large", "tail_cls", TAIL_DROP, "tail_remat_full",
              "tail_remat_dots")
TAIL_T5_TRAIN = ("tail_t5_vlpet_large", "tail_t5_cls")
TAIL_ALL = TAIL_TRAIN + (CLI_CLS,)
# tensor parallelism (phase 10): rank 0's runs at (1, 2) -- (a)'s bf16
# step, (b)'s gated T5 step, (f)'s video step and (d)'s fused beam-5
TP_TRAIN, TP_T5, TP_VIDEO, TP_DECODE = ("tp_train", "tp_t5_gated_train",
                                        "tp_video_train", "tp_decode")
KERNELS = {
    "fused_attention": ("vlpet_tpu_torch/csrc/attention.cu",
                        "vlpet_tpu/ops/attention.py:408",
                        DECODE + TRAIN + T5 + (T5V_EVAL, T5V_TRAIN, FULL_FT,
                                               CLI) + PET_TRAIN + PET_EVAL
                        + (CLI_PROMPT,) + VS_TRAIN + VS_EVAL_CLI + RAW_ALL
                        + ABL_TRAIN + ABL_EVAL + PF_TRAIN + PF_EVAL
                        + TAIL_ALL + (TP_TRAIN, TP_VIDEO, TP_DECODE)),
    "fused_attention_bwd": ("vlpet_tpu_torch/csrc/attention_bwd.cu",
                            "vlpet_tpu/ops/attention.py:1082",
                            TRAIN + (T5V_TRAIN, FULL_FT, CLI) + PET_TRAIN
                            + (CLI_PROMPT,) + VS_TRAIN
                            + (CLI_VIDEO, CLI_VIDEO_PROMPT) + RAW_TRAIN
                            + ABL_TRAIN + PF_TRAIN + TAIL_ALL
                            + (TP_TRAIN, TP_VIDEO)),
    # A6's tensor-core kernel past 128 rows (attention_bwd_tc_256): the
    # prompt's nlvr sites (S 142), the video tvc sites (S 141), the raw
    # 448 px encoder (S 216; phase 3p)
    "fused_attention_bwd past 128": ("vlpet_tpu_torch/csrc/attention_bwd.cu",
                                     "vlpet_tpu/ops/attention.py:1082",
                                     (CLI_PROMPT, "video_VL-PET-large_tvc",
                                      CLI_VIDEO)),
    "fused_attention_bwd_long": ("vlpet_tpu_torch/csrc/attention_bwd_long.cu",
                                 "vlpet_tpu/ops/attention.py:641, "
                                 "vlpet_tpu/ops/attention.py:918",
                                 ("video_train", T5V_TRAIN) + VS_TVQA_TRAIN
                                 + (CLI_VIDEO, CLI_VIDEO_PROMPT, TP_VIDEO)),
    "fused_ffn": ("vlpet_tpu_torch/csrc/ffn.cu", "vlpet_tpu/ops/ffn.py:240",
                  DECODE + TRAIN + ("t5_eval", T5V_EVAL, T5V_TRAIN, CLI)
                  + PET_FFN_TRAIN + PET_EVAL + (CLI_PROMPT,) + VS_FFN_TRAIN
                  + VS_EVAL_CLI + RAW_ALL + ABL_TRAIN + ABL_EVAL + PF_TRAIN
                  + PF_EVAL + TAIL_ALL),
    "fused_ffn_bwd": ("vlpet_tpu_torch/csrc/ffn.cu",
                      "vlpet_tpu/ops/ffn.py:195",
                      TRAIN + (T5V_TRAIN, CLI) + PET_FFN_TRAIN
                      + (CLI_PROMPT,) + VS_FFN_TRAIN
                      + (CLI_VIDEO, CLI_VIDEO_PROMPT) + RAW_TRAIN + ABL_TRAIN
                      + PF_TRAIN + TAIL_ALL),
    "fused_dropout_add_ln": ("vlpet_tpu_torch/csrc/fused_ln.cu",
                             "vlpet_tpu/ops/fused_ln.py:251",
                             TRAIN + (CLI,) + PET_TRAIN + (CLI_PROMPT,)
                             + VS_TRAIN + (CLI_VIDEO, CLI_VIDEO_PROMPT)
                             + RAW_TRAIN + ABL_TRAIN + PF_TRAIN + TAIL_ALL
                             + (TP_TRAIN, TP_VIDEO)),
    "fused_dropout_add_ln_bwd": ("vlpet_tpu_torch/csrc/fused_ln.cu",
                                 "vlpet_tpu/ops/fused_ln.py:270",
                                 TRAIN + (CLI,) + PET_TRAIN + (CLI_PROMPT,)
                                 + VS_TRAIN + (CLI_VIDEO, CLI_VIDEO_PROMPT)
                                 + RAW_TRAIN + ABL_TRAIN + PF_TRAIN
                                 + TAIL_ALL + (TP_TRAIN, TP_VIDEO)),
    "beam_decode_attend": ("vlpet_tpu_torch/csrc/beam_attend.cu",
                           "vlpet_tpu/ops/decode.py:174",
                           DECODE + T5 + (T5V_EVAL, CLI) + PET_EVAL
                           + (CLI_PROMPT, VS_CAP_EVAL, CLI_VIDEO, RAW_EVAL,
                              CLI_FEATURES) + ABL_EVAL + PF_EVAL),
    "topk_lse": ("vlpet_tpu_torch/csrc/topk.cu", "vlpet_tpu/ops/topk.py:159",
                 DECODE + T5 + (T5V_EVAL, CLI) + PET_EVAL + (CLI_PROMPT,)
                 + VS_EVAL_CLI + (RAW_EVAL, CLI_FEATURES, CLI_RAW)
                 + ABL_EVAL + PF_EVAL + (TP_DECODE,)),
    "fused_gated_ffn": ("vlpet_tpu_torch/csrc/ffn.cu",
                        "vlpet_tpu/ops/ffn.py:334", ("t5_gated_eval",)),
    "fused_gated_ffn_bwd": ("vlpet_tpu_torch/csrc/ffn.cu",
                            "vlpet_tpu/ops/ffn.py:354", ("t5_gated_train",)),
    "fused_attention +bias +dropout": ("vlpet_tpu_torch/csrc/attention.cu",
                                       "vlpet_tpu/ops/attention.py:408",
                                       T5_TRAIN + (T5V_TRAIN, FULL_FT)
                                       + ABL_T5_TRAIN + PF_T5_TRAIN
                                       + TAIL_T5_TRAIN + (TP_T5,)),
    "fused_attention_bwd +bias +dropout": (
        "vlpet_tpu_torch/csrc/attention_bwd.cu",
        "vlpet_tpu/ops/attention.py:1082", T5_TRAIN + (T5V_TRAIN, FULL_FT)
        + ABL_T5_TRAIN + PF_T5_TRAIN + TAIL_T5_TRAIN + (TP_T5,)),
    "fused_attention_bwd +dbias": (
        "vlpet_tpu_torch/csrc/attention_bwd.cu",
        "vlpet_tpu/ops/attention.py:1082", (FULL_FT, BITFIT, T5V_BITFIT)
        + PF_DBIAS),
    "fused_attention_bwd_long +bias +dropout": (
        "vlpet_tpu_torch/csrc/attention_bwd_long.cu",
        "vlpet_tpu/ops/attention.py:641, vlpet_tpu/ops/attention.py:918",
        (T5V_TRAIN,)),
    "fused_attention_bwd_long +dbias": (
        "vlpet_tpu_torch/csrc/attention_bwd_long.cu",
        "vlpet_tpu/ops/attention.py:641", (T5V_BITFIT,)),
    "fused_ffn relu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                "vlpet_tpu/ops/ffn.py:175",
                                ("t5_train", T5V_TRAIN) + ABL_T5_TRAIN
                                + PF_T5_TRAIN + TAIL_T5_TRAIN),
    "fused_ffn_bwd relu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                    "vlpet_tpu/ops/ffn.py:195",
                                    ("t5_train", T5V_TRAIN) + ABL_T5_TRAIN
                                    + PF_T5_TRAIN + TAIL_T5_TRAIN),
    # BART's attention and activation dropout (phase 6l's timed cases)
    "fused_attention +dropout": ("vlpet_tpu_torch/csrc/attention.cu",
                                 "vlpet_tpu/ops/attention.py:408",
                                 (TAIL_DROP, TAIL_VIDEO_DROP)),
    "fused_attention_bwd +dropout": ("vlpet_tpu_torch/csrc/attention_bwd.cu",
                                     "vlpet_tpu/ops/attention.py:1082",
                                     (TAIL_DROP,)),
    "fused_attention_bwd_long +dropout": (
        "vlpet_tpu_torch/csrc/attention_bwd_long.cu",
        "vlpet_tpu/ops/attention.py:641, vlpet_tpu/ops/attention.py:918",
        (TAIL_VIDEO_DROP,)),
    "fused_ffn gelu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                "vlpet_tpu/ops/ffn.py:175",
                                (TAIL_DROP, TAIL_VIDEO_DROP)),
    "fused_ffn_bwd gelu +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                    "vlpet_tpu/ops/ffn.py:195",
                                    (TAIL_DROP, TAIL_VIDEO_DROP)),
    "fused_gated_ffn +dropout": ("vlpet_tpu_torch/csrc/ffn.cu",
                                 "vlpet_tpu/ops/ffn.py:334",
                                 ("t5_gated_train",)),
    "fused_linear_ce": ("vlpet_tpu_torch/csrc/fused_ce.cu",
                        "vlpet_tpu/ops/fused_ce.py:115", FUSED_CE),
    "fused_linear_ce_bwd": ("vlpet_tpu_torch/csrc/fused_ce.cu",
                            "vlpet_tpu/ops/fused_ce.py:147", FUSED_CE),
    "beam_decode_attend_update": ("vlpet_tpu_torch/csrc/beam_attend.cu",
                                  "vlpet_tpu/ops/decode.py:249",
                                  FUSED_BEAM + (TP_DECODE,)),
    # the FFN kernels at a tensor-parallel rank's column base (phase 10 (e)
    # times them; every FFN of a split model launches in this mode)
    "fused_ffn +colbase": ("vlpet_tpu_torch/csrc/ffn.cu",
                           "vlpet_tpu/ops/ffn.py:240",
                           (TP_TRAIN, TP_VIDEO, TP_DECODE)),
    "fused_ffn_bwd +colbase": ("vlpet_tpu_torch/csrc/ffn.cu",
                               "vlpet_tpu/ops/ffn.py:195",
                               (TP_TRAIN, TP_VIDEO)),
    "fused_gated_ffn +colbase": ("vlpet_tpu_torch/csrc/ffn.cu",
                                 "vlpet_tpu/ops/ffn.py:334", (TP_T5,)),
    "fused_gated_ffn_bwd +colbase": ("vlpet_tpu_torch/csrc/ffn.cu",
                                     "vlpet_tpu/ops/ffn.py:354", (TP_T5,)),
    "cache_slot_update": ("vlpet_tpu_torch/csrc/cache_update.cu",
                          "vlpet_tpu/ops/cache_update.py:31",
                          DECODE + T5 + (CLI,) + PET_EVAL + (CLI_PROMPT,)
                          + VS_EVAL_CLI + (RAW_EVAL, CLI_FEATURES, CLI_RAW)
                          + ABL_EVAL + PF_EVAL),
}
MODES = {"fused_attention +bias +dropout": "fused_attention",
         "fused_attention_bwd past 128": "fused_attention_bwd.tc256",
         "fused_attention_bwd +bias +dropout": "fused_attention_bwd",
         "fused_attention_bwd +dbias": "fused_attention_bwd.dbias",
         "fused_attention_bwd_long +bias +dropout": "fused_attention_bwd_long",
         "fused_attention_bwd_long +dbias": "fused_attention_bwd_long.dbias",
         "fused_ffn relu +dropout": "fused_ffn",
         "fused_ffn_bwd relu +dropout": "fused_ffn_bwd",
         "fused_gated_ffn +dropout": "fused_gated_ffn",
         "fused_attention +dropout": "fused_attention",
         "fused_attention_bwd +dropout": "fused_attention_bwd",
         "fused_attention_bwd_long +dropout": "fused_attention_bwd_long",
         "fused_ffn gelu +dropout": "fused_ffn",
         "fused_ffn_bwd gelu +dropout": "fused_ffn_bwd",
         "fused_ffn +colbase": "fused_ffn",
         "fused_ffn_bwd +colbase": "fused_ffn_bwd",
         "fused_gated_ffn +colbase": "fused_gated_ffn",
         "fused_gated_ffn_bwd +colbase": "fused_gated_ffn_bwd"}
# the run whose launch count the kernels' JSON record reports: the first of
# these that launches the kernel
MAIN_PATH_ORDER = ("train", "decode", "video_train", "video_eval", "t5_eval",
                   "t5_gated_eval", "t5_train", "t5_gated_train") + FUSED_CE \
    + FUSED_BEAM + (T5V_EVAL, T5V_TRAIN, FULL_FT, BITFIT, T5V_BITFIT, CLI) \
    + PET_TRAIN + PET_EVAL + (CLI_PROMPT,) + VS_TRAIN + VS_EVAL_CLI + RAW_ALL \
    + ABL_TRAIN + ABL_T5_TRAIN + ABL_EVAL + PF_TRAIN + PF_T5_TRAIN + PF_EVAL \
    + TAIL_TRAIN + TAIL_T5_TRAIN + (TAIL_VIDEO_DROP, CLI_CLS) \
    + (TP_TRAIN, TP_T5, TP_VIDEO, TP_DECODE)
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
        # the twins' and the library's medians over fewer calls: the plain
        # twins take up to 60 ms a call, and the smoke has 1200 s in all
        pms = cuda_ms(plain_fn, min(iters, TWIN_ITERS), warmup=1)
        lms = (cuda_ms(library_fn, min(iters, TWIN_ITERS), warmup=1)
               if library_fn is not None else None)
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
    cli_train_sites(rep)


# The image-text CLI's (phase 8) train shapes that the B 500 sites above
# miss, at the pooled 36 boxes: caption B 416 (500 * 50/60), L 40 + 36,
# target 40; nlvr B 166 (500 * 20/60), L 30 + 2 * 36, target 10. A6 takes
# its wide tensor-core kernel past L, S 64. (site, B, L, S, causal)
CLI_ATTENTION_SITES = (("caption enc", 416, 76, 76, False),
                       ("caption dec-self", 416, 40, 40, True),
                       ("caption cross", 416, 40, 76, False),
                       ("nlvr enc", 166, 102, 102, False),
                       ("nlvr cross", 166, 10, 102, False))
# gqa's encoder rows (833 * 56) and caption's (416 * 76)
CLI_ROWS = (46648, 31616)


def cli_train_sites(rep: Report) -> None:
    """A1, A6, F1, F2, L1 and L2 in bf16 at CLI_ATTENTION_SITES and
    CLI_ROWS, against their plain twins (A6 also bit for bit on a repeat),
    with times, bounds and library calls."""
    g = torch.Generator(device="cuda").manual_seed(8)
    randn = randn_fn(g)
    dtype, e = torch.bfloat16, 2
    H, Dh = 12, 64
    inner = H * Dh
    for site, B, L, S, causal in CLI_ATTENTION_SITES:
        mask = (torch.zeros((1, 1, 1, S), device="cuda") if causal
                else padding_mask(g, B, S))
        q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
        k, v, do = (randn(B, n, inner, dtype=dtype) for n in (S, S, L))
        label = f"bf16 {site} B{B} L{L} S{S}" + (" causal" if causal else "")
        lmask = causal_mask(mask, L, S) if causal else mask
        seen = (attention._causal_allowed(L, S, "cuda").float().mean().item()
                if causal else 1.0)
        rep.check("fused_attention", label,
                  lambda: attention.fused_attention(q, k, v, mask, H, causal),
                  lambda: attention.fused_attention_reference(
                      q, k, v, mask, H, causal), dtype,
                  work=(e * 2 * B * (L + S) * inner + 4 * B * S,
                        4 * B * H * L * S * Dh * seen),
                  library_fn=lambda: sdpa(q, k, v, lmask, H))
        plain_bwd = _grads_of(
            lambda a, b, c: attention.fused_attention_reference(
                a, b, c, mask, H, causal), (q, k, v), do)
        lib_bwd = _grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H),
                            (q, k, v), do.view(B, L, H, Dh).transpose(1, 2))
        rep.check("fused_attention_bwd", label,
                  lambda: attention.fused_attention_bwd(q, k, v, mask, do, H,
                                                        causal),
                  plain_bwd, dtype,
                  work=(e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
                        10 * B * H * L * S * Dh * seen),
                  library_fn=lib_bwd, backward=True)
        bitwise_repeat("fused_attention_bwd", label,
                       lambda: attention.fused_attention_bwd(
                           q, k, v, mask, do, H, causal))
        routes_beside(q, k, v, mask, do, H, causal, label, rep.last[0])
    D, Fh = 768, 3072
    w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                          scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    for N in CLI_ROWS:
        x, dy, res = (randn(N, D, dtype=dtype) for _ in range(3))
        label = f"bf16 N{N} D{D} F{Fh} gelu"
        rep.check("fused_ffn", label,
                  lambda: ffn.fused_ffn(x, w1, b1, w2, b2, "gelu"),
                  lambda: ffn.ffn_reference(x, w1, b1, w2, b2, "gelu"), dtype,
                  work=(e * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                        4 * N * D * Fh))
        plain_bwd = _grads_of(
            lambda a, c, d: ffn.ffn_reference(a, w1, c, w2, d, "gelu"),
            (x, b1, b2), dy)
        rep.check("fused_ffn_bwd", label,
                  lambda: ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu"),
                  plain_bwd, dtype,
                  work=(e * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                        6 * N * D * Fh), backward=True)
        gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                             device="cuda", dtype=torch.int32)
        for rate in (0.1, 0.0):
            label = f"bf16 N{N} D{D} rate {rate}"
            rep.check("fused_dropout_add_ln", label,
                      lambda: fused_ln.fused_dropout_add_ln(
                          x, res, gamma, beta, seed, rate),
                      lambda: fused_ln.fused_dropout_add_ln_reference(
                          x, res, gamma, beta, seed, rate), dtype,
                      work=(e * 3 * N * D + 4 * (2 * D + 1), 8 * N * D))
            plain_bwd = _grads_of(
                lambda a, b, c, d: fused_ln.fused_dropout_add_ln_reference(
                    a, b, c, d, seed, rate), (x, res, gamma, beta), dy)
            rep.check("fused_dropout_add_ln_bwd", label,
                      lambda: fused_ln.fused_dropout_add_ln_bwd(
                          x, res, gamma, seed, dy, rate),
                      plain_bwd, dtype,
                      work=(e * 5 * N * D + 4 * (3 * D + 1), 16 * N * D),
                      backward=True)


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
        key = (a6_key(L, S) if dtype == torch.bfloat16
               and max(L, S) > attention.A6_WIDE_ROWS
               else "fused_attention_bwd +dbias")

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


# phase 3n: the prompt baseline's attention sites. single_prompt.sh puts 40
# prompt tokens before the text, so the encoder's L = S and the cross
# attention's S grow by 40 over phase 3b's and phase 8's: vqa 56 -> 96,
# caption 76 -> 116, nlvr 102 -> 142. (site, B, L, S)
PROMPT_SITES = (("vqa enc", 500, 96, 96), ("vqa cross", 500, 10, 96),
                ("gqa enc", 833, 96, 96), ("caption enc", 416, 116, 116),
                ("caption cross", 416, 40, 116), ("nlvr enc", 166, 142, 142),
                ("nlvr cross", 166, 10, 142))


def phase_prompt_sites(rep: Report) -> None:
    """A1, and A6 or (where ``backward_route`` says "long") the long
    backward, in bf16 at PROMPT_SITES with a ragged padding mask, against
    the plain twin and autograd of it (phase 3b's tolerances), each
    backward twice bitwise equal; the route taken, SDPA's time (and its
    autograd's) and the bound on every line, and beside A6 the routes it
    replaced (``routes_beside``). The nlvr encoder's A6 is the timed case
    of A6 past 128 rows."""
    g = torch.Generator(device="cuda").manual_seed(14)
    randn = randn_fn(g)
    dtype, e = torch.bfloat16, 2
    H, Dh = 12, 64
    inner = H * Dh
    for site, B, L, S in PROMPT_SITES:
        mask = padding_mask(g, B, S)
        q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
        k, v, do = (randn(B, n, inner, dtype=dtype) for n in (S, S, L))
        label = f"bf16 prompt {site} B{B} L{L} S{S}"
        rep.check("fused_attention", label,
                  lambda: attention.fused_attention(q, k, v, mask, H),
                  lambda: attention.fused_attention_reference(q, k, v, mask,
                                                              H), dtype,
                  work=(e * 2 * B * (L + S) * inner + 4 * B * S,
                        4 * B * H * L * S * Dh),
                  library_fn=lambda: sdpa(q, k, v, mask, H))
        plain_bwd = _grads_of(
            lambda a, b, c: attention.fused_attention_reference(a, b, c,
                                                                mask, H),
            (q, k, v), do)
        lib_bwd = _grads_of(lambda a, b, c: sdpa(a, b, c, mask, H), (q, k, v),
                            do.view(B, L, H, Dh).transpose(1, 2))
        work = (e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
                10 * B * H * L * S * Dh)
        if attention.backward_route(L, S, Dh, dtype) == "long":
            out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H)
            key = "fused_attention_bwd_long"
            work = (work[0] + e * B * L * inner + 4 * B * H * L, work[1])

            def kernel():
                return attention.fused_attention_bwd_long(q, k, v, mask, out,
                                                          lse, do, H)
        else:
            key = a6_key(L, S)

            def kernel():
                return attention.fused_attention_bwd(q, k, v, mask, do, H)
        rep.check(key, label, kernel, plain_bwd, dtype, work=work,
                  library_fn=lib_bwd, backward=True,
                  timed=site == "nlvr enc")
        bitwise_repeat(key, label, kernel)
        if key != "fused_attention_bwd_long":
            routes_beside(q, k, v, mask, do, H, False, label, rep.last[0])
        del plain_bwd, lib_bwd
    a6_wide_modes(rep)
    a6_route_grid()


# bf16 shapes within A6's tensor-core limit (L, S <= 256) beyond the
# paths' sites, B 64: the record behind ``backward_route`` giving A6 every
# one of them (A6 faster than the long backward)
A6_ROUTE_GRID = ((1, 256), (16, 256), (64, 256), (256, 16), (129, 129),
                 (192, 192), (256, 256))


def a6_route_grid() -> None:
    """A6 at ``A6_ROUTE_GRID`` timed beside the long backward on the same
    inputs (``routes_beside``), a padding mask alone."""
    g = torch.Generator(device="cuda").manual_seed(29)
    randn = randn_fn(g)
    B, H, Dh = 64, 12, 64
    inner = H * Dh
    for L, S in A6_ROUTE_GRID:
        mask = padding_mask(g, B, S)
        q = randn(B, L, inner, dtype=torch.bfloat16, scale=Dh ** -0.5)
        k, v, do = (randn(B, n, inner, dtype=torch.bfloat16)
                    for n in (S, S, L))
        a6_ms = cuda_ms(lambda: attention.fused_attention_bwd(q, k, v, mask,
                                                              do, H))
        routes_beside(q, k, v, mask, do, H, False,
                      f"bf16 grid B{B} L{L} S{S}", a6_ms)


def a6_key(L: int, S: int) -> str:
    """The record entry of A6 at (L, S): past 128 rows its own."""
    return ("fused_attention_bwd past 128"
            if max(L, S) > attention.A6_WIDE_ROWS else "fused_attention_bwd")


def a6_fma(q, k, v, mask, do, H: int, causal: bool):
    """A6's FMA kernel on bf16 inputs, launched directly (no wrapper, no
    launch count): the route of bf16 sites past 128 rows where its fp32
    staging fits a block, until attention_bwd_tc_256. A record only."""
    B, L, inner = q.shape
    S = k.shape[1]
    m = mask.reshape(mask.shape[0], S)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _build.launch("vlpet_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), m.data_ptr(), None, None, do.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None, None, B,
                  L, S, H, inner // H, int(m.shape[0] == B), int(causal), 1,
                  0, 0, 0, 1.0)
    return dq, dk, dv


def routes_beside(q, k, v, mask, do, H: int, causal: bool, label: str,
                  a6_ms: float) -> None:
    """At an A6 site past one 64-row tile (bf16), the other routes on the
    same inputs, timed beside A6's ``a6_ms``: the long backward, from the
    output and row logsumexp of ``fused_attention_fwd_lse`` (that forward's
    time and the plain forward's printed too: the long route pays both),
    and past 128 rows, where the FMA kernel's fp32 staging fits a block
    (``backward_route`` in fp32), that kernel (``a6_fma``). Which of A6 and
    the long backward is faster. A record only: ``backward_route`` gives
    the site to A6."""
    L, S = q.shape[1], k.shape[1]
    if max(L, S) <= 64 or (causal and S < L):
        return
    out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H, causal)
    lse_ms = cuda_ms(lambda: attention.fused_attention_fwd_lse(
        q, k, v, mask, H, causal), TWIN_ITERS, warmup=1)
    fwd_ms = cuda_ms(lambda: attention.fused_attention(
        q, k, v, mask, H, causal), TWIN_ITERS, warmup=1)
    ms = cuda_ms(lambda: attention.fused_attention_bwd_long(
        q, k, v, mask, out, lse, do, H, causal), 10)
    fma = ""
    if (max(L, S) > attention.A6_WIDE_ROWS
            and attention.backward_route(L, S, 64, torch.float32) == "A6"):
        fma_ms = cuda_ms(lambda: a6_fma(q, k, v, mask, do, H, causal), 10)
        fma = f"; A6's FMA kernel {fma_ms:.4f} ms"
    print(f"  {'fused_attention_bwd_long':24s} {label:34s} on A6's inputs: "
          f"{ms:.4f} ms (its forward with lse {lse_ms:.4f}, without "
          f"{fwd_ms:.4f}){fma}; A6 {a6_ms:.4f} ms: "
          f"{'A6' if a6_ms <= ms else 'the long backward'} faster",
          flush=True)


# A6's tensor-core kernels past one tile in every mode at former "fma" and
# "long" sites, bf16, B 300 (the T5 baselines' batch), rate 0.1: (site, L,
# S, causal, bias, bias_grad); the last three past 128 rows. Phase 3n's
# sites above hold the padding mask alone.
A6_WIDE_MODES = (("prompt vqa enc", 96, 96, False, True, False),
                 ("prompt vqa enc", 96, 96, False, True, True),
                 ("prompt caption cross", 40, 116, False, True, True),
                 ("caption enc", 76, 76, True, False, False),
                 ("prompt nlvr enc", 142, 142, False, True, True),
                 ("prompt tvc cross", 20, 181, False, False, False),
                 ("causal", 200, 200, True, True, True))


def a6_wide_modes(rep: Report) -> None:
    """``A6_WIDE_MODES`` through ``grad_case`` (against autograd of the
    plain forward with the same bias, dropout and triangle, dbias too,
    twice bitwise equal, SDPA's autograd at rate 0 beside it), then the
    kernels' dropout masks bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(26)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    for site, L, S, causal, has_bias, bias_grad in A6_WIDE_MODES:
        grad_case(rep, g, torch.bfloat16, seed, f"wide {site}", 300, L, S,
                  causal, has_bias, bias_grad, timed=False)
    check_a6_wide_masks(seed)


@torch.no_grad()
def check_a6_wide_masks(seed: torch.Tensor, rate: float = 0.1) -> None:
    """A6's bf16 dropout mask bit for bit against ops/hashdrop.py at L =
    S 96, L 40 over S 116 and causal L = S 76 (the wide kernel), L = S
    142, L 20 over S 181 and causal L = S 200 (past 128 rows; B 64): with
    a one-hot cotangent (do[i, d] = [i = off + d]) dv returns the dropped
    probabilities of query rows off .. off + 64, at off 0 and L - 64."""
    from vlpet_tpu_torch.ops.hashdrop import attention_keep_mask

    g = torch.Generator(device="cuda").manual_seed(27)
    B, H, Dh = 64, 12, 64
    inner = H * Dh
    eye = torch.eye(Dh, device="cuda")
    for L, S, causal in ((96, 96, False), (40, 116, False), (76, 76, True),
                         (142, 142, False), (20, 181, False),
                         (200, 200, True)):
        q = (torch.randn((B, L, inner), generator=g, device="cuda")
             * 0.1).bfloat16()
        k = torch.randn((B, S, inner), generator=g, device="cuda").bfloat16()
        mask = torch.zeros((1, 1, 1, S), device="cuda")
        keep = attention_keep_mask(B, L, S, H, seed, rate, device="cuda")
        if causal:
            keep = keep & attention._causal_allowed(L, S, "cuda")
        for off in sorted({0, max(L - Dh, 0)}):
            rows = min(Dh, L - off)
            onehot = torch.zeros((L, Dh), device="cuda")
            onehot[off:off + rows, :rows] = eye[:rows, :rows]
            do = onehot.repeat(1, H).expand(B, L, inner).contiguous()
            _, _, dv = attention.fused_attention_bwd(
                q, k, k, mask, do.bfloat16(), H, causal, rate=rate, seed=seed)
            got = dv.float().view(B, S, H, Dh)[..., :rows].permute(0, 2, 3, 1)
            _expect_zeros(f"{a6_key(L, S)} L{L} S{S} rows {off}+",
                          got, keep[:, :, off:off + rows], "bf16")


# phase 3o: the video scripts' sites. vlpet_tpu_torch/data/video.py pads
# the QA text to 600 tokens and the captions to 77, and the targets to
# --gen_max_length (20); with 64 frames the joint length is S 664 (tvqa,
# how2qa) or 141 (tvc, yc2c), and single_prompt.sh's 40 prompt tokens make
# it 704 or 181. B 50, the scripts' batch; beam 5 on captions, greedy on QA.
# (site, L, S, causal, trained): the decode sites only run forward.
VIDEO_B, VIDEO_T = 50, 20
VIDEO_ATTENTION_SITES = (
    ("tvqa enc", 664, 664, False, True), ("prompt tvqa enc", 704, 704, False,
                                          True),
    ("tvc enc", 141, 141, False, True), ("prompt tvc enc", 181, 181, False,
                                         True),
    ("dec-self", 20, 20, True, True), ("tvqa cross", 20, 664, False, True),
    ("prompt tvqa cross", 20, 704, False, True),
    ("tvc cross", 20, 141, False, True),
    ("prompt tvc cross", 20, 181, False, True),
    ("tvc beam cross", 5, 141, False, False),
    ("prompt tvc beam cross", 5, 181, False, False),
    ("tvqa greedy cross", 1, 664, False, False),
    ("prompt tvqa greedy cross", 1, 704, False, False))
# FFN and LayerNorm rows: the four encoders, the decoder (50 x 20); F1 also
# at the beam (250) and greedy (50) decode rows
VIDEO_TRAIN_ROWS = (33200, 35200, 7050, 9050, 1000)
VIDEO_DECODE_ROWS = (250, 50)


def attention_site(rep: Report, g, dtype, site: str, B: int, L: int, S: int,
                   causal: bool, trained: bool, what: str = "video") -> None:
    """A1 (with its row logsumexp where the backward is the long one) and,
    at a trained site, A6 or the long backward as ``backward_route`` picks,
    against the plain twin and autograd of it (phase 3b's tolerances); the
    route, SDPA's time (and its autograd's) and the bound on every line;
    bf16 twice bitwise equal."""
    randn = randn_fn(g)
    H, Dh = 12, 64
    inner = H * Dh
    e = 2 if dtype == torch.bfloat16 else 4
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    mask = padding_mask(g, B, S)
    lmask = causal_mask(mask, L, S) if causal else mask
    seen = (attention._causal_allowed(L, S, "cuda").float().mean().item()
            if causal else 1.0)
    q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
    k, v, do = (randn(B, n, inner, dtype=dtype) for n in (S, S, L))
    label = f"{tag} {what} {site} B{B} L{L} S{S}" + (" causal" if causal
                                                     else "")
    long = trained and attention.backward_route(L, S, Dh, dtype) == "long"
    if long:
        def fwd():
            return attention.fused_attention_fwd_lse(q, k, v, mask, H, causal)

        def fwd_plain():
            return attention.fused_attention_lse_reference(q, k, v, mask, H,
                                                           causal)
    else:
        def fwd():
            return (attention.fused_attention(q, k, v, mask, H, causal),)

        def fwd_plain():
            return (attention.fused_attention_reference(q, k, v, mask, H,
                                                        causal),)
    rep.check("fused_attention", label + (" +lse" if long else ""), fwd,
              fwd_plain, dtype,
              work=(e * 2 * B * (L + S) * inner + 4 * B * S
                    + (4 * B * H * L if long else 0),
                    4 * B * H * L * S * Dh * seen),
              library_fn=lambda: sdpa(q, k, v, lmask, H))
    if dtype == torch.bfloat16:
        bitwise_repeat("fused_attention", label, fwd)
    if not trained:
        return
    plain_bwd = _grads_of(
        lambda a, b, c: attention.fused_attention_reference(a, b, c, mask, H,
                                                            causal),
        (q, k, v), do)
    lib_bwd = _grads_of(lambda a, b, c: sdpa(a, b, c, lmask, H), (q, k, v),
                        do.view(B, L, H, Dh).transpose(1, 2))
    work = (e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
            10 * B * H * L * S * Dh * seen)
    if long:
        out, lse = fwd()
        key = "fused_attention_bwd_long"
        work = (work[0] + e * B * L * inner + 4 * B * H * L, work[1])

        def kernel():
            return attention.fused_attention_bwd_long(q, k, v, mask, out, lse,
                                                      do, H, causal)
    else:
        key = (a6_key(L, S) if dtype == torch.bfloat16
               else "fused_attention_bwd")

        def kernel():
            return attention.fused_attention_bwd(q, k, v, mask, do, H, causal)
    rep.check(key, label, kernel, plain_bwd, dtype, work=work,
              library_fn=lib_bwd, backward=True,
              iters=5 if dtype == torch.float32 else 20)
    if dtype == torch.bfloat16:
        bitwise_repeat(key, label, kernel)
        if key != "fused_attention_bwd_long":
            routes_beside(q, k, v, mask, do, H, causal, label, rep.last[0])
    del plain_bwd, lib_bwd


def phase_video_script_sites(rep: Report) -> None:
    """3o: every kernel of the video scripts' paths at the shapes they give
    it (``VIDEO_ATTENTION_SITES``, ``VIDEO_TRAIN_ROWS``,
    ``VIDEO_DECODE_ROWS``; B 50), bf16, and fp32 for A1 and the long
    backward at the tvqa encoder and cross sites: each against its plain
    twin (the backward ones against autograd of it) within phase 3b's
    tolerances, bf16 twice bitwise equal, with the route, the library call
    where one computes the function and the bound. F1 / F2 print the
    hidden split ``ops.ffn.f1_splits`` takes and the waves of its grid,
    L1 / L2 the plan of ``ops.fused_ln.ln_plan``; then D1 (beam 5 to
    length 40: 40 slots, pos 39), U1 (the beam cache's K+V write), T1
    (R 250, k 10) and T2 (the greedy R 50, k 1)."""
    g = torch.Generator(device="cuda").manual_seed(18)
    B = VIDEO_B
    for site, L, S, causal, trained in VIDEO_ATTENTION_SITES:
        attention_site(rep, g, torch.bfloat16, site, B, L, S, causal, trained)
    for site, L, S, causal, trained in VIDEO_ATTENTION_SITES[:1] + \
            VIDEO_ATTENTION_SITES[5:6]:
        attention_site(rep, g, torch.float32, site, B, L, S, causal, trained)
    ffn_ln_rows(rep, g, VIDEO_TRAIN_ROWS, VIDEO_DECODE_ROWS, "video")
    decode_kernel_sites(rep, g, B, "video")


def ffn_ln_rows(rep: Report, g, train_rows, decode_rows, what: str) -> None:
    """F1 at ``train_rows`` + ``decode_rows``, F2, L1 and L2 at
    ``train_rows`` (bf16, D 768, F 3072, gelu, rate 0.1): each against its
    plain twin (the backward ones against autograd of it), twice bitwise
    equal, with the bound; F1 prints the hidden split ops.ffn.f1_splits
    takes and its grid's waves, L1 / L2 the plan of ops.fused_ln.ln_plan."""
    randn = randn_fn(g)
    dtype, D, Fh = torch.bfloat16, 768, 3072
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                          scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    groups = -(-(D // 128) // ffn._F1_MAX_DU)
    for N in tuple(train_rows) + tuple(decode_rows):
        x, res, dy = (randn(N, D, dtype=dtype) for _ in range(3))
        splits, per = ffn.f1_splits(N, D, Fh, sms)
        grid = -(-N // ffn._F1_ROWS) * groups * splits
        label = f"bf16 {what} N{N} D{D} F{Fh} gelu S{splits}"
        print(f"  {'fused_ffn':24s} N{N}: f1_splits {splits} x {per} hidden "
              f"chunks, grid {grid} blocks = {-(-grid // sms)} wave(s) of "
              f"{sms} SMs", flush=True)
        it = 5 if N > 20000 else 20

        def f1():
            return (ffn.fused_ffn(x, w1, b1, w2, b2, "gelu"),)
        rep.check("fused_ffn", label, f1,
                  lambda: (ffn.ffn_reference(x, w1, b1, w2, b2, "gelu"),),
                  dtype, iters=it,
                  work=(2 * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                        4 * N * D * Fh))
        bitwise_repeat("fused_ffn", label, f1)
        if N in decode_rows:
            continue

        def f2():
            return ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu")
        rep.check("fused_ffn_bwd", label, f2,
                  _grads_of(lambda a, c, d: ffn.ffn_reference(
                      a, w1, c, w2, d, "gelu"), (x, b1, b2), dy),
                  dtype, iters=it, backward=True,
                  work=(2 * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                        6 * N * D * Fh))
        bitwise_repeat("fused_ffn_bwd", label, f2)
        plan = fused_ln.ln_plan(N, D, dtype, True)
        print(f"  {'fused_dropout_add_ln':24s} N{N}: ln_plan route "
              f"{plan.route}, {plan.blocks} blocks of {plan.warps} warps, "
              f"at most {plan.rows_per_warp} rows a warp", flush=True)
        label = f"bf16 {what} N{N} D{D} rate 0.1"

        def l1():
            return (fused_ln.fused_dropout_add_ln(x, res, gamma, beta, seed,
                                                  0.1),)

        def l2():
            return fused_ln.fused_dropout_add_ln_bwd(x, res, gamma, seed, dy,
                                                     0.1)
        rep.check("fused_dropout_add_ln", label, l1,
                  lambda: (fused_ln.fused_dropout_add_ln_reference(
                      x, res, gamma, beta, seed, 0.1),), dtype, iters=it,
                  work=(2 * 3 * N * D + 4 * (2 * D + 1), 8 * N * D))
        bitwise_repeat("fused_dropout_add_ln", label, l1)
        rep.check("fused_dropout_add_ln_bwd", label, l2,
                  _grads_of(lambda a, b, c, d:
                            fused_ln.fused_dropout_add_ln_reference(
                                a, b, c, d, seed, 0.1),
                            (x, res, gamma, beta), dy),
                  dtype, iters=it, backward=True,
                  work=(2 * 5 * N * D + 4 * (3 * D + 1), 16 * N * D))
        bitwise_repeat("fused_dropout_add_ln_bwd", label, l2)
        del x, res, dy


def decode_kernel_sites(rep: Report, g, B: int, what: str) -> None:
    """The beam-5 and greedy eval's decode kernels at batch ``B`` to length
    40 (bf16): D1 at 40 slots, pos 39, a beam-tree ancestry; U1's K+V
    write; T1 (R = 5 B, k 10) and T2 (R = B, k 1) on fp32 logits over the
    BART vocabulary; against the plain twins, bitwise on a repeat."""
    randn = randn_fn(g)
    dtype, K = torch.bfloat16, 5
    H, Dh, Lc = 12, 64, 40
    inner = H * Dh
    qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
    kc, vc = (randn(Lc, B * K, inner, dtype=dtype) for _ in range(2))
    anc = beam_tree_anc(g, B, K, Lc, Lc - 1)
    rows = F.one_hot(anc, K).amax(dim=1).sum().item()
    label = f"bf16 {what} B{B} K{K} L{Lc} pos{Lc - 1} tree"

    def d1():
        return (decode.beam_decode_attend(qb, kc, vc, anc, Lc - 1),)
    rep.check("beam_decode_attend", label, d1,
              lambda: (decode.beam_decode_attend_reference(qb, kc, vc, anc,
                                                           Lc - 1),), dtype,
              work=(2 * (2 * B * K * inner + 2 * rows * inner)
                    + anc.element_size() * B * K * Lc,
                    4 * B * K * H * Lc * Dh),
              library_fn=beam_sdpa(qb, kc, vc, anc, Lc - 1, dtype))
    bitwise_repeat("beam_decode_attend", label, d1)
    u1_case(rep, g, dtype, B * K, inner, Lc, Lc - 1, f"{what} beam", False)
    for R, kk in ((B * K, 2 * K), (B, 1)):
        x = torch.randn((R, 50265), generator=g, device="cuda")
        check_topk(rep, "randn", x, kk)
        bitwise_repeat("topk_lse", f"fp32 {what} R{R} k{kk}",
                       lambda: topk.topk_lse(x, kk))


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
    ``launches``, the backwards' dbias mode counters and A6's launches past
    128 rows."""
    out = {k: (fn, "launches") for k, fn in wrappers().items()}
    for k in ("fused_attention_bwd", "fused_attention_bwd_long"):
        out[f"{k}.dbias"] = (wrappers()[k], "dbias_launches")
    out["fused_attention_bwd.tc256"] = (attention.fused_attention_bwd,
                                        "tc256_launches")
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
    require_launched(path, got)
    return {**got, **route_counts()}


def require_launched(path: str, got: dict) -> None:
    """Raise if a kernel of ``path`` has no launch in the counts ``got``."""
    missing = [k for k, (_, _, paths) in KERNELS.items()
               if path in paths and got[wrapper_of(k)] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")


def require_tc(path: str, launched: dict) -> None:
    """A bf16 bench run (every Dh 64, each A6 site at L, S <= 256, every
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
                   max_length: int, path: str, label: str,
                   num_beams: int = 5):
    """One warm-up and one timed bf16 beam-5 (or ``num_beams``) generate;
    examples/s and the launches of the timed run (the ``path`` main-path
    run)."""
    V = model.cfg.backbone.vocab_size
    B = batch["input_ids"].shape[0]

    def run():
        return seq2seq_generate(model, **batch, ctx=ctx, num_beams=num_beams,
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
                 task: str, lr: float, path: str,
                 unzero_first: bool = False) -> None:
    """K = 3 fp32 steps through the kernels, then through the plain twins
    from the same weights and generator seed (phase 6's tolerances); with
    ``unzero_first``, from the weights after ``unzero``."""
    K = 3
    model = build_model("float32", cfg_fn)
    if unzero_first:
        unzero(model)
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
                          second_reference: bool = False,
                          lambda_z: float = 0.0,
                          elementwise: bool = False,
                          n_steps: int = 3) -> dict:
    """K = ``n_steps`` fp32 steps, each taken twice from the same
    parameters and optimizer state -- through the plain twins, then
    through the kernels -- with the same dropout seeds; the next step
    starts from the plain result. Each step's loss and gradient norm
    within TRAIN_METRIC_RTOL (phase 6's), each tensor's update within
    PARAM_RTOL of the plain update in the L2 norm (``check_updates``).

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
    fp32 rounding of 0 decides a row of the backward (PERF.md, Findings).
    ``lambda_z`` is the steps' z regularizer weight (train/steps.py).

    ``elementwise`` (phase 6j) holds each step's parameters, kernels vs
    plain, by phase 6's elementwise tolerances (``check_params``: rtol
    PARAM_RTOL, atol PARAM_ATOL_SCALE * max|p|) in place of the L2 update
    ratio, whose 1e-3 no tensor with a zero true gradient can meet: the
    key parallel adapter's up bias adds one vector to every key of a
    sequence, which the softmax cancels, so its gradient is fp32 noise
    (kernels and plain sum in other orders) and Adam turns that noise into
    updates of either sign (PERF.md, Findings)."""
    K = n_steps
    model = build_model("float32", cfg_fn)
    unzero(model)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    opts = [build_optimizer(trainable, lr=lr, total_steps=K + 1)
            for _ in range(3 if second_reference else 2)]
    steps = [make_train_step(model, opt, tasks, lambda_z=lambda_z)
             for opt in opts]
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
        if elementwise:
            worst = max(worst, check_params(trainable, kernel_after, start))
            ratios = {}
        else:
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
    rule = (f"every step's parameters within rtol {PARAM_RTOL}, atol "
            f"{PARAM_ATOL_SCALE} max|p| of the plain step's, largest "
            f"|kernel - plain| / largest update" if elementwise else
            f"every step's update within {PARAM_RTOL} of the plain update "
            f"(L2 per tensor"
            f"{', either plain reference' if second_reference else ''}), "
            f"largest ratio")
    print(f"  {len(trainable)} trainable tensors: {rule} {worst:.2e}"
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
                vs_plain: bool = False, warm: int = 3, timed: int = 10,
                lambda_z: float = 0.0):
    """``warm`` warm-up steps, then ``timed`` timed steps ending in one
    sync; the launches of the timed steps (the ``path`` main-path run),
    every one on the tensor-core routes (``require_tc``). With
    ``vs_plain``, then one step kernels vs plain (``step_vs_plain``);
    ``lambda_z`` is the z regularizer weight (train/steps.py)."""
    model = build_model("bfloat16", cfg_fn)
    trainable = apply_freezing(model, model.cfg.pet)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, seed)
    opt = build_optimizer(trainable, lr=lr, total_steps=warm + timed + 1)
    step = make_train_step(model, opt, tasks, lambda_z=lambda_z)
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


# phase 6f: the three other VL-PET granularity gates on BART-base
GATE_VARIANTS = ("small", "middleX", "middleY")


def gate_cfg(variant: str):
    """``flagship_cfg`` with the PET of scripts/image-text/VL-PET-
    ``variant``.sh (r 96, 4 heads, the variant's gate)."""
    def cfg(dtype: str = "float32"):
        return dataclasses.replace(flagship_cfg(dtype), pet=vlpet_recipe(
            variant, r=96, num_heads=4, gate_dim=96, tasks=FLAGSHIP_TASKS))
    return cfg


def phase_gate_parity() -> None:
    """Per gate: phase 6's fp32 train-step parity (B 8, vqa, dropout 0.1,
    3 steps kernels vs plain), then phase 4 (a)'s beam-5 and greedy token
    parity (6+6 layers at the init scale, B 8, length 40)."""
    ctx = PetContext(task="caption", task_idx=3)
    for v in GATE_VARIANTS:
        train_parity(f"VL-PET-{v} B8 vqa", gate_cfg(v), make_train_batch, 8,
                     21, FLAGSHIP_TASKS, "vqa", 1e-3, "train")
        model = build_model("float32", gate_cfg(v))
        parity_run(f"VL-PET-{v} 6+6 layers, init std 0.02", model,
                   make_batch(8, model.cfg.backbone.vocab_size, seed=7), ctx,
                   40, min_distinct=2)
        del model


# phase 8: the image-text CLI at the VL-PET-small recipe. 1000 synthetic
# examples a task (36 boxes of 2048-d fp32, 0.3 MB an image: about 1.5 GB a
# split with NLVR's two images) give 11 optimizer steps an epoch at batch
# 500 (vqa 2, gqa 1, nlvr 6, caption 2), so an epoch takes 11 steps,
# followed by the eval of all four tasks; the resumed run takes one epoch
# more. (10 epochs until the smoke grew past 1000 s of its 1200, 2 until
# phase 10 came: the later epochs repeat the first's shapes.)
CLI_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "image-text", "VL-PET-small.sh")
CLI_EXAMPLES, CLI_EPOCHS, CLI_MIN_STEPS = 1000, 1, 10
CLI_TIMEOUT_S = 600


def script_flags(path: str, positional) -> list:
    """The flags a scripts/*.sh passes to its CLI: its variables and the
    positional arguments ``positional`` ($1, $2, ..) filled in."""
    text = open(path).read()
    env = {str(i + 1): v for i, v in enumerate(positional)}
    env.update(re.findall(r"^(\w+)=(\S+)$", text, flags=re.M))
    cmd = text[text.index("python -m"):].replace("\\\n", " ").split("\n")[0]
    for _ in range(2):
        cmd = re.sub(r"\$\{(\w+)\}|\$(\d|[A-Za-z_]\w*)",
                     lambda m: env.get(m.group(1) or m.group(2), ""), cmd)
    return shlex.split(cmd)[3:]


CLI_MODULE = "vlpet_tpu_torch.cli.multitask"


def cli_child(module: str, argv) -> None:
    """``python -m <module> <argv>`` in this process (``chip_smoke.py
    --cli-child <module> <argv>``), then one tagged line with the kernels'
    launches over the run and its wall time."""
    import runpy

    reset_counts()
    sys.argv = [module] + list(argv)
    t0 = time.perf_counter()
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    got = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    print("CLI_RESULT " + json.dumps({
        "launches": {**got, **route_counts()},
        "wall_s": time.perf_counter() - t0}), flush=True)


def run_cli(argv, label: str, module: str = CLI_MODULE):
    """``python -m <module> <argv>`` in a child process; returns (its
    stdout, its CLI_RESULT). The blocks this process's allocator caches
    go back to the card first: the child allocates its own."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the WhitespaceTokenizer fallback ids words by Python's str hash: one
    # hash seed gives both processes (and every smoke run) the same ids,
    # and the CLI refuses --resume without one (require_stable_word_ids)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--cli-child", module] + list(argv),
                          capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env={**os.environ, "PYTHONHASHSEED": "0"})
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    tag = [ln for ln in proc.stdout.splitlines()
           if ln.startswith("CLI_RESULT ")]
    res = json.loads(tag[-1][len("CLI_RESULT "):])
    res["process_s"] = time.perf_counter() - t0
    return proc.stdout, res


def _digest(out: str, pattern: str) -> tuple:
    m = re.search(pattern, out)
    if m is None:
        raise AssertionError(f"no {pattern!r} in the CLI's output")
    return m.groups()


def phase_cli_rehearsal(card: str) -> dict:
    """``python -m vlpet_tpu_torch.cli.multitask`` with the flags of
    scripts/image-text/VL-PET-small.sh (r 96, 4 heads, VPA 96, lr 1e-3;
    synthetic features made at the pooled 36 boxes, so ``--downsample`` is
    left out) plus ``--bf16``: batch 500 (valid 500), the four tasks,
    beam 5, CLI_EPOCHS epochs of CLI_EXAMPLES examples a task, each epoch
    evaluated; then a second process with ``--resume`` restores the saved
    state (its digest equal, bit for bit, to what the first saved) and
    trains one epoch more. Every kernel of the path must launch in the
    first run (the cli_multitask main-path run); prints the wall clock of
    each part beside the card."""
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "run")
        flags = script_flags(CLI_SCRIPT, ["0", "96", "4", "96", "96", "1e-3",
                                          "9595"])
        flags = [f for f in flags if f != "--downsample"] + [
            "--bf16", "--synthetic_examples", str(CLI_EXAMPLES), "--output",
            out_dir, "--device", "cuda"]
        out1, res1 = run_cli(flags + ["--epochs", str(CLI_EPOCHS)], "train")
        launched = res1["launches"]
        require_launched(CLI, launched)
        if launched.get("fused_attention_bwd[fma]"):
            raise AssertionError(f"{CLI}: A6 launched on fma "
                                 f"{launched['fused_attention_bwd[fma]']} "
                                 f"times; every bf16 site is L, S <= 128")
        saved_step, saved = _digest(out1, r"saved at step (\d+); state "
                                          r"digest ([0-9a-f]+)")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        out2, res2 = run_cli(flags + ["--epochs", str(CLI_EPOCHS + 1),
                                      "--resume"], "resume")
        step2, restore_s, restored = _digest(
            out2, r"resumed from step (\d+) in ([0-9.]+) s; state digest "
                  r"([0-9a-f]+)")
        end_step, _ = _digest(out2, r"saved at step (\d+); state digest "
                                    r"([0-9a-f]+)")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            recs2 = [json.loads(ln) for ln in f][len(recs):]
    if step2 != saved_step or restored != saved:
        raise AssertionError(f"resume: step {step2} digest {restored}, saved "
                             f"step {saved_step} digest {saved}")
    epochs = [r for r in recs if "train_seconds" in r]
    steps = int(sum(r["train_steps"] for r in epochs))
    if len(epochs) != CLI_EPOCHS or steps < CLI_MIN_STEPS:
        raise AssertionError(f"{len(epochs)} epochs, {steps} steps")
    for r in epochs + [r for r in recs2 if "train_seconds" in r]:
        if not math.isfinite(r["train_loss"]):
            raise AssertionError(f"non-finite train loss in {r}")
        for t in FLAGSHIP_TASKS:
            if f"{t}/eval_seconds" not in r:
                raise AssertionError(f"no {t} eval in epoch {r['epoch']}")
    more = int(end_step) - int(saved_step)
    if more <= 0:
        raise AssertionError(f"the resumed run took no step ({end_step})")
    data_s = [r["data_build_seconds"] for r in recs + recs2
              if "data_build_seconds" in r]
    train_s = sum(r["train_seconds"] for r in epochs)
    ex = sum(r["train_examples"] for r in epochs)
    # the epochs after the first: the resumed run's when there is one
    later = epochs[1:] or [r for r in recs2 if "train_seconds" in r]
    later_ms = (sum(r["train_seconds"] for r in later)
                / sum(r["train_steps"] for r in later) * 1e3)
    last = epochs[-1]
    evals = {t: [r[f"{t}/eval_seconds"] for r in epochs]
             for t in FLAGSHIP_TASKS}
    print(f"  on {card}: VL-PET-small CLI, bf16, B 500, {CLI_EXAMPLES} "
          f"examples a task, {CLI_EPOCHS} epochs", flush=True)
    print(f"  data build {data_s[0]:.2f} s (train + val, both runs: "
          f"{', '.join(f'{x:.2f}' for x in data_s)} s)", flush=True)
    print(f"  train: {steps} steps in {train_s:.2f} s host-clocked: "
          f"{train_s / steps * 1e3:.2f} ms/step, {ex / train_s:.2f} "
          f"examples/s over all epochs; {later_ms:.2f} ms/step after the "
          f"first epoch (the resumed run's when it is the only one); last "
          f"epoch loss {last['train_loss']:.4f}",
          flush=True)
    for t, xs in evals.items():
        scores = {k.split("/", 1)[1]: round(v, 4) for k, v in last.items()
                  if k.startswith(t + "/") and not k.endswith("eval_seconds")}
        print(f"  eval {t}: {xs[0]:.2f} s the first epoch, median "
              f"{statistics.median(xs):.2f} s; last scores {scores}",
              flush=True)
    print(f"  processes: train {res1['process_s']:.2f} s ({res1['wall_s']:.2f} "
          f"s in the CLI), resume {res2['process_s']:.2f} s "
          f"({res2['wall_s']:.2f} s in the CLI; restore {float(restore_s):.3f}"
          f" s, {more} more steps); state at step {saved_step} restored bit "
          f"for bit (digest {saved[:16]})", flush=True)
    print(f"  launches of the train run "
          f"{ {k: n for k, n in launched.items() if n} }", flush=True)
    return launched


# phases 6g, 7f and 8b: the PET baselines on BART-base with each script's
# flags (the positional values the scripts leave to their caller: lr 1e-3,
# hypercomplex_division 4, lora_dim 4, projected_task_embedding_dim 64) and
# single_lradapter, which no script sets: single_adapter.sh's flags with
# the low-rank adapter (rank 1) in place of the bottleneck one.
PET_POSITIONAL = {"single_compacter": ["4"], "single_lora": ["4"],
                  "hyperformer": ["64"]}
# the recipes whose decode path differs from the plain model's (phase 6g's
# token parity)
PET_DECODE = ("single_adapter", "single_compacter", "single_lradapter",
              "single_lora", "single_prompt", "hyperformer")
PET_EVAL_SCRIPTS = ("single_lora", "single_prompt", "hyperformer")


def pet_flags(name: str) -> list:
    if name == "single_lradapter":
        flags = pet_flags("single_adapter")
        i = flags.index("--use_adapter")
        return (flags[:i] + ["--use_lradapter", "--low_rank_rank", "1"]
                + flags[i + 1:])
    return script_flags(os.path.join(os.path.dirname(CLI_SCRIPT),
                                     f"{name}.sh"),
                        ["1e-3"] + PET_POSITIONAL.get(name, []) + ["9595"])


def pet_cfg(name: str):
    """``flagship_cfg`` with the PET config the port's CLI builds from
    ``pet_flags(name)``."""
    from vlpet_tpu_torch.cli.param import build_model_config, parse_args

    pet = build_model_config(parse_args(pet_flags(name)), FLAGSHIP_TASKS).pet

    def cfg(dtype: str = "float32"):
        return dataclasses.replace(flagship_cfg(dtype), pet=pet)
    return cfg


def pet_path(name: str) -> str:
    """The main-path name whose kernels a recipe's train step launches."""
    return "pet_single_adapter" if name == "single_lradapter" else f"pet_{name}"


def phase_pet_parity() -> None:
    """6g: per recipe, phase 6's fp32 train-step parity (B 8, vqa, dropout
    0.1 and LoRA's 0.1, 3 steps kernels vs plain, phase 6's tolerances)
    from the weights after ``unzero``, as phase 6c starts: LoRA's B, the
    biases that LoRA, BitFit and full fine-tuning train and the
    hypernets' biases start at zero, where Adam's steps are +-lr whatever
    a gradient's size (from the init: a k_proj bias, whose true gradient
    is zero, 6.7e-10 apart against an atol of ~1e-14; a lora_B 2.7e-8
    apart against ~1e-8); then, for the recipes whose decode path
    differs from the plain model's, phase 4 (a)'s beam-5 and greedy tokens
    at B 8 to length 40 from the init, kernels vs plain, identical."""
    ctx = PetContext(task="caption", task_idx=3)
    for name in PET_SCRIPTS + ("single_lradapter",):
        t0 = time.perf_counter()
        train_parity(f"{name} B8 vqa", pet_cfg(name), make_train_batch, 8, 21,
                     FLAGSHIP_TASKS, "vqa", 1e-3, pet_path(name),
                     unzero_first=True)
        if name in PET_DECODE:
            model = build_model("float32", pet_cfg(name))
            parity_run(f"{name} 6+6 layers, init std 0.02", model,
                       make_batch(8, model.cfg.backbone.vocab_size, seed=7),
                       ctx, 40, min_distinct=2)
            del model
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_pet_bench(card: str) -> dict:
    """7f: each script's bf16 train step (B 500, vqa: S 56, 96 with the
    prompt) as phase 7 (ms/step, examples/s, peak GiB, launches), every
    A6 launch on "tc" (the prompt's L = S = 96 on the wide kernel, its step
    held to the plain step: ``step_vs_plain``). Then the beam-5 eval (B
    500 to length 40, caption) of the LoRA, prompt and hyperformer
    scripts, as phase 5."""
    launched = {}
    for name in PET_SCRIPTS:
        path = f"pet_{name}"
        launched[path] = train_bench(card, pet_cfg(name), make_train_batch,
                                     500, 31, FLAGSHIP_TASKS, "vqa", 1e-3,
                                     path, f"{name} vqa",
                                     vs_plain=name == "single_prompt")
    for name in PET_EVAL_SCRIPTS:
        model = build_model("bfloat16", pet_cfg(name))
        path = f"pet_{name}_eval"
        launched[path] = generate_bench(
            card, model, make_batch(500, model.cfg.backbone.vocab_size,
                                    seed=11),
            PetContext(task="caption", task_idx=3), 40, path,
            f"{name} beam5 len40")
        del model
    return launched


PROMPT_EPOCHS = 1  # 2 until phase 10 came: the second repeats the first


def phase_cli_prompt(card: str) -> dict:
    """8b: ``python -m vlpet_tpu_torch.cli.multitask`` with the flags of
    scripts/image-text/single_prompt.sh (``--downsample`` left out, as in
    phase 8) plus --bf16: batch 500, the four tasks, CLI_EXAMPLES
    synthetic examples a task, PROMPT_EPOCHS epochs, each evaluated. Every
    kernel of the path must launch, A6 on "tc" only, past 128 rows at
    nlvr's encoder (L = S = 142) and cross-attention over S 142 among them;
    prints the data build, the host-clocked ms/step and each task's eval
    seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "run")
        flags = [f for f in pet_flags("single_prompt") if f != "--downsample"]
        flags += ["--bf16", "--synthetic_examples", str(CLI_EXAMPLES),
                  "--output", out_dir, "--device", "cuda", "--epochs",
                  str(PROMPT_EPOCHS)]
        _, res = run_cli(flags, "single_prompt")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
    launched = res["launches"]
    require_launched(CLI_PROMPT, launched)
    if launched.get("fused_attention_bwd[fma]"):
        raise AssertionError(f"single_prompt CLI: A6 launched on fma "
                             f"{launched['fused_attention_bwd[fma]']} times")
    epochs = [r for r in recs if "train_seconds" in r]
    if len(epochs) != PROMPT_EPOCHS:
        raise AssertionError(f"{len(epochs)} epochs")
    for r in epochs:
        if not math.isfinite(r["train_loss"]):
            raise AssertionError(f"non-finite train loss in {r}")
        for t in FLAGSHIP_TASKS:
            if f"{t}/eval_seconds" not in r:
                raise AssertionError(f"no {t} eval in epoch {r['epoch']}")
    data_s = [r["data_build_seconds"] for r in recs
              if "data_build_seconds" in r]
    steps = int(sum(r["train_steps"] for r in epochs))
    train_s = sum(r["train_seconds"] for r in epochs)
    ex = sum(r["train_examples"] for r in epochs)
    print(f"  on {card}: single_prompt CLI, bf16, B 500, {CLI_EXAMPLES} "
          f"examples a task, {PROMPT_EPOCHS} epochs; data build "
          f"{data_s[0]:.2f} s", flush=True)
    for r in epochs:
        print(f"  epoch {r['epoch']}: {r['train_steps']} steps in "
              f"{r['train_seconds']:.2f} s host-clocked "
              f"({r['train_seconds'] / r['train_steps'] * 1e3:.2f} ms/step), "
              f"loss {r['train_loss']:.4f}; eval "
              + ", ".join(f"{t} {r[f'{t}/eval_seconds']:.2f} s"
                          for t in FLAGSHIP_TASKS), flush=True)
    print(f"  train: {steps} steps, {train_s / steps * 1e3:.2f} ms/step, "
          f"{ex / train_s:.2f} examples/s over all epochs; process "
          f"{res['process_s']:.2f} s ({res['wall_s']:.2f} s in the CLI); "
          f"launches {({k: n for k, n in launched.items() if n})}",
          flush=True)
    return launched


# phases 3o, 6h, 7g and 8c: the ten scripts of scripts/video-text/, each
# calling ``python -m vlpet_tpu_torch.cli.multitask_video``. The positional
# values they leave to their caller: the VL-PET scripts r 96, 4 heads, gate
# 96, VPA 96 and phase 7b's lr 7e-4; the baselines lr 1e-3,
# hypercomplex_division 4 and lora_dim 4, as phase 6g; seed 9595.
VIDEO_SCRIPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts", "video-text")


def video_flags(name: str) -> list:
    """The flags scripts/video-text/<name>.sh passes to its CLI."""
    if name in VIDEO_GATES:
        positional = ["0", "96", "4", "96", "96", "7e-4", "9595"]
    else:
        positional = ["1e-3"] + PET_POSITIONAL.get(name, []) + ["9595"]
    return script_flags(os.path.join(VIDEO_SCRIPT_DIR, f"{name}.sh"),
                        positional)


def video_script_cfg(name: str):
    """dtype -> the config ``cli.multitask_video`` builds from
    ``video_flags(name)`` (feat_dim 512, the script's four tasks, the BART
    vocabulary)."""
    from vlpet_tpu_torch.cli.param import build_model_config, parse_args

    args = parse_args(video_flags(name))
    args.feat_dim = 512
    base = build_model_config(args, tuple(args.tasks.split(",")), 50265)

    def cfg(dtype: str = "float32"):
        return dataclasses.replace(base, dtype=dtype)
    return cfg


def video_inputs(text: int):
    """batch_fn (B, vocab, seed) -> the video scripts' model inputs:
    ``text`` text tokens (600 QA, 77 caption; every other example padded
    after two thirds of them) and 64 frames of 512-d CLIP-ViT features with
    zero boxes, as data/video.py collates them."""
    def fn(B: int, vocab: int, seed: int, pad: int = 1):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ids = torch.randint(3, vocab, (B, text), generator=g, device="cuda")
        mask = torch.ones((B, text), dtype=torch.long, device="cuda")
        mask[1::2, 2 * text // 3:] = 0
        ids = torch.where(mask.bool(), ids, pad)
        return dict(input_ids=ids, attention_mask=mask,
                    vis_feats=torch.randn((B, 64, 512), generator=g,
                                          device="cuda"),
                    boxes=torch.zeros((B, 64, 4), device="cuda"))
    return fn


def video_train_inputs(text: int):
    """``video_inputs(text)`` plus VIDEO_T (20, --gen_max_length) target
    tokens, every third example's padded with -100 after 14."""
    def fn(B: int, vocab: int, seed: int):
        batch = video_inputs(text)(B, vocab, seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        targets = torch.randint(3, vocab, (B, VIDEO_T), generator=g,
                                device="cuda")
        targets[::3, 14:] = -100
        batch["target_ids"] = targets
        return batch
    return fn


QA_TEXT, CAP_TEXT = 600, 77  # data/video.py's max_text_length


def phase_video_script_parity() -> None:
    """6h: the video VL-PET-large recipe (``video_script_cfg``, the config
    cli.multitask_video builds from VL-PET-large.sh) at full width, fp32,
    B 2, dropout 0.1, lr 7e-4: phase 6's train-step parity, 3 steps kernels
    vs plain, of tvqa at S 664 and of tvc at S 141, 20 targets each; then
    single_prompt.sh's recipe (lr 1e-3), 3 tvqa steps at S 704. Each from
    the weights after ``unzero`` (phase 6g's start): from the recipe's
    zero-init up projections Adam steps +-lr on noise, and at S 664 a
    multihead adapter's up bias parted by 2.3e-8 against an atol of ~2e-8
    from the init. Then beam-5 and greedy tokens on tvc (B 4, length 40)
    and greedy tokens on tvqa (B 4, length 20) from the init, kernels vs
    plain, identical."""
    large = video_script_cfg("VL-PET-large")
    t0 = time.perf_counter()
    for task, text, seed in (("tvqa", QA_TEXT, 41), ("tvc", CAP_TEXT, 43)):
        train_parity(f"video VL-PET-large B2 S{text + 64} {task} T20", large,
                     video_train_inputs(text), 2, seed, VIDEO_TASKS, task,
                     7e-4, "video_train", unzero_first=True)
    train_parity("video single_prompt B2 S704 tvqa T20",
                 video_script_cfg("single_prompt"),
                 video_train_inputs(QA_TEXT), 2, 45, VIDEO_TASKS, "tvqa",
                 1e-3, "video_train", unzero_first=True)
    print(f"  train parity: {time.perf_counter() - t0:.1f} s", flush=True)
    model = build_model("float32", large)
    V = model.cfg.backbone.vocab_size
    ctx = PetContext(task="tvc", task_idx=VIDEO_TASKS.index("tvc"))
    parity_run("video VL-PET-large tvc B4 S141 len40, init std 0.02", model,
               video_inputs(CAP_TEXT)(4, V, 47), ctx, 40, min_distinct=2)
    ctx = PetContext(task="tvqa", task_idx=VIDEO_TASKS.index("tvqa"))
    batch = video_inputs(QA_TEXT)(4, V, 49)
    # the init-scale model ends most rows at once; 1+1 layers at std 0.2
    # (phase 4 (b)) decode to the full length
    for what, m in (("6+6 layers, init std 0.02", model),
                    ("1+1 layers, std 0.2", spread_model(large))):
        t2 = topk.topk_lse.launches
        got = seq2seq_generate(m, **batch, ctx=ctx, num_beams=1,
                               max_length=20)
        t2 = topk.topk_lse.launches - t2
        with plain_twins():
            want = seq2seq_generate(m, **batch, ctx=ctx, num_beams=1,
                                    max_length=20)
        if not torch.equal(got, want):
            raise AssertionError(f"video tvqa S664 {what}: fp32 greedy tokens "
                                 f"differ between kernels and plain")
        print(f"  video VL-PET-large tvqa B4 S664 len20 {what}: greedy tokens "
              f"identical (kernel vs plain), T2 launches {t2}, distinct ids "
              f"per row {[len(set(r)) for r in got[:, 1:].tolist()]}",
              flush=True)
    del model


def phase_video_script_bench(card: str) -> dict:
    """7g: each video script's bf16 train step at B 50 on tvqa (S 664; 704
    with the prompt), 20 targets, as phase 7 (ms/step, examples/s, peak
    GiB, launches; the video_<script> main-path runs); VL-PET-large's on tvc
    (S 141: A6 past 128 rows at its encoder and cross-attention, every
    launch on "tc"); then VL-PET-large's
    greedy tvqa eval to length 20 (weights at std 0.2) and beam-5 tvc eval
    to length 40 at B 50 (examples/s; VS_QA_EVAL, VS_CAP_EVAL)."""
    launched = {}
    for name in VIDEO_SCRIPTS:
        S = QA_TEXT + 64 + (40 if name == "single_prompt" else 0)
        launched[f"video_{name}"] = train_bench(
            card, video_script_cfg(name), video_train_inputs(QA_TEXT),
            VIDEO_B, 51, VIDEO_TASKS, "tvqa",
            7e-4 if name in VIDEO_GATES else 1e-3,
            f"video_{name}", f"video {name} tvqa S{S}")
    path = "video_VL-PET-large_tvc"
    launched[path] = train_bench(
        card, video_script_cfg("VL-PET-large"), video_train_inputs(CAP_TEXT),
        VIDEO_B, 53, VIDEO_TASKS, "tvc", 7e-4, path,
        "video VL-PET-large tvc S141")
    # greedy at the init scale ends every row at the first step; at
    # phase 4 (b)'s std 0.2 it decodes to the full length (T2's launches
    # count the steps). Beam 5 runs its 39 steps at the init scale.
    for path, task, text, beams, length, spread in (
            (VS_QA_EVAL, "tvqa", QA_TEXT, 1, 20, True),
            (VS_CAP_EVAL, "tvc", CAP_TEXT, 5, 40, False)):
        model = build_model("bfloat16", video_script_cfg("VL-PET-large"))
        if spread:
            spread_weights(model, 1234)
        ctx = PetContext(task=task, task_idx=VIDEO_TASKS.index(task))
        launched[path] = generate_bench(
            card, model,
            video_inputs(text)(VIDEO_B, model.cfg.backbone.vocab_size, 55),
            ctx, length, path,
            f"video VL-PET-large {task} S{text + 64} beam{beams} "
            f"len{length}" + (" std 0.2" if spread else ""),
            num_beams=beams)
        del model
    return launched


VIDEO_CLI_MODULE = "vlpet_tpu_torch.cli.multitask_video"
VIDEO_CLI_EXAMPLES, VIDEO_CLI_EPOCHS = 250, 2


def _epochs_of(out_dir: str, tasks) -> tuple:
    """(every record, the epoch records) of a run's metrics.jsonl, each
    epoch's train loss finite and each task evaluated."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    epochs = [r for r in recs if "train_seconds" in r]
    for r in epochs:
        if not math.isfinite(r["train_loss"]):
            raise AssertionError(f"non-finite train loss in {r}")
        for t in tasks:
            if f"{t}/eval_seconds" not in r:
                raise AssertionError(f"no {t} eval in epoch {r['epoch']}")
    return recs, epochs


def phase_cli_video(card: str) -> dict:
    """8c: ``python -m vlpet_tpu_torch.cli.multitask_video`` with the flags
    of scripts/video-text/VL-PET-large.sh (r 96, 4 heads, gate 96, VPA 96,
    lr 7e-4, seed 9595) plus --bf16: B 50 (valid 50), the four tasks,
    VIDEO_CLI_EXAMPLES synthetic examples a task, VIDEO_CLI_EPOCHS epochs,
    each evaluated (QA greedy to length 20, captions beam 5 to length 40);
    then a second process with ``--resume`` restores the saved state (its
    digest equal, bit for bit) and, nothing being left to train, saves it
    again unchanged. Then ``python -m vlpet_tpu_torch.cli.single_task tvqa``
    with single_prompt.sh's flags for one epoch, whose encoder (S 704) and
    cross-attention take the long backward. Every kernel of each path must
    launch (cli_video, cli_video_single_prompt); prints the data build
    seconds, ms/step, each task's eval seconds and the launches."""
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "run")
        flags = video_flags("VL-PET-large") + [
            "--bf16", "--synthetic_examples", str(VIDEO_CLI_EXAMPLES),
            "--output", out_dir, "--device", "cuda", "--epochs",
            str(VIDEO_CLI_EPOCHS)]
        out1, res1 = run_cli(flags, "video train", VIDEO_CLI_MODULE)
        launched[CLI_VIDEO] = res1["launches"]
        require_launched(CLI_VIDEO, res1["launches"])
        saved_step, saved = _digest(out1, r"saved at step (\d+); state "
                                          r"digest ([0-9a-f]+)")
        recs, epochs = _epochs_of(out_dir, VIDEO_TASKS)
        out2, res2 = run_cli(flags + ["--resume"], "video resume",
                             VIDEO_CLI_MODULE)
        step2, restore_s, restored = _digest(
            out2, r"resumed from step (\d+) in ([0-9.]+) s; state digest "
                  r"([0-9a-f]+)")
        end_step, end = _digest(out2, r"saved at step (\d+); state digest "
                                      r"([0-9a-f]+)")
        prompt_dir = os.path.join(tmp, "prompt")
        pflags = ["tvqa"] + video_flags("single_prompt") + [
            "--bf16", "--synthetic_examples", str(VIDEO_CLI_EXAMPLES),
            "--output", prompt_dir, "--device", "cuda", "--epochs", "1"]
        _, res3 = run_cli(pflags, "single_task tvqa single_prompt",
                          "vlpet_tpu_torch.cli.single_task")
        launched[CLI_VIDEO_PROMPT] = res3["launches"]
        require_launched(CLI_VIDEO_PROMPT, res3["launches"])
        precs, pepochs = _epochs_of(prompt_dir, ("tvqa",))
    if (step2, restored, end_step, end) != (saved_step, saved, saved_step,
                                            saved):
        raise AssertionError(f"resume: step {step2} digest {restored}, saved "
                             f"again at {end_step} {end}; saved step "
                             f"{saved_step} digest {saved}")
    if len(epochs) != VIDEO_CLI_EPOCHS or len(pepochs) != 1:
        raise AssertionError(f"{len(epochs)} and {len(pepochs)} epochs")
    data_s = [r["data_build_seconds"] for r in recs
              if "data_build_seconds" in r]
    pdata_s = [r["data_build_seconds"] for r in precs
               if "data_build_seconds" in r]
    print(f"  on {card}: VL-PET-large video CLI, bf16, B {VIDEO_B}, "
          f"{VIDEO_CLI_EXAMPLES} examples a task, {VIDEO_CLI_EPOCHS} epochs; "
          f"data build {data_s[0]:.2f} s", flush=True)
    for r in epochs:
        print(f"  epoch {int(r['epoch'])}: {int(r['train_steps'])} steps in "
              f"{r['train_seconds']:.2f} s host-clocked "
              f"({r['train_seconds'] / r['train_steps'] * 1e3:.2f} ms/step, "
              f"{r['train_examples'] / r['train_seconds']:.2f} examples/s), "
              f"loss {r['train_loss']:.4f}; eval "
              + ", ".join(f"{t} {r[f'{t}/eval_seconds']:.2f} s"
                          for t in VIDEO_TASKS), flush=True)
    scores = {k: round(v, 4) for k, v in epochs[-1].items()
              if "/" in k and not k.endswith("eval_seconds")}
    print(f"  last scores {scores}; processes: train {res1['process_s']:.2f} "
          f"s ({res1['wall_s']:.2f} s in the CLI), resume "
          f"{res2['process_s']:.2f} s (restore {float(restore_s):.3f} s); "
          f"state at step {saved_step} restored bit for bit (digest "
          f"{saved[:16]}); launches "
          f"{ {k: n for k, n in res1['launches'].items() if n} }",
          flush=True)
    r = pepochs[0]
    print(f"  single_task tvqa, single_prompt.sh flags, 1 epoch: data build "
          f"{pdata_s[0]:.2f} s, {int(r['train_steps'])} steps "
          f"({r['train_seconds'] / r['train_steps'] * 1e3:.2f} ms/step), "
          f"loss {r['train_loss']:.4f}, eval {r['tvqa/eval_seconds']:.2f} s; "
          f"process {res3['process_s']:.2f} s; launches "
          f"{ {k: n for k, n in res3['launches'].items() if n} }", flush=True)
    return launched


# phases 3p, 6i, 7h and 8d: the raw-image path (vision/vis_encoder.py
# RawInputVLModel: the CLIP trunk inside the train step and the
# generation), the feature extractor (vision/extract.py) and the checkpoint
# importers (vision/clip_import.py, models/hf_import.py). The raw
# configuration of the scripts: RN101 at 224 px, a 7 x 7 grid of 2048-d
# features (49 tokens: 20 text tokens give the joint S 69, NLVR's two
# images S 118, a 14 x 14 grid at 448 px S 216), BART-base + VL-PET-large
# with --use_vis_adapter (middle-bottleneck, reduction 2: the JAX
# Trainer's). The trunk runs as plain PyTorch (convolutions, BatchNorm on
# its running statistics); the VL model's kernels serve the raw path at
# these joint lengths.
RAW_BACKBONE, RAW_IMAGE, RAW_GRID, RAW_TEXT = "RN101", 224, 49, 20
RAW_B, RAW_T5_B, RAW_TRUNK_B = 500, 300, 256
RAW_ADAPTER = "middle-bottleneck"
# phase 3p: (site, B, L, S, causal, trained)
RAW_ATTENTION_SITES = (
    ("vqa enc", 500, 69, 69, False, True),
    ("vqa cross", 500, 10, 69, False, True),
    ("caption cross", 500, 40, 69, False, True),
    ("caption beam cross", 500, 5, 69, False, False),
    ("nlvr enc", 500, 118, 118, False, True),
    ("nlvr cross", 500, 10, 118, False, True),
    ("cross L40 S118", 500, 40, 118, False, True),
    ("448 enc", 500, 216, 216, False, True))
RAW_TRAIN_ROWS = (500 * 69, 500 * 118, 500 * 216)


def raw_cfg(dtype: str, adapter: bool = True, unfreeze: bool = False,
            t5: bool = False):
    """BART-base (or T5-base) + VL-PET-large at full width with the raw
    path's visual flags: --use_vis_adapter, --unfreeze_vis_encoder; 2048-d
    grid features, no downsampling (the 49 grid tokens reach the
    encoder)."""
    base = (t5_cfg if t5 else flagship_cfg)(dtype)
    pet = dataclasses.replace(base.pet, use_vis_adapter=adapter,
                              unfreeze_vis_encoder=unfreeze)
    return dataclasses.replace(base, pet=pet)


def raw_model(dtype: str, adapter: bool = True, unfreeze: bool = False,
              t5: bool = False, image: int = RAW_IMAGE,
              seed: int = 1234) -> RawInputVLModel:
    """RawInputVLModel (RN101 trunk) with its seeded init on the card."""
    cfg = raw_cfg(dtype, adapter, unfreeze, t5)
    model = RawInputVLModel(cfg, vis_backbone=RAW_BACKBONE, image_size=image,
                            vis_adapter_type=RAW_ADAPTER if adapter else None,
                            device="cuda")
    return model.init_weights(torch.Generator(device="cuda").manual_seed(seed))


def make_raw_batch(B: int, vocab: int, seed: int, n_images: int = 1,
                   image: int = RAW_IMAGE, pad: int = 1):
    """20 text tokens (every other example padded after 14) and seeded
    images, N(0, 1) as CLIP-normalized pixels, NCHW: (B, 3, H, W), or (B,
    2, 3, H, W) for the NLVR pair; the images ride in the vis_feats slot
    of the generation protocol."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, vocab, (B, RAW_TEXT), generator=g, device="cuda")
    mask = torch.ones((B, RAW_TEXT), dtype=torch.long, device="cuda")
    mask[1::2, 14:] = 0
    ids = torch.where(mask.bool(), ids, pad)
    lead = (B,) if n_images == 1 else (B, n_images)
    return dict(input_ids=ids, attention_mask=mask,
                vis_feats=torch.randn(lead + (3, image, image), generator=g,
                                      device="cuda"))


def make_raw_train_batch(B: int, vocab: int, seed: int, n_images: int = 1):
    """The raw batch plus 10 targets and VQA answer scores."""
    return add_targets(make_raw_batch(B, vocab, seed, n_images), B, vocab,
                       seed, True)


def phase_raw_sites(rep: Report) -> None:
    """3p: the raw path's kernel sites, bf16, and fp32 for A1 and A6 at S
    69 (RAW_ATTENTION_SITES: B 500, vqa S 69, NLVR S 118 and 448 px S
    216 on A6's tensor-core kernels, the cross sites L 10 and the
    caption's L 40 over S 69 and 118, the beam
    cross-attention L 5 over S 69); F1, F2, L1 and L2 at the encoder rows
    (RAW_TRAIN_ROWS, N 34500 / 59000 / 108000); D1, U1, T1 and T2 at the
    raw caption eval (B 500, beam 5 to length 40). Each against its plain
    twin (the backward ones against autograd of it) within phase 3b's
    tolerances, bf16 twice bitwise equal, with the route, the library call
    (SDPA and its autograd for attention) and the bound."""
    g = torch.Generator(device="cuda").manual_seed(19)
    for site, B, L, S, causal, trained in RAW_ATTENTION_SITES:
        attention_site(rep, g, torch.bfloat16, site, B, L, S, causal, trained,
                       what="raw")
    for site, B, L, S, causal, trained in RAW_ATTENTION_SITES[:1]:
        attention_site(rep, g, torch.float32, site, B, L, S, causal, trained,
                       what="raw")
    ffn_ln_rows(rep, g, RAW_TRAIN_ROWS, (), "raw")
    decode_kernel_sites(rep, g, RAW_B, "raw")


# --- the importers' seeded state dicts, names and shapes written out here
# from the published architectures (not from the importers' tables) ------


def clip_visual_keys(backbone: str, grid: int = 7):
    """(key, shape) of an OpenAI CLIP visual state dict at 224 px (grid 7):
    RN101 (stem 32 / 32 / 64, stages (3, 4, 23, 3) of width 64, attention
    pool 2048 -> 512) or ViT-B/32 (width 768, 12 blocks, 768 -> 512
    proj); with two keys of the text tower, which the importer passes
    over."""
    keys = []

    def bn(prefix, c):
        keys.extend([(f"{prefix}.weight", (c,)), (f"{prefix}.bias", (c,)),
                     (f"{prefix}.running_mean", (c,)),
                     (f"{prefix}.running_var", (c,)),
                     (f"{prefix}.num_batches_tracked", ())])

    if backbone == "RN101":
        for i, (cin, cout) in enumerate(((3, 32), (32, 32), (32, 64)), 1):
            keys.append((f"visual.conv{i}.weight", (cout, cin, 3, 3)))
            bn(f"visual.bn{i}", cout)
        inplanes = 64
        for stage, blocks in enumerate((3, 4, 23, 3), 1):
            planes = 64 * 2 ** (stage - 1)
            for b in range(blocks):
                p = f"visual.layer{stage}.{b}"
                keys.append((f"{p}.conv1.weight", (planes, inplanes, 1, 1)))
                bn(f"{p}.bn1", planes)
                keys.append((f"{p}.conv2.weight", (planes, planes, 3, 3)))
                bn(f"{p}.bn2", planes)
                keys.append((f"{p}.conv3.weight", (4 * planes, planes, 1, 1)))
                bn(f"{p}.bn3", 4 * planes)
                if b == 0:
                    keys.append((f"{p}.downsample.0.weight",
                                 (4 * planes, inplanes, 1, 1)))
                    bn(f"{p}.downsample.1", 4 * planes)
                inplanes = 4 * planes
        keys.append(("visual.attnpool.positional_embedding",
                     (grid * grid + 1, 2048)))
        for proj, out in (("q", 2048), ("k", 2048), ("v", 2048), ("c", 512)):
            keys += [(f"visual.attnpool.{proj}_proj.weight", (out, 2048)),
                     (f"visual.attnpool.{proj}_proj.bias", (out,))]
    else:
        W = 768
        keys += [("visual.class_embedding", (W,)),
                 ("visual.positional_embedding", (grid * grid + 1, W)),
                 ("visual.proj", (W, 512)),
                 ("visual.conv1.weight", (W, 3, 32, 32)),
                 ("visual.ln_pre.weight", (W,)), ("visual.ln_pre.bias", (W,)),
                 ("visual.ln_post.weight", (W,)),
                 ("visual.ln_post.bias", (W,))]
        for i in range(12):
            p = f"visual.transformer.resblocks.{i}"
            keys += [(f"{p}.attn.in_proj_weight", (3 * W, W)),
                     (f"{p}.attn.in_proj_bias", (3 * W,)),
                     (f"{p}.attn.out_proj.weight", (W, W)),
                     (f"{p}.attn.out_proj.bias", (W,)),
                     (f"{p}.ln_1.weight", (W,)), (f"{p}.ln_1.bias", (W,)),
                     (f"{p}.mlp.c_fc.weight", (4 * W, W)),
                     (f"{p}.mlp.c_fc.bias", (4 * W,)),
                     (f"{p}.mlp.c_proj.weight", (W, 4 * W)),
                     (f"{p}.mlp.c_proj.bias", (W,)),
                     (f"{p}.ln_2.weight", (W,)), (f"{p}.ln_2.bias", (W,))]
    keys += [("token_embedding.weight", (49408, 512)), ("logit_scale", ())]
    return keys


def bart_base_keys(vocab: int = 50265):
    """(HF key, shape, the port tensor it fills, the vocabulary axis) of
    facebook/bart-base (6 + 6 layers, d 768, FFN 3072, 1026 learned
    positions); the tied lm_head fills nothing."""
    d, ffn, pos = 768, 3072, 1026
    keys = [("model.shared.weight", (vocab, d), "model.shared", 0),
            ("model.encoder.embed_tokens.weight", (vocab, d), "model.shared",
             0),
            ("model.decoder.embed_tokens.weight", (vocab, d), "model.shared",
             0),
            ("final_logits_bias", (1, vocab), "final_logits_bias", 1),
            ("lm_head.weight", (vocab, d), None, None)]
    for stack in ("encoder", "decoder"):
        hf, pt = f"model.{stack}", f"model.{stack}"
        keys += [(f"{hf}.embed_positions.weight", (pos, d),
                  f"{pt}.embed_positions", None),
                 (f"{hf}.layernorm_embedding.weight", (d,),
                  f"{pt}.layernorm_embedding.scale", None),
                 (f"{hf}.layernorm_embedding.bias", (d,),
                  f"{pt}.layernorm_embedding.bias", None)]
        attns = ("self_attn",) + (("encoder_attn",) if stack == "decoder"
                                  else ())
        for i in range(6):
            h, p = f"{hf}.layers.{i}", f"{pt}.layers_{i}"
            for a in attns:
                for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
                    keys += [(f"{h}.{a}.{proj}.weight", (d, d),
                              f"{p}.{a}.{proj}.weight", None),
                             (f"{h}.{a}.{proj}.bias", (d,),
                              f"{p}.{a}.{proj}.bias", None)]
                keys += [(f"{h}.{a}_layer_norm.weight", (d,),
                          f"{p}.{a}_layer_norm.scale", None),
                         (f"{h}.{a}_layer_norm.bias", (d,),
                          f"{p}.{a}_layer_norm.bias", None)]
            keys += [(f"{h}.fc1.weight", (ffn, d), f"{p}.fc1.weight", None),
                     (f"{h}.fc1.bias", (ffn,), f"{p}.fc1.bias", None),
                     (f"{h}.fc2.weight", (d, ffn), f"{p}.fc2.weight", None),
                     (f"{h}.fc2.bias", (d,), f"{p}.fc2.bias", None),
                     (f"{h}.final_layer_norm.weight", (d,),
                      f"{p}.final_layer_norm.scale", None),
                     (f"{h}.final_layer_norm.bias", (d,),
                      f"{p}.final_layer_norm.bias", None)]
    return keys


def t5_base_keys(vocab: int = 32128):
    """(HF key, shape, port tensor, vocabulary axis) of t5-base (12 + 12
    blocks, d 768, 12 heads of 64, relu FFN 3072, 32 relative-position
    buckets on block 0, tied head)."""
    d, ffn = 768, 3072
    keys = [("shared.weight", (vocab, d), "model.shared", 0),
            ("encoder.embed_tokens.weight", (vocab, d), "model.shared", 0),
            ("decoder.embed_tokens.weight", (vocab, d), "model.shared", 0),
            ("lm_head.weight", (vocab, d), None, None)]
    for stack in ("encoder", "decoder"):
        subs = (("SelfAttention", "self_attn"),) + (
            (("EncDecAttention", "cross_attn"),) if stack == "decoder" else ())
        for i in range(12):
            h, p = f"{stack}.block.{i}.layer", f"model.{stack}.blocks_{i}"
            for j, (hf_mod, mod) in enumerate(subs):
                for proj in ("q", "k", "v", "o"):
                    keys.append((f"{h}.{j}.{hf_mod}.{proj}.weight", (d, d),
                                 f"{p}.{mod}.{proj}.weight", None))
                if i == 0 and j == 0:
                    keys.append((f"{h}.0.SelfAttention.relative_attention_bias"
                                 f".weight", (32, 12),
                                 f"{p}.self_attn.relative_attention_bias",
                                 None))
                keys.append((f"{h}.{j}.layer_norm.weight", (d,),
                             f"{p}.{mod}_layer_norm.scale", None))
            f = len(subs)
            keys += [(f"{h}.{f}.DenseReluDense.wi.weight", (ffn, d),
                      f"{p}.wi.weight", None),
                     (f"{h}.{f}.DenseReluDense.wo.weight", (d, ffn),
                      f"{p}.wo.weight", None),
                     (f"{h}.{f}.layer_norm.weight", (d,),
                      f"{p}.ff_layer_norm.scale", None)]
        keys.append((f"{stack}.final_layer_norm.weight", (d,),
                     f"model.{stack}.final_layer_norm.scale", None))
    return keys


def seeded_state_dict(keys, seed: int):
    """{key: seeded CPU fp32 tensor} for (key, shape, ...) rows: N(0, 0.02),
    norm weights 1 + N(0, 0.1), BatchNorm variances in [0.5, 1.5], one
    tensor for the keys that share a port tensor (the tied embeddings)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out, shared = {}, {}
    for row in keys:
        key, shape = row[0], row[1]
        target = row[2] if len(row) > 2 else None
        if target is not None and target in shared:
            out[key] = shared[target]
            continue
        if key.endswith("num_batches_tracked"):
            t = torch.tensor(1000)
        elif key.endswith("running_var"):
            t = 0.5 + torch.rand(shape, generator=g, device="cuda")
        else:
            t = torch.randn(shape, generator=g, device="cuda") * 0.02
            if key.endswith(("norm.weight", "ln_1.weight", "ln_2.weight",
                             "ln_pre.weight", "ln_post.weight",
                             "layernorm_embedding.weight")) or (
                    ".bn" in key and key.endswith("weight")):
                t = t * 5 + 1.0
        out[key] = t.cpu()
        if target is not None:
            shared[target] = out[key]
    return out


def write_safetensors(tensors, path: str) -> None:
    """A ``.safetensors`` file of fp32 tensors: the 8-byte little-endian
    header length, the JSON header (dtype, shape, byte offsets), the raw
    little-endian buffers."""
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * 4
        header[k] = {"dtype": "F32", "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for t in tensors.values():
            f.write(t.float().contiguous().reshape(-1).view(torch.uint8)
                    .numpy().tobytes())


def check_clip_import(backbone: str, image: int) -> None:
    """An OpenAI CLIP visual dict (clip_visual_keys, seeded) into the
    port's trunk at ``image`` px: no skipped key, every filled tensor equal
    to the dict's (the RN101 attention pool's positional embedding to its
    cubic resize at 448), every other tensor unchanged, a finite forward
    of the grid's length."""
    grid = image // 32
    sd = seeded_state_dict(clip_visual_keys(backbone), 31)
    enc = CLIPVisualEncoder(backbone, image, device="cuda")
    enc.init_weights(torch.Generator(device="cuda").manual_seed(5))
    before = {k: v.clone() for k, v in enc.visual.state_dict().items()}
    t0 = time.perf_counter()
    report = load_clip_state_dict(enc, sd)
    secs = time.perf_counter() - t0
    if report["skipped"]:
        raise AssertionError(f"CLIP {backbone} {image}: skipped "
                             f"{report['skipped'][:5]}")
    own = enc.visual.state_dict()
    filled = set(report["filled"])
    resized = unfilled = 0
    for key in (k for k in sd if k.startswith("visual.")):
        name = key[len("visual."):]
        if key not in filled:
            if name in own and not torch.equal(own[name], before[name]):
                raise AssertionError(f"{key}: changed, not reported")
            unfilled += name in own
            continue
        want = sd[key].to(own[name].device)
        if want.shape != own[name].shape:
            want = resize_pos_embed(want, own[name].shape[0])
            resized += 1
        if not torch.equal(own[name], want.to(own[name].dtype)):
            raise AssertionError(f"{key}: port tensor differs from the file")
    with torch.no_grad():
        feats, pooled = enc(torch.randn(2, 3, image, image, device="cuda"))
    if (feats.shape[1] != grid * grid or not torch.isfinite(feats).all()
            or not torch.isfinite(pooled).all()):
        raise AssertionError(f"CLIP {backbone} {image}: bad forward "
                             f"{tuple(feats.shape)}")
    print(f"  CLIP {backbone} at {image} px: {len(sd)} keys, "
          f"{len(report['filled'])} tensors filled ({len(filled)} keys, "
          f"{resized} resized to {grid * grid + 1} positions), "
          f"{unfilled} trunk tensors left at their init (the JAX importer's "
          f"rule: the ViT's positional embedding is not resized), 0 skipped, "
          f"{secs:.2f} s; forward grid {tuple(feats.shape)}", flush=True)
    del enc, sd


def check_hf_import(label: str, keys, model, convert, path: str,
                    write) -> None:
    """A seeded HF state dict (``keys``) written to ``path`` by ``write``,
    read back by load_torch_state_dict and imported into ``model``: no
    skipped key; every port tensor a key names equal to the file's (the
    leading rows where the model's vocabulary is larger), the added rows
    and every tensor no key names unchanged."""
    sd = seeded_state_dict(keys, 37)
    t0 = time.perf_counter()
    write(sd, path)
    write_s = time.perf_counter() - t0
    own = model.state_dict()
    before = {k: v.clone() for k, v in own.items()}
    t0 = time.perf_counter()
    loaded = load_torch_state_dict(path)
    report = convert(loaded, model)
    load_s = time.perf_counter() - t0
    if report["skipped"]:
        raise AssertionError(f"{label}: skipped {report['skipped'][:5]}")
    named = set()
    grown = 0
    for key, shape, name, axis in keys:
        if name is None:
            continue
        named.add(name)
        got, want = own[name], sd[key].to(own[name].device)
        if axis is not None and got.shape[axis] > want.shape[axis]:
            n = want.shape[axis]
            head = got.narrow(axis, 0, n)
            tail = got.narrow(axis, n, got.shape[axis] - n)
            if not torch.equal(tail, before[name].narrow(
                    axis, n, got.shape[axis] - n)):
                raise AssertionError(f"{label} {name}: added rows changed")
            grown = got.shape[axis] - n
            got = head
        if not torch.equal(got, want.to(got.dtype)):
            raise AssertionError(f"{label} {key} -> {name}: differs")
    for name, t in own.items():
        if name not in named and not torch.equal(t, before[name]):
            raise AssertionError(f"{label} {name}: changed, no key names it")
    n_params = sum(t.numel() for t in {id(t): t for t in sd.values()}
                   .values())
    print(f"  {label}: {len(sd)} keys ({n_params / 1e6:.1f} M values), "
          f"{len(report['filled'])} tensors filled, 0 skipped; every named "
          f"tensor equal to the file's, {grown} added vocabulary rows at "
          f"their init; write {write_s:.2f} s, read + import {load_s:.2f} s "
          f"({os.path.getsize(path) / 2 ** 20:.0f} MiB)", flush=True)


@contextlib.contextmanager
def trainer_settings(autotuned: bool = False):
    """The library settings a Trainer run takes (device.deterministic_kernels:
    TF32 off, cuDNN's deterministic algorithms, no autotuner); with
    ``autotuned`` cuDNN's autotuner and any algorithm instead, to show what
    the deterministic choice costs. The cuDNN settings before are restored
    after."""
    cudnn = torch.backends.cudnn
    keep = cudnn.deterministic, cudnn.benchmark
    deterministic_kernels()
    if autotuned:
        cudnn.deterministic, cudnn.benchmark = False, True
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = keep


def cudnn_setting() -> str:
    cudnn = torch.backends.cudnn
    return (f"cuDNN deterministic={cudnn.deterministic} "
            f"benchmark={cudnn.benchmark}")


def raw_train_run(model, trainable, batch, steps: int, total_steps: int,
                  gen_seed: int, task: str = "vqa", lr: float = 1e-3):
    """``steps`` raw train steps of ``task`` with a fresh optimizer."""
    opt = build_optimizer(trainable, lr=lr, total_steps=total_steps)
    step = make_train_step(model, opt, FLAGSHIP_TASKS)
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    return [step(batch, gen, FLAGSHIP_TASKS.index(task))
            for _ in range(steps)]


def raw_train_parity(label: str, model, batch, task: str, K: int) -> dict:
    """K fp32 raw steps through the kernels, then again from the same
    weights and generator seed (bit for bit: the trunk's convolutions and
    their backward under the Trainer's settings, the kernels), then
    through the plain twins (phase 6's tolerances); the trunk's BatchNorm
    statistics unchanged by all. Returns the kernels' launches (with their
    routes)."""
    trainable = apply_freezing(model, model.cfg.pet)
    stats = {n: b.clone() for n, b in model.named_buffers()}
    start = snapshot(trainable)
    reset_counts()
    got = raw_train_run(model, trainable, batch, K, K + 1, 5, task)
    torch.cuda.synchronize()
    launched = {k: n for k, n in read_counts("train").items() if n}
    after = snapshot(trainable)
    restore(trainable, start)
    again = raw_train_run(model, trainable, batch, K, K + 1, 5, task)
    if not (all(torch.equal(a[k], b[k]) for a, b in zip(got, again)
                for k in a)
            and all(torch.equal(p, after[n]) for n, p in trainable.items())):
        raise AssertionError(f"{label}: a repeat from the same state is not "
                             f"bit for bit the first run ({cudnn_setting()})")
    restore(trainable, start)
    reset_counts()
    with plain_twins():
        want = raw_train_run(model, trainable, batch, K, K + 1, 5, task)
    torch.cuda.synchronize()
    if any_launched():
        raise AssertionError("the plain raw train step launched kernels")
    rows = [check_step(i, a, b) for i, (a, b) in enumerate(zip(got, want))]
    worst = check_params(trainable, after, start)
    if any(not torch.equal(b, stats[n]) for n, b in model.named_buffers()):
        raise AssertionError(f"{label}: a BatchNorm statistic moved")
    n_vis = sum(1 for n in trainable if n.startswith("vis_encoder."))
    print(f"  fp32 {label} dropout 0.1, {K} step(s), loss kernel/plain and "
          f"grad norm: {'; '.join(rows)}", flush=True)
    print(f"  repeat from the same state bit for bit ({cudnn_setting()})",
          flush=True)
    print(f"  {len(trainable)} trainable tensors ({n_vis} in the trunk's "
          f"visual adapters) agree (rtol {PARAM_RTOL}, atol "
          f"{PARAM_ATOL_SCALE} max|p|); largest |kernel - plain| / largest "
          f"update {worst:.2e}; {len(stats)} BatchNorm statistics unchanged; "
          f"launches {launched}", flush=True)
    restore(trainable, start)
    return launched


def phase_raw_parity() -> None:
    """6i: fp32 parity kernels vs plain on the raw path, BART-base +
    VL-PET-large + RN101 at 224 px with --use_vis_adapter, from the weights
    after ``unzero``: 3 vqa steps at B 8 (S 69); one NLVR two-image step at
    B 4 (S 118, its route printed); caption beam-5 and greedy tokens at B
    8 to length 40, identical. Then the importers at full shape from
    seeded state dicts whose names and shapes are written out here: OpenAI
    CLIP RN101 and ViT-B/32 at 224 and 448 px, no skipped key; HF
    BART-base (vocabulary 50265, into a model of 50365 rows) through a
    .safetensors file and T5-base (32128, into 32200) through a torch .bin:
    every named tensor equal to the file's, the added rows at their
    init."""
    t0 = time.perf_counter()
    model = raw_model("float32")
    unzero(model)
    V = model.cfg.backbone.vocab_size
    S = RAW_TEXT + 2 * RAW_GRID
    with trainer_settings():
        raw_train_parity(f"raw vqa B8 S{RAW_TEXT + RAW_GRID}", model,
                         make_raw_train_batch(8, V, 61), "vqa", 3)
        launched = raw_train_parity(
            f"raw nlvr two images B4 S{S} (backward_route "
            f"{attention.backward_route(S, S, 64, torch.float32)})", model,
            make_raw_train_batch(4, V, 63, n_images=2), "nlvr", 1)
    print(f"  nlvr routes: "
          f"{ {k: n for k, n in launched.items() if '[' in k} }", flush=True)
    print(f"  raw train parity: {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    model = raw_model("float32")
    ctx = PetContext(task="caption", task_idx=FLAGSHIP_TASKS.index("caption"))
    parity_run(f"raw caption B8 S{RAW_TEXT + RAW_GRID} len40, init std 0.02",
               model, make_raw_batch(8, V, 65), ctx, 40, min_distinct=2)
    del model
    t1 = time.perf_counter()
    for backbone in ("RN101", "ViT-B/32"):
        for image in (224, 448):
            check_clip_import(backbone, image)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = flagship_cfg("float32")
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, vocab_size=50265 + 100))
        model = VLBart(cfg, device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(3))
        check_hf_import("HF BART-base -> VLBart (.safetensors)",
                        bart_base_keys(), model, bart_hf_to_port,
                        os.path.join(tmp, "bart.safetensors"),
                        write_safetensors)
        del model
        cfg = t5_cfg("float32")
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, vocab_size=32200))
        model = VLT5(cfg, device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(3))
        check_hf_import("HF T5-base -> VLT5 (torch .bin)", t5_base_keys(),
                        model, t5_hf_to_port,
                        os.path.join(tmp, "t5.bin"),
                        lambda sd, p: torch.save(sd, p))
        del model
    print(f"  importers: {time.perf_counter() - t1:.1f} s", flush=True)


def _events_around(model, name: str):
    """Wrap model.<name> with CUDA events; returns the list of (start, end)
    pairs it records."""
    fn, spans = getattr(model, name), []

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn(*a, **kw)
        e.record()
        spans.append((s, e))
        return out

    setattr(model, name, timed)
    return spans


def fit_batch(run, B: int, step: int):
    """run(B) at the largest B (from ``B`` down by ``step``) whose memory
    fits on the card; returns (B, run's result)."""
    while True:
        try:
            return B, run(B)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"    B {B} does not fit in the card's memory", flush=True)
            B -= step
            if B <= 0:
                raise


def trunk_bench(card: str, backbone: str, image: int) -> None:
    """7h (a): the trunk alone in bf16 at RAW_TRUNK_B: images/s for the
    forward (no autograd) and for forward + backward (the gradient of a
    pooled-sum loss w.r.t. every trunk parameter, as
    scripts/bench_vision.py takes it), each from CUDA events, and the peak
    GiB; the batch of the backward is the largest multiple of 32 that
    fits."""
    enc = CLIPVisualEncoder(backbone, image, dtype=torch.bfloat16,
                            device="cuda")
    enc.init_weights(torch.Generator(device="cuda").manual_seed(7))
    params = list(enc.parameters())

    def fwd_at(B):
        x = torch.randn(B, 3, image, image, device="cuda")
        with torch.no_grad():
            ms = cuda_ms(lambda: enc(x)[1], iters=5, warmup=2)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    def train_at(B):
        x = torch.randn(B, 3, image, image, device="cuda")

        def run():
            loss = (enc(x)[1].float() ** 2).sum()
            return torch.autograd.grad(loss, params)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, iters=3, warmup=1)
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    torch.cuda.reset_peak_memory_stats()
    Bf, (fms, fpeak) = RAW_TRUNK_B, fwd_at(RAW_TRUNK_B)
    Bt, (tms, tpeak) = fit_batch(train_at, RAW_TRUNK_B, 32)
    print(f"  trunk {backbone} at {image} px, bf16: forward B{Bf} "
          f"{fms:.2f} ms, {Bf / fms * 1e3:.1f} images/s, peak {fpeak:.2f} "
          f"GiB; forward + backward B{Bt} {tms:.2f} ms, "
          f"{Bt / tms * 1e3:.1f} images/s, peak {tpeak:.2f} GiB on {card}",
          flush=True)
    del enc, params


def raw_train_bench(card: str, label: str, path, adapter: bool,
                    unfreeze: bool, t5: bool = False, B: int = RAW_B,
                    lr: float = 1e-3, autotuned: bool = False):
    """7h (b): the bf16 raw vqa step (20 text + 49 grid tokens, 10
    targets, dropout 0.1, clip 5) at B (or the largest multiple of 50
    below it that fits), under a Trainer run's library settings
    (``trainer_settings``; ``autotuned``: cuDNN's autotuner instead): 2
    warm-up steps, then 5 timed steps ending in one sync; ms/step,
    examples/s, peak GiB, and the trunk's share of the step (CUDA events
    around ``vis_forward``, summed over the timed steps, over the steps'
    wall time); where ``path`` is set, then one step kernels vs plain
    (``step_vs_plain``). Returns the timed steps' launches (the ``path``
    main-path run when ``path`` is set)."""
    with trainer_settings(autotuned):
        return _raw_train_bench(card, label, path, adapter, unfreeze, t5, B,
                                lr)


def _raw_train_bench(card, label, path, adapter, unfreeze, t5, B, lr):
    warm, timed = 2, 5
    model = raw_model("bfloat16", adapter, unfreeze, t5)
    trainable = apply_freezing(model, model.cfg.pet)
    n_train = sum(p.numel() for p in trainable.values())
    V = model.cfg.backbone.vocab_size
    opt = build_optimizer(trainable, lr=lr, total_steps=warm + timed + 1)
    step = make_train_step(model, opt, FLAGSHIP_TASKS)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def run(b):
        batch = make_raw_train_batch(b, V, 71)
        for _ in range(warm):
            out = step(batch, gen, 0)
        out["loss"].item()
        return batch

    B, batch = fit_batch(run, B, 50)
    spans = _events_around(model, "vis_forward")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = step(batch, gen, 0)
    loss = out["loss"].item()
    wall = time.perf_counter() - t0
    launched = read_counts(path) if path else {
        k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    if path:
        require_tc(path, launched)
    if not math.isfinite(loss) or not math.isfinite(out["grad_norm"].item()):
        raise AssertionError(f"{label}: non-finite loss {loss}")
    trunk_ms = sum(s.elapsed_time(e) for s, e in spans[-timed:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if path:
        RUNS[path] = dict(ex_s=B * timed / wall, ms_step=wall / timed * 1e3,
                          peak_gib=peak)
    print(f"  bf16 B{B} {label} raw step ({cudnn_setting()}): "
          f"{wall / timed * 1e3:.2f} ms/step, "
          f"{B * timed / wall:.2f} examples/s, peak {peak:.2f} GiB, trunk "
          f"{trunk_ms / timed:.2f} ms/step = {trunk_ms / (wall * 1e3):.3f} "
          f"of the step; {n_train / 1e6:.2f} M trainable; loss {loss:.4f} on "
          f"{card}; launches per step "
          f"{ {k: n / timed for k, n in launched.items() if n} }", flush=True)
    if "--profile" in sys.argv and path:
        profile_run(lambda: step(batch, gen, 0)["loss"].item(), card,
                    f"{label} raw step")
    if path:  # the main-path step: A6's wide kernel at S 69
        step_vs_plain(f"bf16 B{B} {label}", step, trainable, batch, gen, 0)
    del model, opt, step, batch
    return launched


def phase_raw_bench(card: str) -> dict:
    """7h: what the raw path costs, bf16, full width. (a) the trunk alone:
    RN50, RN101 and ViT-B/32 at 224 px and RN101 at 448 px, B 256, forward
    and forward + backward (``trunk_bench``). (b) the raw VL-PET-large vqa
    step at B 500 under a Trainer run's library settings with a frozen
    trunk, with --use_vis_adapter (the raw_step main-path run) and with
    --unfreeze_vis_encoder (``chip_phases.py`` 7i adds the step under
    cuDNN's autotuner), and one raw
    T5-base VL-PET-large step at B 300 (``raw_train_bench``). (c) the raw
    caption beam-5 eval at B 500 to length 40 (the raw_eval main-path run)
    and the NLVR two-image scoring (one deterministic forward on the fixed
    decoder input) at B 166, examples/s. (d) the extractor: RN101 at 224
    px over 2048 seeded preprocessed images at B 256, images/s, and
    PackedFeatureSource reading back what a direct trunk forward gives for
    8 of them (fp32 tolerance)."""
    launched = {}
    t0 = time.perf_counter()
    for backbone, image in (("RN50", 224), ("RN101", 224), ("ViT-B/32", 224),
                            ("RN101", 448)):
        trunk_bench(card, backbone, image)
    print(f"  (a) trunks: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    raw_train_bench(card, "vqa frozen trunk", None, False, False)
    launched[RAW_STEP] = raw_train_bench(card, "vqa --use_vis_adapter",
                                         RAW_STEP, True, False)
    raw_train_bench(card, "vqa --unfreeze_vis_encoder", None, False, True)
    raw_train_bench(card, "T5-base vqa --use_vis_adapter", None, True, False,
                    t5=True, B=RAW_T5_B, lr=T5_LR)
    print(f"  (b) raw steps: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    model = raw_model("bfloat16")
    V = model.cfg.backbone.vocab_size
    ctx = PetContext(task="caption", task_idx=FLAGSHIP_TASKS.index("caption"))
    launched[RAW_EVAL] = generate_bench(
        card, model, make_raw_batch(RAW_B, V, 73), ctx, 40, RAW_EVAL,
        f"raw caption S{RAW_TEXT + RAW_GRID} beam5 len40")
    Bn = RAW_B * 20 // 60  # the CLI's nlvr batch at base 500
    nb = make_raw_batch(Bn, V, 75, n_images=2)
    dec = torch.tensor([[2, 0]], device="cuda").expand(Bn, -1)
    nctx = PetContext(task="nlvr", task_idx=FLAGSHIP_TASKS.index("nlvr"))

    def score():
        with torch.no_grad():
            return model(nb["input_ids"], nb["attention_mask"],
                         nb["vis_feats"], decoder_input_ids=dec, ctx=nctx)[
                "logits"][:, 1]
    ms = cuda_ms(score, iters=3, warmup=1)
    if not torch.isfinite(score()).all():
        raise AssertionError("raw nlvr scoring: non-finite logits")
    print(f"  bf16 B{Bn} raw nlvr two-image scoring S"
          f"{RAW_TEXT + 2 * RAW_GRID}: {ms:.2f} ms, {Bn / ms * 1e3:.1f} "
          f"examples/s on {card}", flush=True)
    del model, nb
    print(f"  (c) raw evals: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    n, B = 2048, 256
    enc = CLIPVisualEncoder(RAW_BACKBONE, RAW_IMAGE, device="cuda")
    enc.init_weights(torch.Generator(device="cuda").manual_seed(11))
    g = torch.Generator().manual_seed(13)
    images = torch.randn((n, RAW_IMAGE, RAW_IMAGE, 3), generator=g)
    ids = [f"img{i}" for i in range(n)]
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "packed")
        write_features(enc, lambda i: images[int(i[3:])].numpy(), ids[:B],
                       prefix, B)  # warm-up: cuDNN's algorithms
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        write_features(enc, lambda i: images[int(i[3:])].numpy(), ids,
                       prefix, B)
        secs = time.perf_counter() - t1
        src = PackedFeatureSource(prefix)
        pick = ids[::n // 8][:8]
        x = torch.stack([images[int(i[3:])] for i in pick]).cuda()
        with torch.no_grad():
            want = enc(x.permute(0, 3, 1, 2).contiguous())[0].float().cpu()
        got = torch.stack([torch.tensor(src.get(i)[0]) for i in pick])
        err = compare("extractor packed vs direct", got, want, torch.float32,
                      scaled=True)
        size = os.path.getsize(prefix + ".npy") / 2 ** 20
    print(f"  extractor RN101 {RAW_IMAGE} px fp32: {n} images at B{B} in "
          f"{secs:.2f} s = {n / secs:.1f} images/s (the loop: host stacking, "
          f"copies, trunk, write of {size:.0f} MiB) on {card}; "
          f"PackedFeatureSource vs a direct forward on 8: max|err| "
          f"{err:.2e}", flush=True)
    del enc, images
    print(f"  (d) extractor: {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def phase_raw_cudnn(card: str) -> None:
    """7i (``chip_phases.py`` only; cuDNN's ~20 s of autotuning stays out
    of the smoke's run): 7h's --use_vis_adapter raw step under a Trainer
    run's settings (cuDNN's deterministic algorithms, no autotuner), then
    under cuDNN's autotuner with any algorithm: what the Trainer's
    deterministic choice costs the step."""
    for autotuned in (False, True):
        raw_train_bench(card, "vqa --use_vis_adapter", None, True, False,
                        autotuned=autotuned)


# phase 8d: the user's pipeline on the CLI. The features run: seeded
# annotation json of vqa and caption (RAW_CLI_TRAIN examples each, and
# RAW_CLI_VALID to evaluate) and their images' features written by the
# extractor's loop (RN101, 224 px); VL-PET-large.sh's flags (--downsample
# pools the 7 x 7 grid to 36) + --bf16 --backbone_ckpt <seeded BART-base
# .safetensors>, one epoch, each task evaluated, then --resume. The raw run:
# the same flags with --feature_type raw_RN101 --image_size "(224,224)"
# --clip_ckpt <seeded RN101 .pt> --use_vis_adapter, on a folder of seeded
# PNGs, over vqa and nlvr, for RAW_CLI_RAW_EPOCHS epochs; then its train
# loader alone in this process, to part the host's decoding from the
# steps.
RAW_CLI_TRAIN, RAW_CLI_VALID = 1000, 500
RAW_CLI_RAW_TRAIN, RAW_CLI_RAW_VALID = 500, 100
RAW_CLI_RAW_EPOCHS = 2  # the second's steps have no first-step warm-up
RAW_CLI_PNG = (160, 128)  # the PNGs' width and height (resized to 224)


def cli_annotations(task: str, n: int, seed: int, prefix: str):
    """Seeded reference-format examples (the synthetic data's layout):
    vqa questions with scored answers, captions with two targets, NLVR
    pairs with a label; image ids ``{prefix}{i}`` (NLVR: two a pair)."""
    rnd = random.Random(seed)
    words = ["red", "blue", "dog", "cat", "ball", "table", "man", "woman",
             "tree", "car"]
    out = []
    for i in range(n):
        sent = " ".join(rnd.choice(words) for _ in range(5))
        if task == "vqa":
            out.append({"img_id": f"{prefix}{i}", "sent": f"what is {sent}",
                        "question_id": i, "label": {rnd.choice(words): 1.0,
                                                    rnd.choice(words): 0.3}})
        elif task == "caption":
            out.append({"img_id": f"{prefix}{i}", "sent": sent,
                        "targets": [sent, sent + " outside"],
                        "question_id": i})
        else:
            out.append({"img0": f"{prefix}{2 * i}", "img1":
                        f"{prefix}{2 * i + 1}", "sent": sent, "uid": i,
                        "identifier": f"test1-{i // 2}-{i % 2}-0",
                        "label": rnd.randint(0, 1)})
    return out


def write_png(path: str, rgb: bytes, width: int, height: int) -> None:
    """An 8-bit RGB PNG (no filter, zlib level 1) from raw row-major
    bytes."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))
    row = 3 * width
    raw = b"".join(b"\x00" + rgb[y * row:(y + 1) * row] for y in range(height))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", width.to_bytes(4, "big")
                        + height.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0]))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def _cli_epoch(out_dir: str, tasks) -> dict:
    recs, epochs = _epochs_of(out_dir, tasks)
    if len(epochs) != 1:
        raise AssertionError(f"{len(epochs)} epochs")
    r = epochs[0]
    r["data_build_seconds"] = next(x["data_build_seconds"] for x in recs
                                   if "data_build_seconds" in x)
    return r


def _print_cli(card: str, label: str, r: dict, res: dict, tasks) -> None:
    print(f"  {label} on {card}: data build {r['data_build_seconds']:.2f} s, "
          f"{int(r['train_steps'])} steps in {r['train_seconds']:.2f} s "
          f"({r['train_seconds'] / r['train_steps'] * 1e3:.2f} ms/step, "
          f"{r['train_examples'] / r['train_seconds']:.2f} examples/s), loss "
          f"{r['train_loss']:.4f}; eval "
          + ", ".join(f"{t} {r[f'{t}/eval_seconds']:.2f} s" for t in tasks)
          + f"; process {res['process_s']:.2f} s; launches "
          f"{ {k: n for k, n in res['launches'].items() if n} }", flush=True)


def phase_cli_raw(card: str) -> dict:
    """8d: the user's pipeline on the CLI, in child processes as phase 8.
    (1) the extractor's loop (``write_features``, RN101 at 224 px, fp32)
    writes <root>/vqa_features and <root>/caption_features for seeded
    preprocessed images, beside seeded annotation json; (2) ``python -m
    vlpet_tpu_torch.cli.multitask`` with VL-PET-large.sh's flags + --bf16
    --data_root <root> --backbone_ckpt <seeded BART-base .safetensors>
    --tasks vqa,caption, one epoch, each task evaluated (the cli_features
    run), then --resume restores the state bit for bit; (3) the same flags
    with --feature_type raw_RN101 --image_size "(224,224)" --clip_ckpt
    <seeded RN101 .pt> --use_vis_adapter --tasks vqa,nlvr on a folder of
    seeded PNGs (the cli_raw run). Prints the data build seconds, ms/step,
    each task's eval seconds and the launches by kernel."""
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "features")
        os.makedirs(root)
        enc = CLIPVisualEncoder(RAW_BACKBONE, RAW_IMAGE, device="cuda")
        enc.init_weights(torch.Generator(device="cuda").manual_seed(17))
        g = torch.Generator().manual_seed(19)
        n_img = RAW_CLI_TRAIN + RAW_CLI_VALID
        for task in ("vqa", "caption"):
            for split, n, off in (("train", RAW_CLI_TRAIN, 0),
                                  ("valid", RAW_CLI_VALID, RAW_CLI_TRAIN)):
                ex = cli_annotations(task, n, 23 + off, f"{task}_")
                for i, e in enumerate(ex):
                    e["img_id"] = f"{task}_{off + i}"
                with open(os.path.join(root, f"{task}_{split}.json"),
                          "w") as f:
                    json.dump(ex, f)
            write_features(
                enc, lambda i: torch.randn((RAW_IMAGE, RAW_IMAGE, 3),
                                           generator=g).numpy(),
                [f"{task}_{i}" for i in range(n_img)],
                os.path.join(root, f"{task}_features"), RAW_TRUNK_B)
        del enc
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "bart-base.safetensors")
        write_safetensors(seeded_state_dict(bart_base_keys(), 37), ckpt)
        clip_pt = os.path.join(tmp, "RN101.pt")
        torch.save(seeded_state_dict(clip_visual_keys("RN101"), 31), clip_pt)
        ckpt_s = time.perf_counter() - t0
        print(f"  extractor: {2 * n_img} images' features in {extract_s:.2f} "
              f"s; seeded BART-base .safetensors and RN101 .pt written in "
              f"{ckpt_s:.2f} s", flush=True)
        flags = script_flags(
            os.path.join(os.path.dirname(CLI_SCRIPT), "VL-PET-large.sh"),
            ["0", "96", "4", "96", "96", "1e-3", "9595"]) + [
            "--bf16", "--backbone_ckpt", ckpt, "--epochs", "1", "--device",
            "cuda"]
        out_dir = os.path.join(tmp, "run")
        fflags = flags + ["--data_root", root, "--tasks", "vqa,caption",
                          "--output", out_dir]
        out1, res1 = run_cli(fflags, "features train")
        launched[CLI_FEATURES] = res1["launches"]
        require_launched(CLI_FEATURES, res1["launches"])
        if "imported" not in out1:
            raise AssertionError("the features run printed no import")
        saved_step, saved = _digest(out1, r"saved at step (\d+); state "
                                          r"digest ([0-9a-f]+)")
        r1 = _cli_epoch(out_dir, ("vqa", "caption"))
        out2, res2 = run_cli(fflags + ["--resume"], "features resume")
        step2, restore_s, restored = _digest(
            out2, r"resumed from step (\d+) in ([0-9.]+) s; state digest "
                  r"([0-9a-f]+)")
        end_step, end = _digest(out2, r"saved at step (\d+); state digest "
                                      r"([0-9a-f]+)")
        if (step2, restored, end_step, end) != (saved_step, saved,
                                                saved_step, saved):
            raise AssertionError(f"resume: step {step2} digest {restored}, "
                                 f"saved again at {end_step} {end}; saved "
                                 f"step {saved_step} digest {saved}")
        _print_cli(card, "features run (VL-PET-large.sh, vqa + caption, "
                   "--backbone_ckpt)", r1, res1, ("vqa", "caption"))
        print(f"  resume: state at step {saved_step} restored bit for bit "
              f"(digest {saved[:16]}) in {float(restore_s):.3f} s; process "
              f"{res2['process_s']:.2f} s", flush=True)
        # (3) the raw run on PNGs
        t0 = time.perf_counter()
        raw_root = os.path.join(tmp, "raw")
        os.makedirs(os.path.join(raw_root, "images"))
        w, h = RAW_CLI_PNG
        n_pairs = RAW_CLI_RAW_TRAIN // 3
        for task, n_tr, n_va in (("vqa", RAW_CLI_RAW_TRAIN, RAW_CLI_RAW_VALID),
                                 ("nlvr", n_pairs, RAW_CLI_RAW_VALID // 2)):
            for split, n, seed in (("train", n_tr, 29), ("valid", n_va, 31)):
                ex = cli_annotations(task, n, seed, f"{task}_{split}_")
                with open(os.path.join(raw_root, f"{task}_{split}.json"),
                          "w") as f:
                    json.dump(ex, f)
                for i in range(n * (2 if task == "nlvr" else 1)):
                    rgb = torch.randint(0, 256, (h * w * 3,), generator=g,
                                        dtype=torch.uint8)
                    write_png(os.path.join(raw_root, "images",
                                           f"{task}_{split}_{i}.png"),
                              rgb.numpy().tobytes(), w, h)
        png_s = time.perf_counter() - t0
        raw_dir = os.path.join(tmp, "raw_run")
        rflags = flags + ["--data_root", raw_root, "--tasks", "vqa,nlvr",
                          "--feature_type", f"raw_{RAW_BACKBONE}",
                          "--image_size", f"({RAW_IMAGE},{RAW_IMAGE})",
                          "--clip_ckpt", clip_pt, "--use_vis_adapter",
                          "--output", raw_dir,
                          "--epochs", str(RAW_CLI_RAW_EPOCHS)]
        out3, res3 = run_cli(rflags, "raw train")
        launched[CLI_RAW] = res3["launches"]
        require_launched(CLI_RAW, res3["launches"])
        if "CLIP import" not in out3:
            raise AssertionError("the raw run printed no CLIP import")
        recs, epochs = _epochs_of(raw_dir, ("vqa", "nlvr"))
        if len(epochs) != RAW_CLI_RAW_EPOCHS:
            raise AssertionError(f"the raw run: {len(epochs)} epochs")
        r3 = dict(epochs[0], data_build_seconds=next(
            x["data_build_seconds"] for x in recs
            if "data_build_seconds" in x))
        print(f"  {len(os.listdir(os.path.join(raw_root, 'images')))} seeded "
              f"{w} x {h} PNGs written in {png_s:.2f} s", flush=True)
        _print_cli(card, "raw run (raw_RN101 224 px, --use_vis_adapter, "
                   "--clip_ckpt, vqa + nlvr), epoch 1", r3, res3,
                   ("vqa", "nlvr"))
        r = epochs[-1]
        print(f"  raw run, epoch {len(epochs)} (no first step): "
              f"{int(r['train_steps'])} steps in {r['train_seconds']:.2f} s "
              f"({r['train_seconds'] / r['train_steps'] * 1e3:.2f} ms/step, "
              f"{r['train_examples'] / r['train_seconds']:.2f} examples/s)",
              flush=True)
        raw_loader_alone(card, rflags)
    return launched


def raw_loader_alone(card: str, argv) -> None:
    """The raw run's train batches from its loader alone, in this process
    and with no step: the CLI's own data pipeline (PIL decoding and
    resizing each PNG, the collate), one epoch; the seconds a batch beside
    the CLI run's ms/step tell the host's share of it."""
    from vlpet_tpu_torch.cli import multitask as cli
    from vlpet_tpu_torch.data.multitask import MultitaskLoader
    from vlpet_tpu_torch.data.tokenization import get_tokenizer

    args = cli.parse_args(argv)
    tasks = tuple(args.tasks.split(","))
    tokenizer, _ = get_tokenizer(args.backbone, args.tokenizer_path)
    loader = MultitaskLoader(cli.build_loaders(args, tasks, tokenizer,
                                               args.train, "train"),
                             sampling=args.multitask_sampling)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    sizes = [len(b["input_ids"]) for b in loader]
    secs = time.perf_counter() - t0
    print(f"  the raw run's train loader alone (no steps, host): "
          f"{len(sizes)} batches of {sizes} in {secs:.2f} s = "
          f"{secs / len(sizes) * 1e3:.2f} ms a batch, "
          f"{sum(sizes) / secs:.2f} examples/s on the host of {card}",
          flush=True)


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


# phases 6j and 7j: the VL-PET ablation flags, each family the
# VL-PET-large recipe (flagship_cfg: r 96, 4 heads, gate 96, VPA 96) with
# one group of flags swapped in at those dims. Every flag group below is
# {PetConfig or VisConfig field: value} over VL-PET-large's.
_NO_LARGE_GATE = dict(use_encoder_adapter_gating_large_x_lowrank=False)
_NO_VPA = dict(use_decoder_enc_attn_value_parallel_adapter_down_dim=False)
_NO_DOWN_MH = dict(use_encoder_adapter_down_multihead=False,
                   use_encoder_multihead_up_zero_init=True)
_VPA_HEADS = dict(_NO_VPA,
                  decoder_enc_attn_value_parallel_adapter_multihead_num_head=4)
_LOWRANK_VIS = dict(use_lowrank_visual_projector=True,
                    visual_projector_down_dim=96,
                    visual_projector_multihead_num_head=4,
                    use_visual_projector_gating_large_x_lowrank=True,
                    visual_projector_gating_down_dim=96)
ABLATIONS = {
    # 0: VL-PET-large itself, phase 7j's reference in the same call
    "vlpet_large": (0, {}),
    # 1: the multihead adapter shapes, their ups zero-initialised
    "mh_up": (1, dict(_NO_DOWN_MH, use_encoder_adapter_up_multihead=True)),
    "mh_down_up": (1, dict(_NO_DOWN_MH,
                           use_encoder_adapter_down_up_multihead=True)),
    "mh_pair": (1, dict(_NO_DOWN_MH,
                        use_encoder_adapter_down_up_pair_multihead=True)),
    # 2: the gate's normalisation
    "gating_layernorm": (2, dict(_NO_LARGE_GATE,
                                 use_encoder_adapter_gating_layernorm=True)),
    "gating_l2norm": (2, dict(_NO_LARGE_GATE,
                              use_encoder_adapter_gating_l2norm=True)),
    # 3: the standalone gate, both forms
    "standalone_gating": (3, dict(_NO_LARGE_GATE,
                                  use_encoder_gating_large_x_lowrank=True,
                                  gating_down_dim=96)),
    "standalone_gating_add_x2": (3, dict(
        _NO_LARGE_GATE, use_encoder_gating_large_x_lowrank=True,
        gating_down_dim=96,
        use_encoder_gating_large_x_lowrank_add_x2_deltay=True)),
    # 4: the key parallel adapter beside the VPA
    "key_parallel": (4, dict(
        use_decoder_enc_attn_key_parallel_adapter_down_dim=True,
        decoder_enc_attn_key_parallel_adapter_down_dim=96)),
    # 5: the decoder's multihead adapters and the key-value adapter
    "decoder_mh_kv_adapter": (5, dict(
        use_decoder_adapter_down_multihead=True,
        decoder_adapter_multihead_num_head=4,
        use_decoder_enc_attn_key_value_adapter_down_dim=True,
        decoder_enc_attn_key_value_adapter_down_dim=96)),
    # 6: the sequential value adapter with the residual and its gate
    "sequential_va": (6, dict(
        _NO_VPA, use_decoder_enc_attn_value_sequential_adapter_down_dim=True,
        decoder_enc_attn_value_sequential_adapter_down_dim=96,
        use_decoder_enc_attn_value_residual_connection=True,
        use_decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank=True,
        decoder_enc_attn_value_sequential_adapter_gating_large_x_lowrank_down_dim=96)),
    # 7: the VPA with the residual gate; the multihead and pair VPAs
    "vpa_residual_gate": (7, dict(
        use_decoder_enc_attn_value_residual_connection=True,
        use_decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank=True,
        decoder_enc_attn_value_parallel_adapter_gating_large_x_lowrank_down_dim=96)),
    "mh_vpa": (7, dict(
        _VPA_HEADS,
        use_decoder_enc_attn_value_parallel_adapter_down_multihead=True)),
    "pair_vpa": (7, dict(
        _VPA_HEADS,
        use_decoder_enc_attn_value_parallel_adapter_down_up_pair_multihead=True)),
    # 8: the decoder's down-dim adapters and the cross gate
    "decoder_adapters": (8, dict(
        use_decoder_self_attn_adapter_down_dim=True,
        decoder_self_attn_adapter_down_dim=96,
        use_decoder_enc_attn_adapter_down_dim=True,
        decoder_enc_attn_adapter_down_dim=96,
        use_decoder_enc_attn_adapter_gating_large_x_lowrank=True,
        decoder_enc_attn_adapter_gating_large_x_lowrank_down_dim=96,
        use_decoder_ff_adapter_down_dim=True, decoder_ff_adapter_down_dim=96)),
    # 9: IA3 on the cross value and the decoder FFN in place of the VPA,
    # with the four value flags that build nothing
    "ia3": (9, dict(
        _NO_VPA, use_decoder_enc_attn_value_ia3=True,
        use_decoder_enc_attn_value_ia3_add=True,
        use_decoder_enc_attn_value_ia3_one_init=True,
        use_decoder_ff_ia3=True, use_decoder_ff_ia3_add=True,
        use_decoder_ff_ia3_one_init=True, use_encoder_attn_value_ia3=True,
        use_decoder_self_attn_value_ia3=True,
        use_encoder_attn_value_parallel_adapter_down_dim=True,
        encoder_attn_value_parallel_adapter_down_dim=96,
        use_decoder_self_attn_value_parallel_adapter_down_dim=True,
        decoder_self_attn_value_parallel_adapter_down_dim=96)),
    # 10: the low-rank visual projector (BART here, T5-base below)
    "lowrank_visual_projector": (10, _LOWRANK_VIS),
    # 11: single_adapter.sh's flags with --track_z --lambda_z 1e-3
    "track_z": (11, dict(track_z=True, lambda_z=1e-3)),
}
# phase 6j's depth, encoder and decoder layers each: at 6+6 (T5-base
# 12+12) 6j took ~75 s and 7j ~45 s of the ~90 s the two may add to the
# smoke, and T5-base's third fp32 step parted by 4.4e-5 in the gradient
# norm (the 12+12 T5 drift of phase 6c; PERF.md, Findings)
ABL_PARITY_LAYERS = 2


def _with_fields(cfg, flags: dict):
    """``cfg`` with each flag set on its PetConfig or VisConfig."""
    pet = {k: v for k, v in flags.items() if hasattr(cfg.pet, k)}
    vis = {k: v for k, v in flags.items() if k not in pet}
    return dataclasses.replace(cfg, pet=dataclasses.replace(cfg.pet, **pet),
                               vis=dataclasses.replace(cfg.vis, **vis))


def ablation_cfg(name: str, layers=None):
    """The configuration function of an ablation (``ABLATIONS``; the T5
    one is ``t5_<name>``), with ``layers`` encoder and decoder layers each
    where given."""
    t5 = name.startswith("t5_")
    flags = ABLATIONS[name[3:] if t5 else name][1]

    def cfg(dtype: str = "float32"):
        if t5:
            base = t5_cfg(dtype)
        elif name == "track_z":
            base = pet_cfg("single_adapter")(dtype)
        else:
            base = flagship_cfg(dtype)
        c = _with_fields(base, flags)
        if layers is not None:
            b = c.backbone
            one = (dict(num_layers=layers, num_decoder_layers=layers) if t5
                   else dict(encoder_layers=layers, decoder_layers=layers))
            c = dataclasses.replace(c, backbone=dataclasses.replace(b, **one))
        return c
    return cfg


def phase_ablation_parity() -> None:
    """6j: per ablation (``ABLATIONS``, and the low-rank projector on
    T5-base), phase 6c's fp32 per-step train parity (B 8, vqa, dropout
    0.1, 3 steps, each from the plain state, kernels vs plain; from the
    weights after ``unzero``) under phase 6's tolerances (loss and grad
    norm 1e-5 relative, parameters elementwise: ``elementwise``; T5 by
    6c's update ratio, as phase 6c holds T5) at ``ABL_PARITY_LAYERS``;
    then, for the
    families whose hooks reach the decode (4-9), phase 4 (a)'s beam-5 and
    greedy caption tokens at B 8 to length 40 from the init, kernels vs
    plain, identical."""
    ctx = PetContext(task="caption", task_idx=3)
    for name in ABL_BART + ("t5_lowrank_visual_projector",):
        t0 = time.perf_counter()
        cfg_fn = ablation_cfg(name, ABL_PARITY_LAYERS)
        t5 = name.startswith("t5_")
        lambda_z = ABLATIONS[name][1].get("lambda_z", 0.0) if not t5 else 0.0
        train_parity_per_step(
            f"{name} B8 vqa", cfg_fn,
            make_t5_train_batch if t5 else make_train_batch, 8, 21,
            FLAGSHIP_TASKS, "vqa", T5_LR if t5 else 1e-3, f"abl_{name}",
            lambda_z=lambda_z, elementwise=not t5)
        if name in ABL_DECODE:
            model = build_model("float32", cfg_fn)
            parity_run(f"{name} init std 0.02", model,
                       make_batch(8, model.cfg.backbone.vocab_size, seed=7),
                       ctx, 40, min_distinct=2)
            del model
        print(f"  {name} (family {ABLATIONS[name.replace('t5_', '')][0]}): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_ablation_bench(card: str) -> dict:
    """7j: per ablation a bf16 vqa train step as phase 7 (B 500; T5-base
    B 300 as phase 7c), timed over 3 steps after 1, beside VL-PET-large's
    own on both backbones; the track_z recipe again at lambda_z 0; then
    the beam-5 caption eval (B 500 to length 40, as phase 5) of families
    4, 6, 8 and 9. Under the decoder FFN's IA3 the decoder's FFN takes the
    plain chain, as in the JAX package: the ia3 step launches F1 and F2 at
    the 6 encoder sites only, half VL-PET-large's. Prints a table of
    ms/step, peak GiB and examples/s."""
    launched = {}
    runs = [(n, ablation_cfg(n), f"abl_{n}",
             ABLATIONS[n][1].get("lambda_z", 0.0))
            for n in ("vlpet_large",) + ABL_BART]
    runs.append(("track_z lambda_z 0", ablation_cfg("track_z"),
                 "abl_track_z_lambda0", 0.0))
    runs += [(n, ablation_cfg(n), f"abl_{n}", 0.0)
             for n in ("t5_vlpet_large", "t5_lowrank_visual_projector")]
    for label, cfg_fn, path, lambda_z in runs:
        t5 = path in ABL_T5_TRAIN
        launched[path] = train_bench(
            card, cfg_fn, make_t5_train_batch if t5 else make_train_batch,
            300 if t5 else 500, 35 if t5 else 31, FLAGSHIP_TASKS, "vqa",
            T5_LR if t5 else 1e-3, path, f"{label} vqa", warm=1, timed=3,
            lambda_z=lambda_z)
    for k in ("fused_ffn", "fused_ffn_bwd"):
        ia3, base = launched["abl_ia3"][k], launched["abl_vlpet_large"][k]
        if 2 * ia3 != base:
            raise AssertionError(f"ia3: {k} launched {ia3} times, "
                                 f"VL-PET-large {base}: expected half")
    ctx = PetContext(task="caption", task_idx=3)
    for name in ABL_EVAL_NAMES:
        model = build_model("bfloat16", ablation_cfg(name))
        path = f"abl_{name}_eval"
        launched[path] = generate_bench(
            card, model, make_batch(500, model.cfg.backbone.vocab_size,
                                    seed=11), ctx, 40, path,
            f"{name} beam5 len40")
        del model
    print(f"  phase 7j on {card}: path, ms/step, peak GiB, examples/s",
          flush=True)
    for path in launched:
        r = RUNS[path]
        ms = f"{r['ms_step']:.2f}" if "ms_step" in r else "-"
        print(f"    {path}: {ms} ms/step, {r['peak_gib']:.2f} GiB, "
              f"{r['ex_s']:.2f} ex/s", flush=True)
    return launched


# phases 6k and 7k: the remaining PET flags, each family a recipe at the
# dims of the earlier phases (BART-base 6+6, T5-base 12+12, 36 boxes of
# 2048-d features, the prompt lengths of single_prompt.sh: 40, mid_dim
# 800). family -> (the recipe its flags go onto: VL-PET-large or a
# scripts/image-text/*.sh recipe through pet_cfg, the flags over it).
# No T5 script sets the baselines' flags: the T5 families put each BART
# script's PET config on T5-base, as tests/test_pet_variants.py's recipes.
_DEC_PROMPT = dict(encoder_prompt_len=0, decoder_prompt_len=40)
PET_FLAGS = {
    # 1: prefix tuning, encoder and decoder prefixes of 40
    "prefix": ("single_prompt", dict(use_attn_prefix=True,
                                     decoder_prompt_len=40)),
    # 2: the visual features as each encoder layer's K/V prefix
    "vis_prefix": ("vlpet_large", dict(use_vis_prefix=True)),
    # 3: the decoder input prompt, on BART-base and T5-base
    "decoder_prompt": ("single_prompt", _DEC_PROMPT),
    "t5_decoder_prompt": ("single_prompt", _DEC_PROMPT),
    # 4: the LM-head adapter, with use_fused_ce asked for (the dense
    # route must serve it: no C1 / C2)
    "lm_head_adapter": ("vlpet_large", dict(use_lm_head_adapter=True,
                                            use_fused_ce=True)),
    # 5: the PET baselines on T5-base
    "t5_single_adapter": ("single_adapter", {}),
    "t5_single_compacter": ("single_compacter", {}),
    "t5_hyperformer": ("hyperformer", {}),
    "t5_single_prompt": ("single_prompt", {}),
    "t5_single_lora": ("single_lora", {}),
    "t5_single_lradapter": ("single_lradapter", {}),
}
# the families whose A6 runs over S 96 (the 40 prefix or prompt slots
# before the 56 joint tokens): the wide tensor-core kernel, past one
# 64-row tile
PF_A6_WIDE = ("prefix", "t5_single_prompt")


def _with_any(cfg, flags: dict):
    """``cfg`` with each flag set on its PetConfig, VisConfig or the
    VLModelConfig itself."""
    pet = {k: v for k, v in flags.items() if hasattr(cfg.pet, k)}
    vis = {k: v for k, v in flags.items()
           if k not in pet and hasattr(cfg.vis, k)}
    top = {k: v for k, v in flags.items() if k not in pet and k not in vis}
    return dataclasses.replace(cfg, pet=dataclasses.replace(cfg.pet, **pet),
                               vis=dataclasses.replace(cfg.vis, **vis), **top)


def pf_cfg(name: str, layers=None):
    """The configuration function of a ``PET_FLAGS`` family (or of
    VL-PET-large, "vlpet_large" / "t5_vlpet_large"), with ``layers``
    encoder and decoder layers each where given."""
    t5 = name.startswith("t5_")
    recipe, flags = PET_FLAGS.get(name, ("vlpet_large", {}))

    def cfg(dtype: str = "float32"):
        base = t5_cfg(dtype) if t5 else flagship_cfg(dtype)
        if recipe != "vlpet_large":
            base = dataclasses.replace(base, pet=pet_cfg(recipe)(dtype).pet)
        c = _with_any(base, flags)
        if layers is not None:
            one = (dict(num_layers=layers, num_decoder_layers=layers) if t5
                   else dict(encoder_layers=layers, decoder_layers=layers))
            c = dataclasses.replace(c, backbone=dataclasses.replace(
                c.backbone, **one))
        return c
    return cfg


@torch.no_grad()
def pet_at_init(model) -> None:
    """The recipe's trainable parameters of ``model`` (its PET modules,
    and what the recipe unfreezes) at the seeded init of
    ``build_model``, the rest as they are."""
    init = type(model)(model.cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(1234))
    for name, p in apply_freezing(init, init.cfg.pet).items():
        model.get_parameter(name).copy_(p)


def phase_pet_flag_parity(rep: Report) -> None:
    """6k: A1 and A6 alone at the sites the prefixes make -- the decoder's
    causal self-attention over the 40 prefix keys (L 10 over S 50, the
    triangle at offset S - L) and the encoder's over them (L 56 over S
    96) -- fp32 at B 8 and bf16 at B 500, against the plain twin and its
    autograd (phase 3b's tolerances, bf16 twice bitwise equal). Then per
    ``PET_FLAGS`` family at ``ABL_PARITY_LAYERS`` (6j's depth, encoder and
    decoder layers each), from the weights after ``unzero``: phase 6c's
    fp32 per-step train parity (B 8, vqa, dropout 0.1, 3 steps, each from
    the plain state, kernels vs plain) under phase 6's elementwise
    tolerances (T5 by 6c's update ratio), then phase 4 (b)'s beam-5 and
    greedy caption tokens at B 8 to length 40, kernels vs plain,
    identical: 1+1 layers at std 0.2, where every decode runs all 39 steps
    over the prefilled cache (at the init a BART greedy decode ends at its
    first step, and at T5's 2+2 init every beam repeats one token); on T5
    the recipe's trainable parameters stay at their init (``pet_at_init``:
    with the serial adapter's too at std 0.2, kernels and plain summed in
    two orders turned a near tie of two beams at step 34)."""
    g = torch.Generator(device="cuda").manual_seed(16)
    for dtype, B in ((torch.float32, 8), (torch.bfloat16, 500)):
        attention_site(rep, g, dtype, "dec-self", B, 10, 50, True, True,
                       what="prefix")
        attention_site(rep, g, dtype, "enc", B, 56, 96, False, True,
                       what="prefix")
    ctx = PetContext(task="caption", task_idx=3)
    for name in PET_FLAGS:
        t0 = time.perf_counter()
        t5 = name.startswith("t5_")
        cfg_fn = pf_cfg(name, ABL_PARITY_LAYERS)
        train_parity_per_step(
            f"{name} B8 vqa", cfg_fn,
            make_t5_train_batch if t5 else make_train_batch, 8, 21,
            FLAGSHIP_TASKS, "vqa", T5_LR if t5 else 1e-3, f"pf_{name}",
            elementwise=not t5)
        model = spread_model(pf_cfg(name))
        if t5:
            pet_at_init(model)
        parity_run(f"{name} 1+1 layers, std 0.2"
                   + (", PET at its init" if t5 else ""), model,
                   make_batch(8, model.cfg.backbone.vocab_size, seed=7,
                              pad=0 if t5 else 1), ctx, 40,
                   min_distinct=MIN_DISTINCT_PER_ROW)
        del model
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_pet_flag_bench(card: str) -> dict:
    """7k: per ``PET_FLAGS`` family a bf16 vqa train step as phase 7 (B
    500; T5-base B 300 as phase 7c), timed over 3 steps after 1, beside
    VL-PET-large's on both backbones; then each one's beam-5 caption eval
    (B 500, T5 B 300, to length 40, as phase 5) and VL-PET-large's. Every
    family's A6 launches on "tc", those of ``PF_A6_WIDE`` (S 96) too, and
    their step is held to the plain step (``step_vs_plain``); the
    LM-head
    adapter's step must launch no C1 / C2 under use_fused_ce; the prefix
    eval's D1 and U1 launches a decode step (a step is one T1 launch) must
    equal VL-PET-large's: the P prefilled slots change what D1 reads, not
    how often it runs. Prints a table of ms/step, peak GiB and
    examples/s."""
    launched = {}
    names = ("vlpet_large",) + PF_BART + ("t5_vlpet_large",) + PF_T5
    for name in names:
        t5, path = name.startswith("t5_"), f"pf_{name}"
        launched[path] = train_bench(
            card, pf_cfg(name), make_t5_train_batch if t5 else make_train_batch,
            300 if t5 else 500, 35 if t5 else 31, FLAGSHIP_TASKS, "vqa",
            T5_LR if t5 else 1e-3, path, f"{name} vqa",
            vs_plain=name in PF_A6_WIDE, warm=1, timed=3)
        if name in PF_A6_WIDE and not launched[path].get(
                "fused_attention_bwd[tc]"):
            raise AssertionError(f"{path}: A6 never launched on tc")
    ce = {k: launched["pf_lm_head_adapter"][k]
          for k in ("fused_linear_ce", "fused_linear_ce_bwd")}
    if any(ce.values()):
        raise AssertionError(f"the LM-head adapter's step launched C1 / C2 "
                             f"{ce}: its head is not frozen")
    ctx = PetContext(task="caption", task_idx=3)
    for name in names:
        if name == "t5_vlpet_large":  # phase 5c's eval
            continue
        t5, path = name.startswith("t5_"), f"pf_{name}_eval"
        model = build_model("bfloat16", pf_cfg(name))
        B = 300 if t5 else 500
        launched[path] = generate_bench(
            card, model, make_batch(B, model.cfg.backbone.vocab_size, seed=11,
                                    pad=0 if t5 else 1), ctx, 40, path,
            f"{name} beam5 len40")
        del model

    def per_step(path: str, k: str) -> float:
        return launched[path][k] / launched[path]["topk_lse"]

    for k in ("beam_decode_attend", "cache_slot_update"):
        got, want = (per_step(p, k) for p in ("pf_prefix_eval",
                                              "pf_vlpet_large_eval"))
        if got != want:
            raise AssertionError(f"prefix eval: {k} {got} launches a step, "
                                 f"VL-PET-large {want}")
    print(f"  phase 7k on {card}: path, ms/step, peak GiB, examples/s",
          flush=True)
    for path in launched:
        r = RUNS[path]
        ms = f"{r['ms_step']:.2f}" if "ms_step" in r else "-"
        print(f"    {path}: {ms} ms/step, {r['peak_gib']:.2f} GiB, "
              f"{r['ex_s']:.2f} ex/s", flush=True)
    return launched


# phases 6l, 7l and 8e: the last single-card paths. name -> the flags over
# VL-PET-large (BART-base, or T5-base for the t5_* names; backbone, PET,
# visual or VLModelConfig fields): the classifier answer head over the
# VQA answer vocabulary (TAIL_ANSWERS, VQAv2's topk), BART's attention and
# activation dropout, per-layer remat, vis.sparse_sample
TAIL_ANSWERS = 3129
TAIL = {
    "vlpet_large": {},
    "cls": dict(classifier=True, num_answers=TAIL_ANSWERS),
    "drop": dict(attention_dropout=0.1, activation_dropout=0.1),
    "remat_full": dict(remat="full"),
    "remat_dots": dict(remat="dots"),
    "sparse": dict(sparse_sample=True),
    "t5_vlpet_large": {},
    "t5_cls": dict(classifier=True, num_answers=TAIL_ANSWERS),
}
# 6l's sparse_sample step: a 7 x 7 grid of features, subsampled to the
# configuration's 36 boxes
SPARSE_TOKENS = 49
# 8e: synthetic vqa examples (two B 500 steps an epoch)
CLS_CLI_EXAMPLES = 1000


def tail_cfg(name: str, layers=None, video: bool = False, **extra):
    """The configuration function of a ``TAIL`` entry (and ``extra`` flags
    over it) on VL-PET-large: BART-base (video_cfg's with ``video``) or
    T5-base, with ``layers`` encoder and decoder layers each where
    given."""
    t5 = name.startswith("t5_")
    flags = {**TAIL[name], **extra}

    def cfg(dtype: str = "float32"):
        base = (t5_cfg if t5 else video_cfg if video else flagship_cfg)(dtype)
        bk = {k: v for k, v in flags.items() if hasattr(base.backbone, k)}
        if layers is not None:
            bk.update(dict(num_layers=layers, num_decoder_layers=layers) if t5
                      else dict(encoder_layers=layers, decoder_layers=layers))
        c = dataclasses.replace(base, backbone=dataclasses.replace(
            base.backbone, **bk))
        return _with_any(c, {k: v for k, v in flags.items()
                             if not hasattr(base.backbone, k)})
    return cfg


def add_answer_scores(batch, B: int, seed: int):
    """The classifier's target: VQA soft scores over TAIL_ANSWERS answers,
    1.0 and 0.3 at two seeded answers a row."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    idx = torch.randint(0, TAIL_ANSWERS, (B, 2), generator=g, device="cuda")
    target = torch.zeros((B, TAIL_ANSWERS), device="cuda")
    target.scatter_(1, idx[:, 1:], 0.3)
    target.scatter_(1, idx[:, :1], 1.0)
    batch["target"] = target
    return batch


def make_cls_batch(B: int, vocab: int, seed: int):
    return add_answer_scores(make_train_batch(B, vocab, seed), B, seed)


def make_t5_cls_batch(B: int, vocab: int, seed: int):
    return add_answer_scores(make_t5_train_batch(B, vocab, seed), B, seed)


def make_sparse_batch(B: int, vocab: int, seed: int):
    """The train batch with SPARSE_TOKENS visual tokens a row."""
    batch = make_train_batch(B, vocab, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    batch["vis_feats"] = torch.randn((B, SPARSE_TOKENS, 2048), generator=g,
                                     device="cuda")
    batch["boxes"] = torch.rand((B, SPARSE_TOKENS, 4), generator=g,
                                device="cuda")
    return batch


def tail_dropout_sites(rep: Report) -> None:
    """The kernels' dropout modes at BART's sites, rate 0.1, one seed:
    A1 and A6 (bf16 B 500 and fp32 B 8) at the encoder's S 56 (ragged
    padding), the causal decoder L = S 10, the cross L 10 over S 56 and
    the classify decoder's one token over S 56 and over itself; A1 with
    its row logsumexp and the long backward at the video encoder (bf16 B
    50, L = S 604); F1 / F2 gelu with both biases at the encoder's and the
    decoder's rows (bf16 N 28000 and 5000). Each against its plain twin
    (the backwards against autograd of it) within phase 3b's tolerances,
    bf16 twice bitwise equal, with the route, the bound and, where one
    computes the same function (rate 0 only: none here), the library
    call."""
    g = torch.Generator(device="cuda").manual_seed(22)
    randn = randn_fn(g)
    H, Dh, D, Fh = 12, 64, 768, 3072
    inner, rate = H * Dh, 0.1
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    for dtype, B in ((torch.bfloat16, 500), (torch.float32, 8)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main, e = dtype == torch.bfloat16, (2 if dtype == torch.bfloat16
                                            else 4)
        enc = padding_mask(g, B, 56)
        zero = torch.zeros((1, 1, 1, 1), device="cuda")
        for site, L, S, causal, mask in (
                ("enc", 56, 56, False, enc),
                ("dec-self", 10, 10, True, zero.expand(1, 1, 1, 10)),
                ("cross", 10, 56, False, enc),
                ("classify cross", 1, 56, False, enc),
                ("classify self", 1, 1, True, zero)):
            mask = mask.contiguous()
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            k, v = (randn(B, S, inner, dtype=dtype) for _ in range(2))
            do = randn(B, L, inner, dtype=dtype)
            seen = (attention._causal_allowed(L, S, "cuda").float().mean()
                    .item() if causal else 1.0)
            label = (f"{tag} {site} B{B} L{L} S{S}"
                     + (" causal" if causal else "") + f" rate {rate}")
            timed = main and site == "enc"

            def fwd():
                return attention.fused_attention(q, k, v, mask, H, causal,
                                                  None, rate, seed)
            rep.check("fused_attention +dropout", label, fwd,
                      lambda: attention.fused_attention_reference(
                          q, k, v, mask, H, causal, None, rate, seed),
                      dtype, timed=timed,
                      work=(e * 2 * B * (L + S) * inner + 4 * B * S,
                            4 * B * H * L * S * Dh * seen))

            def bwd():
                return attention.fused_attention_bwd(q, k, v, mask, do, H,
                                                     causal, None, rate, seed)
            rep.check("fused_attention_bwd +dropout", label, bwd,
                      _grads_of(lambda a, b, c:
                                attention.fused_attention_reference(
                                    a, b, c, mask, H, causal, None, rate,
                                    seed), (q, k, v), do),
                      dtype, timed=timed, backward=True,
                      work=(e * (3 * B * L + 4 * B * S) * inner + 4 * B * S,
                            10 * B * H * L * S * Dh * seen))
            if main:
                bitwise_repeat("fused_attention +dropout", label, fwd)
                bitwise_repeat("fused_attention_bwd +dropout", label, bwd)
    # the long backward at the video encoder
    B, L = VIDEO_B, 604
    dtype = torch.bfloat16
    mask = padding_mask(g, B, L)
    q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
    k, v, do = (randn(B, L, inner, dtype=dtype) for _ in range(3))
    label = f"bf16 video enc B{B} L{L} S{L} rate {rate}"
    rep.check("fused_attention +dropout", label + " +lse",
              lambda: attention.fused_attention_fwd_lse(
                  q, k, v, mask, H, False, None, rate, seed),
              lambda: attention.fused_attention_lse_reference(
                  q, k, v, mask, H, False, None, rate, seed), dtype,
              work=(2 * 2 * B * 2 * L * inner + 4 * B * L + 4 * B * H * L,
                    4 * B * H * L * L * Dh))
    out, lse = attention.fused_attention_fwd_lse(q, k, v, mask, H, False,
                                                 None, rate, seed)

    def long_bwd():
        return attention.fused_attention_bwd_long(q, k, v, mask, out, lse, do,
                                                  H, False, None, rate, seed)
    rep.check("fused_attention_bwd_long +dropout", label, long_bwd,
              _grads_of(lambda a, b, c: attention.fused_attention_reference(
                  a, b, c, mask, H, False, None, rate, seed), (q, k, v), do),
              dtype, timed=True, backward=True,
              work=(2 * (3 * B * L + 4 * B * L) * inner + 4 * B * L
                    + 2 * B * L * inner + 4 * B * H * L,
                    10 * B * H * L * L * Dh))
    bitwise_repeat("fused_attention_bwd_long +dropout", label, long_bwd)
    del q, k, v, do, out, lse
    # F1 / F2 gelu with hidden dropout
    w1, w2 = randn(Fh, D, dtype=dtype, scale=0.02), randn(D, Fh, dtype=dtype,
                                                          scale=0.02)
    b1, b2 = randn(Fh, scale=0.02), randn(D, scale=0.02)
    for N in (500 * 56, 500 * 10):
        x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
        label = f"bf16 N{N} D{D} F{Fh} gelu rate {rate}"
        timed = N == 500 * 56

        def f1():
            return ffn.fused_ffn(x, w1, b1, w2, b2, "gelu", rate, seed)

        def f2():
            return ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu", rate, seed)
        rep.check("fused_ffn gelu +dropout", label, f1,
                  lambda: ffn.ffn_reference(x, w1, b1, w2, b2, "gelu", rate,
                                            seed), dtype, timed=timed,
                  work=(2 * (2 * N * D + 2 * D * Fh) + 4 * (Fh + D),
                        4 * N * D * Fh))
        rep.check("fused_ffn_bwd gelu +dropout", label, f2,
                  _grads_of(lambda a, c, d: ffn.ffn_reference(
                      a, w1, c, w2, d, "gelu", rate, seed), (x, b1, b2), dy),
                  dtype, timed=timed, backward=True,
                  work=(2 * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                        6 * N * D * Fh))
        bitwise_repeat("fused_ffn gelu +dropout", label, f1)
        bitwise_repeat("fused_ffn_bwd gelu +dropout", label, f2)
        del x, dy


@torch.no_grad()
def classify_parity(label: str, cfg_fn, batch_fn, B: int) -> None:
    """predict_classifier's answers (the argmax over the answer head's
    logits, ``classify``) through the kernels and the plain twins, fp32,
    from the weights after ``unzero``: identical; the logits within phase
    6's tolerance."""
    model = build_model("float32", cfg_fn)
    unzero(model)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, 29)
    ctx = PetContext(task="vqa", task_idx=0)

    def run():
        return model.classify(batch["input_ids"], batch["attention_mask"],
                              batch["vis_feats"], batch["boxes"], ctx=ctx)
    got = run()
    with plain_twins():
        want = run()
    err = compare(f"{label} answer logits", got, want, torch.float32, True)
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError(f"{label}: predict_classifier's answers differ, "
                             f"kernels vs plain")
    print(f"  fp32 {label} B{B}: predict_classifier answers identical kernels "
          f"vs plain ({TAIL_ANSWERS} answers), logits max|err| {err:.3e}",
          flush=True)
    del model


def remat_parity() -> None:
    """fp32 BART-base VL-PET-large at dropout, attention and activation
    dropout 0.1, B 8 vqa, from the weights after ``unzero``: the loss and
    the gradient of every trainable tensor of one training pass through the
    kernels under remat "full" and "dots" against "none", with the same
    seeds. The replay takes the layer's seeds of the first run and the
    kernels are deterministic, so the expected difference is 0; checked
    within phase 6's tolerances, the largest printed. The launches of each
    pass: under remat the forward kernels run again in the backward."""
    ref = None
    for mode in ("none", "full", "dots"):
        model = build_model("float32", tail_cfg(
            "vlpet_large", remat=mode, attention_dropout=0.1,
            activation_dropout=0.1))
        unzero(model)
        trainable = apply_freezing(model, model.cfg.pet)
        batch = make_train_batch(8, model.cfg.backbone.vocab_size, 21)
        reset_counts()
        out = model(batch["input_ids"], batch["attention_mask"],
                    batch["vis_feats"], batch["boxes"],
                    labels=batch["target_ids"], ctx=PetContext(task="vqa"),
                    deterministic=False,
                    generator=torch.Generator(device="cuda").manual_seed(5))
        loss = task_loss("vqa", out["loss"], batch["target_ids"],
                         batch["scores"])
        grads = torch.autograd.grad(loss, list(trainable.values()))
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_counts("remat").items() if n}
        got = (loss.detach(), [g.detach() for g in grads])
        if ref is None:
            ref, line = got, "reference"
        else:
            dl = abs(got[0].item() - ref[0].item())
            if not dl <= TRAIN_METRIC_RTOL * abs(ref[0].item()):
                raise AssertionError(f"remat {mode}: loss {got[0].item()} vs "
                                     f"{ref[0].item()}")
            dg = max(compare(f"remat {mode} grad", a, b, torch.float32,
                             True) for a, b in zip(got[1], ref[1]))
            line = (f"|loss - none's| {dl:.3e}, largest |grad - none's| "
                    f"{dg:.3e} over {len(grads)} tensors")
        print(f"  fp32 remat {mode} B8 vqa dropouts 0.1: loss "
              f"{got[0].item():.6f}; {line}; launches {launched}",
              flush=True)
        del model, trainable, out, loss, grads


def bart_heads_parity() -> None:
    """A forward and backward of each models/bart_heads.py class at
    BART-base width (6+6 layers, text only, dropout 0.1, fp32, B 8, 20
    tokens ending in <eos>, an earlier <eos> in row 0), the head and the
    backbone's LayerNorms trainable (the FFN kernels take no weight
    gradient): the loss and every gradient through the kernels against the
    plain twins with the same seeds, within phase 6's tolerances."""
    base = flagship_cfg("float32")
    cfg = dataclasses.replace(base, pet=PetConfig(),
                              vis=dataclasses.replace(base.vis, no_vis=True))
    g = torch.Generator(device="cuda").manual_seed(31)
    B, T, eos = 8, 20, cfg.backbone.eos_token_id
    ids = torch.randint(3, cfg.backbone.vocab_size, (B, T), generator=g,
                        device="cuda")
    ids[:, -1] = eos
    ids[0, 8] = eos
    mask = torch.ones_like(ids)
    for cls, kw in ((BartForSequenceClassification,
                     dict(labels=torch.randint(0, 3, (B,), generator=g,
                                               device="cuda"))),
                    (BartForQuestionAnswering,
                     dict(start_positions=torch.randint(
                         0, T, (B,), generator=g, device="cuda"),
                          end_positions=torch.randint(
                              0, T, (B,), generator=g, device="cuda")))):
        model = cls(cfg, device="cuda").init_weights(
            torch.Generator(device="cuda").manual_seed(7))
        apply_freezing(model, PetConfig(unfreeze_layer_norms=True))
        head = (model.classification_head if "classification_head"
                in model._modules else model.qa_outputs)
        head.requires_grad_(True)
        params = [p for p in model.parameters() if p.requires_grad]

        def run():
            out = model(ids, mask, deterministic=False, generator=torch.
                        Generator(device="cuda").manual_seed(3), **kw)
            return (out["loss"],) + torch.autograd.grad(out["loss"], params)
        reset_counts()
        got = run()
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_counts("bart_heads").items() if n}
        with plain_twins():
            want = run()
        dl = abs(got[0].item() - want[0].item())
        if not dl <= TRAIN_METRIC_RTOL * abs(want[0].item()):
            raise AssertionError(f"{cls.__name__}: loss {got[0].item()} vs "
                                 f"{want[0].item()}")
        dg = max(compare(f"{cls.__name__} grad", a, b, torch.float32, True)
                 for a, b in zip(got[1:], want[1:]))
        print(f"  fp32 {cls.__name__} B{B} T{T} dropout 0.1: loss kernel "
              f"{got[0].item():.6f} / plain {want[0].item():.6f}; "
              f"{len(params)} gradients, largest |err| {dg:.3e}; launches "
              f"{launched}", flush=True)
        del model, got, want


def phase_tail_parity(rep: Report) -> dict:
    """6l: the last single-card paths through the kernels against the
    plain twins, fp32 (module docstring). Returns the launches of the
    TAIL_VIDEO_DROP run."""
    t0 = time.perf_counter()
    tail_dropout_sites(rep)
    print(f"  the dropout sites: {time.perf_counter() - t0:.1f} s",
          flush=True)
    launched = {}
    for label, name, layers, batch_fn, lr in (
            ("classifier", "cls", None, make_cls_batch, 1e-3),
            ("t5 classifier", "t5_cls", ABL_PARITY_LAYERS, make_t5_cls_batch,
             T5_LR)):
        t5 = name.startswith("t5_")
        train_parity_per_step(f"{label} B8 vqa", tail_cfg(name, layers),
                              batch_fn, 8, 21, FLAGSHIP_TASKS, "vqa", lr,
                              f"tail_{name}_parity", elementwise=not t5)
        classify_parity(label, tail_cfg(name, layers), batch_fn, 8)
    train_parity_per_step("attention + activation dropout 0.1 B8 vqa",
                          tail_cfg("drop"), make_train_batch, 8, 21,
                          FLAGSHIP_TASKS, "vqa", 1e-3, "tail_drop_parity",
                          elementwise=True)
    launched[TAIL_VIDEO_DROP] = train_parity_per_step(
        "attention + activation dropout 0.1 video B2 S604 tvqa",
        tail_cfg("drop", video=True), make_video_train_batch, 2, 23,
        VIDEO_TASKS, "tvqa", 7e-4, TAIL_VIDEO_DROP, elementwise=True,
        n_steps=1)
    remat_parity()
    train_parity_per_step(f"sparse_sample {SPARSE_TOKENS} -> 36 tokens B8 "
                          f"vqa", tail_cfg("sparse"), make_sparse_batch, 8,
                          21, FLAGSHIP_TASKS, "vqa", 1e-3,
                          "tail_sparse_parity", elementwise=True, n_steps=1)
    bart_heads_parity()
    return launched


def phase_tail_bench(card: str) -> dict:
    """7l: bf16 vqa steps (B 500, T5-base B 300; 3 timed after 1): the
    classifier beside VL-PET-large's LM step on both backbones,
    VL-PET-large at attention and activation dropout 0.1, and under remat
    "full" and "dots". Prints a table of ms/step, examples/s, peak GiB and
    the launches a step of A1, A6, F1, F2, L1 and L2; under remat the
    forward kernels run again in the backward, so their launches a step
    double."""
    launched = {}
    runs = (("vlpet_large", make_train_batch), ("cls", make_cls_batch),
            ("drop", make_train_batch), ("remat_full", make_train_batch),
            ("remat_dots", make_train_batch),
            ("t5_vlpet_large", make_t5_train_batch),
            ("t5_cls", make_t5_cls_batch))
    for name, batch_fn in runs:
        t5, path = name.startswith("t5_"), f"tail_{name}"
        launched[path] = train_bench(
            card, tail_cfg(name), batch_fn, 300 if t5 else 500,
            35 if t5 else 31, FLAGSHIP_TASKS, "vqa", T5_LR if t5 else 1e-3,
            path, f"{name} vqa", warm=1, timed=3)
    print(f"  phase 7l on {card}: path, ms/step, examples/s, peak GiB; "
          f"launches a step of A1, A6, F1, F2, L1, L2 (under remat the "
          f"forward kernels launch twice a step: once more in the "
          f"recompute)", flush=True)
    keys = ("fused_attention", "fused_attention_bwd", "fused_ffn",
            "fused_ffn_bwd", "fused_dropout_add_ln",
            "fused_dropout_add_ln_bwd")
    for path, n in launched.items():
        r = RUNS[path]
        per = ", ".join(f"{n.get(k, 0) / 3:g}" for k in keys)
        print(f"    {path}: {r['ms_step']:.2f} ms/step, {r['ex_s']:.2f} ex/s, "
              f"{r['peak_gib']:.2f} GiB; {per}", flush=True)
    return launched


def phase_cli_classifier(card: str) -> dict:
    """8e: ``python -m vlpet_tpu_torch.cli.multitask`` with the flags of
    scripts/image-text/VL-PET-large.sh (r 96, 4 heads, gate 96, VPA 96,
    lr 1e-3, seed 9595; synthetic features at the pooled 36 boxes, so
    ``--downsample`` is left out) plus --classifier --bf16 on vqa: B 500,
    CLS_CLI_EXAMPLES synthetic examples, one epoch, the predict_classifier
    eval; then a second process with ``--resume`` restores the saved state
    (its digest equal, bit for bit) and, nothing being left to train,
    saves it again unchanged. Every kernel of the path must launch (the
    cli_classifier run)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "run")
        flags = script_flags(
            os.path.join(os.path.dirname(CLI_SCRIPT), "VL-PET-large.sh"),
            ["0", "96", "4", "96", "96", "1e-3", "9595"])
        flags = [f for f in flags if f != "--downsample"] + [
            "--classifier", "--bf16", "--tasks", "vqa", "--synthetic_examples",
            str(CLS_CLI_EXAMPLES), "--output", out_dir, "--device", "cuda",
            "--epochs", "1"]
        out1, res1 = run_cli(flags, "classifier train")
        require_launched(CLI_CLS, res1["launches"])
        saved_step, saved = _digest(out1, r"saved at step (\d+); state "
                                          r"digest ([0-9a-f]+)")
        recs, epochs = _epochs_of(out_dir, ("vqa",))
        out2, res2 = run_cli(flags + ["--resume"], "classifier resume")
        step2, restore_s, restored = _digest(
            out2, r"resumed from step (\d+) in ([0-9.]+) s; state digest "
                  r"([0-9a-f]+)")
        end_step, end = _digest(out2, r"saved at step (\d+); state digest "
                                      r"([0-9a-f]+)")
    if (step2, restored, end_step, end) != (saved_step, saved, saved_step,
                                            saved):
        raise AssertionError(f"resume: step {step2} digest {restored}, saved "
                             f"again at {end_step} {end}; saved step "
                             f"{saved_step} digest {saved}")
    if len(epochs) != 1:
        raise AssertionError(f"{len(epochs)} epochs")
    r = epochs[0]
    r["data_build_seconds"] = next(x["data_build_seconds"] for x in recs
                                   if "data_build_seconds" in x)
    _print_cli(card, "VL-PET-large --classifier CLI, bf16, B 500, "
                     f"{CLS_CLI_EXAMPLES} vqa examples", r, res1, ("vqa",))
    print(f"  vqa score {r.get('vqa/score')}; resume process "
          f"{res2['process_s']:.2f} s (restore {float(restore_s):.3f} s); "
          f"state at step {saved_step} restored bit for bit (digest "
          f"{saved[:16]})", flush=True)
    return {CLI_CLS: res1["launches"]}


# phase 9: data parallelism on the one card. Every rank is a process that
# vlpet_tpu_torch/parallel/launch.py spawns on cuda:0 and that joins its
# group through the CLIs' own init (multihost.maybe_initialize_distributed
# from torchrun's environment): world 1 over NCCL, world 2 over gloo (NCCL
# refuses two ranks on one card). Two ranks sharing one card time nothing
# about multi-card speed.
DP_TIMEOUT_S = 240  # each spawn's limit
DP_B, DP_FP32_B, DP_EVAL_B = 500, 16, 4  # (a)/(b), (c) global; (d) a rank


def dp_share(batch, rank: int, world: int):
    """The rank's contiguous share of a global batch of tensors."""
    b = batch["input_ids"].shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def params_digest(trainable) -> str:
    """sha256 over the trainable tensors' bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for n in sorted(trainable):
        t = trainable[n].detach().contiguous().cpu()
        h.update(n.encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_bf16_step(rank: int = 0, world: int = 1, model_axis: int = 1,
                 path: str = "train", cfg_fn=flagship_cfg) -> dict:
    """One bf16 vqa step of the full-width model of ``cfg_fn`` (the
    flagship; seeded weights) on the rank's data shard of the B DP_B batch
    (phase 7's inputs) under a (world / ``model_axis``, ``model_axis``)
    mesh: the (global) loss and gradient norm, the digest of the
    trainable tensors after it (gathered whole over the model group) and
    the step's launches (``path``'s kernels each launched)."""
    deterministic_kernels()
    model = build_model("bfloat16", cfg_fn)
    layout = build_mesh(MeshConfig(model=model_axis))
    trainable = apply_freezing(model, model.cfg.pet)
    shard_model(model, layout)
    batch = dp_share(make_train_batch(DP_B, model.cfg.backbone.vocab_size,
                                      31), layout.data_index, layout.data)
    step = make_train_step(model, build_optimizer(trainable, lr=1e-3,
                                                  total_steps=2),
                           FLAGSHIP_TASKS)
    reset_counts()
    out = step(batch, torch.Generator(device="cuda").manual_seed(9),
               FLAGSHIP_TASKS.index("vqa"))
    torch.cuda.synchronize()
    launched = {k: n for k, n in read_counts(path).items() if n}
    return {"loss": out["loss"].item(), "grad_norm": out["grad_norm"].item(),
            "digest": params_digest(gather_state_dict(trainable, model)),
            "launches": launched}


def dp_fp32_cfg(dtype: str):
    """The flagship with every BART dropout at 0.1 (phase 9 (c))."""
    cfg = flagship_cfg(dtype)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dropout=0.1, attention_dropout=0.1,
        activation_dropout=0.1))


def dp_fp32_model(cfg_fn=dp_fp32_cfg, model_axis: int = 1,
                  build=build_model, clip: float = 5.0):
    """The fp32 model of ``cfg_fn`` (built by ``build``, seeded,
    ``unzero``), its trainable tensors, optimizer (clip norm ``clip``) and
    step, placed on this rank's shard of a (world / ``model_axis``,
    ``model_axis``) mesh; and the mesh."""
    model = build("float32", cfg_fn)
    unzero(model)
    layout = build_mesh(MeshConfig(model=model_axis))
    trainable = apply_freezing(model, model.cfg.pet)
    shard_model(model, layout)
    opt = build_optimizer(trainable, lr=1e-3, total_steps=4,
                          clip_grad_norm=clip)
    return (model, trainable, opt,
            make_train_step(model, opt, FLAGSHIP_TASKS), layout)


def dp_fp32_reference(path: str, cfg_fn=dp_fp32_cfg,
                      batch_fn=make_train_batch, steps: int = 3,
                      run: str = "train", build=build_model,
                      clip: float = 5.0, B: int = DP_FP32_B) -> dict:
    """Phase 9 (c)'s one-process run (and phase 10 (b)'s, (c)'s and (h)'s,
    of ``cfg_fn``, ``build`` and ``clip``: ``dp_fp32_model``): ``steps``
    fp32 steps on the B ``B`` batch of ``batch_fn``, each step's start
    (trainable tensors and optimizer state) and end saved to ``path`` for
    the ranks; returns the per-step metrics and the step's launches
    (``run``'s kernels each launched)."""
    model, trainable, opt, step, _ = dp_fp32_model(cfg_fn, build=build,
                                                   clip=clip)
    batch = batch_fn(B, model.cfg.backbone.vocab_size, 21)
    starts, ends, metrics = [], [], []
    reset_counts()
    for i in range(steps):
        starts.append({"params": {n: t.cpu() for n, t in
                                  snapshot(trainable).items()},
                       "opt": {k: ({n: t.detach().to("cpu", copy=True)
                                    for n, t in v.items()}
                                   if isinstance(v, dict) else v)
                               for k, v in opt.state_dict().items()}})
        out = step(batch, torch.Generator(device="cuda").manual_seed(21 + i),
                   FLAGSHIP_TASKS.index("vqa"))
        metrics.append({"loss": out["loss"].item(),
                        "grad_norm": out["grad_norm"].item()})
        ends.append({n: t.cpu() for n, t in snapshot(trainable).items()})
    launched = {k: n // steps for k, n in read_counts(run).items() if n}
    torch.save({"starts": starts, "ends": ends}, path)
    return {"metrics": metrics, "launches": launched}


def zero_grad(name: str) -> bool:
    """A trainable whose true gradient is zero: a bias added to every key
    -- k_proj's (LoRA, BitFit and full fine-tuning train it), the key
    parallel adapter's up projection's -- adds one constant to each
    query's logits, and softmax ignores it."""
    return name.endswith(("k_proj.bias",
                          "attn_key_parallel_adapter.adapters.up_sampler.bias"))


def dp_fp32_steps(rank: int, world: int, path: str, cfg_fn=dp_fp32_cfg,
                  batch_fn=make_train_batch, model_axis: int = 1,
                  run: str = "train", build=build_model, clip: float = 5.0,
                  B: int = DP_FP32_B) -> dict:
    """Phase 9 (c) on a rank (and phase 10 (b), (c) and (h), of
    ``cfg_fn``, ``build`` and ``clip`` under a model axis): each step from
    the one-process run's start (the split trainables' and their
    optimizer state's shards cut from it), on the rank's data shard of
    its batch with the same dropout seeds (folded to the shard's examples
    and the rank's heads and hidden columns); per step the metrics and
    the largest L2 ratio |update - one-process update| / |one-process
    update| over the trainable tensors, gathered whole, but those of
    ``zero_grad``, held by phase 6's elementwise rule (inf where one
    fails it)."""
    ref = torch.load(path, map_location="cuda", weights_only=False)
    model, trainable, opt, step, layout = dp_fp32_model(cfg_fn, model_axis,
                                                        build, clip)
    batch = dp_share(batch_fn(B, model.cfg.backbone.vocab_size, 21),
                     layout.data_index, layout.data)
    rows = []
    for i, (start, end) in enumerate(zip(ref["starts"], ref["ends"])):
        restore(trainable, shard_state_dict(start["params"], model))
        state = dict(start["opt"])
        state.update({k: shard_state_dict(state[k], model)
                      for k in ("mu", "nu", "master")})
        opt.load_state_dict(state)
        reset_counts()
        out = step(batch, torch.Generator(device="cuda").manual_seed(21 + i),
                   FLAGSHIP_TASKS.index("vqa"))
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_counts(run).items() if n}
        whole = gather_state_dict({n: p.detach() for n, p in
                                   trainable.items()}, model)
        ratio = max([(p - end[n]).norm().item()
                     / max((end[n] - start["params"][n]).norm().item(), 1e-30)
                     for n, p in whole.items() if not zero_grad(n)],
                    default=0.0)
        noise = 0.0  # the zero_grad tensors' largest |diff| / tolerance
        for n, p in whole.items():
            # a tensor whose true gradient is zero: Adam's update is its
            # rounding noise scaled up; phase 6's elementwise rule
            if zero_grad(n):
                tol = (PARAM_RTOL * end[n].abs()
                       + PARAM_ATOL_SCALE * end[n].abs().max())
                noise = max(noise, ((p - end[n]).abs() / tol).max().item())
        if noise > 1.0:
            ratio = float("inf")
        rows.append({"loss": out["loss"].item(),
                     "grad_norm": out["grad_norm"].item(), "ratio": ratio,
                     "noise": noise, "launches": launched})
    return rows


def dp_eval_rank(rank: int, world: int) -> list:
    """Phase 9 (d) on a rank: fp32 beam 5 to length 20 on its DP_EVAL_B
    rows of phase 4 (a)'s batch, the ranks' tokens merged in rank
    order."""
    from vlpet_tpu_torch.parallel.multihost import all_gather_objects

    model = build_model("float32")
    batch = dp_share(make_batch(DP_EVAL_B * world,
                                model.cfg.backbone.vocab_size, seed=7),
                     rank, world)
    with torch.inference_mode():
        toks = seq2seq_generate(model, **batch,
                                ctx=PetContext(task="caption", task_idx=3),
                                num_beams=5, max_length=20)
    return torch.cat(all_gather_objects(toks.cpu()))


def dp_world2(rank: int, world: int, path: str) -> dict:
    """Phase 9 (b), (c) and (d) on one rank of world 2."""
    out = {"bf16": dp_bf16_step(rank, world)}
    torch.cuda.empty_cache()
    out["fp32"] = dp_fp32_steps(rank, world, path)
    torch.cuda.empty_cache()
    out["tokens"] = dp_eval_rank(rank, world)
    print(f"  rank {rank}/{world}: bf16 step launches "
          f"{out['bf16']['launches']}; fp32 per-step launches "
          f"{[r['launches'] for r in out['fp32']]}", flush=True)
    return out


def dp_start(tmp: str, pool) -> dict:
    """Phase 9's one-process runs, then its two worlds submitted to
    ``pool`` (their ranks share the card; phase 9 times nothing)."""
    from vlpet_tpu_torch.parallel.launch import run_ranks

    dp = {"t0": time.perf_counter(), "want": dp_bf16_step(),
          "path": os.path.join(tmp, "fp32_steps.pt")}
    dp["fp32"] = dp_fp32_reference(dp["path"])
    model = build_model("float32")
    with torch.inference_mode():
        dp["tokens"] = seq2seq_generate(
            model, **make_batch(DP_EVAL_B * 2, model.cfg.backbone.vocab_size,
                                seed=7),
            ctx=PetContext(task="caption", task_idx=3), num_beams=5,
            max_length=20).cpu()
    del model
    torch.cuda.empty_cache()
    dp["t1"] = time.perf_counter()
    dp["world1"] = pool.submit(run_ranks, dp_bf16_step, 1, device="cuda",
                               timeout=DP_TIMEOUT_S)
    dp["world2"] = pool.submit(run_ranks, dp_world2, 2, dp["path"],
                               device="cuda", backend="gloo",
                               timeout=DP_TIMEOUT_S)
    return dp


def dp_finish(dp: dict, card: str) -> None:
    """Phase 9's checks on its worlds' results (``dp_start``)."""
    (one,) = dp["world1"].result()
    two = dp["world2"].result()
    t2 = time.perf_counter()
    want, fp32, tokens = dp["want"], dp["fp32"], dp["tokens"]
    if (one["loss"], one["grad_norm"], one["digest"]) != (
            want["loss"], want["grad_norm"], want["digest"]):
        raise AssertionError(f"(a) world 1 over NCCL: loss {one['loss']!r} "
                             f"vs {want['loss']!r}, grad norm "
                             f"{one['grad_norm']!r} vs {want['grad_norm']!r}, "
                             f"digests {one['digest'][:12]} vs "
                             f"{want['digest'][:12]}")
    for name, got in [("(a) world 1", one["launches"])] + [
            (f"(b) rank {r}", res["bf16"]["launches"])
            for r, res in enumerate(two)]:
        if got != want["launches"]:
            raise AssertionError(f"{name}: launches {got}, one process "
                                 f"{want['launches']}")
    print(f"  (a) world 1 over NCCL (torchrun-style env): bf16 B{DP_B} vqa "
          f"step bit for bit the one-process step: loss {one['loss']:.6f}, "
          f"grad norm {one['grad_norm']:.6f}, digest {one['digest'][:12]}; "
          f"launches {one['launches']}", flush=True)
    for r, res in enumerate(two):
        b = res["bf16"]
        rel = abs(b["loss"] - one["loss"]) / abs(one["loss"])
        if not rel <= BF16_STEP_RTOL:
            raise AssertionError(f"(b) rank {r}: loss {b['loss']!r} vs (a) "
                                 f"{one['loss']!r}: {rel:.3e} relative")
        for i, (row, ref) in enumerate(zip(res["fp32"], fp32["metrics"])):
            for key in ("loss", "grad_norm"):
                if not abs(row[key] - ref[key]) <= (TRAIN_METRIC_RTOL
                                                    * abs(ref[key])):
                    raise AssertionError(f"(c) rank {r} step {i} {key}: "
                                         f"{row[key]!r} vs one process "
                                         f"{ref[key]!r}")
            if not row["ratio"] <= PARAM_RTOL:
                raise AssertionError(f"(c) rank {r} step {i}: update ratio "
                                     f"{row['ratio']:.3e} > {PARAM_RTOL}")
            if row["launches"] != fp32["launches"]:
                raise AssertionError(f"(c) rank {r} step {i}: launches "
                                     f"{row['launches']}, one process "
                                     f"{fp32['launches']}")
        if not torch.equal(res["tokens"], tokens):
            raise AssertionError(f"(d) rank {r}: merged beam-5 tokens differ "
                                 f"from one process's")
    b = two[0]["bf16"]
    print(f"  (b) world 2 over gloo, B{DP_B // 2} a rank: bf16 loss "
          f"{b['loss']:.6f} vs (a) {one['loss']:.6f} "
          f"({abs(b['loss'] - one['loss']) / abs(one['loss']):.3e} relative, "
          f"tol {BF16_STEP_RTOL}); grad norm {b['grad_norm']:.6f} vs "
          f"{one['grad_norm']:.6f}", flush=True)
    rows = "; ".join(f"{r['loss']:.7f}/{m['loss']:.7f} |g| "
                     f"{r['grad_norm']:.6f}/{m['grad_norm']:.6f} ratio "
                     f"{r['ratio']:.2e}"
                     for r, m in zip(two[0]["fp32"], fp32["metrics"]))
    print(f"  (c) world 2 fp32 B{DP_FP32_B} dropout 0.1 (residual, attention,"
          f" activation), 3 steps each from the one-process state, loss and "
          f"grad norm world 2/world 1 and the largest L2 update ratio: "
          f"{rows}; launches a step {fp32['launches']}", flush=True)
    print(f"  (d) world 2 beam 5 to length 20, B{DP_EVAL_B} a rank: merged "
          f"tokens identical to one process's B{DP_EVAL_B * 2}; the two "
          f"worlds' spawns {t2 - dp['t1']:.1f} s; phase 9 "
          f"{time.perf_counter() - dp['t0']:.1f} s on {card}", flush=True)


def phase_data_parallel(card: str) -> None:
    """(a) world 1 over NCCL: the bf16 B DP_B step bit for bit the
    one-process step; (b) world 2 over gloo, B DP_B/2 a rank: the loss
    within BF16_STEP_RTOL of (a)'s; (c) world 2, fp32, B DP_FP32_B, every
    dropout 0.1: 3 steps, each from the one-process run's state, held by
    phase 6c's per-step rule (TRAIN_METRIC_RTOL, PARAM_RTOL in L2); (d)
    world 2 beam 5 at B DP_EVAL_B a rank: the merged tokens identical to
    one process's. Every rank's launches a step equal one process's."""
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        dp_finish(dp_start(tmp, pool), card)


# phase 10: tensor parallelism on the one card. Every rank is a process that
# parallel/launch.py spawns on cuda:0; its model groups run over gloo (NCCL
# refuses two ranks on one card), and every collective of the model axis
# is an all_reduce (parallel/tensor.py). The model is built whole from its
# seed and then sharded (parallel/mesh.py shard_model), so a rank's weights
# are one process's, cut. Ranks sharing one card time nothing about
# tensor-parallel speed.
TP_LAYERS = 2  # (b) and (c): encoder and decoder layers each, full width
TP_FFN_N = 28000  # (e): the BART encoder's training rows


def tp_layers(cfg_fn):
    """``cfg_fn`` cut to TP_LAYERS encoder and decoder layers."""
    def cfg(dtype: str = "float32"):
        c = cfg_fn(dtype)
        one = (dict(num_layers=TP_LAYERS, num_decoder_layers=TP_LAYERS)
               if c.is_t5 else dict(encoder_layers=TP_LAYERS,
                                    decoder_layers=TP_LAYERS))
        return dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, **one))
    return cfg


def tp_t5_gated_cfg(dtype: str):
    """The gated T5 (t5-v1.1 gated-gelu, untied) at dropout 0.1."""
    c = t5_gated_cfg(dtype)
    return dataclasses.replace(c, backbone=dataclasses.replace(
        c.backbone, dropout_rate=0.1))


# (b)'s and (c)'s runs: (label, configuration, batch, steps, model axis, the
# one-process run whose kernels it launches)
TP_FP32 = (("bart", tp_layers(dp_fp32_cfg), make_train_batch, 3, 2, "train"),
           ("t5 gated", tp_layers(tp_t5_gated_cfg), make_t5_train_batch, 3,
            2, "t5_gated_train"),
           ("bart", tp_layers(dp_fp32_cfg), make_train_batch, 1, 4,
            "train"))


def tp_tokens(model_axis: int = 1) -> dict:
    """(d): fp32 beam 5 with use_fused_beam and greedy, to length 20, on
    phase 4 (a)'s batch of DP_EVAL_B rows (every rank the whole batch: a
    data axis of 1), TP_LAYERS layers at full width, and the fused beam
    run's launches (the tp_decode run on a rank)."""
    model = build_model("float32", tp_layers(with_flags(
        flagship_cfg, use_fused_beam=True)))
    shard_model(model, build_mesh(MeshConfig(model=model_axis)))
    batch = make_batch(DP_EVAL_B, model.cfg.backbone.vocab_size, seed=7)
    ctx = PetContext(task="caption", task_idx=3)
    out = {}
    with torch.inference_mode():
        for beams in (5, 1):
            reset_counts()
            out[beams] = seq2seq_generate(model, **batch, ctx=ctx,
                                          num_beams=beams,
                                          max_length=20).cpu()
            if beams == 5:
                run = TP_DECODE if model_axis > 1 else FUSED_BEAM[0]
                out["launches"] = {k: n for k, n in read_counts(run).items()
                                   if n}
    return out


def tp_video_step(model_axis: int = 1) -> dict:
    """(f): one bf16 tvqa step of the video model (S 604, B VIDEO_B,
    phase 7b's inputs; TP_LAYERS layers at full width: the long backward
    at the encoder's and the cross sites), its loss and launches (the
    tp_video_train run on a rank)."""
    deterministic_kernels()
    model = build_model("bfloat16", tp_layers(video_cfg))
    layout = build_mesh(MeshConfig(model=model_axis))
    trainable = apply_freezing(model, model.cfg.pet)
    shard_model(model, layout)
    batch = make_video_train_batch(VIDEO_B, model.cfg.backbone.vocab_size,
                                   33)
    step = make_train_step(model, build_optimizer(trainable, lr=7e-4,
                                                  total_steps=2),
                           VIDEO_TASKS)
    reset_counts()
    out = step(batch, torch.Generator(device="cuda").manual_seed(9),
               VIDEO_TASKS.index("tvqa"))
    torch.cuda.synchronize()
    run = TP_VIDEO if model_axis > 1 else "video_train"
    return {"loss": out["loss"].item(),
            "launches": {k: n for k, n in read_counts(run).items() if n}}


def tp_world2_train(rank: int, world: int, paths, family_paths) -> dict:
    """(a), (b), (g) and half of (h) on one rank of the (1, 2) mesh."""
    out = {"bf16": dp_bf16_step(rank, world, 2, TP_TRAIN)}
    torch.cuda.empty_cache()
    out["fp32"] = [dp_fp32_steps(rank, world, path, cfg_fn, batch_fn, 2,
                                 TP_T5 if "t5" in label else run)
                   for path, (label, cfg_fn, batch_fn, _, m, run)
                   in zip(paths, TP_FP32) if m == 2]
    torch.cuda.empty_cache()
    out["scripts"] = []
    for _, script, run in TP_SCRIPTS:
        out["scripts"].append(dp_bf16_step(rank, world, 2, run,
                                           pet_cfg(script)))
        torch.cuda.empty_cache()
    out["families"] = tp_family_steps(rank, world, family_paths, 0)
    print(f"  rank {rank}/{world} at (1, 2): bf16 step launches "
          f"{out['bf16']['launches']}", flush=True)
    return out


def tp_world2_eval(rank: int, world: int, family_paths, resume_dir) -> dict:
    """(d), (f), the other half of (h) and (i) on one rank of another
    (1, 2) mesh."""
    out = {"tokens": tp_tokens(2), "video": tp_video_step(2)}
    torch.cuda.empty_cache()
    out["families"] = tp_family_steps(rank, world, family_paths, 1)
    out["family_tokens"] = tp_family_tokens(2)
    out["resume"] = tp_resume_split(resume_dir)
    return out


def tp_world4(rank: int, world: int, path: str) -> list:
    """(c) on one rank of the (1, 4) mesh."""
    label, cfg_fn, batch_fn, _, m, run = TP_FP32[2]
    return dp_fp32_steps(rank, world, path, cfg_fn, batch_fn, m, run)


# (g): (label, the PET script, the main path whose kernels its bf16 step
# launches) of the full-width bf16 steps at (1, 2)
TP_SCRIPTS = (("LoRA", "single_lora", "pet_single_lora"),
              ("full fine-tuning", "full_finetuning", "pet_full_finetuning"))
# (h): BitFit's and full fine-tuning's clip norm, below every step's
# gradient norm (the clip bites: a norm without the other rank's squares
# would scale the update otherwise)
TP_CLIP = 0.1


def tp_family(cfg_fn):
    """``cfg_fn`` at every BART dropout 0.1, TP_LAYERS layers each."""
    def cfg(dtype: str = "float32"):
        c = cfg_fn(dtype)
        return dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, dropout=0.1, attention_dropout=0.1,
            activation_dropout=0.1))
    return tp_layers(cfg)


def tp_mh_vpa_key(dtype: str):
    """The multihead VPA with the key parallel adapter (phase 6j's
    families 7 and 4 together)."""
    return _with_fields(ablation_cfg("mh_vpa")(dtype),
                        ABLATIONS["key_parallel"][1])


def tp_raw_model(dtype: str, cfg_fn):
    """RawInputVLModel of ``cfg_fn`` on the smallest published CLIP trunk
    (RN50 at 224 px), seeded, under the Trainer's cuDNN settings."""
    deterministic_kernels()
    model = RawInputVLModel(cfg_fn(dtype), vis_backbone="RN50",
                            image_size=RAW_IMAGE, vis_adapter_type=RAW_ADAPTER,
                            device="cuda")
    return model.init_weights(torch.Generator(device="cuda").manual_seed(1234))


# (h): (label, its configuration before ``tp_family``, batch, clip norm,
# the main path whose kernels its step launches, the function that builds
# the model, the global batch)
TP_FAMILIES = (
    ("LoRA", lambda d: pet_cfg("single_lora")(d), make_train_batch, 5.0,
     "pet_single_lora", build_model, DP_FP32_B),
    ("attention prefix", lambda d: pf_cfg("prefix")(d), make_train_batch,
     5.0, "pf_prefix", build_model, DP_FP32_B),
    ("visual prefix", lambda d: pf_cfg("vis_prefix")(d), make_train_batch,
     5.0, "pf_vis_prefix", build_model, DP_FP32_B),
    ("IA3", lambda d: ablation_cfg("ia3")(d), make_train_batch, 5.0,
     "abl_ia3", build_model, DP_FP32_B),
    ("multihead VPA + key adapter", tp_mh_vpa_key, make_train_batch, 5.0,
     "abl_mh_vpa", build_model, DP_FP32_B),
    ("BitFit", lambda d: pet_cfg("bitfit")(d), make_train_batch, TP_CLIP,
     "pet_bitfit", build_model, DP_FP32_B),
    ("full fine-tuning", lambda d: pet_cfg("full_finetuning")(d),
     make_train_batch, TP_CLIP, "pet_full_finetuning", build_model,
     DP_FP32_B),
    ("classifier", lambda d: tail_cfg("cls")(d), make_cls_batch, 5.0,
     "tail_cls", build_model, DP_FP32_B),
    ("remat full", lambda d: tail_cfg("remat_full")(d), make_train_batch, 5.0,
     "tail_remat_full", build_model, DP_FP32_B),
    ("raw RN50", lambda d: raw_cfg(d), make_raw_train_batch, 5.0, RAW_STEP,
     tp_raw_model, 4),
)
# (h)'s token families: label -> the eval path whose kernels its beam-5
# generation launches
TP_TOKEN_FAMILIES = {"LoRA": "pet_single_lora_eval",
                     "attention prefix": "pf_prefix_eval"}


def tp_family_refs(paths) -> list:
    """(h)'s one-process runs (``dp_fp32_reference``), one a family."""
    out = []
    for path, (_, cfg_fn, batch_fn, clip, run, build, B) in zip(
            paths, TP_FAMILIES):
        out.append(dp_fp32_reference(path, tp_family(cfg_fn), batch_fn, 3,
                                     run, build, clip, B))
        torch.cuda.empty_cache()
    return out


def tp_family_steps(rank: int, world: int, paths, first: int) -> dict:
    """(h) on a rank of a (1, 2) mesh: every other family from ``first``
    (the two (1, 2) meshes share them); {family index: its rows}."""
    out = {}
    for i in range(first, len(TP_FAMILIES), 2):
        _, cfg_fn, batch_fn, clip, run, build, B = TP_FAMILIES[i]
        out[i] = dp_fp32_steps(rank, world, paths[i], tp_family(cfg_fn),
                               batch_fn, 2, run, build, clip, B)
        torch.cuda.empty_cache()
    return out


def tp_family_tokens(model_axis: int = 1) -> dict:
    """(h)'s tokens: fp32 beam 5 and greedy to length 20 of each
    TP_TOKEN_FAMILIES entry, TP_LAYERS layers at full width, on phase 4
    (a)'s batch of DP_EVAL_B rows; the beam-5 run's launches."""
    out = {}
    for label, run in TP_TOKEN_FAMILIES.items():
        cfg_fn = next(f[1] for f in TP_FAMILIES if f[0] == label)
        model = build_model("float32", tp_layers(cfg_fn))
        shard_model(model, build_mesh(MeshConfig(model=model_axis)))
        batch = make_batch(DP_EVAL_B, model.cfg.backbone.vocab_size, seed=7)
        ctx = PetContext(task="caption", task_idx=3)
        res = {}
        with torch.inference_mode():
            for beams in (5, 1):
                reset_counts()
                res[beams] = seq2seq_generate(model, **batch, ctx=ctx,
                                              num_beams=beams,
                                              max_length=20).cpu()
                if beams == 5:
                    res["launches"] = {k: n for k, n in
                                       read_counts(run).items() if n}
        out[label] = res
    return out


# (i): a BitFit Trainer's steps before its checkpoint and after it
TP_RESUME_STEPS = (2, 2)


def tp_resume_cfg(dtype: str = "float32"):
    """(i)'s configuration: BitFit (bitfit.sh's recipe) at
    ``tp_family``'s depth and dropout."""
    return tp_family(lambda d: pet_cfg("bitfit")(d))(dtype)


def tp_resume_weights(path: str) -> str:
    """(i)'s starting weights, written to the LAST.npz ``path`` that every
    Trainer of (i) loads: the model of ``tp_resume_cfg``, ``unzero``-ed
    (the biases BitFit trains start off zero, as phase 6g's do)."""
    from vlpet_tpu_torch.train.checkpoint import save_params_npz

    model = build_model("float32", tp_resume_cfg)
    unzero(model)
    save_params_npz({n: p.detach() for n, p in model.named_parameters()},
                    path)
    return path


def tp_resume_trainer(out_dir: str, model_axis: int, weights: str):
    """(i)'s Trainer of ``tp_resume_cfg`` from the LAST.npz ``weights``:
    fp32, clip TP_CLIP, writing under ``out_dir``."""
    from vlpet_tpu_torch.train.trainer import Trainer

    return Trainer(tp_resume_cfg(), FLAGSHIP_TASKS, lr=1e-3, total_steps=8,
                   clip_grad_norm=TP_CLIP, output_dir=out_dir, load=weights,
                   mesh_model_axis=model_axis, verbose=False, device="cuda")


def tp_resume_steps(trainer, first: int, n: int) -> list:
    """Steps ``first``..``first + n - 1`` of (i): vqa on the B DP_FP32_B
    batch of seed 50 + i; per step the loss and gradient norm."""
    rows = []
    for i in range(first, first + n):
        batch = make_train_batch(DP_FP32_B, trainer.cfg.backbone.vocab_size,
                                 50 + i)
        out = trainer.train_step(batch, trainer.generator,
                                 FLAGSHIP_TASKS.index("vqa"))
        trainer.step += 1
        rows.append({"loss": out["loss"].item(),
                     "grad_norm": out["grad_norm"].item()})
    return rows


def tp_resume_split(resume_dir: str) -> dict:
    """(i) on a rank of the (1, 2) mesh: the first TP_RESUME_STEPS[0]
    steps, the checkpoint under ``resume_dir``/split (rank 0 writes the
    gathered state), its digest."""
    trainer = tp_resume_trainer(os.path.join(resume_dir, "split"), 2,
                                os.path.join(resume_dir, "weights.npz"))
    rows = tp_resume_steps(trainer, 0, TP_RESUME_STEPS[0])
    trainer.save(trainer.step)
    return {"rows": rows, "digest": trainer.state_digest(),
            "split": sum(p.shape != trainer.model.get_parameter(n).shape
                         for n, p in gather_state_dict(
                             trainer.trainable, trainer.model).items())}


def tp_resume_check(out_dir: str, split: dict) -> str:
    """(i) in this process: an uninterrupted one-process BitFit run of
    both TP_RESUME_STEPS, then a one-process Trainer that restores the
    split run's checkpoint (its state digest the ranks') and takes the
    last steps; each step's loss and gradient norm within
    TRAIN_METRIC_RTOL of the uninterrupted run's, the trainable tensors
    at the end within PARAM_RTOL of its update (L2; ``zero_grad``'s by
    phase 6's elementwise rule). Returns the line it prints."""
    first, last = TP_RESUME_STEPS
    weights = os.path.join(out_dir, "weights.npz")
    straight = tp_resume_trainer(os.path.join(out_dir, "straight"), 1,
                                 weights)
    rows = tp_resume_steps(straight, 0, first)
    mid = snapshot(straight.trainable)
    rows += tp_resume_steps(straight, first, last)
    resumed = tp_resume_trainer(os.path.join(out_dir, "split"), 1, weights)
    if resumed.restore() != first:
        raise AssertionError("(i) the split run's checkpoint did not restore "
                             f"at step {first}")
    digest = resumed.state_digest()
    if digest != split["digest"]:
        raise AssertionError(f"(i) restored state digest {digest[:12]} != "
                             f"the split run's {split['digest'][:12]}")
    got = tp_resume_steps(resumed, first, last)
    for i, (row, ref) in enumerate(zip(split["rows"] + got, rows)):
        for key in ("loss", "grad_norm"):
            if not abs(row[key] - ref[key]) <= TRAIN_METRIC_RTOL * abs(
                    ref[key]):
                raise AssertionError(f"(i) step {i} {key}: {row[key]!r} vs "
                                     f"uninterrupted {ref[key]!r}")
        if row["grad_norm"] <= TP_CLIP:
            raise AssertionError(f"(i) step {i}: grad norm "
                                 f"{row['grad_norm']} under the clip")
    end = snapshot(straight.trainable)
    ratio = max((p.detach() - end[n]).norm().item()
                / max((end[n] - mid[n]).norm().item(), 1e-30)
                for n, p in resumed.trainable.items() if not zero_grad(n))
    for n, p in resumed.trainable.items():
        if zero_grad(n) and not ((p.detach() - end[n]).abs() <= PARAM_RTOL
                                 * end[n].abs() + PARAM_ATOL_SCALE
                                 * end[n].abs().max()).all():
            raise AssertionError(f"(i) {n} outside phase 6's elementwise "
                                 f"tolerance of the uninterrupted run's")
    if not ratio <= PARAM_RTOL:
        raise AssertionError(f"(i) resumed tensors {ratio:.3e} of the last "
                             f"steps' update from the uninterrupted run's")
    return (f"  (i) BitFit Trainer at (1, 2), {first} fp32 steps (clip "
            f"{TP_CLIP}, norms {[round(r['grad_norm'], 4) for r in rows]}), "
            f"checkpoint with {split['split']} split biases gathered whole; "
            f"one process restored it (digest {digest[:12]} = the ranks'), "
            f"{last} more steps: loss and grad norm within "
            f"{TRAIN_METRIC_RTOL} of the uninterrupted run's, tensors "
            f"{ratio:.2e} of the update apart")


def tp_colbase_masks(seed: torch.Tensor, rate: float) -> None:
    """(e)'s masks: F1 / F2 / F3 / F4 at a rank's column base draw, bit for
    bit, those columns of the whole hidden's mask (ops/hashdrop.py
    keep_mask with the column base and width): check_ffn_bf16_mask's,
    check_ffn_bwd_bf16_mask's and check_gated_bf16_mask's picking
    weights at the shard's first and last k = min(D, Fh) columns (the
    rest of W picks nothing: y and dx are zero past k)."""
    bf, D, N = torch.bfloat16, 768, TP_FFN_N
    ones = torch.ones((N, D), device="cuda", dtype=bf)
    x3 = torch.full((N, D), 3.0, device="cuda", dtype=bf)
    z = torch.zeros(D, device="cuda")
    for width, m, gated in ((3072, 2, False), (3072, 4, False),
                            (2048, 2, True), (2048, 4, True)):
        Fh = width // m
        k = min(D, Fh)
        base = (m - 1) * Fh  # the last rank's columns
        cols = dict(col_base=base, width=width)
        keep = keep_mask((N, Fh), 0, seed, rate, device="cuda", **cols)
        for off in sorted({0, Fh - k}):
            pick = torch.zeros((D, Fh), device="cuda", dtype=bf)
            r = torch.arange(k, device="cuda")
            pick[r, r + off] = 1.0              # (D, F): hidden -> D
            spread = pick.t().contiguous()      # (F, D): D -> hidden
            kept = keep[:, off:off + k]
            name = f"N{N} F{Fh} of {width} at {base} off{off}"
            if gated:
                y = ffn.fused_gated_ffn(x3, spread, spread, pick, "gelu_new",
                                        rate, seed, **cols)
                _expect_zeros(f"fused_gated_ffn {name}", y[:, :k], kept,
                              "bf16")
                dx = ffn.fused_gated_ffn_bwd(x3, ones, spread, spread, pick,
                                             "gelu_new", rate, seed, **cols)
                _expect_zeros(f"fused_gated_ffn_bwd {name}", dx[:, :k], kept,
                              "bf16")
                continue
            ones_b1 = torch.ones(Fh, device="cuda")
            y = ffn.fused_ffn(ones, torch.zeros((Fh, D), device="cuda",
                                                dtype=bf),
                              ones_b1, pick, z, "relu", rate, seed, **cols)
            _expect_zeros(f"fused_ffn {name}", y[:, :k], kept, "bf16")
            dx, _, _ = ffn.fused_ffn_bwd(ones, ones, spread, ones_b1, pick,
                                         "relu", rate, seed, **cols)
            _expect_zeros(f"fused_ffn_bwd {name}", dx[:, :k], kept, "bf16")
        del keep


def tp_colbase_kernels(rep: Report) -> None:
    """(e): F1 / F2 (gelu with biases, a zero b2 as the split path passes)
    at Fh 1536 and 768 of BART's 3072 and F1 also at the beam rows N 2500
    (split over the hidden), F3 / F4 (gelu_new) at Fh 1024 and 512 of the
    gated T5's 2048, bf16, N TP_FFN_N, D 768, rate 0.1, each rank's column
    base, against their plain twins (the backwards against autograd of
    them), twice bitwise; the Fh 1536 and 1024 cases timed, with the
    bound; then the masks bit for bit (``tp_colbase_masks``)."""
    g = torch.Generator(device="cuda").manual_seed(24)
    randn = randn_fn(g)
    dtype, D, rate = torch.bfloat16, 768, 0.1
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device="cuda",
                         dtype=torch.int32)
    z = torch.zeros(D, device="cuda")
    for width, m, N in ((3072, 2, TP_FFN_N), (3072, 4, TP_FFN_N),
                        (3072, 2, 2500)):
        Fh = width // m
        cols = dict(col_base=(m - 1) * Fh, width=width)
        w1 = randn(Fh, D, dtype=dtype, scale=0.02)
        w2 = randn(D, Fh, dtype=dtype, scale=0.02)
        b1 = randn(Fh, scale=0.02)
        x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
        label = (f"bf16 N{N} D{D} F{Fh} of {width} at {cols['col_base']} "
                 f"gelu rate {rate}")
        timed = Fh == 1536 and N == TP_FFN_N

        def f1():
            return ffn.fused_ffn(x, w1, b1, w2, z, "gelu", rate, seed,
                                 **cols)
        rep.check("fused_ffn +colbase", label, f1,
                  lambda: ffn.ffn_reference(x, w1, b1, w2, z, "gelu", rate,
                                            seed, **cols), dtype,
                  timed=timed, work=(2 * (2 * N * D + 2 * D * Fh)
                                     + 4 * (Fh + D), 4 * N * D * Fh))
        bitwise_repeat("fused_ffn +colbase", label, f1)
        if N == TP_FFN_N:
            def f2():
                return ffn.fused_ffn_bwd(x, dy, w1, b1, w2, "gelu", rate,
                                         seed, **cols)
            rep.check("fused_ffn_bwd +colbase", label, f2,
                      _grads_of(lambda a, c, d: ffn.ffn_reference(
                          a, w1, c, w2, d, "gelu", rate, seed, **cols),
                          (x, b1, z), dy),
                      dtype, timed=timed, backward=True,
                      work=(2 * (3 * N * D + 2 * D * Fh) + 4 * (2 * Fh + D),
                            6 * N * D * Fh))
            bitwise_repeat("fused_ffn_bwd +colbase", label, f2)
        del x, dy
    for width, m in ((2048, 2), (2048, 4)):
        N, Fh = TP_FFN_N, width // m
        cols = dict(col_base=(m - 1) * Fh, width=width)
        w0, w1 = (randn(Fh, D, dtype=dtype, scale=0.02) for _ in range(2))
        wo = randn(D, Fh, dtype=dtype, scale=0.02)
        x, dy = randn(N, D, dtype=dtype), randn(N, D, dtype=dtype)
        label = (f"bf16 N{N} D{D} F{Fh} of {width} at {cols['col_base']} "
                 f"gelu_new rate {rate}")
        timed = Fh == 1024

        def f3():
            return ffn.fused_gated_ffn(x, w0, w1, wo, "gelu_new", rate, seed,
                                       **cols)

        def f4():
            return ffn.fused_gated_ffn_bwd(x, dy, w0, w1, wo, "gelu_new",
                                           rate, seed, **cols)
        rep.check("fused_gated_ffn +colbase", label, f3,
                  lambda: ffn.gated_ffn_reference(x, w0, w1, wo, "gelu_new",
                                                  rate, seed, **cols),
                  dtype, timed=timed,
                  work=(2 * (2 * N * D + 3 * D * Fh), 6 * N * D * Fh))
        plain_f4 = _grads_of(lambda a: ffn.gated_ffn_reference(
            a, w0, w1, wo, "gelu_new", rate, seed, **cols), (x,), dy)
        rep.check("fused_gated_ffn_bwd +colbase", label, f4,
                  lambda: plain_f4()[0], dtype, timed=timed, backward=True,
                  work=(2 * (3 * N * D + 3 * D * Fh), 10 * N * D * Fh))
        bitwise_repeat("fused_gated_ffn +colbase", label, f3)
        bitwise_repeat("fused_gated_ffn_bwd +colbase", label,
                       lambda: (f4(),))
        del x, dy
    tp_colbase_masks(seed, rate)


def tp_start(tmp: str, pool) -> dict:
    """Phase 10's one-process runs ((a)-(d), (f)-(h)), then its three
    meshes submitted to ``pool``: (1, 2) for (a), (b) and (g), another
    (1, 2) for (d), (f), (h) and (i), (1, 4) for (c); every rank on the
    one card."""
    from vlpet_tpu_torch.parallel.launch import run_ranks

    tp = {"t0": time.perf_counter(), "want": dp_bf16_step(),
          "paths": [os.path.join(tmp, f"tp_fp32_{i}.pt")
                    for i in range(len(TP_FP32))]}
    tp["refs"] = [dp_fp32_reference(path, cfg_fn, batch_fn, steps, run)
                  for path, (_, cfg_fn, batch_fn, steps, _, run)
                  in zip(tp["paths"], TP_FP32)]
    tp["tokens"], tp["video"] = tp_tokens(), tp_video_step()
    torch.cuda.empty_cache()
    tp["scripts"] = []
    for _, script, run in TP_SCRIPTS:
        tp["scripts"].append(dp_bf16_step(path=run, cfg_fn=pet_cfg(script)))
        torch.cuda.empty_cache()
    tp["family_paths"] = [os.path.join(tmp, f"tp_family_{i}.pt")
                          for i in range(len(TP_FAMILIES))]
    tp["family_refs"] = tp_family_refs(tp["family_paths"])
    tp["family_tokens"] = tp_family_tokens()
    tp["resume_dir"] = os.path.join(tmp, "tp_resume")
    os.makedirs(tp["resume_dir"])
    tp_resume_weights(os.path.join(tp["resume_dir"], "weights.npz"))
    torch.cuda.empty_cache()
    tp["t1"] = time.perf_counter()
    kw = dict(device="cuda", backend="gloo", timeout=DP_TIMEOUT_S)
    tp["train"] = pool.submit(run_ranks, tp_world2_train, 2, tp["paths"],
                              tp["family_paths"], **kw)
    tp["eval"] = pool.submit(run_ranks, tp_world2_eval, 2,
                             tp["family_paths"], tp["resume_dir"], **kw)
    tp["four"] = pool.submit(run_ranks, tp_world4, 4, tp["paths"][2], **kw)
    return tp


def tp_finish(tp: dict, card: str) -> dict:
    """Phase 10's checks on its meshes' results (``tp_start``); returns
    the main-path runs' launches (rank 0's)."""
    train, evals, four = (tp[k].result() for k in ("train", "eval", "four"))
    t3 = time.perf_counter()
    want, refs, tokens, video = tp["want"], tp["refs"], tp["tokens"], tp["video"]
    for r, (res, ev) in enumerate(zip(train, evals)):
        b = res["bf16"]
        rel = abs(b["loss"] - want["loss"]) / abs(want["loss"])
        if not rel <= BF16_STEP_RTOL:
            raise AssertionError(f"(a) rank {r}: loss {b['loss']!r} vs one "
                                 f"process {want['loss']!r}: {rel:.3e}")
        if b["digest"] != train[0]["bf16"]["digest"]:
            raise AssertionError(f"(a) rank {r}: trainable tensors differ "
                                 f"from rank 0's")
        if b["launches"] != want["launches"]:
            raise AssertionError(f"(f) rank {r}: bf16 step launches "
                                 f"{b['launches']}, one process "
                                 f"{want['launches']}")
        if ev["video"]["launches"] != video["launches"]:
            raise AssertionError(f"(f) rank {r}: video step launches "
                                 f"{ev['video']['launches']}, one process "
                                 f"{video['launches']}")
        for beams in (5, 1):
            if not torch.equal(ev["tokens"][beams], tokens[beams]):
                raise AssertionError(f"(d) rank {r}: beam {beams} tokens "
                                     f"differ from one process's")
        if ev["tokens"]["launches"] != tokens["launches"]:
            raise AssertionError(f"(d) rank {r}: fused beam-5 launches "
                                 f"{ev['tokens']['launches']}, one process "
                                 f"{tokens['launches']}")
    fp32_rows = [(TP_FP32[i], refs[i], [res["fp32"][i] for res in train])
                 for i in range(2)]
    fp32_rows.append((TP_FP32[2], refs[2], four))
    for (label, *_), ref, per_rank in fp32_rows:
        for r, rows in enumerate(per_rank):
            for i, (row, m) in enumerate(zip(rows, ref["metrics"])):
                for key in ("loss", "grad_norm"):
                    if not abs(row[key] - m[key]) <= (TRAIN_METRIC_RTOL
                                                      * abs(m[key])):
                        raise AssertionError(f"(b/c) {label} rank {r} step "
                                             f"{i} {key}: {row[key]!r} vs "
                                             f"one process {m[key]!r}")
                if not row["ratio"] <= PARAM_RTOL:
                    raise AssertionError(f"(b/c) {label} rank {r} step {i}: "
                                         f"update ratio {row['ratio']:.3e}")
                if row["launches"] != ref["launches"]:
                    raise AssertionError(f"(f) {label} rank {r} step {i}: "
                                         f"launches {row['launches']}, one "
                                         f"process {ref['launches']}")
    b = train[0]["bf16"]
    print(f"  (a) (1, 2) over gloo: bf16 B{DP_B} vqa step loss "
          f"{b['loss']:.6f} vs one process {want['loss']:.6f} "
          f"({abs(b['loss'] - want['loss']) / abs(want['loss']):.3e} "
          f"relative, tol {BF16_STEP_RTOL}); grad norm {b['grad_norm']:.6f} "
          f"vs {want['grad_norm']:.6f}; both ranks' trainable tensors bit "
          f"for bit", flush=True)
    for (label, _, _, steps, m, _), ref, per_rank in fp32_rows:
        rows = "; ".join(f"{r['loss']:.7f}/{x['loss']:.7f} |g| "
                         f"{r['grad_norm']:.6f}/{x['grad_norm']:.6f} ratio "
                         f"{r['ratio']:.2e}"
                         for r, x in zip(per_rank[0], ref["metrics"]))
        print(f"  ({'c' if m == 4 else 'b'}) {label} (1, {m}) fp32 "
              f"B{DP_FP32_B} {TP_LAYERS}+{TP_LAYERS} layers, dropout 0.1, "
              f"{steps} step(s) from the one-process state, loss and grad "
              f"norm split/one and the largest L2 update ratio: {rows}; "
              f"launches a step {ref['launches']}", flush=True)
    print(f"  (d) (1, 2) fp32 beam 5 (use_fused_beam) and greedy to length "
          f"20, B{DP_EVAL_B}, {TP_LAYERS}+{TP_LAYERS} layers: tokens "
          f"identical to one process's; fused beam-5 launches "
          f"{tokens['launches']}", flush=True)
    print(f"  (f) launches a step equal one process's: bf16 step "
          f"{want['launches']}; video S604 B{VIDEO_B} step, "
          f"{TP_LAYERS}+{TP_LAYERS} layers (loss "
          f"{evals[0]['video']['loss']:.6f} vs {video['loss']:.6f}) "
          f"{video['launches']}", flush=True)
    tp_finish_families(tp, train, evals)
    print(f"  phase 10: the one-process runs {tp['t1'] - tp['t0']:.1f} s, "
          f"the three meshes' spawns {t3 - tp['t1']:.1f} s; "
          f"{time.perf_counter() - tp['t0']:.1f} s after (e) on {card}",
          flush=True)
    return {TP_TRAIN: train[0]["bf16"]["launches"],
            TP_T5: train[0]["fp32"][1][0]["launches"],
            TP_VIDEO: evals[0]["video"]["launches"],
            TP_DECODE: evals[0]["tokens"]["launches"]}


def tp_finish_families(tp: dict, train, evals) -> None:
    """Phase 10's checks of (g), (h) and (i) (``tp_start``)."""
    for (label, _, run), want, *per_rank in zip(
            TP_SCRIPTS, tp["scripts"], *[r["scripts"] for r in train]):
        for r, got in enumerate(per_rank):
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            if not rel <= BF16_STEP_RTOL:
                raise AssertionError(f"(g) {label} rank {r}: loss "
                                     f"{got['loss']!r} vs one process "
                                     f"{want['loss']!r}: {rel:.3e}")
            if got["digest"] != per_rank[0]["digest"]:
                raise AssertionError(f"(g) {label} rank {r}: gathered "
                                     f"trainable tensors differ from rank "
                                     f"0's")
            if got["launches"] != want["launches"]:
                raise AssertionError(f"(g) {label} rank {r}: launches "
                                     f"{got['launches']}, one process "
                                     f"{want['launches']}")
        got = per_rank[0]
        print(f"  (g) {label} (1, 2) bf16 B{DP_B} vqa step: loss "
              f"{got['loss']:.6f} vs one process {want['loss']:.6f} "
              f"({abs(got['loss'] - want['loss']) / abs(want['loss']):.3e} "
              f"relative), grad norm {got['grad_norm']:.6f} vs "
              f"{want['grad_norm']:.6f}; gathered trainables bit for bit on "
              f"both ranks; launches {want['launches']}", flush=True)
    if any("fused_ffn" in k for k in tp["scripts"][1]["launches"]):
        raise AssertionError("(g) full fine-tuning launched F1 / F2")
    errors = []  # (h): every family's line first, then its faults
    for i, ((label, _, _, clip, _, _, B), ref) in enumerate(
            zip(TP_FAMILIES, tp["family_refs"])):
        mesh = evals if i % 2 else train
        for r, res in enumerate(mesh):
            for k, (row, m) in enumerate(zip(res["families"][i],
                                             ref["metrics"])):
                for key in ("loss", "grad_norm"):
                    if not abs(row[key] - m[key]) <= (TRAIN_METRIC_RTOL
                                                      * abs(m[key])):
                        errors.append(f"(h) {label} rank {r} step {k} "
                                      f"{key}: {row[key]!r} vs one process "
                                      f"{m[key]!r}")
                if not row["ratio"] <= PARAM_RTOL:
                    errors.append(f"(h) {label} rank {r} step {k}: update "
                                  f"ratio {row['ratio']:.3e}")
                if row["launches"] != ref["launches"]:
                    errors.append(f"(h) {label} rank {r} step {k}: launches "
                                  f"{row['launches']}, one process "
                                  f"{ref['launches']}")
                if clip < 5.0 and not m["grad_norm"] > clip:
                    errors.append(f"(h) {label} step {k}: grad norm "
                                  f"{m['grad_norm']} under the clip {clip}")
        rows = "; ".join(f"{x['loss']:.7f}/{m['loss']:.7f} |g| "
                         f"{x['grad_norm']:.6f}/{m['grad_norm']:.6f} ratio "
                         f"{x['ratio']:.2e}"
                         + (f" (key biases {x['noise']:.2f} of phase 6's "
                            f"tolerance)" if x["noise"] else "")
                         for x, m in zip(mesh[0]["families"][i],
                                         ref["metrics"]))
        print(f"  (h) {label} (1, 2) fp32 B{B} {TP_LAYERS}+{TP_LAYERS} "
              f"layers, dropout 0.1{f', clip {clip}' if clip < 5.0 else ''}: "
              f"{rows}; launches a step {ref['launches']}", flush=True)
    if errors:
        raise AssertionError("; ".join(errors))
    for label in TP_TOKEN_FAMILIES:
        want = tp["family_tokens"][label]
        for r, res in enumerate(evals):
            got = res["family_tokens"][label]
            for beams in (5, 1):
                if not torch.equal(got[beams], want[beams]):
                    raise AssertionError(f"(h) {label} rank {r}: beam "
                                         f"{beams} tokens differ from one "
                                         f"process's")
            if got["launches"] != want["launches"]:
                raise AssertionError(f"(h) {label} rank {r}: beam-5 launches "
                                     f"{got['launches']}, one process "
                                     f"{want['launches']}")
        print(f"  (h) {label} (1, 2) fp32 beam 5 and greedy to length 20, "
              f"B{DP_EVAL_B}: tokens identical to one process's; beam-5 "
              f"launches {want['launches']}", flush=True)
    if evals[1]["resume"]["digest"] != evals[0]["resume"]["digest"]:
        raise AssertionError("(i) the ranks' state digests differ")
    print(tp_resume_check(tp["resume_dir"], evals[0]["resume"]), flush=True)


def tp_kernels(rep: Report) -> None:
    """(e), alone on the card (it times the kernels), with its seconds."""
    t0 = time.perf_counter()
    tp_colbase_kernels(rep)
    print(f"  phase 10 (e): {time.perf_counter() - t0:.1f} s", flush=True)


def phase_tensor_parallel(rep: Report, card: str) -> dict:
    """(a)-(f) of the module docstring's phase 10; returns the main-path
    runs' launches (rank 0's)."""
    tp_kernels(rep)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(3) as pool:
        return tp_finish(tp_start(tmp, pool), card)


def phase_parallel(rep: Report, card: str) -> dict:
    """Phases 9 and 10 with their ranks spawned at once: 10 (e) first,
    alone on the card, then each phase's one-process runs, then the seven
    process groups together (neither phase times its ranks), then each
    phase's checks. Returns phase 10's ``launched``."""
    tp_kernels(rep)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(5) as pool:
        dp = dp_start(tmp, pool)
        tp = tp_start(tmp, pool)
        dp_finish(dp, card)
        return tp_finish(tp, card)

def main() -> int:
    t_start = time.perf_counter()

    def header(text: str, flush: bool = True) -> None:
        """A phase's title line, with the smoke's seconds so far."""
        print(f"{text} [{time.perf_counter() - t_start:.1f} s]", flush=flush)
    header("phase 1: environment", flush=True)
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- "
                         "this script needs a CUDA card")
    card = nvidia_smi()
    print(f"  card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    header("phase 2: build", flush=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"  built and loaded {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    header("phase 3: decode-path kernels vs plain", flush=True)
    rep = Report()
    phase_kernels(rep)
    header("phase 3b: training-path kernels vs plain", flush=True)
    phase_train_kernels(rep)
    header("phase 3c: long attention (video path) vs plain", flush=True)
    phase_long_attention(rep)
    phase_video_kernels(rep)
    header("phase 3d: T5 eval-path kernels vs plain", flush=True)
    phase_t5_kernels(rep)
    header("phase 3e: T5 training-path kernels vs plain", flush=True)
    phase_t5_train_kernels(rep)
    header("phase 3f: fused CE, fused beam and slot-write kernels vs plain",
          flush=True)
    phase_fused_kernels(rep)
    header("phase 3g: long backward with bias and dropout, dbias, vs plain",
          flush=True)
    phase_bias_grad_kernels(rep)
    header("phase 3h: F1 and C1 at their paths' rows, bf16", flush=True)
    phase_ffn_ce_sites(rep)
    header("phase 3i: F3 and F4 at their paths' rows, bf16", flush=True)
    phase_gated_ffn_sites(rep)
    header("phase 3j: F2 at its paths' rows, bf16; U1's K+V write",
          flush=True)
    phase_ffn_bwd_sites(rep)
    header("phase 3k: D1 and D2 at their paths' rows, bf16", flush=True)
    phase_beam_sites(rep)
    header("phase 3l: T1 and T2 at their sites, fp32", flush=True)
    phase_topk_sites(rep)
    header("phase 3m: L1 and L2 at their sites", flush=True)
    phase_ln_sites(rep)
    t0 = time.perf_counter()
    header("phase 3n: A1, A6 and the long backward at the prompt baseline's "
          "sites, bf16", flush=True)
    phase_prompt_sites(rep)
    print(f"  phase 3n: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 3o: the video scripts' kernel sites", flush=True)
    phase_video_script_sites(rep)
    print(f"  phase 3o: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 3p: the raw-image path's kernel sites", flush=True)
    phase_raw_sites(rep)
    print(f"  phase 3p: {time.perf_counter() - t0:.1f} s", flush=True)

    header("phase 4: decode parity, fp32", flush=True)
    phase_parity()

    header("phase 5: decode bench shape, bf16", flush=True)
    launched = {"decode": phase_decode_bench(card)}
    header("phase 5b: video eval, fp32 parity and bf16 bench shape",
          flush=True)
    launched["video_eval"] = phase_video_eval(card)
    header("phase 4c: T5 decode parity, fp32", flush=True)
    phase_t5_parity()
    header("phase 5c: T5 eval shape, bf16", flush=True)
    launched.update(phase_t5_eval(card))
    header("phase 4d: use_fused_beam decode parity, fp32", flush=True)
    phase_fused_beam_parity()
    header("phase 5d: use_fused_beam eval shape, bf16", flush=True)
    launched.update(phase_fused_beam_bench(card))
    header("phase 5e: T5 video eval, fp32 parity and bf16 bench shape",
          flush=True)
    launched[T5V_EVAL] = phase_t5_video_eval(card)

    header("phase 6: train-step parity, fp32", flush=True)
    phase_train_parity()
    header("phase 6b: video train-step parity, fp32", flush=True)
    phase_video_train_parity()
    header("phase 6c: T5 train-step parity, fp32", flush=True)
    phase_t5_train_parity()
    header("phase 6d: use_fused_ce train-step parity, fp32", flush=True)
    phase_fused_ce_parity()
    header("phase 6e: T5 video and trainable-bias train-step parity, fp32",
          flush=True)
    launched.update(phase_bias_train_parity())
    header("phase 6f: VL-PET-small, -middleX, -middleY parity, fp32",
          flush=True)
    phase_gate_parity()
    t0 = time.perf_counter()
    header("phase 6g: the PET baselines' train and decode parity, fp32",
          flush=True)
    phase_pet_parity()
    print(f"  phase 6g: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 6h: the video scripts' train and decode parity, fp32",
          flush=True)
    phase_video_script_parity()
    print(f"  phase 6h: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 6i: the raw path's train and decode parity, fp32; the "
          "importers at full shape", flush=True)
    phase_raw_parity()
    print(f"  phase 6i: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 6j: the VL-PET ablation flags' train and decode parity, "
          "fp32", flush=True)
    phase_ablation_parity()
    print(f"  phase 6j: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 6k: the prefixes', decoder prompts', LM-head adapter's and "
          "T5 baselines' train and decode parity, fp32", flush=True)
    phase_pet_flag_parity(rep)
    print(f"  phase 6k: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 6l: the classifier, BART's attention and activation "
          "dropout, remat, sparse_sample and the BART heads, fp32",
          flush=True)
    launched.update(phase_tail_parity(rep))
    print(f"  phase 6l: {time.perf_counter() - t0:.1f} s", flush=True)

    header("phase 7: train bench shape, bf16", flush=True)
    launched["train"] = phase_train_bench(card)
    header("phase 7b: video train step, bf16", flush=True)
    launched["video_train"] = phase_video_train_bench(card)
    header("phase 7c: T5 train step, bf16", flush=True)
    launched.update(phase_t5_train_bench(card))
    header("phase 7d: use_fused_ce train step, bf16", flush=True)
    launched.update(phase_fused_ce_bench(card))
    header("phase 7e: T5 video and t5_full_ft train steps, bf16", flush=True)
    launched.update(phase_bias_train_bench(card))
    t0 = time.perf_counter()
    header("phase 7f: the PET baselines' train steps and evals, bf16",
          flush=True)
    launched.update(phase_pet_bench(card))
    print(f"  phase 7f: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 7g: the video scripts' train steps and evals, bf16",
          flush=True)
    launched.update(phase_video_script_bench(card))
    print(f"  phase 7g: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 7h: what the raw path costs, bf16", flush=True)
    launched.update(phase_raw_bench(card))
    print(f"  phase 7h: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 7j: the VL-PET ablation flags' train steps and evals, bf16",
          flush=True)
    launched.update(phase_ablation_bench(card))
    print(f"  phase 7j: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 7k: the prefixes', decoder prompts', LM-head adapter's and "
          "T5 baselines' train steps and evals, bf16", flush=True)
    launched.update(phase_pet_flag_bench(card))
    print(f"  phase 7k: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 7l: the classifier, the dropouts and remat: train steps, "
          "bf16", flush=True)
    launched.update(phase_tail_bench(card))
    print(f"  phase 7l: {time.perf_counter() - t0:.1f} s", flush=True)
    header("phase 8: the image-text CLI, VL-PET-small, bf16", flush=True)
    launched[CLI] = phase_cli_rehearsal(card)
    t0 = time.perf_counter()
    header("phase 8b: the image-text CLI, single_prompt, bf16", flush=True)
    launched[CLI_PROMPT] = phase_cli_prompt(card)
    print(f"  phase 8b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 8c: the video CLI, VL-PET-large, and single_task tvqa, "
          "single_prompt, bf16", flush=True)
    launched.update(phase_cli_video(card))
    print(f"  phase 8c: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 8d: the user's pipeline on the CLI: extracted features with "
          "--backbone_ckpt, then raw images with --clip_ckpt, bf16",
          flush=True)
    launched.update(phase_cli_raw(card))
    print(f"  phase 8d: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    header("phase 8e: the image-text CLI with --classifier, VL-PET-large, "
          "bf16", flush=True)
    launched.update(phase_cli_classifier(card))
    print(f"  phase 8e: {time.perf_counter() - t0:.1f} s", flush=True)
    header("phases 9 and 10: data and tensor parallelism on the one card "
           "(spawned ranks on cuda:0, both phases' at once)", flush=True)
    launched.update(phase_parallel(rep, card))

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
    if sys.argv[1:2] == ["--cli-child"]:
        cli_child(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
