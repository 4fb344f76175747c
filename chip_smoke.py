"""Smoke run of the PyTorch port (vlpet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. environment: torch/CUDA versions, card name and power limit;
  2. build the CUDA kernels from vlpet_tpu_torch/csrc with nvcc (sm_90a);
  3. every kernel vs its plain PyTorch twin at the decode path's shapes,
     bf16 and fp32, with median times from CUDA events;
  4. fp32 end-to-end parity: BART-base + VL-PET-large at full width, seeded
     random weights, batch 8, beam 5 (then greedy) to length 40, through
     the kernels and through the plain path: the token sequences must be
     identical. (a) all 6+6 layers at the JAX init scale; (b) 1+1 layers
     with weights at a scale that decodes varied tokens;
  5. the bench shape in bf16: batch 500 (20 text tokens + 36 boxes of
     2048-d features), beam 5 to length 40; examples/s and launches per
     kernel.
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}.

Imports: torch, the standard library and the port (vlpet_tpu_torch) only.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from vlpet_tpu_torch.config import flagship_cfg
from vlpet_tpu_torch.models.generate import seq2seq_generate
from vlpet_tpu_torch.models.vlbart import VLBart
from vlpet_tpu_torch.ops import (_build, attention, decode, ffn, plain_twins,
                                 topk)
from vlpet_tpu_torch.pet.modules import PetContext

# Tolerances of the kernel-vs-plain checks: |kernel - plain| <= tol * (1 +
# |plain|). fp32 kernels only reorder fp32 sums; bf16 kernels keep fp32
# probabilities / hidden activations where the plain path rounds them to
# bf16, which bounds the difference by a few bf16 ulps of O(1) values.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOPK_LSE_TOL = 1e-5  # top-k values and indices must match exactly
# phase 4: at the last beam step at least this share of the cache slots is
# read from another beam's row (hypotheses move between parents), and in
# phase 4b every row holds at least this many distinct token ids
MIN_ROUTED_SHARE = 0.5
MIN_DISTINCT_PER_ROW = 4

SOURCES = {
    "fused_attention": ("vlpet_tpu_torch/csrc/attention.cu",
                        "vlpet_tpu/ops/attention.py:408"),
    "fused_ffn": ("vlpet_tpu_torch/csrc/ffn.cu", "vlpet_tpu/ops/ffn.py:240"),
    "beam_decode_attend": ("vlpet_tpu_torch/csrc/beam_attend.cu",
                           "vlpet_tpu/ops/decode.py:174"),
    "topk_lse": ("vlpet_tpu_torch/csrc/topk.cu", "vlpet_tpu/ops/topk.py:159"),
}


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = TOL[dtype] * (1.0 + want.abs())
    if not torch.isfinite(got).all() or bool((err > bound).any()):
        raise AssertionError(f"{name}: kernel disagrees with plain: max |err| "
                             f"{err.max().item():.3e} (tol {TOL[dtype]})")
    return err.max().item()


class Report:
    def __init__(self):
        self.err = {k: 0.0 for k in SOURCES}
        self.ms = {}
        self.plain_ms = {}

    def check(self, key, label, kernel_fn, plain_fn, dtype, timed=False):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = compare(f"{key} {label}", got, want, dtype)
        self.err[key] = max(self.err[key], err)
        ms = cuda_ms(kernel_fn)
        pms = cuda_ms(plain_fn)
        if timed:
            self.ms[key], self.plain_ms[key] = ms, pms
        print(f"  {key:18s} {label:38s} max|err| {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {pms:.4f} ms", flush=True)


def phase_kernels(rep: Report) -> None:
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    H, Dh = 12, 64
    inner = H * Dh

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        main = dtype == torch.bfloat16  # the bench path runs bf16
        # attention: encoder self-attention and beam cross-attention
        B, S = 500, 56
        mask = torch.where(torch.rand((B, 1, 1, S), generator=g, device=dev)
                           < 0.2, -1e9, 0.0)
        mask[..., 0] = 0.0
        k = randn(B, S, inner, dtype=dtype)
        v = randn(B, S, inner, dtype=dtype)
        for L in (56, 5):
            q = randn(B, L, inner, dtype=dtype, scale=Dh ** -0.5)
            rep.check("fused_attention", f"{tag} B{B} L{L} S{S} H{H} Dh{Dh}",
                      lambda: attention.fused_attention(q, k, v, mask, H),
                      lambda: attention.fused_attention_reference(q, k, v,
                                                                  mask, H),
                      dtype, timed=main and L == 56)
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
                      dtype, timed=main and N == 28000)
        # beam self-attend over the time-major cache
        K = J = 5
        Lc = 40
        qb = randn(B * K, 1, H, Dh, dtype=dtype, scale=Dh ** -0.5)
        kc = randn(Lc, B * J, inner, dtype=dtype)
        vc = randn(Lc, B * J, inner, dtype=dtype)
        anc = torch.randint(0, J, (B, K, Lc), generator=g, device=dev)
        for pos in (0, 13, Lc - 1):
            rep.check("beam_decode_attend",
                      f"{tag} B{B} K{K} L{Lc} pos{pos}",
                      lambda: decode.beam_decode_attend(qb, kc, vc, anc, pos),
                      lambda: decode.beam_decode_attend_reference(
                          qb, kc, vc, anc, pos),
                      dtype, timed=main and pos == Lc - 1)

    # top-k + logsumexp on f32 logits, with ties
    R, V = 2500, 50265
    cases = {
        "randn": torch.randn((R, V), generator=g, device=dev),
        # 2000 levels over 50265 entries: every top value is tied ~25 ways
        "ties": torch.randint(-1000, 1000, (R, V), generator=g,
                              device=dev).float() / 100.0,
    }
    for cname, x in cases.items():
        for kk in (1, 10, 16):
            vals, toks, lse = topk.topk_lse(x, kk)
            rv, rt, rl = topk.topk_lse_reference(x, kk)
            torch.cuda.synchronize()
            if not torch.equal(toks, rt) or not torch.equal(vals, rv):
                bad = (toks != rt).any(dim=1).nonzero()[:3].flatten().tolist()
                raise AssertionError(f"topk_lse {cname} k={kk}: indices/values "
                                     f"differ from the stable sort, rows {bad}")
            err = (lse - rl).abs()
            if bool((err > TOPK_LSE_TOL * (1 + rl.abs())).any()):
                raise AssertionError(f"topk_lse {cname} k={kk}: lse max |err| "
                                     f"{err.max().item():.3e}")
            rep.err["topk_lse"] = max(rep.err["topk_lse"], err.max().item())
            ms = cuda_ms(lambda: topk.topk_lse(x, kk))
            pms = cuda_ms(lambda: topk.topk_lse_reference(x, kk))
            if cname == "randn" and kk == 10:
                rep.ms["topk_lse"], rep.plain_ms["topk_lse"] = ms, pms
            print(f"  {'topk_lse':18s} {f'{cname} R{R} V{V} k{kk}':38s} "
                  f"indices exact, lse max|err| {err.max().item():.3e}  "
                  f"kernel {ms:.4f} ms  plain {pms:.4f} ms", flush=True)


def make_batch(B: int, vocab: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(3, vocab, (B, 20), generator=g, device="cuda")
    mask = torch.ones((B, 20), dtype=torch.long, device="cuda")
    # ragged text lengths: pad the tail of every other example
    mask[1::2, 14:] = 0
    ids = torch.where(mask.bool(), ids, 1)
    return dict(input_ids=ids, attention_mask=mask,
                vis_feats=torch.randn((B, 36, 2048), generator=g, device="cuda"),
                boxes=torch.rand((B, 36, 4), generator=g, device="cuda"))


def build_model(dtype: str):
    """BART-base + VL-PET-large at full width, the JAX package's seeded
    init scheme (normal(0, 0.02) weights)."""
    model = VLBart(flagship_cfg(dtype), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(1234))
    return model


@torch.no_grad()
def spread_weights(model: VLBart, seed: int) -> VLBart:
    """Seeded weights at the scale of tests/test_torch_slice.py: normal(0,
    0.2) everywhere, LayerNorm scales 1 + normal(0, 0.1). At the 0.02 init
    the best hypothesis of each row repeats two or three token ids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=g, device="cuda")
        p.copy_(1.0 + 0.1 * noise if name.endswith(".scale") else 0.2 * noise)
    return model


def counts():
    return {"fused_attention": attention.fused_attention,
            "fused_ffn": ffn.fused_ffn,
            "beam_decode_attend": decode.beam_decode_attend,
            "topk_lse": topk.topk_lse}


def reset_counts():
    for fn in counts().values():
        fn.launches = 0


def read_counts():
    got = {k: fn.launches for k, fn in counts().items()}
    missing = [k for k, n in got.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return got


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


def parity_run(label: str, model: VLBart, min_distinct: int) -> None:
    """Beam 5 and greedy to length 40 at B 8, through the kernels and
    through the plain twins: the tokens must be identical."""
    batch = make_batch(8, model.cfg.backbone.vocab_size, seed=7)
    ctx = PetContext(task="caption", task_idx=3)
    with torch.inference_mode():
        enc, _ = model.encode(**batch, ctx=ctx)
        with plain_twins():
            enc_plain, _ = model.encode(**batch, ctx=ctx)
    enc_rel = ((enc - enc_plain).abs().max() / enc_plain.abs().max()).item()

    def beam5():
        return seq2seq_generate(model, **batch, ctx=ctx, num_beams=5,
                                max_length=40)

    reset_counts()
    got, routed = routed_share(model, beam5)
    torch.cuda.synchronize()
    launched = read_counts()
    with plain_twins():
        want = beam5()
    if not torch.equal(got, want):
        rows = (got != want).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: fp32 beam-5 tokens differ between "
                             f"kernels and plain in rows {rows}:\n"
                             f"{got[rows]}\n{want[rows]}")
    per_row = [len(set(r)) for r in got[:, 1:].tolist()]
    if routed < MIN_ROUTED_SHARE or min(per_row) < min_distinct:
        raise AssertionError(f"{label}: degenerate beam search: routed share "
                             f"{routed:.3f} (need >= {MIN_ROUTED_SHARE}), "
                             f"distinct ids per row {per_row} (need >= "
                             f"{min_distinct}):\n{got}")
    print(f"  {label}: encoder max|kernel - plain| / max|plain| "
          f"{enc_rel:.2e}; beam5 tokens identical (kernel vs plain), "
          f"cache slots read across beams {routed:.3f}, distinct ids per "
          f"row {per_row}; launches {launched}", flush=True)
    print(f"    sample: {got[0].tolist()}", flush=True)
    # greedy: L = 1 cross-attention and k = 1 top-k through the kernels
    got = seq2seq_generate(model, **batch, ctx=ctx, num_beams=1, max_length=40)
    with plain_twins():
        want = seq2seq_generate(model, **batch, ctx=ctx, num_beams=1,
                                max_length=40)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: fp32 greedy tokens differ between "
                             f"kernels and plain")
    print(f"  {label}: greedy tokens identical (kernel vs plain)", flush=True)


def phase_parity() -> None:
    # (a) the full model at the JAX package's init scale
    parity_run("6+6 layers, init std 0.02", build_model("float32"),
               min_distinct=2)
    # (b) weights at the slice test's scale, which decode varied tokens. At
    # full depth a random model at this scale is chaotic: fp32 round-off
    # of any two summation orders grows to O(1) over the encoder layers,
    # so token parity there would test the random model, not the kernels.
    # One layer each keeps the round-off small and every kernel on the path.
    cfg = flagship_cfg("float32")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, encoder_layers=1, decoder_layers=1))
    parity_run("1+1 layers, std 0.2",
               spread_weights(VLBart(cfg, device="cuda"), seed=1234),
               min_distinct=MIN_DISTINCT_PER_ROW)


def phase_bench(card: str):
    model = build_model("bfloat16")
    V = model.cfg.backbone.vocab_size
    B = 500
    batch = make_batch(B, V, seed=11)
    ctx = PetContext(task="caption", task_idx=3)

    def run():
        return seq2seq_generate(model, **batch, ctx=ctx, num_beams=5,
                                max_length=40)

    out = run()  # warm-up: cuBLAS heuristics, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = read_counts()
    if out.shape != (B, 40) or out.dtype != torch.long:
        raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}")
    if not bool(((out >= 0) & (out < V)).all()) or not bool((out[:, 0] == 2).all()):
        raise AssertionError("token ids out of range or missing start token")
    print(f"  bf16 B{B} beam5 len40: {B / wall:.2f} examples/s, wall "
          f"{wall:.3f} s on {card}; launches {launched}", flush=True)
    if "--profile" in sys.argv:
        profile_run(run, card)
    return launched


def profile_run(run, card: str) -> None:
    """One more bench-shape generate under torch.profiler: device time by
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
    families = {"ffn_fwd": "fused_ffn kernel",
                "attention_fwd": "fused_attention kernel",
                "beam_attend": "beam_decode_attend kernel",
                "topk_lse": "topk_lse kernel", "gemm": "cuBLAS GEMMs",
                "sm90": "cuBLAS GEMMs", "cutlass": "cuBLAS GEMMs",
                "nvjet": "cuBLAS GEMMs"}
    by_family, busy = {}, 0.0
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
    print(f"  profile on {card}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}", flush=True)
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:28s} {ms:9.2f} ms  {ms / wall_ms:.3f} of wall")
    print(events.table(sort_by=key, row_limit=25, max_name_column_width=60),
          flush=True)


def main() -> int:
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

    print("phase 3: kernels vs plain", flush=True)
    rep = Report()
    phase_kernels(rep)

    print("phase 4: end-to-end parity, fp32", flush=True)
    phase_parity()

    print("phase 5: bench shape, bf16", flush=True)
    launched = phase_bench(card)

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep_,
                "launches": launched[k], "max_abs_err": rep.err[k],
                "ms": rep.ms[k], "plain_ms": rep.plain_ms[k]}
               for k, (src, rep_) in SOURCES.items()]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
