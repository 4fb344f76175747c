"""L1 and L2 (the port's fused dropout + add + LayerNorm, forward and
backward) on one CUDA card under other grids than ``ln_plan``'s, at the
paths' sites: bf16, D 768, rate 0.1, N 500, 5000, 28000 and 30200.

    python3 scripts/ln_grids_torch.py

Grids: "plan" (ops/fused_ln.py ln_plan: one full wave, or one row a warp
below it), "even" (the wave cut so that every warp takes the same rows),
and "r1", "r2", "r4" (one, two, four rows a warp: more blocks than a
wave). The kernels' row walk takes any grid; y, dh and dres must be
bitwise those of the plan's grid (dgamma and dbeta are summed in another
order). Each grid is timed twice, in the order plan .. r4 r4 .. plan, as
the device ms per call of every kernel of the call (chip_smoke's
torch.profiler windows of 20 calls). Imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from vlpet_tpu_torch.ops import _build  # noqa: E402
from vlpet_tpu_torch.ops import fused_ln  # noqa: E402

GRIDS = ("plan", "even", "r1", "r2", "r4")
SITES = (500, 5000, 28000, 30200)
D, RATE = 768, 0.1


def grid(name: str, plan: fused_ln.LnPlan, N: int) -> fused_ln.LnPlan:
    """``plan`` with the blocks of grid ``name``."""
    W = fused_ln.WARPS
    if name == "plan":
        return plan
    if name == "even":
        rows = -(-N // (plan.blocks * W))
        blocks = -(-N // (W * rows))
    else:
        blocks = -(-N // (W * int(name[1:])))
    return plan._replace(blocks=blocks, rows_per_warp=-(-N // (W * blocks)))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ln_grids_torch: no CUDA card")
    _build.build()
    _build.lib()
    planner = fused_ln.ln_plan
    print(chip_smoke.nvidia_smi(), flush=True)
    randn = chip_smoke.randn_fn(torch.Generator(device="cuda").manual_seed(15))
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    try:
        for N in SITES:
            h, res, dy = (randn(N, D, dtype=torch.bfloat16) for _ in range(3))
            gamma, beta = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)

            def fwd():
                return fused_ln.fused_dropout_add_ln(h, res, gamma, beta,
                                                     seed, RATE)

            def bwd():
                return fused_ln.fused_dropout_add_ln_bwd(h, res, gamma, seed,
                                                         dy, RATE)
            y0, (dh0, dres0, _, _) = fwd(), bwd()
            times = {}
            for name in GRIDS + GRIDS[::-1]:
                fused_ln.ln_plan = (lambda *a, name=name: grid(
                    name, planner(*a), a[0]))
                y, (dh, dres, _, _) = fwd(), bwd()
                assert torch.equal(y, y0) and torch.equal(dh, dh0) \
                    and torch.equal(dres, dres0), f"N {N} grid {name}"
                times.setdefault(name, []).append(
                    (sum(chip_smoke.device_by_kernel(fwd).values()),
                     chip_smoke.device_by_kernel(bwd)))
                fused_ln.ln_plan = planner
            for name in GRIDS:
                p = grid(name, planner(N, D, torch.bfloat16, True), N)
                l1 = " ".join(f"{t[0]:.4f}" for t in times[name])
                l2 = " ".join(f"{sum(t[1].values()):.4f}"
                              for t in times[name])
                split = ", ".join(f"{chip_smoke.kernel_name(k)} {v:.4f}"
                                  for k, v in times[name][0][1].items())
                print(f"N {N} grid {name:4s} blocks {p.blocks} rows a warp "
                      f"{p.rows_per_warp}: L1 {l1}; L2 {l2} ({split})",
                      flush=True)
    finally:
        fused_ln.ln_plan = planner
    return 0


if __name__ == "__main__":
    sys.exit(main())
