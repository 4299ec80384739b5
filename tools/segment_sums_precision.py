#!/usr/bin/env python3
"""How far the card and the CPU runs of the compound-body path part, with
the per-body segment sums' running sum in float32 (the port's
``step._segment_sums``, the JAX package's formulation) and in float64.

    python3 tools/segment_sums_precision.py [--n 10000] [--steps 16] [--out PATH.json]

The scene is the 10k lattice bound in pairs (``workload.paired_lattice``,
5,000 two-cube bodies at ``workload.PAIRED_CFG``), built once on the CPU and
copied to the card, so both runs start from the same bits. For each variant
the card and the CPU plain path each take ``--steps`` steps; printed (and
with --out written as JSON): max |dx|, |dv|, |dq| between the two after the
last step, whether the states are bitwise equal, and the card's name and
power limit. PyTorch's float32 ``cumsum`` accumulates in float64 on the CPU
and in float32 on the card; the float64 variant removes that difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.physics import step as phys_step  # noqa: E402


def segment_sums_f64(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """``step._segment_sums`` with the running sum in float64 and the
    difference rounded once to float32."""
    csum = torch.cumsum(vals.double(), dim=0)
    csum = torch.cat([torch.zeros_like(csum[:1]), csum])
    seg = seg_start.long()
    return (csum[seg[1:]] - csum[seg[:-1]]).to(vals.dtype)


VARIANTS = {"float32 cumsum": phys_step._segment_sums,
            "float64 running sum": segment_sums_f64}


def card_vs_cpu(start, cfg, steps: int, device: str) -> dict:
    sg = workload.to_device(start, device)
    sc = start
    for _ in range(steps):
        sg = phys_step.physics_step(sg, cfg)
        sc = phys_step.physics_step(sc, cfg)
    bg, bc = workload.to_device(sg.bodies, "cpu"), sc.bodies
    out = {f"max_abs_d{f}": float((getattr(bg, f) - getattr(bc, f)).abs().max())
           for f in ("x", "v", "q")}
    out["bitwise_equal"] = all(torch.equal(getattr(bg, f), getattr(bc, f))
                               for f in ("x", "q", "v", "w"))
    out["sleep_frames_equal"] = torch.equal(sg.sleep_frames.cpu(), sc.sleep_frames)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000, help="cubes in the lattice (even)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = workload.PAIRED_CFG
    start = workload.paired_lattice(args.n, "cpu", cfg)
    saved = phys_step._segment_sums
    result = {"card": workload.card() if args.device == "cuda" else "cpu", "n": args.n,
              "steps": args.steps, "variants": {}}
    try:
        for name, fn in VARIANTS.items():
            phys_step._segment_sums = fn
            result["variants"][name] = card_vs_cpu(start, cfg, args.steps, args.device)
            print(f"{name}: {json.dumps(result['variants'][name])}", flush=True)
    finally:
        phys_step._segment_sums = saved
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
