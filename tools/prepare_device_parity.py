#!/usr/bin/env python3
"""Where the card's decomposition parts from the CPU plain run's (the
PyTorch/CUDA port, one GPU).

    python3 tools/prepare_device_parity.py [--model torus] [--cells N] [--out PATH.json]

One ``prepare_fracture`` of ``--model`` at BASELINE config 1's
configuration (``workload.MODEL_1K_CFG``; ``--cells`` sets C and P) runs
on the CPU with every stage function of the pipeline recorded (the ICH,
the folds, the cell planes, the mesh clip and its pooled fold, the parity
grid, the island split and labels, the finish with its caps and refit,
the pack), and each recorded call is replayed on the card with the CPU's
inputs: printed per call is "equal" or the outputs that differ (entries
and largest difference). The whole event is then run on both devices and
its metrics printed side by side. With --out the results are written as
JSON, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.fracture import pipeline  # noqa: E402
from tools.frame_device_parity import differences, to  # noqa: E402

STAGES = ("ich", "clip_planes_batch", "_cell_plane_sets", "_two_pass_cell_clip",
          "_active_planes", "_culled_pair_pool_clip", "clip_trisoup", "soup_clip_pooled",
          "clip_polys_by_rows", "build_parity_grid", "_split_mesh_islands",
          "tri_soup_components_batch", "_finish_pieces", "cap_fans_batch",
          "refit_planes_from_parts", "_append_tris", "_pack_candidates")


def replay_stages(model, cfg):
    """Each stage call of the CPU run replayed on the card. The CPU's
    ``clip_polys_by_rows`` (per-cell context) has no card counterpart to
    replay; ``_culled_pair_pool_clip`` replayed runs kernel B10 (per-block
    context) against it."""
    calls, saved = [], []
    for name in STAGES:
        fn = getattr(pipeline, name)
        saved.append((name, fn))

        def rec(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            calls.append((_name, _fn, to(a, "cpu"), to(kw, "cpu"), to(out, "cpu")))
            return out

        setattr(pipeline, name, rec)
    try:
        workload.run_prepare("cpu", cfg, model)
    finally:
        for name, fn in saved:
            setattr(pipeline, name, fn)
    res = []
    for name, fn, a, kw, want in calls:
        if name == "clip_polys_by_rows":
            continue
        got = fn(*to(a, "cuda"), **to(kw, "cuda"))
        torch.cuda.synchronize()
        d = differences(got, want)
        res.append({"call": name, "differences": d})
        print(f"{name}: " + ("equal" if not d else json.dumps(d[:6])), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=workload.CONCAVE_MODEL)
    ap.add_argument("--cells", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prepare_device_parity: needs a CUDA device")
    cfg = workload.MODEL_1K_CFG
    if args.cells:
        cfg = dataclasses.replace(cfg, initial_decompose_cell_cnt=args.cells,
                                  max_pieces=args.cells)
    card = workload.card()
    print(card, flush=True)
    result = {"card": card, "model": args.model, "cells": cfg.initial_decompose_cell_cnt,
              "stages": replay_stages(args.model, cfg)}
    for dev in ("cuda", "cpu"):
        met = workload.run_prepare(dev, cfg, args.model)[2]
        result[dev] = {k: float(v) for k, v in met.items()}
        print(f"{dev}: {json.dumps(result[dev])}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
