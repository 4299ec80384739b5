#!/usr/bin/env python3
"""Where the card's interactive frames part from the CPU plain run's (the
PyTorch/CUDA port, one GPU).

    python3 tools/frame_device_parity.py [--frames 4] [--out PATH.json]

``Scene("cube", INTERACTIVE_CFG)`` is built once on the CPU. Its first frame
runs on the CPU; the second runs on the CPU with every stage function of the
frame recorded (the raycast, overlap, bake, ``do_fracture`` and its stages,
the rebuild, the physics step), and each recorded call is replayed on the
card with the CPU's inputs: printed per call is "equal" or the outputs that
differ (count and largest difference). Then ``--frames`` chained frames run
on both devices from the CPU-built start, and after each the pieces'
valid/group/tag equality and the largest body x difference are printed.
With --out the results are written as JSON, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import scene as scene_mod  # noqa: E402
from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.fracture import pipeline  # noqa: E402

STAGES = [(pipeline, n) for n in (
    "convex_out_of_sphere", "clip_planes_batch", "clip_trisoup", "_split_mesh_islands",
    "_finish_pieces", "_pack_candidates", "split_groups_by_contact", "moments",
    "tri_soup_components_batch", "refit_planes_from_parts", "_dense_renumber")]
STAGES += [(scene_mod, n) for n in (
    "raycast", "sphere_overlap", "_bake_pieces", "do_fracture", "build_scene",
    "_transfer_velocities", "physics_step")]


def to(obj, dev):
    """``obj`` (tensors in tuples, dicts and dataclasses) on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: to(v, dev) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        if any(isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v)
               for v in fields.values()):
            return dataclasses.replace(obj, **{k: to(v, dev) for k, v in fields.items()})
    return obj


def leaves(obj, name=""):
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif isinstance(obj, (list, tuple)):
        for i, o in enumerate(obj):
            yield from leaves(o, f"{name}[{i}]")
    elif isinstance(obj, dict):
        for k, o in obj.items():
            yield from leaves(o, f"{name}.{k}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{name}.{f.name}")


def differences(got, want):
    """[(leaf, entries that differ, largest difference)] of two outputs."""
    out = []
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        g = g.cpu()
        if g.dtype.is_floating_point:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            if not bool(same.all()):
                out.append((name, int((~same).sum()), float((g - w).abs().nan_to_num().max())))
        elif not torch.equal(g, w):
            out.append((name, int((g != w).sum()), None))
    return out


def replay_stages(start):
    """Each stage call of the CPU run's second frame replayed on the card."""
    sc = workload.scene_to(start, "cpu")
    workload.run_frames(sc, 1)
    calls, saved = [], []
    for mod, name in STAGES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            calls.append((_name, _fn, to(a, "cpu"), to(kw, "cpu"), to(out, "cpu")))
            return out

        setattr(mod, name, rec)
    try:
        workload.run_frames(sc, 1)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    res = []
    for name, fn, a, kw, want in calls:
        got = fn(*to(a, "cuda"), **to(kw, "cuda"))
        torch.cuda.synchronize()
        d = differences(got, want)
        res.append({"call": name, "differences": d})
        print(f"{name}: " + ("equal" if not d else json.dumps(d[:6])), flush=True)
    return res


def chained(start, frames: int):
    """Chained frames on both devices from the same start."""
    g, c = workload.scene_to(start, "cuda"), workload.scene_to(start, "cpu")
    res = []
    for i in range(frames):
        workload.run_frames(g, 1)
        workload.run_frames(c, 1)
        torch.cuda.synchronize()
        same = {k: torch.equal(getattr(g.pieces, k).cpu(), getattr(c.pieces, k))
                for k in ("valid", "group", "tag")}
        dx = (float((g.phys.bodies.x.cpu() - c.phys.bodies.x).abs().max())
              if all(same.values()) else None)
        res.append({"frame": i, "pieces_equal": same, "max_dx": dx})
        print(f"chained frame {i}: pieces equal {same}, body x {dx}", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("frame_device_parity: needs a CUDA device")
    card = workload.card()
    print(card, flush=True)
    start = workload.interactive_scene("cpu")
    result = {"card": card, "stages": replay_stages(start),
              "chained": chained(start, args.frames)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
