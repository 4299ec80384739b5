#!/usr/bin/env python3
"""Per-call times of kernels B12 (Morton-window broadphase, with its glue)
and B10 (pooled soup clip) on the card, held bitwise against their plain
versions first.

    python3 tools/time_b10_b12.py [--path-only] [--events] [--limits] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b10_b12.py [--path-only] [--events] [--limits] [--out FILE.json]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured.

Calls: B12 on the 10k lattice's last-step inputs (bench_physics_10k, as
``chip_smoke``'s phase 7 captures them; W = 32, K = 8) and on the one step
of the 66,000-cube lattice under "auto" (path (c)); B10 on the sphere 1k
decomposition's call (32,768 lanes) and the pooled cube32 impact's
(``mesh_pair_pool=True``). Unless ``--path-only``: also the degenerate
inputs of the tree's ``chip_smoke`` (``sorted_edge_cases`` or
``broadphase_cases``; ``soup_cases``). Before timing, every call must equal
the plain version bit for bit (B12: pidx and the mutual pok, filler slots
included; B10: every slot, n_vert and the drop count); the tool fails
otherwise. Per call: the wrapper's time (CUDA events around the call,
median of 20), the kernels' device time and the device time of the rest
(B12: the glue, Morton codes, ``torch.sort`` and the table; B10: the
memset, and on a tree that has them the casts and the sum), the device
launches of one call (torch.profiler); for B10 the live lanes and the live
lane x plane steps (on a tree whose plain version counts them); the plain
B10's time (CUDA events, median of 20) on the sphere's call. With
``--events``: the events around them, since the plain mesh clip of
``clip_trisoup`` (the cube decomposition, the "auto" impact) shares B10's
plain plane step: the cube and sphere 1k decompositions and the cube32
impact under both routes, each as ms/event (host clock, median of 10),
device busy ms and device entries an event (torch.profiler, 3 events), and
for the impacts the ``clip_trisoup`` stage (CUDA events). ``--limits``
times B12 alone past its warp selection's limits instead, under the variant
each tree takes there: on phase 30's inputs (the 1,000-cube lattice under
chip_smoke's ``LIMIT_PHYSICS_CFG`` after its 30 steps, the last step's
broadphase arguments) at K 32, W 32; K 8, W 256; K 32, W 1,024 and K 48, W
32, each bit for bit first: the wrapper's ms and the device ms of the
selection launch (``*select_kernel*``) and of the mutual launch, and on a
tree with the list variant the same under each of its placements forced
("list", "list_scratch"); and B10 past S = 8 on the sphere decomposition's
call at S = 16 (phase 30's), 3, 5, 32 and 40, bit for bit first: the
wrapper's ms and the fold's device ms (``*soup_fold*``) under each tree's
own variant and, on a tree with the group variant, under "group" (S <= 32)
and "general" forced. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import torch


def fail(msg):
    print(f"time_b10_b12: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path-only", action="store_true",
                    help="only the path's calls, not the degenerate cases")
    ap.add_argument("--events", action="store_true",
                    help="also time the decomposition and impact events")
    ap.add_argument("--limits", action="store_true",
                    help="time only B12 past the warp selection's limits and B10 past S = 8")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.ops import soup_clip_cuda
    from surtr_tpu_torch.physics import broadphase_cuda
    from surtr_tpu_torch.physics import step as phys_step
    from tools.time_b2_b7 import same_bits
    from tools.time_b3_b4 import device_split

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    print(f"package {pkg}; {card}", flush=True)
    out = {"package": pkg, "card": card, "calls": {}}
    if args.limits:
        out["b12_limits"] = time_b12_limits(cs, workload, broadphase_cuda, phys_step, same_bits,
                                            device_split, card)
        out["b10_limits"] = time_b10_limits(cs, workload, soup_clip_cuda, same_bits,
                                            device_split, card)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return
    # The sweep's device functions: this tree's two sweep launches, or the
    # first design's one kernel; the rest of a call is glue.
    sweep_name = "bp_sorted_sweep" if hasattr(broadphase_cuda, "_sorted_launch") \
        else "bp_sorted_kernel"

    # B12: the 10k lattice's last step, and path (c)'s 66,000-cube step.
    cfg = workload.PHYSICS_CFG
    K, W = cfg.max_neighbors, cfg.broadphase_window
    calls, _ = cs.physics_capture(workload.PHYSICS_STEPS)
    b12 = [("B12, 10k lattice last step (Np 10000)",
            tuple(calls["broadphase_exact"][0][:5]) + (K, W))]
    start = workload.physics_lattice(workload.LARGE_LATTICE_N, "cpu")
    with cs.StepRecorder() as rec, warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "auto" past MAX_EXACT_NP warns
        phys_step.physics_step(workload.to_device(start, "cuda"), cfg)
        torch.cuda.synchronize()
    if "broadphase_sorted" not in rec.last:
        fail("path (c)'s step made no B12 call")
    a, kw, _ = rec.last["broadphase_sorted"]
    b12.append(("B12, 66,000-cube step (path c, Np 66000)", tuple(a) + tuple(kw.values())))
    del start, rec

    # B10: the sphere event's call and the pooled impact's.
    sphere, _ = cs.capture("soup_clip_pooled", lambda: workload.run_prepare("cuda",
                                                                           model="sphere"))
    prepared, _ = workload.run_impact("cuda")
    pooled, _ = cs.capture("soup_clip_pooled", lambda: workload.run_impact(
        "cuda", cs.IMPACT_ROUTES["pooled"], prepared))
    b10 = [(f"B10, sphere decomposition, call {i}", a, kw) for i, (a, kw) in enumerate(sphere)]
    b10 += [(f"B10, pooled cube32 impact, call {i}", a, kw) for i, (a, kw) in enumerate(pooled)]
    if not sphere or not pooled:
        fail("the sphere event or the pooled impact made no B10 call")

    if not args.path_only:
        bcases = cs.broadphase_cases("cuda")
        if hasattr(cs, "sorted_edge_cases"):
            edge = [tuple(a) for a, _ in cs.sorted_edge_cases(bcases, K, W)]
        else:
            edge = [tuple(b) + (K, W) for b in bcases.values()]
        b12 += [(f"B12, degenerate case {i} (Np {a[0].shape[0]}, K {a[5]}, W {a[6]})", a)
                for i, a in enumerate(edge)]
        b10 += [(f"B10, degenerate case {name}", a, kw)
                for name, (a, kw) in cs.soup_cases("cuda").items()]

    for name, a in b12:
        got = broadphase_cuda.broadphase_sorted(*a)
        want = broadphase_cuda.broadphase_sorted_reference(*a)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"{name}: differs from the plain version")
        f = lambda a=a: broadphase_cuda.broadphase_sorted(*a)  # noqa: E731
        ms = cs.event_ms(f)
        dev, glue, launches = device_split(f, sweep_name)
        row = {"Np": a[0].shape[0], "K": a[5], "W": a[6], "ms": ms, "sweep_device_ms": dev,
               "glue_device_ms": glue, "device_launches": launches}
        extra = ""
        if sweep_name == "bp_sorted_sweep":        # the glue's two launches apart from the sort
            row["key_device_ms"] = device_split(f, "bp_sorted_glue_key")[0]
            row["pack_device_ms"] = device_split(f, "bp_sorted_glue_pack")[0]
            row["select_device_ms"] = device_split(f, "bp_sorted_sweep_select")[0]
            extra = (f" (codes {row['key_device_ms']:.4f} ms, table {row['pack_device_ms']:.4f} "
                     f"ms, the sort the rest; selection {row['select_device_ms']:.4f} ms of the "
                     f"sweep)")
        out["calls"][name] = row
        print(f"{name}: wrapper {ms:.4f} ms; sweep {dev:.4f} ms and glue {glue:.4f} ms{extra} on "
              f"the device, {launches:.0f} device launches a call; bitwise ({card})", flush=True)

    counts_live = "per_lane" in soup_clip_cuda.soup_clip_pooled_reference.__code__.co_varnames
    for name, a, kw in b10:
        got = soup_clip_cuda.soup_clip_pooled(*a, **kw)
        want = soup_clip_cuda.soup_clip_pooled_reference(*a, **kw)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"{name}: differs from the plain version")
        f = lambda a=a, kw=kw: soup_clip_cuda.soup_clip_pooled(*a, **kw)  # noqa: E731
        ms = cs.event_ms(f)
        dev, rest, launches = device_split(f, "soup_")
        row = {"lanes": a[0].shape[0], "planes": a[3].shape[1], "ms": ms, "kernels_device_ms": dev,
               "other_device_ms": rest, "device_launches": launches}
        extra = ""
        if counts_live:
            steps = soup_clip_cuda.soup_clip_pooled_reference(*a, per_lane=True, **kw)[3][1]
            row["live_lanes"] = int((steps > 0).sum())
            row["live_lane_planes"] = int(steps.sum())
            extra = f"; {row['live_lanes']} live lanes, {row['live_lane_planes']} lane x plane steps"
        if name.startswith("B10, sphere"):
            row["plain_ms"] = cs.event_ms(
                lambda a=a, kw=kw: soup_clip_cuda.soup_clip_pooled_reference(*a, **kw))
            extra += f"; plain version {row['plain_ms']:.3f} ms"
        out["calls"][name] = row
        print(f"{name} ({row['lanes']} lanes, K {row['planes']}): wrapper {ms:.4f} ms; kernels "
              f"{dev:.4f} ms and the rest {rest:.4f} ms on the device, {launches:.0f} device "
              f"operations a call; bitwise{extra} ({card})", flush=True)

    if args.events:
        events = {"cube 1k decomposition": (lambda: workload.run_prepare("cuda"), None),
                  "sphere 1k decomposition": (
                      lambda: workload.run_prepare("cuda", model="sphere"), None)}
        for route, rcfg in cs.IMPACT_ROUTES.items():
            events[f"cube32 impact ({route})"] = (
                lambda rcfg=rcfg: workload.run_impact("cuda", rcfg, prepared), rcfg)
        out["events"] = {}
        for name, (f, rcfg) in events.items():
            row = {"ms": cs.host_ms(f)}
            row["busy_ms"], _, _, row["device_entries"] = cs.profile_busy(f, 3)
            extra = ""
            if rcfg is not None:
                split = cs.impact_stage_split(rcfg, prepared)
                row["clip_trisoup_ms"] = split.get("clip_trisoup", 0.0)
                extra = f"; clip_trisoup stage {row['clip_trisoup_ms']:.3f} ms"
            out["events"][name] = row
            print(f"{name}: {row['ms']:.3f} ms/event; device busy {row['busy_ms']:.3f} ms in "
                  f"{row['device_entries']:.0f} device entries an event{extra} ({card})",
                  flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


LIMIT_SHAPES = ((32, 32), (8, 256), (32, 1024), (48, 32))


def time_b12_limits(cs, workload, broadphase_cuda, phys_step, same_bits, device_split, card):
    """B12 on phase 30's inputs at ``LIMIT_SHAPES``, each tree's own variant
    (and, where the tree has them, each list placement forced): bit for bit
    first, then the wrapper's ms and the selection's and mutual launch's
    device ms."""
    cfg = cs.LIMIT_PHYSICS_CFG
    scene = workload.to_device(workload.physics_lattice(cs.LIMIT_LATTICE, "cpu", cfg), "cuda")
    for _ in range(cs.LIMIT_PHYSICS_STEPS - 1):
        scene = phys_step.physics_step(scene, cfg)
    with cs.StepRecorder() as rec:
        phys_step.physics_step(scene, cfg)
        torch.cuda.synchronize()
    bp = tuple(rec.last["broadphase_exact"][0][:5])
    own = broadphase_cuda._sorted_variant
    forced = [v for v in getattr(broadphase_cuda, "SORTED_VARIANTS", ()) if v != "warp"]
    rows = {}
    for K, W in LIMIT_SHAPES:
        variant = own(K, W)
        for v in [variant] + [f for f in forced if f != variant]:
            if v == "list_scratch" and W <= broadphase_cuda.MAX_W:
                continue                      # its lists live in registers there
            broadphase_cuda._sorted_variant = lambda *shape, _v=v: _v
            try:
                a = bp + (K, W)
                got = broadphase_cuda.broadphase_sorted(*a)
                want = broadphase_cuda.broadphase_sorted_reference(*a)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    fail(f"B12 at K {K}, W {W} ({v}): differs from the plain version")
                f = lambda a=a: broadphase_cuda.broadphase_sorted(*a)  # noqa: E731
                ms = cs.event_ms(f)
                sel = device_split(f, "select_kernel")[0]
                mut = device_split(f, "sweep_mutual")[0]
            finally:
                broadphase_cuda._sorted_variant = own
            name = f"K {K}, W {W}, {v}" + ("" if v == variant else " (forced)")
            rows[name] = {"K": K, "W": W, "variant": v, "own": v == variant, "ms": ms,
                          "select_device_ms": sel, "mutual_device_ms": mut}
            print(f"B12 past the limits, Np {bp[0].shape[0]}, {name}: wrapper {ms:.4f} ms; "
                  f"selection {sel:.4f} ms and mutual {mut:.4f} ms on the device (sum "
                  f"{sel + mut:.4f}); bitwise ({card})", flush=True)
    return rows


LIMIT_SLOTS = (16, 3, 5, 32, 40)   # B10's polygon slots past S = 8: phase 30's first


def time_b10_limits(cs, workload, soup_clip_cuda, same_bits, device_split, card):
    """B10 on the sphere 1k decomposition's call (32,768 lanes) at
    ``LIMIT_SLOTS`` slots, each tree's own variant (and, where the tree has
    them, the group and general variants forced where they take S): bit
    for bit first (every slot, n_vert, the drop count), then the wrapper's
    ms and the fold's and the rest's device ms."""
    calls, _ = cs.capture("soup_clip_pooled", lambda: workload.run_prepare("cuda", model="sphere"))
    a = calls[0][0][:5]
    own = soup_clip_cuda._variant
    forced = [v for v in getattr(soup_clip_cuda, "VARIANTS", ()) if v != "warp"]
    rows = {}
    for S in LIMIT_SLOTS:
        variant = own(S)
        for v in [variant] + [f for f in forced if f != variant]:
            if v == "group" and S > soup_clip_cuda.MAX_GROUP_S:
                continue
            soup_clip_cuda._variant = lambda *shape, _v=v: _v
            try:
                got = soup_clip_cuda.soup_clip_pooled(*a, poly_slots=S)
                want = soup_clip_cuda.soup_clip_pooled_reference(*a, poly_slots=S)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    fail(f"B10 at S {S} ({v}): differs from the plain version")
                f = lambda: soup_clip_cuda.soup_clip_pooled(*a, poly_slots=S)  # noqa: E731
                ms = cs.event_ms(f)
                dev, other, n = device_split(f, "soup_fold")
            finally:
                soup_clip_cuda._variant = own
            name = f"S {S}, {v}" + ("" if v == variant else " (forced)")
            rows[name] = {"S": S, "variant": v, "own": v == variant, "ms": ms,
                          "fold_device_ms": dev, "other_device_ms": other, "device_launches": n}
            print(f"B10 past S = 8, {a[0].shape[0]} lanes by {tuple(a[3].shape)}, {name}: "
                  f"wrapper {ms:.4f} ms; fold {dev:.4f} ms and the rest {other:.4f} ms on the "
                  f"device, {n:.0f} device launches a call; bitwise ({card})", flush=True)
    return rows


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
