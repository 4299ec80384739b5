#!/usr/bin/env python3
"""Per-call times of kernels B2 (limited incremental hull) and B7 (pair
narrowphase) on the card, held bitwise against their plain versions first.

    python3 tools/time_b2_b7.py [--batched | --limits] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b2_b7.py [--batched | --limits] [...]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured.

B2: the cube's hull (the 1k decomposition's call), the sphere's
(``icosphere(2)``, 162 points) and each cloud of ``chip_smoke``'s
``degenerate_cases``; B2's batched entry (``ich_batch``) on the refit pools
of the cube 1k event at refitting_point_limit 8 and 20 and of the torus
config-1 event at 20, and on the pool of the cube at limit 64 with
max_piece_tris 2048 (F = 132: the general variant), each recorded from
its event on the card (``--batched``: these four calls alone). B7: the narrowphase of the 10k lattice's 64th step
(bench_physics_10k, "auto"; Vh = 8) and of the first interactive frame's
step (``Scene("cube", INTERACTIVE_CFG)``: Vh = 64, F = 32), plus the
degenerate inputs ``chip_smoke`` builds where the tree has them. Before
timing, every call must equal the plain version bit for bit (B2: face
slots, face_valid, normals, inner; B7: every record, NaN against NaN); the
tool fails otherwise. Per call: the wrapper's time (CUDA events around the
call, median of 20), the kernel's device time and the device launches of
one call (torch.profiler), and, as B2's latency floor, the device time of
an empty kernel launched and measured the same way.

``--limits`` (these alone): B7 past the staged kernel's shapes at
chip_smoke phase 30's: the narrowphase of the 30th step of its 1,000-cube
lattice (max_neighbors 32, max_hull_verts 12: (Np, K) (1,000, 32), Vh 12,
F 26, M 4) and of one step at max_hull_verts 768 and at max_neighbors 32,
manifold_points 64 (Vh 8, records of 389 floats). Each under the variant
the tree takes there and, on a tree that names its variants
(``narrowphase_cuda.VARIANTS``), under each other variant past the staged
kernel, forced by replacing ``narrowphase_cuda._variant``: bit for bit
against the plain version first (NaN against NaN; the lattice's call also
on ``chip_smoke.narrowphase_edge_cases``), then the wrapper's time, the
device time of the kernels named *narrow_* and of the rest of the call,
and the device launches of one call. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def fail(msg):
    print(f"time_b2_b7: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_split(fn, kernel, runs: int = 20):
    """(kernel device ms, other device ms, device launches) per call of
    ``fn`` under torch.profiler, after one warm-up call: the entries whose
    name holds ``kernel`` (a name fragment or a tuple of them); ``kernel``
    None counts every device entry as the kernel. A trace that lacks the
    kernel is taken once more."""
    frags = (kernel,) if isinstance(kernel, str) else kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        k_us = o_us = n = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0))
            if frags is None or any(f in e.key for f in frags):
                k_us += us
            else:
                o_us += us
            n += e.count
        if k_us > 0.0:
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs
    fail(f"the profiler shows no device kernel named *{kernel}*")


def same_bits(got, want) -> bool:
    """Every output tensor equal bit for bit (NaN against NaN)."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        if g.dtype.is_floating_point:
            diff = (g.view(torch.int32) != w.view(torch.int32)) & ~(torch.isnan(g) & torch.isnan(w))
        else:
            diff = g != w
        if bool(diff.any()):
            return False
    return len(got) == len(want)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--batched", action="store_true",
                    help="time only the batched B2 calls (the refit pools and F = 132)")
    ap.add_argument("--limits", action="store_true",
                    help="time only B7 past the staged kernel's shapes at phase 30's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.ops import hull_cuda

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    print(f"package {pkg}; {card}", flush=True)
    out = {"package": pkg, "card": card, "calls": {}}
    if args.limits:
        out["b7_limits"] = b7_limits(cs, workload, card)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return

    # An empty kernel's device time: the least a launch shows on the device.
    torch.cuda._sleep(0)
    floor, _, _ = device_split(lambda: torch.cuda._sleep(0), None)
    out["empty_kernel_device_ms"] = floor
    print(f"empty kernel: {floor:.4f} ms on the device ({card})", flush=True)

    def ich_fields(r):
        return (r["faces"], r["face_valid"], r["normals"], r["inner"])

    # The batched entry on the refit pools, each recorded from its event.
    b2_batch = []
    for model, cfg, limit in (("cube", workload.BENCH_CFG, 8), ("cube", workload.BENCH_CFG, 20),
                              (cs.CONCAVE_MODEL, cs.CONCAVE_CFG, 20)):
        rec, _ = cs.capture("ich_batch",
                            lambda: cs.run_prepare("cuda", cs.refit_cfg(cfg, limit), model))
        b2_batch.append((f"B2 ich_batch, {model} refit limit {limit}", rec[0]))
    rec, _ = cs.capture("ich_batch", lambda: cs.run_prepare("cuda", cs.LIMIT_PREPARE_CFG))
    b2_batch.append(("B2 ich_batch, cube refit limit 64, max_piece_tris 2048 (F = 132)", rec[0]))
    # Every B2 kernel of either tree (ich_kernel; ich_warp_set_kernel;
    # ich_general_kernel), but not the wrapper's other device work.
    b2_kernels = ("ich_kernel", "ich_warp_set_kernel", "ich_general_kernel")
    sets = [(name, call, hull_cuda.ich_batch, hull_cuda.ich_batch_reference, ich_fields,
             b2_kernels, []) for name, call in b2_batch]
    if not args.batched:
        sets += b2_b7_sets(cs, workload, hull_cuda, ich_fields)
    for name, call, fn, plain, fields, kname, extra in sets:
        a, kw = call[:2]
        for i, (ca, ckw) in enumerate([(a, kw)] + extra):
            if not same_bits(fields(fn(*ca, **ckw)), fields(plain(*ca, **ckw))):
                fail(f"{name}: case {i} differs from the plain version")
        torch.cuda.synchronize()
        f = lambda a=a, kw=kw, fn=fn: fn(*a, **kw)  # noqa: E731
        ms = cs.event_ms(f)
        dev, other, n = device_split(f, kname)
        shape = list(a[0].shape) if fn in (hull_cuda.ich, hull_cuda.ich_batch) else [
            *a[1].shape, a[3], a[4]]
        row = {"ms": ms, "kernel_device_ms": dev, "other_device_ms": other,
               "device_launches": n, "bitwise_cases": 1 + len(extra), "shape": shape}
        what = ""
        if fn is hull_cuda.ich_batch and hasattr(hull_cuda, "KERNEL_NAME"):
            row["variant"] = hull_cuda._variant(*shape[:2], hull_cuda._faces(kw["limit"], None))
            what = f" ({row['variant']} variant)"
        out["calls"][name] = row
        print(f"{name} {shape}{what}: wrapper {ms:.4f} ms; kernel {dev:.4f} ms and the rest "
              f"{other:.4f} ms on the device, {n:.0f} device launches a call; bitwise on "
              f"{1 + len(extra)} cases ({card})", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def b7_limits(cs, workload, card):
    """B7 past the staged kernel's shapes (the module docstring): {case:
    {variant: times}}."""
    import dataclasses

    from surtr_tpu_torch.physics import narrowphase_cuda
    from surtr_tpu_torch.physics import step as phys_step

    cfg = cs.LIMIT_PHYSICS_CFG
    scene = workload.physics_lattice(cs.LIMIT_LATTICE, "cuda", cfg)
    for _ in range(cs.LIMIT_PHYSICS_STEPS - 1):
        scene = phys_step.physics_step(scene, cfg)
    with cs.StepRecorder() as rec:
        phys_step.physics_step(scene, cfg)
        torch.cuda.synchronize()
    lattice = rec.last["narrowphase"][:2]
    base = workload.PHYSICS_CFG
    v768 = cs.one_step(dataclasses.replace(base, max_hull_verts=768))["narrowphase"][:2]
    m64 = cs.one_step(dataclasses.replace(base, max_neighbors=32, manifold_points=64))
    cases = {"(Np, K) (1000, 32), Vh 12, M 4": (lattice, cs.narrowphase_edge_cases(lattice)),
             "Np 1000, Vh 768": (v768, []),
             "(Np, K) (1000, 32), Vh 8, M 64": (m64["narrowphase"][:2], [])}
    own_fn = narrowphase_cuda._variant
    past = [v for v in getattr(narrowphase_cuda, "VARIANTS", ()) if v != "staged"]
    fn, ref = narrowphase_cuda.narrowphase, narrowphase_cuda.narrowphase_reference
    res = {}
    try:
        for name, ((a, kw), edge) in cases.items():
            own = own_fn(a[3], a[1].shape[1], a[4], a[5], a[6])
            res[name] = {}
            for v in [own] + [v for v in past if v != own]:
                narrowphase_cuda._variant = lambda *shape, _v=v: _v
                for i, (ca, _) in enumerate([(a, kw)] + edge):
                    if not same_bits((fn(*ca),), (ref(*ca),)):
                        fail(f"B7 {name}, variant {v}: case {i} differs from the plain version")
                call = lambda a=a: fn(*a)  # noqa: E731
                ms = cs.event_ms(call)
                dev, other, n = device_split(call, "narrow_")
                narrowphase_cuda._variant = own_fn
                res[name][v] = {"own": v == own, "ms": ms, "kernel_device_ms": dev,
                                "other_device_ms": other, "device_launches": n,
                                "bitwise_cases": 1 + len(edge)}
                print(f"B7 {name}, variant {v}{'' if v == own else ' (forced)'}: wrapper "
                      f"{ms:.4f} ms; kernel {dev:.4f} ms and the rest {other:.4f} ms on the "
                      f"device, {n:.0f} device launches a call; bitwise on {1 + len(edge)} "
                      f"cases ({card})", flush=True)
    finally:
        narrowphase_cuda._variant = own_fn
    return res


def b2_b7_sets(cs, workload, hull_cuda, ich_fields):
    """The one-set B2 calls and the B7 calls, as (name, call, kernel, plain,
    fields, device name, extra cases)."""
    from surtr_tpu_torch.physics import narrowphase_cuda

    cube = cs.capture_main_path_inputs()["ich"][0]
    pts, mask = workload.model_inputs("sphere", "cuda")[:2]
    sphere = ((pts, mask), dict(cube[1]))
    degen = cs.degenerate_cases("cuda")["ich"]
    b2 = [("B2 ich, cube", cube), ("B2 ich, sphere", sphere)]
    b2 += [(f"B2 ich, degenerate cloud {i} ({c[0][0].shape[0]} points, limit "
            f"{c[1].get('limit')})", c) for i, c in enumerate(degen)]

    calls, _ = cs.physics_capture(workload.PHYSICS_STEPS)
    with cs.StepRecorder() as rec:
        scene = workload.interactive_scene("cuda")
        workload.run_frames(scene, 1)
        torch.cuda.synchronize()
    edge = getattr(cs, "narrowphase_edge_cases", lambda call: [])
    b7 = [("B7 narrowphase, 10k lattice step 64", calls["narrowphase"]),
          ("B7 narrowphase, interactive frame 1", rec.last["narrowphase"])]

    sets = [(name, call, hull_cuda.ich, hull_cuda.ich_reference, ich_fields, "ich_kernel", [])
            for name, call in b2]
    dnar = cs.degenerate_physics_scene("cuda")[1]    # rotated boxes, a dead partner
    sets += [(name, call, narrowphase_cuda.narrowphase, narrowphase_cuda.narrowphase_reference,
              lambda r: (r,), "narrow_kernel", edge(call) + (dnar if i == 0 else []))
             for i, (name, call) in enumerate(b7)]
    return sets


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
