#!/usr/bin/env python3
"""Per-call times of kernels B1 (plane fold) and B6 (sweep-and-prune and its
glue) on the card, held against their plain versions first.

    python3 tools/time_b1_b6.py [--b6-only | --b1-limits [--b1-crossover]] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b1_b6.py [...] [--out FILE.json]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured.

B1: the six calls of the cube 1k decomposition (bench_decomposition_1k),
each alone: the wrapper's time (CUDA events around the call, median of 20)
and the kernel's device time (torch.profiler, per call). B6 at the inputs
of the 10k lattice's 64th step (bench_physics_10k, "auto"): the wrapper's
time, the device time of the sweep kernel (``bp_exact_kernel``) and of
everything else the call runs on the device (the glue), and the device
launches one call makes. B6 past K = 16 (``--b6-only``: these alone), at
K = 32 on the same 10k step and on the last of 30 steps of chip_smoke's
phase 30 lattice (1,000 cubes, max_neighbors 32, max_hull_verts 12, built
on the CPU and copied to the card), with the variant each tree takes
there (its device function named *bp_exact*). Before timing, every B1 call
and the degenerate cases must match the plain fold (n_verts exactly, live
slots bitwise), and B6 the plain version bitwise on the lattice step,
chip_smoke.py's seven broadphase cases and both K = 32 calls.
``--b1-limits`` times B1 alone past the shared fold's limit instead, with
the variant each tree takes there: each of the six calls of phase 30's F
= 256, S = 32 prepare (chip_smoke's ``LIMIT_FACES_CFG``, 64 cells) and
their sum, and phase 3's degenerate cases at F = 1,025, S = 8 repeated to
800 polytopes, each bit for bit (all slots) against the plain fold first;
``--b1-crossover`` adds, on a tree with the CTA variant, the largest call
of the same prepare at (max_faces, max_face_verts) where the shared fold
runs one polytope a CTA and at its last shapes of two (``CROSSOVER``),
under the shared fold and under the CTA variant.
Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def fail(msg):
    print(f"time_b1_b6: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_split(fn, kernel: str, runs: int = 20, sessions: int = 8):
    """(kernel device ms, other device ms, device launches) per call of
    ``fn`` under torch.profiler, after one warm-up call. The profiler can
    drop device records: a session counts only when it holds a whole
    number of the kernel's records a run, else it is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        k_us = o_us = 0.0
        k_n = n = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0))
            if kernel in e.key:
                k_us += us
                k_n += e.count
            else:
                o_us += us
            n += e.count
        if k_n and k_n % runs == 0:
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs
    fail(f"the profiler shows no whole session of device kernel *{kernel}*")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--b6-only", action="store_true", help="time only B6, K = 8 and K = 32")
    ap.add_argument("--b1-limits", action="store_true",
                    help="time only B1 past the shared fold's limit (F = 256, S = 32; F = 1,025)")
    ap.add_argument("--b1-crossover", action="store_true",
                    help="with --b1-limits: the shared fold against the CTA variant where the "
                         "shared fold runs one polytope a CTA")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.ops import clip_cuda
    from surtr_tpu_torch.physics import broadphase_cuda
    from surtr_tpu_torch.physics import step as phys_step

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    print(f"package {pkg}; {card}", flush=True)
    out = {"package": pkg, "card": card}

    if args.b1_limits:
        out["b1_limits"] = time_b1_limits(cs, clip_cuda, card, args.b1_crossover)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return
    if not args.b6_only:
        out["b1"] = time_b1(cs, clip_cuda, card)

    # B6: the lattice's 64th step and the broadphase cases.
    seen = {}
    orig = phys_step.broadphase_exact

    def rec(*a, **kw):
        seen["a"] = a
        return orig(*a, **kw)

    phys_step.broadphase_exact = rec
    try:
        workload.run_physics(workload.PHYSICS_STEPS, "cuda")
        torch.cuda.synchronize()
    finally:
        phys_step.broadphase_exact = orig
    a = seen["a"]
    K = workload.PHYSICS_CFG.max_neighbors
    for b in [a] + [c + (K,) for c in cs.broadphase_cases("cuda").values()]:
        cs.compare_broadphase_exact(b, {})
    torch.cuda.synchronize()
    fn = lambda: broadphase_cuda.broadphase_exact(*a)  # noqa: E731
    ms = cs.event_ms(fn)
    dev, glue, n = device_split(fn, "bp_exact_kernel")
    print(f"B6 10k lattice, step 64: wrapper {ms:.4f} ms, kernel {dev:.4f} ms and glue "
          f"{glue:.4f} ms on the device, {n:.0f} device launches a call; bitwise on 8 cases "
          f"({card})", flush=True)
    out["b6"] = {"ms": ms, "kernel_device_ms": dev, "glue_device_ms": glue, "launches": n}

    # B6 past K = 16: the same step and phase 30's lattice at K = 32.
    sc = workload.physics_lattice(cs.LIMIT_LATTICE, "cpu", cs.LIMIT_PHYSICS_CFG)
    sg = workload.to_device(sc, "cuda")
    with cs.StepRecorder() as srec:
        for _ in range(cs.LIMIT_PHYSICS_STEPS):
            sg = phys_step.physics_step(sg, cs.LIMIT_PHYSICS_CFG)
        torch.cuda.synchronize()
    k32 = {"10k lattice, step 64": a[:5], f"phase 30 lattice ({cs.LIMIT_LATTICE} cubes), step "
           f"{cs.LIMIT_PHYSICS_STEPS}": srec.last["broadphase_exact"][0][:5]}
    out["b6_k32"] = {}
    for name, b in k32.items():
        cs.compare_broadphase_exact(b + (32,), {})
        torch.cuda.synchronize()
        fn = lambda b=b: broadphase_cuda.broadphase_exact(*b, 32)  # noqa: E731
        ms = cs.event_ms(fn)
        dev, glue, n = device_split(fn, "bp_exact")
        variant = broadphase_cuda._exact_variant(32)
        print(f"B6 K = 32, {name}, Np {b[0].shape[0]}: variant {variant}; wrapper {ms:.4f} ms, "
              f"kernel {dev:.4f} ms and glue {glue:.4f} ms on the device, {n:.0f} device "
              f"launches a call; bitwise ({card})", flush=True)
        out["b6_k32"][name] = {"Np": int(b[0].shape[0]), "variant": variant, "ms": ms,
                               "kernel_device_ms": dev, "glue_device_ms": glue, "launches": n}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def time_b1(cs, clip_cuda, card):
    """B1's six decomposition calls, bitwise first."""
    calls = cs.capture_main_path_inputs()["clip_fold"]
    degen = [cs.degenerate_clip_cases("cuda")]
    full_bits = True
    for a, kw in calls + degen:
        got = clip_cuda.clip_planes_batch(*a, **kw)
        want = clip_cuda.clip_planes_batch_reference(*a, **kw)
        live = got.slot_mask()[..., None]
        if not torch.equal(got.n_verts, want.n_verts) or not torch.equal(
                torch.where(live, got.face_verts, 0.0).view(torch.int32),
                torch.where(live, want.face_verts, 0.0).view(torch.int32)):
            fail("B1 differs from the plain fold in n_verts or a live slot")
        full_bits &= torch.equal(got.face_verts.view(torch.int32),
                                 want.face_verts.view(torch.int32)) and torch.equal(
            torch.where(got.face_mask()[..., None], got.planes, 0.0),
            torch.where(want.face_mask()[..., None], want.planes, 0.0))
    torch.cuda.synchronize()
    b1 = []
    for a, kw in calls:
        fn = lambda a=a, kw=kw: clip_cuda.clip_planes_batch(*a, **kw)  # noqa: E731
        ms = cs.event_ms(fn)
        dev, other, n = device_split(fn, "clip_fold")
        shape = list(a[0].face_verts.shape[:3]) + [a[1].shape[1]]
        b1.append({"shape": shape, "ms": ms, "device_ms": dev, "launches": n})
        print(f"B1 {shape}: wrapper {ms:.4f} ms, kernel {dev:.4f} ms on the device "
              f"({n:.0f} device launches a call)", flush=True)
    total = sum(c["ms"] for c in b1)
    print(f"B1 six calls: wrapper {total:.4f} ms, kernel "
          f"{sum(c['device_ms'] for c in b1):.4f} ms on the device; bitwise in n_verts and live "
          f"slots; padding and planes bitwise too: {full_bits} ({card})", flush=True)
    return {"calls": b1, "ms": total, "device_ms": sum(c["device_ms"] for c in b1),
            "all_slots_bitwise": full_bits}


# (F, S) of the crossover runs: the shared fold's one-polytope-a-CTA shapes
# (F·(24 S + 164) > 116,224 B) at S = 32, 16 and 8, from the first of them,
# and its last shapes of two a CTA at S = 32 and 16.
CROSSOVER = [(124, 32), (125, 32), (200, 32), (249, 32), (212, 16), (213, 16), (320, 16),
             (424, 16), (327, 8), (500, 8), (652, 8)]


def full_bits(got, want) -> bool:
    """n_verts, every face vertex slot and every plane bit for bit."""
    return (torch.equal(got.n_verts, want.n_verts)
            and torch.equal(got.face_verts.view(torch.int32), want.face_verts.view(torch.int32))
            and torch.equal(got.planes.view(torch.int32), want.planes.view(torch.int32)))


def time_b1_limits(cs, clip_cuda, card, crossover: bool):
    """B1 past the shared fold's limit: the F = 256, S = 32 prepare's six
    calls and the F = 1,025, S = 8 degenerate batch, bit for bit first,
    then the wrapper's and the device's ms a call under the tree's own
    variant; with ``crossover``, the shared fold against the CTA variant
    at F = 128-249, S = 32."""
    import dataclasses
    from surtr_tpu_torch import workload

    variant = getattr(clip_cuda, "_variant", None)
    calls = cs.capture_main_path_inputs(
        lambda: workload.run_prepare("cuda", cs.LIMIT_FACES_CFG))["clip_fold"]
    (poly, planes, mask), _ = cs.degenerate_clip_cases("cuda", F=1025, S=8)
    f1025 = ((poly.map(lambda t: t.repeat((100,) + (1,) * (t.dim() - 1))),
              planes.repeat(100, 1, 1), mask.repeat(100, 1)), {})
    rows = []
    for name, (a, kw) in [(f"F = 256 prepare, call {i}", c) for i, c in enumerate(calls)] + [
            ("F = 1,025 degenerate", f1025)]:
        got = clip_cuda.clip_planes_batch(*a, **kw)
        want = clip_cuda.clip_planes_batch_reference(*a, **kw)
        torch.cuda.synchronize()
        if not full_bits(got, want):
            fail(f"B1 {name}: differs from the plain fold")
        fn = lambda a=a, kw=kw: clip_cuda.clip_planes_batch(*a, **kw)  # noqa: E731
        ms = cs.event_ms(fn)
        dev, other, n = device_split(fn, "clip_")
        N, F, S = a[0].face_verts.shape[:3]
        shape = [N, F, S, a[1].shape[1]]
        v = variant(N, F, S) if variant else "?"
        rows.append({"name": name, "shape": shape, "variant": v, "ms": ms, "device_ms": dev,
                     "other_device_ms": other, "device_launches": n})
        print(f"B1 {name} {shape}: variant {v}; wrapper {ms:.4f} ms, kernel {dev:.4f} ms on the "
              f"device in {n:.0f} device launches a call; bit for bit ({card})", flush=True)
    six = rows[:len(calls)]
    total = sum(r["device_ms"] for r in six)
    print(f"B1 F = 256, S = 32 prepare, {len(six)} calls: kernel {total:.4f} ms on the device "
          f"({card})", flush=True)
    res = {"calls": rows, "prepare_device_ms": total}
    if crossover and hasattr(clip_cuda, "cta_bytes"):
        res["crossover"] = []
        for F, S in CROSSOVER:
            cfg = dataclasses.replace(cs.LIMIT_FACES_CFG, max_faces=F, max_face_verts=S)
            fc = cs.capture_main_path_inputs(lambda: workload.run_prepare("cuda", cfg))["clip_fold"]
            a, kw = max(fc, key=lambda c: c[0][0].face_verts.shape[0] * c[0][1].shape[1])
            N = a[0].face_verts.shape[0]
            want = clip_cuda.clip_planes_batch_reference(*a, **kw)
            row = {"shape": [N, F, S, a[1].shape[1]]}
            orig = clip_cuda._variant
            for v in ("shared", "cta", "shared", "cta"):
                clip_cuda._variant = lambda *shape, _v=v: _v
                try:
                    fn = lambda a=a, kw=kw: clip_cuda.clip_planes_batch(*a, **kw)  # noqa: E731
                    got = fn()
                    torch.cuda.synchronize()
                    if not full_bits(got, want):
                        fail(f"B1 crossover F = {F} under {v}: differs from the plain fold")
                    row.setdefault(v, []).append(device_split(fn, "clip_")[0])
                finally:
                    clip_cuda._variant = orig
            res["crossover"].append(row)
            row["variant"] = orig(N, F, S)
            print(f"B1 crossover {row['shape']} ({clip_cuda.poly_bytes(F, S)} B a polytope in "
                  f"the shared fold; the tree's variant there: {row['variant']}): kernel device "
                  f"ms shared {row['shared']}, cta {row['cta']} ({card})", flush=True)
    return res


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
