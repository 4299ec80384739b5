#!/usr/bin/env python3
"""Per-call times of kernels B1 (plane fold) and B6 (sweep-and-prune and its
glue) on the card, held against their plain versions first.

    python3 tools/time_b1_b6.py [--b6-only] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b1_b6.py [--b6-only] [--out FILE.json]

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
chip_smoke.py's seven broadphase cases and both K = 32 calls. Needs one
NVIDIA GPU.
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


def device_split(fn, kernel: str, runs: int = 20):
    """(kernel device ms, other device ms, device launches) per call of
    ``fn`` under torch.profiler, after one warm-up call; a trace that lacks
    the kernel is taken once more."""
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
            if kernel in e.key:
                k_us += us
            else:
                o_us += us
            n += e.count
        if k_us > 0.0:
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs
    fail(f"the profiler shows no device kernel named *{kernel}*")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--b6-only", action="store_true", help="time only B6, K = 8 and K = 32")
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


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
