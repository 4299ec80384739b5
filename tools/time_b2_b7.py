#!/usr/bin/env python3
"""Per-call times of kernels B2 (limited incremental hull) and B7 (pair
narrowphase) on the card, held bitwise against their plain versions first.

    python3 tools/time_b2_b7.py [--batched] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b2_b7.py [--batched] [--out FILE.json]

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
an empty kernel launched and measured the same way. Needs one NVIDIA GPU.
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
