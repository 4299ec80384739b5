#!/usr/bin/env python3
"""Per-call times of kernels B3 (island labels) and B4 (refit planes) on the
card, held bitwise against their plain versions first.

    python3 tools/time_b3_b4.py [--limits] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b3_b4.py [--limits] [--out FILE.json]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured. A tree whose
``_finish_pieces`` builds the refit pool and calls ``refit_planes_batch`` is
measured through that entry.

Calls: B3 and B4 as the cube 1k decomposition event (bench configuration)
and the first interactive frame (``Scene("cube", INTERACTIVE_CFG)``) call
them, plus the degenerate cases of ``chip_smoke.degenerate_cases``. Before
timing, each call must equal the plain version bit for bit (B3: every
label; B4: the plane mask and every float of the planes); the tool fails
otherwise. Per call: the wrapper's time (CUDA events around the call,
median of 20), the kernel's device time and the device time of everything
else, the device launches of one call (torch.profiler); for B3 the valid
triangles and the rounds the early exit runs (largest and mean over the
soups, beside the cap), for B4 the live points. Then the refit step of
``_finish_pieces`` on the event's and the frame's inputs: from the pool
glue (where the tree has one) to the planes, its CUDA-event ms and its
device ms and launches; on a tree with ``refit_planes_from_parts`` also
the built-pool route beside it. ``--limits`` times B3 alone past T = 1,024
instead, with the variant each tree takes there: phase 30's (64, 2,048)
call (chip_smoke's ``LIMIT_PREPARE_CFG``) and the same soups repeated to
320 (more than 264 CTAs), every label bit for bit first; on a tree with
the vertex variant also the crossover: the block kernel and the vertex
variant, each forced, in the order block, vertex, vertex, block, at T =
32, 64, 96, 128, 192, 256, 384, 512, 768 and 1,024 on the cube event's
(1,024, 64) soups, the torus config-1 event's (1,024, 128), the cube32
impact's (T = 128), and the T = 512 calls of the Scenes' prepares (the
cube's, the CLI's full preset; the torus's and the blob's) and of the
torus Scene's impact: each call's soups padded with invalid triangles
past its own T, cut to their first T triangles below it (the rows say
which). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def fail(msg):
    print(f"time_b3_b4: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_split(fn, kernel, runs=20, sessions=8):
    """(kernel device ms, other device ms, device launches) per call of
    ``fn`` under torch.profiler, after one warm-up call; ``kernel`` None
    counts every device entry as the kernel. The rule of
    ``chip_smoke.device_split``, kept here so that both trees are timed
    alike: the profiler drops device records once a process has launched
    many kernels, so a session counts as it stands only when it holds the
    kernel's records whole and no fewer records than an earlier one; else
    the fullest session's mean record times its launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
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
            if kernel is None or kernel in e.key:
                k_us += us
                k_n += e.count
            else:
                o_us += us
            n += e.count
        seen.append((k_us, k_n, o_us, n))
        if k_n and k_n % runs == 0 and n >= max(r[3] for r in seen):
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs
    k_us, k_n, o_us, n = max(seen, key=lambda r: (r[1], r[3]))
    if not k_n:
        fail(f"the profiler shows no device kernel named *{kernel}*")
    scale = -(-k_n // runs) * runs / k_n
    print(f"device_split: *{kernel}*: {k_n} records in the fullest of {len(seen)} sessions, "
          f"scaled by {scale:.3f}", flush=True)
    return k_us * scale / runs / 1e3, o_us * scale / runs / 1e3, n * scale / runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--limits", action="store_true", help="time only B3 past T = 1,024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.fracture import pipeline
    from surtr_tpu_torch.ops import labels, labels_cuda, refit_cuda
    from tools.time_b2_b7 import same_bits

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    print(f"package {pkg}; {card}", flush=True)
    out = {"package": pkg, "card": card, "calls": {}, "refit_step": {}}
    if args.limits:
        out = {"package": pkg, "card": card, "b3_limits": time_b3_limits(cs, labels_cuda, card)}
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return
    parts_entry = hasattr(refit_cuda, "refit_planes_from_parts")
    refit_attr = "refit_planes_from_parts" if parts_entry else "refit_planes_batch"

    def refit_fns(a):
        if len(a) == 4:
            return refit_cuda.refit_planes_from_parts, refit_cuda.refit_planes_from_parts_reference
        return refit_cuda.refit_planes_batch, refit_cuda.refit_planes_batch_reference

    def record(calls, name):
        """Wrap pipeline.<name> so its calls land in ``calls``; returns the
        restore function."""
        fn = getattr(pipeline, name)

        def rec(*a, **kw):
            calls.append((a, kw))
            return fn(*a, **kw)

        setattr(pipeline, name, rec)
        return lambda: setattr(pipeline, name, fn)

    # The cube event's calls and _finish_pieces inputs.
    ev = {"labels": [], "refit": [], "finish": []}
    undo = [record(ev["labels"], "tri_soup_components_batch"), record(ev["refit"], refit_attr),
            record(ev["finish"], "_finish_pieces")]
    try:
        workload.run_prepare("cuda")
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    # The first interactive frame's, after the Scene's own decomposition.
    fr = {"labels": [], "refit": [], "finish": []}
    scene = workload.interactive_scene("cuda")
    torch.cuda.synchronize()
    undo = [record(fr["labels"], "tri_soup_components_batch"), record(fr["refit"], refit_attr),
            record(fr["finish"], "_finish_pieces")]
    try:
        workload.run_frames(scene, 1)
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    degen = cs.degenerate_cases("cuda")
    sets = [("B3 labels, cube event", "labels", ev["labels"]),
            ("B3 labels, interactive frame 1", "labels", fr["labels"]),
            ("B4 refit, cube event", "refit", ev["refit"]),
            ("B4 refit, interactive frame 1", "refit", fr["refit"])]
    for title, kind in (("B3 labels", "labels"), ("B4 refit", "refit")):
        sets += [(f"{title}, degenerate case {i}", kind, [c]) for i, c in enumerate(degen[kind])]

    for title, kind, calls in sets:
        if not calls:
            fail(f"{title}: no call was recorded")
        for n, (a, kw) in enumerate(calls):
            name = title if len(calls) == 1 else f"{title}, call {n}"
            if kind == "labels":
                fn, plain = labels_cuda.tri_soup_components_batch, \
                    labels_cuda.tri_soup_components_batch_reference
                got, want = (fn(*a, **kw),), (plain(*a, **kw),)
                kname = "labels_"
                shape = list(a[0].shape[:2])
            else:
                fn, plain = refit_fns(a)
                got, want = fn(*a, **kw), plain(*a, **kw)
                kname = "refit_kernel"
                shape = ([a[0].shape[0], 3 * a[0].shape[1] + a[2].shape[1]] if len(a) == 4
                         else list(a[0].shape[:2]))
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"{name}: differs from the plain version")
            f = lambda a=a, kw=kw, fn=fn: fn(*a, **kw)  # noqa: E731
            ms = cs.event_ms(f)
            dev, other, launches = device_split(f, kname)
            row = {"shape": shape, "ms": ms, "kernel_device_ms": dev, "other_device_ms": other,
                   "device_launches": launches}
            extra = ""
            if kind == "labels":
                T = a[0].shape[1]
                row["valid_triangles"] = int(a[1].sum())
                row["round_cap"] = labels.label_rounds(T, kw.get("iters"))
                if hasattr(labels, "label_rounds_run"):
                    run = labels.label_rounds_run(a[0], a[1], iters=kw.get("iters"))
                    row["rounds_run_max"] = int(run.max())
                    row["rounds_run_mean"] = float(run.double().mean())
                    extra = (f"; {row['valid_triangles']} valid triangles, rounds run max "
                             f"{row['rounds_run_max']} mean {row['rounds_run_mean']:.3f} of "
                             f"{row['round_cap']}")
                else:
                    extra = f"; {row['valid_triangles']} valid triangles"
            else:
                row["live_points"] = (3 * int(a[1].sum()) + int(a[3].sum()) if len(a) == 4
                                      else int(a[1].sum()))
                extra = f"; {row['live_points']} live points"
            out["calls"][name] = row
            print(f"{name} {shape}: wrapper {ms:.4f} ms; kernel {dev:.4f} ms and the rest "
                  f"{other:.4f} ms on the device, {launches:.0f} device launches a call; "
                  f"bitwise{extra} ({card})", flush=True)

    # The refit step of _finish_pieces: from the pool glue to the planes.
    def parts_of(fa):
        conv, mtris, mmask, cut_planes, cut_mask = fa[:5]
        mas = fa[7]
        N = mmask.shape[0]
        cut_sel = pipeline.match_cut_faces(conv, cut_planes, cut_mask, mas)
        return mtris, mmask, conv.face_verts.reshape(N, -1, 3), \
            (conv.slot_mask() & cut_sel[..., None]).reshape(N, -1)

    def built(tris, tmask, caps, cmask):
        N = tmask.shape[0]
        pool = torch.cat([tris.reshape(N, -1, 3), caps], dim=1)
        pool_m = torch.cat([tmask.repeat_interleave(3, dim=1), cmask], dim=1)
        return refit_cuda.refit_planes_batch(pool, pool_m)

    for where, finish in (("cube event", ev["finish"]), ("interactive frame 1", fr["finish"])):
        for n, (fa, _) in enumerate(finish):
            parts = parts_of(fa)
            steps = [("pool glue + refit_planes_batch", built)]
            if parts_entry:
                steps.insert(0, ("refit_planes_from_parts", refit_cuda.refit_planes_from_parts))
            for label, step in steps:
                f = lambda step=step: step(*parts)  # noqa: E731
                ms = cs.event_ms(f)
                dev, _, launches = device_split(f, None)
                key = f"{where}, call {n}: {label}"
                out["refit_step"][key] = {"ms": ms, "device_ms": dev, "device_launches": launches}
                print(f"refit step, {key}: {ms:.4f} ms (CUDA events), {dev:.4f} ms on the device in "
                      f"{launches:.0f} device launches ({card})", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def time_b3_limits(cs, labels_cuda, card):
    """B3 past T = 1,024 under each tree's own variant, and the crossover
    of the block kernel and the vertex variant (``CROSSOVER_T``)."""
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.fracture import pipeline

    calls = []
    fn0 = pipeline.tri_soup_components_batch

    def rec(*a, **kw):
        calls.append((a, kw))
        return fn0(*a, **kw)

    pipeline.tri_soup_components_batch = rec
    try:
        workload.run_prepare("cuda", cs.LIMIT_PREPARE_CFG)
        torch.cuda.synchronize()
    finally:
        pipeline.tri_soup_components_batch = fn0
    (c, v), kw = calls[0]
    reps = -(-320 // c.shape[0])
    cases = [("phase 30 prepare", (c, v), kw),
             (f"phase 30 prepare x {reps}", (c.repeat(reps, 1, 1, 1), v.repeat(reps, 1)), kw)]

    def run(name, a, kw, forced=None):
        orig = labels_cuda._variant
        if forced:
            labels_cuda._variant = lambda T, _v=forced: _v
        try:
            f = lambda: labels_cuda.tri_soup_components_batch(*a, **kw)  # noqa: E731
            got = f()
            want = labels_cuda.tri_soup_components_batch_reference(*a, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"B3 {name}: differs from the plain version")
            ms = cs.event_ms(f)
            dev, other, n = device_split(f, "labels_")
            variant = labels_cuda._variant(a[0].shape[1])
        finally:
            labels_cuda._variant = orig
        row = {"name": name, "shape": list(a[0].shape[:2]), "variant": variant, "ms": ms,
               "device_ms": dev, "other_device_ms": other, "device_launches": n,
               "valid_triangles": int(a[1].sum())}
        print(f"B3 {name} {row['shape']}: variant {variant}; wrapper {ms:.4f} ms, kernel "
              f"{dev:.4f} ms on the device in {n:.0f} device launches a call; "
              f"{row['valid_triangles']} valid triangles; bit for bit ({card})", flush=True)
        return row

    rows = [run(name, a, kw) for name, a, kw in cases]
    if hasattr(labels_cuda, "vertex_bytes"):
        for name, (c, v), kw in crossover_calls(pipeline, workload, fn0):
            for T in CROSSOVER_T:
                a = fit_soups(c, v, T)
                how = "cut" if T < c.shape[1] else "padded" if T > c.shape[1] else "as called"
                for forced in ("block", "vertex", "vertex", "block"):
                    rows.append(run(f"{name} at T = {T} ({how}), {forced}", a, kw, forced))
                    rows[-1]["cut"] = how == "cut"
    return rows


# The crossover of B3's block kernel and vertex variant: the soup sizes
# timed under both, on the calls that reach them.
CROSSOVER_T = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def crossover_calls(pipeline, workload, fn0):
    """(name, (corners, valid), kwargs) of the labels calls at the soup
    sizes where the choice falls: the cube 1k event's (1,024, 64), the torus
    config-1 event's (1,024, 128), the cube32 impact's (T = 128), and the T
    = 512 calls of the Scenes' prepares (the cube's, as the CLI's full
    preset builds it, the torus's and the blob's, chip_smoke phases 21 and
    26) and of the torus Scene's impact."""
    calls = []

    def rec(*a, **kw):
        calls.append((a, kw))
        return fn0(*a, **kw)

    pipeline.tri_soup_components_batch = rec
    try:
        out = []
        workload.run_prepare("cuda")
        out.append(("cube event", calls[-1]))
        workload.run_prepare("cuda", workload.MODEL_1K_CFG, workload.CONCAVE_MODEL)
        out.append(("torus config 1", calls[-1]))
        n = len(calls)
        workload.run_impact("cuda")
        out += [("cube32 impact", c) for c in calls[n + 1:]]   # its prepare's call first
        for model in ("cube", "torus", "blob"):
            sc = workload.concave_scene(model, "cuda")
            out.append((f"Scene({model!r}) prepare", calls[-1]))
            if model == "torus":
                n = len(calls)
                sc.fire_impact(*workload.CONCAVE_RAYS[model])
                out += [("Scene('torus') impact", c) for c in calls[n:]]
        torch.cuda.synchronize()
    finally:
        pipeline.tri_soup_components_batch = fn0
    return [(f"{name} (N {a[0].shape[0]}, T {a[0].shape[1]})", a[:2], kw)
            for name, (a, kw) in out]


def fit_soups(c, v, T):
    """The soups cut to their first ``T`` triangles, or padded to ``T`` with
    invalid ones."""
    if T <= c.shape[1]:
        return c[:, :T].contiguous(), v[:, :T].contiguous()
    pad = T - c.shape[1]
    return (torch.cat([c, torch.zeros((c.shape[0], pad, 3, 3), device=c.device)], 1),
            torch.cat([v, torch.zeros((v.shape[0], pad), dtype=torch.bool, device=v.device)], 1))

if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
