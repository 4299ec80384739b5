#!/usr/bin/env python3
"""Per-call times of kernels B5 (world transform and pack, with the owner
gather) and B8 (contact prep from the pair records) on the card, held
bitwise against their plain versions first.

    python3 tools/time_b5_b8.py [--limits] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b5_b8.py [--limits] [--out FILE.json]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured. A tree whose step
calls ``transform_pack`` and ``prep_contacts`` (before B5 and B8 took their
glue) is measured through those entries.

B5: the pack of the 10k lattice's 64th step (bench_physics_10k, "auto") and
of the first interactive frame's step (``Scene("cube", INTERACTIVE_CFG)``:
compound owners, Vh = 64, F = 32). B8: the prep of the 10k lattice's 64th
step. Per call: the wrapper's time (CUDA events around the step's entry,
median of 20), the kernel's device time (*pack_kernel* / *prep_kernel*),
the device time of everything else the call runs, and the device launches
of one call. Then the 10k step's pack, glue and prep stages: CUDA-event ms
(median of 10 steps) and, under torch.profiler, each stage's host events of
the CUDA API (kernel launches, copies, synchronizes). Before timing, each
call, plus the degenerate inputs ``chip_smoke.py`` builds where the tree
has them, must equal the plain version bit for bit (NaN against NaN); the
tool fails otherwise. ``--limits`` times B8 alone past the 48 KB row
instead, under the variant each tree takes there: the prep call of one
step of phase 30's 1,000-cube lattice at ``max_neighbors=32,
manifold_points=64`` (60,844 B a row), bit for bit first: the wrapper's
ms, the device ms and launches of ``*prep_*`` kernels, and the device
memory a call allocates beyond its outputs; on a tree with the wide
variant the same with its records staged ("wide") and read in place
("wide_inplace"), each forced; and B5 past 48 KB of staged rows: the pack
call of one step of the same lattice at ``max_hull_verts=768`` and at 747,
the first Vh past it at the lattice's F = 8, bit for bit first: the wrapper's ms, the device ms
and launches of ``*pack_*`` kernels under each tree's own variant, and on
a tree with the wide variant its other variants ("direct", "wide")
forced. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def fail(msg):
    print(f"time_b5_b8: FAIL: {msg}", file=sys.stderr, flush=True)
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


def same_bits(got, want) -> bool:
    """Every output tensor equal bit for bit (NaN against NaN)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return False
        diff = (g.view(torch.int32) != w.view(torch.int32)) & ~(torch.isnan(g) & torch.isnan(w))
        if bool(diff.any()):
            return False
    return len(got) == len(want)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--limits", action="store_true",
                    help="time only B8 past a 48 KB row and B5 past 48 KB of staged rows")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.physics import pack_cuda, prep_cuda
    from surtr_tpu_torch.physics import step as phys_step

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    owned = hasattr(pack_cuda, "transform_pack_owned")
    entries = ("transform_pack_owned, prep_from_records" if owned
               else "transform_pack, prep_contacts")
    print(f"package {pkg}; {card}; entries {entries}", flush=True)
    out = {"package": pkg, "card": card, "glue_in_kernels": owned}
    if args.limits:
        out["b8_limits"] = time_b8_limits(cs, workload, prep_cuda, card)
        out["b5_limits"] = time_b5_limits(cs, workload, pack_cuda, card)
        out["zero_ties"] = zero_ties(card)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return
    if owned:
        pack = (pack_cuda.transform_pack_owned, pack_cuda.transform_pack_owned_reference)
        prep = (prep_cuda.prep_from_records, prep_cuda.prep_from_records_reference)
    else:
        pack = (pack_cuda.transform_pack, pack_cuda.transform_pack_reference)
        prep = (prep_cuda.prep_contacts, prep_cuda.prep_contacts_reference)

    calls, _ = cs.physics_capture(workload.PHYSICS_STEPS)
    with cs.StepRecorder() as rec:
        scene = workload.interactive_scene("cuda")
        workload.run_frames(scene, 1)
        torch.cuda.synchronize()
    frame_pack = rec.last["pack"]
    sets = {
        "B5 pack, 10k lattice step 64": (calls["pack"], pack, "pack_kernel",
                                        getattr(cs, "pack_edge_cases", None)),
        "B5 pack, interactive frame 1": (frame_pack, pack, "pack_kernel",
                                        getattr(cs, "pack_edge_cases", None)),
        "B8 prep, 10k lattice step 64": (calls["prep"], prep, "prep_kernel",
                                        getattr(cs, "prep_edge_cases", None)),
    }
    out["calls"] = {}
    for name, (call, (fn, plain), kname, edge) in sets.items():
        a, kw = call[:2]
        cases = [(a, kw)] + (edge(call) if edge is not None else [])
        for i, (ca, ckw) in enumerate(cases):
            if not same_bits(fn(*ca, **ckw), plain(*ca, **ckw)):
                fail(f"{name}: case {i} differs from the plain version")
        torch.cuda.synchronize()
        f = lambda a=a, kw=kw, fn=fn: fn(*a, **kw)  # noqa: E731
        ms = cs.event_ms(f)
        dev, other, n = device_split(f, kname)
        row = {"ms": ms, "kernel_device_ms": dev, "other_device_ms": other,
               "device_launches": n, "bitwise_cases": len(cases),
               "shape": [int(a[0].shape[0]), *map(int, a[0].shape[1:2])]}
        out["calls"][name] = row
        print(f"{name} {row['shape']}: wrapper {ms:.4f} ms; kernel {dev:.4f} ms and the rest "
              f"{other:.4f} ms on the device, {n:.0f} device launches a call; bitwise on "
              f"{len(cases)} cases ({card})", flush=True)

    # The 10k step's stages around both kernels, from a contact-rich state.
    cfg = workload.PHYSICS_CFG
    state = workload.run_physics(workload.PHYSICS_STEPS - 1)
    torch.cuda.synchronize()
    split = cs.stage_split(state, cfg)
    out["stages_ms"] = split
    print("10k step stage split (CUDA events, ms, median of 10): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    prof = step_profile(phys_step, cs.STAGES, state, cfg,
                        {"pack": r"(?<![A-Za-z0-9_])pack_kernel", "prep": r"prep_kernel"})
    out["step_profile"] = prof
    print("10k step host events by stage (CUDA API: launch, memcpy, memset, sync): " + json.dumps(
        {k: [round(v[h], 2) for h in HOST_EVENTS] for k, v in prof["stages"].items()})
        + f"; {prof['device_entries']:.0f} device entries a step, copies on the device "
        + json.dumps(prof["device_copies"]) + "; B5 and B8 in the step: "
        + json.dumps({k: [round(v["device_ms"], 5), v["launches"]]
                      for k, v in prof["kernels"].items()}) + f" ({card})", flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def time_b8_limits(cs, workload, prep_cuda, card):
    """B8 at phase 30's K = 32, M = 64 step: each tree's own variant and,
    where the tree has them, each wide kind forced; bit for bit first."""
    import dataclasses

    cfg = dataclasses.replace(workload.PHYSICS_CFG, max_neighbors=32, manifold_points=64)
    a, kw = cs.one_step(cfg)["prep"][:2]
    own = prep_cuda._variant
    variant = own(kw["K"], kw["M"], kw["G"])
    kinds = [variant] + [v for v in getattr(prep_cuda, "VARIANTS", ())
                         if v not in ("shared", variant)]
    rows = {}
    for v in kinds:
        prep_cuda._variant = lambda *shape, _v=v: _v
        try:
            if not same_bits(prep_cuda.prep_from_records(*a, **kw),
                             prep_cuda.prep_from_records_reference(*a, **kw)):
                fail(f"B8 at K 32, M 64 ({v}): differs from the plain version")
            f = lambda: prep_cuda.prep_from_records(*a, **kw)  # noqa: E731
            ms = cs.event_ms(f)
            dev, other, n = device_split(f, "prep_")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs = f()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base - sum(
                t.numel() * t.element_size() for t in outs)
            del outs
        finally:
            prep_cuda._variant = own
        name = f"Np {a[0].shape[0]}, K 32, M 64, {v}" + ("" if v == variant else " (forced)")
        rows[name] = {"variant": v, "own": v == variant, "ms": ms, "kernel_device_ms": dev,
                      "other_device_ms": other, "device_launches": n,
                      "extra_bytes": int(extra)}
        print(f"B8 past a 48 KB row, {name}: wrapper {ms:.4f} ms; kernel {dev:.4f} ms and the "
              f"rest {other:.4f} ms on the device, {n:.0f} device launches a call; "
              f"{extra / 2 ** 20:.1f} MiB allocated beyond the outputs; bitwise ({card})",
              flush=True)
    return rows


def time_b5_limits(cs, workload, pack_cuda, card):
    """B5 at phase 30's Vh = 768 step (Np 1,000) and at chip_smoke's
    ``LIMIT_VH_FIRST`` (747), the first Vh whose staged rows pass 48 KB at
    the lattice's F = 8, Ne = 3: each tree's own variant and, where the tree
    has them, its other variants past 48 KB forced; bit for bit first."""
    import dataclasses

    own = pack_cuda._variant
    rows = {}
    for Vh in (768, getattr(cs, "LIMIT_VH_FIRST", 747)):
        a, kw = cs.one_step(dataclasses.replace(workload.PHYSICS_CFG, max_hull_verts=Vh))["pack"][:2]
        shape = (a[0].shape[1], a[2].shape[1], a[4].shape[1])
        variant = own(*shape)
        kinds = [variant] + [v for v in getattr(pack_cuda, "VARIANTS", ())
                             if v not in ("staged", variant)]
        for v in kinds:
            pack_cuda._variant = lambda *sh, _v=v: _v
            try:
                if not same_bits(pack_cuda.transform_pack_owned(*a, **kw),
                                 pack_cuda.transform_pack_owned_reference(*a, **kw)):
                    fail(f"B5 at Vh {Vh} ({v}): differs from the plain version")
                f = lambda: pack_cuda.transform_pack_owned(*a, **kw)  # noqa: E731
                ms = cs.event_ms(f)
                dev, other, n = device_split(f, "pack_")
            finally:
                pack_cuda._variant = own
            name = f"Np {a[0].shape[0]}, Vh {Vh}, {v}" + ("" if v == variant else " (forced)")
            rows[name] = {"variant": v, "own": v == variant, "ms": ms, "kernel_device_ms": dev,
                          "other_device_ms": other, "device_launches": n}
            print(f"B5 past 48 KB of staged rows, {name}: wrapper {ms:.4f} ms; kernel {dev:.4f} "
                  f"ms and the rest {other:.4f} ms on the device, {n:.0f} device launches a "
                  f"call; bitwise ({card})", flush=True)
    return rows


def zero_ties(card):
    """The sign ``torch.amin`` and ``torch.amax`` give a tie of +0 and -0 on
    the card, over dim 1 of a (4, Vh, 13) tensor of ones (minus ones for
    the maximum) with +0 at corner i and -0 at corner j: {Vh: {"i,j":
    "amin, amax"}}, "-" or "+" for the sign. The kernels' ``fminf`` /
    ``fmaxf`` give -0 and +0 in either order."""
    out = {}
    for Vh in (40, 130, 724, 768):
        res = {}
        for i, j in ((0, 1), (1, 0), (3, Vh - 1), (Vh - 1, 3), (16, 17), (17, 16)):
            t = torch.ones((4, Vh, 13), device="cuda")
            u = -t
            t[:, i], t[:, j] = 0.0, -0.0
            u[:, i], u[:, j] = 0.0, -0.0
            sign = lambda r: "-" if bool(torch.signbit(r[0, 0])) else "+"  # noqa: E731
            res[f"{i},{j}"] = f"{sign(torch.amin(t, 1))}, {sign(torch.amax(u, 1))}"
        out[Vh] = res
        print(f"torch.amin / amax of +0 at corner i and -0 at corner j, Vh {Vh}: "
              f"{json.dumps(res)} ({card})", flush=True)
    return out


# Host events of the CUDA API counted per stage, by name fragment.
HOST_EVENTS = {"launch": "LaunchKernel", "memcpy": "Memcpy", "memset": "Memset",
               "sync": "Synchronize"}


def step_profile(phys_step, stages, state, cfg, kernels=None, runs: int = 5) -> dict:
    """One step from ``state`` under torch.profiler, ``runs`` times, per step:
    per stage (``stages``, the names ``physics_step`` marks, in order, after
    "entry", the all-asleep check before the pack) the host events of the
    CUDA API (kernel launches, copies, memsets, synchronizes); the device
    entries and the device's copies by direction; and per name in
    ``kernels`` ({name: regular expression on the profiler's keys}) the
    device ms and launches."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    order = ["entry", *stages]
    cur = []

    def switch(label):
        if cur:
            cur.pop().__exit__(None, None, None)
        if label is not None:
            rf = record_function(f"stage:{label}")
            rf.__enter__()
            cur.append(rf)

    def mark(name):
        i = order.index(name)
        switch(order[i + 1] if i + 1 < len(order) else None)

    orig = phys_step._step_body

    def body(*a):
        switch("pack")
        return orig(*a)

    phys_step.physics_step(state, cfg)
    torch.cuda.synchronize()
    phys_step._step_body = body
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                switch("entry")
                phys_step.physics_step(state, cfg, mark=mark)
                switch(None)
            torch.cuda.synchronize()
    finally:
        phys_step._step_body = orig
    found = {k: [0.0, 0.0] for k in (kernels or {})}
    copies = {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0}
    entries = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        entries += e.count
        for kind in copies:
            if kind in e.key:
                copies[kind] += e.count / runs
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        for k, pat in (kernels or {}).items():
            if re.search(pat, e.key):
                found[k][0] += us / runs / 1e3
                found[k][1] += e.count / runs
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.name.split(":", 1)[1], e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("stage:")]
    per_stage = {k: dict.fromkeys(HOST_EVENTS, 0.0) for k in order}
    for e in events:
        kind = next((k for k, frag in HOST_EVENTS.items()
                     if e.name.startswith(("cuda", "cu")) and frag in e.name), None)
        if kind is None:
            continue
        for label, t0, t1 in spans:
            if t0 <= e.time_range.start < t1:
                per_stage[label][kind] += 1.0 / runs
                break
    return {"stages": per_stage, "device_entries": entries / runs, "device_copies": copies,
            "kernels": {k: {"device_ms": v[0], "launches": v[1]} for k, v in found.items()}}


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
