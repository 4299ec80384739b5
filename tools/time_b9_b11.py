#!/usr/bin/env python3
"""Per-call times of kernels B9 (the contact solver's iterations) and B11
(tiled z-buffer raster, with its glue) on the card, held against their plain
versions first.

    python3 tools/time_b9_b11.py [--shadow-maps | --limits] [--out FILE.json]
    PYTHONPATH=<other checkout> python3 tools/time_b9_b11.py [--shadow-maps | --limits] [...]

The second form measures another checkout's ``surtr_tpu_torch`` (and uses
its ``chip_smoke.py`` helpers), so two trees can be compared in one session
on one card. It prints the package path it measured.

B9: the solve of the 10k lattice's 64th step (bench_physics_10k, "auto")
and the accumulated-mode solve of the warm-start lattice's 32nd step: the
wrapper's time (CUDA events around ``solve`` / ``solve_warm``, median of
20), the device time of the kernels named *solver_* and of everything else
the call runs on the device, and the device launches of one solve. B11: the
first interactive frame's two calls (shadow and camera, ``Scene("cube",
INTERACTIVE_CFG)``) and render_512's at shadow 512 and 1024: per call the
wrapper's time (``rasterize_ids_tiled``: glue and kernel), the device time
of the kernel (*raster_kernel*) and of the rest of the call (the glue), the
call's device launches, and the live (tile, chunk) pairs with the most in
one tile. Before timing, both solves must match the plain version (bitwise
equality is printed; the tool fails beyond 1e-5 x (1 + |v|)), and B11's
kernel its plain version bitwise on every call's table.

``--shadow-maps`` (these alone): B11's raster (``tile_raster`` on the
packed table, no glue) of the shadow map of render_512's 4,096 triangles
at 512², 1,024², 2,048², 4,096² and 8,192² (128 to 32,768 tiles) and of
its first 512 triangles at 8,192² (``--sizes`` names other sizes for the
4,096 triangles), under each variant the tree has that
takes the screen (the resident kernel up to 10,239 tiles; the variant past
it at every size), each chosen by replacing ``raster_cuda._variant``: per
variant bit for bit against the plain version, then the wrapper's time,
the device time of the raster kernel (*raster_kernel*) and of the rest of
the call (the key scratch's memsets or the offsets' launches), and its
device launches.

``--limits`` (these alone): B9 past K = 16 at chip_smoke phase 30's shapes:
the solve of the 30th step of its 1,000-cube lattice (max_neighbors 32,
max_hull_verts 12: K 32, C 132) in both modes (the accumulated mode on
seeded totals), the solve of one step at max_neighbors 32,
manifold_points 64 (C 2,052) and the lattice's solve on 24 copies of it
(24,000 rows, more than the cooperative grid holds). Each under the
variant the tree takes there and, on a tree that names its variants
(``solver_cuda.VARIANTS``), under each other variant past K = 16, forced
by replacing ``solver_cuda._variant``: bit for bit against the plain
version first (NaN against NaN), then the wrapper's time, the device time
of the kernels named *solver_* and of the rest of the call, and the device
launches of one solve; then, under the tree's own variant, the lattice's
solve at (iterations, substeps) (1, 1), (2, 2), (8, 8), (4, 1) and (8, 2),
and from their device times the cost of a substep (8, 8 against 1, 1),
of an iteration beside its substeps (4, 1 against 1, 1) and of the rest
(a launch of one substep less that substep). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def fail(msg):
    print(f"time_b9_b11: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_split(fn, kernel: str, runs: int = 20):
    """(kernel device ms, other device ms, device launches, kernel launches)
    per call of ``fn`` under torch.profiler, after one warm-up call; a trace
    that lacks the kernel is taken once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        k_us = o_us = n = nk = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0))
            if kernel in e.key:
                k_us += us
                nk += e.count
            else:
                o_us += us
            n += e.count
        if k_us > 0.0:
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs, nk / runs
    fail(f"the profiler shows no device kernel named *{kernel}*")


def capture(mod, attr, fn):
    """The (args, kwargs) of every call ``fn`` makes to ``mod.attr``."""
    calls = []
    orig = getattr(mod, attr)

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    setattr(mod, attr, rec)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        setattr(mod, attr, orig)
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--shadow-maps", action="store_true",
                    help="time only B11's variants on render_512's shadow maps, 512² to 8,192²")
    ap.add_argument("--limits", action="store_true",
                    help="time only B9 past K = 16 at chip_smoke phase 30's shapes")
    ap.add_argument("--sizes", default=",".join(map(str, SHADOW_SIZES)),
                    help="with --shadow-maps: the shadow map sizes (comma-separated)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this tool needs an NVIDIA GPU")
    import chip_smoke as cs
    import surtr_tpu_torch
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.physics import solver_cuda
    from surtr_tpu_torch.physics import step as phys_step
    from surtr_tpu_torch.render import raster as render_raster
    from surtr_tpu_torch.render import raster_cuda

    pkg = os.path.dirname(os.path.abspath(surtr_tpu_torch.__file__))
    card = workload.card()
    print(f"package {pkg}; {card}", flush=True)
    out = {"package": pkg, "card": card}
    if args.shadow_maps or args.limits:
        if args.limits:
            out["b9_limits"] = b9_limits(cs, workload, solver_cuda, phys_step, card)
        else:
            sizes = tuple(int(x) for x in args.sizes.split(","))
            out["b11_shadow_maps"] = shadow_maps(cs, raster_cuda, render_raster, workload, card,
                                                 sizes)
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return

    # B9: the main path's solve and the warm-start path's.
    solves = {
        "solve, 10k lattice step 64": (
            capture(phys_step, "solve", lambda: workload.run_physics(workload.PHYSICS_STEPS))[-1],
            solver_cuda.solve, solver_cuda.solve_reference),
        "solve_warm, warm lattice step 32": (
            capture(phys_step, "solve_warm",
                    lambda: workload.run_physics(32, cfg=workload.WARM_CFG))[-1],
            solver_cuda.solve_warm, solver_cuda.solve_warm_reference),
    }
    out["b9"] = {}
    for name, ((a, kw), fn, plain) in solves.items():
        got, want = (o if isinstance(o, tuple) else (o,) for o in (fn(*a, **kw), plain(*a, **kw)))
        bitwise = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want))
        if not all(bool(((g - w).abs() <= 1e-5 * (1 + w.abs())).all()) for g, w in zip(got, want)):
            fail(f"B9 {name}: differs from the plain version beyond 1e-5 x (1 + |v|)")
        call = lambda a=a, kw=kw, fn=fn: fn(*a, **kw)  # noqa: E731
        ms = cs.event_ms(call)
        dev, other, n, nk = device_split(call, "solver_")
        S = max(1, kw["substeps"])
        outer = (kw["iters"] + S - 1) // S
        out["b9"][name] = {"ms": ms, "kernel_device_ms": dev, "other_device_ms": other,
                           "device_launches": n, "kernel_launches": nk, "iterations": outer,
                           "bitwise": bitwise, "Np": int(a[0].shape[0])}
        print(f"B9 {name}: wrapper {ms:.4f} ms; kernel {dev:.4f} ms on the device in {nk:.0f} "
              f"launches for {outer} iterations, {other:.4f} ms beside it; {n:.0f} device "
              f"launches a solve; bitwise {bitwise} ({card})", flush=True)

    # B11: the frame's first two calls and render_512's.
    scene = workload.interactive_scene("cuda")
    sets = {"interactive frame": capture(render_raster, "rasterize_ids_tiled",
                                         lambda: workload.run_frames(scene, 1))}
    inputs = workload.render_512_inputs("cuda")
    for shadow in (512, 1024):
        sets[f"render_512, shadow {shadow}"] = capture(
            render_raster, "rasterize_ids_tiled",
            lambda s=shadow: workload.run_render_512("cuda", s, inputs))
    out["b11"] = {}
    for name, calls in sets.items():
        rows = []
        for a, kw in calls:
            attrs, bbox, rng, _, (nty, ntx) = raster_cuda._tile_table(*a, **kw)
            W, H = a[4], a[5]
            A = attrs.shape[1] - 10
            tab = (attrs, bbox, rng, nty, ntx, H, W, A)
            for g, w in zip(raster_cuda.tile_raster(*tab), raster_cuda.tile_raster_reference(*tab)):
                if (g is None) != (w is None) or (g is not None and not torch.equal(
                        cs._bits(g), cs._bits(w))):
                    fail(f"B11 {name}: the kernel differs from its plain version")
            tiles, _ = raster_cuda._chunk_pairs(bbox, rng, nty, ntx)
            call = lambda a=a, kw=kw: raster_cuda.rasterize_ids_tiled(*a, **kw)  # noqa: E731
            ms = cs.event_ms(call)
            dev, glue, n, nk = device_split(call, "raster_kernel")
            row = {"shape": [int(attrs.shape[0]), A, H, W], "ms": ms, "kernel_device_ms": dev,
                   "glue_device_ms": glue, "device_launches": n, "kernel_launches": nk,
                   "live_pairs": int(tiles.numel()),
                   "max_tile_pairs": int(torch.bincount(tiles).max()) if tiles.numel() else 0}
            rows.append(row)
            print(f"B11 {name} [T_pad, A, H, W] {row['shape']}: wrapper {ms:.4f} ms; kernel "
                  f"{dev:.4f} ms and the rest {glue:.4f} ms on the device, {n:.0f} device "
                  f"launches; {row['live_pairs']} live pairs, {row['max_tile_pairs']} in the "
                  f"densest tile ({card})", flush=True)
        tot = {k: sum(r[k] for r in rows) for k in ("ms", "kernel_device_ms", "glue_device_ms",
                                                    "device_launches")}
        out["b11"][name] = {"calls": rows, **tot}
        print(f"B11 {name}, {len(rows)} calls: wrapper {tot['ms']:.4f} ms, kernel "
              f"{tot['kernel_device_ms']:.4f} ms and glue {tot['glue_device_ms']:.4f} ms on the "
              f"device, {tot['device_launches']:.0f} device launches; kernel bitwise ({card})",
              flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def warm_case(call, seed: int = 30):
    """The accumulated mode on a plain-mode solve's inputs: seeded totals
    [λn | λu | λv] (λn >= 0; 0 on the slots without a hit)."""
    (vw0, pb, tables), kw = call[0][:3], call[1]
    C = kw["K"] * kw["M"] + kw["G"]
    Np = vw0.shape[0]
    g = torch.Generator().manual_seed(seed)
    hit = tables[4][:, :C].cpu()
    lam = torch.cat([0.05 * torch.rand((Np, C), generator=g) * hit,
                     0.02 * torch.randn((Np, C), generator=g) * hit,
                     0.02 * torch.randn((Np, C), generator=g) * hit], dim=1)
    return (vw0, lam.to(vw0.device), pb, tables), dict(kw)


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


def b9_limits(cs, workload, solver_cuda, phys_step, card):
    """B9 past K = 16 (the module docstring): {case: {variant: times}}."""
    import dataclasses

    cfg = cs.LIMIT_PHYSICS_CFG
    scene = workload.physics_lattice(cs.LIMIT_LATTICE, "cuda", cfg)
    for _ in range(cs.LIMIT_PHYSICS_STEPS - 1):
        scene = phys_step.physics_step(scene, cfg)
    calls = capture(phys_step, "solve", lambda: phys_step.physics_step(scene, cfg))
    lattice = calls[-1]
    m64 = cs.one_step(dataclasses.replace(workload.PHYSICS_CFG, max_neighbors=32,
                                          manifold_points=64))["solver"][:2]
    plain = (solver_cuda.solve, solver_cuda.solve_reference)
    warm = (solver_cuda.solve_warm, solver_cuda.solve_warm_reference)
    Np = lattice[0][0].shape[0]
    cases = {f"Np {Np}, K 32, C 132": (lattice, *plain),
             f"Np {Np}, K 32, C 132, warm": (warm_case(lattice), *warm),
             f"Np {m64[0][0].shape[0]}, K 32, M 64, C 2052": (m64, *plain),
             f"{24 * Np} rows, K 32, C 132": (cs.tile_solver(*lattice), *plain)}
    own_fn = solver_cuda._variant
    past = [v for v in getattr(solver_cuda, "VARIANTS", ()) if v != "registers"]
    res = {}
    try:
        for name, ((a, kw), fn, ref) in cases.items():
            own = own_fn(kw["K"], kw["K"] * kw["M"] + kw["G"])
            want = ref(*a, **kw)
            res[name] = {}
            for v in [own] + [v for v in past if v != own]:
                solver_cuda._variant = lambda *shape, _v=v: _v
                if not same_bits(fn(*a, **kw), want):
                    fail(f"B9 {name}, variant {v}: differs from the plain version")
                call = lambda a=a, kw=kw, fn=fn: fn(*a, **kw)  # noqa: E731
                ms = cs.event_ms(call)
                dev, other, n, nk = device_split(call, "solver_")
                solver_cuda._variant = own_fn
                res[name][v] = {"own": v == own, "ms": ms, "kernel_device_ms": dev,
                                "other_device_ms": other, "device_launches": n,
                                "kernel_launches": nk}
                print(f"B9 {name}, variant {v}{'' if v == own else ' (forced)'}: wrapper "
                      f"{ms:.4f} ms; kernel {dev:.4f} ms on the device in {nk:.0f} launches, "
                      f"{other:.4f} ms beside it; {n:.0f} device launches a solve; bitwise "
                      f"({card})", flush=True)
    finally:
        solver_cuda._variant = own_fn
    # Where a solve's time goes: substeps, iterations, the rest.
    (a, kw) = lattice
    split = {}
    for iters, sub in ((1, 1), (2, 2), (8, 8), (4, 1), (8, 2)):
        k = dict(kw, iters=iters, substeps=sub)
        split[f"{iters},{sub}"] = device_split(lambda k=k: solver_cuda.solve(*a, **k), "solver_")[0]
    sub_ms = (split["8,8"] - split["1,1"]) / 7
    it_ms = (split["4,1"] - split["1,1"]) / 3 - sub_ms
    res["split"] = {"device_ms": split, "substep_ms": sub_ms, "iteration_ms": it_ms,
                    "rest_ms": split["1,1"] - sub_ms}
    print(f"B9 Np {Np}, K 32, C 132, {own_fn(32, 132)}: device ms at (iterations, substeps) "
          f"{json.dumps({k: round(v, 5) for k, v in split.items()})}; a substep {sub_ms:.5f} ms, "
          f"an iteration beside its substeps {it_ms:.5f} ms, the rest "
          f"{split['1,1'] - sub_ms:.5f} ms ({card})", flush=True)
    return res


SHADOW_SIZES = (512, 1024, 2048, 4096, 8192)
RESIDENT_LIMIT = 10239    # the most tiles the resident kernel's offsets take (40 KB)


def shadow_maps(cs, raster_cuda, render_raster, workload, card, sizes=SHADOW_SIZES):
    """B11's variants on render_512's shadow-map tables (see the module
    docstring) at ``sizes``, and of its first 512 triangles at 8192² when
    ``sizes`` holds 8192: {"<tris> triangles, shadow <n>²": {variant:
    times}}."""
    past = raster_cuda._variant(10 ** 6)        # the variant past the resident kernel
    full = workload.render_512_inputs("cuda")
    scenes = [(full[0].shape[0], full, s) for s in sizes]
    part = (full[0][:512], full[1][:512], full[2][:512], *full[3:])
    if 8192 in sizes:
        scenes.append((512, part, 8192))
    res = {}
    variant_fn = raster_cuda._variant
    try:
        for tris, inputs, size in scenes:
            calls = capture(render_raster, "rasterize_ids_tiled",
                            lambda i=inputs, s=size: workload.run_render_512("cuda", s, i))
            a, kw = next((a, kw) for a, kw in calls    # the shadow map: no G-buffer
                         if kw.get("attr_tab") is None and (len(a) < 7 or a[6] is None))
            attrs, bbox, rng, _, (nty, ntx) = raster_cuda.tile_table(*a, **kw)
            tab = (attrs, bbox, rng, nty, ntx, a[5], a[4], attrs.shape[1] - 10)
            want = raster_cuda.tile_raster_reference(*tab)
            tiles, _ = raster_cuda._chunk_pairs(bbox, rng, nty, ntx)
            name = f"{tris} triangles, shadow {size}²"
            res[name] = {"tiles": nty * ntx, "live_pairs": int(tiles.numel()),
                         "max_tile_pairs": int(torch.bincount(tiles).max()), "variants": {}}
            for v in (["resident"] if nty * ntx <= RESIDENT_LIMIT else []) + [past]:
                raster_cuda._variant = lambda n, v=v: v
                got = raster_cuda.tile_raster(*tab)
                for g, w in zip(got, want):
                    if (g is None) != (w is None) or (g is not None and not torch.equal(
                            cs._bits(g), cs._bits(w))):
                        fail(f"B11 {name}, variant {v}: differs from the plain version")
                call = lambda: raster_cuda.tile_raster(*tab)  # noqa: E731
                ms = cs.event_ms(call)
                dev, rest, n, nk = device_split(call, "raster_kernel")
                res[name]["variants"][v] = {"ms": ms, "kernel_device_ms": dev,
                                            "rest_device_ms": rest, "device_launches": n,
                                            "kernel_launches": nk}
                print(f"B11 {name} ({nty * ntx} tiles, {int(tiles.numel())} live pairs), "
                      f"variant {v}: wrapper {ms:.4f} ms; raster kernel {dev:.4f} ms in "
                      f"{nk:.0f} launches and the rest {rest:.4f} ms on the device, {n:.0f} "
                      f"device launches; bitwise ({card})", flush=True)
                raster_cuda._variant = variant_fn
    finally:
        raster_cuda._variant = variant_fn
    return res


if __name__ == "__main__":
    # After PYTHONPATH: a checkout named there is the one measured.
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
