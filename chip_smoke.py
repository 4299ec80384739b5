#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. a CUDA device is present; print the card, torch and CUDA versions;
  2. build the hand-written kernels from ``surtr_tpu_torch/csrc``, then
     start one background process (``--cpu-runs``, nice 19, no card
     visible) that computes the CPU plain runs phases 20, 21, 28 and 29
     compare with, so that they overlap the card's phases;
  3. per decomposition kernel (B1 clip fold, B2 ICH, B3 island labels, B4
     refit planes): the kernel against its plain PyTorch version on the
     card, on the inputs the main path gives it plus degenerate cases, with
     times; B2 bitwise (face slots, face_valid, normals, inner) also on the
     sphere's hull, 4 points, tied extreme points, 300 points, 4 live
     points, limit 62 and 13,000 points, and its wrapper and device time a
     call on the cube and on the sphere; B3 exactly also at T = 1, 40 and
     200, on strips that need all 6 rounds at T = 64 (and at iters 1 and
     2, unclosed), a complete graph, corners on a half-tol rounding
     boundary and all-invalid soups; B4 bitwise (the mask and all 32 floats
     of every candidate) on the main path's pool parts, the same pools
     built, and all-masked, 2-live, coplanar, tied, ±0-support, odd-sized
     and 9,001-point pools;
  4. the decomposition main path: ``prepare_fracture`` of the cube at the
     1k-seed bench configuration on ``cuda:0``, with launch counts proving
     every kernel ran;
  5. the same event through the plain path on the CPU, compared;
  6. median ms per event on the card;
  7. per physics kernel (B5 pack with its owner gather, B6 sweep-and-prune,
     B7 narrowphase, B8 contact prep from the pair records, B9 solver
     iteration, B12 Morton window, B9's accumulated mode): the kernel
     against its plain version on the inputs of the last of the 64 steps of
     the 10k lattice (pair and ground hits asserted present; the
     accumulated mode's of the 32nd step of a warm-start run) plus
     degenerate cases (for B5 and B8: one row, a count that is not a
     multiple of a block, -1 owners and partners, every slot missed, NaN
     depth; for B7 at Vh = 8 and, with the first interactive frame's step
     and the degenerate scene at Vh = 64, at Vh = 64 too: one piece, 39
     pairs, -1 and out-of-range partners, a dead partner, pieces with no
     live corner, rotated boxes that reach the support fallback; for B12
     ``sorted_edge_cases``: one piece, 1,001 pieces, all invalid, one
     owner, equal centers, int64 owners, W = 128 with K = 16, K = 2W),
     with times; B5-B9 (B9 in both modes) and B12 bitwise (B12's glue,
     codes, order and sorted table, against its plain mirror too); B5, B7
     and B8's device time and device launches a call (B7 also at Vh = 64),
     B12's sweep and glue device time and its device launches a call, B9's
     a launch and a step and its device launches a solve;
  8. the physics main path: ``workload.run_physics(64)`` at bench.py:207's
     configuration ("auto" broadphase on 10,000 pieces) on ``cuda:0``,
     launches pack 1, B6 1, narrowphase 1, prep 1, solver 1 on every step
     that is not skipped as all-asleep;
  9. the same lattice stepped through the plain path on the CPU, compared
     after 30 steps;
  (a)-(e) the other paths of ``physics_step``, each from a scene built on
     the CPU and copied, with launch counts per step: (a) the exact block
     sweep, 16 steps; (b) broadphase "sorted" (B12), 16 steps; (c) one
     step of a 66,000-cube lattice under "auto" (RecallDegradedWarning,
     B12); on (b) and (c) each step's B12 result bitwise against its plain
     version on the step's inputs; (d) warm start (B9's accumulated mode), 32 steps, compared with
     the CPU plain run after 16; (e) the lattice bound in pairs (5,000
     two-cube compound bodies), 32 steps, compared likewise;
 10. ms per physics step, a per-stage split and the device idle share;
     per step each kernel's device ms and launches and, per stage, the
     host events of the CUDA API (kernel launches, copies, memsets,
     synchronizes) under torch.profiler; ms per step of (b), (d) and (e)
     and the stage splits of (d) and (e);
 11. the sphere's 1k decomposition (the culled pair-pool mesh clip) on
     ``cuda:0``, launches B10 1 and B1-B4 as in phase 4, compared with the
     CPU plain run;
 12. the cube32 impact (``workload.run_impact``, bench.py:295-333) from one
     cube prepared on the card, under mesh_pair_pool "auto" (B1, B3, B4,
     no B10) and True (B10 once), each compared with the CPU plain run from
     the same prepared pieces; B1 against its plain fold on both routes'
     calls;
 13. kernel B10 (pooled soup clip) against its plain version on the calls
     of 11 and 12 and on degenerate cases (``soup_cases``: multiruns with
     up to four crossings a plane at K = 32, cut sums of -0, lanes emptied
     at the first and the last plane, int64 and int32 cell ids among
     them), bitwise in n_vert, the drops and all 8 slots, with times, its
     device operations a call, the live lanes and lane x plane steps, and
     its bound;
 14. ms per event of the sphere decomposition and of the impact on both
     routes, each impact route's stage split and device idle share;
 15. kernel B11 (tiled z-buffer raster) against its plain version on the
     card, bitwise in depth, ids (sorted and the caller's order) and
     G-buffer, on the interactive frame's two calls, ``render_512``'s at
     shadow maps of 512² and 1024² and degenerate tables (a dense tile
     among them), and its glue against ``_tile_table`` bitwise on the same
     inputs; per call the wrapper's time, the kernel's and the glue's device
     time and device launches, the live (tile, chunk) pairs and the most in
     one tile; times per input set and its bound; B1, B3 and B4 on the first
     frame's calls and B5 (bitwise, with its degenerate inputs at Vh = 64),
     B7 on the last frame's step against their plain versions, timed at the
     frame's shapes;
 16. the interactive frame (BASELINE config 4, bench.py:372-434):
     ``Scene("cube", INTERACTIVE_CFG)`` on ``cuda:0`` and 16 chained
     ``interactive_frame`` calls, launches per frame B11 2 (and its glue
     2 calls), B5 1, B7 1, no B6/B8/B9/B10/B12, the first frame fracturing;
 17. the same frames from one CPU-built Scene, on the card and through the
     plain path on the CPU in lockstep, compared after each of the first
     three;
 18. ms per frame (median of the 16 frames, 3 runs), a stage split, the
     device idle share, and ``render_512`` ms at shadow 512 and 1024;
 19. the concave path's kernels at its calls: the torus decomposition at
     BASELINE config 1's configuration (``workload.MODEL_1K_CFG``: F = 96,
     S = 32, Tp = 128, exact caps, the parity grid, the culled pair pool)
     run once on the card with recording wrappers, then B1 (its six calls
     at F = 96, S = 32), B2 (the torus's 288 points), B3 (T = 128), B4
     (the pool of mesh corners and exact-cap points) and B10 (the torus's
     pair pool) against their plain versions on those calls, bit for bit,
     and on their degenerate cases (B1's at F = 96, S = 32); per kernel
     the wrapper's and the device ms a call, the plain version's ms and
     the bound;
 20. that event on ``cuda:0`` with launch counts (B1 6, B2 1, B3 1 by its
     vertex variant at T = 128, B4 1, B10 1; one parity grid), compared with the CPU plain run at full
     width: piece_cnt, ich_face_cnt and mesh_tris_dropped equal, total
     volume within rtol 1e-5, pieces slot for slot;
 21. ``workload.concave_scene("torus")`` and ``("blob")`` (the default
     SceneConfig, exact caps kept), each built on the CPU, and on the card
     with recording wrappers: launches (B1 6, B2 1, B3 1 at T = 512, B4 1),
     each recorded kernel call bit for bit against its plain version, the
     prepare metrics and pieces (slot for slot) against the CPU-built
     Scene's. From the CPU-built Scene copied to the card and to the CPU:
     one ``fire_impact`` (exact caps; B1, B3, B4 and the pooled job clip's
     B10 each launched, and each recorded call bit for bit against its
     plain version), 16 steps (B5, B7) and one render (B11) in lockstep,
     compared as phase 17 compares frames;
 22. ms per event of the torus config-1 decomposition (its stage split:
     grid build, cell clip, mesh clip, islands, caps, refit, the ACH and
     refit folds, pack; its device idle share) and of each Scene's
     ``fire_impact`` (its stage split and idle share), beside the card's
     name and power limit.
 23. every ``PhysicsConfig`` route (``workload.ROUTES``: the XLA
     narrowphase, the unfused prep, no kernel broadphase, the Morton window
     beyond 2·window, the grid broadphase, all three switches off) and the
     kernel route on the 10k lattice from the main path's contact-rich
     state: 8 steps on ``cuda:0`` with launch counts per step (which kernels
     each route runs and which it does not) and through the plain path on
     the CPU from the same bits, compared; ms per step of each route;
 24. BASELINE config 2: ``batch_decompose`` of 64 cubes at 1k seeds
     (``workload.BATCH_CFG``) on ``cuda:0``, launches B1 6·64, B2, B3 and
     B4 64 each; every mesh bit for bit equal to its own
     ``prepare_fracture`` on the card from the same seeds, mesh 0 against
     the CPU plain run; ms a batch and a mesh, the device idle share (of
     the first 4 meshes);
 25. ``batch_step`` of four copies of the 10k lattice, 16 steps, launches
     4·16 of each main-path kernel, each copy bit for bit equal to its own
     run;
 26. the CLI: ``python -m surtr_tpu_torch --preset tiny`` as a subprocess,
     then ``main`` in-process at the full preset for the cube (240 steps,
     an impact, 512² frames, snapshot, trajectory) and the torus (120
     steps, an impact), with launch counts; the snapshots load back;
 27. ``PhaseTimer`` ms of the cube 1k prepare, the cube32 impact and a 10k
     step, and of each ``prepare_fracture`` (1-7) and ``physics_step``
     (1, 2, 3, 35, 4) stage on the card, each stage's fence within rtol
     1e-5 of the CPU plain run's; ``profiling.trace`` of one 10k step.
 28. the last module slice: (a) B2's batched entry (``hull_cuda.ich_batch``:
     a warp a point set for the refit pools, else a block a set) against
     its plain version on the card, bit for bit, on the refit pools of the
     cube 1k event at refitting_point_limit 8 and 20 and of the torus
     config-1 event at 20 and on degenerate batches (0-3 live points, all
     masked, ties, coplanar, P = 45, 13,000 points a set, B = 1 at limits
     62 and 20, live points only at a pool's end, exactly 4 live, about 160
     live in a set), each call's variant shown by its counter (the refit
     pools on the warp-a-set variant), with its wrapper, device and plain
     ms, device launches a call and its bound; (b) the cube 1k event at
     limit 20 (B1 6, B2 2 of which one batched on the warp-a-set variant,
     B3 1, no B4) and (c) the torus config-1 event at limit 20 and the
     cube32 impact at limit 20 (B2 once, batched; no B4), and (d) the
     sphere's 1k prepare with mesh_pair_pool=False (no B10), each against
     its CPU plain run; (e) ``delaunay3d`` (24 and 256 points),
     ``delaunay2d`` (30 and 512) and ``voronoi_dual_edges`` (20) on the
     card against the CPU run, the small sizes also against scipy; (f)
     ``sharded_batch_decompose`` (4 cubes at config 2's configuration) and
     ``sharded_batch_step`` (2 copies of the 10k lattice, 8 steps) over
     every visible GPU and over [cuda:0, cuda:0], each shard bit for bit
     equal to its unsharded run, each tally to the unsharded sum.
 29. BASELINE config 1 at its model's scale: a torus of 5,000 vertices and
     10,000 triangles (the pumpkin's size, bench.py:138) written as OBJ
     text and read back by ``io.obj.load_obj`` (``workload.model_scale_mesh``),
     decomposed at ``workload.MODEL_1K_CFG`` with no cut: phase 19's checks
     on its calls (B1's six at F = 96, S = 32, B2 on 5,000 points, B3, B4,
     B10 on 40,000 lanes), phase 20's launch counts (B1 6, B2 1, B3 1, B4
     1, B10 1) and slot-for-slot comparison with the CPU plain run, then ms
     per event (median of 5), the stage split, the idle share and the peak
     device memory of one event, beside the card's name and power limit.
 30. past the old limits (ROADMAP C14): each kernel with a limit at a
     shape past it (B1's CTA variant at F = 256, S = 32, each of that
     prepare's six calls timed, with its vertex buffers in a scratch at F =
     1,025 over more polytopes than its CTAs, the global fold at F = 2,304;
     the batched B2 at limit 64, F = 132; B3's vertex variant at T = 2048,
     also over more soups than its CTAs, and in a scratch at T = 4,096; B1
     and B3's variants forced onto the degenerate cases; B5 at Vh = 768
     and 747 (the first Vh past 48 KB at F = 8) and on supports of -0 and
     +0 tied at an interval's end (its wide variant), and at Vh = 8,100
     (the wide variant reading its corners in place); B6, B9 and B12 at K =
     32, B9 also over more rows than its grid, B12 at W = 256 and 1,024
     and at K = 48 too (its list selection); B7 at Vh = 12 and 768 and with
     M = 64 (its group variant; at Vh 12 also on narrowphase_edge_cases);
     B9 by its shared variant in both modes (the accumulated one on seeded
     totals); B8 at K = 32, M = 64 (its wide variant) and at M = 3,300 (the
     records read in place); B8's and B12's variants forced onto the
     lattice's calls and the degenerate broadphase pools, B7's and B9's
     last resorts ("general") onto phase 30's B7 and B9 calls, B5's and
     B10's ("direct", "general") onto phase 30's B5 and B10 calls, a NaN
     corner through B5's wide and direct variants (ROADMAP C17); B10 at S
     = 16, 3, 5 and 32 (its group variant) and S = 40 (the general one);
     B11 at 32,768 tiles; the general B2 also on the sphere's
     hull and on sets of 0-4 live points at F = 132), and, since the
     redesigns of B11 past its resident kernel and of B6 past K = 16, B11
     on render_512's 4,096 triangles at a shadow map of 8192² and B6 on
     the 10k lattice's 64th step at K = 32 (B6 at K = 80 too, its
     thread-a-piece variant), bit for bit against its plain version
     on the card, the counter of the variant it takes showing that it ran, with
     the wrapper's ms, the device ms and launches (torch.profiler, in one
     fresh process), the plain version's ms and the bound; the Python byte
     counts behind each choice of variant against the kernels' C layouts;
     then three configurations end to end: the 1,000-cube lattice under
     max_neighbors 32 and max_hull_verts 12 against the CPU plain run in
     lockstep from one CPU-built scene (phase 9's bounds), each step's B7
     and B9 call bit for bit against its plain version, the cube under
     max_piece_tris 2048 and refitting_point_limit 64 against its CPU plain
     run slot for slot, and render_scene at a shadow map of 8192² (bench_
     render's first 512 triangles, then all 4,096) against the plain
     versions on the card, bit for bit, one raster launch a call.
The line before last is a JSON object of per-kernel results; the last line
is the device JSON object.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import statistics
import sys
import time
import warnings

try:
    import torch
except ImportError:
    print("chip_smoke: torch is not installed", file=sys.stderr)
    sys.exit(2)

try:
    import surtr_tpu_torch  # noqa: F401
except ImportError:
    print("chip_smoke: run from the repository root (surtr_tpu_torch not found)",
          file=sys.stderr)
    sys.exit(2)

import numpy as np

from surtr_tpu_torch import _build, workload
from surtr_tpu_torch.fracture import pipeline
from surtr_tpu_torch.io.models import get_model
from surtr_tpu_torch.ops import (clip_cuda, hull_cuda, labels_cuda, mesh_clip, refit_cuda,
                                 soup_clip_cuda, voronoi)
from surtr_tpu_torch.ops import labels as label_ops
from surtr_tpu_torch.physics import (broadphase_cuda, narrowphase_cuda, pack_cuda, prep_cuda,
                                     solver_cuda)
from surtr_tpu_torch.physics import step as phys_step
from surtr_tpu_torch.physics.rigid import quat_normalize
from surtr_tpu_torch.physics.scene import build_scene
from surtr_tpu_torch.render import raster as render_raster
from surtr_tpu_torch.render import raster_cuda
from surtr_tpu_torch import scene as scene_mod
from surtr_tpu_torch.types import ConvexPoly, index_tree, unit_cube
from surtr_tpu_torch.workload import run_prepare
from tools.time_b5_b8 import HOST_EVENTS, step_profile

KERNELS = {
    "clip_fold": (clip_cuda, "surtr_tpu_torch/csrc/clip_fold.cu",
                  "surtr_tpu/ops/clip_pallas.py:52", 6),
    "ich": (hull_cuda, "surtr_tpu_torch/csrc/ich.cu",
            "surtr_tpu/ops/hull_pallas.py:51", 1),
    "labels": (labels_cuda, "surtr_tpu_torch/csrc/labels.cu",
               "surtr_tpu/ops/labels_pallas.py:25", 1),
    "refit": (refit_cuda, "surtr_tpu_torch/csrc/refit.cu",
              "surtr_tpu/ops/refit_pallas.py:38", 1),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn``, each run fenced by synchronize (for a
    whole event, whose host work is part of its cost)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of CUDA-event ms around one call of ``fn``
    (device time as the card sees it, launch gaps included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def capture_main_path_inputs(run=lambda: run_prepare("cuda")):
    """Run a decomposition (the main path unless ``run`` says otherwise)
    once on the card with recording wrappers, returning the arguments each
    kernel wrapper received (its real shapes)."""
    calls = {k: [] for k in (*KERNELS, "soup_clip")}
    patches = [
        (pipeline, "clip_planes_batch", "clip_fold"),
        (voronoi, "clip_planes_batch", "clip_fold"),
        (pipeline, "ich", "ich"),
        (pipeline, "tri_soup_components_batch", "labels"),
        (pipeline, "refit_planes_from_parts", "refit"),
        (pipeline, "soup_clip_pooled", "soup_clip"),
    ]
    saved = []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def rec(*a, _fn=fn, _name=name, **kw):
            calls[_name].append((a, kw))
            return _fn(*a, **kw)

        setattr(mod, attr, rec)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return calls


def degenerate_clip_cases(device, F=26, S=16):
    """Planes through vertices and edges, face-coplanar, tangent, slivers,
    an emptying cut and an empty polytope."""
    cases = [
        [[1.0, 1.0, 0.0, 0.0]],
        [[1.0, 1.0, 1.0, -0.75]],
        [[1.0, 0.0, 0.0, -0.5]],
        [[1.0, 0.0, 0.0, -0.7]],
        [[1.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 0.0]],
        [[1.0, 0.0, 0.0, -0.01], [-1.0, 0.0, 0.0, -0.01]],
        [[1.0, 0.0, 0.0, 0.6]],
    ]
    K = max(len(c) for c in cases)
    N = len(cases) + 1
    planes = torch.zeros((N, K, 4))
    mask = torch.zeros((N, K), dtype=torch.bool)
    for i, c in enumerate(cases):
        for j, p in enumerate(c):
            n = torch.tensor(p[:3])
            ln = torch.linalg.vector_norm(n)
            planes[i, j, :3] = n / ln
            planes[i, j, 3] = p[3] / ln
            mask[i, j] = True
    planes[-1, 0] = torch.tensor([1.0, 0.0, 0.0, 0.1])
    mask[-1, 0] = True
    base = unit_cube(F=F, S=S)
    poly = base.map(lambda a: a[None].expand((N,) + a.shape).contiguous())
    nv = poly.n_verts.clone()
    nv[-1] = 0
    poly = ConvexPoly(poly.face_verts, nv, poly.planes)
    return (poly.map(lambda a: a.to(device)), planes.to(device), mask.to(device)), {}


def compare_clip(args, kw):
    """n_verts exactly (so emptiness and live faces too) and every live face
    vertex and plane bit for bit. Returns the largest difference, 0."""
    poly, planes, mask = args[:3]
    got = clip_cuda.clip_planes_batch(poly, planes, mask)
    want = clip_cuda.clip_planes_batch_reference(poly, planes, mask)
    _exact("clip_fold", "n_verts", got.n_verts, want.n_verts)
    sm, fm = want.slot_mask()[..., None], want.face_mask()[..., None]
    _same_bits("clip_fold", "face vertices", torch.where(sm, got.face_verts, 0.0),
               torch.where(sm, want.face_verts, 0.0))
    return _same_bits("clip_fold", "planes", torch.where(fm, got.planes, 0.0),
                      torch.where(fm, want.planes, 0.0))


def compare_ich(args, kw):
    """Face slots slot for slot, face_valid, normals and inner bitwise equal
    to the plain hull's."""
    pts, mask = args[:2]
    limit = kw.get("limit", args[2] if len(args) > 2 else 20)
    got = hull_cuda.ich(pts, mask, limit=limit)
    want = hull_cuda.ich_reference(pts, mask, limit=limit)
    what = f"ich ({pts.shape[0]} points, limit {limit})"
    if not torch.equal(got["faces"], want["faces"]):
        bad = torch.nonzero((got["faces"] != want["faces"]).any(-1)).flatten().tolist()
        fail(f"{what}: face slots {bad[:10]} differ from the plain hull")
    if not torch.equal(got["face_valid"], want["face_valid"]):
        fail(f"{what}: face_valid differs from the plain hull")
    _same_bits(what, "normals", got["normals"], want["normals"])
    _same_bits(what, "inner", got["inner"][None], want["inner"][None])
    return 0.0


def compare_labels(args, kw):
    corners, valid = args[:2]
    iters = kw.get("iters")
    got = labels_cuda.tri_soup_components_batch(corners, valid, iters=iters)
    want = labels_cuda.tri_soup_components_batch_reference(corners, valid, iters=iters)
    if not torch.equal(got, want):
        fail(f"labels: {int((got != want).sum())} labels differ from the plain closure")
    return 0.0


def refit_any(*a):
    """B4 on a built pool (pool, mask) or on its parts (tris, tri_mask,
    caps, cap_mask), as the call's arguments say."""
    if len(a) == 4:
        return refit_cuda.refit_planes_from_parts(*a)
    return refit_cuda.refit_planes_batch(*a)


def refit_any_reference(*a):
    if len(a) == 4:
        return refit_cuda.refit_planes_from_parts_reference(*a)
    return refit_cuda.refit_planes_batch_reference(*a)


def refit_points(a) -> tuple[int, int]:
    """(N, Pv) of a B4 call: Pv = 3T + C on parts."""
    if len(a) == 4:
        return a[0].shape[0], 3 * a[0].shape[1] + a[2].shape[1]
    return tuple(a[0].shape[:2])


def compare_refit(args, kw):
    """The plane mask exactly and all 32 floats of every candidate's planes
    bit for bit, masked slots included."""
    gp, gm = refit_any(*args)
    wp, wm = refit_any_reference(*args)
    what = f"refit {list(refit_points(args))}"
    if not torch.equal(gm, wm):
        bad = torch.nonzero((gm != wm).any(-1)).flatten().tolist()
        fail(f"{what}: plane masks differ in candidates {bad[:10]} ({len(bad)} in all)")
    _same_bits(what, "slab planes", gp, wp)
    return 0.0


def sphere_ich_call(device):
    """The sphere decomposition's B2 call: ``icosphere(2)``'s 162 points,
    all live, at the bench configuration's limit."""
    pts, mask = workload.model_inputs("sphere", device)[:2]
    return (pts, mask), {"limit": workload.BENCH_CFG.ich_include_point_limit}


def ich_edge_cases(device, g):
    """B2's inputs beside the main path's: 4 points (no insertion); a
    3 x 3 x 3 integer grid (exact ties among the extreme points and among
    the priorities, integer volumes); 300 points (more than one pass a
    lane); a mask that leaves 4 live points; limit 62 (F = 128, the
    wrapper's limit); 13,000 points (more than the kernel stages in shared
    memory)."""
    grid = torch.stack(torch.meshgrid(*[torch.arange(3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    four = torch.randn((50, 3), generator=g)
    m4 = torch.zeros(50, dtype=torch.bool)
    m4[[3, 17, 29, 41]] = True
    cases = [
        (torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]), None, 20),
        (grid, None, 20),
        (torch.randn((300, 3), generator=g), None, 20),
        (four, m4, 20),
        (torch.randn((200, 3), generator=g), None, 62),
        (torch.rand((13_000, 3), generator=g), None, 20),
    ]
    return [((c.to(device), (torch.ones(len(c), dtype=torch.bool) if m is None else m).to(device)),
             {"limit": lim}) for c, m, lim in cases]


def degenerate_cases(device):
    g = torch.Generator().manual_seed(7)
    v, _ = get_model("cube")
    clouds = [
        torch.as_tensor(v),
        torch.randn((40, 3), generator=g),
        torch.rand((100, 3), generator=g) * torch.tensor([2.0, 1.0, 0.5]),
        torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0.5, 0]]),  # coplanar
    ]
    ich_cases = [((c.to(device), torch.ones(len(c), dtype=torch.bool, device=device)),
                  {"limit": 20}) for c in clouds]
    ich_cases += ich_edge_cases(device, g)
    N, T = 6, 16
    corners = torch.rand((N, T, 3, 3), generator=g)
    for t in range(T - 1):
        corners[0, t + 1, 0] = corners[0, t, 1]
        if t != T // 2 - 1:
            corners[1, t + 1, 0] = corners[1, t, 1]
    valid = torch.ones((N, T), dtype=torch.bool)
    valid[2] = False
    valid[3, T // 2:] = False
    label_cases = [((corners.to(device), valid.to(device)), {})]
    label_cases += [((c.to(device), v.to(device)), kw) for c, v, kw in label_edge_cases(g)]
    pool = torch.randn((5, 40, 3), generator=g)
    pm = torch.rand((5, 40), generator=g) > 0.3
    pm[3, 4:] = False
    pm[4] = False
    refit_cases = [((pool.to(device), pm.to(device)), {})]
    refit_cases += [(tuple(t.to(device) for t in a), {}) for a in refit_edge_cases(g)]
    return {
        "clip_fold": [degenerate_clip_cases(device)],
        "ich": ich_cases,
        "labels": label_cases,
        "refit": refit_cases,
    }


def _strip(T, order, g):
    """T triangles, consecutive ones (in strip order) sharing a corner,
    triangle k of the strip stored at index order[k]."""
    P = torch.rand((T + 1, 3), generator=g)
    Q = torch.rand((T, 3), generator=g)
    c = torch.empty((T, 3, 3))
    c[torch.as_tensor(order)] = torch.stack([P[:-1], Q, P[1:]], 1)
    return c


def label_edge_cases(g, tol=1e-5):
    """B3 beside the main path: T = 1 (one lane), 40 (a partial second
    word; with a soup whose corner keys collide, ``key_wrap_soup``) and 200;
    at T = 64 a strip in reversed order (closes in its 6th round), one in
    bit-reversed order (still open after 6) and one in random order, a
    complete graph (one corner shared by all), corners a half-tol apart that
    fall on rounding boundaries (x / tol = k + 0.5 exactly, rounded to
    even), and an all-invalid soup, also at iters 1 and 2 (unclosed
    labels); then T = 512 (``FractureConfig.max_piece_tris``' default) and
    1024 (the wrapper's limit: a block of 1024 threads), strips in random
    order and, at 1024, a complete graph."""
    cases = []
    c1 = torch.rand((4, 1, 3, 3), generator=g)
    cases.append((c1, torch.tensor([[True], [False], [True], [False]]), {}))
    c40 = torch.rand((5, 40, 3, 3), generator=g)
    c40[0] = _strip(40, torch.randperm(40, generator=g), g)
    c40[1, 20:] = c40[1, :20] + 0.5
    c40[4] = key_wrap_soup(40, g, tol)
    v40 = torch.ones((5, 40), dtype=torch.bool)
    v40[2] = False
    v40[3, ::3] = False
    cases.append((c40, v40, {}))
    c200 = torch.rand((3, 200, 3, 3), generator=g)
    c200[0] = _strip(200, torch.randperm(200, generator=g), g)
    c200[1] = _strip(200, torch.arange(200).flip(0), g)
    v200 = torch.ones((3, 200), dtype=torch.bool)
    v200[1, 150:] = False
    v200[2] = False
    cases.append((c200, v200, {}))
    T = 64
    bitrev = [int(format(i, "06b")[::-1], 2) for i in range(T)]
    c64 = torch.stack([_strip(T, torch.arange(T).flip(0), g), _strip(T, bitrev, g),
                       _strip(T, torch.randperm(T, generator=g), g),
                       torch.rand((T, 3, 3), generator=g), half_tol_soup(T, g, tol),
                       torch.rand((T, 3, 3), generator=g)])
    c64[3, :, 1] = 0.5
    v64 = torch.ones((6, T), dtype=torch.bool)
    v64[5] = False
    for iters in (None, 1, 2):
        cases.append((c64, v64, {} if iters is None else {"iters": iters}))
    c512 = torch.rand((3, 512, 3, 3), generator=g)
    c512[0] = _strip(512, torch.randperm(512, generator=g), g)
    c512[1] = _strip(512, torch.arange(512).flip(0), g)
    v512 = torch.ones((3, 512), dtype=torch.bool)
    v512[1, 400:] = False
    v512[2] = False
    cases.append((c512, v512, {}))
    c1024 = torch.rand((2, 1024, 3, 3), generator=g)
    c1024[0] = _strip(1024, torch.randperm(1024, generator=g), g)
    c1024[1, :, 1] = 0.5                                   # a complete graph
    cases.append((c1024, torch.ones((2, 1024), dtype=torch.bool), {}))
    return cases


def half_tol_soup(T, g, tol):
    """Triangles whose corners sit where x / tol is exactly k + 0.5 in float32
    (round half to even joins k + 0.5 and k + 1.5 at k + 1 for odd k and
    parts them otherwise): a chain that a rounding or a division other than
    the true one cuts or joins differently."""
    t32 = np.float32(tol)
    ks = []
    k = 1000
    while len(ks) < 3 * T + 2:
        x = np.float32((k + 0.5) * float(t32))
        for cand in (x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1))):
            if np.float32(cand) / t32 == np.float32(k + 0.5):
                ks.append(float(cand))
                break
        k += 1
    xs = torch.tensor(ks[:3 * T + 2], dtype=torch.float32)
    c = torch.rand((T, 3, 3), generator=g)
    for t in range(T):
        c[t, 0, 0], c[t, 1, 0], c[t, 2, 0] = xs[3 * t], xs[3 * t + 1], xs[3 * t + 2]
        c[t, :, 1:] = 0.25
    return c


def key_wrap_soup(T, g, tol):
    """Two strips of T / 2 triangles; triangle t of the second has a corner
    2^21 quanta beyond one of triangle t of the first in x: equal in their
    low 21 bits (B3's corner keys) but not equal, so B3 must confirm its key
    matches by the triple compare (coordinates beyond 2^20 quanta), or it
    joins the strips."""
    t32 = np.float32(tol)

    def at(q):   # a float32 x with rint(x / tol) == q
        x = np.float32(q * float(t32))
        while np.rint(x / t32) < q:
            x = np.nextafter(x, np.float32(np.inf))
        while np.rint(x / t32) > q:
            x = np.nextafter(x, np.float32(-np.inf))
        assert np.rint(x / t32) == q
        return float(x)

    h = T // 2
    c = torch.cat([_strip(h, torch.arange(h), g), _strip(T - h, torch.arange(T - h), g)])
    for t in range(h):
        q = 3_000 + 7 * t
        c[t, 1] = torch.tensor([at(q), 0.25, 0.25])
        c[h + t, 1] = torch.tensor([at(q + (1 << 21)), 0.25, 0.25])
    return c


def refit_edge_cases(g):
    """B4 beside the main path: 2 live points; a coplanar pool; a 3 x 3 x 3
    integer grid (exact ties in x and in distance); collinear points
    through the origin (every normal zero, supports of -0 and +0 tied at
    the minimum); points on the plane x = 0 of both signs (a zero support
    tie on a live normal); Pv = 41 (not a multiple of 4: unaligned rows);
    parts with T = 5, C = 7 (an unaligned span boundary); one pool of 9,001
    points (staged in 9 chunks, compacted into the device scratch)."""
    grid = torch.stack(torch.meshgrid(*[torch.arange(3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    line = torch.randn((27, 1), generator=g).expand(27, 3)
    plane = torch.randn((27, 3), generator=g)
    plane[:20, 0] = 0.0
    plane[20:, 0] = plane[20:, 0].abs() + 0.1
    plane[:5, 1:] = -plane[:5, 1:].abs()
    cop = torch.randn((27, 3), generator=g)
    cop[:, 1] = 0.25
    two = torch.randn((27, 3), generator=g)
    pools = torch.stack([two, cop, grid, line, plane])
    masks = torch.ones((5, 27), dtype=torch.bool)
    masks[0, 2:] = False
    masks[3, 20:] = False
    cases = [(pools, masks)]
    p41 = torch.randn((3, 41, 3), generator=g)
    m41 = torch.rand((3, 41), generator=g) > 0.4
    m41[2] = False
    cases.append((p41, m41))
    tris = torch.randn((3, 5, 3, 3), generator=g)
    caps = torch.randn((3, 7, 3), generator=g)
    tm = torch.rand((3, 5), generator=g) > 0.3
    cm = torch.rand((3, 7), generator=g) > 0.3
    tm[1] = False
    cm[2] = False
    cases.append((tris, tm, caps, cm))
    big = torch.randn((1, 9001, 3), generator=g)
    cases.append((big, torch.rand((1, 9001), generator=g) > 0.5))
    return cases


KERNEL_FN = {"clip_fold": clip_cuda.clip_planes_batch, "ich": hull_cuda.ich,
             "labels": labels_cuda.tri_soup_components_batch,
             "refit": refit_any, "soup_clip": soup_clip_cuda.soup_clip_pooled}
PLAIN_FN = {"clip_fold": clip_cuda.clip_planes_batch_reference, "ich": hull_cuda.ich_reference,
            "labels": labels_cuda.tri_soup_components_batch_reference,
            "refit": refit_any_reference,
            "soup_clip": soup_clip_cuda.soup_clip_pooled_reference}
# Name fragments of each kernel's device functions (torch.profiler keys).
DEVICE_NAME = {"clip_fold": "clip_fold", "ich": "ich_kernel", "labels": "labels_",
               "refit": "refit_kernel", "pack": "pack_kernel", "narrowphase": "narrow_kernel",
               "prep": "prep_kernel", "broadphase_sorted": "bp_sorted_sweep"}


def per_call_times(name, calls, fn=None, required=True):
    """Per call of a kernel wrapper: the wrapper's ms (CUDA events around
    the call, median of 20) and the kernel's device ms (torch.profiler;
    None where ``required`` is False and the trace lacks the kernel)."""
    fn = fn or KERNEL_FN[name]
    out = []
    for a, kw in calls:
        call = functools.partial(fn, *a, **kw)
        out.append({"ms": event_ms(call),
                    "device_ms": device_split(call, DEVICE_NAME[name], required=required)[0]})
    return out


def time_kernel(name, calls, plain_reps: int = 20):
    """Summed median ms of a path's calls: kernel vs plain version."""
    ms = sum(event_ms(lambda a=a, kw=kw: KERNEL_FN[name](*a, **kw)) for a, kw in calls)
    plain_ms = sum(event_ms(lambda a=a, kw=kw: PLAIN_FN[name](*a, **kw), reps=plain_reps,
                            warmup=1) for a, kw in calls)
    return ms, plain_ms


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work.
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores (data sheet)


def nbytes(obj) -> int:
    """Bytes of every tensor in ``obj`` (tuples, lists, dicts, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(nbytes(o) for o in obj.values())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def bound(n_bytes: float, n_ops: float):
    """(ms, "bytes" or "operations"): each input byte read once and each
    output byte written once at the memory rate, against the float
    operations at the FP32 rate; the larger of the two."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def decomposition_ops(name, a, kw) -> float:
    """Float operations the decomposition kernels do on these inputs (the
    dominant terms, counted from the code)."""
    if name == "clip_fold":
        poly, planes, mask = a[:3]
        verts = poly.n_verts.clamp_min(0).sum(-1).to(torch.float64)
        return float((mask.sum(-1).to(torch.float64) * verts).sum()) * 6
    if name == "ich":
        pts = a[0]
        limit = kw.get("limit", a[2] if len(a) > 2 else 20)
        return limit * pts.shape[0] * (2 * max(limit, 4) + 4) * 6.0
    if name == "labels":
        T = a[0].shape[1]
        v = a[1].sum(-1).to(torch.float64)
        if labels_cuda._variant(T) == "block":   # the valid pairs' corner tests
            return float((v * v).sum()) * 81.0
        # The vertex variant: 9T quantizations, a hash and a triple compare
        # a valid corner, then per round run 3 atomics, 3 gathers, 3 minima
        # and a jump a valid triangle.
        run = label_ops.label_rounds_run(a[0], a[1], iters=kw.get("iters")).to(torch.float64)
        return float((18.0 * T + 36.0 * v + 10.0 * v * run).sum())
    N, Pv = refit_points(a)        # refit: 4 extreme-point passes + 4 slab passes
    return N * Pv * 8 * 8.0


def decomposition_bound(name, calls):
    fn = KERNEL_FN[name]
    b = ops = 0.0
    for a, kw in calls:
        b += nbytes(a) + nbytes(kw) + nbytes(fn(*a, **kw))
        ops += decomposition_ops(name, a, kw)
    return bound(b, ops)


# ---------------------------------------------------------------------------
# Physics kernels (B5-B9, B12) on the 10k lattice.
# ---------------------------------------------------------------------------

PHYS_KERNELS = {
    # name: (module, launch counter, source, TPU kernel, step attribute)
    "pack": (pack_cuda, "launches", "surtr_tpu_torch/csrc/pack.cu",
             "surtr_tpu/physics/pack_pallas.py:31", "transform_pack_owned"),
    "broadphase_exact": (broadphase_cuda, "exact_launches",
                         "surtr_tpu_torch/csrc/broadphase_exact.cu",
                         "surtr_tpu/physics/broadphase_pallas.py:221", "broadphase_exact"),
    "narrowphase": (narrowphase_cuda, "launches", "surtr_tpu_torch/csrc/narrowphase.cu",
                    "surtr_tpu/physics/narrowphase_pallas.py:103", "narrowphase"),
    "prep": (prep_cuda, "launches", "surtr_tpu_torch/csrc/prep.cu",
             "surtr_tpu/physics/prep_pallas.py:42", "prep_from_records"),
    "solver": (solver_cuda, "launches", "surtr_tpu_torch/csrc/solver.cu",
               "surtr_tpu/physics/solver_pallas.py:53", "solve"),
    "broadphase_sorted": (broadphase_cuda, "sorted_launches",
                          "surtr_tpu_torch/csrc/broadphase_sorted.cu",
                          "surtr_tpu/physics/broadphase_pallas.py:55", "broadphase_sorted"),
    "solver_warm": (solver_cuda, "warm_launches", "surtr_tpu_torch/csrc/solver.cu",
                    "surtr_tpu/physics/solver_pallas.py:53", "solve_warm"),
}
STAGES = ["pack", "broadphase", "narrowphase", "glue", "prep", "solver", "finish"]


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr, *_) in PHYS_KERNELS.items()}


def reset_counts():
    for mod, attr, *_ in PHYS_KERNELS.values():
        setattr(mod, attr, 0)


def launches_a_step(**changes) -> dict:
    """Launches a step that is not skipped as all-asleep makes: the main
    path's (bench.py:207, "auto" on 10k pieces), with ``changes``."""
    want = dict(pack=1, broadphase_exact=1, narrowphase=1, prep=1, solver=1,
                broadphase_sorted=0, solver_warm=0)
    want.update(changes)
    return want


EXACT_CFG = dataclasses.replace(workload.PHYSICS_CFG, broadphase="exact")
SORTED_CFG = dataclasses.replace(workload.PHYSICS_CFG, broadphase="sorted")
# The paths beside the main one, each driven from a scene built on the CPU
# and copied to the card: (scene factory, config, steps, steps compared with the
# CPU plain run in lockstep, launches a step).
VARIANTS = {
    "a_exact": (lambda: workload.physics_lattice(device="cpu", cfg=EXACT_CFG), EXACT_CFG, 16, 0,
                launches_a_step(broadphase_exact=0)),
    "b_sorted": (lambda: workload.physics_lattice(device="cpu", cfg=SORTED_CFG), SORTED_CFG, 16,
                 0, launches_a_step(broadphase_exact=0, broadphase_sorted=1)),
    "c_auto_66k": (lambda: workload.physics_lattice(workload.LARGE_LATTICE_N, "cpu"),
                   workload.PHYSICS_CFG, 1, 0,
                   launches_a_step(broadphase_exact=0, broadphase_sorted=1)),
    "d_warm": (lambda: workload.physics_lattice(device="cpu", cfg=workload.WARM_CFG),
               workload.WARM_CFG, 32, 16, launches_a_step(solver=0, solver_warm=1)),
    "e_pairs": (lambda: workload.paired_lattice(device="cpu"), workload.PAIRED_CFG, 32, 16,
                launches_a_step(prep=0, solver=0)),
}


class StepRecorder:
    """Wraps the step's kernel entry points and keeps, per kernel, the
    arguments and result of its latest call. The wrapped functions still
    run, so launch counts are unchanged."""

    def __enter__(self):
        self.last = {}
        self.saved = []
        for name, (*_, attr) in PHYS_KERNELS.items():
            fn = getattr(phys_step, attr)
            self.saved.append((attr, fn))

            def rec(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                self.last[_name] = (a, kw, out)
                return out

            setattr(phys_step, attr, rec)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved:
            setattr(phys_step, attr, fn)


class LaunchCheck:
    """Called after each step: the launches the step made must equal
    ``want``, except a step that launched nothing from an all-asleep scene
    (skipped). The counts are set to 0 when it is made."""

    def __init__(self, name, cfg, want):
        self.name, self.cfg, self.want = name, cfg, want
        self.skipped = 0
        self.was_asleep = False
        self.ran_last = False
        reset_counts()
        self.prev = launch_counts()

    def __call__(self, i, scene):
        now = launch_counts()
        delta = {k: now[k] - self.prev[k] for k in now}
        self.prev = now
        self.ran_last = any(delta.values())
        if self.was_asleep and not self.ran_last:
            self.skipped += 1
        elif delta != self.want:
            fail(f"{self.name}: step {i} launched {json.dumps(delta)}, expected "
                 f"{json.dumps(self.want)}")
        self.was_asleep = all_asleep(scene, self.cfg)


def hit_counts(prep_call):
    """(pair hit slots, ground hit slots) of a recorded prep call."""
    _, kw, out = prep_call
    K, M, G = kw["K"], kw["M"], kw["G"]
    C = K * M + G
    hit = out[4][:, :C] > 0.5
    return int(hit[:, : K * M].sum()), int(hit[:, K * M :].sum())


def all_asleep(scene, cfg) -> bool:
    b = scene.bodies
    asleep = (scene.sleep_frames >= cfg.sleep_frames) | ~b.active
    return bool(torch.all(asleep) & torch.any(b.active))


def _exact(name, what, got, want):
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    if not torch.equal(got, want):
        bad = torch.nonzero((got != want).any(1)).flatten().tolist()
        fail(f"{name}: {what} differ from the plain version in rows {bad[:10]} "
             f"({len(bad)} in all)")


def _same_bits(name, what, got, want):
    """Every float of ``got`` has the bits of ``want``'s (NaN against NaN of
    any payload); fails naming the rows that differ. Returns the largest
    difference, 0."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    if got.shape != want.shape:
        fail(f"{name}: {what} has shape {tuple(got.shape)}, the plain version {tuple(want.shape)}")
    bad = (got.view(torch.int32) != want.view(torch.int32)) & ~(torch.isnan(got)
                                                                & torch.isnan(want))
    if bool(bad.any()):
        rows = torch.nonzero(bad.any(1)).flatten().tolist()
        i = rows[0]
        j = int(torch.nonzero(bad[i])[0])
        fail(f"{name}: {what} differ from the plain version in rows {rows[:10]} ({len(rows)} in "
             f"all; row {i} column {j}: {float(got[i, j])!r} against {float(want[i, j])!r})")
    return 0.0


def compare_pack(a, kw):
    """The packed rows and the AABB rows bitwise equal to the plain
    version's (the owner gather included)."""
    got = pack_cuda.transform_pack_owned(*a, **kw)
    want = pack_cuda.transform_pack_owned_reference(*a, **kw)
    return max(_same_bits("pack", "packed rows", got[0], want[0]),
               _same_bits("pack", "AABB rows", got[1], want[1]))


def compare_narrowphase(a, kw):
    """Every record bitwise equal to the plain version's (NaN against
    NaN)."""
    Np, K = a[1].shape
    return _same_bits("narrowphase", "pair records",
                      narrowphase_cuda.narrowphase(*a).reshape(Np * K, -1),
                      narrowphase_cuda.narrowphase_reference(*a).reshape(Np * K, -1))


def compare_prep(a, kw):
    """All eight tables bitwise equal to the plain version's (the slot
    assembly and the partner gather included; NaN targets of dead partners
    against NaN)."""
    got = prep_cuda.prep_from_records(*a, **kw)
    want = prep_cuda.prep_from_records_reference(*a, **kw)
    names = ["rA", "rB", "n", "m_eff|target", "hit|static", "scale", "inv_I", "vn0"]
    return max(_same_bits("prep", nm, g, w) for nm, g, w in zip(names, got, want))


def compare_solver(a, kw):
    """The state bitwise equal to the plain version's after all outer
    iterations (same formulas, same order)."""
    return _bitwise("solver", ("state",), solver_cuda.solve(*a, **kw),
                    solver_cuda.solve_reference(*a, **kw))


def _flat(out):
    """The tensors of a nested result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _bitwise(name, names, got, want):
    """Every output equal to the plain version's; the largest difference
    (0)."""
    err = 0.0
    for what, g, w in zip(names, _flat(got), _flat(want)):
        _exact(name, what, g, w)
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def compare_broadphase_exact(a, kw):
    """pidx, pok, key_ji and θ equal to the plain version's (integer keys)."""
    return _bitwise("broadphase_exact", ("pidx", "pok", "key_ji", "theta"),
                    broadphase_cuda.broadphase_exact(*a, **kw),
                    broadphase_cuda.broadphase_exact_reference(*a, **kw))


def compare_broadphase_sorted(a, kw):
    """pidx and the mutual pok equal to the plain version's, filler slots
    included; the glue's Morton codes, sort order and sorted table equal to
    its plain mirror ``sorted_glue`` (the table bit for bit)."""
    pidx, pok, glue = broadphase_cuda._sorted_launch(*a, **kw)
    codes, order, table = broadphase_cuda.sorted_glue(*a[:5])
    _exact("broadphase_sorted", "Morton codes", glue[0][:, None], codes[:, None])
    _exact("broadphase_sorted", "sort order", glue[1][:, None], order[:, None])
    _same_bits("broadphase_sorted", "sorted table", glue[2], table)
    return _bitwise("broadphase_sorted", ("pidx", "pok"), (pidx, pok),
                    broadphase_cuda.broadphase_sorted_reference(*a, **kw))


def compare_solver_warm(a, kw):
    """The state and the accumulated impulses bitwise equal to the plain
    version's after all outer iterations (same formulas, same order)."""
    return _bitwise("solver_warm", ("state", "accumulated impulses"),
                    solver_cuda.solve_warm(*a, **kw), solver_cuda.solve_warm_reference(*a, **kw))


PHYS_COMPARE = {"pack": compare_pack, "broadphase_exact": compare_broadphase_exact,
                "narrowphase": compare_narrowphase, "prep": compare_prep,
                "solver": compare_solver, "broadphase_sorted": compare_broadphase_sorted,
                "solver_warm": compare_solver_warm}
PHYS_PLAIN = {
    "pack": pack_cuda.transform_pack_owned_reference,
    "broadphase_exact": broadphase_cuda.broadphase_exact_reference,
    "narrowphase": narrowphase_cuda.narrowphase_reference,
    "prep": prep_cuda.prep_from_records_reference,
    "solver": solver_cuda.solve_reference,
    "broadphase_sorted": broadphase_cuda.broadphase_sorted_reference,
    "solver_warm": solver_cuda.solve_warm_reference,
}
PHYS_KERNEL_FN = {
    "pack": pack_cuda.transform_pack_owned,
    "broadphase_exact": broadphase_cuda.broadphase_exact,
    "narrowphase": narrowphase_cuda.narrowphase,
    "prep": prep_cuda.prep_from_records,
    "solver": solver_cuda.solve,
    "broadphase_sorted": broadphase_cuda.broadphase_sorted,
    "solver_warm": solver_cuda.solve_warm,
}


def overlap_pairs(a, block: int = 1024) -> int:
    """Ordered pairs (i, j) that produce a key of the broadphase function on
    these inputs: margin AABBs overlap, both valid, other owners, j != i."""
    centers, lo, hi, owner, valid = a[:5]
    Np = centers.shape[0]
    ids = torch.arange(Np, device=centers.device)
    n = 0
    for r0 in range(0, Np, block):
        r1 = min(r0 + block, Np)
        over = torch.all((lo[None] <= hi[r0:r1, None]) & (lo[r0:r1, None] <= hi[None]), dim=-1)
        n += int((over & valid[r0:r1, None] & valid[None] & (owner[r0:r1, None] != owner[None])
                  & (ids[r0:r1, None] != ids[None])).sum())
    return n


def sweep_tests(a) -> tuple[int, int]:
    """Candidate tests B6's sweep makes on these inputs (a design statistic,
    not its bound): per (query tile, row tile) pair its walk visits, 32
    pieces times the rows whose AABB meets the query tile's union
    (``broadphase_cuda.tile_schedule``); and the first design's count, 128
    x 128 for every chunk of a block's range whose union meets the block's."""
    centers, lo, hi, owner, valid = a[:5]
    table, tiles, rng = broadphase_cuda.exact_glue(centers, lo, hi, owner, valid)
    _, rows = broadphase_cuda.tile_schedule(table, tiles, rng)
    CH = broadphase_cuda.CHUNK
    NCH = rng.shape[0]
    cu = tiles.reshape(NCH, CH // broadphase_cuda.TILE, 6)
    clo, chi = cu[..., :3].amin(1), cu[..., 3:].amax(1)
    ch = torch.arange(NCH, device=tiles.device)[None]
    in_range = (ch >= rng[:, :1]) & (ch < rng[:, 1:])
    meets = ((clo[None] <= chi[:, None]) & (clo[:, None] <= chi[None])).all(-1)
    return int(rows.sum()) * broadphase_cuda.TILE, int((in_range & meets).sum()) * CH * CH


def physics_ops(name, a, kw) -> float:
    """Float operations of one step's calls of a physics kernel, counted
    from the code (every pair and slot is computed, hit or not)."""
    if name == "pack":
        Np, Vh = a[0].shape[:2]
        F, Ne = a[2].shape[1], a[4].shape[1]
        return Np * (45 + Vh * (24 + 13 * 7) + F * 21 + Ne * 15)
    if name == "broadphase_exact":      # per key: 6 compares, 4 flags, d², key, insert
        return overlap_pairs(a) * 20.0
    if name == "broadphase_sorted":     # per candidate: the test, d², the top-K insert
        Np, window = a[0].shape[0], a[6]
        return Np * 2 * window * 25.0
    if name == "narrowphase":
        packed, pidx, pok, Vh, F, Ne, M, slop = a
        per_pair = (13 * 7 + 2 * F * Vh * 8 + Ne * Ne * (28 + Vh * 14) + Vh * 14
                    + M * (2 * Vh + 12) + 30)
        return pidx.numel() * per_pair
    K, M, G = kw["K"], kw["M"], kw["G"]
    C = K * M + G
    if name == "prep":
        return a[0].shape[0] * C * 95.0
    S = max(1, kw["substeps"])
    outer = (kw["iters"] + S - 1) // S
    per_slot = 120.0 if name == "solver_warm" else 75.0
    return outer * a[0].shape[0] * (S * C * per_slot + C * 3)


def physics_bound(name, a, kw, out):
    return bound(nbytes(a) + nbytes(kw) + nbytes(out), physics_ops(name, a, kw))


def with_sleepers(prep_call, solver_call):
    """Copies of captured prep/solver inputs with every 7th body marked
    asleep (a sleeping partner wherever a slot names one) and every 5th body
    carrying the wake seed; the solver's tables are rebuilt from the changed
    prep inputs by the plain prep. The prep call is (records, partners,
    ground points, depths, hits, x, v0, w0, inv_m, inv_I, asleep); the
    solver call is (state, partners, tables) or, in the accumulated mode,
    (state, impulses, partners, tables)."""
    a, kw, _ = prep_call
    asleep = a[10].clone()
    asleep[::7] = True
    a = (*a[:10], asleep)
    tables = prep_cuda.prep_from_records_reference(*a, **kw)
    sa, skw, _ = solver_call
    vw0 = sa[0].clone()
    vw0[::5, 6] = 1.0
    rest = sa[1:-1]
    return (a, kw), ((vw0, *rest, tuple(tables[:-1])), skw)


def pack_edge_cases(call):
    """B5's degenerate inputs beside a recorded call: one piece; a count
    that is not a multiple of a block's pieces (8 at Vh <= 16, 4 above);
    owners of -1 and past the last body, invalid pieces, and a piece whose
    corners are all masked (its intervals stay at +-BIG)."""
    a, kw = call[:2]
    verts, vmask, planes, pmask, edges, emask, owner, valid, q, x = a[:10]
    n = min(13, verts.shape[0])
    cut = lambda t: t[:n]  # noqa: E731
    sub = (*map(cut, (verts, vmask, planes, pmask, edges, emask, owner, valid)), q, x, *a[10:])
    own, val, vm = owner[:n].clone(), valid[:n].clone(), vmask[:n].clone()
    own[1::4] = -1
    own[2] = q.shape[0] + 5
    val[3::5] = False
    vm[min(4, n - 1)] = False
    odd = (verts[:n], vm, planes[:n], pmask[:n], edges[:n], emask[:n], own, val, q, x, *a[10:])
    one = (*(t[:1] for t in (verts, vmask, planes, pmask, edges, emask, owner, valid)), q, x,
           *a[10:])
    return [(one, kw), (sub, kw), (odd, kw)]


def prep_edge_cases(call):
    """B8's degenerate inputs beside a recorded call: one row; 10 rows (not
    a multiple of a block's rows); every slot missed; NaN depth on the
    slots of a dead partner, partners of -1 and past the last row."""
    a, kw = call[:2]
    raw, pidx, g_pts, gd, g_hit = a[:5]
    bodies = a[5:]
    one = (raw[:1], pidx[:1], g_pts[:1], gd[:1], g_hit[:1], *(t[:1] for t in bodies))
    n = min(10, raw.shape[0])
    ten = (raw[:n], pidx[:n], g_pts[:n], gd[:n], g_hit[:n], *(t[:n] for t in bodies))
    missed = raw.clone()
    missed[:, :, 4] = 0.0
    missed[:, :, 6::6] = 0.0
    none = (missed, pidx, g_pts, gd, torch.zeros_like(g_hit), *bodies)
    dead, pk = raw.clone(), pidx.clone()
    dead[::3, ::2, 5::6] = float("nan")
    dead[::3, ::2, 0:3] = 0.0
    pk[1::4, 1] = -1
    pk[2::4, 2] = raw.shape[0] + 3
    nan = (dead, pk, g_pts, gd, g_hit, *bodies)
    return [(one, kw), (ten, kw), (none, kw), (nan, kw)]


def degenerate_physics_scene(device, cfg=workload.PHYSICS_CFG):
    """20 boxes: a strongly rotated overlapping cluster, an edge-edge crossing
    pair (no corner of either inside the other: the support-point fallback),
    a grounded box, a far box and one dead piece; one physics step's kernel
    inputs (at ``cfg``'s hull size)."""
    g = torch.Generator().manual_seed(11)
    cluster = (torch.rand((14, 3), generator=g) * 1.2 - 0.6) + torch.tensor([0.0, -0.8, 0.0])
    r2 = 2 ** 0.5
    extra = torch.tensor([[10.0, 0.0, 0.0], [10.0, r2 - 0.01, 0.0], [5.0, -1.5005, 0.0],
                          [-20.0, 3.0, 0.0], [0.0, -0.8, 0.0], [30.0, 0.0, 0.0]])
    offs = torch.cat([cluster, extra]).numpy()
    pieces = workload.cube_pieces(offs, device)
    pieces.valid[-1] = False                                   # dead piece
    scene = build_scene(pieces, cfg, max_bodies=len(offs))
    b = scene.bodies
    q = quat_normalize(b.q + 0.35 * torch.randn(b.q.shape, generator=g).to(device))
    c, s8 = math.cos(math.pi / 8), math.sin(math.pi / 8)
    q[14] = torch.tensor([c, 0.0, 0.0, s8], device=device)     # 45 degrees about z
    q[15] = torch.tensor([c, s8, 0.0, 0.0], device=device)     # 45 degrees about x
    q[16] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    v = 0.5 * torch.randn(b.v.shape, generator=g).to(device)
    scene = dataclasses.replace(scene, bodies=dataclasses.replace(b, q=q, v=v))
    with StepRecorder() as rec:
        phys_step.physics_step(scene, cfg)
    torch.cuda.synchronize()
    calls = rec.last
    # Rows with no candidate at all; and every slot that is not a pair
    # naming the dead last piece, as B6's empty-slot sentinel does (its
    # edge axes have no finite penetration: depth NaN, normal 0).
    a, kw, _ = calls["narrowphase"]
    pok = a[2].clone()
    pok[::3] = False
    sentinel = torch.where(a[2], a[1], (1 << broadphase_cuda.id_bits(a[1].shape[0])) - 1)
    nar = [(a, kw), ((a[0], a[1], pok) + tuple(a[3:]), kw),
           ((a[0], sentinel) + tuple(a[2:]), kw)]
    return calls, nar


def narrowphase_edge_cases(call):
    """B7's degenerate inputs beside a recorded call: one piece; 13 pieces
    and 3 partner columns (39 pairs, not a multiple of a block's pairs at
    any Vh; partners past the 13th clamp to the last); partners of -1 and
    past the last piece; pieces whose corners are all masked, some of them
    with their edges masked too (a NaN axis: depth NaN, normal 0)."""
    a, kw = call[:2]
    packed, pidx, pok, Vh, F, Ne = a[:6]
    offs, _ = pack_cuda.pack_layout(Vh, F, Ne)
    one = (packed[:1], pidx[:1], pok[:1], *a[3:])
    n = min(13, packed.shape[0])
    odd = (packed[:n], pidx[:n, :3].contiguous(), pok[:n, :3].contiguous(), *a[3:])
    pk = pidx.clone()
    pk[1::4, 1] = -1
    pk[2::4, 2] = packed.shape[0] + 3
    bad = (packed, pk, pok, *a[3:])
    dead = packed.clone()
    wo, wc = offs["wm"]
    dead[1::5, wo:wo + wc] = 0.0
    dead[2::5, wo:wo + wc] = 0.0
    if "em" in offs:
        eo, ec = offs["em"]
        dead[2::5, eo:eo + ec] = 0.0
    masked = (dead, pidx, pok, *a[3:])
    return [(one, kw), (odd, kw), (bad, kw), (masked, kw)]


def frame_step_calls():
    """The kernel inputs of the first interactive frame's step on the card
    (``Scene("cube", INTERACTIVE_CFG)``: compound owners, Vh = 64, F = 32)."""
    with StepRecorder() as rec:
        scene = workload.interactive_scene("cuda")
        workload.run_frames(scene, 1)
        torch.cuda.synchronize()
    return rec.last


def broadphase_cases(device):
    """Broadphase inputs (centers, lo, hi, owner, valid) beside the main
    path's, by name: a pool that is not a multiple of 128 with invalid
    rows, a single block, owners shared in pairs, pieces with fewer than K
    overlaps, a dense cluster inside one chunk, 65,536 pieces (ID_BITS 16)
    and the exact distance ties of a lattice."""
    rng = np.random.default_rng(17)

    def boxes(c, half, owner=None, valid=None):
        n = len(c)
        own = np.arange(n) if owner is None else owner
        val = np.ones(n, bool) if valid is None else valid
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        return (f(c), f(c - half), f(c + half),
                torch.as_tensor(np.asarray(own, np.int32), device=device),
                torch.as_tensor(val, device=device))

    u = rng.uniform
    cluster = np.concatenate([u(-0.05, 0.05, (100, 3)) + [-40.0, 0.0, 0.0],
                              u(-30, 30, (900, 3))])
    side = 6
    g = np.arange(side) * 1.02
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    n = broadphase_cuda.MAX_EXACT_NP
    return {
        "700 random, 5% invalid": boxes(u(-5, 5, (700, 3)), u(0.2, 0.6, (700, 3)),
                                        valid=u(size=700) > 0.05),
        "single block": boxes(u(-2, 2, (100, 3)), u(0.2, 0.6, (100, 3))),
        "owners shared in pairs": boxes(u(-3, 3, (300, 3)), u(0.2, 0.6, (300, 3)),
                                        owner=np.arange(300) // 2, valid=u(size=300) > 0.2),
        "fewer than K overlaps": boxes(u(-8, 8, (300, 3)), np.full((300, 3), 0.5)),
        "dense cluster in one chunk": boxes(cluster, np.full((1000, 3), 0.5)),
        "65,536 random": boxes(u(0, 40, (n, 3)), u(0.2, 0.8, (n, 3)),
                               owner=np.arange(n) // 3, valid=u(size=n) > 0.05),
        "lattice ties": boxes(lattice, np.full(lattice.shape, 0.6)),
    }


def sorted_edge_cases(bcases, K: int, W: int):
    """B12's inputs beside the main path's: ``broadphase_cases``' pools at
    the path's K and W, and, as (centers, lo, hi, owner, valid, K, W): one
    piece; 1,001 pieces (no multiple of the select launch's 8 lanes or of
    a 256-thread block); all invalid; one owner for all; equal centers
    (equal codes, pairs at d² = 0); int64 owners; W = 128 with K = 16 and
    K = 2W (W = 4 and 8) on a random pool and the lattice of exact ties."""
    rng = np.random.default_rng(29)
    dev = next(iter(bcases.values()))[0].device
    u = rng.uniform

    def boxes(c, owner=None, valid=None, odt=np.int32):
        n = len(c)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
        own = np.arange(n) if owner is None else owner
        val = np.ones(n, bool) if valid is None else valid
        return (f(c), f(c - 0.6), f(c + 0.6), torch.as_tensor(np.asarray(own, odt), device=dev),
                torch.as_tensor(val, device=dev))

    dup = u(-3, 3, (400, 3))
    dup[:200] = dup[200:]
    rand, ties = bcases["700 random, 5% invalid"], bcases["lattice ties"]
    cases = [(b, K, W) for b in bcases.values()] + [
        (boxes(u(-1, 1, (1, 3))), K, W),
        (boxes(u(-6, 6, (1001, 3)), valid=u(size=1001) > 0.1), K, W),
        (boxes(u(-3, 3, (300, 3)), valid=np.zeros(300, bool)), K, W),
        (boxes(u(-2, 2, (300, 3)), owner=np.zeros(300)), K, W),
        (boxes(dup), K, W),
        (boxes(u(-4, 4, (500, 3)), owner=np.arange(500) // 2, odt=np.int64), K, W),
        (rand, 16, 128), (ties, 16, 128), (rand, 8, 4), (ties, 16, 8)]
    return [(tuple(b) + (k, w), {}) for b, k, w in cases]


def physics_capture(steps: int, cfg=workload.PHYSICS_CFG):
    """Run the lattice once with recording wrappers; the inputs of the last
    step that ran, that step's index and the final scene."""
    seen = {}
    with StepRecorder() as rec:
        def on_step(i, scene):
            if rec.last and rec.last.get("pack") is not seen.get("pack"):
                seen.update(rec.last)
                seen["step"] = i
        final = workload.run_physics(steps, "cuda", cfg=cfg, on_step=on_step)
        torch.cuda.synchronize()
    return seen, final


def physics_kernel_phase(card):
    """Phase 7."""
    cfg = workload.PHYSICS_CFG
    calls, final = physics_capture(workload.PHYSICS_STEPS)
    pair_hits, ground_hits = hit_counts(calls["prep"])
    asleep = int((final.sleep_frames >= cfg.sleep_frames).sum())
    print(f"physics capture: step {calls['step'] + 1} of {workload.PHYSICS_STEPS}, "
          f"pair hit slots {pair_hits}, ground hit slots {ground_hits}, "
          f"bodies asleep {asleep}", flush=True)
    if pair_hits <= 0 or ground_hits <= 0:
        fail("the captured step has no pair or no ground contact: the comparison proves nothing")
    wcalls, _ = physics_capture(32, workload.WARM_CFG)
    if not float(wcalls["solver_warm"][0][1].abs().max()) > 0:
        fail("the captured warm-start step carries no warm impulse")
    main = {k: (v[0], v[1]) for k, v in calls.items() if k != "step"}
    bp_args = main["broadphase_exact"][0]
    main["broadphase_sorted"] = (tuple(bp_args) + (cfg.broadphase_window,), {})
    main["solver_warm"] = (wcalls["solver_warm"][0], wcalls["solver_warm"][1])
    sleepy_prep, sleepy_solver = with_sleepers(calls["prep"], calls["solver"])
    _, sleepy_warm = with_sleepers(wcalls["prep"], wcalls["solver_warm"])
    dcalls, dnar = degenerate_physics_scene("cuda")
    dsleepy_prep, dsleepy_solver = with_sleepers(dcalls["prep"], dcalls["solver"])
    # B7 at the frame's hull size too: the first interactive frame's step
    # and the degenerate scene at Vh = 64.
    fcall = frame_step_calls()["narrowphase"]
    _, dnar64 = degenerate_physics_scene(
        "cuda", dataclasses.replace(workload.PHYSICS_CFG, max_hull_verts=fcall[0][3]))
    for (da, _), what in ((dnar[0], "degenerate scene"), (dnar64[0], "degenerate scene (Vh 64)")):
        out, Vh = narrowphase_cuda.narrowphase(*da), da[3]
        fb = (out[..., 10] > 2 * Vh) & (out[..., 6] > 0.5)
        print(f"{what}: {int(fb.sum())} fallback contacts (fid > 2Vh)", flush=True)
        if int(fb.sum()) == 0:
            fail(f"the {what} reached no support-point fallback")
    K = cfg.max_neighbors
    bcases = broadphase_cases("cuda")
    cases = {
        "pack": [main["pack"], (dcalls["pack"][0], dcalls["pack"][1])]
        + pack_edge_cases(main["pack"]),
        "broadphase_exact": [main["broadphase_exact"]] + [(b + (K,), {}) for b in bcases.values()],
        "narrowphase": [main["narrowphase"]] + dnar + narrowphase_edge_cases(main["narrowphase"])
        + [fcall[:2]] + dnar64 + narrowphase_edge_cases(fcall),
        "prep": [main["prep"], sleepy_prep, (dcalls["prep"][0], dcalls["prep"][1]),
                 dsleepy_prep] + prep_edge_cases(main["prep"]),
        "solver": [main["solver"], sleepy_solver, (dcalls["solver"][0], dcalls["solver"][1]),
                   dsleepy_solver],
        "broadphase_sorted": [main["broadphase_sorted"]]
        + sorted_edge_cases(bcases, K, cfg.broadphase_window),
        "solver_warm": [main["solver_warm"], sleepy_warm],
    }
    live = {name: int(broadphase_cuda.broadphase_exact(*b, K)[1].sum())
            for name, b in bcases.items()}
    print("broadphase cases (pieces, live B6 slots): " + json.dumps(
        {name: [b[0].shape[0], live[name]] for name, b in bcases.items()}), flush=True)
    results = {}
    for name in PHYS_KERNELS:
        err = 0.0
        for a, kw in cases[name]:
            err = max(err, PHYS_COMPARE[name](a, kw))
        torch.cuda.synchronize()
        a, kw = main[name]
        ms = event_ms(lambda: PHYS_KERNEL_FN[name](*a, **kw))
        plain_ms = event_ms(lambda: PHYS_PLAIN[name](*a, **kw), warmup=1)
        out = PHYS_KERNEL_FN[name](*a, **kw)
        b_ms, b_by = physics_bound(name, a, kw, out)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by}
        extra = ""
        if name in ("solver", "solver_warm"):
            dev_ms, other_ms, entries = device_split(
                functools.partial(PHYS_KERNEL_FN[name], *a, **kw), "solver_kernel")
            S = max(1, kw["substeps"])
            outer = (kw["iters"] + S - 1) // S
            results[name].update(device_ms=dev_ms, other_device_ms=other_ms,
                                 device_launches=entries, outer_iterations=outer)
            extra = (f" (on the device: {dev_ms:.4f} ms a launch, which runs all {outer} "
                     f"iterations: one launch a solve and a step, {dev_ms:.4f} ms a step; "
                     f"{entries:.0f} device launches a solve, {other_ms:.4f} ms beside the "
                     f"kernel)")
        if name in DEVICE_NAME:
            dev_ms, other_ms, entries = device_split(
                functools.partial(PHYS_KERNEL_FN[name], *a, **kw), DEVICE_NAME[name])
            results[name].update(device_ms=dev_ms, other_device_ms=other_ms,
                                 device_launches=entries)
            extra = (f" (on the device: {dev_ms:.4f} ms, {other_ms:.4f} ms beside the kernel, "
                     f"{entries:.0f} device launches a call)")
            if name == "broadphase_sorted":
                results[name]["glue_device_ms"] = other_ms
                extra = (f" (on the device: sweep {dev_ms:.4f} ms in its two launches, glue "
                         f"{other_ms:.4f} ms (codes, torch.sort, table); {entries:.0f} device "
                         f"launches a call)")
        if name == "narrowphase":   # B7 at the frame's Vh = 64 as well
            fa, fkw = fcall[:2]
            t = per_call_times(name, [(fa, fkw)], PHYS_KERNEL_FN[name])[0]
            t["shape"] = [*fa[1].shape, fa[3], fa[4]]
            results[name]["frame_call"] = t
            print(f"narrowphase at the frame's shapes (Np, K, Vh, F) {t['shape']} (interactive "
                  f"frame 1's step): wrapper {t['ms']:.4f} ms, kernel {t['device_ms']:.4f} ms on "
                  f"the device ({card})", flush=True)
        if name == "broadphase_exact":
            dev_ms, glue_ms, entries = device_split(
                functools.partial(PHYS_KERNEL_FN[name], *a, **kw), "bp_exact_kernel")
            _, _, stage = device_split(functools.partial(
                phys_step._broadphase, "exact_pallas", cfg, *a[:5]), "bp_exact_kernel")
            tests, first = sweep_tests(a)
            pairs = overlap_pairs(a)
            results[name].update(device_ms=dev_ms, glue_device_ms=glue_ms,
                                 device_launches=entries, stage_device_launches=stage,
                                 sweep_tests=tests, first_design_tests=first,
                                 overlap_pairs=pairs)
            extra = (f" (on the device: kernel {dev_ms:.4f} ms, glue {glue_ms:.4f} ms; "
                     f"{entries:.0f} device launches a call, {stage:.0f} for the step's "
                     f"broadphase stage with the mutual mask; {tests} candidate tests for {pairs} "
                     f"overlapping pairs, the first design's chunk walk {first})")
        print(f"{name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms{extra}  plain {plain_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  ({len(cases[name])} cases; {card})", flush=True)
    return results


def physics_main_path(card):
    """Phase 8: the main path through the user's entry point, launch counts
    per step. Returns the counts and the scene one step before the end
    (contact rich)."""
    cfg = workload.PHYSICS_CFG
    keep = {}
    with StepRecorder() as rec:
        check = LaunchCheck("physics main path", cfg, launches_a_step())

        def on_step(i, scene):
            check(i, scene)
            if i == workload.PHYSICS_STEPS - 2:
                keep["before_last"] = scene
        final = workload.run_physics(workload.PHYSICS_STEPS, "cuda", on_step=on_step)
        torch.cuda.synchronize()
        counts = launch_counts()
        last_prep = rec.last.get("prep")
    print(f"physics main path (cuda): launches {json.dumps(counts)}, "
          f"{check.skipped} all-asleep steps skipped", flush=True)
    if any(counts[k] == 0 for k, v in launches_a_step().items() if v):
        fail("a physics kernel of the main path was never launched")
    b = final.bodies
    for f in ("x", "q", "v", "w"):
        if not bool(torch.isfinite(getattr(b, f)).all()):
            fail(f"physics state {f} is not finite after {workload.PHYSICS_STEPS} steps")
    if last_prep is None or not check.ran_last:
        fail(f"step {workload.PHYSICS_STEPS} did not run (all asleep): no contact to check")
    pair_hits, ground_hits = hit_counts(last_prep)
    print(f"step {workload.PHYSICS_STEPS}: pair hit slots {pair_hits}, ground hit slots "
          f"{ground_hits}, bodies asleep {int((final.sleep_frames >= cfg.sleep_frames).sum())}",
          flush=True)
    if pair_hits <= 0 or ground_hits <= 0:
        fail(f"step {workload.PHYSICS_STEPS} has no pair or no ground contact")
    return counts, keep["before_last"]


def _stage_diffs(g, c):
    """Largest difference per stage between two recorded steps."""
    def d(x, y):
        x = x.cpu()
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        return float(torch.where(same, 0.0, (x - y).abs()).max()) if x.numel() else 0.0
    return {
        "pack": d(g["pack"][2][0], c["pack"][2][0]),
        "broadphase": int((g["narrowphase"][0][1].cpu() != c["narrowphase"][0][1]).sum()),
        "narrowphase": d(g["narrowphase"][2], c["narrowphase"][2]),
        "prep": max(d(x, y) for x, y in zip(g["prep"][2], c["prep"][2])),
        "solver": d(g["solver"][2], c["solver"][2]),
    }


def physics_cpu_compare(steps: int = 30):
    """Phase 9: the lattice on the card and through the plain path on the
    CPU, in lockstep from one scene built on the CPU (the pile is chaotic: a
    one-ulp change of the start moves x by ~1e-2 within 30 steps, so both
    runs start from the same bits); x within 2e-4 and v within 2e-3 after
    ``steps``, the hit contact slots within 1%. On failure, the first step
    and stage where the runs part."""
    cfg = workload.PHYSICS_CFG
    sc = workload.physics_lattice(device="cpu")
    sg = workload.to_device(sc, "cuda")
    t0 = time.perf_counter()
    history = []
    with StepRecorder() as rec:
        for i in range(steps):
            rec.last = {}
            sg = phys_step.physics_step(sg, cfg)
            rg = dict(rec.last)
            rec.last = {}
            sc = phys_step.physics_step(sc, cfg)
            rcpu = dict(rec.last)
            dx = float((sg.bodies.x.cpu() - sc.bodies.x).abs().max())
            dv = float((sg.bodies.v.cpu() - sc.bodies.v).abs().max())
            stages = _stage_diffs(rg, rcpu) if rg and rcpu else {}
            hits = (sum(hit_counts(rg["prep"])) if rg else 0,
                    sum(hit_counts(rcpu["prep"])) if rcpu else 0)
            history.append((dx, dv, stages, hits))
    cpu_s = time.perf_counter() - t0
    dx, dv, _, (hg, hc) = history[-1]
    print(f"physics cuda vs cpu plain after {steps} steps: max |dx| {dx:.3e}, max |dv| {dv:.3e}, "
          f"hit slots {hg} vs {hc} ({cpu_s:.1f} s in lockstep)", flush=True)
    first = next(((i, st) for i, (dxi, dvi, st, _) in enumerate(history)
                  if dxi or dvi or any(st.values())), None)
    if first is not None:
        print(f"cuda and cpu runs first differ at step {first[0]}: per stage "
              f"{json.dumps(first[1])}", flush=True)
    if not (dx <= 2e-4 and dv <= 2e-3 and abs(hg - hc) <= 0.01 * max(hc, 1)):
        fail("cuda and cpu runs differ beyond x 2e-4, v 2e-3 or 1% of hit slots")
    return dx, dv


def physics_variants(card):
    """Phases (a)-(e): each path beside the main one from a scene built on
    the CPU and copied to the card, launch counts per step; (c) must warn;
    for (d) and (e) the CPU scene is then stepped through the plain path
    and compared with the card's state after as many steps (x 2e-4, v
    2e-3; warm start also its pairs and feature ids exactly and its
    impulses within 2e-3). Returns per path its launches, its start scene
    on the CPU and its final scene on the card."""
    out = {}
    for name, (build, cfg, steps, cmp_steps, want) in VARIANTS.items():
        t0 = time.perf_counter()
        start = build()
        built_s = time.perf_counter() - t0
        sg = workload.to_device(start, "cuda")
        held = 0
        with warnings.catch_warnings(record=True) as caught, StepRecorder() as rec:
            warnings.simplefilter("always")
            check = LaunchCheck(f"physics path {name}", cfg, want)
            for i in range(steps):
                sg = phys_step.physics_step(sg, cfg)
                check(i, sg)
                if i + 1 == cmp_steps:
                    cg = sg
                # B12's result in this step against its plain version on the
                # step's own inputs (no second launch).
                a, kw, got = rec.last.pop("broadphase_sorted", (None, None, None))
                if a is not None:
                    _bitwise("broadphase_sorted", ("pidx", "pok"), got,
                             broadphase_cuda.broadphase_sorted_reference(*a, **kw))
                    held += 1
            torch.cuda.synchronize()
            counts = launch_counts()
        if held != counts["broadphase_sorted"]:
            fail(f"physics path {name}: B12 held on {held} of its {counts['broadphase_sorted']} "
                 f"calls")
        degraded = [w for w in caught if issubclass(w.category, phys_step.RecallDegradedWarning)]
        if bool(degraded) != (name == "c_auto_66k"):
            fail(f"physics path {name}: RecallDegradedWarning raised {len(degraded)} times")
        b = sg.bodies
        if not all(bool(torch.isfinite(getattr(b, f)).all()) for f in ("x", "q", "v", "w")):
            fail(f"physics path {name}: the state is not finite after {steps} steps")
        line = (f"physics path {name}: Np {start.Np}, B {start.B}, {steps} steps (scene built in "
                f"{built_s:.1f} s), launches {json.dumps(counts)}, {check.skipped} skipped"
                + (f", B12 bitwise on all {held} calls" if held else ""))
        if degraded:
            line += f", warned: {str(degraded[0].message)[:60]}..."
        if cmp_steps:
            sc = start
            for _ in range(cmp_steps):
                sc = phys_step.physics_step(sc, cfg)
            dx = float((cg.bodies.x.cpu() - sc.bodies.x).abs().max())
            dv = float((cg.bodies.v.cpu() - sc.bodies.v).abs().max())
            line += f"; vs cpu plain after {cmp_steps} steps: max |dx| {dx:.3e}, max |dv| {dv:.3e}"
            ok = dx <= 2e-4 and dv <= 2e-3
            if cfg.warm_start:
                dl = float((cg.warm_lam.cpu() - sc.warm_lam).abs().max())
                same = (torch.equal(cg.warm_pair.cpu(), sc.warm_pair)
                        and torch.equal(cg.warm_fid.cpu(), sc.warm_fid))
                line += f", warm pairs and ids equal {same}, max |dλ| {dl:.3e}"
                ok = ok and same and dl <= 2e-3
                if not float(sc.warm_lam.abs().max()) > 0:
                    fail(f"physics path {name}: no warm impulse was carried")
            if not ok:
                print(line, flush=True)
                fail(f"physics path {name}: card and cpu runs differ beyond the stated bounds")
        print(line, flush=True)
        out[name] = (counts, start, sg)
    return out


def steps_ms(start, cfg, steps: int, runs: int = 3) -> tuple[float, list]:
    """ms per step over ``steps`` steps from a copy of ``start`` on the card
    (host clock, synchronize at the end); median of ``runs`` runs after one
    warm-up run."""
    per_run = []
    for _ in range(runs + 1):
        s = workload.to_device(start, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            s = phys_step.physics_step(s, cfg)
        torch.cuda.synchronize()
        per_run.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(per_run[1:]), per_run[1:]


def stage_split(state, cfg, reps: int = 10) -> dict:
    """Median ms per stage of one step from ``state`` (CUDA events at the
    step's stage marks)."""
    split = {k: [] for k in STAGES}
    for r in range(reps + 2):
        marks = []
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        phys_step.physics_step(state, cfg, mark=mark)
        torch.cuda.synchronize()
        prev = e0
        for name, e in marks:
            if r >= 2:
                split[name].append(prev.elapsed_time(e))
            prev = e
    return {k: statistics.median(v) for k, v in split.items() if v}


# Device kernels of one 10k step by name (regular expressions on the
# profiler's keys; B6's sort is part of its glue).
STEP_KERNELS = {"pack": r"(?<![A-Za-z0-9_])pack_kernel", "broadphase_exact": r"bp_exact_kernel",
                "broadphase_exact glue": r"bp_key_kernel|bp_pack_kernel",
                "narrowphase": r"narrow_kernel", "prep": r"prep_kernel",
                "solver": r"solver_kernel"}


def physics_timing(state, variants, card, runs: int = 3):
    """Phase 10: ms per step over the 64-step main path run (host clock,
    synchronize at the end, / 64; median of ``runs`` runs from the fresh
    lattice), the stage split of one contact-rich step by CUDA events, the
    device idle share under torch.profiler; ms per step of paths (b), (d)
    and (e), and the splits of a contact-rich step of (d) and (e)."""
    cfg = workload.PHYSICS_CFG
    n = workload.PHYSICS_STEPS
    lattice = workload.physics_lattice(device="cuda")
    per_run = []
    for _ in range(runs + 1):
        s = lattice
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            s = phys_step.physics_step(s, cfg)
        torch.cuda.synchronize()
        per_run.append((time.perf_counter() - t0) * 1e3 / n)
    step_ms = statistics.median(per_run[1:])
    stages = stage_split(state, cfg)
    busy, wall, idle, entries = profile_busy(lambda: phys_step.physics_step(state, cfg), 8)
    print(f"physics 10k lattice (bench.py:207, \"auto\"): {step_ms:.3f} ms/step (median of {runs} "
          f"runs of {n} steps, host clock; {card})", flush=True)
    print("physics stage split, one contact-rich step (CUDA events, ms): "
          + json.dumps({k: round(v, 4) for k, v in stages.items()}), flush=True)
    if idle is None:
        print("physics idle share: the profiler reported no device time", flush=True)
    else:
        print(f"physics idle share {idle:.3f}: device busy {busy:.3f} ms of {wall:.3f} ms per "
              f"step under the profiler, {entries:.0f} device entries per step", flush=True)
    prof = step_profile(phys_step, STAGES, state, cfg, STEP_KERNELS)
    print("physics kernels on the device a step (torch.profiler, ms and launches): " + json.dumps(
        {k: [round(v["device_ms"], 5), v["launches"]] for k, v in prof["kernels"].items()}),
        flush=True)
    print(f"physics host events a step by stage (CUDA API: launch, memcpy, memset, sync; "
          f"{prof['device_entries']:.0f} device entries a step, copies on the device "
          f"{json.dumps(prof['device_copies'])}): " + json.dumps(
              {k: [round(v[h], 2) for h in HOST_EVENTS] for k, v in prof["stages"].items()}),
          flush=True)
    out = {"step_ms": step_ms, "per_run_ms": per_run[1:], "stages_ms": stages,
           "idle_share": idle, "busy_ms": busy, "profiled_wall_ms": wall, "step_profile": prof}
    for name in ("b_sorted", "d_warm", "e_pairs"):
        _, vcfg, vsteps, _, _ = VARIANTS[name]
        ms, runs_ms = steps_ms(variants[name][1], vcfg, vsteps, runs)
        out[f"{name}_step_ms"] = ms
        print(f"physics path {name}: {ms:.3f} ms/step (median of {runs} runs of {vsteps} steps "
              f"from the start scene, host clock; runs {[round(x, 3) for x in runs_ms]}; {card})",
              flush=True)
    for name, what in (("d_warm", "prep holds B8, the warm matching and the pre-apply"),
                       ("e_pairs", "the solver is plain PyTorch")):
        split = stage_split(variants[name][2], VARIANTS[name][1])
        out[f"{name}_stages_ms"] = split
        print(f"physics path {name} stage split, one contact-rich step (CUDA events, ms; {what}): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return out


# ---------------------------------------------------------------------------
# The sphere decomposition, the cube32 impact and kernel B10.
# ---------------------------------------------------------------------------

SOUP_SRC = "surtr_tpu_torch/csrc/soup_clip.cu"
SOUP_REPLACES = "surtr_tpu/ops/soup_clip_pallas.py:43"
# bench_cube32's event under both mesh-clip routes: "auto" (the vmapped
# plain clip at this pool size, the benchmark's own) and the pooled job
# clip, which on the card culls, packs and runs B10.
IMPACT_ROUTES = {"auto": workload.CUBE32_CFG,
                 "pooled": dataclasses.replace(workload.CUBE32_CFG, mesh_pair_pool=True)}
IMPACT_COUNTS = ("new_pieces", "active_pieces", "merged_out", "num_groups", "mesh_tris_dropped")
IMPACT_OVERFLOWS = ("active_overflow", "job_overflow", "piece_overflow", "split_face_overflow")
IMPACT_STAGES = ("convex_out_of_sphere", "clip_planes_batch", "clip_trisoup",
                 "_pooled_job_mesh_clip", "_split_mesh_islands", "_finish_pieces",
                 "_pack_candidates", "split_groups_by_contact")


def all_counts() -> dict:
    """Launches of every kernel since the counts were last set to 0."""
    counts = {name: mod.launches for name, (mod, *_) in KERNELS.items()}
    counts["ich_batch"] = hull_cuda.batch_launches
    counts["ich_warp_set"] = hull_cuda.warp_set_launches
    counts["soup_clip"] = soup_clip_cuda.launches
    counts["raster"] = raster_cuda.launches
    counts["raster_glue"] = raster_cuda.glue_launches
    counts["broadphase_exact_long"] = broadphase_cuda.exact_long_launches
    counts["clip_fold_global"] = clip_cuda.global_launches
    counts.update(launch_counts())
    counts.update(general_counts())
    return counts


def reset_all():
    for mod, *_ in KERNELS.values():
        mod.launches = 0
    hull_cuda.batch_launches = 0
    hull_cuda.warp_set_launches = 0
    soup_clip_cuda.launches = 0
    raster_cuda.launches = 0
    raster_cuda.glue_launches = 0
    broadphase_cuda.exact_long_launches = 0
    clip_cuda.global_launches = 0
    reset_counts()
    reset_general()


def check_launches(what, counts, want):
    """Every count as ``want`` gives it (an int, or "> 0"); kernels it does
    not name must not have launched."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if (n <= 0) if w == "> 0" else (n != w):
            fail(f"{what}: {name} launched {n} times, expected {w} ({json.dumps(counts)})")


def capture(attr, fn):
    """Run ``fn`` with a recording wrapper on ``pipeline.<attr>``; the
    (args, kwargs) of each call. The wrapped function still runs, so launch
    counts are unchanged."""
    calls = []
    orig = getattr(pipeline, attr)

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    setattr(pipeline, attr, rec)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        setattr(pipeline, attr, orig)
    return calls, out


def _soup_random(seed, P=300, C=16, K=12):
    """A pool in the layout of tests/test_soup_clip_pallas.py: triangles in
    [-1, 1]^3, 10% dead lanes, cell ids sorted (lanes grouped by cell),
    unit-normal planes at |d| <= 0.6 with 15% masked."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1, 1, (P, 3, 3)).astype(np.float32)
    valid = rng.uniform(size=P) > 0.1
    cell = np.sort(rng.integers(0, C, P)).astype(np.int32)
    n = rng.normal(size=(C, K, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (C, K, 1)).astype(np.float32)
    pmask = rng.uniform(size=(C, K)) > 0.15
    return [tris, valid, cell, np.concatenate([n, d], axis=-1), pmask]


def soup_multirun_pool(seed=22, P=1024, C=4, K=32):
    """A pool whose folds cross planes several times: zero-area triangles on
    a line through far-off points for each cell, and planes that contain
    the line. Every distance is rounding noise, mostly beyond tol, so the
    kept corners of a polygon alternate (multiruns, up to four crossings a
    plane) and the exit and enter points sum several cuts."""
    rng = np.random.default_rng(seed)
    t, v, c, p, m = _soup_random(seed, P, C, K)
    base = rng.uniform(50, 200, (C, 3))
    u = rng.normal(size=(C, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    s = rng.uniform(-30, 30, (P, 3))
    t[:] = base[c][:, None, :] + s[..., None] * u[c][:, None, :]
    w = rng.normal(size=(C, K, 3))
    w -= (w * u[:, None, :]).sum(-1, keepdims=True) * u[:, None, :]
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    p[..., :3] = w
    p[..., 3] = -(w * base[:, None, :]).sum(-1)
    m[:] = True
    return [t, v, c, p, m]


def soup_crossings(tris, valid, cell, planes, pmask, tol=1e-6):
    """Per plane k, the most crossings (exits plus enters) of a lane whose
    plane k is live, and the multiruns it drops, by the plain fold on the
    CPU (the in-plane context taken per pool; only the counts are read)."""
    T = [torch.as_tensor(np.asarray(x)).cpu() for x in (tris, valid, cell, planes, pmask)]
    pl, ok, _, _ = soup_clip_cuda._lane_planes(T[2], T[3], T[4])
    P = T[0].shape[0]
    poly = torch.zeros((P, 8, 3))
    poly[:, :3] = T[0]
    nv = torch.where(T[1], 3, 0).to(torch.int32)
    slot = torch.arange(8)
    most, runs = [], []
    for k in range(pl.shape[1]):
        n, d = pl[:, k, None, :3], pl[:, k, None, 3]
        dist = (poly[..., 0] * n[..., 0] + poly[..., 1] * n[..., 1]) + poly[..., 2] * n[..., 2] + d
        m = slot < nv[:, None]
        dn = torch.where(slot == nv[:, None] - 1, dist[:, :1], torch.roll(dist, -1, 1))
        cross = (m & (dist < -tol) & (dn > tol)).sum(1) + (m & (dist > tol) & (dn < -tol)).sum(1)
        p2, n2, mrun = mesh_clip._clip_polys_plane(poly, nv, pl[:, k], tol)
        live = ok[:, k]
        poly = torch.where(live[:, None, None], p2, poly)
        nv = torch.where(live, n2, nv)
        most.append(int(torch.where(live, cross, 0).max()) if P else 0)
        runs.append(int((mrun & live).sum()))
    return most, runs


def soup_cases(device):
    """B10's degenerate cases by name: an in-plane triangle; a cell that
    straddles the 2,048-lane block boundary with an in-plane triangle on
    each side and material beyond the plane on one side only (lanes 2001
    and 2090: the block-local context keeps the first and drops the
    second); dead lanes and one live lane with the sentinel cell id C; 77
    lanes; one plane; no valid lane; at K = 32 the multirun pool
    (``soup_multirun_pool``) whole and cut after the first plane on which a
    lane crosses three or more times (its multi-cut sums then stand in the
    result's slots); triangles in the plane z = -0 (cut points with z = -0,
    summed from +0); lanes emptied at the first plane and at the last;
    the random pool with int64 cell ids and with int32 ids."""
    flat = np.array([[0.2, 0.0, 0.0], [0.0, 0.3, 0.0], [-0.2, -0.1, 0.0]], np.float32)
    cases = {"random": _soup_random(0)}
    t, v, c, p, m = cases["in-plane triangle"] = _soup_random(3)
    p[c[0], 0], m[c[0], 0], t[0], v[0] = [0, 0, 1, 0], True, flat, True
    t, v, c, p, m = cases["block straddle"] = _soup_random(5, P=2100, C=2, K=6)
    c[:2000], c[2000:] = 0, 1
    rng = np.random.default_rng(11)
    t[2000:2048] = rng.uniform(-1, 1, (48, 3, 3))
    t[2000:2048, :, 2] = -np.abs(t[2000:2048, :, 2]) - 0.01
    t[2048:] = rng.uniform(-1, 1, (52, 3, 3))
    t[2001] = t[2090] = flat
    v[2000:] = True
    p[1], m[1] = 0.0, False
    p[1, 0], m[1, 0] = [0, 0, 1, 0], True
    t, v, c, p, m = cases["sentinel ids"] = _soup_random(8)
    c[-40:], v[-40:-1], v[-1] = p.shape[0], False, True
    cases["77 lanes"] = _soup_random(9, P=77)
    cases["K = 1"] = _soup_random(10, K=1)
    t, v, c, p, m = cases["no valid lane"] = _soup_random(12)
    v[:] = False
    mr = cases["multirun, K = 32"] = soup_multirun_pool()
    most, _ = soup_crossings(*mr)
    cut = next(k for k, n in enumerate(most) if n >= 3) + 1
    cases[f"multirun cut at K = {cut}"] = [mr[0], mr[1], mr[2], mr[3][:, :cut].copy(),
                                          mr[4][:, :cut].copy()]
    t, v, c, p, m = cases["z = -0 plane"] = _soup_random(13, K=32)
    t[..., 2] = -0.0
    p[..., 2] = 0.0
    p[..., :2] /= np.linalg.norm(p[..., :2], axis=-1, keepdims=True)
    m[:, 3:] = False                                   # three live planes: lanes survive
    t, v, c, p, m = cases["emptied at the first and the last plane"] = _soup_random(14, K=32)
    m[:] = True
    t[c == 0] = np.abs(t[c == 0])
    p[0, 0] = [1.0, 1.0, 1.0, 0.01]                    # removes cell 0's lanes at once
    t[c == 1] *= 0.1
    p[1, :, 3] = -np.abs(p[1, :, 3]) - 0.5             # cell 1 keeps its lanes ...
    p[1, -1] = [0.0, 0.0, 0.0, 1.0]                    # ... until its last plane
    r = _soup_random(15, P=600)
    cases["int64 cell ids"] = [r[0], r[1], r[2].astype(np.int64), r[3], r[4]]
    cases["int32 cell ids"] = r
    return {name: (tuple(torch.as_tensor(x, device=device) for x in case), {})
            for name, case in cases.items()}


def compare_soup(a, kw):
    """n_vert and the drop count exactly; all S = 8 slots of every lane bit
    for bit (NaN against NaN). Returns the largest difference, 0."""
    got = soup_clip_cuda.soup_clip_pooled(*a, **kw)
    want = soup_clip_cuda.soup_clip_pooled_reference(*a, **kw)
    if not torch.equal(got[1], want[1]):
        bad = torch.nonzero(got[1] != want[1]).flatten().tolist()
        fail(f"soup_clip: n_vert differs from the plain fold in lanes {bad[:10]} "
             f"({len(bad)} in all)")
    if int(got[2]) != int(want[2]):
        fail(f"soup_clip: {int(got[2])} multirun drops, the plain fold {int(want[2])}")
    return _same_bits("soup_clip", "polygon slots", got[0], want[0])


def soup_live(a) -> tuple[int, int]:
    """(lanes, lane x plane steps) that B10's fold runs on these inputs: the
    lanes folded through at least one live plane, and the live planes of
    each up to the one that finds its polygon empty."""
    steps = soup_clip_cuda.soup_clip_pooled_reference(*a, per_lane=True)[3][1]
    return int((steps > 0).sum()), int(steps.sum())


def soup_ops(a, S: int = 8) -> float:
    """Float operations the pooled fold needs on these inputs: per valid
    lane with a cell, per live plane of its cell, the context test of its
    three corners (18); per fold step (``soup_live``) the fold of its S
    slots (36 each)."""
    tri, valid, cell, planes, pmask = a[:5]
    C = planes.shape[0]
    inside = (cell >= 0) & (cell < C)
    live = pmask[cell.long().clamp(0, C - 1)].sum(1) * (valid & inside)
    return float(live.sum()) * 18 + soup_live(a)[1] * S * 36.0


def soup_kernel_phase(calls, card):
    """B10 against its plain version on the card: the calls captured from
    the sphere decomposition and the pooled impact, then the degenerate
    cases; kernel and plain ms summed over the sphere event's calls, and
    its bound."""
    cases = soup_cases("cuda")
    err = 0.0
    for a, kw in [c for path in calls.values() for c in path] + list(cases.values()):
        err = max(err, compare_soup(a, kw))
    torch.cuda.synchronize()
    nv = soup_clip_cuda.soup_clip_pooled(*cases["block straddle"][0])[1]
    if not (int(nv[2001]) == 3 and int(nv[2090]) == 0):
        fail("soup_clip: the in-plane context is not per 2,048-lane block")
    out = {"max_abs_err": err}
    for path, pc in calls.items():
        ms = sum(event_ms(lambda a=a, kw=kw: soup_clip_cuda.soup_clip_pooled(*a, **kw))
                 for a, kw in pc)
        # The two kernels alone, as the profiler sees them on the device
        # (``ms`` is the wrapper's whole call); the memset is the rest.
        split = [device_split(functools.partial(soup_clip_cuda.soup_clip_pooled, *a, **kw),
                              "soup_") for a, kw in pc]
        device_ms = sum(x[0] for x in split)
        ops = sum(x[2] for x in split)
        plain_ms = sum(event_ms(lambda a=a, kw=kw: soup_clip_cuda.soup_clip_pooled_reference(
            *a, **kw), warmup=1) for a, kw in pc)
        b_ms, b_by = bound(sum(nbytes(a) + nbytes(soup_clip_cuda.soup_clip_pooled(*a, **kw))
                               for a, kw in pc), sum(soup_ops(a) for a, _ in pc))
        live = [soup_live(a) for a, _ in pc]
        out[path] = {"ms": ms, "device_ms": device_ms, "other_device_ms": sum(x[1] for x in split),
                     "device_launches": ops, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "live_lanes": [x[0] for x in live],
                     "live_lane_planes": [x[1] for x in live],
                     "shapes": [[tuple(a[0].shape), tuple(a[3].shape)] for a, _ in pc]}
        print(f"soup_clip ({path}): kernel {ms:.4f} ms (its two kernels {device_ms:.4f} ms on the "
              f"device; {ops:.0f} device operations a call, the memset and the two launches)  "
              f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  lanes x planes "
              f"{out[path]['shapes']}, live lanes {out[path]['live_lanes']}, live lane x plane "
              f"{out[path]['live_lane_planes']}  ({card})", flush=True)
    print(f"soup_clip: max_abs_err {err:.3e} over {sum(map(len, calls.values()))} main-path "
          f"calls and {len(cases)} degenerate cases ({', '.join(cases)})", flush=True)
    return out


def _mesh_volume(model):
    """The mesh volume (float64) of a procedural model or a (verts, tris)
    pair."""
    v, f = get_model(model) if isinstance(model, str) else model
    v = v.astype(np.float64)
    return float(np.einsum("ij,ij->i", v[f[:, 0]], np.cross(v[f[:, 1]], v[f[:, 2]])).sum() / 6)


def sphere_phase():
    """The sphere's 1k decomposition on the card (launches counted: B10
    once, B1-B4 as the cube's), its output checked, and the same event
    through the plain path on the CPU: piece count exactly, total volume
    within rtol 1e-5. Returns (launches, metrics, B10 calls)."""
    reset_all()
    calls, (pieces, _, met) = capture("soup_clip_pooled",
                                      lambda: run_prepare("cuda", model="sphere"))
    counts = all_counts()
    gpu = {k: float(v) for k, v in met.items()}
    print("sphere decomposition (cuda):", json.dumps(gpu), "launches:", json.dumps(counts),
          flush=True)
    check_launches("sphere decomposition", counts,
                   {**{name: want for name, (*_, want) in KERNELS.items()}, "soup_clip": 1})
    mesh_vol = _mesh_volume("sphere")
    fv = pieces.convex.face_verts
    P = workload.BENCH_CFG.max_pieces
    if fv.shape[0] != P or not bool(torch.isfinite(fv).all()) or int(gpu["piece_cnt"]) <= 0:
        fail(f"sphere pieces are not finite, not {P} slots or none")
    # At most the ACH's overshoot of the mesh (tests/test_fracture.py:69-79).
    # No lower bound: pieces whose triangles overflow Tp lose volume in the
    # JAX package too.
    if not 0.0 < gpu["total_volume"] <= mesh_vol * 1.6:
        fail(f"sphere total_volume {gpu['total_volume']} against the mesh's {mesh_vol}")
    t0 = time.perf_counter()
    _, _, met_cpu = run_prepare("cpu", model="sphere")
    cpu = {k: float(v) for k, v in met_cpu.items()}
    print(f"sphere decomposition (cpu, plain): {json.dumps(cpu)} in "
          f"{time.perf_counter() - t0:.2f} s; mesh volume {mesh_vol:.6f}", flush=True)
    if int(cpu["piece_cnt"]) != int(gpu["piece_cnt"]):
        fail(f"sphere piece_cnt: cuda {gpu['piece_cnt']} != cpu {cpu['piece_cnt']}")
    if abs(cpu["total_volume"] - gpu["total_volume"]) > 1e-5 * abs(cpu["total_volume"]):
        fail(f"sphere total_volume: cuda {gpu['total_volume']} vs cpu {cpu['total_volume']}")
    return counts, gpu, calls


def _impact_compare(route, out, met, cout, cmet, strict):
    """The card's event against the CPU plain run's: every overflow 0 on
    both sides; if ``strict``, the counts, ``valid`` and the dense groups
    exactly; the total volume within rtol 1e-5 and within rtol 1e-3 of the
    cube's 27 (tests/test_fracture.py:88)."""
    g = {k: float(v) for k, v in met.items()}
    c = {k: float(v) for k, v in cmet.items()}
    for k in IMPACT_OVERFLOWS:
        if g[k] or c[k]:
            fail(f"impact ({route}): {k} is {g[k]} on the card, {c[k]} on the cpu")
    if strict:
        for k in IMPACT_COUNTS:
            if g[k] != c[k]:
                fail(f"impact ({route}): {k} cuda {g[k]} != cpu {c[k]}")
        if not (torch.equal(out.valid.cpu(), cout.valid) and torch.equal(out.group.cpu(),
                                                                          cout.group)):
            fail(f"impact ({route}): valid or group differ from the cpu plain run")
    if abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(c["total_volume"]):
        fail(f"impact ({route}): total_volume cuda {g['total_volume']} vs cpu {c['total_volume']}")
    if abs(g["total_volume"] - 27.0) > 1e-3 * 27.0:
        fail(f"impact ({route}): total_volume {g['total_volume']} not within rtol 1e-3 of 27")
    if not g["new_pieces"] > 0:
        fail(f"impact ({route}): no new piece")


def impact_phase():
    """The cube32 impact on the card under both routes from one cube
    prepared on the card, launches counted around each event ("auto": B1,
    B3, B4 and no B10; "pooled": also B10 once), each compared with the CPU
    plain run from the same prepared pieces. The pooled route's card branch
    (cull, pack, B10 with its block-local context) is also held against the
    CPU branch (no pack, per-job context) on its own inputs, on the card:
    where no job differs ("context splits" 0) the comparison is exact,
    else counts and groups may differ by those jobs and only the volumes
    are compared. Returns (prepared pieces, per route launches and metrics,
    B10 calls)."""
    prepared, _ = workload.run_impact("cuda")
    res, soup_calls, clip_calls = {}, [], []
    for route, cfg in IMPACT_ROUTES.items():
        reset_all()
        run = lambda cfg=cfg: workload.run_impact("cuda", cfg, prepared)  # noqa: E731
        clips, (pooled, (soup, (_, (out, met)))) = capture("clip_planes_batch", lambda: capture(
            "_pooled_job_mesh_clip", lambda: capture("soup_clip_pooled", run)))
        counts = all_counts()
        soup_calls += soup
        clip_calls += clips
        want = {"clip_fold": "> 0", "labels": "> 0", "labels_general": "> 0", "refit": "> 0",
                "soup_clip": 1 if route == "pooled" else 0}
        check_launches(f"impact ({route})", counts, want)
        splits = 0
        for a, kw in pooled:
            card_b = pipeline._pooled_job_mesh_clip(*a, **kw)
            cpu_b = pipeline._pooled_job_mesh_clip(*a, on_card=False, **kw)
            live = cpu_b[1][..., None, None] | card_b[1][..., None, None]
            diff = ((card_b[1] != cpu_b[1]).any(1)
                    | (torch.where(live, card_b[0] - cpu_b[0], 0.0) != 0).flatten(1).any(1))
            splits += int(diff.sum()) + int(card_b[2] != cpu_b[2])
        t0 = time.perf_counter()
        _, (cout, cmet) = workload.run_impact("cpu", cfg, prepared)
        cpu_s = time.perf_counter() - t0
        g = {k: float(v) for k, v in met.items()}
        print(f"impact ({route}, cuda): {json.dumps(g)} launches: {json.dumps(counts)}; "
              f"cpu plain run in {cpu_s:.2f} s: {json.dumps({k: float(v) for k, v in cmet.items()})}"
              + (f"; pooled clip {tuple(pooled[0][0][1].shape)} jobs x tris, context splits "
                 f"{splits}" if pooled else ""), flush=True)
        _impact_compare(route, out, met, cout, cmet, strict=splits == 0)
        res[route] = {"launches": counts, "metrics": g, "context_splits": splits}
    err = max(compare_clip(a, kw) for a, kw in clip_calls)
    res["clip_fold_max_abs_err"] = err
    print(f"clip_fold on the impact's {len(clip_calls)} calls (N, F, S, K) "
          f"{[list(a[0].face_verts.shape[:3]) + [a[1].shape[1]] for a, _ in clip_calls]}: "
          f"max_abs_err {err:.3e}", flush=True)
    return prepared, res, soup_calls


def profile_busy(fn, runs: int):
    """(device busy ms, wall ms, idle share, device entries) per run of
    ``fn`` under torch.profiler; the idle share is None when the profiler
    reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    busy_us = 0.0
    entries = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        busy_us += us
        entries += e.count
    busy = busy_us / runs / 1e3
    return busy, wall, ((1.0 - busy / wall) if busy > 0 else None), entries / runs


def _profile_split(call, kernel: str, runs: int, sessions: int):
    """(kernel device ms, other device ms, device entries) per run of
    ``call`` under torch.profiler, after one warm-up run; the kernel's ms
    is None where no session holds it (see ``device_split``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    seen = []   # (kernel us, kernel records, other us, records) of each session
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
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
        seen.append((k_us, k_n, o_us, n))
        if k_n and k_n % runs == 0 and n >= max(r[3] for r in seen):
            return k_us / runs / 1e3, o_us / runs / 1e3, n / runs
    k_us, k_n, o_us, n = max(seen, key=lambda r: (r[1], r[3]))
    if k_n:
        per_run = -(-k_n // runs)
        scale = per_run * runs / k_n
        print(f"device_split: *{kernel}*: {k_n} of {per_run * runs} records in the fullest of "
              f"{len(seen)} profiler sessions; its time is their mean times {per_run} a run",
              flush=True)
        return k_us * scale / runs / 1e3, o_us * scale / runs / 1e3, n * scale / runs
    return None, o_us / runs / 1e3, n / runs


def device_split(call, kernel: str, runs: int = 20, required: bool = True, sessions: int = 8):
    """(kernel device ms, other device ms, device entries) per run of
    ``call`` under torch.profiler, after one warm-up run: the entries whose
    names contain ``kernel``, and everything else ``call`` runs on the
    device. ``call`` is a ``functools.partial`` of a module-level function,
    so that another process can make the same call.

    The profiler drops device records once the process has launched many
    kernels (on the H100 most sessions of phases 13 to 15 keep only part
    of the runs' records, and late in the run a session may keep none of
    a kernel); the records it keeps are whole launches. So a session is
    used as it stands only when it holds the kernel's records whole (a
    multiple of ``runs``) and no fewer device records than any session
    before it. Up to ``sessions`` are taken; if none holds the kernel
    whole, its time is the mean of the records of the fullest session
    times its launches a run (that session's records ÷ ``runs``, rounded
    up), the rest scaled alike, and a line says so. A kernel that no
    session shows is measured the same way in a fresh process
    (``fresh_device_split``), which fails if none of its sessions shows
    it either; with ``required=False`` it gives None instead."""
    split = _profile_split(call, kernel, runs, sessions)
    if split[0] is not None or not required:
        return split
    print(f"device_split: *{kernel}*: no profiler session of {sessions} in this process holds "
          "it; profiled in a fresh process instead", flush=True)
    return fresh_device_split([(call, kernel, runs, sessions)])[0]


FRESH_DIR = "build/device_split"


def fresh_device_split(jobs):
    """``device_split`` of each (call, kernel, runs, sessions) of ``jobs``
    in one fresh process (``python chip_smoke.py --device-split DIR``): the
    calls are saved with torch.save, their tensors on the card, and made
    there in the same way. Fails if that process fails, or if its profiler
    shows one of the kernels in no session."""
    import os
    import subprocess
    import tempfile

    os.makedirs(FRESH_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=FRESH_DIR) as d:
        torch.save(jobs, os.path.join(d, "jobs.pt"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--device-split", d],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"device_split in a fresh process exited {proc.returncode}: "
                 f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
        with open(os.path.join(d, "splits.json")) as fh:
            out = [tuple(x) for x in json.load(fh)]
    for line in proc.stdout.splitlines():
        print(f"  (fresh process) {line}", flush=True)
    print(f"device_split: {len(jobs)} call(s) profiled in a fresh process in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


# The CPU plain runs that need nothing from the card (phases 20, 21, 28 and
# 29 compare the card's runs with them): one background process computes
# them while the card's phases run, and each phase waits for its own.
CPU_DIR = "build/cpu_runs"
CPU_RUNS = ("torus config 1", "Scene('torus')", "Scene('blob')", "cube 1k, refit limit 20",
            "torus config 1, refit limit 20", "sphere 1k, mesh_pair_pool=False",
            "config 1 at model scale (10,000-triangle torus)")
_cpu_proc = None


def cpu_run_fn(name):
    """The CPU plain run ``name``: a decomposition event's (pieces, ctx,
    metrics), or a concave Scene built on the CPU."""
    events = {
        "torus config 1": (workload.MODEL_1K_CFG, workload.CONCAVE_MODEL),
        "cube 1k, refit limit 20": (refit_cfg(workload.BENCH_CFG, 20), "cube"),
        "torus config 1, refit limit 20": (refit_cfg(workload.MODEL_1K_CFG, 20),
                                           workload.CONCAVE_MODEL),
        "sphere 1k, mesh_pair_pool=False": (dataclasses.replace(workload.BENCH_CFG,
                                                                mesh_pair_pool=False), "sphere"),
        CPU_RUNS[6]: (workload.MODEL_1K_CFG, None),
    }
    if name.startswith("Scene("):
        return lambda: workload.concave_scene(name[7:-2], "cpu")
    cfg, model = events[name]
    return lambda: run_prepare("cpu", cfg, workload.model_scale_mesh() if model is None else model)


def cpu_runs_main(d):
    """The background process of ``start_cpu_runs``: each of ``CPU_RUNS``
    on the CPU, saved as ``d``/<index>.pt (result, seconds) in that order,
    at the lowest CPU priority, so that the card's host-paced phases keep
    their pace."""
    import os

    os.nice(19)
    for i, name in enumerate(CPU_RUNS):
        t0 = time.perf_counter()
        out = cpu_run_fn(name)()
        tmp = os.path.join(d, f"{i}.pt.tmp")
        torch.save((out, time.perf_counter() - t0), tmp)
        os.replace(tmp, os.path.join(d, f"{i}.pt"))


def start_cpu_runs():
    """Starts ``python chip_smoke.py --cpu-runs DIR`` (no card visible to
    it); ``cpu_run`` waits for each result, and the process is stopped when
    this one exits."""
    import atexit
    import os
    import shutil
    import subprocess

    global _cpu_proc
    shutil.rmtree(CPU_DIR, ignore_errors=True)
    os.makedirs(CPU_DIR)
    log = open(os.path.join(CPU_DIR, "log.txt"), "w")
    _cpu_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-runs", CPU_DIR], stdout=log,
        stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    def stop():
        if _cpu_proc.poll() is None:
            _cpu_proc.kill()
            _cpu_proc.wait()
    atexit.register(stop)


def cpu_run(name):
    """(result, seconds) of the CPU plain run ``name``: from the background
    process when it runs (waiting for it), else computed here."""
    import os

    if _cpu_proc is None:
        t0 = time.perf_counter()
        out = cpu_run_fn(name)()
        return out, time.perf_counter() - t0
    path = os.path.join(CPU_DIR, f"{CPU_RUNS.index(name)}.pt")
    while not os.path.exists(path):
        if _cpu_proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(CPU_DIR, "log.txt")) as fh:
                fail(f"the CPU plain runs' process exited {_cpu_proc.returncode} before "
                     f"{name!r}: {fh.read()[-2000:]}")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def device_split_main(d):
    """The fresh process of ``fresh_device_split``: each saved call's split
    into ``d``/splits.json."""
    import os

    _build.library()
    jobs = torch.load(os.path.join(d, "jobs.pt"), weights_only=False)
    out = []
    for call, kernel, runs, sessions in jobs:
        split = _profile_split(call, kernel, runs, sessions)
        if split[0] is None:
            fail(f"the profiler shows no device kernel named *{kernel}*, in a fresh process too")
        out.append(split)
    with open(os.path.join(d, "splits.json"), "w") as fh:
        json.dump(out, fh)


def span_split(stages, run, reps: int, warmup: int = 0, total: str = "event") -> dict:
    """Median over ``reps`` runs of ``run`` (after ``warmup`` more) of
    CUDA-event ms per stage: a stage is the span of one of ``stages``'
    (label, module, function) (outermost calls only, repeated calls
    summed), "glue" the rest of the run and ``total`` the whole run."""
    spans, depth, saved = [], [0], []
    for label, mod, name in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _label=label, **kw):
            if depth[0]:
                return _fn(*a, **kw)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            depth[0] += 1
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1
                e.record()
                spans.append((_label, s, e))

        setattr(mod, name, wrapped)
    per = {}
    try:
        for r in range(warmup + reps):
            spans.clear()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
            if r < warmup:
                continue
            acc = {}
            for label, s, e in spans:
                acc[label] = acc.get(label, 0.0) + s.elapsed_time(e)
            acc["glue"] = t0.elapsed_time(t1) - sum(acc.values())
            acc[total] = t0.elapsed_time(t1)
            for k, v in acc.items():
                per.setdefault(k, []).append(v)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {k: statistics.median(v) for k, v in per.items()}


def impact_stage_split(cfg, prepared, reps: int = 10) -> dict:
    """Median CUDA-event ms per stage of one impact event: a stage is the
    span of a pipeline function ``do_fracture`` calls, "glue" the rest of
    the event."""
    pieces, ctx = prepared
    return span_split([(n, pipeline, n) for n in IMPACT_STAGES],
                      lambda: pipeline.do_fracture(pieces, ctx, workload.IMPACT, 0, cfg,
                                                   partial=True), reps, warmup=2)


def fracture_timing(prepared, card, reps: int = 10):
    """ms per event on the card (host clock, synchronize at the end, median
    of ``reps``): the sphere decomposition and the cube32 impact under both
    routes; each impact route's stage split and device idle share."""
    out = {"sphere_prepare_ms": host_ms(lambda: run_prepare("cuda", model="sphere"), reps=reps)}
    print(f"prepare_fracture sphere 1k: median {out['sphere_prepare_ms']:.3f} ms/event ({card})",
          flush=True)
    for route, cfg in IMPACT_ROUTES.items():
        ms = host_ms(lambda cfg=cfg: workload.run_impact("cuda", cfg, prepared), reps=reps)
        split = impact_stage_split(cfg, prepared)
        busy, wall, idle, entries = profile_busy(
            lambda cfg=cfg: workload.run_impact("cuda", cfg, prepared), 5)
        out[route] = {"event_ms": ms, "stages_ms": split, "busy_ms": busy,
                      "profiled_wall_ms": wall, "idle_share": idle, "device_entries": entries}
        print(f"do_fracture cube32 ({route}): median {ms:.3f} ms/event of {reps} ({card})",
              flush=True)
        print(f"impact ({route}) stage split, one event (CUDA events, ms): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
        print(f"impact ({route}) idle share "
              + (f"{idle:.3f}: device busy {busy:.3f} ms of {wall:.3f} ms per event under the "
                 f"profiler, {entries:.0f} device entries per event" if idle is not None
                 else "not measured: the profiler reported no device time"), flush=True)
    return out


# ---------------------------------------------------------------------------
# The interactive frame (Scene, raycast, shadow-mapped render) and kernel B11.
# ---------------------------------------------------------------------------

RASTER_SRC = "surtr_tpu_torch/csrc/raster.cu"
RASTER_REPLACES = "surtr_tpu/render/raster_pallas.py:37"
# Launches of one interactive frame: the two raster passes, one physics step
# (compound bodies, 256 pieces: the plain block sweep and the plain solver);
# the fracture kernels B1, B3 and B4 as the event runs them.
FRAME_LAUNCHES = {"raster": 2, "raster_glue": 2, "pack": 1, "narrowphase": 1}
FRAME_ANY = ("clip_fold", "labels", "refit")
FRAME_OVERFLOWS = ("active_overflow", "job_overflow", "piece_overflow", "split_face_overflow")
FRAME_COMPARE = 3          # frames compared with the CPU plain run
# The fracture kernels of the first frame, by pipeline function.
FRAME_FRACTURE = {"clip_fold": "clip_planes_batch", "labels": "tri_soup_components_batch",
                  "refit": "refit_planes_from_parts"}
# Stages of a frame: (label, module, function); spans of outermost calls.
FRAME_STAGES = [
    ("raycast/targets", scene_mod, "raycast"), ("raycast/targets", scene_mod, "sphere_overlap"),
    ("bake", scene_mod, "_bake_pieces"), ("do_fracture", scene_mod, "do_fracture"),
    ("rebuild", scene_mod, "build_scene"), ("rebuild", scene_mod, "_transfer_velocities"),
    ("physics", scene_mod, "physics_step"), ("shadow raster", render_raster, "rasterize_ids"),
    ("camera raster", render_raster, "raster_screen"),
    ("shading", render_raster, "_shade_deferred"),
]
# Operations per (pixel, live triangle) test of B11: three edge functions
# (2 subtractions, 2 products, 1 subtraction each), three weights, the depth
# (3 products, 2 sums) and six compares.
RASTER_OPS = 29


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare_raster(a):
    """B11 kernel against its plain version on one packed table ``a`` =
    (attrs, bbox, rng, nty, ntx, H, W, A, order): depth, sorted-domain ids
    and G-buffer bit for bit, and the ids in the caller's order. Returns the
    largest |kernel - plain| over depth and G-buffer."""
    got = raster_cuda.tile_raster(*a[:8])
    want = raster_cuda.tile_raster_reference(*a[:8])
    mapped = raster_cuda.tile_raster(*a)[1]
    want_mapped = raster_cuda._finish(a[8], *want)[1]
    for what, g, w in zip(("depth", "ids", "G-buffer", "ids (caller's order)"),
                          (*got, mapped), (*want, want_mapped)):
        if (g is None) != (w is None) or (g is not None and not torch.equal(_bits(g), _bits(w))):
            bad = 0 if g is None or w is None else int((_bits(g) != _bits(w)).sum())
            fail(f"raster: {what} differ from the plain version ({bad} entries, table "
                 f"{tuple(a[0].shape)}, image {a[5]}x{a[6]})")
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want) if g is not None and g.is_floating_point())


def compare_raster_glue(g):
    """B11's glue kernels (``raster_cuda.tile_table`` on the card) against
    ``_tile_table`` on the same inputs ``g`` = (sx, sy, sz, ok, W, H,
    attr_tab): the table and ranges bit for bit, the sort order equal, the
    chunk boxes equal in value (a box edge of 0 may come out as -0 or +0,
    which the raster's compares do not tell apart)."""
    got = raster_cuda.tile_table(*g)
    want = raster_cuda._tile_table(*g)
    for what, x, y in zip(("table", "chunk boxes", "tile ranges", "order"), got[:4], want[:4]):
        same = torch.equal(x, y) if what == "chunk boxes" else torch.equal(_bits(x), _bits(y))
        if x.shape != y.shape or not same:
            fail(f"raster glue: {what} differ from _tile_table's (table {tuple(want[0].shape)})")
    if got[4] != want[4]:
        fail(f"raster glue: tile grid {got[4]} != {want[4]}")


def raster_ops(a) -> float:
    """Operations B11 needs on this table: per (tile, chunk) pair inside
    the tile's range and past the box reject, its live triangles (valid,
    |area| > 1e-12) times the tile's 2,048 pixels times RASTER_OPS."""
    attrs, bbox, rng, nty, ntx = a[:5]
    ax, ay, bx, by, cx, cy = (attrs[:, j] for j in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    live = ((attrs[:, 9] > 0.5) & (area.abs() > 1e-12)).reshape(-1, raster_cuda.CHUNK).sum(1)
    _, chunk = raster_cuda._chunk_pairs(bbox, rng, nty, ntx)
    return float(live[chunk].sum()) * raster_cuda.TH * raster_cuda.TW * RASTER_OPS


def live_pairs(a) -> tuple[int, int]:
    """(live (tile, chunk) pairs of the table, the most in one tile)."""
    tiles, _ = raster_cuda._chunk_pairs(a[1], a[2], a[3], a[4])
    return int(tiles.numel()), int(torch.bincount(tiles).max()) if tiles.numel() else 0


def _dense_tile_inputs():
    """400 triangles centred in one 16 x 128 tile of a 256 x 64 image (7
    chunks), with copies of a tile-covering triangle at constant depth 0.5
    and of one random triangle across chunk boundaries (depth ties)."""
    rng = np.random.default_rng(9)
    T = 400
    c = rng.uniform([8.0, 2.0], [120.0, 14.0], (T, 1, 2))
    xy = c + rng.normal(0, [30.0, 6.0], (T, 3, 2))
    xy = (xy - xy.mean(1, keepdims=True) + c).astype(np.float32)
    sz = rng.uniform(0.05, 0.95, (T, 3)).astype(np.float32)
    ok = rng.uniform(size=T) > 0.05
    for i in (5, 63, 64, 130, 200, 260):
        xy[i], sz[i], ok[i] = [[-200.0, -40.0], [300.0, -40.0], [64.0, 80.0]], 0.5, True
    for i in (127, 128, 191, 192):
        xy[i], sz[i], ok[i] = xy[10], sz[10], True
    ok[10] = True
    return xy, sz, ok, rng.normal(size=(T, 7)).astype(np.float32), 256, 64


def raster_cases(device):
    """B11's degenerate inputs by name, as (glue inputs, packed table): 40
    triangles (one partial chunk), 100 (not a multiple of 64), none valid, a
    256 x 64 image with a G-buffer, a screen-covering triangle, an exact
    duplicate and off-screen ones, and a dense tile of 400 triangles with
    depth ties across chunks."""
    cases = {}
    for name, (seed, T, W, H, A, none) in {
            "T = 40": (1, 40, 512, 512, 0, False), "T = 100": (2, 100, 512, 512, 7, False),
            "no valid triangle": (3, 96, 512, 512, 7, True),
            "256 x 64, ties": (4, 160, 256, 64, 7, False),
            "dense tile": (9, 400, 256, 64, 7, False)}.items():
        if name == "dense tile":
            xy, sz, ok, attr, W, H = _dense_tile_inputs()
        else:
            rng = np.random.default_rng(seed)
            c = rng.uniform(-20, [W + 20, H + 20], (T, 1, 2))
            xy = (c + rng.normal(0, 40, (T, 3, 2))).astype(np.float32)
            sz = rng.uniform(-0.1, 1.1, (T, 3)).astype(np.float32)
            ok = rng.uniform(size=T) > 0.05
            xy[0] = [[-10, -10], [3 * W, -10], [-10, 3 * H]]
            sz[0] = 0.9
            xy[2], sz[2] = xy[1], sz[1]
            ok[:3], ok[3] = True, False
            xy[4, :, 0] += 10 * W
            ok &= not none
            attr = rng.normal(size=(T, A)).astype(np.float32) if A else None
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
        g = (t(xy[..., 0]), t(xy[..., 1]), t(sz), t(ok), W, H, None if attr is None else t(attr))
        attrs, bbox, rngs, order, (nty, ntx) = raster_cuda._tile_table(*g)
        cases[name] = (g, (attrs, bbox, rngs, nty, ntx, H, W, A, order))
    return cases


def capture_raster(fn):
    """The glue inputs ``fn`` hands to ``raster_cuda.tile_table`` and the
    tables it hands to ``raster_cuda.tile_raster``, as (glue inputs,
    table) per call (the kernels still run, so counts are unchanged)."""
    glue, tables = [], []
    orig = raster_cuda.tile_table, raster_cuda.tile_raster

    def rec_glue(*g):
        glue.append(g)
        return orig[0](*g)

    def rec(*a):
        tables.append(a)
        return orig[1](*a)

    raster_cuda.tile_table, raster_cuda.tile_raster = rec_glue, rec
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        raster_cuda.tile_table, raster_cuda.tile_raster = orig
    return list(zip(glue, tables))


def raster_call_times(g, a):
    """One call's split: the wrapper's ms (CUDA events around
    ``rasterize_ids_tiled``, median of 20), the kernel's device ms, the
    glue's device ms and device launches (torch.profiler), the live pairs
    and the most in one tile."""
    wrapper = event_ms(lambda: raster_cuda.rasterize_ids_tiled(*g))
    kernel, memset, _ = device_split(functools.partial(raster_cuda.tile_raster, *a),
                                     "raster_kernel")
    pack, rest, entries = device_split(functools.partial(raster_cuda.tile_table, *g),
                                       "raster_pack")
    pairs, most = live_pairs(a)
    return {"wrapper_ms": wrapper, "device_ms": kernel, "memset_device_ms": memset,
            "glue_device_ms": pack + rest, "glue_device_launches": entries, "live_pairs": pairs,
            "max_tile_pairs": most, "shape": [int(a[0].shape[0]), a[7], a[5], a[6]]}


def raster_kernel_phase(frame_calls, card):
    """Phase 15: B11 against its plain version, and its glue against
    ``_tile_table``, on the frame's two calls, render_512's at shadow 512
    and 1024 and the degenerate inputs, bitwise; per call the wrapper's
    time, the kernel's and the glue's device time and launches and the live
    pairs; per input set the kernel ms (CUDA events, median of 20, per call
    summed), its device ms under the profiler, the plain ms and the
    bound."""
    inputs = workload.render_512_inputs("cuda")
    sets = {"interactive frame": frame_calls}
    for shadow in (512, 1024):
        sets[f"render_512, shadow {shadow}"] = capture_raster(
            lambda s=shadow: workload.run_render_512("cuda", s, inputs))
    cases = raster_cases("cuda")
    pairs = [c for calls in sets.values() for c in calls] + list(cases.values())
    err = max(compare_raster(a) for _, a in pairs)
    for g, _ in pairs:
        compare_raster_glue(g)
    torch.cuda.synchronize()
    dense = live_pairs(cases["dense tile"][1])
    print(f"raster: dense tile {dense[0]} live pairs, {dense[1]} in one tile", flush=True)
    out = {"max_abs_err": err}
    for name, calls in sets.items():
        tables = [a for _, a in calls]
        ms = sum(event_ms(lambda a=a: raster_cuda.tile_raster(*a)) for a in tables)
        split = [raster_call_times(g, a) for g, a in calls]
        for t in split:
            print(f"raster ({name}) call [T_pad, A, H, W] {t['shape']}: wrapper "
                  f"{t['wrapper_ms']:.4f} ms; on the device kernel {t['device_ms']:.4f} ms, "
                  f"glue {t['glue_device_ms']:.4f} ms in {t['glue_device_launches']:.0f} launches; "
                  f"{t['live_pairs']} live pairs, {t['max_tile_pairs']} in the densest tile "
                  f"({card})", flush=True)
        device_ms = sum(t["device_ms"] for t in split)
        plain_ms = sum(event_ms(lambda a=a: raster_cuda.tile_raster_reference(*a[:8]), reps=5,
                                warmup=1) for a in tables)
        b_ms, b_by = bound(sum(nbytes(a[:3]) + nbytes(raster_cuda.tile_raster(*a))
                               for a in tables), sum(raster_ops(a) for a in tables))
        out[name] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "shapes": [t["shape"] for t in split],
                     "wrapper_ms": sum(t["wrapper_ms"] for t in split),
                     "glue_device_ms": sum(t["glue_device_ms"] for t in split),
                     "glue_device_launches": sum(t["glue_device_launches"] for t in split),
                     "calls": split}
        print(f"raster ({name}): kernel {ms:.4f} ms (the kernel alone {device_ms:.4f} ms on the "
              f"device; glue {out[name]['glue_device_ms']:.4f} ms on the device; wrapper "
              f"{out[name]['wrapper_ms']:.4f} ms)  plain {plain_ms:.3f} ms  bound {b_ms:.5f} ms "
              f"({b_by})  ({card})", flush=True)
    print(f"raster: bitwise on {sum(map(len, sets.values()))} main-path calls and {len(cases)} "
          f"degenerate inputs ({', '.join(cases)}), glue and kernel, max_abs_err {err:.3e}",
          flush=True)
    return out


def _frame_checks(i, met, img, what):
    """The frame's image is finite, in [0, 1], of the configured size; the
    first frame fractures and keeps the cube's volume (rtol 1e-3,
    tests/test_fracture.py:88). Returns the metrics as floats."""
    g = {k: float(v) for k, v in met.items()}
    rc = workload.INTERACTIVE_CFG.render
    if img.shape != (rc.height, rc.width, 3) or not bool(torch.isfinite(img).all()) \
            or float(img.min()) < 0 or float(img.max()) > 1:
        fail(f"{what}: frame {i} image is not a finite {rc.height}x{rc.width} image in [0, 1]")
    if i == 0:
        if not g["new_pieces"] > 0:
            fail(f"{what}: the first frame did not fracture ({json.dumps(g)})")
        if abs(g["total_volume"] - 27.0) > 1e-3 * 27.0:
            fail(f"{what}: total_volume {g['total_volume']} not within rtol 1e-3 of 27")
    return g


def snapshot(obj):
    """``obj`` with every tensor in it copied at the same strides (tuples,
    lists, dicts, ConvexPoly): a replay then reads the same layout."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_strided(obj.size(), obj.stride(), dtype=obj.dtype,
                                   device=obj.device).copy_(obj)
    if isinstance(obj, ConvexPoly):
        return obj.map(snapshot)
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(o) for o in obj)
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()}
    return obj


def frame_main_path(card):
    """Phase 16: Scene("cube", INTERACTIVE_CFG) on the card and 16 chained
    frames through the user's entry points, counts set to 0 just before;
    launches per frame checked. Returns (counts of the run, B11's two calls
    of the first frame as (glue inputs, table), per-frame metrics, B1/B3/B4's calls of the first
    frame, B5/B7's calls of the last frame's step)."""
    reset_all()
    frames = []
    prev = {}
    first_glue, first_calls = [], []
    frac_calls = {name: [] for name in FRAME_FRACTURE}
    orig = raster_cuda.tile_table, raster_cuda.tile_raster
    saved = [(attr, getattr(pipeline, attr)) for attr in FRAME_FRACTURE.values()]

    def rec_glue(*g):
        if not frames:
            first_glue.append(g)
        return orig[0](*g)

    def rec(*a):
        if not frames:
            first_calls.append(a)
        return orig[1](*a)

    def rec_frac(*a, _fn, _name, **kw):
        if not frames:   # a copy: the later frames must not change what is replayed
            frac_calls[_name].append((snapshot(a), snapshot(kw)))
        return _fn(*a, **kw)

    def on_frame(i, sc, img, met):
        nonlocal prev
        now = all_counts()
        delta = {k: now[k] - prev.get(k, 0) for k in now}
        prev = now
        for k, n in delta.items():
            want = FRAME_LAUNCHES.get(k, 0)
            if k in FRAME_ANY:
                if i == 0 and n <= 0:
                    fail(f"interactive frame 0: {k} never launched ({json.dumps(delta)})")
            elif n != want:
                fail(f"interactive frame {i}: {k} launched {n} times, expected {want} "
                     f"({json.dumps(delta)})")
        g = _frame_checks(i, met, img, "interactive frame (cuda)")
        frames.append({"launches": delta, "pieces": sc.num_pieces(), "bodies": sc.num_bodies(),
                       **{k: g[k] for k in ("new_pieces", "total_volume", *FRAME_OVERFLOWS)}})

    raster_cuda.tile_table, raster_cuda.tile_raster = rec_glue, rec
    try:
        t0 = time.perf_counter()
        sc = workload.interactive_scene("cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prev = all_counts()
        for name, (attr, fn) in zip(FRAME_FRACTURE, saved):   # after the Scene's decomposition
            setattr(pipeline, attr, functools.partial(rec_frac, _fn=fn, _name=name))
        with StepRecorder() as steps:
            workload.run_frames(sc, workload.FRAMES, on_frame=on_frame)
            torch.cuda.synchronize()
    finally:
        raster_cuda.tile_table, raster_cuda.tile_raster = orig
        for attr, fn in saved:
            setattr(pipeline, attr, fn)
    counts = all_counts()
    # B5 and B7 at the frame's hull size (Vh = 64, F = 32) against their
    # plain versions, on the last frame's step.
    errs = {name: cmp(*steps.last[name][:2]) for name, cmp in
            (("pack", compare_pack), ("narrowphase", compare_narrowphase))}
    a = steps.last["pack"][0]
    print(f"pack and narrowphase at Vh {a[0].shape[1]}, F {a[2].shape[1]}, {a[0].shape[0]} "
          f"pieces (the last frame's step): max_abs_err {json.dumps(errs)}", flush=True)
    print(f"interactive frame (cuda): Scene init {init_s:.2f} s, launches {json.dumps(prev)} "
          f"(the Scene's decomposition included)", flush=True)
    for i, f in enumerate(frames):
        print(f"  frame {i}: " + json.dumps({k: v for k, v in f.items() if k != "launches"})
              + " launches " + json.dumps({k: v for k, v in f["launches"].items() if v}),
              flush=True)
    phys = {name: steps.last[name][:2] for name in ("pack", "narrowphase")}
    return counts, list(zip(first_glue, first_calls)), frames, frac_calls, phys


FRAME_COMPARE_FN = {"clip_fold": compare_clip, "labels": compare_labels, "refit": compare_refit,
                    "pack": compare_pack, "narrowphase": compare_narrowphase}
FRAME_KERNEL_FN = {**KERNEL_FN, "pack": pack_cuda.transform_pack_owned,
                   "narrowphase": narrowphase_cuda.narrowphase}


def frame_kernel_phase(frac_calls, phys, card):
    """Phase 15, second part: B1, B3 and B4 on the first frame's calls, B5
    and B7 on the last frame's step, each against its plain version on the
    card (the checks of phases 3 and 7) and timed at the frame's shapes:
    wrapper ms (CUDA events, median of 20, per call summed) and the
    kernel's device ms (torch.profiler)."""
    sets = {**frac_calls, **{name: [call] for name, call in phys.items()}}
    out = {}
    for name, calls in sets.items():
        if not calls:
            fail(f"interactive frame: no {name} call was recorded")
        edge = pack_edge_cases(calls[0]) if name == "pack" else []
        err = max(FRAME_COMPARE_FN[name](a, kw) for a, kw in calls + edge)
        torch.cuda.synchronize()
        split = per_call_times(name, calls, FRAME_KERNEL_FN[name], required=False)
        shapes = [list(a[0].face_verts.shape[:3]) + [a[1].shape[1]] if name == "clip_fold"
                  else list(refit_points(a)) if name == "refit" else list(a[0].shape[:2])
                  for a, _ in calls]
        ms = sum(t["ms"] for t in split)
        devs = [t["device_ms"] for t in split]
        dev = None if None in devs else sum(devs)
        out[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev, "shapes": shapes,
                     "calls": split}
        where = ("not measured (the profiler's trace lacked the kernel)" if dev is None
                 else f"{dev:.4f} ms")
        bnd = ""
        if name in FRAME_FRACTURE:
            b_ms, b_by = decomposition_bound(name, calls)
            out[name].update(bound_ms=b_ms, bound_by=b_by)
            bnd = f", bound {b_ms:.4f} ms ({b_by})"
        if name == "labels":
            bnd += f"; {sum(int(a[1].sum()) for a, _ in calls)} valid triangles"
        elif name == "refit":
            live = sum(3 * int(a[1].sum()) + int(a[3].sum()) for a, _ in calls)
            bnd += f"; {live} live points"
        print(f"{name} at the frame's shapes {shapes}: max_abs_err {err:.3e}, wrapper {ms:.4f} ms, "
              f"kernel on the device {where}{bnd} ({len(calls)} calls; {card})", flush=True)
    return out


def _scene_diff(g, c):
    """Largest body x and v differences between the card's and the CPU's
    scene."""
    dx = float((g.phys.bodies.x.cpu() - c.phys.bodies.x).abs().max())
    dv = float((g.phys.bodies.v.cpu() - c.phys.bodies.v).abs().max())
    return dx, dv


def _frame(sc):
    return sc.interactive_frame(*workload.FRAME_RAY, eye=workload.FRAME_EYE,
                                target=workload.FRAME_TARGET)


def frame_cpu_compare(card, n: int = FRAME_COMPARE):
    """Phase 17: one CPU-built Scene, copied to the card; the first ``n``
    chained frames on both devices, compared after each: valid, group and
    tag exactly, every overflow counter and count equal, total volume
    within rtol 1e-5, body x within 2e-4 and v within 2e-3, at least 99.5%
    of pixels within 1e-5. Returns the CPU-built Scene (the timing runs'
    start)."""
    t0 = time.perf_counter()
    start = workload.interactive_scene("cpu")
    print(f"interactive Scene (cpu, plain): built in {time.perf_counter() - t0:.2f} s, "
          f"{start.num_pieces()} pieces", flush=True)
    gsc, csc = workload.scene_to(start, "cuda"), workload.scene_to(start, "cpu")
    for i in range(n):
        gimg, gmet = _frame(gsc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cimg, cmet = _frame(csc)
        cpu_s = time.perf_counter() - t0
        g = _frame_checks(i, gmet, gimg, "interactive frame (cuda, from the cpu scene)")
        c = {k: float(v) for k, v in cmet.items()}
        for k in (*FRAME_OVERFLOWS, "new_pieces", "active_pieces", "merged_out", "num_groups",
                  "mesh_tris_dropped"):
            if g[k] != c[k]:
                fail(f"interactive frame {i}: {k} cuda {g[k]} != cpu {c[k]}")
        for k in ("valid", "group", "tag"):
            if not torch.equal(getattr(gsc.pieces, k).cpu(), getattr(csc.pieces, k)):
                fail(f"interactive frame {i}: pieces' {k} differ from the cpu plain run")
        if abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(c["total_volume"]):
            fail(f"interactive frame {i}: total_volume cuda {g['total_volume']} vs cpu "
                 f"{c['total_volume']}")
        dx, dv = _scene_diff(gsc, csc)
        share = float(((gimg.cpu() - cimg).abs() <= 1e-5).all(-1).float().mean())
        print(f"interactive frame {i} (cuda vs cpu plain run, {cpu_s:.2f} s on the cpu): "
              f"new_pieces {g['new_pieces']:.0f}, body x {dx:.3e}, v {dv:.3e}, pixels within "
              f"1e-5 {share:.6f}", flush=True)
        if not (dx <= 2e-4 and dv <= 2e-3 and share >= 0.995):
            fail(f"interactive frame {i}: the card parts from the cpu plain run")
    return start


def frame_stage_split(start, frames: int = workload.FRAMES) -> dict:
    """Median over ``frames`` chained frames of CUDA-event ms per stage
    (outermost calls of the FRAME_STAGES functions, repeated calls summed),
    "glue" the rest of the frame."""
    sc = workload.scene_to(start, "cuda")
    return span_split(FRAME_STAGES, lambda: _frame(sc), frames, total="frame")


def frame_timing(start, card, runs: int = 3) -> dict:
    """Phase 18: ms per frame (host clock, synchronize after each frame) of
    16 chained frames from the CPU-built Scene copied to the card, median
    of the 16, per run; the stage split; the device idle share over 5
    frames; render_512 ms at shadow 512 and 1024."""
    medians = []
    for _ in range(runs):
        sc = workload.scene_to(start, "cuda")
        ts = []
        for _ in range(workload.FRAMES):
            t0 = time.perf_counter()
            _frame(sc)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        medians.append(statistics.median(ts))
    split = frame_stage_split(start)
    sc = workload.scene_to(start, "cuda")
    busy, wall, idle, entries = profile_busy(lambda: _frame(sc), 5)
    inputs = workload.render_512_inputs("cuda")
    render = {s: host_ms(lambda s=s: workload.run_render_512("cuda", s, inputs))
              for s in (512, 1024)}
    out = {"frame_ms": statistics.median(medians), "frame_ms_runs": medians, "stages_ms": split,
           "busy_ms": busy, "profiled_wall_ms": wall, "idle_share": idle,
           "device_entries": entries, "render_512_ms": render[512],
           "render_512_shadow1024_ms": render[1024]}
    print(f"interactive frame: median {out['frame_ms']:.3f} ms/frame (medians of 16 frames in "
          f"{runs} runs: {', '.join(f'{m:.3f}' for m in medians)}) ({card})", flush=True)
    print("interactive frame stage split, median of 16 frames (CUDA events, ms): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    print("interactive frame idle share "
          + (f"{idle:.3f}: device busy {busy:.3f} ms of {wall:.3f} ms per frame under the "
             f"profiler, {entries:.0f} device entries per frame" if idle is not None
             else "not measured: the profiler reported no device time"), flush=True)
    print(f"render_512: {render[512]:.3f} ms (shadow 512), {render[1024]:.3f} ms (shadow 1024), "
          f"median of 10 ({card})", flush=True)
    return out


# ---------------------------------------------------------------------------
# The concave-model path: BASELINE config 1 on the torus (exact caps, the
# parity grid, the culled pair pool), Scene("torus") and Scene("blob").
# ---------------------------------------------------------------------------

CONCAVE_CFG = workload.MODEL_1K_CFG
CONCAVE_MODEL = workload.CONCAVE_MODEL
# Launches of one torus config-1 decomposition: B1's six folds (ACH, the two
# pattern cell sets, the two Voronoi passes, the refit), B2, B3 (its vertex
# variant at T = 128, past labels_cuda.MAX_BLOCK_T), B4, B10.
CONCAVE_LAUNCHES = {"clip_fold": 6, "ich": 1, "labels": 1, "labels_general": 1, "refit": 1,
                    "soup_clip": 1}
# Its stages: (label, pipeline function), spans of outermost calls; the
# ACH clip and the refit fold are the clip_planes_batch calls outside the
# cell clip.
CONCAVE_STAGES = (("grid build", "build_parity_grid"), ("cell clip", "_two_pass_cell_clip"),
                  ("mesh clip", "_culled_pair_pool_clip"), ("islands", "_split_mesh_islands"),
                  ("caps", "cap_fans_batch"), ("refit", "refit_planes_from_parts"),
                  ("ACH and refit folds", "clip_planes_batch"), ("pack", "_pack_candidates"))
# Stages of a concave Scene's fire_impact (the caps and the refit outside
# _finish_pieces' other work; the rebuild).
CONCAVE_IMPACT_STAGES = [(n, pipeline, n) for n in (
    "convex_out_of_sphere", "clip_planes_batch", "_pooled_job_mesh_clip", "clip_trisoup",
    "_split_mesh_islands", "cap_fans_batch", "refit_planes_from_parts", "_pack_candidates",
    "split_groups_by_contact")] + [("rebuild", scene_mod, "build_scene")]
CONCAVE_KERNELS = ("clip_fold", "ich", "labels", "refit", "soup_clip")
# Kernels a concave Scene's prepare and its fire_impact launch.
SCENE_PREPARE_LAUNCHES = {"clip_fold": 6, "ich": 1, "labels": 1, "labels_general": 1,
                          "refit": 1}   # B3 by its vertex variant at T = 512
SCENE_IMPACT_KERNELS = ("clip_fold", "labels", "refit", "soup_clip")
SCENE_STEPS = 16
SCENE_MODELS = ("torus", "blob")


CONCAVE_COMPARE = {"clip_fold": compare_clip, "ich": compare_ich, "labels": compare_labels,
                   "refit": compare_refit, "soup_clip": compare_soup}


def concave_shape(name, a):
    if name == "clip_fold":
        return list(a[0].face_verts.shape[:3]) + [a[1].shape[1]]
    if name == "refit":
        return list(refit_points(a))
    if name == "soup_clip":
        return [a[0].shape[0], a[3].shape[0], a[3].shape[1]]
    return list(a[0].shape[:2])


def concave_kernel_phase(card, model=CONCAVE_MODEL, what="torus config 1", degenerate=True):
    """Phase 19 (and 29's first part): the config-1 event of ``model`` (a
    name or a (verts, tris) pair) on the card with recording wrappers, then
    each of its kernels (B1 at F = 96, S = 32, B2, B3, B4, B10) against its
    plain version on those calls, bit for bit, and, where ``degenerate``,
    on its degenerate cases (B1's at F = 96, S = 32); per kernel the
    wrapper's ms and the kernel's device ms a call, the plain version's ms
    and the bound. Returns the per-kernel results."""
    calls = capture_main_path_inputs(lambda: run_prepare("cuda", CONCAVE_CFG, model))
    degen = {name: [] for name in CONCAVE_KERNELS}
    if degenerate:
        degen = degenerate_cases("cuda")
        degen["clip_fold"] = [degenerate_clip_cases("cuda", F=CONCAVE_CFG.max_faces,
                                                    S=CONCAVE_CFG.max_face_verts)]
        degen["soup_clip"] = list(soup_cases("cuda").values())
    out = {}
    for name in CONCAVE_KERNELS:
        if not calls[name]:
            fail(f"{what}: no {name} call was recorded")
        err = max(CONCAVE_COMPARE[name](a, kw) for a, kw in calls[name] + degen[name])
        torch.cuda.synchronize()
        fn = KERNEL_FN[name]
        shapes = [concave_shape(name, a) for a, _ in calls[name]]
        if name == "soup_clip":
            split = [device_split(functools.partial(fn, *a, **kw), "soup_")
                     for a, kw in calls[name]]
            per_call = [{"ms": event_ms(lambda a=a, kw=kw: fn(*a, **kw)), "device_ms": x[0]}
                        for (a, kw), x in zip(calls[name], split)]
            b_ms, b_by = bound(sum(nbytes(a) + nbytes(fn(*a, **kw)) for a, kw in calls[name]),
                               sum(soup_ops(a) for a, _ in calls[name]))
            live = [soup_live(a) for a, _ in calls[name]]
            extra = (f"; live lanes {[x[0] for x in live]}, live lane x plane "
                     f"{[x[1] for x in live]}")
        else:
            per_call = per_call_times(name, calls[name])
            b_ms, b_by = decomposition_bound(name, calls[name])
            extra = ""
            if name == "labels":
                extra = f"; {sum(int(a[1].sum()) for a, _ in calls[name])} valid triangles"
            elif name == "refit":
                extra = (f"; {sum(3 * int(a[1].sum()) + int(a[3].sum()) for a, _ in calls[name])}"
                         f" live points")
        plain_ms = time_kernel(name, calls[name], plain_reps=5)[1]
        for t, shp in zip(per_call, shapes):
            t["shape"] = shp
        ms = sum(t["ms"] for t in per_call)
        dev = sum(t["device_ms"] for t in per_call)
        out[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "calls": per_call,
                     "degenerate_cases": len(degen[name])}
        if name == "soup_clip":
            out[name]["live_lanes"] = [x[0] for x in live]
        for t in per_call:
            print(f"{name} call {t['shape']} ({what}): wrapper {t['ms']:.4f} ms, kernel "
                  f"{t['device_ms']:.4f} ms on the device ({card})", flush=True)
        print(f"{name} ({what}): bit for bit on {len(calls[name])} calls and "
              f"{len(degen[name])} degenerate cases; kernel {ms:.4f} ms (on the device "
              f"{dev:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}){extra} "
              f"({card})", flush=True)
    return out


def _piece_compare(what, g, c, mas):
    """The card's pieces against the CPU plain run's, slot for slot:
    valid, group, tag, n_verts and mesh_valid exactly; live face vertices
    and mesh corners within 1e-5 × scale. Returns the largest vertex
    difference."""
    for k in ("valid", "group", "tag", "mesh_valid"):
        if not torch.equal(getattr(g, k).cpu(), getattr(c, k)):
            fail(f"{what}: pieces' {k} differ from the cpu plain run")
    if not torch.equal(g.convex.n_verts.cpu(), c.convex.n_verts):
        fail(f"{what}: pieces' n_verts differ from the cpu plain run")
    sm = c.convex.slot_mask()[..., None]
    dv = float(torch.where(sm, (g.convex.face_verts.cpu() - c.convex.face_verts).abs(), 0.0).max())
    mv = c.mesh_valid[..., None, None]
    dm = float(torch.where(mv, (g.mesh.cpu() - c.mesh).abs(), 0.0).max())
    if not (dv <= 1e-5 * mas and dm <= 1e-5 * mas):
        fail(f"{what}: face vertices ({dv:.3e}) or mesh corners ({dm:.3e}) part from the cpu "
             f"plain run")
    return max(dv, dm)


def concave_main_path(card, model=CONCAVE_MODEL, what="torus config 1"):
    """Phase 20 (and 29's second part): ``prepare_fracture`` of ``model`` at
    config 1 on the card, launch counts proving every kernel ran (and the
    parity grid built), then the same event through the plain path on the
    CPU: counts equal, total volume within rtol 1e-5, pieces slot for slot.
    Returns (launches, metrics, comparison)."""
    grids = []
    build = pipeline.build_parity_grid
    pipeline.build_parity_grid = lambda *a, **k: grids.append(build(*a, **k)) or grids[-1]
    try:
        reset_all()
        pieces, ctx, met = run_prepare("cuda", CONCAVE_CFG, model)
        torch.cuda.synchronize()
        counts = all_counts()
    finally:
        pipeline.build_parity_grid = build
    gpu = {k: float(v) for k, v in met.items()}
    print(f"{what} (cuda): {json.dumps(gpu)} launches: {json.dumps(counts)}; parity "
          f"grids built {len(grids)}", flush=True)
    check_launches(what, counts, CONCAVE_LAUNCHES)
    if len(grids) != 1:
        fail(f"{what}: {len(grids)} parity grids built, expected 1")
    P, F, S = CONCAVE_CFG.max_pieces, CONCAVE_CFG.max_faces, CONCAVE_CFG.max_face_verts
    fv = pieces.convex.face_verts
    if fv.shape != (P, F, S, 3) or not bool(torch.isfinite(fv).all()) or gpu["piece_cnt"] <= 0:
        fail(f"{what}: pieces are not finite, not of the expected shape or none")
    mesh_vol = _mesh_volume(model)
    if not 0.0 < gpu["total_volume"] <= 1.6 * mesh_vol:
        fail(f"{what}: total_volume {gpu['total_volume']} against the mesh's {mesh_vol}")
    (cpieces, _, cmet), cpu_s = cpu_run(what)
    g = gpu
    c = {k: float(v) for k, v in cmet.items()}
    print(f"{what} (cpu, plain): {json.dumps(c)} in {cpu_s:.2f} s", flush=True)
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        if g[k] != c[k]:
            fail(f"{what}: {k} cuda {g[k]} != cpu {c[k]}")
    if abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(c["total_volume"]):
        fail(f"{what}: total_volume cuda {g['total_volume']} vs cpu {c['total_volume']}")
    err = _piece_compare(what, pieces, cpieces, float(ctx.max_axis_scale))
    print(f"{what}: card and cpu plain run agree (counts, volume, pieces slot for slot, largest "
          f"vertex difference {err:.3e}); mesh volume {mesh_vol:.6f}", flush=True)
    return counts, gpu, {"cpu_s": cpu_s, "cpu": c, "cuda": g, "max_vertex_diff": err}


def _scene_state_compare(what, gsc, csc):
    """The card's Scene against the CPU's: valid, group, tag exactly, total
    volume within rtol 1e-5, body x within 2e-4 and v within 2e-3."""
    for k in ("valid", "group", "tag"):
        if not torch.equal(getattr(gsc.pieces, k).cpu(), getattr(csc.pieces, k)):
            fail(f"{what}: pieces' {k} differ from the cpu plain run")
    gv, cv = gsc.total_volume(), csc.total_volume()
    if abs(gv - cv) > 1e-5 * abs(cv):
        fail(f"{what}: total volume cuda {gv} vs cpu {cv}")
    dx, dv = _scene_diff(gsc, csc)
    if not (dx <= 2e-4 and dv <= 2e-3):
        fail(f"{what}: bodies part from the cpu plain run (x {dx:.3e}, v {dv:.3e})")
    return dx, dv


SCENE_PLAIN = {"pack": pack_cuda.transform_pack_owned_reference,
               "narrowphase": narrowphase_cuda.narrowphase_reference}


def scene_kernel_times(what, step_calls, raster_calls, card):
    """B5 and B7 on a Scene's last step and B11 on its render: each against
    its plain version (bitwise, as phases 7 and 15 hold them) and timed at
    the Scene's shapes: the wrapper's ms (CUDA events, median of 20, per
    call summed), the kernel's device ms, the plain version's ms and the
    bound."""
    out = {}
    for name in ("pack", "narrowphase"):
        a, kw, res = step_calls[name]
        err = FRAME_COMPARE_FN[name](a, kw)
        t = per_call_times(name, [(a, kw)], FRAME_KERNEL_FN[name], required=False)[0]
        plain_ms = event_ms(lambda a=a, kw=kw: SCENE_PLAIN[name](*a, **kw), reps=5, warmup=1)
        b_ms, b_by = physics_bound(name, a, kw, res)
        out[name] = {"max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": list(a[0].shape[:2])}
    tables = [a for _, a in raster_calls]
    err = max(compare_raster(a) for a in tables)
    for g, _ in raster_calls:
        compare_raster_glue(g)
    split = [raster_call_times(g, a) for g, a in raster_calls]
    b_ms, b_by = bound(sum(nbytes(a[:3]) + nbytes(raster_cuda.tile_raster(*a)) for a in tables),
                       sum(raster_ops(a) for a in tables))
    out["raster"] = {
        "max_abs_err": err, "ms": sum(event_ms(lambda a=a: raster_cuda.tile_raster(*a))
                                      for a in tables),
        "device_ms": sum(t["device_ms"] for t in split),
        "glue_device_ms": sum(t["glue_device_ms"] for t in split),
        "plain_ms": sum(event_ms(lambda a=a: raster_cuda.tile_raster_reference(*a[:8]), reps=5,
                                 warmup=1) for a in tables),
        "bound_ms": b_ms, "bound_by": b_by, "shapes": [t["shape"] for t in split],
        "live_pairs": [t["live_pairs"] for t in split]}
    for name, r in out.items():
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        print(f"{name} at {what}'s shapes {r.get('shape', r.get('shapes'))}: bit for bit, "
              f"wrapper {r['ms']:.4f} ms, kernel on the device {dev}, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}) ({card})", flush=True)
    return out


def compare_recorded(what, calls, counts) -> dict:
    """Each kernel's recorded calls of one run (``capture_main_path_inputs``)
    against its plain version, bit for bit, as phase 19 holds them; a
    kernel launched in that run (``counts``) with no call recorded fails.
    Returns per kernel the calls, their shapes and the largest
    difference."""
    out = {}
    for name in CONCAVE_KERNELS:
        if counts[name] and not calls[name]:
            fail(f"{what}: {name} launched {counts[name]} times but no call was recorded")
        if not calls[name]:
            continue
        err = max(CONCAVE_COMPARE[name](a, kw) for a, kw in calls[name])
        out[name] = {"calls": len(calls[name]), "max_abs_err": err,
                     "shapes": [concave_shape(name, a) for a, _ in calls[name]]}
    torch.cuda.synchronize()
    print(f"{what}: kernels bit for bit against their plain versions on the recorded calls "
          + json.dumps({k: [v["calls"], v["shapes"]] for k, v in out.items()}), flush=True)
    return out


def scene_prepare_on_card(model, start):
    """``concave_scene(model)`` built on the card with recording wrappers:
    its launches (B1 6, B2 1, B3 1 at the Scene's T = 512, by its vertex
    variant, B4 1), each
    recorded kernel call bit for bit against its plain version, and its
    prepare metrics and pieces (slot for slot) against the CPU-built
    ``start``'s."""
    what = f"Scene({model!r}) prepare on the card"
    built = []
    reset_all()
    calls = capture_main_path_inputs(
        lambda: built.append(workload.concave_scene(model, "cuda")))
    counts = all_counts()
    check_launches(what, counts, SCENE_PREPARE_LAUNCHES)
    kernels = compare_recorded(what, calls, counts)
    gsc = built[0]
    g = {k: float(v) for k, v in gsc.prepare_metrics.items()}
    c = {k: float(v) for k, v in start.prepare_metrics.items()}
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        if g[k] != c[k]:
            fail(f"{what}: {k} cuda {g[k]} != cpu {c[k]}")
    if abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(c["total_volume"]):
        fail(f"{what}: total_volume cuda {g['total_volume']} vs cpu {c['total_volume']}")
    err = _piece_compare(what, gsc.pieces, start.pieces, float(start.ctx.max_axis_scale))
    print(f"{what}: {json.dumps(g)} launches {json.dumps(counts)} (B3 at T = "
          f"{gsc.cfg.fracture.max_piece_tris}); equal to the cpu-built Scene's (metrics, pieces "
          f"slot for slot, largest vertex difference {err:.3e})", flush=True)
    return {"metrics": g, "launches": counts, "kernels": kernels, "max_vertex_diff": err}


def concave_scene_phase(card):
    """Phase 21: per model, ``concave_scene`` built on the CPU, and again on
    the card with recording wrappers (``scene_prepare_on_card``). From the
    CPU-built Scene copied to the card and to the CPU, in lockstep on both:
    one ``fire_impact`` (exact caps in ``do_fracture``) with recording
    wrappers, its kernels' calls bit for bit against their plain versions;
    ``SCENE_STEPS`` steps and one render; each compared with the CPU plain
    run (pieces exactly, x 2e-4, v 2e-3, 99.5% of pixels within 1e-5), with
    the card's launches per part. Returns (the CPU-built Scenes,
    results)."""
    starts, res = {}, {}
    for model in SCENE_MODELS:
        ray = workload.CONCAVE_RAYS[model]
        start, build_s = cpu_run(f"Scene({model!r})")
        if not start.cfg.fracture.exact_caps:
            fail(f"Scene({model!r}) dropped exact caps")
        starts[model] = start
        prep = scene_prepare_on_card(model, start)
        gsc, csc = workload.scene_to(start, "cuda"), workload.scene_to(start, "cpu")
        what = f"Scene({model!r})"
        out_img, got = [], []
        reset_all()
        impact_calls = capture_main_path_inputs(lambda: got.append(gsc.fire_impact(*ray)))
        gout = got[0]
        impact_counts = all_counts()
        for k in SCENE_IMPACT_KERNELS:
            if impact_counts[k] <= 0:
                fail(f"{what} impact: {k} never launched ({json.dumps(impact_counts)})")
        impact_kernels = compare_recorded(f"{what} impact", impact_calls, impact_counts)
        t0 = time.perf_counter()
        cout = csc.fire_impact(*ray)
        cpu_impact_s = time.perf_counter() - t0
        if not gout or not cout:
            fail(f"{what}: the impact ray missed")
        gm = {k: float(v) for k, v in gout["metrics"][0].items()}
        cm = {k: float(v) for k, v in cout["metrics"][0].items()}
        for k in (*FRAME_OVERFLOWS, "new_pieces", "active_pieces", "merged_out", "num_groups",
                  "mesh_tris_dropped"):
            if gm[k] != cm[k]:
                fail(f"{what} impact: {k} cuda {gm[k]} != cpu {cm[k]}")
        if gm["new_pieces"] <= 0:
            fail(f"{what} impact: no new piece ({json.dumps(gm)})")
        d_imp = float(np.abs(gout["impact"] - cout["impact"]).max())
        if gout["targets"] != cout["targets"] or d_imp > 1e-5:
            fail(f"{what} impact: targets or impact point ({d_imp:.3e}) differ from the cpu "
                 f"plain run")
        dx_i, dv_i = _scene_state_compare(f"{what} impact", gsc, csc)
        reset_all()
        with StepRecorder() as steps:
            gsc.step(SCENE_STEPS)
            torch.cuda.synchronize()
        step_counts = all_counts()
        csc.step(SCENE_STEPS)
        for k in ("pack", "narrowphase"):
            if step_counts[k] != SCENE_STEPS:
                fail(f"{what}: {k} launched {step_counts[k]} times in {SCENE_STEPS} steps")
        dx_s, dv_s = _scene_state_compare(f"{what} after {SCENE_STEPS} steps", gsc, csc)
        reset_all()
        raster_calls = capture_raster(lambda: out_img.append(gsc.render()))
        gimg = out_img.pop()
        render_counts = all_counts()
        cimg = csc.render()
        if render_counts["raster"] != 2:
            fail(f"{what} render: raster launched {render_counts['raster']} times, expected 2")
        share = float(((gimg.cpu() - cimg).abs() <= 1e-5).all(-1).float().mean())
        if not (share >= 0.995 and bool(torch.isfinite(gimg).all())):
            fail(f"{what} render: {share:.6f} of pixels within 1e-5 of the cpu plain run")
        nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
        kernels = scene_kernel_times(what, steps.last, raster_calls, card)
        res[model] = {"kernels": kernels, "impact_kernels": impact_kernels, "prepare_on_card": prep,
                      "build_cpu_s": build_s, "impact_cpu_s": cpu_impact_s, "metrics": gm,
                      "launches": {"impact": nz(impact_counts), "steps": nz(step_counts),
                                   "render": nz(render_counts)},
                      "impact_dx_dv": [dx_i, dv_i], "steps_dx_dv": [dx_s, dv_s],
                      "pixels_within_1e-5": share, "pieces": gsc.num_pieces(),
                      "bodies": gsc.num_bodies()}
        print(f"{what} (built on the cpu in {build_s:.2f} s; {start.num_pieces()} pieces): "
              f"impact {json.dumps(gm)} launches {json.dumps(nz(impact_counts))}; body x "
              f"{dx_i:.3e}, v {dv_i:.3e}; {SCENE_STEPS} steps launches "
              f"{json.dumps(nz(step_counts))}, x {dx_s:.3e}, v {dv_s:.3e}; render launches "
              f"{json.dumps(nz(render_counts))}, pixels within 1e-5 {share:.6f}; cpu impact "
              f"{cpu_impact_s:.2f} s", flush=True)
    return starts, res


def prepare_stage_split(cfg, model, reps: int = 5) -> dict:
    """Median CUDA-event ms per stage of one decomposition: a stage is the
    span of a CONCAVE_STAGES function, "glue" the rest of the event."""
    return span_split([(label, pipeline, name) for label, name in CONCAVE_STAGES],
                      lambda: run_prepare("cuda", cfg, model), reps, warmup=1)


def concave_event_timing(model, what, card, reps: int = 5) -> dict:
    """ms per config-1 event of ``model`` on the card (host clock,
    synchronize at the end, median of ``reps``), its stage split, device
    idle share and peak device memory (``max_memory_allocated`` over one
    event, beside what was allocated before it)."""
    run = lambda: run_prepare("cuda", CONCAVE_CFG, model)  # noqa: E731
    event = host_ms(run, reps=reps, warmup=1)
    split = prepare_stage_split(CONCAVE_CFG, model, reps)
    busy, wall, idle, entries = profile_busy(run, 3)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"event_ms": event, "stages_ms": split, "busy_ms": busy, "profiled_wall_ms": wall,
           "idle_share": idle, "device_entries": entries, "peak_bytes": peak,
           "allocated_before_bytes": before}
    print(f"prepare_fracture {what}: median {event:.3f} ms/event of {reps}; peak device memory "
          f"{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB allocated before it) ({card})",
          flush=True)
    print(f"{what} stage split, median of {reps} events (CUDA events, ms): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    print(f"{what} idle share "
          + (f"{idle:.3f}: device busy {busy:.3f} ms of {wall:.3f} ms per event under the "
             f"profiler, {entries:.0f} device entries per event" if idle is not None
             else "not measured: the profiler reported no device time") + f" ({card})",
          flush=True)
    return out


def concave_timing(starts, card, reps: int = 5) -> dict:
    """Phase 22: ``concave_event_timing`` of the torus config-1
    decomposition; ms per ``fire_impact`` of each concave Scene (each run
    from a fresh copy of the CPU-built Scene), its stage split and idle
    share."""
    ev = concave_event_timing(CONCAVE_MODEL, "torus config 1", card, reps)
    out = {"torus_config1_ms": ev.pop("event_ms"), "torus_config1": ev}
    for model, start in starts.items():
        ray = workload.CONCAVE_RAYS[model]
        copies = [workload.scene_to(start, "cuda") for _ in range(reps + 1)]
        ts = []
        for sc in copies:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.fire_impact(*ray)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        prof = [workload.scene_to(start, "cuda") for _ in range(3)]
        busy, wall, idle, entries = profile_busy(lambda: prof.pop().fire_impact(*ray), 3)
        split_from = [workload.scene_to(start, "cuda") for _ in range(reps + 1)]
        split = span_split(CONCAVE_IMPACT_STAGES, lambda: split_from.pop().fire_impact(*ray),
                           reps, warmup=1)
        out[f"{model}_impact"] = {"event_ms": statistics.median(ts[1:]), "runs_ms": ts[1:],
                                  "stages_ms": split, "busy_ms": busy, "profiled_wall_ms": wall,
                                  "idle_share": idle, "device_entries": entries}
        print(f"Scene({model!r}).fire_impact: median {statistics.median(ts[1:]):.3f} ms/event "
              f"of {reps}; idle share "
              + (f"{idle:.3f} (device busy {busy:.3f} ms of {wall:.3f} ms, {entries:.0f} device "
                 f"entries per event)" if idle is not None else "not measured") + f" ({card})",
              flush=True)
        print(f"Scene({model!r}).fire_impact stage split, median of {reps} events (CUDA events, "
              f"ms): " + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phases 23-27: every PhysicsConfig route, BASELINE config 2, batch_step, the
# CLI and the stage truncation.
# ---------------------------------------------------------------------------

ROUTE_STEPS = 8
# Launches a step of each route on the 10k lattice ("auto" on 10,000 pieces).
ROUTE_LAUNCHES = {
    "kernel": launches_a_step(),
    "xla_narrowphase": launches_a_step(pack=0, narrowphase=0),
    "unfused_prep": launches_a_step(prep=0),
    "xla_broadphase": launches_a_step(broadphase_exact=0),
    "sorted_k_beyond_two_windows": launches_a_step(broadphase_exact=0),
    "grid": launches_a_step(broadphase_exact=0),
    "all_off": launches_a_step(pack=0, broadphase_exact=0, narrowphase=0, prep=0),
}


def routes_phase(state, card):
    """Phase 23: the 10k lattice (bench.py:207's configuration) under each
    route of ``workload.ROUTES`` and the kernel route, from the main path's
    contact-rich state copied to the CPU: ``ROUTE_STEPS`` steps on the card
    with launch counts per step and, for every route but the kernel route
    (held against the CPU plain run over 64 steps in phase 9), through the
    plain path on the CPU, compared after the last (bit for bit, else x
    within 2e-4 and v within 2e-3, phase 9's bounds); ms per step on the
    card."""
    start = workload.to_device(state, "cpu")
    out = {}
    for name in ROUTE_LAUNCHES:
        cfg = workload.PHYSICS_CFG if name == "kernel" else workload.route_cfg(name)
        sg, sc = workload.to_device(start, "cuda"), start
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            check = LaunchCheck(f"route {name}", cfg, ROUTE_LAUNCHES[name])
            for i in range(ROUTE_STEPS):
                sg = phys_step.physics_step(sg, cfg)
                check(i, sg)
            torch.cuda.synchronize()
            counts = launch_counts()
            t0 = time.perf_counter()
            if name != "kernel":
                for _ in range(ROUTE_STEPS):
                    sc = phys_step.physics_step(sc, cfg)
            cpu_s = time.perf_counter() - t0
            ms, runs = steps_ms(start, cfg, ROUTE_STEPS)
        recall = [str(w.message)[:80] for w in warned
                  if issubclass(w.category, phys_step.RecallDegradedWarning)]
        # "auto" on 10,000 pieces without the kernel broadphase warns.
        if bool(recall) != (not cfg.pallas_broadphase):
            fail(f"route {name}: RecallDegradedWarning {'missing' if not recall else recall[0]}")
        b = sg.bodies
        for f in ("x", "q", "v", "w"):
            if not bool(torch.isfinite(getattr(b, f)).all()):
                fail(f"route {name}: {f} is not finite after {ROUTE_STEPS} steps")
        out[name] = {"launches": counts, "skipped": check.skipped, "ms_per_step": ms,
                     "runs_ms": runs, "recall_warning": bool(recall)}
        if name == "kernel":
            vs = "vs cpu plain: in phase 9"
        else:
            dx = float((b.x.cpu() - sc.bodies.x).abs().max())
            dv = float((b.v.cpu() - sc.bodies.v).abs().max())
            bitwise = all(torch.equal(getattr(b, f).cpu(), getattr(sc.bodies, f))
                          for f in ("x", "q", "v", "w")) and torch.equal(sg.sleep_frames.cpu(),
                                                                         sc.sleep_frames)
            if not (dx <= 2e-4 and dv <= 2e-3):
                fail(f"route {name}: card and cpu plain run differ (x {dx:.3e}, v {dv:.3e})")
            out[name].update(dx=dx, dv=dv, bitwise=bitwise, cpu_s_per_step=cpu_s / ROUTE_STEPS)
            vs = (f"vs cpu plain: {'bit for bit' if bitwise else ''} max |dx| {dx:.3e}, "
                  f"max |dv| {dv:.3e}, cpu plain {cpu_s / ROUTE_STEPS:.2f} s/step")
        print(f"route {name}: launches {json.dumps(counts)} over {ROUTE_STEPS} steps "
              f"({check.skipped} skipped); {vs}; {ms:.3f} ms/step on the card ({card})",
              flush=True)
    print("routes ms/step on the card: " + json.dumps({k: round(v["ms_per_step"], 4)
                                                        for k, v in out.items()})
          + f" ({card})", flush=True)
    return out


PROFILED_MESHES = 4
BATCH_LAUNCHES = {"clip_fold": 6 * workload.BATCH_M, "ich": workload.BATCH_M,
                  "labels": workload.BATCH_M, "refit": workload.BATCH_M}


def _pieces_bits_equal(a, b) -> bool:
    """Every field of two PieceSets equal, floats by their bits."""
    for f in ("face_verts", "n_verts", "planes"):
        x, y = getattr(a.convex, f), getattr(b.convex, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return (torch.equal(a.mesh.view(torch.int32), b.mesh.view(torch.int32))
            and all(torch.equal(getattr(a, f), getattr(b, f))
                    for f in ("mesh_valid", "valid", "group", "tag")))


def batch_phase(card):
    """Phase 24: BASELINE config 2, ``batch_decompose`` of 64 cubes at
    ``workload.BATCH_CFG`` on ``cuda:0`` (launches B1 6·64, B2, B3 and B4
    64 each); each mesh against its own single-mesh ``prepare_fracture`` on
    the card from the same seeds, bit for bit; mesh 0 against the CPU plain
    run; ms a batch and a mesh and the device idle share of its first
    ``PROFILED_MESHES``."""
    from surtr_tpu_torch.fracture.batch import batch_decompose

    cfg, M = workload.BATCH_CFG, workload.BATCH_M
    v, vm, tc, tm, cloud, seeds, pseeds, gseeds = workload.batch_inputs("cuda")

    def run(m=M):
        return batch_decompose(v[:m], vm[:m], tc[:m], tm[:m], cloud, cfg, seeds=seeds[:m],
                               partial_seeds=pseeds[:m], general_seeds=gseeds[:m])

    reset_all()
    t0 = time.perf_counter()
    pieces, met = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = all_counts()
    check_launches("config 2", counts, BATCH_LAUNCHES)
    if pieces.valid.shape != (M, cfg.max_pieces) or met["piece_cnt"].shape != (M,):
        fail(f"config 2: stacked shapes {tuple(pieces.valid.shape)}, "
             f"{tuple(met['piece_cnt'].shape)}")
    if not bool(torch.isfinite(pieces.convex.face_verts).all()):
        fail("config 2: pieces are not finite")
    for i in range(M):
        one, _, m1 = pipeline.prepare_fracture(v[i], vm[i], tc[i], tm[i], cloud, cfg, seeds[i],
                                               pseeds[i], gseeds[i])
        if not _pieces_bits_equal(index_tree(pieces, i), one):
            fail(f"config 2: mesh {i} differs from its single-mesh run")
        if any(not torch.equal(met[k][i], m1[k]) for k in m1):
            fail(f"config 2: mesh {i}'s metrics differ from its single-mesh run")
    t0 = time.perf_counter()
    _, _, cpu = run_prepare("cpu", cfg)
    cpu_s = time.perf_counter() - t0
    for k in ("piece_cnt", "mesh_tris_dropped"):
        if int(cpu[k]) != int(met[k][0]):
            fail(f"config 2: mesh 0 {k} {int(met[k][0])} != cpu plain {int(cpu[k])}")
    vg, vc = float(met["total_volume"][0]), float(cpu["total_volume"])
    if abs(vg - vc) > 1e-5 * abs(vc):
        fail(f"config 2: mesh 0 volume {vg} vs cpu plain {vc}")
    ms = host_ms(run, reps=2, warmup=0)
    # The idle share of the first PROFILED_MESHES meshes: the batch is a loop
    # of like events, and the profiler takes minutes over a whole batch's
    # ~390,000 device records.
    busy, wall, idle, entries = profile_busy(lambda: run(PROFILED_MESHES), 1)
    res = {"launches": counts, "first_run_s": first_s, "ms_batch": ms, "ms_per_mesh": ms / M,
           "idle_share": idle, "device_busy_ms": busy, "profiled_wall_ms": wall,
           "profiled_meshes": PROFILED_MESHES,
           "device_entries": entries, "cpu_mesh0_s": cpu_s,
           "piece_cnt": [int(c) for c in met["piece_cnt"].tolist()],
           "total_volume_mesh0": vg, "cpu_total_volume_mesh0": vc}
    print(f"config 2 (batch_decompose, {M} cubes at 1k seeds): launches {json.dumps(counts)}; "
          f"every mesh bit for bit equal to its single run; mesh 0 as the cpu plain run "
          f"(piece_cnt {int(met['piece_cnt'][0])}, volume {vg} vs {vc}); {ms:.1f} ms a batch, "
          f"{ms / M:.2f} ms a mesh; idle share of {PROFILED_MESHES} meshes "
          f"{'not measured' if idle is None else f'{idle:.3f}'} (device busy {busy:.1f} ms of "
          f"{wall:.1f} ms, {entries:.0f} device entries) ({card})", flush=True)
    return res


BATCH_STEP_COPIES = 4
BATCH_STEP_STEPS = 16


def batch_step_phase(card):
    """Phase 25: four copies of the 10k lattice, 30 apart in x, stepped 16
    times by ``batch_step`` (launches 4·16 of each main-path kernel); each
    copy bit for bit equal to its own ``physics_step`` run on the card."""
    from surtr_tpu_torch.physics.batch import batch_step, stack_scenes

    cfg = workload.PHYSICS_CFG
    base = workload.physics_lattice(device="cuda")
    scenes = []
    for i in range(BATCH_STEP_COPIES):
        shift = torch.tensor([30.0 * i, 0.0, 0.0], device="cuda")
        scenes.append(dataclasses.replace(base, bodies=dataclasses.replace(
            base.bodies, x=base.bodies.x + shift)))
    batch = stack_scenes(scenes)
    reset_counts()
    t0 = time.perf_counter()
    out = batch_step(batch, cfg, BATCH_STEP_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    n = BATCH_STEP_COPIES * BATCH_STEP_STEPS
    want = {k: v * n for k, v in launches_a_step().items()}
    if counts != want:
        fail(f"batch_step: launches {json.dumps(counts)}, expected {json.dumps(want)}")
    for i, s in enumerate(scenes):
        for _ in range(BATCH_STEP_STEPS):
            s = phys_step.physics_step(s, cfg)
        for f in dataclasses.fields(s.bodies):
            a, b = getattr(out.bodies, f.name)[i], getattr(s.bodies, f.name)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                fail(f"batch_step: copy {i} {f.name} differs from its single run")
        if not torch.equal(out.sleep_frames[i], s.sleep_frames):
            fail(f"batch_step: copy {i} sleep counters differ from its single run")
    print(f"batch_step ({BATCH_STEP_COPIES} copies of the 10k lattice, {BATCH_STEP_STEPS} steps): "
          f"launches {json.dumps(counts)}; every copy bit for bit equal to its single run; "
          f"{ms:.1f} ms, {ms / n:.3f} ms per scene step ({card})", flush=True)
    return {"launches": counts, "ms": ms, "ms_per_scene_step": ms / n}


CLI_DIR = "build/cli"
CLI_RUNS = {
    "cube": ["--model", "cube", "--steps", "240", "--impact", "0,4.5,-10:0,0,1@60",
             "--size", "512"],
    "torus": ["--model", "torus", "--steps", "120", "--impact",
              "{},{},{}:{},{},{}@30".format(*workload.CONCAVE_RAYS["torus"][0],
                                            *workload.CONCAVE_RAYS["torus"][1])],
}
# Kernels each CLI run must launch, and those it must not (the Scene's
# physics is the compound-body path on 256 pieces: the plain block sweep and
# the plain solver).
CLI_NEEDS = {"cube": ("clip_fold", "ich", "labels", "refit", "pack", "narrowphase", "raster"),
             "torus": ("clip_fold", "ich", "labels", "refit", "pack", "narrowphase",
                       "soup_clip")}
CLI_NEVER = ("broadphase_exact", "broadphase_sorted", "prep", "solver", "solver_warm")


def cli_phase(card):
    """Phase 26: ``python -m surtr_tpu_torch --preset tiny`` as a subprocess
    (exit 0, the last line parses), then ``main`` in-process at the full
    preset on ``cuda:0``: the cube (240 steps, one impact, frames of 512²
    every 10 steps, snapshot, trajectory) and the torus (120 steps, one
    impact, snapshot), with launch counts; each snapshot loaded back with
    ``checkpoint.load_scene`` gives the run's piece count and volume."""
    import contextlib
    import io
    import os
    import subprocess

    from surtr_tpu_torch.__main__ import main as cli_main
    from surtr_tpu_torch.checkpoint import load_scene

    os.makedirs(CLI_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "surtr_tpu_torch", "--preset", "tiny", "--model", "cube",
         "--steps", "12", "--impact", "0,10,0:0,-1,0@5", "--size", "64", "--shadow", "64",
         "--frames", f"{CLI_DIR}/tiny_frames", "--save", f"{CLI_DIR}/tiny.npz"],
        capture_output=True, text=True, timeout=300)
    tiny_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli --preset tiny exited {proc.returncode}: {proc.stderr[-2000:]}")
    tiny = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cli --preset tiny (subprocess, {tiny_s:.1f} s): {json.dumps(tiny)}", flush=True)
    out = {"tiny": {**tiny, "subprocess_s": tiny_s}}
    for model, args in CLI_RUNS.items():
        snap = f"{CLI_DIR}/{model}.npz"
        extra = ["--save", snap]
        if model == "cube":
            extra += ["--frames", f"{CLI_DIR}/cube_frames", "--trajectory",
                      f"{CLI_DIR}/cube_traj.npz"]
        reset_all()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main(args + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        missing = [k for k in CLI_NEEDS[model] if counts[k] <= 0]
        extra_k = [k for k in CLI_NEVER if counts[k]]
        if missing or extra_k:
            fail(f"cli {model}: launches {json.dumps(counts)}; none of {missing}, "
                 f"unexpected {extra_k}")
        steps = int(args[args.index("--steps") + 1])
        if res["steps"] != steps or res["pieces"] <= 0 or not math.isfinite(res["volume"]):
            fail(f"cli {model}: {json.dumps(res)}")
        back = load_scene(snap, device="cuda")
        if back.num_pieces() != res["pieces"] or round(back.total_volume(), 4) != res["volume"]:
            fail(f"cli {model}: the snapshot gives {back.num_pieces()} pieces, volume "
                 f"{back.total_volume()}, the run {res['pieces']}, {res['volume']}")
        if model == "cube":
            traj = np.load(f"{CLI_DIR}/cube_traj.npz")["x"]
            frames = len(os.listdir(f"{CLI_DIR}/cube_frames"))
            if traj.shape[0] != steps or not np.isfinite(traj).all() or frames != steps // 10:
                fail(f"cli cube: trajectory {traj.shape}, {frames} frames")
        out[model] = {**res, "launches": counts, "wall_s_measured": wall,
                      "ms_per_step": wall * 1e3 / steps}
        print(f"cli {model} (main in-process): {json.dumps(res)}; launches {json.dumps(counts)}; "
              f"snapshot loads back with the same pieces and volume; wall {wall:.2f} s, "
              f"{wall * 1e3 / steps:.2f} ms/step with prepare, impact and frames ({card})",
              flush=True)
    return out


PREPARE_STAGES = (1, 2, 3, 4, 5, 6, 7)
PHYSICS_STAGES = (1, 2, 3, 35, 4)


def _fence_close(a: float, b: float) -> bool:
    return math.isfinite(a) and math.isfinite(b) and abs(a - b) <= 1e-5 * abs(b)


def stages_phase(state, prepared, card, reps: int = 3):
    """Phase 27: ``profiling.PhaseTimer`` ms of the cube 1k prepare, the
    cube32 impact and one 10k step on the card; each ``prepare_fracture``
    stage (``profile_stage`` 1-7, cube 1k) and each ``physics_step`` stage
    (1, 2, 3, 35, 4; the 10k lattice's contact-rich state) on the card, the
    fence of each finite and within rtol 1e-5 of the CPU plain run's (the
    physics fences over ``stage_arrays``; stage 3's over B7's live records,
    since its unfilled points hold -BIG and the raw fence is -inf on both
    devices); ``profiling.trace`` of one 10k step keeps its CUDA kernel
    records."""
    import os

    from surtr_tpu_torch.profiling import PhaseTimer, fence_sum, trace

    timer = PhaseTimer()
    cfg = workload.PHYSICS_CFG
    for _ in range(reps + 1):
        with timer.phase("prepare cube 1k") as h:
            h["out"] = run_prepare("cuda")
        with timer.phase("impact cube32") as h:
            h["out"] = workload.run_impact("cuda", prepared=prepared)[1]
        with timer.phase("step 10k") as h:
            h["out"] = phys_step.physics_step(state, cfg)
    for name in list(timer.times):
        timer.times[name] = timer.times[name][1:]      # the first run warms up
    inputs = {dev: (workload.model_inputs("cube", dev), workload.bench_seeds())
              for dev in ("cuda", "cpu")}
    fences = {}
    for st in PREPARE_STAGES:
        def prep(dev, st=st):
            args, seeds = inputs[dev]
            return pipeline.prepare_fracture(*args, workload.BENCH_CFG, *seeds,
                                             profile_stage=st)[0]
        for _ in range(reps + 1):
            with timer.phase(f"prepare stage {st}") as h:
                h["out"] = g = prep("cuda")
        timer.times[f"prepare stage {st}"] = timer.times[f"prepare stage {st}"][1:]
        fences[f"prepare {st}"] = (float(g), float(prep("cpu")))
    states = {"cuda": state, "cpu": workload.to_device(state, "cpu")}
    for st in PHYSICS_STAGES:
        for _ in range(reps + 1):
            with timer.phase(f"step stage {st}") as h:
                h["out"] = phys_step.physics_step(state, cfg, profile_stage=st)
        timer.times[f"step stage {st}"] = timer.times[f"step stage {st}"][1:]
        arrays = {dev: phys_step.stage_arrays(s, cfg, st) for dev, s in states.items()}
        if st == 3:
            if not math.isinf(float(fence_sum(*arrays["cuda"]))):
                fail("step stage 3: B7's raw records no longer overflow the fence")
            arrays = {dev: (narrowphase_cuda.live_records(a[0], cfg.manifold_points),)
                      for dev, a in arrays.items()}
        fences[f"step {st}"] = tuple(float(fence_sum(*arrays[dev])) for dev in ("cuda", "cpu"))
    bad = {k: v for k, v in fences.items() if not _fence_close(*v)}
    if bad:
        fail("stage fences not finite or differ from the cpu plain run beyond rtol 1e-5: "
             + json.dumps(bad))
    os.makedirs(CLI_DIR, exist_ok=True)
    # The profiler can drop device records late in a long process: the
    # count says how many it kept (printed, not checked).
    _, records = trace(phys_step.physics_step, state, cfg, path=f"{CLI_DIR}/step_trace.json")
    med = timer.medians()
    print(f"profiling.trace of one 10k step: {records} CUDA kernel records, Chrome trace "
          f"{os.path.getsize(f'{CLI_DIR}/step_trace.json')} bytes", flush=True)
    print("PhaseTimer (median ms, host clock fenced by synchronize):\n" + timer.report()
          + f"\n({card})", flush=True)
    print("stage fences, card against cpu plain (all finite, within rtol 1e-5; step 3 over "
          f"B7's live records): {json.dumps(fences)}", flush=True)
    return {"ms": med, "fences": fences, "trace_kernel_records": records}


# ---------------------------------------------------------------------------
# Phase 28: the last module slice (the ICH refit on the batched B2, the
# per-cell mesh-clip fallback, Delaunay, the sharded batch variants).
# ---------------------------------------------------------------------------

ICH_BATCH_SRC = "surtr_tpu_torch/csrc/ich.cu"
ICH_BATCH_REPLACES = "surtr_tpu/ops/hull_pallas.py:51"
REFIT_LIMITS = (8, 20)
REFIT_EVENT_LAUNCHES = {"clip_fold": 6, "ich": 2, "ich_batch": 1, "ich_warp_set": 1, "labels": 1}
REFIT_TORUS_LAUNCHES = {**REFIT_EVENT_LAUNCHES, "labels_general": 1, "soup_clip": 1}  # T 128
REFIT_IMPACT_LAUNCHES = {"clip_fold": "> 0", "ich": 1, "ich_batch": 1, "ich_warp_set": 1,
                         "labels": "> 0", "labels_general": "> 0"}
NOPOOL_LAUNCHES = {"clip_fold": 6, "ich": 1, "labels": 1, "refit": 1}
SHARD_MESHES = 4
SHARD_LATTICES = 2
SHARD_STEPS = 8


def refit_cfg(cfg, limit: int):
    return dataclasses.replace(cfg, refitting_point_limit=limit)


def compare_ich_batch(args, kw):
    """Every set's face slots, face_valid, normals and inner bit for bit
    equal to the plain batched hull's on the card."""
    pts, mask = args[:2]
    limit = kw["limit"]
    got = hull_cuda.ich_batch(pts, mask, limit=limit)
    want = hull_cuda.ich_batch_reference(pts, mask, limit=limit)
    what = f"ich_batch ({tuple(pts.shape)}, limit {limit})"
    for k in ("faces", "face_valid"):
        if not torch.equal(got[k], want[k]):
            bad = torch.nonzero((got[k] != want[k]).flatten(1).any(1)).flatten().tolist()
            fail(f"{what}: {k} differ from the plain hull in sets {bad[:10]} ({len(bad)} in all)")
    _same_bits(what, "normals", got["normals"], want["normals"])
    _same_bits(what, "inner", got["inner"], want["inner"])
    return 0.0


def ich_batch_cases(device, g):
    """Degenerate batches: sets with 0 to 3 live points and one all masked,
    tied extreme points (an integer grid), a coplanar set, every point
    twice, P = 45 (not a multiple of 32); ``tail_sets``; two sets of 13,000
    points (above what a block stages in shared memory: the scratch path,
    and too large for a warp); B = 1 at limits 62 and 20 (the block
    variant through the batched entry)."""
    P = 45
    pts = torch.randn((9, P, 3), generator=g)
    mask = torch.rand((9, P), generator=g) > 0.3
    mask[0] = False
    for b, live in ((1, [4]), (2, [4, 30]), (3, [4, 9, 30])):
        mask[b] = False
        mask[b, live] = True
    grid = torch.stack(torch.meshgrid(*[torch.arange(3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts[4, :27] = grid
    mask[4] = torch.arange(P) < 27
    pts[5, :, 2] = 0.25
    pts[6, 20:] = pts[6, :25].clone()
    big = torch.rand((2, 13_000, 3), generator=g)
    big_m = torch.rand((2, 13_000), generator=g) > 0.1
    tail = tail_sets(g)
    cases = [((pts, mask), {"limit": 20}), ((pts, mask), {"limit": 8}),
             ((big, big_m), {"limit": 20}), ((pts[7:8], mask[7:8]), {"limit": 62}),
             (tail, {"limit": 20}), (tail, {"limit": 8}), ((tail[0][5:6], tail[1][5:6]), {"limit": 20})]
    return [(tuple(t.to(device) for t in a), kw) for a, kw in cases]


def tail_sets(g, P=200):
    """Sets whose live points sit at the end of the pool, so that every
    masked slot lies below them and wins the NEG ties once the live points
    are used up: 1, 2, 3 and exactly 4 live points at the end, one all
    masked, 80 live at the end and about 160 live at random (more than a
    warp's lanes twice over), every seventh slot live."""
    pts = torch.randn((8, P, 3), generator=g)
    mask = torch.zeros((8, P), dtype=torch.bool)
    for b, n in enumerate((1, 2, 3, 4)):
        mask[b, P - n:] = True
    mask[5, 120:] = True
    mask[6] = torch.rand(P, generator=g) > 0.2
    mask[7, ::7] = True
    return pts, mask


def ich_general_cases(device, g):
    """The general variant's degenerate sets: ``tail_sets`` (0-4 live points
    among them) and the 45-point sets with 0-3 live points of
    ``ich_batch_cases`` at limit 64, F = 132."""
    a, _ = ich_batch_cases("cpu", g)[0]
    tail = tail_sets(g)
    return [(tuple(t.to(device) for t in c), {"limit": 64}) for c in (tail, (a[0][:4], a[1][:4]))]


def ich_batch_bound(calls):
    """Each input byte read once and each output written once, against the
    float operations: per insertion and live point, the volumes of the
    added and removed faces (counted as F faces of 6 operations, as for
    the one-set B2), for the sets' live points."""
    b = ops = 0.0
    for a, kw in calls:
        out = hull_cuda.ich_batch(*a, **kw)
        b += nbytes(a) + nbytes(out)
        limit = kw["limit"]
        ops += float(a[1].sum()) * limit * (2 * max(limit, 4) + 4) * 6.0
    return bound(b, ops)


VARIANT_COUNTER = {"block": "launches", "warp_set": "warp_set_launches",
                   "general": "general_launches"}


def variant_launches(a, kw):
    """(the variant ``hull_cuda._variant`` names for the batched call, the
    launches its own counter counts in one call); fails unless that counter
    and ``launches`` both count exactly one."""
    B, N = a[0].shape[:2]
    variant = hull_cuda._variant(B, N, hull_cuda._faces(kw["limit"], kw.get("max_faces")))
    counter = VARIANT_COUNTER[variant]
    reset_all()
    hull_cuda.ich_batch(*a, **kw)
    torch.cuda.synchronize()
    n = getattr(hull_cuda, counter)
    if not n == hull_cuda.launches == 1:
        fail(f"ich_batch {tuple(a[0].shape)} limit {kw['limit']}: {hull_cuda.launches} launches, "
             f"{n} counted by {counter} ({variant} variant)")
    return variant, n


def refit_kernel_phase(card):
    """Phase 28 (a): the refit pools of the cube 1k event at limits 8 and
    20 and of the torus config-1 event at limit 20, recorded on the card,
    and ``ich_batch_cases``: the batched B2 against its plain version on
    the card, bit for bit; the wrapper's and the device ms a call, the
    device launches a call, the plain version's ms and the bound."""
    calls = {}
    for model, cfg, limits in (("cube", workload.BENCH_CFG, REFIT_LIMITS),
                               (CONCAVE_MODEL, CONCAVE_CFG, (20,))):
        for limit in limits:
            rec, _ = capture("ich_batch", lambda: run_prepare("cuda", refit_cfg(cfg, limit), model))
            if len(rec) != 1:
                fail(f"refit pools of {model} at limit {limit}: {len(rec)} ich_batch calls")
            calls[f"{model} limit {limit}"] = rec[0]
    degen = ich_batch_cases("cuda", torch.Generator().manual_seed(28))
    seen = {}
    for a, kw in list(calls.values()) + degen:
        compare_ich_batch(a, kw)
        variant = variant_launches(a, kw)[0]
        seen[variant] = seen.get(variant, 0) + 1
    torch.cuda.synchronize()
    if set(seen) != {"block", "warp_set"}:
        fail(f"phase 28a: the batched calls ran the variants {seen}, not both block and warp_set")
    print(f"ich_batch variants over the recorded and degenerate calls: {json.dumps(seen)}",
          flush=True)
    res = {"max_abs_err": 0.0, "calls": {}, "variants": seen}
    for what, (a, kw) in calls.items():
        call = functools.partial(hull_cuda.ich_batch, *a, **kw)
        plain = functools.partial(hull_cuda.ich_batch_reference, *a, **kw)
        variant, n_var = variant_launches(a, kw)
        if variant != "warp_set":
            fail(f"phase 28a: the refit pool {what} ran the {variant} variant, not warp_set")
        dev_ms, other_ms, entries = device_split(call, hull_cuda.KERNEL_NAME[variant], runs=10)
        b_ms, b_by = ich_batch_bound([(a, kw)])
        t = {"shape": list(a[0].shape), "limit": kw["limit"],
             "live_points": int(a[1].sum()), "variant": variant, "variant_launches": n_var,
             "ms": event_ms(call),
             "device_ms": dev_ms, "other_device_ms": other_ms, "device_launches": entries,
             "plain_ms": event_ms(plain, reps=3, warmup=1), "bound_ms": b_ms, "bound_by": b_by}
        res["calls"][what] = t
        print(f"ich_batch call {what} (B, P, 3) {t['shape']}: {variant} variant, {n_var} "
              f"{variant} launch(es) a call; wrapper {t['ms']:.4f} ms, kernel "
              f"{dev_ms:.4f} ms on the device, {entries:.0f} device launches a call, plain "
              f"{t['plain_ms']:.2f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"{dev_ms / b_ms:.0f}x the bound ({card})", flush=True)
    main = res["calls"]["cube limit 20"]
    res.update({k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "variant")})
    print(f"ich_batch: bit for bit on {len(calls)} recorded refit calls and {len(degen)} "
          f"degenerate batches ({card})", flush=True)
    return res


def refit_event(what, cfg, model, want):
    """One prepare at an ICH refit limit on the card, launches counted
    (``want``), against the CPU plain run: counts equal, total volume
    within rtol 1e-5, pieces slot for slot. Returns (launches, metrics,
    cpu seconds)."""
    reset_all()
    pieces, ctx, met = run_prepare("cuda", cfg, model)
    torch.cuda.synchronize()
    counts = all_counts()
    check_launches(what, counts, want)
    g = {k: float(v) for k, v in met.items()}
    if not bool(torch.isfinite(pieces.convex.face_verts).all()) or g["piece_cnt"] <= 0:
        fail(f"{what}: pieces are not finite or none")
    (cpieces, _, cmet), cpu_s = cpu_run(what)
    c = {k: float(v) for k, v in cmet.items()}
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        if g[k] != c[k]:
            fail(f"{what}: {k} cuda {g[k]} != cpu {c[k]}")
    if abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(c["total_volume"]):
        fail(f"{what}: total_volume cuda {g['total_volume']} vs cpu {c['total_volume']}")
    err = _piece_compare(what, pieces, cpieces, float(ctx.max_axis_scale))
    print(f"{what} (cuda): {json.dumps(g)} launches: {json.dumps(counts)}; cpu plain run in "
          f"{cpu_s:.2f} s agrees (counts, volume, pieces slot for slot, largest vertex "
          f"difference {err:.3e})", flush=True)
    return counts, g, cpu_s


def refit_paths_phase(prepared, card):
    """Phase 28 (b)-(d): the cube 1k event and the torus config-1 event at
    refitting_point_limit 20 (B2 twice: the model hull and one batched
    refit; no B4), the cube32 impact at limit 20 from the cube prepared in
    phase 12 (B2 once, the batched refit; no B4), and the sphere's 1k
    prepare with mesh_pair_pool=False (no B10), each against its CPU plain
    run; ms per event of the limit-20 cube event beside the limit-4 one."""
    res = {}
    cfg20 = refit_cfg(workload.BENCH_CFG, 20)
    res["cube_limit20"] = refit_event("cube 1k, refit limit 20", cfg20, "cube",
                                      REFIT_EVENT_LAUNCHES)
    res["torus_limit20"] = refit_event("torus config 1, refit limit 20",
                                       refit_cfg(CONCAVE_CFG, 20), CONCAVE_MODEL,
                                       REFIT_TORUS_LAUNCHES)
    icfg = refit_cfg(workload.CUBE32_CFG, 20)
    reset_all()
    _, (out, met) = workload.run_impact("cuda", icfg, prepared)
    torch.cuda.synchronize()
    counts = all_counts()
    check_launches("cube32 impact, refit limit 20", counts, REFIT_IMPACT_LAUNCHES)
    t0 = time.perf_counter()
    _, (cout, cmet) = workload.run_impact("cpu", icfg, prepared)
    cpu_s = time.perf_counter() - t0
    _impact_compare("refit limit 20", out, met, cout, cmet, strict=True)
    g = {k: float(v) for k, v in met.items()}
    print(f"cube32 impact, refit limit 20 (cuda): {json.dumps(g)} launches: "
          f"{json.dumps(counts)}; cpu plain run in {cpu_s:.2f} s agrees", flush=True)
    res["impact_limit20"] = (counts, g, cpu_s)
    res["sphere_nopool"] = refit_event(
        "sphere 1k, mesh_pair_pool=False", dataclasses.replace(workload.BENCH_CFG,
                                                               mesh_pair_pool=False),
        "sphere", NOPOOL_LAUNCHES)
    ms20 = host_ms(lambda: run_prepare("cuda", cfg20), reps=5, warmup=1)
    ms4 = host_ms(lambda: run_prepare("cuda"), reps=5, warmup=1)
    print(f"prepare_fracture cube 1k: refit limit 20 {ms20:.3f} ms/event, limit 4 {ms4:.3f} "
          f"ms/event ({card})", flush=True)
    return {k: {"launches": v[0], "metrics": v[1], "cpu_s": v[2]} for k, v in res.items()} | {
        "cube_ms_limit20": ms20, "cube_ms_limit4": ms4}


def _simplex_sets(t, valid):
    return {tuple(sorted(r)) for r, v in zip(t.cpu().tolist(), valid.cpu().tolist()) if v}


def delaunay_phase(card):
    """Phase 28 (e): ``delaunay3d`` and ``delaunay2d`` on the card against
    the CPU run of the same points (simplices as sets; where the tables
    agree slot for slot, the real simplices' circumcentres within 1e-4 of
    max(r, 1)): at the JAX package's test
    sizes (24 and 30 points), also against ``scipy.spatial.Delaunay``; at
    256 (3-D) and 512 (2-D) points against the CPU only;
    ``voronoi_dual_edges`` at 20 points. ms per call on the card."""
    from scipy.spatial import Delaunay

    from surtr_tpu_torch.ops.delaunay import delaunay3d, voronoi_dual_edges
    from surtr_tpu_torch.ops.delaunay2d import delaunay2d

    res = {}
    # The small clouds are the JAX package's tests' (tests/test_delaunay_checkpoint.py,
    # test_delaunay2d.py), on which its triangulations equal scipy's.
    for name, fn, d, n, seed, key, scipy_ok in (("3d", delaunay3d, 3, 24, 3, "tets", True),
                                                ("3d", delaunay3d, 3, 256, 256, "tets", False),
                                                ("2d", delaunay2d, 2, 30, 2, "tris", True),
                                                ("2d", delaunay2d, 2, 512, 512, "tris", False)):
        pts = np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)
        mask = torch.ones(n, dtype=torch.bool)
        t0 = time.perf_counter()
        g = fn(torch.as_tensor(pts, device="cuda"), mask.cuda())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = fn(torch.as_tensor(pts), mask)
        cpu_s = time.perf_counter() - t0
        valid = f"{key[:-1]}_valid"
        what = f"delaunay{name} ({n} points)"
        sets = _simplex_sets(g[key], g[valid])
        if not sets or sets != _simplex_sets(c[key], c[valid]):
            fail(f"{what}: no simplex, or the card's simplices differ from the cpu run's")
        slots = torch.equal(g[key].cpu(), c[key]) and torch.equal(g[valid].cpu(), c[valid])
        if scipy_ok and sets != {tuple(sorted(t)) for t in
                                 Delaunay(pts.astype(np.float64)).simplices}:
            fail(f"{what}: the simplices differ from scipy.spatial.Delaunay's")
        live = c[valid] & g[valid].cpu() if slots else None
        if slots:
            r = torch.clamp(torch.sqrt(torch.clamp(c.get("r2", torch.ones(len(live))), min=0)),
                            min=1)
            dc = (g["circumcenters"].cpu() - c["circumcenters"]).abs().amax(-1)
            if not bool((dc[live] <= 1e-4 * r[live]).all()):
                fail(f"{what}: circumcentres part from the cpu run's by "
                     f"{float(dc[live].max()):.3e}")
        ms = host_ms(lambda: fn(torch.as_tensor(pts, device="cuda"), mask.cuda()), reps=3,
                     warmup=0)
        res[f"{name}_{n}"] = {"simplices": len(sets), "slot_for_slot": slots, "ms": ms,
                              "cpu_s": cpu_s, "first_call_s": first_s}
        print(f"{what}: {len(sets)} simplices, as the cpu run"
              + (" slot for slot" if slots else " (as sets; the slots differ)")
              + (" and scipy" if scipy_ok else "") + f"; {ms:.2f} ms on the card, cpu "
              f"{cpu_s:.2f} s ({card})", flush=True)
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (20, 3)).astype(np.float32))
    mask = torch.ones(20, dtype=torch.bool)
    ge, gm = voronoi_dual_edges(delaunay3d(pts.cuda(), mask.cuda()))
    ce, cm = voronoi_dual_edges(delaunay3d(pts, mask))
    if not torch.equal(gm.cpu(), cm) or int(cm.sum()) <= 10:
        fail(f"voronoi_dual_edges: masks differ or too few edges ({int(cm.sum())})")
    de = float((ge.cpu() - ce).abs()[cm].max())
    if not de <= 1e-4 * max(1.0, float(ce[cm].abs().max())):
        fail(f"voronoi_dual_edges: edges part from the cpu run's by {de:.3e}")
    res["voronoi_dual_edges_20"] = {"edges": int(cm.sum()), "max_diff": de}
    print(f"voronoi_dual_edges (20 points): {int(cm.sum())} edges as the cpu run's (largest "
          f"difference {de:.3e})", flush=True)
    return res


def sharded_phase(card):
    """Phase 28 (f): ``sharded_batch_decompose`` of 4 cubes at
    ``workload.BATCH_CFG`` and ``sharded_batch_step`` of 2 copies of the
    10k lattice (8 steps) over every visible GPU and over [cuda:0,
    cuda:0] (with more cards, as many of each as the least multiple of 4,
    or 2, and the card count): each shard on its device, bit for bit equal
    to ``batch_decompose`` / ``batch_step`` of the same meshes or scenes
    there, each tally equal to the sum over the unsharded run."""
    from surtr_tpu_torch.fracture.batch import batch_decompose, sharded_batch_decompose
    from surtr_tpu_torch.physics.batch import (activity, batch_step, sharded_batch_step,
                                               stack_scenes)
    from surtr_tpu_torch.types import device_context

    n_gpu = torch.cuda.device_count()
    # Batches that split evenly over every layout below.
    cfg, M = workload.BATCH_CFG, math.lcm(SHARD_MESHES, n_gpu)
    n_lat = math.lcm(SHARD_LATTICES, n_gpu)
    v, vm, tc, tm, cloud, seeds, pseeds, gseeds = workload.batch_inputs("cpu", M)
    base = workload.physics_lattice(device="cpu")
    scenes = stack_scenes([dataclasses.replace(base, bodies=dataclasses.replace(
        base.bodies, x=base.bodies.x + torch.tensor([30.0 * i, 0.0, 0.0])))
        for i in range(n_lat)])
    layouts = {f"all {n_gpu} visible": [f"cuda:{i}" for i in range(n_gpu)],
               "cuda:0 twice": ["cuda:0", "cuda:0"]}
    res = {}
    for name, devices in layouts.items():
        t0 = time.perf_counter()
        shards, total = sharded_batch_decompose(devices, v, vm, tc, tm, cloud, cfg, seeds=seeds,
                                                partial_seeds=pseeds, general_seeds=gseeds)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        want_total = 0
        for shard, dev, sl in zip(shards, devices, range(len(devices))):
            m = M // len(devices)
            part = slice(sl * m, (sl + 1) * m)
            with device_context(dev):
                one, met = batch_decompose(v[part].to(dev), vm[part].to(dev), tc[part].to(dev),
                                           tm[part].to(dev), cloud.to(dev), cfg,
                                           seeds=seeds[part], partial_seeds=pseeds[part],
                                           general_seeds=gseeds[part])
            if shard.valid.device != torch.device(dev) or not _pieces_bits_equal(shard, one):
                fail(f"sharded_batch_decompose over {name}: a shard differs from "
                     f"batch_decompose of its meshes")
            want_total += int(met["piece_cnt"].sum())
        if total.device != torch.device(devices[0]) or int(total) != want_total:
            fail(f"sharded_batch_decompose over {name}: tally {int(total)} != {want_total}")
        t0 = time.perf_counter()
        sshards, act = sharded_batch_step(devices, scenes, workload.PHYSICS_CFG, SHARD_STEPS)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        outs = []
        for i, (shard, dev) in enumerate(zip(sshards, devices)):
            m = n_lat // len(devices)
            with device_context(dev):
                whole = batch_step(workload.to_device(
                    index_tree(scenes, slice(i * m, (i + 1) * m)), dev), workload.PHYSICS_CFG,
                    SHARD_STEPS)
            for f in dataclasses.fields(shard.bodies):
                a, b = getattr(shard.bodies, f.name), getattr(whole.bodies, f.name)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    fail(f"sharded_batch_step over {name}: shard {i} {f.name} differs from "
                         f"batch_step of its scenes")
            outs.append(activity(whole).to(devices[0]))
        want_act = functools.reduce(torch.add, outs).float()
        if not torch.equal(act, want_act) or float(act) <= 0:
            fail(f"sharded_batch_step over {name}: tally {float(act)} != {float(want_act)}")
        res[name] = {"devices": devices, "piece_total": int(total), "decompose_ms": dec_ms,
                     "activity": float(act), "step_ms": step_ms}
        print(f"sharded over {name} ({devices}): {M} cubes, tally {int(total)} pieces, "
              f"{dec_ms:.1f} ms; {n_lat} lattices x {SHARD_STEPS} steps, activity "
              f"{float(act):.6g}, "
              f"{step_ms:.1f} ms; every shard bit for bit as its unsharded run ({card})",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 29: BASELINE config 1 at its model's scale (the pumpkin's 10,000
# triangles, bench.py:138), on a torus read back from OBJ text.
# ---------------------------------------------------------------------------

MODEL_SCALE = "config 1 at model scale (10,000-triangle torus)"


def model_scale_phase(card):
    """Phase 29: ``workload.model_scale_mesh()`` (the 10,000-triangle torus
    through ``io.obj.load_obj``) at config 1: phase 19's kernel checks on
    its calls (no degenerate cases: phase 19 ran them), phase 20's launch
    counts and CPU comparison, then ms per event, the stage split, the idle
    share and the peak device memory."""
    t0 = time.perf_counter()
    mesh = workload.model_scale_mesh()
    print(f"{MODEL_SCALE}: {len(mesh[0])} vertices, {len(mesh[1])} triangles, read back from "
          f"OBJ text in {time.perf_counter() - t0:.2f} s", flush=True)
    kernels = concave_kernel_phase(card, mesh, MODEL_SCALE, degenerate=False)
    counts, met, cmp = concave_main_path(card, mesh, MODEL_SCALE)
    timing = concave_event_timing(mesh, MODEL_SCALE, card)
    return {"kernels": kernels, "launches": counts, "metrics": met, "cpu_compare": cmp,
            "timing": timing}


# ---------------------------------------------------------------------------
# 30. Past the old limits: every kernel's general variant.
# ---------------------------------------------------------------------------

# kernel: (module, its general variant's counter, source, TPU kernel, a name
# fragment of the general variant's device function)
GENERAL = {
    "clip_fold": (clip_cuda, "general_launches", "surtr_tpu_torch/csrc/clip_fold.cu",
                  "surtr_tpu/ops/clip_pallas.py:52", "clip_cta_kernel"),
    "ich": (hull_cuda, "general_launches", "surtr_tpu_torch/csrc/ich.cu",
            "surtr_tpu/ops/hull_pallas.py:51", "ich_general"),
    "labels": (labels_cuda, "general_launches", "surtr_tpu_torch/csrc/labels.cu",
               "surtr_tpu/ops/labels_pallas.py:25", "labels_vertex"),
    "pack": (pack_cuda, "general_launches", "surtr_tpu_torch/csrc/pack.cu",
             "surtr_tpu/physics/pack_pallas.py:31", "pack_wide"),
    "broadphase_exact": (broadphase_cuda, "exact_general_launches",
                         "surtr_tpu_torch/csrc/broadphase_exact.cu",
                         "surtr_tpu/physics/broadphase_pallas.py:221", "bp_exact_general"),
    "narrowphase": (narrowphase_cuda, "general_launches", "surtr_tpu_torch/csrc/narrowphase.cu",
                    "surtr_tpu/physics/narrowphase_pallas.py:103", "narrow_group"),
    "prep": (prep_cuda, "general_launches", "surtr_tpu_torch/csrc/prep.cu",
             "surtr_tpu/physics/prep_pallas.py:42", "prep_wide"),
    "solver": (solver_cuda, "general_launches", "surtr_tpu_torch/csrc/solver.cu",
               "surtr_tpu/physics/solver_pallas.py:53", "solver_shared"),
    "soup_clip": (soup_clip_cuda, "general_launches", "surtr_tpu_torch/csrc/soup_clip.cu",
                  "surtr_tpu/ops/soup_clip_pallas.py:43", "soup_fold_group"),
    "raster": (raster_cuda, "general_launches", "surtr_tpu_torch/csrc/raster.cu",
               "surtr_tpu/render/raster_pallas.py:37", "raster_kernel"),
    "broadphase_sorted": (broadphase_cuda, "sorted_list_launches",
                          "surtr_tpu_torch/csrc/broadphase_sorted.cu",
                          "surtr_tpu/physics/broadphase_pallas.py:55", "bp_sorted_list"),
}
LIMIT_LATTICE = 1000           # pieces of phase 30's lattices: past broadphase_block, so B6 runs
LIMIT_PHYSICS_CFG = dataclasses.replace(workload.PHYSICS_CFG, max_neighbors=32,
                                        max_hull_verts=12)
LIMIT_PHYSICS_STEPS = 30
LIMIT_PREPARE_CFG = dataclasses.replace(workload.BENCH_CFG, initial_decompose_cell_cnt=64,
                                        max_pieces=64, max_piece_tris=2048,
                                        refitting_point_limit=64)
LIMIT_FACES_CFG = dataclasses.replace(workload.BENCH_CFG, initial_decompose_cell_cnt=64,
                                      max_pieces=64, max_faces=256, max_face_verts=32)
LIMIT_PREPARE_LAUNCHES = {"clip_fold": 6, "ich": 2, "ich_batch": 1, "labels": 1,
                          "ich_general": 1, "labels_general": 1}
LIMIT_RENDER_TRIS = 512
LIMIT_SHADOW = 8192
LIMIT_K = 32          # B6 past K = 16: the long variant
LIMIT_K_GENERAL = 80  # B6 past LONG_K: the thread-a-piece general variant
# Where phase 30's shape past a kernel's old limit takes another variant
# than its general one: (the ``all_counts`` key of its launches, a name
# fragment of its device function). B6 at K = 32 runs the tiled sweep's
# long lists; B1 past the CTA variant's per-face state the global fold.
PAST_VARIANT = {"broadphase_exact": ("broadphase_exact_long", "bp_exact_kernel"),
                "clip_fold_global": ("clip_fold_global", "clip_fold_kernel"),
                "soup_clip_s40": ("soup_clip_fallback", "soup_fold_general")}
# Phase 30's further cases: name -> the kernel (a GENERAL key) it runs.
PAST_CASES = {"raster_render_512": "raster", "broadphase_exact_10k": "broadphase_exact",
              "clip_fold_f1025": "clip_fold", "clip_fold_global": "clip_fold",
              "labels_scratch": "labels", "broadphase_sorted_k48": "broadphase_sorted",
              "prep_inplace": "prep", "soup_clip_s40": "soup_clip"}
LIMIT_K_LIST = 48     # B12 past one slot a lane (K > 32)
# B8 past the wide variant's staged records (one partner's record past a
# third of the SM's shared memory: M > 3,223): (Np, K, M).
PREP_INPLACE_SHAPE = (64, 2, 3300)
LIMIT_F_GLOBAL = 2304   # B1 past the CTA variant's per-face state (F > 2,131): the global fold


# The last resorts past the redesigned variants' shared memory, beside their
# ``general_launches``: kernel -> (module, counter).
FALLBACK = {"narrowphase": (narrowphase_cuda, "fallback_launches"),
            "solver": (solver_cuda, "fallback_launches"),
            "pack": (pack_cuda, "fallback_launches"),
            "soup_clip": (soup_clip_cuda, "fallback_launches")}
LIMIT_VH_FIRST = 747       # B5's first Vh past 48 KB of staged rows at the lattice's F 8, Ne 3
LIMIT_VH_INPLACE = 8100    # B5 past the wide CTA's staged raw corners: read in place
LIMIT_SLOTS = (3, 5, 32)   # B10's further slot counts on the group variant (phase 30's is 16)
LIMIT_SLOTS_GENERAL = 40   # B10 past a warp's slots: the general variant


def general_counts() -> dict:
    counts = {f"{name}_general": getattr(mod, attr) for name, (mod, attr, *_) in GENERAL.items()}
    counts.update({f"{name}_fallback": getattr(mod, attr)
                   for name, (mod, attr) in FALLBACK.items()})
    return counts


def _past(name: str):
    """(the ``all_counts`` key of its launches, a name fragment of its
    device function) of the variant phase 30's case ``name`` runs."""
    base = PAST_CASES.get(name, name)
    for k in (name, base):
        if k in PAST_VARIANT:
            return PAST_VARIANT[k]
    return f"{base}_general", GENERAL[base][4]


def past_key(name: str) -> str:
    """The ``all_counts`` key of the launches of ``name``'s variant at
    phase 30's shape past its old limit."""
    return _past(name)[0]


def past_kernel(name: str) -> str:
    """A name fragment of that variant's device function."""
    return _past(name)[1]


def reset_general():
    for mod, attr, *_ in GENERAL.values():
        setattr(mod, attr, 0)
    for mod, attr in FALLBACK.values():
        setattr(mod, attr, 0)


def capture_many(attrs, fn):
    """``capture`` of several ``pipeline`` attributes at once: {attr: the
    (args, kwargs) of each call}, and ``fn``'s result."""
    calls = {a: [] for a in attrs}
    saved = [(a, getattr(pipeline, a)) for a in attrs]
    for attr, orig in saved:
        def rec(*a, _orig=orig, _attr=attr, **kw):
            calls[_attr].append((a, kw))
            return _orig(*a, **kw)
        setattr(pipeline, attr, rec)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for attr, orig in saved:
            setattr(pipeline, attr, orig)
    return calls, out


def one_step(cfg, n: int = LIMIT_LATTICE):
    """The calls of one physics step of an ``n``-cube lattice under
    ``cfg`` on the card (StepRecorder's (args, kwargs, result) by kernel)."""
    scene = workload.physics_lattice(n, "cuda", cfg)
    with StepRecorder() as rec:
        phys_step.physics_step(scene, cfg)
        torch.cuda.synchronize()
    return dict(rec.last)


def limits_physics(card):
    """30 (e1): the lattice under max_neighbors 32 and max_hull_verts 12 on
    the card and through the plain path on the CPU, in lockstep from one
    CPU-built scene (C7), phase 9's bounds; every step B6, B7 and B9 by
    their variants past K = 16 (B6's long lists; B7's and B9's group and
    shared kernels), B5 and B8 by today's. Then every step's B7 and B9 call
    bit for bit against its plain version on the card. Returns the launches
    of the card's run and the last step's calls."""
    cfg = LIMIT_PHYSICS_CFG
    sc = workload.physics_lattice(LIMIT_LATTICE, "cpu", cfg)
    sg = workload.to_device(sc, "cuda")
    reset_all()
    want = {"pack": 1, "broadphase_exact": 1, "broadphase_exact_long": 1, "narrowphase": 1,
            "narrowphase_general": 1, "prep": 1, "solver": 1, "solver_general": 1}
    hits = (0, 0)
    step_calls = []
    with StepRecorder() as rec:
        for i in range(LIMIT_PHYSICS_STEPS):
            before = all_counts()
            rec.last = {}
            sg = phys_step.physics_step(sg, cfg)
            torch.cuda.synchronize()
            last = dict(rec.last)
            now = all_counts()
            delta = {k: now[k] - before[k] for k in now}
            if any(delta.values()):
                check_launches(f"phase 30 lattice step {i}", delta, want)
            sc = phys_step.physics_step(sc, cfg)
            if last:
                hits = hit_counts(last["prep"])
                step_calls.append((last["narrowphase"][:2], last["solver"][:2]))
    counts = all_counts()
    dx = float((sg.bodies.x.cpu() - sc.bodies.x).abs().max())
    dv = float((sg.bodies.v.cpu() - sc.bodies.v).abs().max())
    print(f"phase 30 lattice ({LIMIT_LATTICE} cubes, max_neighbors 32, max_hull_verts 12): cuda "
          f"vs cpu plain after {LIMIT_PHYSICS_STEPS} steps: max |dx| {dx:.3e}, max |dv| "
          f"{dv:.3e}; last step's pair and ground hit slots {hits}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    if not (dx <= 2e-4 and dv <= 2e-3):
        fail("phase 30 lattice: cuda and cpu runs differ beyond x 2e-4 or v 2e-3")
    if counts["broadphase_exact_long"] < 1:
        fail("phase 30 lattice: no step ran")
    for nar, sol in step_calls:
        compare_narrowphase(*nar)
        compare_solver(*sol)
    torch.cuda.synchronize()
    print(f"phase 30 lattice: B7's group kernel and B9's shared kernel bit for bit against their "
          f"plain versions on the card on each of the {len(step_calls)} steps' calls", flush=True)
    return counts, last, {"dx": dx, "dv": dv, "hits": list(hits),
                          "bitwise_steps": len(step_calls)}


def limits_prepare(card):
    """30 (e2): the cube under max_piece_tris 2048 and refitting_point_limit
    64 on the card (B3 and the batched B2 by their general variants) and
    through the plain path on the CPU, compared slot for slot. Returns the
    launches and the recorded B2 and B3 calls."""
    reset_all()
    calls, (pieces, ctx, met) = capture_many(
        ("ich_batch", "tri_soup_components_batch"),
        lambda: run_prepare("cuda", LIMIT_PREPARE_CFG))
    counts = all_counts()
    check_launches("phase 30 prepare", counts, LIMIT_PREPARE_LAUNCHES)
    g = {k: float(v) for k, v in met.items()}
    t0 = time.perf_counter()
    cpieces, _, cmet = run_prepare("cpu", LIMIT_PREPARE_CFG)
    c = {k: float(v) for k, v in cmet.items()}
    cpu_s = time.perf_counter() - t0
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        if g[k] != c[k]:
            fail(f"phase 30 prepare: {k} cuda {g[k]} != cpu {c[k]}")
    if g["piece_cnt"] <= 0 or abs(g["total_volume"] - c["total_volume"]) > 1e-5 * abs(
            c["total_volume"]):
        fail(f"phase 30 prepare: total_volume cuda {g['total_volume']} vs cpu "
             f"{c['total_volume']}")
    err = _piece_compare("phase 30 prepare", pieces, cpieces, float(ctx.max_axis_scale))
    print(f"phase 30 prepare (cube, 64 cells, max_piece_tris 2048, refit limit 64): "
          f"{json.dumps(g)}; the cpu plain run agrees slot for slot (largest vertex difference "
          f"{err:.3e}, {cpu_s:.1f} s); launches {json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    return counts, calls, {"cuda": g, "cpu": c, "cpu_s": cpu_s, "max_vertex_diff": err}


def limits_render(card, tris: int = LIMIT_RENDER_TRIS):
    """30 (e3): render_scene at a shadow map of 8192² (32,768 tiles: B11's
    global variant) of bench_render's first ``tris`` triangles, the kernels
    against the plain versions on the card: one raster launch a call (the
    global variant's for the shadow map), each raster call and its glue
    bit for bit, then the frame with every raster call on the plain
    versions, image and depth bit for bit. Returns the launches and the
    shadow map's packed table."""
    full = workload.render_512_inputs("cuda")
    inputs = (full[0][:tris], full[1][:tris], full[2][:tris], *full[3:])
    out = {}

    def run():
        out["frame"] = workload.run_render_512("cuda", LIMIT_SHADOW, inputs)

    reset_all()
    calls = capture_raster(run)
    img, depth = out["frame"]
    counts = all_counts()
    past = sum(raster_cuda._variant(a[3] * a[4]) == "global" for _, a in calls)
    check_launches(f"phase 30 render, {tris} triangles", counts,
                   {"raster": len(calls), "raster_glue": len(calls), "raster_general": past})
    if past < 1 or len(calls) != 2:
        fail(f"phase 30 render, {tris} triangles: {len(calls)} raster calls, {past} past the "
             f"resident kernel's threshold")
    for g, a in calls:
        compare_raster_glue(g)
        compare_raster(a)
    orig = raster_cuda.tile_table, raster_cuda.tile_raster

    def plain_raster(*a):
        out = raster_cuda.tile_raster_reference(*a[:8])
        return out if len(a) < 9 or a[8] is None else raster_cuda._finish(a[8], *out)

    raster_cuda.tile_table, raster_cuda.tile_raster = raster_cuda._tile_table, plain_raster
    try:
        pimg, pdepth = workload.run_render_512("cuda", LIMIT_SHADOW, inputs)
        torch.cuda.synchronize()
    finally:
        raster_cuda.tile_table, raster_cuda.tile_raster = orig
    for what, x, y in (("image", img, pimg), ("depth", depth, pdepth)):
        if not torch.equal(_bits(x), _bits(y)):
            fail(f"phase 30 render: the frame's {what} differs from the plain versions' "
                 f"({int((_bits(x) != _bits(y)).sum())} entries)")
    shadow = next(a for _, a in calls if a[3] * a[4] > raster_cuda.RESIDENT_TILES)
    pairs, most = live_pairs(shadow)
    print(f"phase 30 render ({tris} triangles, 512², shadow {LIMIT_SHADOW}²: "
          f"{shadow[3] * shadow[4]} tiles, {pairs} live pairs, {most} in the densest tile): "
          f"frame, raster calls and glue bit for bit against the plain versions on the card; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    return counts, shadow


def lattice_bp_args(state):
    """B6's arguments (before K) in the step from ``state`` (the 10k
    lattice's 63rd-step state: the 64th step's broadphase)."""
    with StepRecorder() as rec:
        phys_step.physics_step(state, workload.PHYSICS_CFG)
        torch.cuda.synchronize()
    return rec.last["broadphase_exact"][0][:5]


def limits_phase(card, state):
    """Phase 30; ``state`` is the 10k lattice's 63rd-step state (phase 8)."""
    # (e1)-(e3): the three configurations end to end.
    phys_counts, last, phys_cmp = limits_physics(card)
    prep_counts, pcalls, prep_cmp = limits_prepare(card)
    render_counts, shadow = limits_render(card)
    render_full, shadow_full = limits_render(card, workload.RENDER_512_TRIS)

    # One call of each kernel at a shape past its old limit; the launches
    # of the variant it takes there in the runs that record them.
    launches = {name: 0 for name in GENERAL}
    for counts in (phys_counts, prep_counts, render_counts):
        for name in GENERAL:
            launches[name] += counts[past_key(name)]
    launches["raster_render_512"] = render_full["raster_general"]
    reset_all()
    faces = capture_main_path_inputs(lambda: run_prepare("cuda", LIMIT_FACES_CFG))["clip_fold"]
    launches["clip_fold"] = general_counts()["clip_fold_general"]
    if not clip_cuda.launches == launches["clip_fold"] == len(faces):
        fail(f"phase 30: of the F = 256, S = 32 event's {clip_cuda.launches} B1 launches in "
             f"{len(faces)} calls, {launches['clip_fold']} were of the CTA variant")
    b1 = max(faces, key=lambda c: c[0][0].face_verts.shape[0] * c[0][1].shape[1])
    for a, kw in faces + [degenerate_clip_cases("cuda", F=256, S=32)]:
        compare_clip(a, kw)
    f1025 = clip_past_f1024()
    forced = forced_variant_checks(pcalls["tri_soup_components_batch"][0])
    lt = pcalls["tri_soup_components_batch"][0][0]
    l4096 = ((lt[0].reshape(-1, 4096, 3, 3), lt[1].reshape(-1, 4096)),
             pcalls["tri_soup_components_batch"][0][1])
    reset_general()
    step768 = one_step(dataclasses.replace(workload.PHYSICS_CFG, max_hull_verts=768))
    step747 = one_step(dataclasses.replace(workload.PHYSICS_CFG, max_hull_verts=LIMIT_VH_FIRST))
    step_m64 = one_step(dataclasses.replace(workload.PHYSICS_CFG, max_neighbors=32,
                                            manifold_points=64))
    zeros = pack_zero_case(step768["pack"][:2])
    inplace = prep_inplace_case("cuda", step_m64["prep"][1])
    launches["pack"] = general_counts()["pack_general"]
    launches["prep"] = general_counts()["prep_general"]
    soup_calls, _ = capture("soup_clip_pooled", lambda: run_prepare("cuda", model="sphere"))
    sa = soup_calls[0][0][:5]
    bp = last["broadphase_exact"][0][:5]
    bp10k = lattice_bp_args(state)
    W = LIMIT_PHYSICS_CFG.broadphase_window
    sphere_pts = sphere_ich_call("cuda")[0]
    cases = {
        # name: (shape, call (args, kwargs), comparison, kernel, plain, ops)
        "clip_fold": ("(N, F, S, K) " + str([*b1[0][0].face_verts.shape[:3], b1[0][1].shape[1]]),
                      b1, compare_clip, clip_cuda.clip_planes_batch,
                      clip_cuda.clip_planes_batch_reference,
                      decomposition_ops("clip_fold", *b1)),
        "ich": (f"(B, P) {list(pcalls['ich_batch'][0][0][0].shape[:2])}, limit 64: F = 132",
                pcalls["ich_batch"][0], compare_ich_batch, hull_cuda.ich_batch,
                hull_cuda.ich_batch_reference, None),
        "labels": (f"(N, T) {list(pcalls['tri_soup_components_batch'][0][0][0].shape[:2])}",
                   pcalls["tri_soup_components_batch"][0], compare_labels,
                   labels_cuda.tri_soup_components_batch,
                   labels_cuda.tri_soup_components_batch_reference,
                   decomposition_ops("labels", *pcalls["tri_soup_components_batch"][0])),
        "pack": (f"Np {LIMIT_LATTICE}, Vh 768", step768["pack"][:2], compare_pack,
                 pack_cuda.transform_pack_owned, pack_cuda.transform_pack_owned_reference,
                 physics_ops("pack", *step768["pack"][:2])),
        "broadphase_exact": (f"Np {LIMIT_LATTICE}, K {LIMIT_K}", (bp + (LIMIT_K,), {}),
                             compare_broadphase_exact, broadphase_cuda.broadphase_exact,
                             broadphase_cuda.broadphase_exact_reference,
                             physics_ops("broadphase_exact", bp + (LIMIT_K,), {})),
        "narrowphase": (f"(Np, K) ({LIMIT_LATTICE}, 32), Vh 12", last["narrowphase"][:2],
                        compare_narrowphase, narrowphase_cuda.narrowphase,
                        narrowphase_cuda.narrowphase_reference,
                        physics_ops("narrowphase", *last["narrowphase"][:2])),
        "prep": (f"Np {LIMIT_LATTICE}, K 32, M 64: a row of "
                 f"{prep_cuda.row_bytes(32, 64, workload.PHYSICS_CFG.max_ground_contacts)} B",
                 step_m64["prep"][:2], compare_prep, prep_cuda.prep_from_records,
                 prep_cuda.prep_from_records_reference, physics_ops("prep", *step_m64["prep"][:2])),
        "solver": (f"Np {LIMIT_LATTICE}, K 32, C {32 * 4 + 4}", last["solver"][:2],
                   compare_solver, solver_cuda.solve, solver_cuda.solve_reference,
                   physics_ops("solver", *last["solver"][:2])),
        "soup_clip": (f"{sa[0].shape[0]} lanes by {tuple(sa[3].shape)}, S 16",
                      (sa, {"poly_slots": 16}), compare_soup, soup_clip_cuda.soup_clip_pooled,
                      soup_clip_cuda.soup_clip_pooled_reference, soup_ops(sa, 16)),
        "soup_clip_s40": (f"{sa[0].shape[0]} lanes by {tuple(sa[3].shape)}, S "
                          f"{LIMIT_SLOTS_GENERAL}: {soup_clip_cuda._variant(LIMIT_SLOTS_GENERAL)}",
                          (sa, {"poly_slots": LIMIT_SLOTS_GENERAL}), compare_soup,
                          soup_clip_cuda.soup_clip_pooled,
                          soup_clip_cuda.soup_clip_pooled_reference,
                          soup_ops(sa, LIMIT_SLOTS_GENERAL)),
        "raster": (f"shadow {LIMIT_SHADOW}²: {shadow[3] * shadow[4]} tiles, T_pad "
                   f"{shadow[0].shape[0]}", (shadow[:8], {}), lambda a, kw: compare_raster(shadow),
                   raster_cuda.tile_raster, raster_cuda.tile_raster_reference,
                   raster_ops(shadow)),
        "raster_render_512": (f"render_512's {workload.RENDER_512_TRIS} triangles, shadow "
                              f"{LIMIT_SHADOW}²: {shadow_full[3] * shadow_full[4]} tiles, T_pad "
                              f"{shadow_full[0].shape[0]}", (shadow_full[:8], {}),
                              lambda a, kw: compare_raster(shadow_full), raster_cuda.tile_raster,
                              raster_cuda.tile_raster_reference, raster_ops(shadow_full)),
        "broadphase_exact_10k": (f"Np {bp10k[0].shape[0]} (the 10k lattice's 64th step), K "
                                 f"{LIMIT_K}", (bp10k + (LIMIT_K,), {}), compare_broadphase_exact,
                                 broadphase_cuda.broadphase_exact,
                                 broadphase_cuda.broadphase_exact_reference,
                                 physics_ops("broadphase_exact", bp10k + (LIMIT_K,), {})),
        "broadphase_sorted": (f"Np {LIMIT_LATTICE}, K 32, W {W}", (bp + (32, W), {}),
                              compare_broadphase_sorted, broadphase_cuda.broadphase_sorted,
                              broadphase_cuda.broadphase_sorted_reference,
                              physics_ops("broadphase_sorted", bp + (32, W), {})),
        "broadphase_sorted_k48": (f"Np {LIMIT_LATTICE}, K {LIMIT_K_LIST}, W {W}",
                                  (bp + (LIMIT_K_LIST, W), {}), compare_broadphase_sorted,
                                  broadphase_cuda.broadphase_sorted,
                                  broadphase_cuda.broadphase_sorted_reference,
                                  physics_ops("broadphase_sorted", bp + (LIMIT_K_LIST, W), {})),
        "prep_inplace": ("(Np, K, M) {}: {} B of a partner's record past the wide variant's "
                         "room: {}".format(list(PREP_INPLACE_SHAPE),
                                           4 * (5 + 6 * PREP_INPLACE_SHAPE[2]),
                                           prep_cuda._variant(*PREP_INPLACE_SHAPE[1:], 4)),
                         inplace, compare_prep, prep_cuda.prep_from_records,
                         prep_cuda.prep_from_records_reference, physics_ops("prep", *inplace)),
        "clip_fold_f1025": (f"(N, F, S, K) {f1025['shape'] + [f1025['args'][0][1].shape[1]]}: "
                            f"{clip_cuda._variant(*f1025['shape'])}", f1025["args"], compare_clip,
                            clip_cuda.clip_planes_batch, clip_cuda.clip_planes_batch_reference,
                            decomposition_ops("clip_fold", *f1025["args"])),
        "clip_fold_global": (f"(N, F, S) (8, {LIMIT_F_GLOBAL}, 4): "
                             f"{clip_cuda._variant(8, LIMIT_F_GLOBAL, 4)}", forced["global_args"],
                             compare_clip, clip_cuda.clip_planes_batch,
                             clip_cuda.clip_planes_batch_reference,
                             decomposition_ops("clip_fold", *forced["global_args"])),
        "labels_scratch": (f"(N, T) {list(l4096[0][0].shape[:2])}: "
                           f"{labels_cuda._variant(l4096[0][0].shape[1])}", l4096, compare_labels,
                           labels_cuda.tri_soup_components_batch,
                           labels_cuda.tri_soup_components_batch_reference,
                           decomposition_ops("labels", *l4096)),
    }
    extra = {   # further calls past the limits, compared only
        "ich": [((sphere_pts[0], sphere_pts[1]), {"limit": 64})]
        + ich_general_cases("cuda", torch.Generator().manual_seed(30)),
        "labels": [tile_labels(*pcalls["tri_soup_components_batch"][0])],
        "solver": [step_m64["solver"][:2], tile_solver(*last["solver"][:2]),
                   warm_solver_case(last["solver"][:2]), warm_solver_case(step_m64["solver"][:2])],
        "narrowphase": [step768["narrowphase"][:2], step_m64["narrowphase"][:2]]
        + narrowphase_edge_cases(last["narrowphase"]),
        "broadphase_sorted": [(bp + (8, 256), {}), (bp + (32, 1024), {})],
        "broadphase_exact": [(bp + (LIMIT_K_GENERAL,), {}), (bp + (64,), {}),
                             (bp10k + (LIMIT_K_GENERAL,), {})],
        "pack": [step747["pack"][:2], zeros, pack_inplace_case(step768["pack"][:2])],
        "soup_clip": [(sa, {"poly_slots": S}) for S in LIMIT_SLOTS],
    }
    compare_one = {"ich": lambda a, kw: (compare_ich_batch if a[0].dim() == 3 else compare_ich)(
        a, kw), "solver": lambda a, kw: (compare_solver_warm if len(a) == 4 else compare_solver)(
        a, kw)}
    results, jobs = {}, []
    for name, (shape, (a, kw), cmp, fn, plain, ops) in cases.items():
        base = PAST_CASES.get(name, name)
        call = functools.partial(fn, *a, **kw)
        pcall = functools.partial(plain, *a, **kw)
        reset_all()
        out = call()
        torch.cuda.synchronize()
        n_general = all_counts()[past_key(name)]
        if n_general < 1:
            fail(f"phase 30 {name} at {shape}: its variant past the old limit did not launch")
        if name in FALLBACK and all_counts()[f"{name}_fallback"]:
            fail(f"phase 30 {name} at {shape}: its last resort launched")
        cmp(a, kw)
        for ea, ekw in extra.get(name, []):
            before = general_counts()
            compare_one.get(name, cmp)(ea, ekw)
            now = general_counts()
            if name in FALLBACK and (now[f"{name}_general"] <= before[f"{name}_general"]
                                     or now[f"{name}_fallback"] != before[f"{name}_fallback"]):
                fail(f"phase 30 {name}: a further call past the old limit did not take the "
                     f"{past_kernel(name)} kernel")
        torch.cuda.synchronize()
        if name == "broadphase_exact" and broadphase_cuda.exact_general_launches < 2:
            fail(f"phase 30 broadphase_exact: K = {LIMIT_K_GENERAL} launched the general "
                 f"variant {broadphase_cuda.exact_general_launches} times, want 2")
        ms = event_ms(call, reps=5, warmup=1)
        plain_ms = event_ms(pcall, reps=3, warmup=1)
        jobs.append((call, past_kernel(name), 5, 2))
        if name == "ich":
            b_ms, b_by = ich_batch_bound([(a, kw)])
        else:
            b_ms, b_by = bound(nbytes(a) + nbytes(kw) + nbytes(out), ops)
        launches[name] = launches.get(name) or n_general
        results[name] = {"shape": shape, "general_launches": n_general, "max_abs_err": 0.0,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    # The bounds of the further calls timed by the tools (B3 over 320 soups;
    # B7 at Vh 768 and M 64; B9 at C 2,052, over 24,000 rows and in warm
    # mode; B5 at Vh 747, the zero ties and Vh 8,100; B10 at S 3, 5 and 32)
    # and of the F = 256, S = 32 event's six B1 calls.
    further = {name: [further_bound(name, ea, ekw) for ea, ekw in extra[name][:n]]
               for name, n in (("labels", 1), ("narrowphase", 2), ("solver", 4), ("pack", 3),
                               ("soup_clip", 3))}
    for name, bounds in further.items():
        results[name]["further_bounds"] = bounds
        print(f"phase 30 {name}: bounds of its further calls {json.dumps(bounds)} ms", flush=True)
    six_bounds = [further_bound("clip_fold", a, kw) for a, kw in faces]
    # The device split of every call in one fresh process: late in this
    # long process the profiler may keep no record of a kernel; with them
    # each of the F = 256, S = 32 event's six B1 calls.
    six = [functools.partial(clip_cuda.clip_planes_batch, *a, **kw) for a, kw in faces]
    splits = fresh_device_split(jobs + [(c, past_kernel("clip_fold"), 5, 2) for c in six])
    results["clip_fold"]["calls"] = [
        {"shape": [*a[0].face_verts.shape[:3], a[1].shape[1]], "device_ms": sp[0],
         "device_launches": sp[2], "bound_ms": bd[0], "bound_by": bd[1]}
        for (a, _), sp, bd in zip(faces, splits[len(jobs):], six_bounds)]
    for c in results["clip_fold"]["calls"]:
        print(f"phase 30 clip_fold (the CTA variant), F = 256, S = 32 call (N, F, S, K) "
              f"{c['shape']}: kernel {c['device_ms']:.4f} ms on the device, bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']}) ({card})", flush=True)
    for (name, res), (dev_ms, other_ms, entries) in zip(results.items(), splits):
        res.update(device_ms=dev_ms, other_device_ms=other_ms, device_launches=entries)
        print(f"phase 30 {name} (variant past the old limit) at {res['shape']}: bit for bit "
              f"against the plain version; {res['general_launches']} launch(es) of it a call; "
              f"wrapper {res['ms']:.4f} ms, kernel {dev_ms:.4f} ms on the device in {entries:.0f} "
              f"device launches a call ({other_ms:.4f} ms beside it), plain "
              f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']}) "
              f"({card})", flush=True)
    forced.update(forced_b8_b12_checks([last["prep"][:2], step_m64["prep"][:2], inplace],
                                       bp, W))
    forced.update(forced_b5_b10_checks(
        [step768["pack"][:2], step747["pack"][:2], zeros],
        [(sa, {"poly_slots": S}) for S in (16,) + LIMIT_SLOTS]))
    forced.update(forced_b7_b9_checks(
        [last["narrowphase"][:2], step768["narrowphase"][:2], step_m64["narrowphase"][:2]]
        + narrowphase_edge_cases(last["narrowphase"]),
        [last["solver"][:2], warm_solver_case(last["solver"][:2]), step_m64["solver"][:2]]))
    layouts = check_layouts()
    return {"kernels": results, "launches": launches, "physics": phys_cmp,
            "prepare": prep_cmp, "clip_f1025": {k: v for k, v in f1025.items() if k != "args"},
            "forced": {k: v for k, v in forced.items() if k != "global_args"},
            "layouts": layouts}


def further_bound(name, a, kw):
    """[ms, "bytes" or "operations"] of one call of kernel ``name`` (B1, B3,
    B5, B7, B9 in either mode, or B10) on the card: its inputs read once and
    its outputs written once, against its float operations."""
    if name in ("clip_fold", "labels"):
        out, ops = KERNEL_FN[name](*a, **kw), decomposition_ops(name, a, kw)
    elif name == "narrowphase":
        out, ops = narrowphase_cuda.narrowphase(*a), physics_ops(name, a, kw)
    elif name == "pack":
        out, ops = pack_cuda.transform_pack_owned(*a, **kw), physics_ops(name, a, kw)
    elif name == "soup_clip":
        out = soup_clip_cuda.soup_clip_pooled(*a, **kw)
        ops = soup_ops(a, kw.get("poly_slots", 8))
    else:
        warm = len(a) == 4
        out = (solver_cuda.solve_warm if warm else solver_cuda.solve)(*a, **kw)
        ops = physics_ops("solver_warm" if warm else "solver", a, kw)
    return list(bound(nbytes(a) + nbytes(kw) + nbytes(out), ops))


def clip_past_f1024():
    """B1 at F = 1,025 (past the old explicit F <= 1,024), S = 8: phase 3's
    degenerate cases 100 times over, 800 polytopes, more than the CTA
    variant's scratch slots (``clip_cuda.CTA_SLOTS``), so its CTAs walk
    them: one launch of the CTA variant with its vertex buffers in the
    scratch, none of the global fold. Bit for bit against the plain
    version. Returns the call's shape, launches and arguments."""
    (poly, planes, mask), kw = degenerate_clip_cases("cuda", F=1025, S=8)
    reps = 100
    poly = poly.map(lambda t: t.repeat((reps,) + (1,) * (t.dim() - 1)))
    a = (poly, planes.repeat(reps, 1, 1), mask.repeat(reps, 1))
    N = poly.face_verts.shape[0]
    variant = clip_cuda._variant(N, 1025, 8)
    reset_all()
    clip_cuda.clip_planes_batch(*a, **kw)
    torch.cuda.synchronize()
    n, g, old = clip_cuda.launches, clip_cuda.general_launches, clip_cuda.global_launches
    if variant != "cta_scratch" or not n == g == 1 or old:
        fail(f"phase 30 clip_fold at (N, F, S) ({N}, 1025, 8): variant {variant}, {n} launches, "
             f"{g} of the CTA variant, {old} of the global fold; want cta_scratch, 1, 1, 0")
    compare_clip(a, kw)
    print(f"phase 30 clip_fold at (N, F, S) ({N}, 1025, 8): bit for bit against the plain "
          f"version; 1 launch of the CTA variant, its vertex buffers in a scratch of "
          f"{min(N, clip_cuda.CTA_SLOTS)} slots", flush=True)
    return {"shape": [N, 1025, 8], "variant": variant, "launches": n, "args": (a, kw)}


def forced_variant_checks(labels_call):
    """Each variant of B1 and B3 past the old limits, held bit for bit
    against its plain version on the degenerate cases, forced where the
    shape would take another (``_variant`` replaced for the call): B1's
    "cta" and "cta_scratch" on phase 3's cases (F = 26, S = 16) and at F =
    256, S = 32, the global fold at F = ``LIMIT_F_GLOBAL`` (its own
    variant there); B3's "vertex" and "vertex_scratch" on phase 3's label
    edge cases (T = 1-1,024: strips in several orders, complete graphs,
    corners a half tol apart, corner keys equal in their low 21 bits only,
    all-invalid soups, iters 1 and 2) and on four T = 2,048 soups of the
    same kinds, and on phase 30's prepare call. Each forced run must move
    that variant's launch counter. Returns the counts of cases."""
    clip_cases = [degenerate_clip_cases("cuda"), degenerate_clip_cases("cuda", F=256, S=32)]
    g = torch.Generator().manual_seed(2048)
    T = 2048
    c = torch.stack([_strip(T, torch.randperm(T, generator=g), g), key_wrap_soup(T, g, 1e-5),
                     torch.rand((T, 3, 3), generator=g), half_tol_soup(T, g, 1e-5)])
    c[2, :, 1] = 0.5                                       # a complete graph
    v = torch.ones((4, T), dtype=torch.bool)
    v[0, ::9] = False
    label_cases = [((x.to("cuda"), m.to("cuda")), kw) for x, m, kw in label_edge_cases(g)]
    label_cases += [((c.to("cuda"), v.to("cuda")), {}), ((c.to("cuda"), v.to("cuda")),
                                                          {"iters": 3}),
                    ((c.to("cuda"), torch.zeros_like(v).to("cuda")), {}), labels_call]
    counts = {}
    for mod, cases, cmp, variants, counter in (
            (clip_cuda, clip_cases, compare_clip, ("cta", "cta_scratch"), "general_launches"),
            (labels_cuda, label_cases, compare_labels, ("vertex", "vertex_scratch"),
             "general_launches")):
        orig = mod._variant
        for variant in variants:
            mod._variant = lambda *shape, _v=variant: _v
            try:
                for a, kw in cases:
                    before = getattr(mod, counter)
                    cmp(a, kw)
                    torch.cuda.synchronize()
                    if getattr(mod, counter) <= before:
                        fail(f"phase 30: {mod.__name__} forced to {variant} did not launch it")
            finally:
                mod._variant = orig
            counts[f"{mod.__name__.rsplit('.', 1)[1]}:{variant}"] = len(cases)
    ga = degenerate_clip_cases("cuda", F=LIMIT_F_GLOBAL, S=4)
    before = clip_cuda.global_launches
    compare_clip(*ga)
    torch.cuda.synchronize()
    if clip_cuda._variant(8, LIMIT_F_GLOBAL, 4) != "global" or clip_cuda.global_launches <= before:
        fail(f"phase 30 clip_fold at F = {LIMIT_F_GLOBAL}: the global fold did not launch")
    print(f"phase 30 forced variants: bit for bit against the plain versions on "
          f"{json.dumps(counts)} cases; the global fold at F = {LIMIT_F_GLOBAL}, S = 4 too",
          flush=True)
    return {"cases": counts, "global_args": ga}


def prep_inplace_case(device, kw, shape=PREP_INPLACE_SHAPE, seed=20):
    """B8's inputs at (Np, K, M) = ``shape`` under ``kw`` (a step's prep
    keywords, K and M replaced): random pair records with hit and missed
    points, a dead partner's slots (NaN depth, no hit), pidx = -1 slots,
    sleeping and static bodies, ground contacts with and without hits."""
    Np, K, M = shape
    G = kw["G"]
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(s, generator=g)  # noqa: E731
    x = u(-2.0, 2.0, Np, 3)
    raw = torch.zeros((Np, K, 5 + 6 * M))
    n = torch.randn((Np, K, 3), generator=g)
    raw[..., 0:3] = n / n.norm(dim=-1, keepdim=True)
    raw[..., 3] = u(-0.01, 0.05, Np, K)
    raw[..., 5::6] = u(-0.01, 0.05, Np, K, M)
    raw[..., 6::6] = (torch.rand((Np, K, M), generator=g) < 0.5).float()
    for c in range(3):
        raw[..., 7 + c::6] = x[:, None, None, c] + u(-0.6, 0.6, Np, K, M)
    raw[..., 10::6] = torch.randint(1, 40, (Np, K, M), generator=g).float()
    raw[..., 4] = raw[..., 6::6].amax(-1)
    pidx = torch.randint(-1, Np, (Np, K), generator=g, dtype=torch.int32)
    dead = torch.rand((Np, K), generator=g) < 0.2
    raw[..., 3][dead] = float("nan")
    raw[..., 5::6][dead] = float("nan")
    raw[..., 6::6][dead] = 0.0
    raw[..., 4][dead] = 0.0
    a = torch.randn((Np, 3, 3), generator=g)
    inv_I = (0.3 * a @ a.transpose(1, 2) + 0.2 * torch.eye(3)).reshape(Np, 9)
    inv_m = u(0.05, 0.3, Np)
    inv_m[::11] = 0.0
    gd = u(-0.02, 0.05, Np, G)
    args = (raw, pidx, x[:, None] + u(-0.6, 0.6, Np, G, 3), gd, gd > 0.0, x, torch.randn(
        (Np, 3), generator=g), torch.randn((Np, 3), generator=g), inv_m, inv_I,
        torch.rand(Np, generator=g) < 0.25)
    return tuple(t.to(device) for t in args), dict(kw, K=K, M=M)


def forced_b8_b12_checks(prep_calls, bp, W):
    """Each variant of B8 and B12 past the old limits, held bit for bit
    against its plain version, forced where the shape would take another
    (``_variant`` / ``_sorted_variant`` replaced for the call): B8's "wide"
    and "wide_inplace" on ``prep_calls`` (phase 30's lattice step at K =
    32, M = 4, its K = 32, M = 64 step, where "wide" only where a partner's
    record fits); B12's "list" on ``sorted_edge_cases`` at K = 8 and 48, W
    = ``W`` (its register lists; K = 16, W = 128 and K = 2W among them) and
    on ``bp`` at K 16, W 64, and "list_scratch" on ``bp`` and the lattice of
    ties at W = 256 and 1,024. Each forced run must move that variant's
    launch counter. Returns the counts of cases."""
    bcases = broadphase_cases("cuda")
    ties = bcases["lattice ties"]
    lists = (sorted_edge_cases(bcases, 8, W) + sorted_edge_cases(bcases, LIMIT_K_LIST, W)
             + [(bp + (16, 64), {}), (bp + (32, W), {})])
    scratch = [(bp + (8, 256), {}), (bp + (32, 1024), {}), (tuple(ties) + (8, 256), {}),
               (tuple(ties) + (48, 1024), {})]
    runs = [(prep_cuda, "_variant", "wide",
             [c for c in prep_calls if prep_cuda.wide_partners(c[1]["K"], c[1]["M"], True)],
             compare_prep, "general_launches"),
            (prep_cuda, "_variant", "wide_inplace", prep_calls, compare_prep,
             "general_launches"),
            (broadphase_cuda, "_sorted_variant", "list", lists, compare_broadphase_sorted,
             "sorted_list_launches"),
            (broadphase_cuda, "_sorted_variant", "list_scratch", scratch,
             compare_broadphase_sorted, "sorted_list_launches")]
    counts = {}
    for mod, attr, variant, cases, cmp, counter in runs:
        orig = getattr(mod, attr)
        setattr(mod, attr, lambda *shape, _v=variant: _v)
        try:
            for a, kw in cases:
                before = getattr(mod, counter)
                cmp(a, kw)
                torch.cuda.synchronize()
                if getattr(mod, counter) <= before:
                    fail(f"phase 30: {mod.__name__} forced to {variant} did not launch it")
        finally:
            setattr(mod, attr, orig)
        counts[f"{mod.__name__.rsplit('.', 1)[1]}:{variant}"] = len(cases)
    print(f"phase 30 forced B8 and B12 variants: bit for bit against the plain versions on "
          f"{json.dumps(counts)} cases", flush=True)
    return {"cases_b8_b12": counts}


def forced_b7_b9_checks(nar_calls, sol_calls):
    """The last resorts of B7 and B9 ("general": one thread a pair, rows
    read in place; the scratch solver), forced where the shape takes the
    group or shared kernel (``_variant`` replaced for the call), each call
    bit for bit against its plain version: B7 on phase 30's lattice call at
    Vh 12, its Vh 768 and M 64 calls and ``narrowphase_edge_cases``; B9 on
    the lattice call in both modes and the M 64 call. Each forced run must
    move the module's ``fallback_launches``. Returns the counts of cases."""
    runs = [(narrowphase_cuda, nar_calls, compare_narrowphase),
            (solver_cuda, sol_calls,
             lambda a, kw: (compare_solver_warm if len(a) == 4 else compare_solver)(a, kw))]
    counts = {}
    for mod, cases, cmp in runs:
        orig = mod._variant
        mod._variant = lambda *shape: "general"
        try:
            for a, kw in cases:
                before = mod.fallback_launches
                cmp(a, kw)
                torch.cuda.synchronize()
                if mod.fallback_launches <= before:
                    fail(f"phase 30: {mod.__name__} forced to general did not launch it")
        finally:
            mod._variant = orig
        counts[f"{mod.__name__.rsplit('.', 1)[1]}:general"] = len(cases)
    print(f"phase 30 forced B7 and B9 last resorts: bit for bit against the plain versions on "
          f"{json.dumps(counts)} cases", flush=True)
    return {"cases_b7_b9": counts}


def pack_zero_case(call):
    """B5's inputs of ``call`` with supports tied at zero: body 0 at (-0,
    -0, -0) with the identity pose owns pieces 0-2; each has a live corner
    at (-0, -0, -0) (world -0) and one at (+0, +0, +0) (world +0), in
    either order, and its other corners on one side of the origin, so that
    +0 and -0 tie at the end of its intervals (the card's fminf / fmaxf and
    the plain version order them: -0 the minimum, +0 the maximum)."""
    a, kw = call
    verts, vmask, owner, q, x = (t.clone() for t in (a[0], a[1], a[6], a[8], a[9]))
    q[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    x[0] = -0.0
    for i, (lo, hi, side) in enumerate(((0, 1, 1.0), (1, 0, 1.0), (0, 1, -1.0))):
        owner[i] = 0
        verts[i] = side * (verts[i].abs() + 0.1)
        verts[i, lo] = -0.0
        verts[i, hi] = 0.0
        vmask[i, lo] = vmask[i, hi] = True
    return (verts, vmask, *a[2:6], owner, a[7], q, x, *a[10:]), kw


def pack_inplace_case(call, Vh: int = LIMIT_VH_INPLACE, n: int = 16):
    """B5's inputs of ``call``'s first ``n`` pieces at ``Vh`` corners (their
    corners and corner masks repeated): past 8,001 corners at F = 8 a wide
    CTA of one piece reads them in place."""
    a, kw = call
    reps = -(-Vh // a[0].shape[1])
    cut = [t[:n] for t in a[:8]]
    cut[0] = cut[0].repeat(1, reps, 1)[:, :Vh].contiguous()
    cut[1] = cut[1].repeat(1, reps)[:, :Vh].contiguous()
    return (*cut, *a[8:]), kw


def forced_b5_b10_checks(pack_calls, soup_calls):
    """The last resorts of B5 and B10 ("direct": rows built in place; the
    general fold, a thread a lane), forced where the shape takes the wide
    or group kernel (``_variant`` replaced for the call), each call bit for
    bit against its plain version: B5 on phase 30's Vh 768 and 747 calls
    and the zero-tie case, B10 on the sphere's call at S 16, 3, 5 and 32.
    Each forced run must move the module's ``fallback_launches``. Then a NaN
    corner in a live piece of the Vh 768 call: the wide variant keeps the
    plain version's NaN intervals (bit for bit); the direct variant's walk
    drops it (ROADMAP C17), which is counted, not failed. Returns the
    counts of cases."""
    counts = {}
    for mod, cases, cmp in ((pack_cuda, pack_calls, compare_pack),
                            (soup_clip_cuda, soup_calls, compare_soup)):
        last = {pack_cuda: "direct", soup_clip_cuda: "general"}[mod]
        orig = mod._variant
        mod._variant = lambda *shape, _v=last: _v
        try:
            for a, kw in cases:
                before = mod.fallback_launches
                cmp(a, kw)
                torch.cuda.synchronize()
                if mod.fallback_launches <= before:
                    fail(f"phase 30: {mod.__name__} forced to {last} did not launch it")
        finally:
            mod._variant = orig
        counts[f"{mod.__name__.rsplit('.', 1)[1]}:{last}"] = len(cases)
    a, kw = pack_calls[0]
    verts, vmask = a[0].clone(), a[1].clone()
    verts[3, 0, 1] = float("nan")
    vmask[3, 0] = True
    nan_call = ((verts, vmask, *a[2:]), kw)
    compare_pack(*nan_call)
    orig = pack_cuda._variant
    pack_cuda._variant = lambda *shape: "direct"
    try:
        got = pack_cuda.transform_pack_owned(*nan_call[0], **kw)
    finally:
        pack_cuda._variant = orig
    want = pack_cuda.transform_pack_owned_reference(*nan_call[0], **kw)
    rows = int((((got[0].view(torch.int32) != want[0].view(torch.int32))
                 & ~(torch.isnan(got[0]) & torch.isnan(want[0]))).any(1)).sum())
    print(f"phase 30 forced B5 and B10 last resorts: bit for bit against the plain versions on "
          f"{json.dumps(counts)} cases; a NaN corner: the wide variant bit for bit, the direct "
          f"variant differs in {rows} packed row(s) (ROADMAP C17)", flush=True)
    return {"cases_b5_b10": counts, "nan_corner_direct_rows": rows}


def warm_solver_case(call, seed: int = 30):
    """B9's accumulated mode on a plain-mode call's inputs: seeded totals
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


def tile_labels(a, kw):
    """B3's general call repeated over the soups to 300 or more, more soups
    than the general variant's CTAs (``labels_cuda.GENERAL_BLOCKS``): its
    CTAs walk the soups."""
    corners, valid = a[:2]
    reps = -(-300 // corners.shape[0])
    return (corners.repeat(reps, 1, 1, 1), valid.repeat(reps, 1)), kw


def tile_solver(a, kw, reps: int = 24):
    """B9's call past K = 16 on ``reps`` copies of its lattice (24,000
    rows): more rows than the shared variant's cooperative grid holds (a
    warp a row, about 2,000 rows on the card at C 132), so its warps walk
    them and restage each row's tables every iteration."""
    vw0, pb, tables = a[:3]
    Np = vw0.shape[0]
    pbs = torch.cat([pb + i * Np for i in range(reps)])
    return (vw0.repeat(reps, 1), pbs, tuple(t.repeat(reps, 1) for t in tables)), kw


def check_layouts():
    """The byte counts behind each wrapper's choice of variant (Python)
    against the C functions the kernels size their memory with, over the
    shapes where the choice flips and around them. Returns the number of
    shapes compared."""
    import ctypes

    def q(name, n):
        return _build.bind(name, [ctypes.c_int] * n, ctypes.c_longlong)

    grids = [
        ("surtr_clip_fold_poly_bytes", clip_cuda.poly_bytes,
         [(F, S) for F in (4, 26, 96, 249, 250, 256, 984, 985, 1024, 1025, 4096)
          for S in (3, 8, 16, 32, 64)]),
        ("surtr_pack_stage_bytes", pack_cuda.stage_bytes,
         [(Vh, F, Ne) for Vh in (8, 16, 17, 64, 723, 724, 768) for F in (8, 16, 17, 26, 32)
          for Ne in (0, 3, 16, 17)]),
        ("surtr_pack_wide_bytes", pack_cuda.wide_bytes,
         [(Vh, F, Ne) for Vh in (8, 17, 724, 768, 2667, 7989, 7990, 14482, 14483, 20000)
          for F in (8, 26, 32) for Ne in (0, 3, 17)]),
        ("surtr_prep_row_bytes", prep_cuda.row_bytes,
         [(K, M, G) for K in (1, 8, 16, 32, 64) for M in (1, 4, 25, 26, 64) for G in (0, 4)]),
        ("surtr_prep_wide_bytes", lambda K, M, s: prep_cuda.wide_bytes(K, M, bool(s)),
         [(K, M, s) for K in (1, 8, 32, 47, 48, 922, 5000) for M in (1, 4, 64, 3223, 3224)
          for s in (0, 1)]),
        ("surtr_broadphase_sorted_list_bytes", broadphase_cuda.list_bytes,
         [(K, W) for W in (129, 256, 1024, 14304, 14305, 20000) for K in (1, 8, 48, 893, 894)]),
        ("surtr_labels_vertex_bytes", labels_cuda.vertex_bytes,
         [(T,) for T in (1, 31, 32, 33, 1024, 1025, 2048, 2049, 2454, 2455, 4096, 8192)]),
        ("surtr_clip_fold_cta_bytes", clip_cuda.cta_bytes,
         [(F, S) for F in (4, 26, 249, 250, 256, 264, 265, 1025, 2131, 2132) for S in (3, 8, 32)]),
        ("surtr_clip_fold_cta_aux_bytes", lambda F, S: clip_cuda.cta_aux_bytes(F),
         [(F, 8) for F in (4, 26, 256, 1025, 2131, 2132, 4096)]),
        ("surtr_ich_table_words", hull_cuda.table_words,
         [(F,) for F in (4, 20, 32, 33, 44, 64, 65, 128, 129, 132, 2400, 2401, 4096)]),
        ("surtr_ich_set_bytes", hull_cuda.set_bytes,
         [(N, F) for N in (1, 45, 512, 608, 896, 1917, 1918, 2187, 2188) for F in (20, 44, 96, 128)]),
        ("surtr_ich_general_stage", hull_cuda.general_stage,
         [(N, F) for N in (1, 162, 5000, 6560, 11956, 11957, 20000)
          for F in (129, 132, 260, 2400, 2401, 4096)]),
        ("surtr_raster_global_bytes", raster_cuda.global_bytes,
         [(n, k) for n in (1, 128, 512, 8192, 10239, 10240, 32768, 10 ** 6)
          for k in (1, 528, 1056)]),
        ("surtr_narrowphase_staged_bytes", narrowphase_cuda.staged_bytes,
         [(Vh, K, F, Ne, M) for Vh in (8, 12, 16, 32, 64, 128) for K in (1, 8, 32)
          for F in (8, 26, 32) for Ne in (3, 16) for M in (1, 4, 20, 64)]),
        ("surtr_narrowphase_group_bytes", narrowphase_cuda.group_bytes,
         [(Vh, K, F, Ne, M) for Vh in (1, 5, 8, 12, 24, 97, 768, 1300) for K in (1, 8, 32)
          for F in (8, 26) for Ne in (0, 3) for M in (1, 4, 64)]),
        ("surtr_solver_shared_bytes", lambda K, C, w: solver_cuda.shared_bytes(K, C, bool(w)),
         [(K, C, w) for K in (1, 17, 32, 33, 64) for C in (17, 129, 132, 136, 2052, 2200)
          for w in (0, 1)]),
    ]
    n = 0
    for cname, pyfn, shapes in grids:
        cfn = q(cname, len(shapes[0]))
        for shape in shapes:
            c, py = cfn(*shape), pyfn(*shape)
            if c != py:
                fail(f"phase 30 layouts: {cname}{shape} is {c} in C, {py} in Python")
            n += 1
    print(f"phase 30 layouts: the Python byte counts equal the kernels' C layouts at {n} shapes "
          f"({', '.join(g[0] for g in grids)})", flush=True)
    return n


def main():
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    card = workload.card()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()

    # 2. Build.
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)", flush=True)
    start_cpu_runs()
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    # 3. Kernel phases: main-path inputs + degenerate cases.
    calls = capture_main_path_inputs()
    shapes = {
        "clip_fold": [tuple(a[0].face_verts.shape[:3]) + (a[1].shape[1],) for a, _ in calls["clip_fold"]],
        "ich": [tuple(a[0].shape) for a, _ in calls["ich"]],
        "labels": [tuple(a[0].shape[:2]) for a, _ in calls["labels"]],
        "refit": [refit_points(a) for a, _ in calls["refit"]],
    }
    print("main-path kernel shapes:", json.dumps(shapes), flush=True)
    compare = {"clip_fold": compare_clip, "ich": compare_ich,
               "labels": compare_labels, "refit": compare_refit}
    degen = degenerate_cases("cuda")
    results = {}
    for name in KERNELS:
        err = 0.0
        for a, kw in calls[name] + degen[name]:
            err = max(err, compare[name](a, kw))
        torch.cuda.synchronize()
        ms, plain_ms = time_kernel(name, calls[name])
        b_ms, b_by = decomposition_bound(name, calls[name])
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by}
        split = per_call_times(name, calls[name])
        for shape, t in zip(shapes[name], split):
            t["shape"] = list(shape)
            if name == "clip_fold":
                print(f"clip_fold call (N, F, S, K) {list(shape)}: wrapper {t['ms']:.4f} ms, "
                      f"kernel {t['device_ms']:.4f} ms on the device ({card})", flush=True)
        results[name]["calls"] = split
        results[name]["device_ms"] = sum(t["device_ms"] for t in split)
        if name == "ich":   # B2 a call on the cube and on the sphere
            sphere = sphere_ich_call("cuda")
            compare_ich(*sphere)
            t = per_call_times(name, [sphere])[0]
            t["shape"] = list(sphere[0][0].shape)
            results[name]["sphere_call"] = t
            for model, c in (("cube", split[0]), ("sphere", t)):
                print(f"ich call {model} (N, 3) {c['shape']}: wrapper {c['ms']:.4f} ms, kernel "
                      f"{c['device_ms']:.4f} ms on the device ({card})", flush=True)
        print(f"{name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms (on the device "
              f"{results[name]['device_ms']:.4f} ms)  plain {plain_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}) ({len(calls[name])} main-path calls; {card})",
              flush=True)

    # 4. Main path on the card, counting launches.
    reset_all()
    pieces, ctx, met = run_prepare("cuda")
    torch.cuda.synchronize()
    counts = all_counts()
    gpu = {k: float(v) for k, v in met.items()}
    print("main path (cuda):", json.dumps(gpu), "launches:", json.dumps(counts), flush=True)
    check_launches("main path", counts, {name: want for name, (*_, want) in KERNELS.items()})
    if int(gpu["piece_cnt"]) != 1024:
        fail(f"piece_cnt {gpu['piece_cnt']} != 1024")
    if abs(gpu["total_volume"] - 27.005) >= 0.05:
        fail(f"total_volume {gpu['total_volume']} not within 0.05 of 27.005")
    fv = pieces.convex.face_verts
    if fv.shape != (1024, 26, 16, 3) or not bool(torch.isfinite(fv).all()):
        fail("pieces are not finite or not of the expected shape")
    print(f"mesh_tris_dropped (cuda): {int(gpu['mesh_tris_dropped'])}", flush=True)

    # 5. The same event through the plain path on the CPU.
    t0 = time.perf_counter()
    _, _, met_cpu = run_prepare("cpu")
    cpu = {k: float(v) for k, v in met_cpu.items()}
    print(f"main path (cpu, plain): {json.dumps(cpu)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for key in ("piece_cnt", "mesh_tris_dropped", "ich_face_cnt"):
        if int(cpu[key]) != int(gpu[key]):
            fail(f"{key}: cuda {gpu[key]} != cpu {cpu[key]}")
    if abs(cpu["total_volume"] - gpu["total_volume"]) > 1e-5 * abs(cpu["total_volume"]):
        fail(f"total_volume: cuda {gpu['total_volume']} vs cpu {cpu['total_volume']}")

    # 6. Timing per event on the card.
    ms_event = host_ms(lambda: run_prepare("cuda"))
    print(f"prepare_fracture cube 1k: median {ms_event:.3f} ms/event ({card})", flush=True)

    # 7. Physics kernels against their plain versions on the main path's
    # inputs (the last of the 64 steps; the warm solver's of a warm-start
    # run) and degenerate cases.
    phys = physics_kernel_phase(card)

    # 8. Physics main path on the card, counting launches.
    phys_counts, before_last = physics_main_path(card)

    # 9. The same lattice through the plain path on the CPU.
    physics_cpu_compare(30)

    # (a)-(e). The other paths of physics_step.
    variants = physics_variants(card)

    # 10. Timing.
    timing = physics_timing(before_last, variants, card)

    # 11. The sphere decomposition: the culled pair-pool mesh clip (B10).
    sphere_counts, sphere_met, sphere_calls = sphere_phase()

    # 12. The cube32 impact under both mesh-clip routes.
    prepared, impact, pooled_calls = impact_phase()

    # 13. B10 against its plain version on both paths' inputs.
    soup = soup_kernel_phase({"sphere decomposition": sphere_calls,
                              "cube32 impact, pooled": pooled_calls}, card)

    # 14. Timing of the sphere decomposition and the impact.
    fracture = fracture_timing(prepared, card)

    # 16. The interactive frame on the card, counting launches per frame.
    frame_counts, frame_calls, frames, frac_calls, frame_phys = frame_main_path(card)

    # 15. B11 against its plain version (the frame's calls, render_512's,
    # degenerate tables); B1, B3, B4, B5 and B7 at the frame's shapes.
    raster = raster_kernel_phase(frame_calls, card)
    frame_kernels = frame_kernel_phase(frac_calls, frame_phys, card)

    # 17. The same frames from one CPU-built Scene on both devices.
    start = frame_cpu_compare(card)

    # 18. Timing of the frame and of render_512.
    frame = frame_timing(start, card)

    # 19. The kernels at the torus config-1 event's calls.
    concave_kernels = concave_kernel_phase(card)

    # 20. The torus at config 1 on the card, against the CPU plain run.
    concave_counts, concave_met, concave_cmp = concave_main_path(card)

    # 21. Scene("torus") and Scene("blob") in lockstep on both devices.
    concave_starts, concave_scenes = concave_scene_phase(card)

    # 22. Times of the concave path.
    concave_times = concave_timing(concave_starts, card)

    phase_s = {}

    def timed(n, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[n] = round(time.perf_counter() - t0, 1)
        return res

    # 23. Every PhysicsConfig route on the 10k lattice.
    routes = timed(23, routes_phase, before_last, card)

    # 24. BASELINE config 2: batch_decompose of 64 cubes.
    config2 = timed(24, batch_phase, card)

    # 25. batch_step: four copies of the 10k lattice.
    bstep = timed(25, batch_step_phase, card)

    # 26. The CLI.
    cli = timed(26, cli_phase, card)

    # 27. PhaseTimer and the stage fences.
    stages = timed(27, stages_phase, before_last, prepared, card)

    # 28. The ICH refit on the batched B2, the per-cell mesh-clip fallback,
    # Delaunay and the sharded batch variants.
    ich_batch_res = timed("28a", refit_kernel_phase, card)
    refit_paths = timed("28b-d", refit_paths_phase, prepared, card)
    delaunay = timed("28e", delaunay_phase, card)
    sharded = timed("28f", sharded_phase, card)

    # 29. BASELINE config 1 at its model's scale.
    model_scale = timed(29, model_scale_phase, card)

    # 30. Past the old limits: each kernel's general variant.
    limits = timed(30, limits_phase, card, before_last)
    print(f"phases 23-30, s: {json.dumps(phase_s)}", flush=True)

    path_counts = {"broadphase_sorted": ("b_sorted", variants["b_sorted"][0]),
                   "solver_warm": ("d_warm", variants["d_warm"][0])}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "path": "decomposition",
         "launches": counts[name], **results[name], "library_ms": None}
        for name, (_, src, rep, _) in KERNELS.items()
    ]
    for name, (_, _, src, rep, _) in PHYS_KERNELS.items():
        path, cnt = path_counts.get(name, ("physics main", phys_counts))
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "path": path, "launches": cnt[name], **phys[name], "library_ms": None})
    soup_main = soup["sphere decomposition"]
    kernels.append({
        "name": "soup_clip", "route": "cuda", "source": SOUP_SRC, "replaces": SOUP_REPLACES,
        "path": "sphere decomposition", "launches": sphere_counts["soup_clip"],
        "max_abs_err": soup["max_abs_err"],
        **{k: soup_main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "shapes")},
        "library_ms": None,
        "pooled_impact": {"launches": impact["pooled"]["launches"]["soup_clip"],
                          **soup["cube32 impact, pooled"]},
    })
    raster_main = raster["interactive frame"]
    kernels.append({
        "name": "raster", "route": "cuda", "source": RASTER_SRC, "replaces": RASTER_REPLACES,
        "path": "interactive frame", "launches": frame_counts["raster"],
        "max_abs_err": raster["max_abs_err"],
        **{k: raster_main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                       "shapes", "wrapper_ms", "glue_device_ms",
                                       "glue_device_launches", "calls")},
        "glue_launches": frame_counts["raster_glue"],
        "library_ms": None,
        "render_512": {k: v for k, v in raster.items() if k.startswith("render_512")},
    })
    kernels.append({
        "name": "ich_batch", "route": "cuda", "source": ICH_BATCH_SRC,
        "replaces": ICH_BATCH_REPLACES, "path": "cube 1k decomposition, refit limit 20",
        "launches": refit_paths["cube_limit20"]["launches"]["ich_batch"],
        "warp_set_launches": refit_paths["cube_limit20"]["launches"]["ich_warp_set"],
        **{k: ich_batch_res[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by", "variant", "calls",
                                         "variants")},
        "library_ms": None,
    })
    for k in kernels:
        if k["name"] in concave_kernels:
            k["torus_config1"] = {"launches": concave_counts[k["name"]],
                                  **concave_kernels[k["name"]]}
            k["model_scale"] = {"launches": model_scale["launches"][k["name"]],
                                **model_scale["kernels"][k["name"]]}
    labels = {"broadphase_exact": "broadphase_exact_long",
              "broadphase_exact_10k": "broadphase_exact_long_10k",
              "raster_render_512": "raster_general_render_512",
              "clip_fold": "clip_fold_cta", "clip_fold_f1025": "clip_fold_cta_scratch_f1025",
              "clip_fold_global": "clip_fold_global", "labels": "labels_vertex",
              "labels_scratch": "labels_vertex_scratch", "prep": "prep_wide",
              "prep_inplace": "prep_wide_inplace", "broadphase_sorted": "broadphase_sorted_list",
              "broadphase_sorted_k48": "broadphase_sorted_list_k48",
              "narrowphase": "narrowphase_group", "solver": "solver_shared",
              "pack": "pack_wide", "soup_clip": "soup_clip_group",
              "soup_clip_s40": "soup_clip_general_s40"}
    for name, res in limits["kernels"].items():
        _, _, src, rep, _ = GENERAL[PAST_CASES.get(name, name)]
        kernels.append({"name": labels.get(name, f"{name}_general"), "route": "cuda",
                        "source": src, "replaces": rep, "path": "phase 30, past the old limits",
                        "launches": limits["launches"][name], "library_ms": None, **res})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device check", flush=True)
    print(json.dumps({"kernels": kernels, "event_ms": ms_event, "physics": timing,
                      "sphere": {"metrics": sphere_met, "launches": sphere_counts},
                      "impact": impact, "fracture_timing": fracture,
                      "frame": {"timing": frame, "frames": frames, "kernels": frame_kernels},
                      "concave": {"torus_config1": {"metrics": concave_met,
                                                    "launches": concave_counts,
                                                    "cpu_compare": concave_cmp},
                                  "scenes": concave_scenes, "timing": concave_times},
                      "routes": routes, "config2": config2, "batch_step": bstep, "cli": cli,
                      "stages": stages, "refit_paths": refit_paths, "delaunay": delaunay,
                      "sharded": sharded,
                      "model_scale": {k: model_scale[k] for k in ("metrics", "launches",
                                                                  "cpu_compare", "timing")},
                      "limits": {k: limits[k] for k in ("physics", "prepare", "clip_f1025",
                                                        "forced", "layouts")},
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--device-split"]:
        device_split_main(sys.argv[2])
    elif sys.argv[1:2] == ["--cpu-runs"]:
        cpu_runs_main(sys.argv[2])
    else:
        main()
