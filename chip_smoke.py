#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. a CUDA device is present; print the card, torch and CUDA versions;
  2. build the hand-written kernels from ``surtr_tpu_torch/csrc``;
  3. per kernel (B1 clip fold, B2 ICH, B3 island labels, B4 refit planes):
     the kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it plus degenerate cases, with times;
  4. the main path: ``prepare_fracture`` of the cube at the 1k-seed bench
     configuration on ``cuda:0``, with launch counts proving every kernel
     ran;
  5. the same event through the plain path on the CPU, compared;
  6. median ms per event on the card.
The line before last is a JSON object of per-kernel results; the last line
is the device JSON object.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

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

from surtr_tpu_torch import _build, workload
from surtr_tpu_torch.fracture import pipeline
from surtr_tpu_torch.io.models import get_model
from surtr_tpu_torch.ops import clip_cuda, hull_cuda, labels_cuda, refit_cuda, voronoi
from surtr_tpu_torch.types import ConvexPoly, unit_cube
from surtr_tpu_torch.workload import run_prepare

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


def capture_main_path_inputs():
    """Run the main path once on the card with recording wrappers, returning
    the arguments each kernel wrapper received (its real shapes)."""
    calls = {k: [] for k in KERNELS}
    patches = [
        (pipeline, "clip_planes_batch", "clip_fold"),
        (voronoi, "clip_planes_batch", "clip_fold"),
        (pipeline, "ich", "ich"),
        (pipeline, "tri_soup_components_batch", "labels"),
        (pipeline, "refit_planes_batch", "refit"),
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
        run_prepare("cuda")
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


def _scale(x, valid):
    """Per item of the batch: the largest |coordinate| of its valid points,
    at least 1 (planes carry unit normals)."""
    m = torch.where(valid[..., None], x.abs(), 0.0)
    return m.flatten(1).amax(1).clamp_min(1.0)


def _check_close(name, what, err, scale):
    """Fail naming each batch item whose ``err`` exceeds 1e-5 x its scale
    (NaN counts as exceeding)."""
    bad = torch.nonzero(~(err <= 1e-5 * scale)).flatten().tolist()
    if bad:
        fail(f"{name}: {what} differ from the plain version in items {bad[:10]} "
             f"({len(bad)} in all, max {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def compare_clip(args, kw):
    """n_verts exactly (so emptiness and live faces too); per polytope, face
    vertices and planes within 1e-5 x its scale. Returns the largest vertex
    or plane difference."""
    poly, planes, mask = args[:3]
    got = clip_cuda.clip_planes_batch(poly, planes, mask)
    want = clip_cuda.clip_planes_batch_reference(poly, planes, mask)
    if not torch.equal(got.n_verts, want.n_verts):
        bad = torch.nonzero((got.n_verts != want.n_verts).any(-1)).flatten().tolist()
        fail(f"clip_fold: n_verts differ from the plain fold in polytopes {bad[:10]} "
             f"({len(bad)} in all)")
    dv = torch.where(got.slot_mask()[..., None], (got.face_verts - want.face_verts).abs(), 0.0)
    dp = torch.where(got.face_mask()[..., None], (got.planes - want.planes).abs(), 0.0)
    err = torch.maximum(dv.flatten(1).amax(1), dp.flatten(1).amax(1))
    return _check_close("clip_fold", "face vertices or planes", err,
                        _scale(poly.face_verts, poly.slot_mask()))


def compare_ich(args, kw):
    pts, mask = args[:2]
    limit = kw.get("limit", args[2] if len(args) > 2 else 20)
    got = hull_cuda.ich(pts, mask, limit=limit)
    want = hull_cuda.ich_reference(pts, mask, limit=limit)
    if not torch.equal(got["face_valid"], want["face_valid"]):
        fail("ich: face_valid differs from the plain hull")
    err = float(torch.amax(torch.abs(got["normals"] - want["normals"])))
    ierr = float(torch.amax(torch.abs(got["inner"] - want["inner"])))
    scale = float(torch.amax(torch.abs(pts))) or 1.0
    if not (err <= 1e-5 and ierr <= 1e-6 * scale):
        fail(f"ich: normals differ by {err}, inner by {ierr}")
    return max(err, ierr)


def compare_labels(args, kw):
    corners, valid = args[:2]
    iters = kw.get("iters")
    got = labels_cuda.tri_soup_components_batch(corners, valid, iters=iters)
    want = labels_cuda.tri_soup_components_batch_reference(corners, valid, iters=iters)
    if not torch.equal(got, want):
        fail(f"labels: {int((got != want).sum())} labels differ from the plain closure")
    return 0.0


def compare_refit(args, kw):
    """The plane mask exactly; per candidate, the valid slab planes (normals
    and offsets) within 1e-5 x its pool's scale."""
    pool, pmask = args[:2]
    gp, gm = refit_cuda.refit_planes_batch(pool, pmask)
    wp, wm = refit_cuda.refit_planes_batch_reference(pool, pmask)
    if not torch.equal(gm, wm):
        bad = torch.nonzero((gm != wm).any(-1)).flatten().tolist()
        fail(f"refit: plane masks differ in candidates {bad[:10]} ({len(bad)} in all)")
    err = torch.where(gm[..., None], (gp - wp).abs(), 0.0).flatten(1).amax(1)
    return _check_close("refit", "slab planes", err, _scale(pool, pmask))


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
    pool = torch.randn((5, 40, 3), generator=g)
    pm = torch.rand((5, 40), generator=g) > 0.3
    pm[3, 4:] = False
    pm[4] = False
    refit_cases = [((pool.to(device), pm.to(device)), {})]
    return {
        "clip_fold": [degenerate_clip_cases(device)],
        "ich": ich_cases,
        "labels": label_cases,
        "refit": refit_cases,
    }


def time_kernel(name, calls):
    """Summed median ms of the main path's calls: kernel vs plain version."""
    if name == "clip_fold":
        k = lambda a, kw: clip_cuda.clip_planes_batch(*a, **kw)
        p = lambda a, kw: clip_cuda.clip_planes_batch_reference(*a, **kw)
    elif name == "ich":
        k = lambda a, kw: hull_cuda.ich(*a, **kw)
        p = lambda a, kw: hull_cuda.ich_reference(*a, **kw)
    elif name == "labels":
        k = lambda a, kw: labels_cuda.tri_soup_components_batch(*a, **kw)
        p = lambda a, kw: labels_cuda.tri_soup_components_batch_reference(*a, **kw)
    else:
        k = lambda a, kw: refit_cuda.refit_planes_batch(*a, **kw)
        p = lambda a, kw: refit_cuda.refit_planes_batch_reference(*a, **kw)
    ms = sum(event_ms(lambda a=a, kw=kw: k(a, kw)) for a, kw in calls)
    plain_ms = sum(event_ms(lambda a=a, kw=kw: p(a, kw), warmup=1) for a, kw in calls)
    return ms, plain_ms


def main():
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    card = workload.card()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    # 3. Kernel phases: main-path inputs + degenerate cases.
    calls = capture_main_path_inputs()
    shapes = {
        "clip_fold": [tuple(a[0].face_verts.shape[:3]) + (a[1].shape[1],) for a, _ in calls["clip_fold"]],
        "ich": [tuple(a[0].shape) for a, _ in calls["ich"]],
        "labels": [tuple(a[0].shape[:2]) for a, _ in calls["labels"]],
        "refit": [tuple(a[0].shape[:2]) for a, _ in calls["refit"]],
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
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"{name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms "
              f"({len(calls[name])} main-path calls; {card})", flush=True)

    # 4. Main path on the card, counting launches.
    for mod, *_ in KERNELS.values():
        mod.launches = 0
    pieces, ctx, met = run_prepare("cuda")
    torch.cuda.synchronize()
    counts = {name: KERNELS[name][0].launches for name in KERNELS}
    gpu = {k: float(v) for k, v in met.items()}
    print("main path (cuda):", json.dumps(gpu), "launches:", json.dumps(counts), flush=True)
    for name, (_, _, _, want) in KERNELS.items():
        if counts[name] != want:
            fail(f"{name} launched {counts[name]} times on the main path, expected {want}")
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

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": counts[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
        }
        for name, (_, src, rep, _) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels, "event_ms": ms_event}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
