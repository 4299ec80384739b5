"""The port's main-path workloads, one owner for the configurations, seeds
and inputs that ``chip_smoke.py``, the tools and the tests drive:

* the 1k-seed decomposition of the cube at ``bench.py``'s
  ``bench_decomposition_1k`` configuration (bench.py:70-92), and of the
  procedural sphere at the same configuration (its 320 triangles exceed
  the per-cell cull pool of 256, so it takes the culled pair-pool mesh
  clip, kernel B10);
* BASELINE config 2, ``bench_batch64_1k`` (bench.py:256-292): 64 cubes
  decomposed at 1k seeds each (``BATCH_CFG``, ``batch_inputs``), one
  ``batch_decompose`` call;
* the 1k-seed decomposition of a concave model at BASELINE config 1's
  configuration (``bench_decomposition_1k_model``, bench.py:136-188, its
  pumpkin absent here, so the procedural torus stands in): exact caps, the
  prepare-time parity grid and the culled pair-pool mesh clip; on the
  default torus (576 triangles) and at the pumpkin's scale, a torus of
  10,000 triangles read back from OBJ text as a user's model is
  (``MODEL_SCALE_MESH``, ``model_scale_mesh``);
* ``Scene`` of a concave model (the torus, the blob) at the default
  ``SceneConfig``, which keeps exact caps, and one impact on a fixed ray
  through the model;
* the cube32 impact of ``bench_cube32`` (bench.py:295-333): the cube
  prepared at its configuration, then one partial ``do_fracture`` event at
  (1.5, 1.5, 1.5);
* the 10k-fragment physics lattice of ``bench_physics_10k``
  (bench.py:191-253) at its configuration (bench.py:207), and the
  variants ``chip_smoke.py`` drives beside it: the lattice bound in pairs
  (compound bodies), a 66,000-cube lattice (beyond the exact sweep's
  pool limit) and the lattice under each ``PhysicsConfig`` route
  (``ROUTES``);
* the interactive frame of ``bench_interactive_frame`` (bench.py:372-434):
  ``Scene("cube", INTERACTIVE_CFG)`` and chained ``interactive_frame``
  calls with the bench's ray, camera and spawn, and its render tail
  ``bench_render`` (bench.py:336-369): 4,096 random triangles rendered
  at 512² with a 512² or 1024² shadow map.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile

import numpy as np
import torch

from surtr_tpu_torch.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
from surtr_tpu_torch.fracture import pipeline
from surtr_tpu_torch.fracture.pattern import radial_seeds, uniform_seeds
from surtr_tpu_torch.fracture.types import PieceSet
from surtr_tpu_torch.io.models import _torus, get_model, sphere_point_cloud
from surtr_tpu_torch.io.obj import load_obj
from surtr_tpu_torch.physics.scene import build_scene
from surtr_tpu_torch.physics.step import physics_step
from surtr_tpu_torch.types import ConvexPoly, map_tree, unit_cube

SEED = 46354
BENCH_CFG = FractureConfig(
    initial_decompose_cell_cnt=1024,
    max_pieces=1024,
    max_faces=26,
    max_face_verts=16,
    max_piece_tris=64,
    voronoi_neighbors=48,
    voronoi_prefix=24,
    partial_pattern_cell_cnt=8,
    general_pattern_cell_cnt=8,
    exact_caps=False,
)


BATCH_CFG = FractureConfig(       # bench.py:264-275
    initial_decompose_cell_cnt=1024,
    max_pieces=1024,
    max_faces=26,
    max_face_verts=16,
    max_piece_tris=64,
    voronoi_neighbors=48,
    voronoi_prefix=24,
    partial_pattern_cell_cnt=8,
    general_pattern_cell_cnt=8,
    exact_caps=False,
)
BATCH_M = 64                      # bench.py:256


MODEL_1K_CFG = FractureConfig(    # bench.py:152-161; every other field at its default
    initial_decompose_cell_cnt=1024,
    max_pieces=1024,
    max_faces=96,
    max_face_verts=32,
    max_piece_tris=128,
    voronoi_neighbors=48,
    partial_pattern_cell_cnt=8,
    general_pattern_cell_cnt=8,
)
CONCAVE_MODEL = "torus"           # the stand-in for config 1's pumpkin
MODEL_SCALE_MESH = dict(nu=100, nv=50)   # 5,000 v / 10,000 f: the pumpkin's size, bench.py:138


CUBE32_CFG = FractureConfig(      # bench.py:301-310
    initial_decompose_cell_cnt=32,
    max_pieces=256,
    max_active_pieces=16,
    max_piece_tris=128,
    partial_pattern_cell_cnt=128,
    voronoi_neighbors=48,
    general_pattern_cell_cnt=8,
    exact_caps=False,
)
IMPACT = (1.5, 1.5, 1.5)          # bench.py:317


def model_scale_obj_text() -> str:
    """The model-scale torus, ``_torus(**MODEL_SCALE_MESH)``, as OBJ text;
    each coordinate reads back to the same float32."""
    v, f = _torus(**MODEL_SCALE_MESH)
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in v.astype(np.float64).tolist()]
    lines += [f"f {a} {b} {c}" for a, b, c in (f.astype(np.int64) + 1).tolist()]
    return "\n".join(lines) + "\n"


def model_scale_mesh():
    """Config 1's mesh at its model's scale, loaded as a user's OBJ is: the
    model-scale torus written to a temporary file and read back by
    ``io.obj.load_obj`` at scale 1 (parse, mirror, weld) → (verts, tris)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "torus10k.obj")
        with open(path, "w") as fh:
            fh.write(model_scale_obj_text())
        return load_obj(path)


def model_inputs(model, device):
    """``prepare_fracture``'s model arguments on ``device`` for ``model``, a
    name (``io.models.get_model``) or a (verts, tris) pair."""
    v, f = get_model(model) if isinstance(model, str) else model
    return (
        torch.as_tensor(v, device=device),
        torch.ones(len(v), dtype=torch.bool, device=device),
        torch.as_tensor(v[f], device=device),
        torch.ones(len(f), dtype=torch.bool, device=device),
        torch.as_tensor(sphere_point_cloud(), device=device),
    )


def bench_seeds(cfg: FractureConfig = BENCH_CFG, seed: int = SEED):
    """Decomposition, partial-pattern and general-pattern seeds (host tensors)."""
    g = torch.Generator().manual_seed(seed)
    return (
        uniform_seeds(g, cfg.initial_decompose_cell_cnt),
        radial_seeds(g, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist),
        radial_seeds(g, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist),
    )


def batch_inputs(device="cuda", M: int = BATCH_M, cfg: FractureConfig = BATCH_CFG,
                 model: str = "cube"):
    """``batch_decompose``'s arguments for config 2: ``model`` stacked M
    times (verts (M, V, 3), vmask, tri corners (M, T, 3, 3), tmask), the
    sphere cloud, and per mesh i the seeds of ``bench_seeds(cfg, SEED + i)``
    stacked to (M, C, 3), (M, Cp, 3), (M, Cg, 3), all on ``device``."""
    v, vm, tc, tm, cloud = model_inputs(model, device)
    seeds = [bench_seeds(cfg, SEED + i) for i in range(M)]
    stack = lambda j: torch.stack([s[j] for s in seeds]).to(device)  # noqa: E731
    return (v.expand((M,) + v.shape), vm.expand(M, -1), tc.expand((M,) + tc.shape),
            tm.expand(M, -1), cloud, stack(0), stack(1), stack(2))


def run_prepare(device="cuda", cfg: FractureConfig = BENCH_CFG, model="cube"):
    """One ``prepare_fracture`` event of ``model`` (a name or a (verts, tris)
    pair) on ``device``, seeded from ``manual_seed(SEED)`` (``bench_seeds``);
    config 1's stand-in is ``run_prepare(device, MODEL_1K_CFG,
    CONCAVE_MODEL)``, at its model's scale ``run_prepare(device,
    MODEL_1K_CFG, model_scale_mesh())``."""
    return pipeline.prepare_fracture(*model_inputs(model, device), cfg, *bench_seeds(cfg))


def to_device(obj, device):
    """A copy of nested dataclasses of tensors (pieces, contexts, scenes)
    on ``device``."""
    return map_tree(obj, lambda a: a.to(device))


def run_impact(device="cuda", cfg: FractureConfig = CUBE32_CFG, prepared=None):
    """The cube32 impact on ``device``: the cube prepared at ``cfg`` (or
    ``prepared``, a (PieceSet, FractureContext) pair, copied to ``device``),
    then ``do_fracture`` at ``IMPACT``, group 0, partial. Returns
    ((pieces, ctx), (out, metrics)), the prepared input first, so that a run
    on another device can start from the same bits."""
    if prepared is None:
        pieces, ctx, _ = run_prepare(device, cfg)
    else:
        pieces, ctx = (to_device(p, device) for p in prepared)
    out = pipeline.do_fracture(pieces, ctx, IMPACT, 0, cfg, partial=True)
    return (pieces, ctx), out


PHYSICS_CFG = PhysicsConfig(single_piece_bodies=True, max_hull_verts=8)   # bench.py:207
PHYSICS_STEPS = 64  # bench.py's REP
# The lattice with warm start: the solver's accumulated mode, 4 iterations
# of one substep each.
WARM_CFG = dataclasses.replace(PHYSICS_CFG, warm_start=True, solver_iters=4, solver_substeps=1)
# Compound bodies at the default configuration, the bench's hull size.
PAIRED_CFG = PhysicsConfig(max_hull_verts=8)
# A lattice beyond the exact sweep's pool limit (MAX_EXACT_NP = 65,536).
LARGE_LATTICE_N = 66_000


# Every PhysicsConfig route beside the kernel route, as field changes of the
# lattice's configuration: the XLA formulations the JAX package takes when
# a switch is off, the Morton window beyond 2·window (K = 8 > 6) and the
# uniform-grid broadphase. "all_off" turns the three switches off together.
ROUTES = {
    "xla_narrowphase": dict(pallas_narrowphase=False),
    "unfused_prep": dict(fused_prep=False),
    "xla_broadphase": dict(pallas_broadphase=False),
    "sorted_k_beyond_two_windows": dict(broadphase="sorted", broadphase_window=3),
    "grid": dict(broadphase="grid"),
    "all_off": dict(pallas_narrowphase=False, fused_prep=False, pallas_broadphase=False),
}


def route_cfg(name: str, base: PhysicsConfig = PHYSICS_CFG) -> PhysicsConfig:
    """``base`` with the field changes of ``ROUTES[name]``."""
    return dataclasses.replace(base, **ROUTES[name])


def lattice_offsets(n: int) -> np.ndarray:
    """bench.py's lattice: n unit-cube slots on a side³ grid at spacing 1.02,
    offset (-side/2, -1.45, -side/2); float64 as numpy computes it."""
    side = int(round(n ** (1 / 3)))
    while side * side * side < n:
        side += 1
    idx = np.arange(side ** 3)[:n]
    xs = np.stack([idx % side, (idx // side) % side, idx // (side * side)], axis=1)
    return xs.astype(np.float32) * 1.02 + np.array([-side / 2, -1.45 + 0.0, -side / 2])


def cube_pieces(offsets, device=None, group=None) -> PieceSet:
    """One unit cube (F = 8, S = 8) per offset, each its own group unless
    ``group`` (one body index per cube) binds them."""
    n = len(offsets)
    cube = unit_cube(F=8, S=8, device=device)
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.float32, device=device)
    fv = cube.face_verts[None] + off[:, None, None, :]
    n_pl = cube.planes[None, :, :3].expand(n, -1, -1)
    d = cube.planes[None, :, 3:4] - torch.sum(n_pl * off[:, None, :], -1, keepdim=True)
    conv = ConvexPoly(fv, cube.n_verts[None].expand(n, -1).contiguous(),
                      torch.cat([n_pl, d], -1))
    return PieceSet(
        convex=conv,
        mesh=torch.zeros((n, 1, 3, 3), device=device),
        mesh_valid=torch.zeros((n, 1), dtype=torch.bool, device=device),
        valid=torch.ones((n,), dtype=torch.bool, device=device),
        group=(torch.arange(n, dtype=torch.int32, device=device) if group is None
               else torch.as_tensor(np.asarray(group), dtype=torch.int32, device=device)),
        tag=torch.full((n,), -1, dtype=torch.int32, device=device),
    )


def physics_lattice(n: int = 10_000, device="cuda", cfg: PhysicsConfig = PHYSICS_CFG):
    """The bench's fully shattered lattice as a scene on ``device``: every
    cube its own body, all at rest."""
    return build_scene(cube_pieces(lattice_offsets(n), device), cfg, max_bodies=n)


def paired_lattice(n: int = 10_000, device="cuda", cfg: PhysicsConfig = PAIRED_CFG):
    """The lattice with cubes 2i and 2i + 1 bound into one body (n / 2
    two-cube compound bodies), at rest."""
    group = np.arange(n) // 2
    return build_scene(cube_pieces(lattice_offsets(n), device, group), cfg,
                       max_bodies=int(group[-1]) + 1)


def run_physics(steps: int = PHYSICS_STEPS, device="cuda", n: int = 10_000,
                cfg: PhysicsConfig = PHYSICS_CFG, on_step=None):
    """Build the lattice and step it ``steps`` times; ``on_step(i, scene)``
    sees the scene after each step. Returns the last scene."""
    scene = physics_lattice(n, device, cfg)
    for i in range(steps):
        scene = physics_step(scene, cfg)
        if on_step is not None:
            on_step(i, scene)
    return scene


INTERACTIVE_CFG = SceneConfig(   # bench.py:382-395
    fracture=FractureConfig(
        initial_decompose_cell_cnt=64,
        max_pieces=256,
        max_active_pieces=32,
        max_piece_tris=64,
        max_mesh_tris=512,
        partial_pattern_cell_cnt=128,
        general_pattern_cell_cnt=64,
        voronoi_neighbors=48,
    ),
    physics=PhysicsConfig(),
    render=RenderConfig(width=512, height=512, shadow_size=512),
)
FRAME_RAY = ((0.0, 10.0, 0.0), (0.0, -1.0, 0.0))   # bench.py:402-403
FRAME_EYE = (8.0, 6.0, 8.0)                         # bench.py:404-405
FRAME_TARGET = (0.0, 1.0, 0.0)
FRAME_SPAWN = (0.0, 5.0, 0.0)                       # Scene's default spawn
FRAMES = 16                                         # bench.py's REP


def interactive_scene(device="cuda"):
    """``Scene("cube", INTERACTIVE_CFG)`` on ``device``; its ``cfg`` is the
    one the frames run (the convex-model dispatch turns ``exact_caps`` off)."""
    from surtr_tpu_torch.scene import Scene

    return Scene("cube", INTERACTIVE_CFG, spawn=FRAME_SPAWN, device=device)


# A ray down onto each concave model at the Scene's default spawn (0, 5, 0):
# through the torus's tube (its hole is at the axis), through the blob's top.
CONCAVE_RAYS = {"torus": ((1.2, 10.0, 0.0), (0.0, -1.0, 0.0)),
                "blob": ((0.0, 10.0, 0.0), (0.0, -1.0, 0.0))}


def concave_scene(model: str = CONCAVE_MODEL, device="cuda"):
    """``Scene(model)`` at the default ``SceneConfig`` on ``device`` (a
    concave model keeps exact caps); ``CONCAVE_RAYS[model]`` is its impact
    ray for ``fire_impact``."""
    from surtr_tpu_torch.scene import Scene

    return Scene(model, device=device)


def scene_to(scene, device):
    """A copy of a ``Scene`` on ``device`` (pieces, context, bodies, x0),
    so that runs on two devices can start from the same bits."""
    from surtr_tpu_torch.scene import Scene

    out = Scene.__new__(Scene)
    out.__dict__.update(scene.__dict__)
    out.device = torch.device(device)
    for name in ("pieces", "ctx", "phys", "_x0"):
        setattr(out, name, to_device(getattr(scene, name), device))
    out.events = list(scene.events)
    return out


def run_frames(scene, n: int = FRAMES, on_frame=None):
    """``n`` chained ``interactive_frame`` calls with the bench's ray and
    camera; ``on_frame(i, scene, image, metrics)`` sees each frame. Returns
    the last (image, metrics)."""
    out = None
    for i in range(n):
        out = scene.interactive_frame(*FRAME_RAY, eye=FRAME_EYE, target=FRAME_TARGET)
        if on_frame is not None:
            on_frame(i, scene, *out)
    return out


RENDER_512_TRIS = 4096   # bench_render's triangles (bench.py:343-351)


def render_512_inputs(device="cuda"):
    """bench_render's frame (bench.py:343-351): 4,096 triangles from
    ``np.random.default_rng(0)``, gray, seen from (8, 6, 8); returns the
    arguments of ``render_scene`` before W, H and the shadow size."""
    from surtr_tpu_torch.render.camera import camera_view_proj, light_view_proj

    rng = np.random.default_rng(0)
    T = RENDER_512_TRIS
    centers = rng.uniform(-4, 4, (T, 1, 3)).astype(np.float32)
    tris = torch.as_tensor(centers + rng.normal(0, 0.3, (T, 3, 3)).astype(np.float32),
                           device=device)
    valid = torch.ones((T,), dtype=torch.bool, device=device)
    colors = torch.full((T, 3), 0.5, device=device)
    cam = camera_view_proj((8, 6, 8), (0, 0, 0), 45, 1.0, 0.1, 100)
    ldir = (-0.4, -1.0, -0.3)
    return tris, valid, colors, cam, light_view_proj(ldir, (0, 0, 0), 8.0), ldir


def run_render_512(device="cuda", shadow: int = 512, inputs=None):
    """One bench_render frame at 512² with a ``shadow``² shadow map."""
    from surtr_tpu_torch.render.raster import render_scene

    inputs = render_512_inputs(device) if inputs is None else inputs
    return render_scene(*inputs, W=512, H=512, shadow_size=shadow)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, which
    every time measured on it is reported beside."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    out = smi.stdout.strip()
    return out.splitlines()[0] if smi.returncode == 0 and out else "unknown"
