"""Stage truncation (``profile_stage``) and the phase timer of the port on the
CPU: the fence a truncated ``prepare_fracture``, ``do_fracture`` or
``physics_step`` returns, against the JAX package's at the same stage,
within rtol 1e-5 (the port sums in float64 and rounds once; the JAX package
sums in float32 in XLA's order); and ``PhaseTimer`` and ``trace``.

* ``prepare_fracture`` on the sphere at 16 cells and 64 triangles a piece
  (a per-cell pool of 256 < 320 triangles: the culled pair-pool mesh clip,
  where stages 42-44 sit), from the JAX package's seeds: stages 1-7, the
  pooled fold (44) and the refit planes (46, where both sides' sums
  overflow float32);
* ``do_fracture``'s partial event on a JAX-prepared cube
  (tests/test_torch_fracture.py's configuration at 8 cells): stages 1-5;
* ``physics_step`` on a rotated overlapping lattice of compound bodies on
  the JAX package's CPU route (its XLA formulations, the port's
  ``pallas_narrowphase=False``): stages 1, 2, 3, 35 and 4. The truncated
  step returns ``bodies.x + Σ·1e-30``; with every body at x = 0 (the hulls
  shifted into the body frame, so the world geometry stays) that is the
  fence itself;
* ``physics_step`` on the kernel route (single-piece bodies, B5 → B7 → B8
  against the JAX package's kernels forced in interpret mode) on a rotated
  overlapping lattice: stages 1, 3 and 35, each stage's arrays
  (``stage_arrays``; the JAX side's are captured by replacing its
  ``_stage_out`` in the child) against the JAX package's, and their fences.
  Stage 3's fence is -inf on both sides (B7's unfilled points hold -BIG), so
  there the records themselves decide.

The JAX reference runs compiled in child processes with
``--xla_cpu_max_isa=AVX`` (see ``test_torch_prepare.py``); run as a script
(``python tests/test_torch_profiling.py PART OUT.npz``) it is one child.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PREPARE_CFG = dict(max_faces=26, max_face_verts=16, voronoi_prefix=8, partial_pattern_cell_cnt=8,
                   general_pattern_cell_cnt=8, initial_decompose_cell_cnt=16, max_pieces=16,
                   max_piece_tris=64, voronoi_neighbors=15)
FRACTURE_CFG = dict(initial_decompose_cell_cnt=8, max_pieces=64, max_faces=32, max_face_verts=16,
                    max_piece_tris=128, max_active_pieces=8, partial_pattern_cell_cnt=32,
                    general_pattern_cell_cnt=16, voronoi_neighbors=7, exact_caps=False)
IMPACT = (1.5, 1.5, 1.5)
KEY = 46354
CHILDREN = {"prepare_a": ("prepare", (1, 2, 3, 4, 44, 5)),
            "prepare_b": ("prepare", (6, 46, 7)),
            "fracture": ("fracture", (1, 2, 3, 4, 5)),
            "physics": ("physics", (1, 2, 3, 35, 4)),
            "physics_kernel": ("physics_kernel", (1, 3, 35))}
PHYSICS_CFG = dict(broadphase_block=64, max_hull_verts=16)
KERNEL_CFG = dict(single_piece_bodies=True, max_hull_verts=8, broadphase_block=64)


def _jax_reference(part, out_path):
    """Child-process side: one part's fences."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig, PhysicsConfig
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.fracture.pipeline import do_fracture, prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    kind, stages = CHILDREN[part]
    res = {}
    cloud = jnp.asarray(sphere_point_cloud())
    if kind == "prepare":
        cfg = FractureConfig(**PREPARE_CFG)
        v, f = get_model("sphere")
        key = jax.random.PRNGKey(KEY)
        args = (jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]),
                jnp.ones(len(f), bool), cloud, key)
        for st in stages:
            res[f"prepare/{st}"] = np.asarray(prepare_fracture(*args, cfg, profile_stage=st)[0])
        k0, k1, k2 = jax.random.split(key, 3)
        res["seeds"] = np.asarray(uniform_seeds(k0, cfg.initial_decompose_cell_cnt))
        res["pseeds"] = np.asarray(
            radial_seeds(k1, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist))
        res["gseeds"] = np.asarray(
            radial_seeds(k2, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist))
    elif kind == "fracture":
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from test_torch_fracture import _flatten

        cfg = FractureConfig(**FRACTURE_CFG)
        v, f = get_model("cube")
        pieces, ctx, _ = prepare_fracture(
            jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]), jnp.ones(len(f), bool),
            cloud, jax.random.PRNGKey(cfg.seed), cfg)
        _flatten("in/pieces", pieces, res)
        _flatten("in/ctx", ctx, res)
        for st in stages:
            res[f"fracture/{st}"] = np.asarray(do_fracture(
                pieces, ctx, jnp.asarray(IMPACT, jnp.float32), 0, cfg, partial=True,
                profile_stage=st)[0])
    elif kind == "physics_kernel":
        import surtr_tpu.physics.step as jstep
        from surtr_tpu.physics.rigid import quat_normalize
        from surtr_tpu.physics.scene import build_scene
        from test_torch_routes import _j_pieces, _offsets_rotated, _save_scene

        cfg = PhysicsConfig(**KERNEL_CFG, force_pallas_narrowphase=True,
                            force_pallas_solver=True)
        offs, q = _offsets_rotated()
        scene = build_scene(_j_pieces(offs), cfg)
        scene = dataclasses.replace(scene, bodies=dataclasses.replace(
            scene.bodies, q=quat_normalize(jnp.asarray(q))))
        jstep._stage_out = lambda s, *arrays: arrays     # the stage's arrays, not the fence
        for st in stages:
            arrays = jax.jit(lambda s, st=st: jstep.physics_step(s, cfg, profile_stage=st))(scene)
            for i, a in enumerate(arrays):
                res[f"kernel/{st}/{i}"] = np.asarray(a)
        _save_scene("kscene", scene, res)
    else:
        from surtr_tpu.physics.step import physics_step

        cfg = PhysicsConfig(**PHYSICS_CFG)
        scene = _physics_scene()
        for st in stages:
            out = jax.jit(lambda s, st=st: physics_step(s, cfg, profile_stage=st))(scene)
            res[f"physics/{st}"] = np.asarray(out.bodies.x)
        for f_ in dataclasses.fields(scene):
            val = getattr(scene, f_.name)
            if f_.name == "bodies":
                for g in dataclasses.fields(val):
                    res[f"scene/bodies/{g.name}"] = np.asarray(getattr(val, g.name))
            else:
                res[f"scene/{f_.name}"] = np.asarray(val)
    np.savez(out_path, **res)


def _physics_scene():
    """(JAX side) 27 rotated overlapping cubes in 14 bodies, every body at
    x = 0 with its hull and planes shifted by its former position."""
    import jax.numpy as jnp

    from surtr_tpu.config import PhysicsConfig
    from surtr_tpu.physics.rigid import quat_normalize
    from surtr_tpu.physics.scene import build_scene
    from test_torch_routes import _j_pieces

    from surtr_tpu_torch import workload

    offs = workload.lattice_offsets(27) * 0.8
    pieces = _j_pieces(offs)
    pieces = dataclasses.replace(pieces, group=jnp.asarray(np.arange(27) // 2, jnp.int32))
    s = build_scene(pieces, PhysicsConfig(**PHYSICS_CFG), max_bodies=14)
    rng = np.random.default_rng(2)
    q = quat_normalize(s.bodies.q + 0.3 * rng.standard_normal((14, 4)).astype(np.float32))
    x = s.bodies.x[jnp.clip(s.piece_owner, 0, 13)]                       # (Np, 3)
    planes = s.piece_planes.at[..., 3].add(-jnp.sum(s.piece_planes[..., :3] * x[:, None], -1))
    return dataclasses.replace(
        s, bodies=dataclasses.replace(s.bodies, x=jnp.zeros_like(s.bodies.x), q=q),
        piece_verts=jnp.where(s.piece_vmask[..., None], s.piece_verts + x[:, None], 0.0),
        piece_planes=planes)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profiling_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = {part: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), part, str(tmp / f"{part}.npz")], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for part in CHILDREN}
    ref = {}
    try:
        for part, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            ref.update(np.load(tmp / f"{part}.npz"))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref


def _close(got, want):
    got, want = float(got), float(want)
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 44, 5, 6, 46, 7])
def test_prepare_fracture_stage_fence_matches_jax(jax_ref, stage):
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.workload import model_inputs

    seeds = [torch.as_tensor(jax_ref[k]) for k in ("seeds", "pseeds", "gseeds")]
    out = prepare_fracture(*model_inputs("sphere", "cpu"), FractureConfig(**PREPARE_CFG), *seeds,
                           profile_stage=stage)
    assert out[1] is None and out[2] is None and out[0].dim() == 0
    _close(out[0], jax_ref[f"prepare/{stage}"])


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_do_fracture_stage_fence_matches_jax(jax_ref, stage):
    from test_torch_fracture import _unflatten

    from surtr_tpu_torch import convert
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import do_fracture

    pieces = convert.pieces_from(_unflatten(jax_ref, "in/pieces"))
    ctx = convert.context_from(_unflatten(jax_ref, "in/ctx"))
    fence, none = do_fracture(pieces, ctx, IMPACT, 0, FractureConfig(**FRACTURE_CFG),
                              partial=True, profile_stage=stage)
    assert none is None
    _close(fence, jax_ref[f"fracture/{stage}"])


@pytest.mark.parametrize("stage", [1, 2, 3, 35, 4])
def test_physics_step_stage_fence_matches_jax(jax_ref, stage):
    from surtr_tpu_torch import convert
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.scene import PhysicsScene
    from surtr_tpu_torch.physics.step import physics_step
    from surtr_tpu_torch.types import RigidState

    d = {f.name: jax_ref[f"scene/{f.name}"] for f in dataclasses.fields(PhysicsScene)
         if f.name != "bodies"}
    d["bodies"] = {g.name: jax_ref[f"scene/bodies/{g.name}"]
                   for g in dataclasses.fields(RigidState)}
    scene = convert.scene_from(d)
    cfg = PhysicsConfig(**PHYSICS_CFG, pallas_narrowphase=False)
    out = physics_step(scene, cfg, profile_stage=stage)
    want = jax_ref[f"physics/{stage}"]
    assert np.all(want == want[0, 0]) and want[0, 0] != 0
    got = out.bodies.x.numpy()
    assert np.all(got == got[0, 0])
    _close(got[0, 0] / np.float32(1e-30), want[0, 0] / np.float32(1e-30))
    for k in ("v", "w", "q"):
        assert torch.equal(getattr(out.bodies, k), getattr(scene.bodies, k)), k


def _jax_fence(arrays):
    """The JAX package's fence: a float32 sum of float32 sums."""
    s = np.float32(0)
    with np.errstate(over="ignore"):
        for a in arrays:
            s = s + np.sum(a.astype(np.float32), dtype=np.float32)
    return s


@pytest.mark.parametrize("stage", [1, 3, 35])
def test_physics_step_kernel_route_stages_match_jax(jax_ref, stage):
    from test_torch_routes import _load_scene

    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.narrowphase_cuda import live_records, out_rows
    from surtr_tpu_torch.physics.step import stage_arrays
    from surtr_tpu_torch.profiling import fence_sum

    scene = _load_scene("kscene", jax_ref)
    cfg = PhysicsConfig(**KERNEL_CFG)
    got = stage_arrays(scene, cfg, stage)
    raw = [jax_ref[f"kernel/{stage}/{i}"] for i in range(len(got))]
    assert f"kernel/{stage}/{len(got)}" not in jax_ref
    Np, K, M = scene.Np, cfg.max_neighbors, cfg.manifold_points
    if stage == 1:      # the AABB rows; the JAX kernel's are (9, Np)
        want = [raw[0].T]
    elif stage == 3:    # B7's records; the JAX kernel's are (rows padded to 8, K · Np_pad)
        o = raw[0].reshape(raw[0].shape[0], K, -1).transpose(2, 1, 0)
        want = [o[:Np, :, : out_rows(M)]]
    else:               # B8's seven tables; the JAX kernel pads rows and columns
        want = [w[: g.shape[0], : g.shape[1]] for g, w in zip(got, raw)]
    for g, w, r in zip(got, want, raw):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
        if stage == 35:   # the JAX kernel's padding columns hold zeros
            assert not r[: g.shape[0], g.shape[1]:].any()
    # Each fence over the unpadded arrays, within rtol 1e-5.
    _close(fence_sum(*got), _jax_fence(want))
    if stage == 3:
        # B7's unfilled points hold -BIG: the fence is -inf on both sides,
        # so the live records (each point's fields where it hits, the pair's
        # where the pair hits) decide.
        assert float(fence_sum(*got)) == -np.inf
        live = live_records(got[0], M)
        assert (got[0][..., 4] > 0.5).sum() > 50 and torch.isfinite(fence_sum(live))
        _close(fence_sum(live), _jax_fence([live_records(torch.as_tensor(want[0]), M).numpy()]))


def test_every_physics_stage_truncates_on_the_kernel_route():
    """The kernel route (single-piece bodies, B5 → B7 → B8 → B9's plain
    versions) stops at each stage: the bodies keep their velocities and x
    moves only by the fence."""
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.physics.step import physics_step

    cfg = workload.PHYSICS_CFG
    s = workload.physics_lattice(27, "cpu", cfg)
    for stage in (1, 2, 3, 35, 4):
        out = physics_step(s, cfg, profile_stage=stage)
        assert torch.equal(out.bodies.v, s.bodies.v), stage
        assert torch.equal(out.sleep_frames, s.sleep_frames), stage
    full = physics_step(s, cfg)
    assert not torch.equal(full.bodies.v, s.bodies.v)


def test_cap_stages_return_their_fences():
    """``cap_fans_batch`` stops after each of its four candidate stages."""
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture import pipeline
    from surtr_tpu_torch.workload import model_inputs

    seen = {}
    real = pipeline.cap_fans_batch

    def spy(*a, **kw):
        seen.update({st: real(*a, **kw, profile_stage=st) for st in (1, 2, 3, 4)})
        return real(*a, **kw)

    pipeline.cap_fans_batch = spy
    try:
        cfg = FractureConfig(**dict(PREPARE_CFG, initial_decompose_cell_cnt=8, max_pieces=8))
        pipeline.prepare_fracture(*model_inputs("blob", "cpu"), cfg,
                                  generator=torch.Generator().manual_seed(1))
    finally:
        pipeline.cap_fans_batch = real
    assert sorted(seen) == [1, 2, 3, 4]
    for st, v in seen.items():
        assert v.dim() == 0 and v.dtype == torch.float32 and torch.isfinite(v), st


def test_phase_timer_on_the_cpu(tmp_path):
    from surtr_tpu_torch.profiling import PhaseTimer, fence_sum, trace

    t = PhaseTimer()
    for _ in range(3):
        with t.phase("sleep") as h:
            time.sleep(0.01)
            h["out"] = torch.ones(4)
    with t.phase("other"):
        pass
    med = t.medians()
    assert set(med) == {"sleep", "other"} and med["sleep"] >= 10.0
    assert len(t.times["sleep"]) == 3
    lines = t.report().splitlines()
    assert lines[0].startswith("sleep") and "(n=3)" in lines[0]
    out, kernels = trace(lambda a: a * 2, torch.ones(3), path=str(tmp_path / "t.json"))
    assert torch.equal(out, torch.full((3,), 2.0)) and kernels == 0
    assert (tmp_path / "t.json").exists()
    assert float(fence_sum(torch.ones(2, dtype=torch.bool), [torch.full((3,), 0.5)])) == 3.5


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
