"""Every ``PhysicsConfig`` route of the port's ``physics_step`` on the CPU
(plain versions throughout) against the JAX package's.

* The XLA narrowphase (B5's and B7's plain versions, the latter with
  ``divide=True``) on a captured pair table: the JAX package's normal,
  manifold points, values and hits, bit for bit (its ``_fused_prep_solve``
  is replaced in the child by a capture of its inputs); B7's own rounding
  (``divide=False``) is not.
* The uniform-grid sweep and the XLA Morton-window sweep with K > 2·window:
  ``pidx`` and ``pok`` as the JAX package's ``_broadphase_grid`` and
  ``_broadphase_sorted`` give them.
* The port's mirrors of the JAX suite's route checks
  (tests/test_physics.py ``test_pallas_narrowphase_matches_xla``,
  ``test_fused_fast_path_matches_xla_reference``,
  ``test_broadphase_grid_full_recall_on_dense_pile``), within the same
  bounds.
* One scene holding a three-cube stack, the settling pile of
  tests/test_physics.py:454-456 and a sleep-and-wake pair (a cube that
  falls asleep, then a second lands on it), 72 steps under each route of
  ``workload.ROUTES`` and the kernel route, against the JAX package with
  its kernels forced (interpret mode) wherever the port's route runs one.
  Tolerances: the step test's (x 2e-4, v 2e-3, q 2e-4, counters exactly).

The JAX reference runs compiled in child processes with
``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the port; see
``test_torch_prepare.py``). Run as a script (``python
tests/test_torch_routes.py PART OUT.npz``) it is one child.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from surtr_tpu_torch import workload  # noqa: E402
from torch_threads import bounded_threads  # noqa: E402, F401 (autouse)

BASE = dict(single_piece_bodies=True, max_hull_verts=8, broadphase_block=64)
FORCED = dict(force_pallas_narrowphase=True, force_pallas_solver=True,
              force_pallas_broadphase=True)
# The JAX side of each route; "xla_broadphase" and "all_off" shrink the
# block below the scene's 11 pieces, so that "auto" takes the XLA window.
ROUTES = {"kernel": {}, **workload.ROUTES}
ROUTES["xla_broadphase"] = dict(ROUTES["xla_broadphase"], broadphase_block=8)
ROUTES["all_off"] = dict(ROUTES["all_off"], broadphase_block=8)
CHILDREN = {"pairs": (), "routes_a": ("kernel", "xla_narrowphase", "unfused_prep", "grid"),
            "routes_b": ("xla_broadphase", "sorted_k_beyond_two_windows", "all_off")}
# Stacked faces tie on several SAT axes, and which wins turns on the last
# bit of a sum: at x = -6 the JAX package's own AVX-only and AVX2 builds part
# by 5e-3 on this stack within 72 steps. At x = -3 neither tie is that close.
STACK = [[-3.0, -1.45 + 1.02 * i, 0.0] for i in range(3)]
PILE = [[0.0, -1.45 + 1.02 * i, 0.0] for i in range(4)] + [[1.2, -1.45, 0.0], [1.2, -0.4, 0.0]]
WAKE = [[6.0, -1.49, 0.0], [6.0, 0.6, 0.0]]    # the lower cube sleeps, then is struck
SCENE = STACK + PILE + WAKE
STEPS = 72
BOXES = 200


def _offsets_rotated(n=27):
    """An overlapping lattice (spacing 0.816) with random rotations."""
    rng = np.random.default_rng(5)
    offs = workload.lattice_offsets(n) * 0.8
    q = np.zeros((n, 4), np.float32)
    q[:, 0] = 1.0
    return offs, q + 0.35 * rng.standard_normal((n, 4)).astype(np.float32)


def _boxes():
    """Random boxes (centres, lo, hi, owner, valid) for the sweeps: a few
    invalid, two pieces sharing an owner."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-3, 3, (BOXES, 3)).astype(np.float32)
    h = rng.uniform(0.2, 0.6, (BOXES, 3)).astype(np.float32)
    owner = np.arange(BOXES, dtype=np.int32)
    owner[1] = 0
    valid = np.ones(BOXES, bool)
    valid[[7, 50, 123]] = False
    return c, c - h, c + h, owner, valid


def _j_pieces(offsets):
    import jax.numpy as jnp

    from surtr_tpu.fracture.types import PieceSet
    from surtr_tpu.types import ConvexPoly

    tp = workload.cube_pieces(np.asarray(offsets, np.float32))
    return PieceSet(
        convex=ConvexPoly(*(jnp.asarray(getattr(tp.convex, f).numpy())
                            for f in ("face_verts", "n_verts", "planes"))),
        **{f: jnp.asarray(getattr(tp, f).numpy())
           for f in ("mesh", "mesh_valid", "valid", "group", "tag")})


def _save_scene(prefix, scene, res):
    """A JAX scene's fields as numpy arrays under ``prefix``."""
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name == "bodies":
            for g in dataclasses.fields(v):
                res[f"{prefix}/bodies/{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            res[f"{prefix}/{f.name}"] = np.asarray(v)


def _load_scene(prefix, ref):
    """The port's scene from ``_save_scene``'s arrays."""
    from surtr_tpu_torch import convert
    from surtr_tpu_torch.physics.scene import PhysicsScene
    from surtr_tpu_torch.types import RigidState

    d = {f.name: ref[f"{prefix}/{f.name}"] for f in dataclasses.fields(PhysicsScene)
         if f.name != "bodies"}
    d["bodies"] = {g.name: ref[f"{prefix}/bodies/{g.name}"] for g in dataclasses.fields(RigidState)}
    return convert.scene_from(d)


def _jax_reference(part, out_path):
    """Child-process side: one part of the JAX reference, saved to OUT."""
    import jax
    import jax.numpy as jnp

    import surtr_tpu.physics.step as jstep
    from surtr_tpu.config import PhysicsConfig
    from surtr_tpu.physics.rigid import quat_normalize
    from surtr_tpu.physics.scene import build_scene

    res = {}
    if part == "pairs":
        offs, q = _offsets_rotated()
        cfg = PhysicsConfig(**BASE, pallas_narrowphase=False, force_pallas_solver=True)
        js = build_scene(_j_pieces(offs), cfg)
        js = dataclasses.replace(js, bodies=dataclasses.replace(
            js.bodies, q=quat_normalize(jnp.asarray(q))))
        _save_scene("pairs_scene", js, res)

        def capture(scene, cfg, profile_stage, bodies, Np, K, G, M, wverts, wmask, owner,
                    pvalid, pidx, mpts, mvals, mhit, pc_n, on_tpu, np_raw=None):
            return dict(mpts=mpts, mvals=mvals, mhit=mhit, n=pc_n, pidx=pidx)

        jstep._fused_prep_solve = capture
        out = jax.jit(lambda s: jstep._physics_step_body(s, cfg))(js)
        res.update({f"np/{k}": np.asarray(v) for k, v in out.items()})
        args = [jnp.asarray(a) for a in _boxes()]
        res["grid/pidx"], res["grid/pok"] = map(np.asarray, jstep._broadphase_grid(*args, 8, 8))
        res["sorted/pidx"], res["sorted/pok"] = map(
            np.asarray, jstep._broadphase_sorted(*args, 8, 3)[:2])
    else:
        for name in CHILDREN[part]:
            cfg = PhysicsConfig(**{**BASE, **FORCED, **ROUTES[name]})
            s = build_scene(_j_pieces(SCENE), cfg)
            if name == "kernel":
                _save_scene("route_scene", s, res)
            step = jax.jit(lambda s, c=cfg: jstep.physics_step(s, c))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for _ in range(STEPS):
                    s = step(s)
            for k in ("x", "v", "q"):
                res[f"{name}/{k}"] = np.asarray(getattr(s.bodies, k))
            res[f"{name}/sleep_frames"] = np.asarray(s.sleep_frames)
            res[f"{name}/push_frames"] = np.asarray(s.push_frames)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("routes_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
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


def _scene(offsets, cfg):
    """One body per unit cube at ``offsets``, built by the port."""
    from surtr_tpu_torch.physics.scene import build_scene

    return build_scene(workload.cube_pieces(np.asarray(offsets, np.float32)), cfg)


def test_xla_narrowphase_matches_jax_bitwise(jax_ref):
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics import step as tstep
    from surtr_tpu_torch.physics.narrowphase_cuda import narrowphase_reference
    from surtr_tpu_torch.physics.pack_cuda import transform_pack_owned_reference

    cfg = PhysicsConfig(**BASE, pallas_narrowphase=False)
    sc = _load_scene("pairs_scene", jax_ref)
    packed, aabb = transform_pack_owned_reference(
        sc.piece_verts, sc.piece_vmask, sc.piece_planes, sc.piece_pmask, sc.piece_edges,
        sc.piece_emask, sc.piece_owner, sc.piece_valid, sc.bodies.q, sc.bodies.x,
        cfg.contact_slop * 4.0)
    pvalid = sc.piece_valid & (sc.piece_owner >= 0)
    pidx, pok = tstep._broadphase("exact", cfg, aabb[:, 6:9], aabb[:, 0:3], aabb[:, 3:6],
                                  sc.piece_owner, pvalid)
    np.testing.assert_array_equal(pidx.numpy(), jax_ref["np/pidx"])
    M = cfg.manifold_points
    args = (packed, pidx, pok, 8, 8, cfg.max_edge_dirs, M, cfg.contact_slop)
    raw = narrowphase_reference(*args, divide=True)
    assert not torch.equal(narrowphase_reference(*args)[..., 0:3], raw[..., 0:3])
    rows = lambda r: raw[..., r::6][..., :M].numpy()  # noqa: E731
    np.testing.assert_array_equal(raw[..., 0:3].numpy(), jax_ref["np/n"])
    np.testing.assert_array_equal(rows(5), jax_ref["np/mvals"])
    np.testing.assert_array_equal(rows(6) > 0.5, jax_ref["np/mhit"])
    np.testing.assert_array_equal(np.stack([rows(7), rows(8), rows(9)], -1), jax_ref["np/mpts"])
    hits = rows(6) > 0.5
    assert hits.sum() > 100
    fallback = (rows(10)[..., 0] > 2 * 8) & hits[..., 0]
    assert fallback.any(), "no pair took the support-point fallback"


@pytest.mark.parametrize("sweep", ["grid", "sorted"])
def test_sweep_matches_jax(jax_ref, sweep):
    from surtr_tpu_torch.physics.broadphase import grid_sweep, morton_window_sweep

    args = [torch.as_tensor(a) for a in _boxes()]
    if sweep == "grid":
        pidx, pok = grid_sweep(*args, 8, 8)
    else:
        pidx, pok = morton_window_sweep(*args, 8, 3)     # K = 8 > 2·window = 6
    want_p, want_ok = jax_ref[f"{sweep}/pidx"], jax_ref[f"{sweep}/pok"]
    np.testing.assert_array_equal(pok.numpy(), want_ok)
    got_p = pidx.numpy()
    for i in range(len(got_p)):
        assert set(got_p[i][want_ok[i]]) == set(want_p[i][want_ok[i]]), i
    np.testing.assert_array_equal(got_p, want_p)
    assert want_ok.sum() > 100


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(jax_ref, route):
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.step import physics_step

    cfg = PhysicsConfig(**{**BASE, **ROUTES[route]})
    s = _load_scene("route_scene", jax_ref)
    slept = woke = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(STEPS):
            s = physics_step(s, cfg)
            lower = int(s.sleep_frames[9])
            slept |= lower >= cfg.sleep_frames
            woke |= slept and lower == 0
    assert slept and woke, "the lower cube of the pair did not sleep, then wake"
    r = lambda k: jax_ref[f"{route}/{k}"]  # noqa: E731
    np.testing.assert_allclose(s.bodies.x.numpy(), r("x"), atol=2e-4)
    np.testing.assert_allclose(s.bodies.v.numpy(), r("v"), atol=2e-3)
    np.testing.assert_allclose(s.bodies.q.numpy(), r("q"), atol=2e-4)
    np.testing.assert_array_equal(s.sleep_frames.numpy(), r("sleep_frames"))
    np.testing.assert_array_equal(s.push_frames.numpy(), r("push_frames"))
    assert torch.isfinite(s.bodies.w).all()


def test_kernel_narrowphase_route_matches_xla_route():
    """Mirror of test_pallas_narrowphase_matches_xla: single steps from
    random strongly rotated overlapping states (compound-body path), B7's
    plain version against the XLA narrowphase, v and w within 1e-5."""
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.rigid import quat_normalize
    from surtr_tpu_torch.physics.step import physics_step

    base = PhysicsConfig(broadphase_block=64, max_hull_verts=16, pallas_narrowphase=False)
    kern = dataclasses.replace(base, pallas_narrowphase=True)
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        offs = torch.cat([torch.rand((3, 3), generator=g) * 1.2 - 0.6
                          + torch.tensor([0.0, -0.8, 0.0]), torch.tensor([[5.0, -1.45, 0.0]])])
        s = _scene(offs.numpy(), base)
        q = quat_normalize(s.bodies.q + 0.35 * torch.randn((4, 4), generator=g))
        v = 0.5 * torch.randn((4, 3), generator=g)
        s = dataclasses.replace(s, bodies=dataclasses.replace(s.bodies, q=q, v=v))
        sx, sk = physics_step(s, base), physics_step(s, kern)
        np.testing.assert_allclose(sk.bodies.v.numpy(), sx.bodies.v.numpy(), atol=1e-5,
                                   err_msg=f"seed {seed}")
        np.testing.assert_allclose(sk.bodies.w.numpy(), sx.bodies.w.numpy(), atol=1e-5,
                                   err_msg=f"seed {seed}")


def test_fused_fast_route_matches_xla_route():
    """Mirror of test_fused_fast_path_matches_xla_reference: the kernel
    route (B5 → B7 → B8 → B9) against the XLA narrowphase with the
    unfused prep, 30 steps on the settling pile, x within 2e-4, v 2e-3."""
    from surtr_tpu_torch.config import PhysicsConfig
    from surtr_tpu_torch.physics.step import physics_step

    fast = PhysicsConfig(broadphase_block=64, single_piece_bodies=True, max_hull_verts=16)
    ref = dataclasses.replace(fast, pallas_narrowphase=False, fused_prep=False)
    a, b = _scene(PILE, fast), _scene(PILE, ref)
    for _ in range(30):
        a, b = physics_step(a, fast), physics_step(b, ref)
    np.testing.assert_allclose(a.bodies.x.numpy(), b.bodies.x.numpy(), atol=2e-4)
    np.testing.assert_allclose(a.bodies.v.numpy(), b.bodies.v.numpy(), atol=2e-3)


def test_grid_full_recall_on_dense_pile():
    """Mirror of test_broadphase_grid_full_recall_on_dense_pile: the grid
    sweep finds all but at most 2% of the exact sweep's pairs on a dense
    jittered 6³ pile."""
    from surtr_tpu_torch.physics.broadphase import block_sweep, grid_sweep

    rng = np.random.RandomState(11)
    side = 6
    n = side ** 3
    idx = np.arange(n)
    xs = np.stack([idx % side, (idx // side) % side, idx // side ** 2], 1).astype(np.float32)
    c = torch.as_tensor(xs * 1.05 + rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32))
    owner = torch.arange(n, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    args = (c, c - 0.55, c + 0.55, owner, valid)

    def pairs(pi, ok):
        i, k = np.nonzero(ok.numpy())
        j = pi.numpy()[i, k]
        return set(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))

    se = pairs(*block_sweep(*args, 8, 512))
    sg = pairs(*grid_sweep(*args, 8, 8))
    assert len(se) > 500
    assert len(se - sg) / len(se) <= 0.02


def test_auto_without_kernel_broadphase_warns_and_takes_the_window():
    from surtr_tpu_torch.physics import step as tstep

    cfg = workload.route_cfg("xla_broadphase")
    with pytest.warns(tstep.RecallDegradedWarning, match="pallas_broadphase=False"):
        assert tstep._broadphase_mode(dataclasses.replace(cfg, broadphase_block=8), 27) \
            == "sorted_xla"
    assert tstep._broadphase_mode(cfg, 27) == "exact"
    assert tstep._broadphase_mode(workload.route_cfg("sorted_k_beyond_two_windows"), 27) \
        == "sorted_xla"
    assert tstep._broadphase_mode(workload.PHYSICS_CFG, 10_000) == "exact_pallas"


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
