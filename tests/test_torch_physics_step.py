"""The slice whole: the port's ``physics_step`` (every kernel's plain version
on CPU tensors) against the JAX package's ``physics_step``, from the same
scene, over 30 steps; and the routes the port once left out (the XLA
formulations, the grid broadphase, the window beyond 2·window and the
stage truncation) against the JAX package's same routes.

The JAX side runs its kernel paths in interpret mode where the port runs
kernels: single-piece bodies on the fast path (``transform_pack`` →
broadphase → raw narrowphase → fused prep and solver; the exact block sweep,
the sweep-and-prune B6 with ``force_pallas_broadphase``, or the Morton
window B12; warm start with the solver's accumulated mode); compound
bodies on the JAX suite's default configuration (tests/test_physics.py:17),
whose XLA narrowphase and solver compute what the port's B7 and plain
``_assemble_and_solve`` compute.

Tolerances: x within 2e-4, v within 2e-3 and q within 2e-4 after 30 steps,
the JAX suite's own bounds for its fast path against its XLA path
(tests/test_physics.py:480-485): the two sides round a few reductions in
different orders (XLA may also contract products into FMAs), and a settling
pile amplifies last-bit differences once contacts begin. Sleep and push
counters exactly. Warm start: the warm pairs and feature ids exactly, the
accumulated impulses within 2e-3 (impulses of the same scale as v).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.fracture.types import PieceSet as JPieceSet
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.physics.step import physics_step as j_physics_step
from surtr_tpu.types import ConvexPoly as JConvexPoly
from surtr_tpu_torch import convert, workload
from surtr_tpu_torch.physics.step import physics_step
from torch_threads import bounded_threads  # noqa: F401 (autouse)

FORCED = dict(pallas_narrowphase=True, force_pallas_narrowphase=True, force_pallas_solver=True,
              fused_prep=True)
LATTICE = JPhysicsConfig(single_piece_bodies=True, max_hull_verts=8)
# The JAX suite's default-path configuration (tests/test_physics.py:17).
PCFG = JPhysicsConfig(broadphase_block=64, max_hull_verts=16)
PILE = [[0, -1.45 + 1.02 * i, 0] for i in range(4)] + [[1.2, -1.45, 0.0], [1.2, -0.4, 0.0]]
# name: (offsets, body per piece or None, max_bodies or None, JAX config, contact expected
#        [, dead pieces])
SCENES = {
    # bench.py's lattice, 27 cubes, the exact block sweep.
    "lattice27": (workload.lattice_offsets(27), None, None,
                  dataclasses.replace(LATTICE, broadphase="exact", **FORCED), True),
    # "auto" past broadphase_block: the sweep-and-prune B6.
    "lattice27_auto": (workload.lattice_offsets(27), None, None,
                       dataclasses.replace(LATTICE, broadphase_block=16,
                                           force_pallas_broadphase=True, **FORCED), True),
    # B6 on a pool whose last piece is dead: every empty slot names it.
    "pile7_dead_last_auto": (PILE + [[4.0, 3.0, 0.0]], None, None,
                             dataclasses.replace(LATTICE, broadphase_block=4,
                                                 force_pallas_broadphase=True, **FORCED),
                             True, (6,)),
    # The Morton window B12.
    "lattice27_sorted": (workload.lattice_offsets(27), None, None,
                         dataclasses.replace(LATTICE, broadphase="sorted",
                                             force_pallas_broadphase=True, **FORCED), True),
    # The settling pile of tests/test_physics.py:454-456; "auto" maps to the
    # exact sweep for a pool this small.
    "pile6": (PILE, None, None,
              dataclasses.replace(LATTICE, broadphase_block=64, **FORCED), True),
    # The same pile with warm start: the solver's accumulated mode.
    "pile6_warm": (PILE, None, None,
                   dataclasses.replace(LATTICE, broadphase_block=64, warm_start=True,
                                       solver_iters=4, solver_substeps=1, **FORCED), True),
    # Compound bodies: the two-piece compound of tests/test_physics.py:76-87
    # (free fall), a six-piece pile in three bodies, 27 cubes bound in pairs
    # with idle body slots.
    "compound2": ([[0, 5, 0], [1, 5, 0]], [0, 0], None, PCFG, False),
    "pile6_in_three": (PILE, [0, 0, 1, 1, 2, 2], 3, PCFG, True),
    "lattice27_pairs": (workload.lattice_offsets(27), np.arange(27) // 2, 30, PCFG, True),
}
STEPS = 30


def _j_pieces(offsets, group, dead=()):
    """The JAX package's PieceSet of ``workload.cube_pieces``, the pieces
    ``dead`` invalid."""
    tp = workload.cube_pieces(np.asarray(offsets, np.float32), group=group)
    tp.valid[list(dead)] = False
    return JPieceSet(
        convex=JConvexPoly(*(jnp.asarray(getattr(tp.convex, f).numpy())
                             for f in ("face_verts", "n_verts", "planes"))),
        **{f: jnp.asarray(getattr(tp, f).numpy())
           for f in ("mesh", "mesh_valid", "valid", "group", "tag")})


@pytest.fixture(scope="module", params=list(SCENES))
def trajectories(request):
    offsets, group, max_bodies, jcfg, expect_contact, *dead = SCENES[request.param]
    n = len(offsets)
    js = j_build_scene(_j_pieces(offsets, group, *dead), jcfg,
                       max_bodies=max_bodies if max_bodies is not None else n)
    ts = convert.scene_from(js)
    tcfg = convert.physics_config_from(jcfg)
    step = jax.jit(lambda s: j_physics_step(s, jcfg))
    contacts = False
    for _ in range(STEPS):
        js = step(js)
        ts = physics_step(ts, tcfg)
        act = ts.bodies.active
        contacts |= bool((ts.bodies.v[act, 1] > -1e-3).any())
    assert contacts == expect_contact, "contact expected" if expect_contact else "free fall"
    return js, ts, tcfg


def test_physics_step_matches_jax(trajectories):
    js, ts, _ = trajectories
    np.testing.assert_allclose(ts.bodies.x.numpy(), np.asarray(js.bodies.x), atol=2e-4)
    np.testing.assert_allclose(ts.bodies.v.numpy(), np.asarray(js.bodies.v), atol=2e-3)
    np.testing.assert_allclose(ts.bodies.q.numpy(), np.asarray(js.bodies.q), atol=2e-4)
    np.testing.assert_array_equal(ts.sleep_frames.numpy(), np.asarray(js.sleep_frames))
    np.testing.assert_array_equal(ts.push_frames.numpy(), np.asarray(js.push_frames))
    assert torch.isfinite(ts.bodies.w).all()


def test_warm_state_matches_jax(trajectories):
    js, ts, tcfg = trajectories
    np.testing.assert_array_equal(ts.warm_pair.numpy(), np.asarray(js.warm_pair))
    np.testing.assert_array_equal(ts.warm_fid.numpy(), np.asarray(js.warm_fid))
    np.testing.assert_allclose(ts.warm_lam.numpy(), np.asarray(js.warm_lam), atol=2e-3)
    if tcfg.warm_start:
        assert np.abs(ts.warm_lam.numpy()).max() > 1e-3, "no impulse was carried"


def test_run_physics_steps_the_bench_lattice():
    seen = []
    s = workload.run_physics(steps=3, device="cpu", n=27, on_step=lambda i, sc: seen.append(i))
    assert seen == [0, 1, 2]
    assert torch.isfinite(s.bodies.x).all()
    start = workload.physics_lattice(27, "cpu")
    # Free fall, no contact yet: 3 symplectic steps of gravity.
    dt, g = workload.PHYSICS_CFG.dt, workload.PHYSICS_CFG.gravity
    np.testing.assert_allclose((s.bodies.x - start.bodies.x)[:, 1].numpy(), g * dt * dt * 6, rtol=1e-4)


def test_all_asleep_scene_is_returned_unchanged():
    cfg = workload.PHYSICS_CFG
    s = workload.physics_lattice(8, "cpu")
    s = dataclasses.replace(s, sleep_frames=torch.full_like(s.sleep_frames, cfg.sleep_frames))
    assert physics_step(s, cfg) is s


# The routes that raised before the port had them: each now runs, from the
# settling pile pressed into the ground and into itself by 0.005 (ground
# and pair contacts from the first step, one least-penetration axis per
# pair), and gives the JAX package's state for the same route (its kernels
# forced where the port's route runs one) after two steps; profile_stage=2
# truncates both after the broadphase (at 3 the fast route's fence sums
# the pair records' -BIG fillers, which overflow float32 on both sides).
ROUTE_CASES = {
    "grid": (dict(broadphase="grid"), {}),
    "xla_narrowphase": (dict(pallas_narrowphase=False), {}),
    "unfused_prep": (dict(fused_prep=False), {}),
    "xla_broadphase": (dict(pallas_broadphase=False, broadphase_block=4), {}),
    "sorted_k_beyond_two_windows": (dict(broadphase="sorted", broadphase_window=3), {}),
    "profile_stage": ({}, dict(profile_stage=2)),
}
PRESSED = ([[0.0, -1.505 + 0.995 * i, 0.0] for i in range(4)]
           + [[0.995, -1.505, 0.0], [0.995, -0.51, 0.0]])


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_off_slice_configurations_raise(case):
    """(Named for what it checked before the routes were ported.)"""
    fields, extra = ROUTE_CASES[case]
    stage = extra.get("profile_stage", 99)
    jcfg = dataclasses.replace(LATTICE, **{**FORCED, "force_pallas_broadphase": True, **fields})
    js = j_build_scene(_j_pieces(PRESSED, None), jcfg, max_bodies=len(PRESSED))
    ts = convert.scene_from(js)
    tcfg = convert.physics_config_from(jcfg)
    step = jax.jit(lambda s: j_physics_step(s, jcfg, profile_stage=stage))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(1 if stage < 99 else 2):
            js = step(js)
            ts = physics_step(ts, tcfg, profile_stage=stage)
    for k in ("x", "v", "w", "q"):
        assert torch.isfinite(getattr(ts.bodies, k)).all(), k
    np.testing.assert_allclose(ts.bodies.x.numpy(), np.asarray(js.bodies.x), atol=2e-4)
    np.testing.assert_allclose(ts.bodies.v.numpy(), np.asarray(js.bodies.v), atol=2e-3)
    np.testing.assert_allclose(ts.bodies.q.numpy(), np.asarray(js.bodies.q), atol=2e-4)
    np.testing.assert_array_equal(ts.sleep_frames.numpy(), np.asarray(js.sleep_frames))
    if stage == 99:
        assert float(torch.abs(ts.bodies.v[:, 1]).max()) > 0.0
