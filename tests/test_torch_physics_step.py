"""The slice whole: the port's ``physics_step`` (every kernel's plain version
on CPU tensors) against the JAX package's ``physics_step`` on its fast path
(``transform_pack`` → exact broadphase → raw narrowphase → fused prep and
solver, the Pallas kernels in interpret mode), from the same scene, over 30
steps; and every configuration off the slice raising ``NotImplementedError``.

Tolerances: x within 2e-4 and v within 2e-3 after 30 steps, the JAX suite's
own bounds for its fast path against its XLA path
(tests/test_physics.py:480-485): the two sides round a few reductions in
different orders (XLA may also contract products into FMAs), and a settling
pile amplifies last-bit differences once contacts begin.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.physics.step import physics_step as j_physics_step
from surtr_tpu_torch import convert, workload
from surtr_tpu_torch.physics.scene import build_scene
from surtr_tpu_torch.physics.step import physics_step

from test_torch_pack import j_cube_pieces

FORCED = dict(pallas_narrowphase=True, force_pallas_narrowphase=True, force_pallas_solver=True,
              fused_prep=True)
SCENES = {
    # bench.py's lattice, 27 cubes, broadphase "exact" as in the port's workload.
    "lattice27": (workload.lattice_offsets(27),
                  JPhysicsConfig(single_piece_bodies=True, max_hull_verts=8, broadphase="exact")),
    # The settling pile of tests/test_physics.py:454-456; "auto" maps to the
    # exact sweep for a pool this small.
    "pile6": ([[0, -1.45 + 1.02 * i, 0] for i in range(4)] + [[1.2, -1.45, 0.0], [1.2, -0.4, 0.0]],
              JPhysicsConfig(broadphase_block=64, single_piece_bodies=True, max_hull_verts=8)),
}
STEPS = 30


@pytest.fixture(scope="module", params=list(SCENES))
def trajectories(request):
    offsets, base = SCENES[request.param]
    jcfg = dataclasses.replace(base, **FORCED)
    n = len(offsets)
    js = j_build_scene(j_cube_pieces(np.asarray(offsets, np.float32)), jcfg, max_bodies=n)
    ts = convert.scene_from(js)
    tcfg = convert.physics_config_from(jcfg)
    step = jax.jit(lambda s: j_physics_step(s, jcfg))
    contacts = False
    for _ in range(STEPS):
        js = step(js)
        ts = physics_step(ts, tcfg)
        contacts |= bool((ts.bodies.v[:, 1] > -1e-3).any())
    return js, ts, contacts


def test_physics_step_matches_jax(trajectories):
    js, ts, contacts = trajectories
    assert contacts, "no body was stopped by a contact: the comparison proves little"
    np.testing.assert_allclose(ts.bodies.x.numpy(), np.asarray(js.bodies.x), atol=2e-4)
    np.testing.assert_allclose(ts.bodies.v.numpy(), np.asarray(js.bodies.v), atol=2e-3)
    np.testing.assert_allclose(ts.bodies.q.numpy(), np.asarray(js.bodies.q), atol=2e-4)
    np.testing.assert_array_equal(ts.sleep_frames.numpy(), np.asarray(js.sleep_frames))
    np.testing.assert_array_equal(ts.push_frames.numpy(), np.asarray(js.push_frames))
    assert torch.isfinite(ts.bodies.w).all()


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


def _small_scene(cfg, n=27, max_bodies=None):
    return build_scene(workload.cube_pieces(workload.lattice_offsets(n)), cfg,
                       max_bodies=max_bodies if max_bodies is not None else n)


OFF_SLICE = {
    "auto_beyond_block": (dict(broadphase="auto", broadphase_block=16), {}, "B6"),
    "exact_pallas": (dict(broadphase="exact_pallas"), {}, "B6"),
    "sorted": (dict(broadphase="sorted"), {}, "B12"),
    "grid": (dict(broadphase="grid"), {}, "Leave out"),
    "xla_narrowphase": (dict(pallas_narrowphase=False), {}, "A9"),
    "unfused_prep": (dict(fused_prep=False), {}, "A9"),
    "compound_bodies": (dict(single_piece_bodies=False), {}, "A9"),
    "more_bodies_than_pieces": ({}, dict(max_bodies=30), "A9"),
    "warm_start": (dict(warm_start=True), {}, "A9"),
    "profile_stage": ({}, dict(profile_stage=3), "A14"),
}


@pytest.mark.parametrize("case", list(OFF_SLICE))
def test_off_slice_configurations_raise(case):
    fields, extra, item = OFF_SLICE[case]
    cfg = dataclasses.replace(workload.PHYSICS_CFG, **fields)
    scene = _small_scene(cfg, max_bodies=extra.get("max_bodies"))
    with pytest.raises(NotImplementedError, match=item):
        physics_step(scene, cfg, profile_stage=extra.get("profile_stage", 99))
