"""The port's rigid-body helpers, moments, DOP axes and ``build_scene``
against the JAX package's, on the same numpy inputs.

Tolerances: elementwise formulas 1e-6 absolute on unit-scale inputs (the
two sides may round a three-term sum in another order); masks, owners,
segment starts and the corner dedup exactly (selections and copies: the
dedup of the same face soups gives the same bits); the scene's body-frame
corners, planes and COMs 1e-6 absolute (they are corners minus a COM, and
the COM is a masked sum whose order XLA and PyTorch choose differently, one
ulp apart); inverse inertia rtol 1e-5 (LAPACK against XLA's inversion of
the same 3×3 matrices).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.fracture.types import PieceSet as JPieceSet
from surtr_tpu.ops import kdop as j_kdop
from surtr_tpu.ops import linalg as j_linalg
from surtr_tpu.ops import moments as j_moments
from surtr_tpu.physics import rigid as j_rigid
from surtr_tpu.physics.scene import _dedup_verts as j_dedup_verts
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.types import ConvexPoly as JConvexPoly
from surtr_tpu.types import unit_cube as j_unit_cube
from surtr_tpu_torch import convert, workload
from surtr_tpu_torch.ops import kdop, linalg, moments
from surtr_tpu_torch.physics import rigid
from surtr_tpu_torch.physics.scene import _dedup_verts, build_scene, piece_world_verts
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quaternion_helpers_match():
    rng = np.random.default_rng(3)
    a, b = _quats(rng, 64), _quats(rng, 64)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    I = rng.standard_normal((64, 3, 3)).astype(np.float32)
    I = I @ I.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    raw = 2.0 * rng.standard_normal((64, 4)).astype(np.float32)
    pairs = [
        (rigid.quat_mul(_t(a), _t(b)), j_rigid.quat_mul(jnp.asarray(a), jnp.asarray(b))),
        (rigid.quat_normalize(_t(raw)), j_rigid.quat_normalize(jnp.asarray(raw))),
        (rigid.quat_to_mat(_t(a)), j_rigid.quat_to_mat(jnp.asarray(a))),
        (rigid.quat_integrate(_t(a), _t(w), 1 / 120), j_rigid.quat_integrate(jnp.asarray(a), jnp.asarray(w), 1 / 120)),
        (rigid.rotate(_t(a), _t(v)), j_rigid.rotate(jnp.asarray(a), jnp.asarray(v))),
        (rigid.world_inv_inertia(_t(a), _t(I)), j_rigid.world_inv_inertia(jnp.asarray(a), jnp.asarray(I))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(rigid.quat_identity((5,)).numpy(), np.asarray(j_rigid.quat_identity((5,))))


def test_rot_points_matvec3_and_dop26_match():
    rng = np.random.default_rng(4)
    R = rng.standard_normal((16, 3, 3)).astype(np.float32)
    pts = rng.standard_normal((16, 9, 3)).astype(np.float32)
    vec = rng.standard_normal((16, 3)).astype(np.float32)
    np.testing.assert_allclose(linalg.rot_points(_t(R), _t(pts)).numpy(),
                               np.asarray(j_linalg.rot_points(jnp.asarray(R), jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(linalg.matvec3(_t(R), _t(vec)).numpy(),
                               np.asarray(j_linalg.matvec3(jnp.asarray(R), jnp.asarray(vec))),
                               atol=1e-6)
    np.testing.assert_array_equal(kdop.dop26_directions().numpy(),
                                  np.asarray(j_kdop.dop26_directions()))


def test_sqrt_rn_is_correctly_rounded():
    # The float64 root rounded to float32 equals numpy's IEEE float32 root
    # (PyTorch's vectorized float32 sqrt on the CPU is off by an ulp on
    # some inputs, which the plain versions must not inherit).
    rng = np.random.default_rng(5)
    x = (rng.random(200_000) * 10.0 ** rng.integers(-20, 20, 200_000)).astype(np.float32)
    np.testing.assert_array_equal(linalg.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def _boxes(rng, n, rotate=True):
    """Non-uniform boxes, randomly rotated and translated (numpy ConvexPoly
    fields of the JAX unit cube with F = 8, S = 8)."""
    cube = j_unit_cube(F=8, S=8)
    fv0 = np.asarray(cube.face_verts)
    pl0 = np.asarray(cube.planes)
    fv, pl = [], []
    for _ in range(n):
        s = rng.uniform(0.3, 1.5, 3).astype(np.float32)
        q = _quats(rng, 1) if rotate else np.array([[1, 0, 0, 0]], np.float32)
        R = np.asarray(j_rigid.quat_to_mat(jnp.asarray(q)))[0]
        t = rng.uniform(-3, 3, 3).astype(np.float32)
        f = (fv0 * s) @ R.T + t
        nrm = pl0[:, :3] / s
        nl = np.linalg.norm(nrm, axis=1, keepdims=True)
        nl[nl == 0] = 1
        nrm = (nrm / nl) @ R.T
        d = (pl0[:, 3:4] / nl) - np.sum(nrm * t, axis=1, keepdims=True)
        fv.append(f.astype(np.float32))
        pl.append(np.concatenate([nrm, d], 1).astype(np.float32))
    nv = np.broadcast_to(np.asarray(cube.n_verts), (n, 8)).copy()
    return np.stack(fv), nv, np.stack(pl)


def _piece_sets(fv, nv, pl, group, valid):
    P = len(group)
    j = JPieceSet(
        convex=JConvexPoly(jnp.asarray(fv), jnp.asarray(nv), jnp.asarray(pl)),
        mesh=jnp.zeros((P, 1, 3, 3)), mesh_valid=jnp.zeros((P, 1), bool),
        valid=jnp.asarray(valid), group=jnp.asarray(group, jnp.int32),
        tag=jnp.full((P,), -1, jnp.int32),
    )
    return j, convert.pieces_from(j)


def _same_edge_sets(got, gm, want, wm):
    """Per piece, the chosen edge directions as a set (within 1e-6): on
    rotated boxes the greedy pick between two perpendicular directions is a
    near tie that the two backends may round either way, so only the order
    may differ."""
    for i in range(got.shape[0]):
        a, b = got[i][gm[i]], want[i][wm[i]]
        assert len(a) == len(b), i
        if not len(a):
            continue
        d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
        assert (d.min(1) <= 1e-6).all() and (d.min(0) <= 1e-6).all(), i


def _compare_scenes(got, want, edge_order=True):
    for f in ("piece_owner", "piece_valid", "piece_vmask", "piece_pmask", "piece_emask",
              "seg_start", "sleep_frames", "push_frames", "warm_pair", "warm_fid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.piece_verts.numpy(), np.asarray(want.piece_verts), atol=1e-6)
    np.testing.assert_array_equal(got.bodies.active.numpy(), np.asarray(want.bodies.active))
    np.testing.assert_allclose(got.piece_planes.numpy(), np.asarray(want.piece_planes), atol=1e-6)
    if edge_order:
        np.testing.assert_allclose(got.piece_edges.numpy(), np.asarray(want.piece_edges), atol=1e-6)
    else:
        _same_edge_sets(got.piece_edges.numpy(), got.piece_emask.numpy(),
                        np.asarray(want.piece_edges), np.asarray(want.piece_emask))
    np.testing.assert_allclose(got.bodies.x.numpy(), np.asarray(want.bodies.x), atol=1e-6)
    np.testing.assert_allclose(got.bodies.inv_mass.numpy(), np.asarray(want.bodies.inv_mass), rtol=1e-5)
    np.testing.assert_allclose(got.bodies.inv_inertia_body.numpy(),
                               np.asarray(want.bodies.inv_inertia_body), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vh", [8, 32])
def test_build_scene_bench_lattice(vh):
    """The 27-cube lattice as the bench builds it (bench.py:207-238) against
    the port's ``workload.cube_pieces`` of the same offsets."""
    n = 27
    offsets = workload.lattice_offsets(n)
    jcfg = JPhysicsConfig(single_piece_bodies=True, max_hull_verts=vh)
    cube = j_unit_cube(F=8, S=8)
    conv = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), cube)
    off = jnp.asarray(offsets)
    d = conv.planes[..., 3:4] - jnp.sum(conv.planes[..., :3] * off[:, None, :], -1, keepdims=True)
    conv = JConvexPoly(conv.face_verts + off[:, None, None, :], conv.n_verts,
                       jnp.concatenate([conv.planes[..., :3], d], -1))
    jp = JPieceSet(convex=conv, mesh=jnp.zeros((n, 1, 3, 3)), mesh_valid=jnp.zeros((n, 1), bool),
                   valid=jnp.ones((n,), bool), group=jnp.arange(n, dtype=jnp.int32),
                   tag=jnp.full((n,), -1, jnp.int32))
    want = j_build_scene(jp, jcfg, max_bodies=n)
    got = build_scene(workload.cube_pieces(offsets), convert.physics_config_from(jcfg), max_bodies=n)
    _compare_scenes(got, want)
    assert int(got.piece_vmask.sum(1).min()) == 8   # the dedup finds each cube's 8 corners


def test_build_scene_rotated_boxes_with_compounds():
    """Rotated non-uniform boxes; two compounds of several pieces, a dead
    piece, unsorted groups (exercises the owner sort and segment sums)."""
    rng = np.random.default_rng(6)
    fv, nv, pl = _boxes(rng, 9)
    group = np.array([3, 0, 3, 1, 0, 2, 4, 1, 3], np.int32)
    valid = np.ones(9, bool)
    valid[5] = False
    jp, tp = _piece_sets(fv, nv, pl, group, valid)
    jcfg = JPhysicsConfig(max_hull_verts=16)
    want = j_build_scene(jp, jcfg, max_bodies=6)
    got = build_scene(tp, convert.physics_config_from(jcfg), max_bodies=6)
    _compare_scenes(got, want, edge_order=False)
    # World corners through the scene's poses.
    wv, wm = piece_world_verts(got)
    np.testing.assert_array_equal(wm.numpy(), np.asarray(want.piece_vmask))


@pytest.mark.parametrize("vh", [8, 32])
def test_dedup_verts_copies_exactly(vh):
    rng = np.random.default_rng(8)
    fv, nv, pl = _boxes(rng, 6)
    poly = convert.poly_from(JConvexPoly(fv, nv, pl))
    got, gm = _dedup_verts(poly.face_verts, poly.slot_mask(), vh)
    want, wm = jax.vmap(lambda f, m: j_dedup_verts(f, m, vh))(
        jnp.asarray(fv), jnp.asarray(poly.slot_mask().numpy()))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(got.numpy()[gm.numpy()], np.asarray(want)[np.asarray(wm)])


def test_inertia_matches():
    rng = np.random.default_rng(7)
    fv, nv, pl = _boxes(rng, 12)
    m_t, c_t, I_t = moments.inertia(convert.poly_from(JConvexPoly(fv, nv, pl)), density=10.0)
    m_j, c_j, I_j = j_moments.inertia(JConvexPoly(jnp.asarray(fv), jnp.asarray(nv), jnp.asarray(pl)),
                                      density=10.0)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    np.testing.assert_allclose(I_t.numpy(), np.asarray(I_j), rtol=1e-4, atol=1e-5)


def test_scene_round_trip():
    sc = workload.physics_lattice(8, "cpu")
    back = convert.scene_from(convert.scene_to_numpy(sc))
    for f in dataclasses.fields(sc):
        a, b = getattr(sc, f.name), getattr(back, f.name)
        if f.name == "bodies":
            for g in dataclasses.fields(a):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name))
        else:
            assert torch.equal(a, b)
