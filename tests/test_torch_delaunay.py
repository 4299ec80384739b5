"""The port's Delaunay triangulations (``ops/delaunay.py``,
``ops/delaunay2d.py``) on the CPU against the JAX package's, on the inputs
of its own tests (tests/test_delaunay_checkpoint.py, test_delaunay2d.py),
and against ``scipy.spatial.Delaunay``.

Tolerances: the tet and triangle tables slot for slot (the insertion
order and the stable free-slot order are the JAX package's) and, as sets,
equal to scipy's; the extended points, the 2-D circumcentres and the
Voronoi dual's edges within 1e-5 of the largest coordinate, its edge mask
exactly; the 3-D circumcentres within 1e-5 of max(radius, 1) for the real
tets and 1e-4 for those with a super-tetrahedron corner (whose spheres are
up to ~100 times the cloud's; ``torch.linalg`` and ``jnp.linalg`` solve
with LU factorizations of their own), squared radii to the same bound on
r. XLA may contract the super-tetrahedron's scale·corner + centre into an
FMA, one ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull, Delaunay

from surtr_tpu.ops.delaunay import circumcenter as j_circumcenter
from surtr_tpu.ops.delaunay import delaunay3d as j_delaunay3d
from surtr_tpu.ops.delaunay import voronoi_dual_edges as j_voronoi_dual_edges
from surtr_tpu.ops.delaunay2d import circumcircle as j_circumcircle
from surtr_tpu.ops.delaunay2d import delaunay2d as j_delaunay2d
from surtr_tpu_torch.ops.delaunay import circumcenter, delaunay3d, voronoi_dual_edges
from surtr_tpu_torch.ops.delaunay2d import circumcircle, delaunay2d
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def _set(simplices, valid):
    return {tuple(sorted(t)) for t, v in zip(np.asarray(simplices), np.asarray(valid)) if v}


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5 * scale)


def _cloud(seed, n, d, live=None):
    """tests/test_delaunay*'s inputs: ``default_rng(seed)`` uniform in
    [-1, 1], the first ``live`` points live and the rest zeros."""
    rng = np.random.default_rng(seed)
    live = n if live is None else live
    pts = np.zeros((n, d), np.float32)
    pts[:live] = rng.uniform(-1, 1, (live, d))
    return pts, np.arange(n) < live


CASES_3D = {"scipy24": (3, 24, None), "hull16": (9, 16, None), "masked20": (5, 20, 12),
            "dual20": (1, 20, None)}


@pytest.mark.parametrize("case", list(CASES_3D))
def test_delaunay3d_matches_jax_and_scipy(case):
    pts, mask = _cloud(*CASES_3D[case][:2], 3, CASES_3D[case][2])
    got = delaunay3d(torch.as_tensor(pts), torch.as_tensor(mask))
    want = j_delaunay3d(jnp.asarray(pts), jnp.asarray(mask))
    for k in ("tets", "tet_valid", "tet_valid_all"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    scale = float(np.abs(np.asarray(want["points"])).max())
    # The super-tetrahedron's corners: XLA may contract scale·corner + centre.
    _close(got["points"].numpy(), np.asarray(want["points"]), scale)
    # The real tets' spheres within 1e-5 of max(r, 1); those of tets with a
    # super-tetrahedron corner (radii up to ~100 times the cloud's) within
    # 1e-4 of it.
    for v, tol in ((np.asarray(want["tet_valid"]), 1e-5),
                   (np.asarray(want["tet_valid_all"]), 1e-4)):
        r = np.sqrt(np.asarray(want["r2"])[v])
        lim = np.maximum(r, 1.0) * tol
        dc = np.abs(got["circumcenters"].numpy()[v] - np.asarray(want["circumcenters"])[v])
        assert (dc <= lim[:, None]).all()
        assert (np.abs(got["r2"].numpy()[v] - np.asarray(want["r2"])[v]) <= 2 * r * lim).all()
    live = pts[mask].astype(np.float64)
    assert _set(got["tets"], got["tet_valid"]) == {tuple(sorted(t))
                                                   for t in Delaunay(live).simplices}
    tets = got["tets"].numpy()[got["tet_valid"].numpy()]
    a, b, c, d = (pts[tets[:, i]].astype(np.float64) for i in range(4))
    vol = np.abs(np.einsum("ij,ij->i", a - d, np.cross(b - d, c - d))).sum() / 6
    assert vol == pytest.approx(ConvexHull(live).volume, rel=1e-4)


def test_voronoi_dual_edges_match_jax():
    pts, mask = _cloud(1, 20, 3)
    got_e, got_m = voronoi_dual_edges(delaunay3d(torch.as_tensor(pts), torch.as_tensor(mask)))
    want_e, want_m = j_voronoi_dual_edges(j_delaunay3d(jnp.asarray(pts), jnp.asarray(mask)))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert int(got_m.sum()) > 10
    m = got_m.numpy()
    _close(got_e.numpy()[m], np.asarray(want_e)[m], float(np.abs(np.asarray(want_e)[m]).max()))


CASES_2D = {"scipy30": (2, 30, None), "masked20": (4, 20, 11)}


@pytest.mark.parametrize("case", list(CASES_2D))
def test_delaunay2d_matches_jax_and_scipy(case):
    pts, mask = _cloud(*CASES_2D[case][:2], 2, CASES_2D[case][2])
    got = delaunay2d(torch.as_tensor(pts), torch.as_tensor(mask))
    want = j_delaunay2d(jnp.asarray(pts), jnp.asarray(mask))
    for k in ("tris", "tri_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    scale = float(np.abs(np.asarray(want["points"])).max())
    _close(got["circumcenters"].numpy(), np.asarray(want["circumcenters"]), scale)
    assert _set(got["tris"], got["tri_valid"]) == {
        tuple(sorted(t)) for t in Delaunay(pts[mask].astype(np.float64)).simplices}


def test_circumcenters_match_jax_on_degenerate_simplices():
    rng = np.random.default_rng(7)
    tets = rng.uniform(-1, 1, (64, 4, 3)).astype(np.float32)
    tets[0] = 0.0                                   # all corners equal
    tets[1, 3] = tets[1, 0]                         # a repeated corner
    tets[2, :, 2] = 0.5                             # coplanar
    got = circumcenter(torch.as_tensor(tets))
    want = j_circumcenter(jnp.asarray(tets))
    assert (got[1][:3] == -1).all() and (np.asarray(want[1])[:3] == -1).all()
    ok = np.asarray(want[1]) >= 0
    scale = float(np.abs(np.asarray(want[0])[ok]).max())
    _close(got[0].numpy(), np.asarray(want[0]), scale)
    _close(got[1].numpy()[ok], np.asarray(want[1])[ok], scale ** 2)
    tris = rng.uniform(-1, 1, (64, 3, 2)).astype(np.float32)
    tris[0] = 0.0
    tris[1, 2] = tris[1, 0] * 2 - tris[1, 1] * 1     # collinear
    tris[1, 2] = (tris[1, 0] + tris[1, 1]) * 0.5
    got = circumcircle(torch.as_tensor(tris))
    want = j_circumcircle(jnp.asarray(tris))
    np.testing.assert_array_equal(got[1].numpy() == -1, np.asarray(want[1]) == -1)
    ok = np.asarray(want[1]) >= 0
    scale = float(np.abs(np.asarray(want[0])[ok]).max())
    _close(got[0].numpy()[ok], np.asarray(want[0])[ok], scale)
    _close(got[1].numpy()[ok], np.asarray(want[1])[ok], scale ** 2)
