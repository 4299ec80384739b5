"""The port's remaining public functions on the CPU against the JAX
package's: ``clip_poly_poly`` and ``clip_batch_by_cells``, ``ich_contains``,
``aabb`` and ``all_verts``, ``smooth_vertex_normals``, ``TriSoup`` and
``transform_poly``, ``unique_corner_verts``, ``dotn`` and ``compact_big``,
the refit's ``refit_planes`` at limits 4 and 8 and ``refit_convex`` at 8, and
the batched hull ``ich_batch`` (kernel B2's batched entry: its plain version
on the CPU) against the one-set ``ich``.

The JAX clip, hull, transform and refit run compiled in a child process
with ``--xla_cpu_max_isa=AVX``: on an AVX2 host XLA:CPU contracts products
into FMAs (ROADMAP C5), which moves cut points and greedy picks by an ulp;
without FMA every product is rounded, as in the port. Run as a script
(``python tests/test_torch_leftovers.py OUT.npz``) it is that child.
Tolerances: counts, masks, indices and boolean
results exactly; the batched hull bit for bit against the one-set hull;
coordinates and planes within 1e-6 (1e-5 for the refit fold, whose cap
points are sums of several cut points); refit offsets by value, since
the JAX package's XLA refit can give a zero minimum as +0 where the port
gives -0 (ROADMAP C12).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu_torch import convert
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = (4, 8)

def _poly(jp):
    return convert.poly_from(jp)


def _cells(seed, n, F=16, S=12):
    from surtr_tpu.ops.voronoi import voronoi_cells

    seeds = np.random.RandomState(seed).uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return voronoi_cells(jnp.asarray(seeds), k=n - 1, F=F, S=S)


def _assert_poly(got, want, atol=1e-6):
    np.testing.assert_array_equal(got.n_verts.numpy(), np.asarray(want.n_verts))
    sm = got.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, got.face_verts.numpy(), 0),
                               np.where(sm, np.asarray(want.face_verts), 0), atol=atol)
    fm = got.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, got.planes.numpy(), 0),
                               np.where(fm, np.asarray(want.planes), 0), atol=atol)


def _pieces():
    from surtr_tpu.types import scale_poly, translate_poly, unit_cube

    return jax.tree_util.tree_map(
        lambda *a: jnp.stack(a),
        unit_cube(F=16, S=12),
        translate_poly(scale_poly(unit_cube(F=16, S=12), 0.6), jnp.asarray([0.3, 0.1, 0.0])),
    )


def _empty_cell():
    empty = jax.tree_util.tree_map(lambda a: a[0], _cells(3, 6))
    return dataclasses.replace(empty, n_verts=jnp.zeros_like(empty.n_verts))


def _contains_inputs():
    rng = np.random.RandomState(4)
    pool = rng.randn(40, 3).astype(np.float32)
    mask = rng.rand(40) > 0.2
    probes = (rng.randn(300, 3) * 0.8).astype(np.float32)
    probes[:5] = pool[:5]                       # on hull corners or inside
    return pool, mask, probes


def _rotation():
    q = np.random.RandomState(2).randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.asarray([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                   np.float32)
    return R, np.asarray([0.3, -1.2, 2.0], np.float32)


def _flat(prefix, tree, out):
    items = dataclasses.asdict(tree) if dataclasses.is_dataclass(tree) else tree
    for k, v in items.items():
        out[f"{prefix}/{k}"] = np.asarray(v)


def _jax_reference(out_path):
    """Child-process side: the JAX functions compiled without FMA."""
    from surtr_tpu.fracture.pipeline import refit_convex, refit_planes
    from surtr_tpu.ops.clip import clip_batch_by_cells, clip_poly_poly
    from surtr_tpu.ops.hull import ich, ich_contains
    from surtr_tpu.types import transform_poly, unit_cube

    res = {}
    pieces, cells = _pieces(), _cells(3, 6)
    _flat("cells3", cells, res)
    _flat("cells5", _cells(5, 4), res)
    _flat("grid", clip_batch_by_cells(pieces, cells), res)
    one = jax.tree_util.tree_map(lambda a: a[1], pieces)
    _flat("one", clip_poly_poly(one, jax.tree_util.tree_map(lambda a: a[2], cells)), res)
    _flat("none", clip_poly_poly(one, _empty_cell()), res)
    pool, mask, probes = _contains_inputs()
    h = ich(jnp.asarray(pool), jnp.asarray(mask), limit=12)
    res["contains/faces"] = np.asarray(h["faces"])
    res["contains/inside"] = np.asarray(ich_contains(h, jnp.asarray(probes), jnp.asarray(pool)))
    R, t = _rotation()
    _flat("transform", transform_poly(_cells(5, 4), jnp.asarray(R), jnp.asarray(t)), res)
    pts, pm = _pools()
    pts = pts * 0.3
    for limit in LIMITS:
        planes, m = jax.vmap(lambda p, q: refit_planes(p, q, limit))(jnp.asarray(pts),
                                                                     jnp.asarray(pm))
        res[f"refit{limit}/planes"], res[f"refit{limit}/mask"] = np.asarray(planes), np.asarray(m)
    _flat("refit8/convex", refit_convex(unit_cube(F=32, S=16), jnp.asarray(pts[6]),
                                        jnp.asarray(pm[6]), 8), res)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("leftovers_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _ref_poly(ref, prefix):
    from surtr_tpu_torch.types import ConvexPoly

    return ConvexPoly(*(torch.as_tensor(ref[f"{prefix}/{k}"])
                        for k in ("face_verts", "n_verts", "planes")))


def test_clip_poly_poly_and_batch_by_cells_match(jax_ref):
    from surtr_tpu_torch.ops.clip import clip_batch_by_cells, clip_poly_poly

    # The cells as the child built them (compiled in-process, XLA's FMAs
    # can give the caps other vertices).
    pieces, cells = _pieces(), _ref_poly(jax_ref, "cells3")
    got = clip_batch_by_cells(_poly(pieces), cells)
    assert got.batch_shape == (2, 6)
    _assert_poly(got, _ref_poly(jax_ref, "grid"))
    one = _poly(jax.tree_util.tree_map(lambda a: a[1], pieces))
    _assert_poly(clip_poly_poly(one, cells.map(lambda a: a[2])), _ref_poly(jax_ref, "one"))
    got_none = clip_poly_poly(one, _poly(_empty_cell()))
    _assert_poly(got_none, _ref_poly(jax_ref, "none"))
    assert bool(got_none.is_empty())
    assert not bool(got.is_empty().all())


def test_ich_contains_matches(jax_ref):
    from surtr_tpu_torch.ops.hull import ich, ich_contains

    pool, mask, probes = _contains_inputs()
    h = ich(torch.as_tensor(pool), torch.as_tensor(mask), limit=12)
    np.testing.assert_array_equal(h["faces"].numpy(), jax_ref["contains/faces"])
    got = ich_contains(h, torch.as_tensor(probes), torch.as_tensor(pool)).numpy()
    want = jax_ref["contains/inside"]
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_aabb_and_all_verts_match():
    from surtr_tpu.ops.moments import aabb as j_aabb
    from surtr_tpu.ops.moments import all_verts as j_all_verts
    from surtr_tpu_torch.ops.moments import aabb, all_verts

    cells = _cells(8, 5)
    for got, want in zip(aabb(_poly(cells)), j_aabb(cells)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(all_verts(_poly(cells)), j_all_verts(cells)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smooth_vertex_normals_match():
    from surtr_tpu.io.models import icosphere as j_icosphere
    from surtr_tpu.io.models import smooth_vertex_normals as j_normals
    from surtr_tpu_torch.io.models import icosphere, smooth_vertex_normals

    for sub in (1, 2):
        v, f = icosphere(sub)
        np.testing.assert_array_equal(smooth_vertex_normals(v, f), j_normals(*j_icosphere(sub)))


def test_trisoup_and_transform_poly_match(jax_ref):
    from surtr_tpu.types import TriSoup as JTriSoup
    from surtr_tpu_torch import RigidState, TriSoup
    from surtr_tpu_torch import __all__ as names
    from surtr_tpu_torch.types import transform_poly

    assert {"TriSoup", "RigidState"} <= set(names) and RigidState.__name__ == "RigidState"
    rng = np.random.RandomState(2)
    verts = rng.randn(2, 9, 3).astype(np.float32)
    tris = rng.randint(-1, 9, (2, 7, 3)).astype(np.int32)     # -1 reads vertex 0
    valid = rng.rand(2, 7) > 0.3
    js = JTriSoup(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(valid))
    ts = TriSoup(torch.as_tensor(verts), torch.as_tensor(tris), torch.as_tensor(valid))
    assert (ts.V, ts.T) == (js.V, js.T) == (9, 7)
    np.testing.assert_array_equal(ts.corners().numpy(), np.asarray(js.corners()))
    one = TriSoup(ts.verts[0], ts.tris[0], ts.tri_valid[0])
    np.testing.assert_array_equal(one.corners().numpy(), np.asarray(js.corners())[0])

    R, t = _rotation()
    _assert_poly(transform_poly(_ref_poly(jax_ref, "cells5"), torch.as_tensor(R),
                                torch.as_tensor(t)), _ref_poly(jax_ref, "transform"))


def test_unique_corner_verts_dotn_and_compact_big_match():
    from surtr_tpu.ops.linalg import compact_big as j_compact_big
    from surtr_tpu.ops.linalg import dotn as j_dotn
    from surtr_tpu.ops.mesh_clip import unique_corner_verts as j_ucv
    from surtr_tpu_torch.ops.linalg import compact_big, dot3, dotn
    from surtr_tpu_torch.ops.mesh_clip import unique_corner_verts

    rng = np.random.RandomState(9)
    corners = rng.randn(11, 3, 3).astype(np.float32)
    valid = rng.rand(11) > 0.4
    for got, want in zip(unique_corner_verts(torch.as_tensor(corners), torch.as_tensor(valid)),
                         j_ucv(jnp.asarray(corners), jnp.asarray(valid))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a, b = rng.randn(2, 6, 5).astype(np.float32)
    np.testing.assert_allclose(dotn(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(j_dotn(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    a3, b3 = torch.as_tensor(a[..., :3]), torch.as_tensor(b[..., :3])
    assert torch.equal(dotn(a3, b3), dot3(a3, b3))
    vals = rng.randn(300, 4).astype(np.float32)
    for frac, S_out in ((0.3, 64), (0.5, 200), (0.0, 16)):
        flags = rng.rand(300) < frac
        got = compact_big(torch.as_tensor(vals), torch.as_tensor(flags), S_out)
        want = j_compact_big(jnp.asarray(vals), jnp.asarray(flags), S_out)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])


def _pools():
    """Refit pools: random clouds with 0-3 live points, all masked, tied
    corners, a coplanar set, and a padded size that is not a multiple of
    32."""
    rng = np.random.RandomState(6)
    P = 45
    pts = rng.randn(10, P, 3).astype(np.float32)
    mask = rng.rand(10, P) > 0.3
    mask[0] = False                             # nothing live
    mask[1] = False
    mask[1, [4, 9, 30]] = True                  # 3 live points
    mask[2] = False
    mask[2, [7]] = True                         # 1 live point
    grid = np.stack(np.meshgrid(*[np.arange(3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts[3, :27] = grid                          # exact ties
    mask[3] = np.arange(P) < 27
    pts[4, :, 2] = 0.25                         # coplanar
    pts[5, 20:] = pts[5, :25]                   # every point twice
    return pts, mask


@pytest.mark.parametrize("limit", [8, 20])
def test_ich_batch_equals_one_set_ich_bit_for_bit(limit):
    from surtr_tpu_torch.ops import hull_cuda

    pts, mask = _pools()
    before = hull_cuda.launches
    got = hull_cuda.ich_batch(torch.as_tensor(pts), torch.as_tensor(mask), limit=limit)
    assert hull_cuda.launches == before         # CPU tensors take the plain version
    assert got["faces"].shape == (10, 2 * limit + 4, 3)
    for b in range(len(pts)):
        one = hull_cuda.ich(torch.as_tensor(pts[b]), torch.as_tensor(mask[b]), limit=limit)
        for k, v in one.items():
            assert torch.equal(got[k][b], v), (b, k)
            assert got[k][b].dtype == v.dtype
    single = hull_cuda.ich_batch(torch.as_tensor(pts[6:7]), torch.as_tensor(mask[6:7]), limit)
    for k in single:
        assert torch.equal(single[k][0], got[k][6]), k


@pytest.mark.parametrize("limit", LIMITS)
def test_refit_planes_and_convex_match(jax_ref, limit):
    from surtr_tpu_torch.fracture.pipeline import refit_convex, refit_planes
    from surtr_tpu_torch.types import unit_cube

    pts, mask = _pools()
    pts = pts * 0.3
    got_p, got_m = refit_planes(torch.as_tensor(pts), torch.as_tensor(mask), limit)
    np.testing.assert_array_equal(got_m.numpy(), jax_ref[f"refit{limit}/mask"])
    # Pools with fewer than 4 live points come out masked in both.
    assert not got_m[:3].any()
    m = got_m.numpy()[..., None]
    np.testing.assert_allclose(np.where(m, got_p.numpy(), 0),
                               np.where(m, jax_ref[f"refit{limit}/planes"], 0), atol=1e-6)
    one_p, one_m = refit_planes(torch.as_tensor(pts[6]), torch.as_tensor(mask[6]), limit)
    assert torch.equal(one_p, got_p[6]) and torch.equal(one_m, got_m[6])

    if limit == 8:
        gc = refit_convex(unit_cube(F=32, S=16), torch.as_tensor(pts[6]),
                          torch.as_tensor(mask[6]), limit)
        _assert_poly(gc, _ref_poly(jax_ref, "refit8/convex"), atol=1e-5)
        assert not bool(gc.is_empty())


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
