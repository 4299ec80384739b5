"""The port's plain operators around the kernels against the JAX package:
moments, k-DOP slabs, bisectors and Voronoi cells, the triangle-soup clip
and the inside-solid queries. Inputs are made with numpy from fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.io.models import get_model as j_get_model
from surtr_tpu.io.models import sphere_point_cloud as j_sphere_cloud
from surtr_tpu.ops import kdop as j_kdop
from surtr_tpu.ops import mesh_clip as j_mesh
from surtr_tpu.ops import voronoi as j_voronoi
from surtr_tpu.ops.moments import moments as j_moments
from surtr_tpu.types import ConvexPoly as JPoly
from surtr_tpu.types import scale_poly as j_scale_poly
from surtr_tpu.types import translate_poly as j_translate_poly
from surtr_tpu.types import unit_cube as j_unit_cube
from surtr_tpu_torch import convert
from surtr_tpu_torch.io.models import get_model, sphere_point_cloud
from surtr_tpu_torch.ops import mesh_clip, voronoi
from surtr_tpu_torch.ops.kdop import kdop_planes
from surtr_tpu_torch.ops.linalg import compact, pack_rows
from surtr_tpu_torch.ops.moments import moments
from surtr_tpu_torch.types import scale_poly, translate_poly, unit_cube
from torch_threads import bounded_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["cube", "box", "sphere", "blob", "torus"])
def test_models_match(name):
    v, f = get_model(name)
    jv, jf = j_get_model(name)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_sphere_cloud_matches():
    np.testing.assert_array_equal(sphere_point_cloud(), j_sphere_cloud())


def test_scaled_cube_moments_match():
    s, t = (2.0, 3.0, 0.5), (0.1, -0.2, 0.3)
    j = j_translate_poly(j_scale_poly(j_unit_cube(F=10, S=6), s), t)
    p = translate_poly(scale_poly(unit_cube(F=10, S=6), s), t)
    np.testing.assert_allclose(p.planes.numpy(), np.asarray(j.planes), atol=1e-7)
    v, c = moments(p.map(lambda a: a[None]))
    jv, jc = j_moments(jax.tree_util.tree_map(lambda a: a[None], j))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    assert float(v[0]) == pytest.approx(3.0)


def test_kdop_planes_match():
    rng = np.random.RandomState(2)
    verts = rng.randn(3, 20, 3).astype(np.float32)
    vmask = rng.rand(3, 20) > 0.2
    vmask[2] = False
    dirs = rng.randn(5, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dmask = np.array([True, True, False, True, True])
    got, gm = kdop_planes(torch.as_tensor(verts), torch.as_tensor(vmask),
                          torch.as_tensor(dirs), torch.as_tensor(dmask), gap=0.01)
    want, wm = j_kdop.kdop_planes(jnp.asarray(verts), jnp.asarray(vmask),
                                  jnp.broadcast_to(jnp.asarray(dirs), (3, 5, 3)),
                                  jnp.asarray(dmask), gap=0.01)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(got.numpy()[gm.numpy()], np.asarray(want)[np.asarray(wm)],
                               atol=1e-6)


def test_compact_and_pack_rows():
    rng = np.random.RandomState(4)
    vals = torch.as_tensor(rng.randn(7, 5, 2).astype(np.float32))
    counts = torch.as_tensor([0, 3, 5, 1, 0, 2, 4])
    packed, total = pack_rows(vals, counts, 9)
    want = torch.cat([vals[r, : int(c)] for r, c in enumerate(counts)])[:9]
    assert int(total) == 9
    assert torch.equal(packed, want)
    out, n = compact(vals.reshape(35, 2), torch.zeros(35, dtype=torch.bool), 4)
    assert int(n) == 0 and not bool(out.any())


def test_voronoi_cells_match():
    rng = np.random.RandomState(8)
    seeds = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32)
    cells = voronoi.voronoi_cells(torch.as_tensor(seeds), k=11, F=20, S=12)
    want = j_voronoi.voronoi_cells(jnp.asarray(seeds), k=11, F=20, S=12)
    # Compiled XLA may leave duplicate cap vertices (FMA contraction, see
    # test_torch_clip.py): compare live faces and their planes, not loops.
    np.testing.assert_array_equal(cells.face_mask().numpy(), np.asarray(want.face_mask()))
    fm = cells.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, cells.planes.numpy(), 0),
                               np.where(fm, np.asarray(want.planes), 0), atol=1e-6)
    vol, _ = moments(cells)
    np.testing.assert_allclose(vol.numpy(), np.asarray(j_moments(want)[0]), atol=1e-6)
    assert float(vol.sum()) == pytest.approx(1.0, abs=1e-5)   # cells tile the cube


def test_bisector_planes_match():
    rng = np.random.RandomState(9)
    s = rng.randn(3).astype(np.float32)
    o = rng.randn(6, 3).astype(np.float32)
    o[2] = s                                   # coincident seed: masked
    m = np.ones(6, bool)
    got, gm = voronoi.bisector_planes(torch.as_tensor(s), torch.as_tensor(o), torch.as_tensor(m))
    want, wm = j_voronoi.bisector_planes(jnp.asarray(s), jnp.asarray(o), jnp.asarray(m))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(got.numpy()[gm.numpy()], np.asarray(want)[np.asarray(wm)], atol=1e-6)


@pytest.mark.parametrize("model,max_out", [("cube", 16), ("blob", 64)])
def test_clip_trisoup_matches(model, max_out):
    v, f = get_model(model)
    corners = v[f].astype(np.float32)
    tmask = np.ones(len(f), bool)
    tmask[::7] = False
    rng = np.random.RandomState(6)
    B, K = 3, 5
    n = rng.randn(B, K, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(-0.6, 0.3, (B, K, 1))], -1).astype(np.float32)
    planes[0, 1] = [1.0, 0.0, 0.0, -1.5]       # a cube face plane: in-plane drop rule
    pm = rng.rand(B, K) > 0.2
    got, gv, gd = mesh_clip.clip_trisoup(torch.as_tensor(corners), torch.as_tensor(tmask),
                                         torch.as_tensor(planes), torch.as_tensor(pm), max_out=max_out)
    for b in range(B):
        wt, wv, wd = j_mesh.clip_trisoup(jnp.asarray(corners), jnp.asarray(tmask),
                                         jnp.asarray(planes[b]), jnp.asarray(pm[b]), max_out=max_out)
        np.testing.assert_array_equal(gv[b].numpy(), np.asarray(wv))
        assert int(gd[b]) == int(wd)
        m = gv[b].numpy()
        np.testing.assert_allclose(got[b].numpy()[m], np.asarray(wt)[m], atol=1e-5)


@pytest.mark.parametrize("query", ["winding", "ray"])
def test_solid_queries_match(query):
    v, f = get_model("blob")
    corners = v[f].astype(np.float32)
    tmask = np.ones(len(f), bool)
    rng = np.random.RandomState(1)
    pts = rng.uniform(-2.0, 2.0, (200, 3)).astype(np.float32)
    fn = {"winding": (mesh_clip.winding_inside, j_mesh.winding_inside),
          "ray": (mesh_clip.point_in_mesh, j_mesh.point_in_mesh)}[query]
    got = fn[0](torch.as_tensor(pts), torch.as_tensor(corners), torch.as_tensor(tmask)).numpy()
    want = np.asarray(fn[1](jnp.asarray(pts), jnp.asarray(corners), jnp.asarray(tmask)))
    np.testing.assert_array_equal(got, want)
    assert 10 < got.sum() < 190


def test_convert_poly_feeds_port_ops():
    # The same JAX intermediate state, carried across, gives the same volume.
    j = jax.tree_util.tree_map(lambda a: a[None], j_unit_cube(F=8, S=6))
    p = convert.poly_from(JPoly(*(np.asarray(a) for a in (j.face_verts, j.n_verts, j.planes))))
    assert float(moments(p)[0][0]) == pytest.approx(float(j_moments(j)[0][0]))
