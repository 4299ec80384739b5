"""The port's plain plane fold (the CPU side of kernel B1) against the JAX
package: the XLA fold and the Pallas kernel in interpret mode.

Slot layout is compared against the XLA fold run op by op
(``jax.disable_jit``): compiled, XLA:CPU contracts ``a·s_b − b·s_a`` into
FMAs, the two faces sharing an edge then get cut points one ulp apart, the
cap dedup keeps both, and the cap loop carries duplicate vertices. Op by op
every product is rounded, as in the port and its kernel. Against the
compiled fold and the Pallas kernel (which also rotates loops and orders
caps by a pseudo-angle) the comparison is by invariants: volume, centroid,
emptiness and the set of live face planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.ops.clip import clip_poly_planes as j_clip_poly_planes
from surtr_tpu.ops.clip_pallas import clip_planes_batch_pallas
from surtr_tpu.ops.moments import moments as j_moments
from surtr_tpu.types import ConvexPoly as JPoly
from surtr_tpu_torch.ops import clip_cuda
from surtr_tpu_torch.ops.clip import clip_poly_plane, contains_point
from surtr_tpu_torch.ops.moments import moments
from surtr_tpu_torch.types import ConvexPoly, unit_cube
from torch_threads import bounded_threads  # noqa: F401 (autouse)

F, S = 26, 16


def _normalize(rows):
    rows = np.asarray(rows, np.float64)
    n = rows[..., :3]
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([n / ln, rows[..., 3:] / ln], -1).astype(np.float32)


def _case(name):
    cube = unit_cube(F=F, S=S)
    if name == "random":
        rng = np.random.RandomState(11)
        N, K = 8, 12
        pn = rng.randn(N, K, 3)
        pd = rng.uniform(-0.45, 0.1, (N, K, 1))
        planes = _normalize(np.concatenate([pn, pd], -1))
        mask = rng.rand(N, K) > 0.3
    else:
        lists = {
            # Planes through cube vertices and edges (in-plane candidates).
            "tangent": [
                [[1, 1, 0, 0]], [[1, 1, 1, -0.75]], [[1, 0, 0, -0.7]],
                [[1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 1, 0]],
            ],
            # Re-clipping by a face plane the polytope already carries: the
            # cube's own +x face, and a cut repeated after it made a cap.
            "reclip": [
                [[1, 0, 0, -0.5]],
                [[1, 1, 0, -0.2], [1, 1, 0, -0.2]],
                [[0, 1, 1, 0.1], [1, 0, 0, -0.5], [0, 1, 1, 0.1]],
            ],
            # Everything masked: a no-op.
            "masked": [[[1, 0, 0, 0.3], [0, 1, 0, 0.2]]],
            # A polytope that empties, and a sliver between two cuts.
            "empties": [[[1, 0, 0, 0.6]], [[1, 0, 0, -0.01], [-1, 0, 0, -0.01]]],
        }[name]
        N, K = len(lists), max(len(c) for c in lists)
        planes = np.zeros((N, K, 4), np.float32)
        mask = np.zeros((N, K), bool)
        for i, c in enumerate(lists):
            planes[i, : len(c)] = _normalize(c)
            mask[i, : len(c)] = name != "masked"
    fv = np.broadcast_to(cube.face_verts.numpy(), (N, F, S, 3)).copy()
    nv = np.broadcast_to(cube.n_verts.numpy(), (N, F)).copy()
    pl = np.broadcast_to(cube.planes.numpy(), (N, F, 4)).copy()
    return (fv, nv, pl), planes, mask


CASES = ["random", "tangent", "reclip", "masked", "empties"]


def _batch():
    """All cases in one batch (one JAX compile per reference), padded to a
    common plane count with masked planes; returns the batch and each
    case's row slice."""
    cases = [_case(n) for n in CASES]
    K = max(c[1].shape[1] for c in cases)
    polys, planes, masks, slices, at = [[], [], []], [], [], {}, 0
    for name, (poly, pl, m) in zip(CASES, cases):
        n = pl.shape[0]
        for acc, a in zip(polys, poly):
            acc.append(a)
        planes.append(np.pad(pl, ((0, 0), (0, K - pl.shape[1]), (0, 0))))
        masks.append(np.pad(m, ((0, 0), (0, K - m.shape[1]))))
        slices[name] = slice(at, at + n)
        at += n
    poly = tuple(np.concatenate(a) for a in polys)
    return (poly, np.concatenate(planes), np.concatenate(masks)), slices


def _port(poly, planes, mask):
    tp = ConvexPoly(*(torch.as_tensor(a) for a in poly))
    before = clip_cuda.launches
    out = clip_cuda.clip_planes_batch(tp, torch.as_tensor(planes), torch.as_tensor(mask))
    assert clip_cuda.launches == before  # CPU tensors never reach the kernel
    return out


def _jax_poly(poly):
    return JPoly(*(jnp.asarray(a) for a in poly))


@pytest.fixture(scope="module")
def folds():
    (poly, planes, mask), slices = _batch()
    jp, jpl, jm = _jax_poly(poly), jnp.asarray(planes), jnp.asarray(mask)
    with jax.disable_jit():
        eager = jax.vmap(j_clip_poly_planes)(jp, jpl, jm)
    return {
        "slices": slices,
        "planes": planes,
        "mask": mask,
        "port": _port(poly, planes, mask),
        "eager": eager,
        "pallas": clip_planes_batch_pallas(jp, jpl, jm, interpret=True, block=8),
        "compiled": jax.jit(jax.vmap(j_clip_poly_planes))(jp, jpl, jm),
    }


def _rows(p, sl):
    return ConvexPoly(p.face_verts[sl], p.n_verts[sl], p.planes[sl])


@pytest.mark.parametrize("name", CASES)
def test_clip_matches_xla_fold_slot_for_slot(folds, name):
    sl = folds["slices"][name]
    out = _rows(folds["port"], sl)
    ref = folds["eager"]
    np.testing.assert_array_equal(out.n_verts.numpy(), np.asarray(ref.n_verts)[sl])
    sm = out.slot_mask().numpy()[..., None]
    # Same operations in the same order: 1 ulp of the unit cube's scale.
    np.testing.assert_allclose(np.where(sm, out.face_verts.numpy(), 0),
                               np.where(sm, np.asarray(ref.face_verts)[sl], 0), atol=1e-7)
    fm = out.face_mask().numpy()[..., None]
    np.testing.assert_array_equal(np.where(fm, out.planes.numpy(), 0),
                                  np.where(fm, np.asarray(ref.planes)[sl], 0))


def _invariants(out, ref, sl):
    v, c = j_moments(ref)
    vol_ref, cen_ref = np.asarray(v)[sl], np.asarray(c)[sl]
    vol, cen = moments(out)
    # Volumes: fan sums over differently rotated loops; f32 at unit scale.
    np.testing.assert_allclose(vol.numpy(), vol_ref, atol=3e-6)
    live = vol_ref > 1e-7
    np.testing.assert_allclose(cen.numpy()[live], cen_ref[live], atol=2e-5)
    np.testing.assert_array_equal(out.is_empty().numpy(), np.asarray(ref.is_empty())[sl])
    planes_ref = np.asarray(ref.planes)[sl]
    fmask_ref = np.asarray(ref.face_mask())[sl]
    got_planes, got_fm = out.planes.numpy(), out.face_mask().numpy()
    for i in range(len(vol_ref)):
        a = np.round(got_planes[i][got_fm[i]], 5)
        b = np.round(planes_ref[i][fmask_ref[i]], 5)
        assert sorted(map(tuple, a)) == sorted(map(tuple, b))


@pytest.mark.parametrize("name", CASES)
def test_clip_matches_pallas_interpret(folds, name):
    sl = folds["slices"][name]
    _invariants(_rows(folds["port"], sl), folds["pallas"], sl)


@pytest.mark.parametrize("name", CASES)
def test_clip_matches_compiled_xla_fold(folds, name):
    sl = folds["slices"][name]
    _invariants(_rows(folds["port"], sl), folds["compiled"], sl)


def test_clip_vertices_inside_all_planes():
    poly, planes, mask = _case("random")
    out = _port(poly, planes, mask)
    s = np.einsum("nkd,nfsd->nfsk", planes[..., :3], out.face_verts.numpy()) + planes[:, None, None, :, 3]
    sm = out.slot_mask().numpy()[..., None] & mask[:, None, None, :]
    assert float(np.max(np.where(sm, s, -1.0))) < 1e-5
    # contains_point agrees: the centroid of a live cell is inside it.
    vol, cen = moments(out)
    live = vol > 1e-6
    assert bool(contains_point(ConvexPoly(out.face_verts[live], out.n_verts[live],
                                          out.planes[live]), cen[live], tol=1e-5).all())


def _identity_expected(poly, plane, tol=1e-6):
    """Per polytope, kernel B1's skip rule: every live vertex kept
    (distance <= tol), every n_verts in {0} ∪ [3, S], every slot past
    n_verts bitwise +0.0, and 0 or >= 4 live faces."""
    fv, nv = poly.face_verts, poly.n_verts
    S = fv.shape[2]
    m = torch.arange(S) < nv[..., None]
    dist = (fv[..., 0] * plane[:, None, None, 0] + fv[..., 1] * plane[:, None, None, 1]
            + fv[..., 2] * plane[:, None, None, 2]) + plane[:, None, None, 3]
    kept = torch.all(~m | (dist <= tol), dim=(1, 2))
    pad_zero = torch.all(m[..., None] | (fv.view(torch.int32) == 0), dim=(1, 2, 3))
    nv_ok = torch.all((nv == 0) | ((nv >= 3) & (nv <= S)), dim=1)
    live = (nv >= 3).sum(1)
    return kept & pad_zero & nv_ok & ((live == 0) | (live >= 4))


def _states(name):
    """Every state the plain fold passes through on a case, plus states
    the fold never makes: a face of 2 vertices, junk in a padding slot."""
    poly, planes, mask = _case(name)
    p = ConvexPoly(*(torch.as_tensor(a) for a in poly))
    planes, mask = torch.as_tensor(planes), torch.as_tensor(mask)
    out = [p]
    for k in range(planes.shape[1]):
        q = clip_poly_plane(out[-1], planes[:, k])
        ok = mask[:, k]
        prev = out[-1]
        out.append(ConvexPoly(torch.where(ok[:, None, None, None], q.face_verts, prev.face_verts),
                              torch.where(ok[:, None], q.n_verts, prev.n_verts),
                              torch.where(ok[:, None, None], q.planes, prev.planes)))
    two = out[0].map(torch.clone)
    two.n_verts[:, 0] = 2
    junk = out[0].map(torch.clone)
    junk.face_verts[:, 1, 6] = 0.25
    return out + [two, junk]


@pytest.mark.parametrize("name", CASES)
def test_plane_that_removes_nothing_is_the_identity_exactly_when_skipped(name):
    """The plain fold's step by a plane that removes no vertex (one clear
    of every vertex, and one through the farthest vertex) returns its input
    bitwise exactly where kernel B1 skips the step, and only there."""
    rng = np.random.default_rng(3)
    seen = set()
    for state in _states(name):
        N = state.n_verts.shape[0]
        n = torch.as_tensor(_normalize(np.concatenate(
            [rng.normal(size=(N, 3)), np.zeros((N, 1))], -1))[:, :3])
        live = state.slot_mask()
        proj = (state.face_verts[..., 0] * n[:, None, None, 0]
                + state.face_verts[..., 1] * n[:, None, None, 1]
                + state.face_verts[..., 2] * n[:, None, None, 2])
        far = torch.where(live, proj, -1e30).flatten(1).amax(1)
        for d in (-far - 0.5, -far):
            plane = torch.cat([n, d[:, None]], 1)
            step = clip_poly_plane(state, plane)
            bits = lambda t: t.view(torch.int32).flatten(1)  # noqa: E731
            same = (torch.all(bits(step.face_verts) == bits(state.face_verts), 1)
                    & torch.all(step.n_verts == state.n_verts, 1)
                    & torch.all(bits(step.planes) == bits(state.planes), 1))
            want = _identity_expected(state, plane)
            np.testing.assert_array_equal(same.numpy(), want.numpy())
            seen.update(want.tolist())
    assert seen == {True, False}


def test_clip_kernel_path_rejects_unsupported_device():
    poly, planes, mask = _case("masked")
    tp = ConvexPoly(*(torch.as_tensor(a).to("meta") for a in poly))
    with pytest.raises(ValueError):
        clip_cuda.clip_planes_batch(tp, torch.as_tensor(planes).to("meta"),
                                    torch.as_tensor(mask).to("meta"))
