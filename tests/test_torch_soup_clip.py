"""The plain version of kernel B10 (``soup_clip_pooled`` on CPU tensors)
against the JAX package's Pallas kernel in interpret mode, and the port's
``clip_polys_by_rows`` and ``fan_triangles`` against the JAX package's.

Cases: the random pools of ``tests/test_soup_clip_pallas.py`` (seeds 0 and
7, and the coplanar triangle of seed 3), a pool of 2,100 lanes in which one
cell straddles the 2,048-lane block boundary with an in-plane triangle on
each side but material beyond the plane on one side only (the kernel's
per-block context), dead lanes and a live lane with the sentinel cell id C,
a pool of 77 lanes, one plane, and a pool with no valid lane; and
``chip_smoke.soup_multirun_pool`` at K = 32, whole and cut after a plane
that a lane crosses three or more times, against the Pallas kernel run in
a child process without FMA contraction (``--xla_cpu_max_isa=AVX``: the
pool's distances are rounding noise). Tolerance: ``n_vert`` and the drop
count exactly, the live polygon slots within 1e-5 (the same operations in
the same order; the Pallas kernel runs compiled, where XLA may contract
products into FMAs). The plain version's drop count is also held equal to
the sum of its per-lane drops, the counter kernel B10 adds them into, and
its plane step to the identity, bit for bit, wherever it keeps every live
slot (the steps B10 skips).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.ops.mesh_clip import clip_polys_by_rows as j_rows
from surtr_tpu.ops.mesh_clip import fan_triangles as j_fans
from surtr_tpu.ops.soup_clip_pallas import soup_clip_pooled_pallas
from surtr_tpu_torch.ops import soup_clip_cuda
from surtr_tpu_torch.ops.mesh_clip import _clip_polys_plane, clip_polys_by_rows, fan_triangles
from tests.test_soup_clip_pallas import _random_case
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _straddle_case():
    """Cell 0 on lanes 0-1999 (random), cell 1 on lanes 2000-2099 with one
    live plane z = 0: an in-plane triangle at lane 2001 (block 0, where no
    triangle reaches z > 0) and at lane 2090 (block 1, where triangles cross
    the plane)."""
    tris, valid, cell, planes, pmask = (np.asarray(a).copy() for a in _random_case(5, P=2100,
                                                                                   C=2, K=6))
    cell[:2000], cell[2000:] = 0, 1
    rng = np.random.default_rng(11)
    tris[2000:2048] = rng.uniform(-1, 1, (48, 3, 3))
    tris[2000:2048, :, 2] = -np.abs(tris[2000:2048, :, 2]) - 0.01
    tris[2048:] = rng.uniform(-1, 1, (52, 3, 3))
    flat = np.array([[0.2, 0.0, 0.0], [0.0, 0.3, 0.0], [-0.2, -0.1, 0.0]], np.float32)
    tris[2001] = tris[2090] = flat
    valid[2000:] = True
    planes[1] = 0.0
    planes[1, 0] = [0, 0, 1, 0]
    pmask[1] = False
    pmask[1, 0] = True
    return tris, valid, cell, planes, pmask


def _case(name):
    if name in ("seed0", "seed7"):
        return tuple(np.array(a) for a in _random_case(int(name[4:])))
    if name == "coplanar":
        return tuple(np.array(a) for a in _random_case(3, coplanar=True))
    if name == "straddle":
        return _straddle_case()
    tris, valid, cell, planes, pmask = (np.asarray(a).copy() for a in _random_case(
        {"sentinel": 8, "small": 9, "one_plane": 10, "none_valid": 12}[name],
        P=77 if name == "small" else 300, K=1 if name == "one_plane" else 12))
    if name == "sentinel":
        C = planes.shape[0]
        cell[-40:] = C
        valid[-40:-1] = False
        valid[-1] = True                       # a live lane that reads no planes
    if name == "none_valid":
        valid[:] = False
    return tris, valid, cell, planes, pmask


CASES = ["seed0", "seed7", "coplanar", "straddle", "sentinel", "small", "one_plane", "none_valid"]


def _check_live(got, want, nv):
    S = got.shape[1]
    mask = (np.arange(S)[None, :] < nv[:, None])[..., None]
    np.testing.assert_allclose(np.where(mask, got, 0), np.where(mask, want, 0), atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_plain_b10_matches_pallas_interpret(name):
    tris, valid, cell, planes, pmask = _case(name)
    t = torch.as_tensor
    poly, nv, dr = soup_clip_cuda.soup_clip_pooled(t(tris), t(valid), t(cell), t(planes),
                                                   t(pmask))
    wpoly, wnv, wdr = soup_clip_pooled_pallas(jnp.asarray(tris), jnp.asarray(valid),
                                              jnp.asarray(cell), jnp.asarray(planes),
                                              jnp.asarray(pmask), interpret=True)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(wnv))
    assert int(dr) == int(wdr)
    _check_live(poly.numpy(), np.asarray(wpoly), nv.numpy())
    if name == "straddle":
        # Block 0 has no material beyond z = 0 for cell 1: its in-plane
        # triangle stays; block 1's is dropped.
        assert int(nv[2001]) == 3 and int(nv[2090]) == 0
    if name == "sentinel":
        assert int(nv[-1]) == 3 and not nv[-40:-1].any()
    if name == "none_valid":
        assert not nv.any()


@pytest.mark.parametrize("name", CASES)
def test_clip_polys_by_rows_and_fans_match(name):
    tris, valid, cell, planes, pmask = _case(name)
    C = planes.shape[0]
    rows = np.clip(cell, 0, C - 1)
    pl = np.where((cell < C)[:, None, None], planes[rows], 0).astype(np.float32)
    pm = pmask[rows] & (cell < C)[:, None]
    pstart = np.searchsorted(cell, np.arange(C + 1)).astype(np.int32)
    t = torch.as_tensor
    poly, nv, dr = clip_polys_by_rows(t(tris), t(valid), t(pl), t(pm), seg_starts=t(pstart),
                                      seg_id=t(cell))
    wpoly, wnv, wdr = j_rows(jnp.asarray(tris), jnp.asarray(valid), jnp.asarray(pl),
                             jnp.asarray(pm), seg_starts=jnp.asarray(pstart),
                             seg_id=jnp.asarray(cell))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(wnv))
    assert int(dr) == int(wdr)
    _check_live(poly.numpy(), np.asarray(wpoly), nv.numpy())
    fans, cnt = fan_triangles(poly, nv)
    wfans, wcnt = j_fans(wpoly, wnv)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    live = (np.arange(fans.shape[1])[None] < cnt.numpy()[:, None])[..., None, None]
    np.testing.assert_allclose(np.where(live, fans.numpy(), 0), np.where(live, wfans, 0),
                               atol=1e-5)
    if name == "straddle":
        # The per-cell context sees block 1's material for both triangles.
        assert int(nv[2001]) == 0 and int(nv[2090]) == 0


def test_soup_clip_wrapper_dispatch():
    # CPU tensors take the plain version; nothing else is accepted.
    args = tuple(torch.as_tensor(np.array(a)) for a in _random_case(0, P=50, C=4, K=3))
    before = soup_clip_cuda.launches
    soup_clip_cuda.soup_clip_pooled(*args)
    assert soup_clip_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        soup_clip_cuda.soup_clip_pooled(*(a.to("meta") for a in args))
    assert soup_clip_cuda.block_lanes(77) == 128
    assert soup_clip_cuda.block_lanes(2047) == 2048 and soup_clip_cuda.block_lanes(32768) == 2048


def _multirun_cases():
    """chip_smoke's multirun pool at K = 32, whole and cut after the first
    plane on which a lane crosses three or more times."""
    import chip_smoke

    mr = chip_smoke.soup_multirun_pool()
    most, runs = chip_smoke.soup_crossings(*mr)
    cut = next(k for k, n in enumerate(most) if n >= 3) + 1
    return {"K32": mr, "cut": [mr[0], mr[1], mr[2], mr[3][:, :cut].copy(), mr[4][:, :cut].copy()]}


def _jax_multirun(out_path):
    """Child process: the Pallas kernel in interpret mode on the multirun
    cases, compiled without FMA contraction."""
    res = {}
    for name, case in _multirun_cases().items():
        poly, nv, dr = soup_clip_pooled_pallas(*(jnp.asarray(a) for a in case), interpret=True)
        res[f"{name}/poly"], res[f"{name}/nv"] = np.asarray(poly), np.asarray(nv)
        res[f"{name}/drops"] = np.asarray(dr)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_multirun(tmp_path_factory):
    # The pool's distances are rounding noise: XLA:CPU's FMA contraction on
    # an AVX2/AVX-512 host would move them, so the reference runs AVX-only.
    out = tmp_path_factory.mktemp("soup_multirun") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", ["K32", "cut"])
def test_plain_b10_matches_pallas_on_multiruns(name, jax_multirun):
    # K = 32, lanes crossing a plane three and four times: n_vert and the
    # drops exactly, the live slots within 1e-5.
    import chip_smoke

    case = _multirun_cases()[name]
    most, runs = chip_smoke.soup_crossings(*case)
    assert max(most) >= 3 and sum(runs) > 0
    poly, nv, dr = soup_clip_cuda.soup_clip_pooled(*(torch.as_tensor(a) for a in case))
    np.testing.assert_array_equal(nv.numpy(), jax_multirun[f"{name}/nv"])
    assert int(dr) == int(jax_multirun[f"{name}/drops"]) > 0
    _check_live(poly.numpy(), jax_multirun[f"{name}/poly"], nv.numpy())


@pytest.mark.parametrize("name", ["K32", "seed0", "straddle", "sentinel"])
def test_plain_drop_count_is_the_per_lane_sum(name):
    # The kernel adds each lane's multirun drops into one counter; the plain
    # version's total is that sum, and only lanes that take a fold step
    # drop.
    case = _multirun_cases()["K32"] if name == "K32" else _case(name)
    t = [torch.as_tensor(a) for a in case]
    poly, nv, dr = soup_clip_cuda.soup_clip_pooled_reference(*t)
    poly2, nv2, dr2, (lane_drops, steps) = soup_clip_cuda.soup_clip_pooled_reference(
        *t, per_lane=True)
    assert torch.equal(poly, poly2) and torch.equal(nv, nv2) and int(dr) == int(dr2)
    assert int(lane_drops.sum()) == int(dr)
    assert bool((lane_drops <= steps).all())
    assert bool((steps[~t[1]] == 0).all())
    if name == "K32":
        assert int(dr) > 0


def test_plane_that_keeps_every_slot_is_the_identity():
    # Kernel B10 skips a plane step when, for every lane of a warp, the plane
    # keeps every live slot and the polygon is not an in-plane one in a plane
    # that removes material: the plain step is then the identity, bit for
    # bit. Polygons of 3 to 6 slots (triangles cut by two planes), planes
    # that keep them with the farthest corner at -0.5, -tol/2, 0 and tol,
    # and in-plane polygons with and without removed material.
    rng = np.random.default_rng(31)
    P, tol = 4000, 1e-6
    tri = torch.as_tensor(rng.uniform(-1, 1, (P, 3, 3)).astype(np.float32))
    poly = torch.zeros((P, 8, 3))
    poly[:, :3] = tri
    nv = torch.full((P,), 3, dtype=torch.int32)
    for _ in range(2):
        n = rng.normal(size=(P, 3))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        pl = torch.as_tensor(np.concatenate([n, rng.uniform(-0.5, 0.5, (P, 1))], 1)
                             .astype(np.float32))
        poly, nv, _ = _clip_polys_plane(poly, nv, pl, tol)
    live = nv >= 3
    tail = (torch.arange(8)[None] >= nv[:, None])[..., None].expand_as(poly)
    assert bool((poly.view(torch.int32)[tail & live[:, None, None]] == 0).all())   # +0 past nv
    n = torch.as_tensor(rng.normal(size=(P, 3)).astype(np.float32))
    n = n / torch.linalg.norm(n, dim=1, keepdim=True)
    m = torch.arange(8)[None] < nv[:, None]
    dots = torch.where(m, (poly[..., 0] * n[:, None, 0] + poly[..., 1] * n[:, None, 1])
                       + poly[..., 2] * n[:, None, 2], -np.inf)
    margin = torch.as_tensor(rng.choice([-0.5, -tol / 2, 0.0, tol], P).astype(np.float32))
    flat = torch.arange(P) % 7 == 0                  # in-plane: every live corner within tol
    n = torch.where(flat[:, None], torch.tensor([0.0, 0.0, 1.0]), n)
    poly = torch.where(flat[:, None, None] & m[..., None],
                       torch.cat([poly[..., :2], torch.zeros_like(poly[..., 2:])], -1), poly)
    d = torch.where(flat, torch.zeros(P), margin - dots.amax(1))
    plane = torch.cat([n, d[:, None]], 1)
    for removed in (False, True):
        rm = torch.full((P,), removed)
        p2, n2, mrun = _clip_polys_plane(poly, nv, plane, tol, any_removed=rm)
        dist = (poly[..., 0] * plane[:, None, 0] + poly[..., 1] * plane[:, None, 1]
                + poly[..., 2] * plane[:, None, 2]) + plane[:, None, 3]
        keeps = live & torch.where(m, dist <= tol, True).all(1)
        inplane = torch.where(m, dist.abs() <= tol, True).all(1)
        same = keeps & ~(inplane & rm)
        assert int(same.sum()) > P // 4
        assert torch.equal(p2[same].view(torch.int32), poly[same].view(torch.int32))
        assert torch.equal(n2[same], nv[same]) and not bool(mrun[same].any())
        if removed:
            assert bool((n2[keeps & inplane] == 0).all()) and bool((keeps & inplane).any())


if __name__ == "__main__":
    _jax_multirun(sys.argv[1])
