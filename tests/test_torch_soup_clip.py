"""The plain version of kernel B10 (``soup_clip_pooled`` on CPU tensors)
against the JAX package's Pallas kernel in interpret mode, and the port's
``clip_polys_by_rows`` and ``fan_triangles`` against the JAX package's.

Cases: the random pools of ``tests/test_soup_clip_pallas.py`` (seeds 0 and
7, and the coplanar triangle of seed 3), a pool of 2,100 lanes in which one
cell straddles the 2,048-lane block boundary with an in-plane triangle on
each side but material beyond the plane on one side only (the kernel's
per-block context), dead lanes and a live lane with the sentinel cell id C,
a pool of 77 lanes, one plane, and a pool with no valid lane. Tolerance:
``n_vert`` and the drop count exactly, the live polygon slots within 1e-5
(the same operations in the same order; the Pallas kernel runs compiled,
where XLA may contract products into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.ops.mesh_clip import clip_polys_by_rows as j_rows
from surtr_tpu.ops.mesh_clip import fan_triangles as j_fans
from surtr_tpu.ops.soup_clip_pallas import soup_clip_pooled_pallas
from surtr_tpu_torch.ops import soup_clip_cuda
from surtr_tpu_torch.ops.mesh_clip import clip_polys_by_rows, fan_triangles
from tests.test_soup_clip_pallas import _random_case


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
