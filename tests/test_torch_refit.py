"""The port's plain refit planes (the CPU side of kernel B4) against the JAX
package's ``refit_planes_batch_pallas`` in interpret mode and the vmapped
``refit_planes(limit=4)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.fracture.pipeline import refit_planes as j_refit_planes
from surtr_tpu.ops.refit_pallas import refit_planes_batch_pallas
from surtr_tpu_torch.ops import refit_cuda
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def _pools(Pv):
    rng = np.random.RandomState(5)
    N = 6
    pool = rng.randn(N, Pv, 3).astype(np.float32)
    mask = rng.rand(N, Pv) > 0.3
    mask[3, 3:] = False          # too few points
    mask[4, :] = False           # nothing
    pool[5, :, 1] = 0.25         # coplanar pool: degenerate tetra faces
    return pool, mask


@pytest.mark.parametrize("Pv", [40, 608])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_refit_matches_reference(Pv, ref):
    pool, mask = _pools(Pv)
    before = refit_cuda.launches
    gp, gm = refit_cuda.refit_planes_batch(torch.as_tensor(pool), torch.as_tensor(mask))
    assert refit_cuda.launches == before
    if ref == "pallas":
        wp, wm = refit_planes_batch_pallas(jnp.asarray(pool), jnp.asarray(mask), interpret=True)
    else:
        wp, wm = jax.vmap(lambda v, m: j_refit_planes(v, m, 4))(jnp.asarray(pool), jnp.asarray(mask))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    gm_ = gm.numpy().copy()
    if ref == "pallas":
        # The coplanar pool's fourth pick is a tie among volumes that are
        # zero up to rounding, and the compiled kernel rounds (FMA) unlike
        # the op-by-op XLA reference: its planes are held by support below.
        gm_[5] = False
    # Same extreme picks; plane offsets are supports over O(1) points: f32.
    np.testing.assert_allclose(gp.numpy()[gm_], np.asarray(wp)[gm_], rtol=1e-5, atol=1e-5)
    s = np.einsum("nkd,npd->nkp", gp.numpy()[..., :3], pool) + gp.numpy()[..., 3:4]
    s = np.where(mask[:, None, :], s, -np.inf).max(-1)
    assert np.all(np.abs(s[gm.numpy()]) < 1e-5)


def test_refit_planes_order_and_support():
    pool, mask = _pools(40)
    planes, pm = refit_cuda.refit_planes_batch(torch.as_tensor(pool), torch.as_tensor(mask))
    planes, pm = planes.numpy(), pm.numpy()
    # [4 max; 4 min]: the min planes are the max planes' normals negated.
    np.testing.assert_array_equal(planes[:, 4:, :3], -planes[:, :4, :3])
    s = np.einsum("nkd,npd->nkp", planes[..., :3], pool) + planes[..., 3:4]
    s = np.where(mask[:, None, :], s, -np.inf).max(-1)
    assert np.all(np.abs(s[pm]) < 1e-5)           # every valid slab touches the pool
    assert not pm[3].any() and not pm[4].any()


def _parts(T=64, C=416, seed=9):
    """The cube event's refit shapes (T = 64 triangles, C = 26 x 16 cap
    slots: Pv = 608): one candidate of random triangles and caps, one with
    its triangles masked, one with its caps masked, one with nothing live."""
    rng = np.random.RandomState(seed)
    N = 4
    tris = rng.randn(N, T, 3, 3).astype(np.float32)
    caps = rng.randn(N, C, 3).astype(np.float32)
    tmask = rng.rand(N, T) > 0.5
    cmask = rng.rand(N, C) > 0.8
    tmask[1] = False
    cmask[2] = False
    tmask[3] = False
    cmask[3] = False
    return tris, tmask, caps, cmask


def _bits(x):
    return x.numpy().view(np.int32)


@pytest.mark.parametrize("T,C", [(64, 416), (5, 7)])
def test_refit_from_parts_equals_the_concatenated_pool(T, C):
    args = [torch.as_tensor(a) for a in _parts(T, C)]
    before = refit_cuda.launches
    gp, gm = refit_cuda.refit_planes_from_parts(*args)
    assert refit_cuda.launches == before
    tris, tmask, caps, cmask = args
    pool = torch.cat([tris.reshape(len(tris), -1, 3), caps], 1)
    mask = torch.cat([tmask.repeat_interleave(3, 1), cmask], 1)
    wp, wm = refit_cuda.refit_planes_batch(pool, mask)
    np.testing.assert_array_equal(_bits(gp), _bits(wp))
    np.testing.assert_array_equal(gm.numpy(), wm.numpy())
    assert gm[0].all() and not gm[3].any()


def test_refit_from_parts_matches_pallas_at_the_cube_width():
    tris, tmask, caps, cmask = _parts()
    gp, gm = refit_cuda.refit_planes_from_parts(*[torch.as_tensor(a)
                                                  for a in (tris, tmask, caps, cmask)])
    N = len(tris)
    pool = np.concatenate([tris.reshape(N, -1, 3), caps], 1)
    mask = np.concatenate([np.repeat(tmask, 3, 1), cmask], 1)
    assert pool.shape[1] == 608
    wp, wm = refit_planes_batch_pallas(jnp.asarray(pool), jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    gm_ = gm.numpy()
    np.testing.assert_allclose(gp.numpy()[gm_], np.asarray(wp)[gm_], rtol=1e-5, atol=1e-5)


def test_zero_min_support_is_negative_zero_whatever_the_order():
    # Collinear points through the origin: every tetra face is degenerate,
    # so every normal is zero and each support is (x·0 + y·0) + z·0: -0 for
    # the points in the negative octant, +0 for the others. The zero minimum
    # is -0 (IEEE minimum) in any point order; the maximum offset is
    # -(max + 0) = -0 either way.
    t = np.array([-2.0, -1.0, 1.0, 2.0, 0.5], np.float32)
    pool = (t[:, None] * np.ones(3, np.float32))[None]
    rng = np.random.RandomState(2)
    for order in [np.arange(5), np.arange(5)[::-1], rng.permutation(5)]:
        p = torch.as_tensor(np.ascontiguousarray(pool[:, order]))
        planes, pm = refit_cuda.refit_planes_batch(p, torch.ones((1, 5), dtype=torch.bool))
        off = planes[0, :, 3].numpy()
        assert not pm.any()
        assert (off == 0).all()
        assert np.signbit(off[4:]).all() and np.signbit(off[:4]).all()
    # With no negative-octant point the zero minimum is +0.
    p = torch.as_tensor(pool[:, 2:])
    planes, _ = refit_cuda.refit_planes_batch(p, torch.ones((1, 3), dtype=torch.bool))
    assert not np.signbit(planes[0, 4:, 3].numpy()).any()


@pytest.mark.parametrize("order", ["given", "reversed", "shuffled"])
def test_zero_min_support_sign_matches_pallas(order):
    # The sign of a ±0 tie at the minimum is not fixed by the reference:
    # the JAX package's XLA `refit_planes` takes +0 on this collinear pool,
    # its Pallas kernel (which B4 replaces) -0. The port takes -0 (IEEE
    # minimum), as the Pallas kernel does, in every point order; with no
    # -0 support both take +0.
    t = np.array([-2.0, -1.0, 1.0, 2.0, 0.5], np.float32)
    perm = {"given": np.arange(5), "reversed": np.arange(5)[::-1],
            "shuffled": np.random.RandomState(2).permutation(5)}[order]
    line = (t[perm, None] * np.ones(3, np.float32))
    pools = np.stack([line, np.abs(line)])
    mask = np.ones((2, 5), bool)
    got, _ = refit_cuda.refit_planes_batch(torch.as_tensor(pools), torch.as_tensor(mask))
    want, _ = refit_planes_batch_pallas(jnp.asarray(pools), jnp.asarray(mask), interpret=True)
    got_min, want_min = got.numpy()[:, 4:, 3], np.asarray(want)[:, 4:, 3]
    assert (got_min == 0).all() and (want_min == 0).all()
    np.testing.assert_array_equal(np.signbit(got_min), np.signbit(want_min))
    assert np.signbit(got_min[0]).all() and not np.signbit(got_min[1]).any()
