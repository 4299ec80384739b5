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
