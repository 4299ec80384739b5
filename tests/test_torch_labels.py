"""The port's plain triangle-soup labels (the CPU side of kernel B3) against
the JAX package's ``tri_soup_components_batch_pallas`` in interpret mode and
the XLA ``tri_soup_components``. Labels are integers: compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.ops.labels import tri_soup_components as j_labels
from surtr_tpu.ops.labels_pallas import tri_soup_components_batch_pallas
from surtr_tpu_torch.ops import labels_cuda


def _soups(T=16):
    rng = np.random.RandomState(3)
    N = 6
    corners = rng.rand(N, T, 3, 3).astype(np.float32)
    for t in range(T - 1):
        corners[0, t + 1, 0] = corners[0, t, 1]          # one strip
        if t != T // 2 - 1:
            corners[1, t + 1, 0] = corners[1, t, 1]      # two strips
    # Candidate 4: corners equal only after quantization (within tol/2).
    corners[4, 1:, 0] = corners[4, :-1, 2] + 3e-6
    valid = np.ones((N, T), bool)
    valid[2] = False                                      # empty
    valid[3, T // 2:] = False                             # half valid
    return corners, valid


@pytest.mark.parametrize("iters", [None, 2])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_labels_match_reference(iters, ref):
    corners, valid = _soups()
    before = labels_cuda.launches
    got = labels_cuda.tri_soup_components_batch(torch.as_tensor(corners),
                                                torch.as_tensor(valid), iters=iters)
    assert labels_cuda.launches == before
    if ref == "pallas":
        want = tri_soup_components_batch_pallas(jnp.asarray(corners), jnp.asarray(valid),
                                                iters=iters, interpret=True)
    else:
        want = jnp.stack([j_labels(jnp.asarray(corners[i]), jnp.asarray(valid[i]), iters=iters)
                          for i in range(len(corners))])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_labels_at_pipeline_width():
    # T = 64 as in the 1k decomposition (6 rounds): a long strip needs them all.
    # Reference run op by op: compiled, XLA may turn corners / tol into a
    # multiply by 1/tol, which moves values that sit on a rounding boundary
    # of the quantization (the port and its kernel divide, as jnp.round(
    # corners / tol) reads).
    corners, valid = _soups(T=64)
    got = labels_cuda.tri_soup_components_batch(torch.as_tensor(corners), torch.as_tensor(valid))
    with jax.disable_jit():
        want = jnp.stack([j_labels(jnp.asarray(corners[i]), jnp.asarray(valid[i]), method="jump")
                          for i in range(len(corners))])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[0] == 0).all()            # the strip is one component
    assert (got.numpy()[2] == 64).all()           # invalid triangles get T
