"""The port's plain ICH and tetra hull (the CPU sides of kernels B2 and B4's
extreme-point picks) against the JAX package: ``ich_pallas`` in interpret
mode and the XLA ``ich`` / ``tetra_hull``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.io.models import get_model
from surtr_tpu.ops.hull import ich as j_ich
from surtr_tpu.ops.hull import tetra_hull as j_tetra_hull
from surtr_tpu.ops.hull_pallas import ich_pallas
from surtr_tpu_torch.ops import hull_cuda
from surtr_tpu_torch.ops.hull import tetra_hull


def _clouds():
    rng = np.random.RandomState(7)
    return {
        "cube": np.asarray(get_model("cube")[0], np.float32),
        "gauss40": rng.randn(40, 3).astype(np.float32),
        "box100": (rng.rand(100, 3) * np.asarray([2.0, 1.0, 0.5])).astype(np.float32),
    }


@pytest.fixture(scope="module")
def hulls():
    out = {}
    for name, pts in _clouds().items():
        m = np.ones(len(pts), bool)
        before = hull_cuda.launches
        got = hull_cuda.ich(torch.as_tensor(pts), torch.as_tensor(m), limit=20)
        assert hull_cuda.launches == before  # CPU tensors run the plain hull
        out[name] = (
            got,
            ich_pallas(jnp.asarray(pts), jnp.asarray(m), limit=20, interpret=True),
            j_ich(jnp.asarray(pts), jnp.asarray(m), limit=20),
        )
    return out


@pytest.mark.parametrize("cloud", ["cube", "gauss40", "box100"])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_ich_matches_reference(hulls, cloud, ref):
    got, pallas, xla = hulls[cloud]
    want = pallas if ref == "pallas" else xla
    # Face slots follow the stable free-slot order: compared slot for slot.
    np.testing.assert_array_equal(got["face_valid"].numpy(), np.asarray(want["face_valid"]))
    np.testing.assert_allclose(got["inner"].numpy(), np.asarray(want["inner"]), rtol=1e-6)
    fv = got["face_valid"].numpy()
    # Unit normals from the same index triples; f32 cross-product rounding.
    np.testing.assert_allclose(got["normals"].numpy()[fv], np.asarray(want["normals"])[fv],
                               rtol=1e-5, atol=1e-6)
    if ref == "xla":
        np.testing.assert_array_equal(got["faces"].numpy()[fv], np.asarray(want["faces"])[fv])


def test_ich_masked_points_are_ignored():
    pts = _clouds()["gauss40"]
    m = np.ones(len(pts), bool)
    m[::3] = False
    got = hull_cuda.ich(torch.as_tensor(pts), torch.as_tensor(m), limit=12)
    want = j_ich(jnp.asarray(pts), jnp.asarray(m), limit=12)
    np.testing.assert_array_equal(got["face_valid"].numpy(), np.asarray(want["face_valid"]))
    used = np.unique(got["faces"].numpy()[got["face_valid"].numpy()])
    assert m[used].all()


@pytest.mark.parametrize("degenerate", [False, True])
def test_tetra_hull_matches_xla(degenerate):
    rng = np.random.RandomState(5)
    pts = rng.randn(6, 30, 3).astype(np.float32)
    mask = rng.rand(6, 30) > 0.3
    if degenerate:
        mask[3, 4:] = False      # too few points
        mask[4] = False          # nothing
        pts[5, :, 2] = 0.0       # coplanar: the fourth extreme adds no volume
    got = tetra_hull(torch.as_tensor(pts), torch.as_tensor(mask))
    want = jax.vmap(j_tetra_hull)(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(got["face_valid"].numpy(), np.asarray(want["face_valid"]))
    np.testing.assert_allclose(got["inner"].numpy(), np.asarray(want["inner"]), atol=1e-6)
    np.testing.assert_allclose(got["normals"].numpy(), np.asarray(want["normals"]), atol=1e-5)
