"""The port's plain ICH and tetra hull (the CPU sides of kernels B2 and B4's
extreme-point picks) against the JAX package: ``ich_pallas`` in interpret
mode and the XLA ``ich`` / ``tetra_hull``; the plain batched hull
``ich_batch`` against the vmapped XLA ``ich`` on degenerate sets.

The hulls of ``test_ich_matches_reference`` are computed on the JAX side in
a child process with ``--xla_cpu_max_isa=AVX`` (ROADMAP C5): on an
AVX2/AVX-512 host XLA:CPU contracts products into FMAs, which moves the
greedy pick between the near-equal priorities of the sphere's points.
Without FMA both sides round every product. Run as a script
(``python tests/test_torch_hull.py OUT.npz``) it writes the JAX side.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.io.models import get_model, icosphere
from surtr_tpu.ops.hull import ich as j_ich
from surtr_tpu.ops.hull import tetra_hull as j_tetra_hull
from surtr_tpu.ops.hull_pallas import ich_pallas
from surtr_tpu_torch.ops import hull_cuda
from surtr_tpu_torch.ops.hull import tetra_hull
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def _clouds():
    rng = np.random.RandomState(7)
    grid = np.stack(np.meshgrid(*[np.arange(3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {
        "cube": np.asarray(get_model("cube")[0], np.float32),
        "gauss40": rng.randn(40, 3).astype(np.float32),
        "box100": (rng.rand(100, 3) * np.asarray([2.0, 1.0, 0.5])).astype(np.float32),
        # The sphere decomposition's hull input: 162 points, many near-equal
        # priorities.
        "sphere": np.asarray(icosphere(2)[0], np.float32),
        # A 3 x 3 x 3 integer grid: exact ties among the extreme points and
        # among the priorities (integer volumes), decided by the lowest index.
        "ties": grid.astype(np.float32),
    }


def _tail_batch():
    """A batch for the batched hull's degenerate sets: live points only at
    the end of the pool (1, 2, 3 and exactly 4 of them), so the masked slots
    below them win the NEG ties once the live points are used up; one set
    all masked; 70 live points (more than a warp's lanes twice over); 70% at
    random; a coplanar set."""
    rng = np.random.RandomState(11)
    P = 80
    pts = rng.randn(8, P, 3).astype(np.float32)
    mask = np.zeros((8, P), bool)
    for b, n in enumerate((1, 2, 3, 4)):
        mask[b, P - n:] = True
    mask[5, 10:] = True
    mask[6] = rng.rand(P) > 0.3
    mask[7] = rng.rand(P) > 0.2
    pts[7, :, 2] = 0.5
    return pts, mask


BATCH_LIMITS = (8, 20, 64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = ("pallas", "xla")


def _jax_hulls():
    """``ich_pallas`` (interpret) and the XLA ``ich`` of every cloud, and the
    vmapped XLA ``ich`` of ``_tail_batch`` at each of ``BATCH_LIMITS``
    (F = 20, 44 and 132), flat."""
    out = {}
    for name, pts in _clouds().items():
        m = jnp.ones(len(pts), bool)
        refs = (ich_pallas(jnp.asarray(pts), m, limit=20, interpret=True),
                j_ich(jnp.asarray(pts), m, limit=20))
        for ref, r in zip(REFS, refs):
            out.update({f"{name}/{ref}/{k}": np.asarray(v) for k, v in r.items()})
    pts, mask = _tail_batch()
    for limit in BATCH_LIMITS:
        r = jax.vmap(lambda p, m, limit=limit: j_ich(p, m, limit=limit))(jnp.asarray(pts),
                                                                         jnp.asarray(mask))
        out.update({f"batch{limit}/xla/{k}": np.asarray(v) for k, v in r.items()})
    return out


@pytest.fixture(scope="module")
def hulls(tmp_path_factory):
    path = tmp_path_factory.mktemp("hull") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(path)
    out = {}
    for name, pts in _clouds().items():
        m = np.ones(len(pts), bool)
        before = hull_cuda.launches
        got = hull_cuda.ich(torch.as_tensor(pts), torch.as_tensor(m), limit=20)
        assert hull_cuda.launches == before  # CPU tensors run the plain hull
        want = [{k.rsplit("/", 1)[1]: data[k] for k in data.files if k.startswith(f"{name}/{ref}/")}
                for ref in REFS]
        out[name] = (got, *want)
    pts, mask = _tail_batch()
    for limit in BATCH_LIMITS:
        before = hull_cuda.launches
        got = hull_cuda.ich_batch(torch.as_tensor(pts), torch.as_tensor(mask), limit=limit)
        assert hull_cuda.launches == before
        pre = f"batch{limit}/xla/"
        out[f"batch{limit}"] = (got, {k[len(pre):]: data[k] for k in data.files
                                      if k.startswith(pre)})
    return out


@pytest.mark.parametrize("cloud", ["cube", "gauss40", "box100", "sphere", "ties"])
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


@pytest.mark.parametrize("limit", BATCH_LIMITS)
def test_ich_batch_degenerate_sets_match_vmapped_xla(hulls, limit):
    """The plain batched hull (kernel B2's batched entry on the CPU) against
    the JAX package's vmapped XLA ``ich`` on ``_tail_batch``, with the
    one-set test's tolerances: face slots, face_valid and the valid faces'
    corners exactly, inner and the valid normals to float32 rounding."""
    got, want = hulls[f"batch{limit}"]
    assert got["faces"].shape == (8, 2 * limit + 4, 3)
    np.testing.assert_array_equal(got["face_valid"].numpy(), want["face_valid"])
    fv = got["face_valid"].numpy()
    np.testing.assert_array_equal(got["faces"].numpy()[fv], want["faces"][fv])
    np.testing.assert_allclose(got["inner"].numpy(), want["inner"], rtol=1e-6)
    np.testing.assert_allclose(got["normals"].numpy()[fv], want["normals"][fv], rtol=1e-5,
                               atol=1e-6)
    # 1 or 2 live points and none span no area, 3 span the seed triangle
    # (twice), exactly 4 the seed tetrahedron.
    assert fv.sum(1)[:5].tolist() == [0, 0, 2, 4, 0] and fv[5].sum() > 4


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


if __name__ == "__main__":
    np.savez(sys.argv[1], **_jax_hulls())
