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
from surtr_tpu_torch.ops import labels, labels_cuda
from torch_threads import bounded_threads  # noqa: F401 (autouse)


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


def _strips(T=64):
    """Three 64-triangle strips whose consecutive triangles share a corner,
    their indices in reversed, bit-reversed and random order, and a
    complete graph (one corner shared by all): the reversed strip closes
    only in its 6th round, the bit-reversed one is still open after it."""
    rng = np.random.RandomState(11)
    bits = T.bit_length() - 1
    orders = [np.arange(T)[::-1],
              np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(T)]),
              rng.permutation(T)]
    corners = np.zeros((len(orders) + 1, T, 3, 3), np.float32)
    for n, order in enumerate(orders):
        P = rng.rand(T + 1, 3).astype(np.float32)
        Q = rng.rand(T, 3).astype(np.float32)
        for k in range(T):
            corners[n, order[k]] = [P[k], Q[k], P[k + 1]]
    corners[-1] = rng.rand(T, 3, 3)
    corners[-1, :, 1] = 0.5
    return corners, np.ones(corners.shape[:2], bool)


@pytest.mark.parametrize("iters", [None, 1, 2, 3])
def test_permuted_strip_labels_match_pallas(iters):
    # Unclosed labels (iters 1-3, and the bit-reversed strip at 6 rounds)
    # must still match round for round: the kernel's early exit stops only
    # at a round that changes no label.
    corners, valid = _strips()
    got = labels_cuda.tri_soup_components_batch(torch.as_tensor(corners), torch.as_tensor(valid),
                                                iters=iters)
    want = tri_soup_components_batch_pallas(jnp.asarray(corners), jnp.asarray(valid),
                                            iters=iters, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if iters is None:
        assert (got.numpy()[0] == 0).all() and (got.numpy()[3] == 0).all()
        assert len(np.unique(got.numpy()[1])) > 1


def test_rounds_run_stop_at_the_first_unchanged_round():
    corners, valid = _strips()
    valid[2] = False
    c, v = torch.as_tensor(corners), torch.as_tensor(valid)
    run = labels.label_rounds_run(c, v)
    # Reversed strip: all 6 rounds; bit-reversed: 6 (still open); empty: 0;
    # the complete graph closes in round 1 and round 2 changes nothing.
    assert run.tolist() == [6, 6, 0, 2]
    for it in (1, 2, 3):
        assert labels.label_rounds_run(c, v, iters=it).tolist() == [it, it, 0, min(it, 2)]
    # Stopping there returns the labels of all the rounds.
    for n in range(4):
        r = max(int(run[n]), 1)
        np.testing.assert_array_equal(labels.tri_soup_components(c[n], v[n], iters=r).numpy(),
                                      labels.tri_soup_components(c[n], v[n]).numpy())


def test_quantize_is_a_true_division_on_rounding_boundaries():
    # Corners whose x / tol is exactly k + 1/2 in float32: a product with
    # the rounded reciprocal (which the card takes for a Python divisor)
    # moves some of them to the other integer; quantize divides.
    tol = np.float32(1e-5)
    xs = []
    for k in range(1000, 1400):
        x = np.float32((k + 0.5) * float(tol))
        for c in (x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1))):
            if c / tol == np.float32(k + 0.5):
                xs.append(c)
                break
    xs = np.array(xs, np.float32)
    assert len(xs) > 100
    want = np.rint(xs / tol).astype(np.int32)
    got = labels.quantize(torch.as_tensor(xs), float(tol)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.rint(xs * (np.float32(1) / tol)).astype(np.int32) != want).any()


def _vertex_labels(corners, valid, iters=None, tol=1e-5):
    """A plain emulation of B3's vertex variant (csrc/labels.cu
    ``labels_vertex_kernel``): vertex ids from the quantized triples; per
    round vmin[v] = the minimum old label of the valid triangles with a
    corner at v, each valid triangle's relaxed label the minimum of its
    three vmin, then the pointer jump on the relaxed labels; stop at the
    first round that changes no label, at most ``label_rounds``. Returns
    the labels and the rounds run a soup."""
    corners, valid = torch.as_tensor(corners), torch.as_tensor(valid)
    N, T = valid.shape
    q = labels.quantize(corners, tol).reshape(N, 3 * T, 3)
    out, runs = [], []
    for n in range(N):
        lab = torch.where(valid[n], torch.arange(T, dtype=torch.int32), T)
        vid = torch.unique(q[n], dim=0, return_inverse=True)[1].reshape(T, 3)
        run = 0
        for _ in range(labels.label_rounds(T, iters) if bool(valid[n].any()) else 0):
            run += 1
            vmin = torch.full((3 * T,), T, dtype=torch.int32).scatter_reduce(
                0, vid[valid[n]].reshape(-1), lab[valid[n]].repeat_interleave(3), "amin")
            relaxed = torch.where(valid[n], vmin[vid].amin(dim=1), T)
            nxt = torch.where(valid[n], torch.minimum(relaxed, relaxed[relaxed.clamp(max=T - 1)]), T)
            changed = bool((nxt != lab).any())
            lab = nxt
            if not changed:
                break
        out.append(lab)
        runs.append(run)
    return torch.stack(out), runs


def _vertex_soups(T=64, tol=1e-5):
    """Strips (reversed, bit-reversed, random and index order) and a fan
    whose triangles share corners (a vertex of all T triangles), invalid
    triangles cutting strips, an all-invalid soup, a strip scaled past the
    corner keys' 21-bit range (|x| / tol > 2^20), and two strips whose
    corners lie 2^21 quanta apart in x: equal in their low 21 bits only."""
    rng = np.random.RandomState(19)
    strips = _strips(T)[0]
    corners = np.concatenate([strips, rng.rand(4, T, 3, 3).astype(np.float32)])
    corners[4, 1:, 0] = corners[4, :-1, 2]                   # a strip in index order
    corners[5] = strips[0] * np.float32(64.0)                # quantized past 2^20
    h = T // 2
    base = rng.rand(h, 3, 3).astype(np.float32)
    base[1:, 0] = base[:-1, 2]
    corners[6, :h] = base
    corners[6, h:] = base
    corners[6, h:, :, 0] += np.float32((1 << 21) * tol)
    valid = np.ones(corners.shape[:2], bool)
    valid[0, ::7] = False
    valid[4, T // 3:2 * T // 3] = False                       # cuts the strip in two
    valid[7] = False
    return corners, valid


@pytest.mark.parametrize("iters", [None, 1, 2, 3])
def test_vertex_rounds_match_pallas(iters):
    # The vertex variant's reformulation gives the JAX kernel's labels bit
    # for bit, also where the rounds stop before the labels close, and runs
    # the rounds the block kernel's early exit runs.
    corners, valid = _vertex_soups()
    got, runs = _vertex_labels(corners, valid, iters=iters)
    want = tri_soup_components_batch_pallas(jnp.asarray(corners), jnp.asarray(valid),
                                            iters=iters, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c, v = torch.as_tensor(corners), torch.as_tensor(valid)
    assert runs == labels.label_rounds_run(c, v, iters=iters).tolist()
    if iters is None:
        lab = got.numpy()
        assert (lab[3] == 0).all() and (lab[5] == 0).all()   # the fan; the scaled strip
        assert (lab[4, :21] == 0).all() and (lab[4, 42:] == 42).all()   # the strip, cut
        assert (lab[6, :32] == 0).all() and (lab[6, 32:] == 32).all()   # not joined
        assert (lab[7] == 64).all()
