"""Kernel B10's group variant (``soup_fold_group_kernel`` in csrc/soup_clip.cu)
mirrored in numpy on the CPU: a group of G threads a lane (G the least power
of two >= S, at least 4), 32 / G lanes a warp, thread s holding slot s. Per
plane: the kept, off-plane, exit and enter masks as bit masks (the group's
ballots), the run count, starts and start position by popcounts, the
rotated emission from slot (a + s) mod nv by a conditional subtraction, and
the exit and enter points as S-term sums in slot order from +0, or, where
every group of the warp has at most one exit and one enter slot and finite
cut points, +0 plus that slot's cut; a warp skips a plane that keeps every
live corner of its lanes. Every product and sum is float32, rounded in the
kernel's order (numpy does not contract them).

The mirror equals the plain version (``soup_clip_pooled_reference``) bit for
bit in every slot, ``n_vert`` and the drop count at S = 3, 5, 16 and 32, on
one pool that holds chip_smoke's multirun pool at K = 32 (lanes crossing a
plane three and four times: the full sums), a triangle in a plane of its
cell (the in-plane drop) and a cell that straddles the 2,048-lane block of
the in-plane context with material beyond its plane on one side only. On a
small pool it agrees with the JAX package's ``soup_clip_pooled_pallas`` at
``poly_slots=16`` in interpret mode as tests/test_torch_soup_clip.py holds
the S = 8 plain version to it: ``n_vert`` and the drops exactly, the live
slots within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from surtr_tpu.ops.soup_clip_pallas import soup_clip_pooled_pallas
from surtr_tpu_torch.ops import soup_clip_cuda
from tests.test_soup_clip_pallas import _random_case
from torch_threads import bounded_threads  # noqa: F401 (autouse)

F32 = np.float32


def popc(b, G):
    return sum((b >> q) & 1 for q in range(G))


def ballot(p):
    """A group's ballot: bit s of a (lanes, G) bool array."""
    return (p.astype(np.int64) << np.arange(p.shape[1])).sum(1)


def in_plane_context(tri, valid, cell, planes, pmask, tol):
    """(P, K) "this plane removes material" as the context pass computes it:
    any valid lane of the cell in the same ``block_lanes`` block with an
    original corner beyond the live plane."""
    P = tri.shape[0]
    C, K = pmask.shape
    inside = (cell >= 0) & (cell < C)
    cid = np.clip(cell, 0, C - 1)
    pl = planes[cid]
    d = ((tri[:, None, :, 0] * pl[:, :, None, 0] + tri[:, None, :, 1] * pl[:, :, None, 1])
         + tri[:, None, :, 2] * pl[:, :, None, 2]) + pl[:, :, None, 3]
    beyond = ~np.isnan(d).any(-1) & (d > F32(tol)).any(-1)
    rm = beyond & valid[:, None] & pmask[cid] & inside[:, None]
    key = np.arange(P) // soup_clip_cuda.block_lanes(P) * C + cid
    table = np.zeros((key.max() + 1, K), bool)
    np.logical_or.at(table, key, rm)
    return table[key] & inside[:, None]


def group_fold(tri, valid, cell, planes, pmask, S, tol=1e-6):
    """(poly (P, S, 3), n_vert (P,), drops) as the group kernel computes them."""
    G = soup_clip_cuda.group_lanes(S)
    L = 32 // G                                     # lanes a warp
    P0 = tri.shape[0]
    C, K = pmask.shape
    P = -(-P0 // L) * L                             # whole warps; the rest do not exist
    tol = F32(tol)
    ctx = np.zeros((P, K), bool)
    ctx[:P0] = in_plane_context(tri, valid, cell, planes, pmask, tol)
    inside = np.zeros(P, bool)
    inside[:P0] = (cell >= 0) & (cell < C)
    cid = np.zeros(P, np.int64)
    cid[:P0] = np.clip(cell, 0, C - 1)
    poly = np.zeros((P, G, 3), F32)
    poly[:P0, :3] = tri
    nv = np.zeros(P, np.int64)
    nv[:P0] = np.where(valid, 3, 0)
    done = ~inside
    mrun = np.zeros(P, np.int64)
    slot = np.arange(G)
    GM = (1 << G) - 1
    wall = lambda b: np.repeat(b.reshape(-1, L).all(1), L)  # noqa: E731
    for k in range(K):
        live = ~done & pmask[cid, k] & inside
        empty = live & (nv == 0)                    # an empty polygon: zeros, done
        poly[empty] = 0
        done |= empty
        live &= ~empty
        ix = np.nonzero(np.repeat(live.reshape(-1, L).any(1), L))[0]   # warps with a live lane
        if not ix.size:
            continue
        pl = np.where(inside[ix, None], planes[cid[ix], k], F32(0))
        pg, n, lv, rm = poly[ix], nv[ix], live[ix], ctx[ix, k]
        lane = np.arange(ix.size)[:, None]
        ds = ((pg[..., 0] * pl[:, None, 0] + pg[..., 1] * pl[:, None, 1])
              + pg[..., 2] * pl[:, None, 2]) + pl[:, None, 3]
        m = slot < n[:, None]
        bk = ballot(m & (ds <= tol))
        bo = ballot(m & ~(np.abs(ds) <= tol))
        same = ~lv | ((bk == (1 << n) - 1) & ~((bo == 0) & (n > 0) & rm))
        step = lv & ~wall(same)                     # a warp skips a plane no lane needs
        src = np.where((slot == n[:, None] - 1) | (slot + 1 >= S), 0, slot + 1)
        v = pg[lane, src]
        dn = ((v[..., 0] * pl[:, None, 0] + v[..., 1] * pl[:, None, 1])
              + v[..., 2] * pl[:, None, 2]) + pl[:, None, 3]
        denom = dn - ds
        safe = np.where(np.abs(denom) > F32(1e-30), denom, F32(1))
        cut = (pg * dn[..., None] - v * ds[..., None]) / safe[..., None]
        cex = m & (ds < -tol) & (dn > tol)
        cen = m & (ds > tol) & (dn < -tol)
        bx, bn = ballot(cex), ballot(cen)
        ex, en = (bx != 0).astype(np.int64), (bn != 0).astype(np.int64)
        mcnt = popc(bk, G)
        klast = np.where(n > 0, (bk >> np.maximum(n - 1, 0)) & 1, 0)
        st = bk & ~(((bk << 1) | klast) & GM)
        nstarts = popc(st, G)
        a = sum(q * ((st >> q) & 1) for q in range(G))
        # The exit and enter sums: one crossing's cut, or all S terms.
        fin = (slot >= S) | np.isfinite(cut).all(-1)
        one = wall(fin.all(1) & (popc(bx, G) <= 1) & (popc(bn, G) <= 1))
        first = lambda b: np.log2(np.maximum(b & -b, 1)).astype(np.int64)  # noqa: E731
        exit_p = np.where(ex[:, None] > 0, F32(0) + cut[lane[:, 0], first(bx)], F32(0))
        enter_p = np.where(en[:, None] > 0, F32(0) + cut[lane[:, 0], first(bn)], F32(0))
        if not one.all():
            exit_all = np.zeros((ix.size, 3), F32)
            enter_all = np.zeros((ix.size, 3), F32)
            for q in range(S):
                exit_all = exit_all + cex[:, q, None].astype(F32) * cut[:, q]
                enter_all = enter_all + cen[:, q, None].astype(F32) * cut[:, q]
            exit_p = np.where(one[:, None], exit_p, exit_all)
            enter_p = np.where(one[:, None], enter_p, enter_all)
        # Emit [rotated kept run, exit, enter].
        nvc = np.maximum(n, 1)[:, None]
        t = a[:, None] + slot
        t = np.where(t >= nvc, t - nvc, t)
        t = np.where(t >= nvc, t % nvc, t)
        rot = pg[lane, t]
        s_ = slot[None, :, None]
        mc, exn = mcnt[:, None, None], ex[:, None, None]
        out = np.where(s_ < mc, rot, np.where((s_ == mc) & (exn > 0), exit_p[:, None],
                       np.where((s_ == mc + exn) & (en[:, None, None] > 0), enter_p[:, None],
                                F32(0))))
        n_out = np.minimum(mcnt + ex + en, S)
        n_out = np.where((bo == 0) & (n > 0) & rm, 0, n_out)
        multi = nstarts > 1
        n_out = np.where(multi | (n_out < 3), 0, n_out)
        poly[ix] = np.where(step[:, None, None], out, pg)
        nv[ix] = np.where(step, n_out, n)
        mrun[ix] += step & multi
    return poly[:P0, :S], nv[:P0], int(mrun.sum())


def mixed_pool(K=32):
    """One pool: the straddle case of tests/test_torch_soup_clip.py (lanes
    0-2,099, cells 0-1: an in-plane triangle in each 2,048-lane block, the
    plane removing material in the second only), chip_smoke's multirun pool
    (cells 2-5) and seed 3's coplanar case (cells 6-21), planes padded to K
    masked."""
    from tests.test_torch_soup_clip import _straddle_case

    parts = [_straddle_case(), chip_smoke.soup_multirun_pool(),
             [np.array(a) for a in _random_case(3, coplanar=True)]]
    tris, valid, cell, planes, pmask, off = [], [], [], [], [], 0
    for t, v, c, pl, pm in parts:
        C, k = pm.shape
        tris.append(t)
        valid.append(v)
        cell.append(c.astype(np.int32) + off)
        planes.append(np.concatenate([pl, np.zeros((C, K - k, 4), F32)], 1))
        pmask.append(np.concatenate([pm, np.zeros((C, K - k), bool)], 1))
        off += C
    return [np.concatenate(x) for x in (tris, valid, cell, planes, pmask)]


@pytest.fixture(scope="module")
def pool():
    return mixed_pool()


@pytest.mark.parametrize("S", [3, 5, 16, 32])
def test_group_fold_equals_the_plain_version(pool, S):
    poly, nv, drops = group_fold(*pool, S)
    wp, wn, wd = soup_clip_cuda.soup_clip_pooled_reference(
        *(torch.as_tensor(a) for a in pool), poly_slots=S)
    assert np.array_equal(poly.view(np.int32), wp.numpy().view(np.int32))
    assert np.array_equal(nv, wn.numpy()) and drops == int(wd)
    if S >= 5:      # every case took place: drops, in-plane drops on one side of the block
        assert drops > 0 and int(nv[2001]) == 3 and int(nv[2090]) == 0


def test_group_fold_matches_pallas_interpret():
    tris, valid, cell, planes, pmask = (np.array(a) for a in _random_case(9, P=77))
    poly, nv, drops = group_fold(tris, valid, cell, planes, pmask, 16)
    wpoly, wnv, wdr = soup_clip_pooled_pallas(jnp.asarray(tris), jnp.asarray(valid),
                                              jnp.asarray(cell), jnp.asarray(planes),
                                              jnp.asarray(pmask), poly_slots=16, interpret=True)
    np.testing.assert_array_equal(nv, np.asarray(wnv))
    assert drops == int(wdr)
    live = (np.arange(16)[None, :] < nv[:, None])[..., None]
    np.testing.assert_allclose(np.where(live, poly, 0), np.where(live, np.asarray(wpoly), 0),
                               atol=1e-5)
    assert nv.max() > 3
