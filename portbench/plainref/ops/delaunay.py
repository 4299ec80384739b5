"""3-D Delaunay tetrahedralization (Bowyer–Watson) and its Voronoi dual
edges (counterpart of ``surtr_tpu/ops/delaunay.py``; the reference's
header-only DT3D, dead code on its shipping path but kept as a capability).

A padded tet table (T, 4) with a valid mask, a super-tetrahedron in the
last four rows of the extended point array, and one Python-loop iteration
per inserted point over masked tensor ops on the input's device: the
cavity (tets whose circumsphere holds the point) is removed and its
boundary faces (faces found once among the cavity's) are joined to the new
point in the free slots, in stable slot order. Plain PyTorch: the JAX
package has no Pallas kernel here. The circumcentres go through
``torch.linalg`` (``det`` and ``solve_ex``, where the JAX package takes
``jnp.linalg.det`` and ``solve``).
"""

from __future__ import annotations

import torch

BIG = 3.4e38
_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def circumcenter(tets_pts: torch.Tensor):
    """Circumcentre and squared radius of tetrahedra (..., 4, 3): solves
    2(A - d)ᵀ c = |A|² − |d|². A degenerate tet (|det| <= 1e-20) gets
    centre 0 and r2 = -1, so it never captures a point."""
    a, b, c, d = (tets_pts[..., i, :] for i in range(4))
    M = torch.stack([a - d, b - d, c - d], dim=-2) * 2.0
    rhs = torch.stack([sq_norm(a) - sq_norm(d), sq_norm(b) - sq_norm(d),
                       sq_norm(c) - sq_norm(d)], dim=-1)
    det = torch.linalg.det(M)
    ok = torch.abs(det) > 1e-20
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    Msafe = torch.where(ok[..., None, None], M, eye)
    center = torch.linalg.solve_ex(Msafe, rhs[..., None])[0][..., 0]
    center = torch.where(ok[..., None], center, torch.zeros_like(center))
    r2 = torch.where(ok, sq_norm(center - a), torch.full_like(det, -1.0))
    return center, r2


def sq_norm(r: torch.Tensor) -> torch.Tensor:
    """Σ r_j² over the last axis, added in index order."""
    s = r[..., 0] * r[..., 0]
    for j in range(1, r.shape[-1]):
        s = s + r[..., j] * r[..., j]
    return s


def cavity_boundary(simplices: torch.Tensor, inside: torch.Tensor, local, n_points: int):
    """Faces of the cavity's simplices found exactly once among them.

    simplices (T, k) indices into ``n_points`` points, inside (T,) the
    cavity, ``local`` the k facets as index tuples. Returns (facets (T·k, k-1) sorted vertex
    indices, boundary (T·k,) bool). Each facet is keyed by its sorted
    indices and the keys sorted, so a facet's twin is its neighbour in the
    sorted order: the JAX package's all-pairs facet comparison, counted in
    O(T log T)."""
    T = simplices.shape[0]
    idx = torch.as_tensor(local, device=simplices.device)
    facets = torch.sort(simplices[:, idx].long(), dim=-1).values.reshape(T * len(local), -1)
    fmask = inside.repeat_interleave(len(local))
    key = facets[:, 0]
    for j in range(1, facets.shape[1]):
        key = key * n_points + facets[:, j]
    # Facets outside the cavity get distinct negative keys: no twin.
    key = torch.where(fmask, key, -1 - torch.arange(key.shape[0], device=key.device))
    sk, order = torch.sort(key)
    eq = sk[1:] == sk[:-1]
    dup = torch.zeros_like(fmask)
    dup[1:] |= eq
    dup[:-1] |= eq
    once = torch.empty_like(fmask)
    once[order] = ~dup
    return facets, fmask & once


def insert_cavities(simplices, valid, centers, r2, pts, mask, first: int, circum, local):
    """The Bowyer–Watson insertion loop shared by the 2-D and 3-D
    triangulations: for each point i < ``first`` (a masked point changes
    nothing) the cavity is removed and its boundary facets joined to i in
    the free slots, invalid slots first in slot order. Returns the final
    (simplices, valid, centers, r2)."""
    T = simplices.shape[0]
    dev = pts.device
    trash_s = torch.zeros((1, simplices.shape[1]), dtype=simplices.dtype, device=dev)
    trash_v = torch.zeros((1,), dtype=torch.bool, device=dev)
    for i in range(first):
        inside = valid & (sq_norm(centers - pts[i]) <= r2) & mask[i]
        any_cav = torch.any(inside)
        facets, boundary = cavity_boundary(simplices, inside, local, pts.shape[0])
        new = torch.cat([facets.to(simplices.dtype),
                         torch.full((facets.shape[0], 1), i, dtype=simplices.dtype, device=dev)],
                        dim=1)
        valid_mid = valid & ~inside
        free_order = torch.sort(valid_mid.to(torch.int8), stable=True).indices
        bz = boundary.to(torch.int64)
        rank = torch.cumsum(bz, 0) - bz
        slot = free_order[torch.clamp(rank, max=T - 1)]
        wr = boundary & any_cav
        tgt = torch.where(wr, slot, torch.full_like(slot, T))
        s2 = torch.cat([simplices, trash_s])
        s2[tgt] = new
        s2 = s2[:T]
        v2 = torch.cat([valid_mid, trash_v])
        v2[tgt] = wr
        v2 = v2[:T]
        c2, r22 = circum(pts[s2.long()])
        simplices = torch.where(any_cav, s2, simplices)
        valid = torch.where(any_cav, v2, valid)
        centers = torch.where(any_cav, c2, centers)
        r2 = torch.where(any_cav, r22, r2)
    return simplices, valid, centers, r2


def super_points(points, mask, corners, factor):
    """The extended point array: the masked cloud's box centre plus
    ``factor`` times its largest extent (plus 1) times ``corners``."""
    big = torch.tensor(BIG, dtype=points.dtype, device=points.device)
    m = mask[:, None]
    lo = torch.amin(torch.where(m, points, big), dim=0)
    hi = torch.amax(torch.where(m, points, -big), dim=0)
    center = (lo + hi) / 2
    scale = torch.amax(hi - lo) * factor + 1.0
    sup = center + scale * torch.tensor(corners, dtype=points.dtype, device=points.device)
    return torch.cat([points, sup])


@torch.no_grad()
def delaunay3d(points: torch.Tensor, mask: torch.Tensor, max_tets: int | None = None):
    """Incremental Bowyer–Watson. points (N, 3) padded, mask (N,).

    Returns dict with tets (T, 4) i32 indices into the extended points
    (N + 4, 3) whose last 4 rows are the super-tetrahedron, T = max(8N, 64)
    by default; tet_valid (T,) without, and tet_valid_all (T,) with, the
    tets that touch the super-tetrahedron (the Voronoi dual reads the
    latter); circumcenters (T, 3) and r2 (T,)."""
    N = points.shape[0]
    dev = points.device
    pts = super_points(points, mask, [[2.5, -1.0, -1.0], [-2.5, -1.0, -1.0], [0.0, 3.0, -1.0],
                                [0.0, 0.0, 3.5]], 8.0)
    T = max_tets if max_tets is not None else max(8 * N, 64)
    tets = torch.zeros((T, 4), dtype=torch.int32, device=dev)
    tets[0] = torch.arange(N, N + 4, dtype=torch.int32, device=dev)
    valid = torch.zeros((T,), dtype=torch.bool, device=dev)
    valid[0] = True
    cc, r2 = circumcenter(pts[tets.long()])
    tets, valid, cc, r2 = insert_cavities(tets, valid, cc, r2, pts, mask, N, circumcenter,
                                          _FACES)
    touches_super = torch.any(tets >= N, dim=1)
    return {
        "points": pts,
        "tets": tets,
        "tet_valid": valid & ~touches_super,
        "tet_valid_all": valid,
        "circumcenters": cc,
        "r2": r2,
    }


def voronoi_dual_edges(dt: dict):
    """Voronoi dual: edges between the circumcentres of face-adjacent valid
    tets (reference Voronoi(dt)). Returns (edges (4T, 2, 3), edge_mask
    (4T,)): one slot per tet face, each shared face emitted by its lower
    tet. Builds the (4T)² face-equality table, as the JAX package does."""
    tets, valid, cc = dt["tets"], dt["tet_valid"], dt["circumcenters"]
    T = tets.shape[0]
    dev = tets.device
    idx = torch.as_tensor(_FACES, device=dev)
    faces = torch.sort(tets[:, idx], dim=-1).values.reshape(T * 4, 3)
    fmask = valid.repeat_interleave(4)
    owner = torch.arange(T, device=dev).repeat_interleave(4)
    same = (torch.all(faces[:, None, :] == faces[None, :, :], dim=-1)
            & fmask[None, :] & fmask[:, None])
    other = torch.where(same & (owner[None, :] != owner[:, None]), owner[None, :],
                        torch.full_like(owner, T)[None, :]).amin(dim=1)
    has = (other < T) & fmask & (owner < other)
    a = cc[owner]
    b = cc[torch.clamp(other, max=T - 1)]
    return torch.stack([a, b], dim=1), has
