"""Convex polytope clipping against half-spaces — the plain fold
(counterpart of ``surtr_tpu/ops/clip.py``).

Faces are clipped independently by Sutherland–Hodgman (per slot emit
[v if kept][cut point if the edge crosses], compacted to S), and the cap
face is rebuilt from the cut points: at most CAPS candidates per face,
ordered by atan2 about their centroid in the plane basis (the centroid's
sum and the angle taken in float64, each rounded once to float32, so that
every device orders them alike), bitwise duplicates removed, truncated to
S and written to the first free face slot. A
polytope left with fewer than 4 faces is cleared.

Everything is batched over a leading polytope axis N (the JAX package's
``vmap``); the K-plane fold is a Python loop (its ``lax.scan``).

The cut point ``(a·s_b − b·s_a)/(s_b − s_a)`` is sign-symmetric, so the two
faces sharing an edge produce bitwise-identical points; the cap dedup
relies on it.
"""

from __future__ import annotations

import torch

from plainref.ops.hull import _cross
from plainref.ops.linalg import compact, dot3, sqrt_rn
from plainref.types import ConvexPoly

DEFAULT_TOL = 1e-6
CAPS = 3  # cap-point slots per face (a convex face cuts in <= 2)


def _loop_next(fv: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Next vertex around each padded loop (wraps at n_verts - 1)."""
    S = fv.shape[-2]
    slot = torch.arange(S, dtype=torch.int32, device=fv.device)
    rolled = torch.roll(fv, -1, dims=-2)
    is_last = slot == nv[..., None] - 1
    return torch.where(is_last[..., None], fv[..., 0:1, :], rolled)


def plane_basis(n: torch.Tensor):
    """Deterministic orthonormal basis (u, v) with u × v = n (n unit),
    batched over leading axes: u = e × n, e the axis of smallest |n|."""
    axis = torch.argmin(torch.abs(n), dim=-1)
    e = torch.nn.functional.one_hot(axis, 3).to(n.dtype)
    u = _cross(e, n)
    u = u / torch.clamp(sqrt_rn(dot3(u, u)), min=1e-30)[..., None]
    v = _cross(n, u)
    return u, v


def clip_poly_plane(poly: ConvexPoly, plane: torch.Tensor,
                    tol: float = DEFAULT_TOL) -> ConvexPoly:
    """Clip a batch of polytopes (N, F, S) by one plane each (N, 4),
    keeping n·x + d < 0."""
    fv, nv = poly.face_verts, poly.n_verts
    N, F, S = fv.shape[0], fv.shape[1], fv.shape[2]
    dev = fv.device
    n = plane[:, None, None, :3]
    d = plane[:, None, None, 3]

    slot = torch.arange(S, dtype=torch.int32, device=dev)
    m = slot < nv[..., None]                                   # (N, F, S)
    dist = dot3(fv, n) + d
    v_next = _loop_next(fv, nv)
    d_next = dot3(v_next, n) + d

    kept = m & (dist <= tol)
    cross = m & (((dist < -tol) & (d_next > tol)) | ((dist > tol) & (d_next < -tol)))
    denom = d_next - dist
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    p_cut = (fv * d_next[..., None] - v_next * dist[..., None]) / safe[..., None]

    # Sutherland–Hodgman emission: per slot [v if kept][p if cross].
    flags = torch.stack([kept, cross], dim=-1).reshape(N, F, 2 * S)
    vals = torch.stack([fv, p_cut], dim=-2).reshape(N, F, 2 * S, 3)
    out_fv, n_out = compact(vals, flags, S)
    new_nv = torch.where(n_out >= 3, n_out, torch.zeros_like(n_out))

    # Cap candidates: crossings + in-plane vertices of touched faces.
    removed = m & (dist > tol)
    face_touched = torch.any(removed, dim=-1)
    inplane = m & (torch.abs(dist) <= tol) & face_touched[..., None]
    any_removed = torch.any(removed.reshape(N, -1), dim=-1)
    cand = (cross | inplane) & any_removed[:, None, None]
    cand_pts = torch.where(cross[..., None], p_cut, fv)
    pool, pool_n = compact(cand_pts, cand, CAPS)               # (N, F, CAPS, 3)
    P = F * CAPS
    pool_mask = (
        torch.arange(CAPS, dtype=torch.int32, device=dev) < pool_n[..., None]
    ).reshape(N, P)
    cap_pts = pool.reshape(N, P, 3)

    # The centroid's sum and the angles run in float64 and round once to
    # float32: a float32 sum's order and a float32 atan2 are each device's
    # own, and a near tie of two angles decides the cap's dedup.
    cnt = pool_mask.sum(dim=-1)
    wsum = torch.sum(torch.where(pool_mask[..., None], cap_pts, 0.0).double(), dim=1)
    centroid = wsum.to(fv.dtype) / torch.clamp(cnt, min=1).to(fv.dtype)[:, None]
    nn = plane[:, :3]
    u, v = plane_basis(
        nn / torch.clamp(sqrt_rn(dot3(nn, nn)), min=1e-30)[..., None]
    )
    rel = cap_pts - centroid[:, None, :]
    ang = torch.atan2(dot3(rel, v[:, None]).double(),
                      dot3(rel, u[:, None]).double()).to(fv.dtype)
    key = torch.where(pool_mask, ang, torch.full_like(ang, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices
    sorted_pts = torch.gather(cap_pts, 1, order[..., None].expand(N, P, 3))
    sorted_mask = torch.arange(P, device=dev) < cnt[:, None]
    prev = torch.roll(sorted_pts, 1, dims=1)
    prev[:, 0] = float("inf")
    dup = torch.all(sorted_pts == prev, dim=-1)
    keep = sorted_mask & ~dup
    cap_fv, n_cap = compact(sorted_pts, keep, S)               # (N, S, 3)
    has_cap = n_cap >= 3

    # Cap into the first free face slot.
    free = new_nv == 0
    cap_slot = torch.argmax(free.to(torch.int32), dim=-1)
    can_place = has_cap & torch.any(free, dim=-1)
    put = (torch.arange(F, device=dev) == cap_slot[:, None]) & can_place[:, None]
    new_fv = torch.where(put[..., None, None], cap_fv[:, None], out_fv)
    new_nv = torch.where(put, n_cap[:, None], new_nv)
    new_planes = torch.where(put[..., None], plane[:, None, :], poly.planes)

    # Fewer than 4 faces: the polytope is cleared.
    alive = torch.sum((new_nv >= 3).to(torch.int32), dim=-1) >= 4
    new_nv = torch.where(alive[:, None], new_nv, torch.zeros_like(new_nv))
    return ConvexPoly(new_fv, new_nv, new_planes)


def clip_poly_planes(poly: ConvexPoly, planes: torch.Tensor,
                     plane_mask: torch.Tensor | None = None,
                     tol: float = DEFAULT_TOL) -> ConvexPoly:
    """Fold ``clip_poly_plane`` over (N, K, 4) plane lists with an (N, K)
    mask; a masked plane leaves its polytope as it was."""
    N, K = planes.shape[0], planes.shape[1]
    if plane_mask is None:
        plane_mask = torch.ones((N, K), dtype=torch.bool, device=planes.device)
    out = poly
    for k in range(K):
        if not bool(torch.any(plane_mask[:, k])):
            continue
        q = clip_poly_plane(out, planes[:, k], tol)
        ok = plane_mask[:, k]
        out = ConvexPoly(
            torch.where(ok[:, None, None, None], q.face_verts, out.face_verts),
            torch.where(ok[:, None], q.n_verts, out.n_verts),
            torch.where(ok[:, None, None], q.planes, out.planes),
        )
    return out


def contains_point(poly: ConvexPoly, x: torch.Tensor,
                   tol: float = DEFAULT_TOL) -> torch.Tensor:
    """Point-in-polytope via face planes. poly batch (...), x (..., 3) →
    (...,) bool."""
    s = dot3(poly.planes[..., :3], x[..., None, :]) + poly.planes[..., 3]
    ok = (s <= tol) | ~poly.face_mask()
    return torch.all(ok, dim=-1) & ~poly.is_empty()


def clip_poly_poly(poly: ConvexPoly, clipper: ConvexPoly,
                   tol: float = DEFAULT_TOL) -> ConvexPoly:
    """Clip ``poly`` by every face plane of ``clipper`` (Poly::ClipPolyhedron):
    batches (N, F, S) or single polytopes (F, S). An empty clipper gives the
    empty polytope."""
    single = poly.face_verts.dim() == 3
    if single:
        poly, clipper = (p.map(lambda a: a[None]) for p in (poly, clipper))
    out = clip_poly_planes(poly, clipper.planes, clipper.face_mask(), tol)
    nv = torch.where(clipper.is_empty()[:, None], torch.zeros_like(out.n_verts), out.n_verts)
    out = ConvexPoly(out.face_verts, nv, out.planes)
    return out.map(lambda a: a[0]) if single else out


def clip_batch_by_cells(pieces: ConvexPoly, cells: ConvexPoly,
                        tol: float = DEFAULT_TOL) -> ConvexPoly:
    """The (P pieces) × (C cells) grid clip of the fracture fan-out: pieces
    (P, F, S), cells (C, Fc, Sc). Returns a ConvexPoly with batch (P, C)."""
    P, C = pieces.batch_shape[0], cells.batch_shape[0]
    rep = pieces.map(lambda a: a[:, None].expand((P, C) + a.shape[1:]).flatten(0, 1))
    cl = cells.map(lambda a: a[None].expand((P, C) + a.shape[1:]).flatten(0, 1))
    out = clip_poly_poly(rep, cl, tol)
    return out.map(lambda a: a.reshape((P, C) + a.shape[1:]))
