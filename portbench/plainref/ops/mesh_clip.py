"""Triangle-soup clipping and solid queries (counterpart of
``surtr_tpu/ops/mesh_clip.py``).

Each triangle × plane-list clip is an independent Sutherland–Hodgman pass
over a small padded polygon with cyclic-run emission (the kept vertices of
a convex loop form one cyclic run; the cut adds [exit, enter] after it),
then a fan re-triangulation packed front-aligned. ``clip_trisoup`` clips
one soup by B plane lists; ``clip_polys_by_rows`` clips P pooled triangles,
each by its own plane list (the pair-pool mesh clip; kernel B10 in
``soup_clip_cuda.py`` computes the same fold on the card). ``point_in_mesh``
(ray parity) and ``winding_inside`` (generalized winding number) answer the
inside-solid queries of the island split, the occupancy test and the cap
probes, batched over per-candidate solids; ``build_parity_grid`` and
``parity_grid_inside`` answer them from one precomputed grid when every
candidate shares one closed source solid (prepare).
"""

from __future__ import annotations

import torch

from plainref.ops.hull import _cross
from plainref.ops.linalg import compact, div_rn, dot3, sqrt_rn

BIG = 3.4e38
# Golden-ratio cell offsets of the grid's ray columns (x, y).
GRID_FX, GRID_FY = 0.381966, 0.618034


def _clip_polys_plane(poly, n_vert, plane, tol, any_removed=None):
    """SH-clip small convex polygons, each row by its own plane.

    poly (..., T, S, 3); n_vert (..., T); plane (..., T, 4) (a plane shared
    by a batch row is passed expanded). ``any_removed`` (..., T) bool is the
    "this plane removes material" context of the in-plane polygon drop
    rule; None takes the any over the T axis of each batch row (the
    per-soup semantics). Returns (poly, n_vert, multirun) with the same
    shapes. Keeps n·x + d < 0."""
    S = poly.shape[-2]
    dev = poly.device
    n = plane[..., None, :3]
    d = plane[..., None, 3]
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    m = slot < n_vert[..., None]
    dist = dot3(poly, n) + d
    rolled = torch.roll(poly, -1, dims=-2)
    is_last = slot == n_vert[..., None] - 1
    v_next = torch.where(is_last[..., None], poly[..., 0:1, :], rolled)
    d_next = dot3(v_next, n) + d
    kept = m & (dist <= tol)
    denom = d_next - dist
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    p_cut = (poly * d_next[..., None] - v_next * dist[..., None]) / safe[..., None]

    cross_exit = m & (dist < -tol) & (d_next > tol)
    cross_enter = m & (dist > tol) & (d_next < -tol)
    # Exit and enter points, both from one (..., S, 2, 3) tensor of terms
    # summed slot by slot from +0. Written out rather than ``torch.sum``,
    # whose order is unspecified: a lane that crosses a plane more than once
    # (a multirun, dropped) sums several cuts, and kernel B10 adds them in
    # this order.
    terms = torch.stack((cross_exit, cross_enter), dim=-1)[..., None] * p_cut[..., None, :]
    acc = 0.0 + terms[..., 0, :, :]
    for s in range(1, S):
        acc = acc + terms[..., s, :, :]
    exit_p, enter_p = acc[..., 0, :], acc[..., 1, :]
    ex_i = torch.any(cross_exit, dim=-1).to(torch.int32)
    en_i = torch.any(cross_enter, dim=-1).to(torch.int32)

    # Run start a = the kept vertex whose cyclic predecessor is removed.
    kept_i = kept.to(torch.int32)
    kprev = torch.cat(
        [torch.sum(torch.where(is_last, kept_i, 0), -1, keepdim=True), kept_i[..., :-1]], dim=-1
    )
    startm = kept & (kprev == 0)
    nstarts = startm.to(torch.int32).sum(-1)
    a = torch.sum(torch.where(startm, slot, 0), dim=-1)
    mcnt = kept_i.sum(-1)
    # rot[j] = poly[(a + j) mod n_vert] (only slots j < mcnt are read).
    src = (a[..., None] + slot) % torch.clamp(n_vert, min=1)[..., None]
    rot = torch.gather(poly, -2, src.long()[..., None].expand(poly.shape))

    in_run = slot < mcnt[..., None]
    at_exit = (slot == mcnt[..., None]) & (ex_i[..., None] > 0)
    at_enter = (slot == (mcnt + ex_i)[..., None]) & (en_i[..., None] > 0)
    zero = torch.zeros((), dtype=poly.dtype, device=dev)
    out = torch.where(
        in_run[..., None], rot,
        torch.where(at_exit[..., None], exit_p[..., None, :],
                    torch.where(at_enter[..., None], enter_p[..., None, :], zero)),
    )
    n_out = torch.clamp(mcnt + ex_i + en_i, max=S)
    # Polygons wholly in a plane that removes material are old cap geometry:
    # drop them (the new cap re-covers the cross-section).
    inplane = torch.all((torch.abs(dist) <= tol) | ~m, dim=-1) & (n_vert > 0)
    if any_removed is None:
        any_removed = torch.any(m & (dist > tol), dim=-1).any(-1, keepdim=True)
    n_out = torch.where(inplane & any_removed, 0, n_out)
    # A convex loop has exactly one kept run; otherwise drop (counted).
    multirun = nstarts > 1
    n_out = torch.where(multirun, 0, n_out)
    return out, torch.where(n_out >= 3, n_out, 0).to(torch.int32), multirun


def clip_trisoup(corners, tri_valid, planes, plane_mask, max_out: int,
                 poly_slots: int = 8, tol: float = 1e-6):
    """Clip a triangle soup by B convex plane lists.

    corners (T, 3, 3) and tri_valid (T,), one soup shared by all B lists,
    or (B, T, 3, 3) and (B, T), one soup each; planes (B, K, 4), plane_mask
    (B, K). Returns (out (B, max_out, 3, 3), out_valid (B, max_out),
    dropped (B,))."""
    T = corners.shape[-3]
    B, K = planes.shape[0], planes.shape[1]
    S = poly_slots
    dev = corners.device
    poly = torch.zeros((B, T, S, 3), dtype=corners.dtype, device=dev)
    poly[:, :, :3] = corners
    n_vert = torch.where(tri_valid, 3, 0).to(torch.int32).expand(B, T).contiguous()
    mdrop = torch.zeros((B,), dtype=torch.int32, device=dev)
    for k in range(K):
        ok = plane_mask[:, k]
        p2, n2, mrun = _clip_polys_plane(poly, n_vert, planes[:, None, k].expand(B, T, 4), tol)
        poly = torch.where(ok[:, None, None, None], p2, poly)
        n_vert = torch.where(ok[:, None], n2, n_vert)
        mdrop = mdrop + torch.where(ok, mrun.to(torch.int32).sum(1), 0)

    tris, counts = fan_triangles(poly, n_vert)                 # (B, T, S, 3, 3)
    total = counts.sum(1)
    fan_ok = torch.arange(S, device=dev) < counts[..., None]
    out, _ = compact(tris.reshape(B, T * S, 9), fan_ok.reshape(B, T * S), max_out)
    out = out.reshape(B, max_out, 3, 3)
    out_valid = torch.arange(max_out, device=dev) < total[:, None]
    dropped = torch.clamp(total - max_out, min=0) + mdrop
    return out, out_valid, dropped.to(torch.int32)


def clip_polys_by_rows(corners, valid, planes, pmask, seg_starts=None, seg_id=None,
                       poly_slots: int = 8, tol: float = 1e-6):
    """Clip P independent triangles, each by its own plane list.

    corners (P, 3, 3); valid (P,); planes (P, K, 4); pmask (P, K).
    ``seg_starts`` (C+1,) / ``seg_id`` (P,): rows grouped by cell in
    contiguous runs; the in-plane drop rule's context is then evaluated per
    cell from the current polygons at each plane step (boundary cumsum
    differences). Without them it is the any over the whole pool.
    Returns (poly (P, S, 3), n_vert (P,), multirun_drops)."""
    P = corners.shape[0]
    S = poly_slots
    dev = corners.device
    poly = torch.zeros((P, S, 3), dtype=corners.dtype, device=dev)
    poly[:, :3] = corners
    n_vert = torch.where(valid, 3, 0).to(torch.int32)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(planes.shape[1]):
        pl, ok = planes[:, k], pmask[:, k]
        ctx = None
        if seg_starts is not None:
            dist = dot3(poly, pl[:, None, :3]) + pl[:, None, 3]
            m = slot < n_vert[:, None]
            rm = (torch.any(m & (dist > tol), dim=1) & ok).to(torch.int64)
            cs = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(rm, 0)])
            per_seg = cs[seg_starts[1:].long()] - cs[seg_starts[:-1].long()]
            # Out-of-range ids read the last segment, as the JAX gather clamps.
            ctx = (per_seg > 0)[torch.clamp(seg_id.long(), 0, per_seg.shape[0] - 1)]
        p2, n2, mrun = _clip_polys_plane(poly, n_vert, pl, tol, any_removed=ctx)
        poly = torch.where(ok[:, None, None], p2, poly)
        n_vert = torch.where(ok, n2, n_vert)
        drops = drops + (mrun & ok).sum()
    return poly, n_vert, drops


def fan_triangles(poly, n_vert):
    """Fan re-triangulation of padded polygons: (..., S, 3) + counts →
    ((..., S, 3, 3) fan triangles, (...) triangle counts max(n − 2, 0))."""
    S = poly.shape[-2]
    fan = torch.arange(S, device=poly.device)
    i1 = torch.clamp(fan + 1, max=S - 1)
    i2 = torch.clamp(fan + 2, max=S - 1)
    tris = torch.stack(
        [poly[..., 0:1, :].expand(poly.shape), poly[..., i1, :], poly[..., i2, :]], dim=-2
    )
    return tris, torch.clamp(n_vert - 2, min=0)


def point_in_mesh(points, corners, tri_valid):
    """Ray-parity solid test along a fixed generic direction (Möller–
    Trumbore). points (..., P, 3), corners (..., T, 3, 3), tri_valid
    (..., T) → (..., P) bool; leading axes broadcast (one solid per
    candidate, or one shared)."""
    a, b, c = corners[..., 0, :], corners[..., 1, :], corners[..., 2, :]
    d = torch.tensor([0.8138294, 0.40996888, 0.41189286], dtype=corners.dtype,
                     device=corners.device)
    e1 = b - a
    e2 = c - a
    pvec = _cross(d.expand_as(e2), e2)                         # (..., T, 3)
    det = dot3(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)
    tvec = points[..., :, None, :] - a[..., None, :, :]        # (..., P, T, 3)
    u = dot3(tvec, pvec[..., None, :, :]) * inv[..., None, :]
    qvec = _cross(tvec, e1[..., None, :, :].expand_as(tvec))
    v = dot3(qvec, d) * inv[..., None, :]
    t = dot3(qvec, e2[..., None, :, :]) * inv[..., None, :]
    hit = ((ok & tri_valid)[..., None, :] & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t > 1e-9))
    return (hit.sum(dim=-1) % 2) == 1


def winding_inside(points, corners, tri_valid, threshold: float = 0.5):
    """Generalized winding-number solid test (Van Oosterom–Strackee).
    points (..., P, 3), corners (..., T, 3, 3), tri_valid (..., T) →
    (..., P) bool; leading axes broadcast."""
    p = points[..., :, None, :]
    a = corners[..., None, :, 0, :] - p                        # (..., P, T, 3)
    b = corners[..., None, :, 1, :] - p
    c = corners[..., None, :, 2, :] - p
    la, lb, lc = sqrt_rn(dot3(a, a)), sqrt_rn(dot3(b, b)), sqrt_rn(dot3(c, c))
    det = dot3(a, _cross(b, c))
    den = la * lb * lc + dot3(a, b) * lc + dot3(b, c) * la + dot3(c, a) * lb
    omega = 2.0 * torch.atan2(det, den)
    total = torch.sum(torch.where(tri_valid[..., None, :], omega, 0.0), dim=-1)
    return torch.abs(total) > threshold * 4.0 * torch.pi


def build_parity_grid(corners, tri_valid, res: int = 64):
    """Inside-solid parity grid of ONE closed triangle soup (T, 3, 3): the
    crossing parity of a vertical ray at the centres of a res³ grid over
    the soup's bounding box (padded 0.5%), the ray columns at golden-ratio
    fractions of a cell so they miss axis-aligned vertices and edges.

    Each column's crossing heights are sorted and counted below every
    z-bin centre with a left ``searchsorted``: the strict-less count of
    the JAX package's fused (R², T, R) compare, without building that
    tensor. Returns {lo (3,), ext (3,), res, inside (res³,) bool}; query
    with ``parity_grid_inside``."""
    R = int(res)
    dev, dt = corners.device, corners.dtype
    c2 = corners.reshape(-1, 3)
    m2 = tri_valid.repeat_interleave(3)[:, None]
    lo = torch.amin(torch.where(m2, c2, BIG), dim=0)
    hi = torch.amax(torch.where(m2, c2, -BIG), dim=0)
    ext = torch.clamp(hi - lo, min=1e-6)
    lo = lo - 0.005 * ext
    ext = ext * 1.01

    ar = torch.arange(R, dtype=dt, device=dev)
    xs = lo[0] + div_rn(ar + GRID_FX, R) * ext[0]
    ys = lo[1] + div_rn(ar + GRID_FY, R) * ext[1]
    zc = lo[2] + div_rn(ar + 0.5, R) * ext[2]
    px = xs.repeat_interleave(R)[:, None]                      # (R², 1) x-major
    py = ys.repeat(R)[:, None]

    A, B, Cc = corners[:, 0], corners[:, 1], corners[:, 2]

    def edge(p0, p1):
        return (p1[:, 0] - p0[:, 0]) * (py - p0[:, 1]) - (p1[:, 1] - p0[:, 1]) * (px - p0[:, 0])

    e0 = edge(A, B)                                            # (R², T)
    e1 = edge(B, Cc)
    e2 = edge(Cc, A)
    area = (B[:, 0] - A[:, 0]) * (Cc[:, 1] - A[:, 1]) - (B[:, 1] - A[:, 1]) * (Cc[:, 0] - A[:, 0])
    big_a = torch.abs(area) > 1e-14
    ok = big_a & tri_valid
    s = torch.sign(area)
    hit = ok & (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
    inv_a = 1.0 / torch.where(big_a, area, torch.ones_like(area))
    sia = s * torch.abs(inv_a)                                 # 1 / area
    w0 = e1 * sia
    w1 = e2 * sia
    w2 = 1.0 - w0 - w1
    zhit = w0 * A[:, 2] + w1 * B[:, 2] + w2 * Cc[:, 2]
    zhit = torch.where(hit, zhit, BIG)
    zs = torch.sort(zhit, dim=1).values
    cnt = torch.searchsorted(zs, zc.expand(R * R, R).contiguous(), side="left")
    inside = (cnt % 2) == 1                                    # (R², R)
    return {"lo": lo, "ext": ext, "res": R, "inside": inside.reshape(R * R * R)}


def parity_grid_inside(grid: dict, points):
    """Sample a ``build_parity_grid`` result at (P, 3) points → (P,) bool,
    each point snapped to its cell's centre; points outside the grid's
    box are outside the solid."""
    R = grid["res"]
    rel = (points - grid["lo"]) / grid["ext"] * R
    ix = torch.round(rel[:, 0] - GRID_FX).to(torch.int64)
    iy = torch.round(rel[:, 1] - GRID_FY).to(torch.int64)
    iz = torch.round(rel[:, 2] - 0.5).to(torch.int64)
    inb = (ix >= 0) & (ix < R) & (iy >= 0) & (iy < R) & (iz >= 0) & (iz < R)
    flat = (torch.clamp(ix, 0, R - 1) * (R * R) + torch.clamp(iy, 0, R - 1) * R
            + torch.clamp(iz, 0, R - 1))
    return grid["inside"][flat] & inb


def unique_corner_verts(corners: torch.Tensor, tri_valid: torch.Tensor):
    """Flattened (possibly duplicated) corner pool: ((3T, 3), (3T,) mask).
    Duplicates are harmless for supports and hull seeding."""
    T = corners.shape[0]
    return corners.reshape(3 * T, 3), tri_valid.repeat_interleave(3)
