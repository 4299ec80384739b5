"""Triangle-soup clipping and solid queries (counterpart of
``surtr_tpu/ops/mesh_clip.py``).

Each triangle × plane-list clip is an independent Sutherland–Hodgman pass
over a small padded polygon with cyclic-run emission (the kept vertices of
a convex loop form one cyclic run; the cut adds [exit, enter] after it),
then a fan re-triangulation packed front-aligned. ``point_in_mesh`` (ray
parity) and ``winding_inside`` (generalized winding number) answer the
inside-solid queries of the island split and the occupancy test.
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.ops.hull import _cross
from surtr_tpu_torch.ops.linalg import compact


def _clip_polys_plane(poly, n_vert, plane, tol):
    """SH-clip batches of small convex polygons by one plane per batch.

    poly (B, T, S, 3); n_vert (B, T); plane (B, 4). The in-plane polygon
    drop rule's "this plane removes material" context is per batch row.
    Returns (poly, n_vert, multirun) with the same shapes."""
    B, T, S, _ = poly.shape
    dev = poly.device
    n = plane[:, None, None, :3]
    d = plane[:, None, None, 3]
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    m = slot < n_vert[..., None]
    dist = torch.sum(poly * n, dim=-1) + d
    rolled = torch.roll(poly, -1, dims=2)
    is_last = slot == n_vert[..., None] - 1
    v_next = torch.where(is_last[..., None], poly[:, :, 0:1, :], rolled)
    d_next = torch.sum(v_next * n, dim=-1) + d
    kept = m & (dist <= tol)
    denom = d_next - dist
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    p_cut = (poly * d_next[..., None] - v_next * dist[..., None]) / safe[..., None]

    cross_exit = m & (dist < -tol) & (d_next > tol)
    cross_enter = m & (dist > tol) & (d_next < -tol)
    exit_p = torch.sum(cross_exit.to(poly.dtype)[..., None] * p_cut, dim=2)
    enter_p = torch.sum(cross_enter.to(poly.dtype)[..., None] * p_cut, dim=2)
    ex_i = torch.any(cross_exit, dim=2).to(torch.int32)
    en_i = torch.any(cross_enter, dim=2).to(torch.int32)

    # Run start a = the kept vertex whose cyclic predecessor is removed.
    kept_i = kept.to(torch.int32)
    kprev = torch.cat(
        [torch.sum(torch.where(is_last, kept_i, 0), 2, keepdim=True), kept_i[..., :-1]], dim=2
    )
    startm = kept & (kprev == 0)
    nstarts = startm.to(torch.int32).sum(2)
    a = torch.sum(torch.where(startm, slot, 0), dim=2)
    mcnt = kept_i.sum(2)
    # rot[j] = poly[(a + j) mod n_vert] (only slots j < mcnt are read).
    src = (a[..., None] + slot) % torch.clamp(n_vert, min=1)[..., None]
    rot = torch.gather(poly, 2, src.long()[..., None].expand(B, T, S, 3))

    in_run = slot < mcnt[..., None]
    at_exit = (slot == mcnt[..., None]) & (ex_i[..., None] > 0)
    at_enter = (slot == (mcnt + ex_i)[..., None]) & (en_i[..., None] > 0)
    zero = torch.zeros((), dtype=poly.dtype, device=dev)
    out = torch.where(
        in_run[..., None], rot,
        torch.where(at_exit[..., None], exit_p[:, :, None, :],
                    torch.where(at_enter[..., None], enter_p[:, :, None, :], zero)),
    )
    n_out = torch.clamp(mcnt + ex_i + en_i, max=S)
    # Polygons wholly in a plane that removes material are old cap geometry:
    # drop them (the new cap re-covers the cross-section).
    inplane = torch.all((torch.abs(dist) <= tol) | ~m, dim=2) & (n_vert > 0)
    any_removed = torch.any((m & (dist > tol)).reshape(B, -1), dim=1)[:, None]
    n_out = torch.where(inplane & any_removed, 0, n_out)
    # A convex loop has exactly one kept run; otherwise drop (counted).
    multirun = nstarts > 1
    n_out = torch.where(multirun, 0, n_out)
    return out, torch.where(n_out >= 3, n_out, 0).to(torch.int32), multirun


def clip_trisoup(corners, tri_valid, planes, plane_mask, max_out: int,
                 poly_slots: int = 8, tol: float = 1e-6):
    """Clip one triangle soup by B convex plane lists.

    corners (T, 3, 3), tri_valid (T,), planes (B, K, 4), plane_mask (B, K).
    Returns (out (B, max_out, 3, 3), out_valid (B, max_out), dropped (B,))."""
    T = corners.shape[0]
    B, K = planes.shape[0], planes.shape[1]
    S = poly_slots
    dev = corners.device
    poly = torch.zeros((B, T, S, 3), dtype=corners.dtype, device=dev)
    poly[:, :, :3] = corners
    n_vert = torch.where(tri_valid, 3, 0).to(torch.int32).expand(B, T).contiguous()
    mdrop = torch.zeros((B,), dtype=torch.int32, device=dev)
    for k in range(K):
        ok = plane_mask[:, k]
        p2, n2, mrun = _clip_polys_plane(poly, n_vert, planes[:, k], tol)
        poly = torch.where(ok[:, None, None, None], p2, poly)
        n_vert = torch.where(ok[:, None], n2, n_vert)
        mdrop = mdrop + torch.where(ok, mrun.to(torch.int32).sum(1), 0)

    fan = torch.arange(S, device=dev)
    i1 = torch.clamp(fan + 1, max=S - 1)
    i2 = torch.clamp(fan + 2, max=S - 1)
    tris = torch.stack(
        [poly[:, :, 0:1, :].expand(B, T, S, 3), poly[:, :, i1, :], poly[:, :, i2, :]], dim=3
    )                                                          # (B, T, S, 3, 3)
    counts = torch.clamp(n_vert - 2, min=0)
    total = counts.sum(1)
    fan_ok = fan < counts[..., None]
    out, _ = compact(tris.reshape(B, T * S, 9), fan_ok.reshape(B, T * S), max_out)
    out = out.reshape(B, max_out, 3, 3)
    out_valid = torch.arange(max_out, device=dev) < total[:, None]
    dropped = torch.clamp(total - max_out, min=0) + mdrop
    return out, out_valid, dropped.to(torch.int32)


def point_in_mesh(points, corners, tri_valid):
    """Ray-parity solid test along a fixed generic direction (Möller–
    Trumbore). points (P, 3), corners (T, 3, 3) → (P,) bool."""
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    d = torch.tensor([0.8138294, 0.40996888, 0.41189286], dtype=corners.dtype,
                     device=corners.device)
    e1 = b - a
    e2 = c - a
    pvec = _cross(d.expand_as(e2), e2)
    det = torch.sum(e1 * pvec, dim=-1)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)
    tvec = points[:, None, :] - a[None]
    u = torch.sum(tvec * pvec[None], -1) * inv[None]
    qvec = _cross(tvec, e1[None].expand_as(tvec))
    v = torch.sum(qvec * d, -1) * inv[None]
    t = torch.sum(qvec * e2[None], -1) * inv[None]
    hit = ok[None] & tri_valid[None] & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
    return (hit.sum(dim=1) % 2) == 1


def winding_inside(points, corners, tri_valid, threshold: float = 0.5):
    """Generalized winding-number solid test (Van Oosterom–Strackee).
    points (P, 3), corners (T, 3, 3) → (P,) bool."""
    a = corners[None, :, 0] - points[:, None]
    b = corners[None, :, 1] - points[:, None]
    c = corners[None, :, 2] - points[:, None]
    la = torch.linalg.vector_norm(a, dim=-1)
    lb = torch.linalg.vector_norm(b, dim=-1)
    lc = torch.linalg.vector_norm(c, dim=-1)
    det = torch.sum(a * _cross(b, c), dim=-1)
    den = (
        la * lb * lc
        + torch.sum(a * b, -1) * lc
        + torch.sum(b * c, -1) * la
        + torch.sum(c * a, -1) * lb
    )
    omega = 2.0 * torch.atan2(det, den)
    total = torch.sum(torch.where(tri_valid[None], omega, 0.0), dim=-1)
    return torch.abs(total) > threshold * 4.0 * torch.pi
