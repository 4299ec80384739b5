"""Limited incremental convex hull (counterpart of ``surtr_tpu/ops/hull.py``;
reference VMACH::ConvexHull).

Greedy volume-max insertion capped at ``limit`` points: a seed tetrahedron
from extreme points (max x, farthest, max area, max volume), then per step
the unprocessed point with the largest Σ max(0, vol(face, p)), the horizon
by twin-edge matching, new faces on free slots in stable slot order, each
oriented outward against the seed centroid. ``ich_batch`` builds the hulls
of a batch of point sets at once (``ich`` is its batch of one). Plain
PyTorch; the hand-written kernel is in ``hull_cuda.py``.
"""

from __future__ import annotations

import torch

from plainref.ops.linalg import dot3, sqrt_rn

NEG = -3.4e38


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _vol(tri_pts, p):
    """Signed 6×volume det(a-p, b-p, c-p); positive when p is on the inner
    side of a CCW-outward face."""
    a = tri_pts[..., 0, :] - p
    b = tri_pts[..., 1, :] - p
    c = tri_pts[..., 2, :] - p
    return dot3(a, _cross(b, c))


def _first_argmax(x):
    """Index of the first maximum (jnp.argmax semantics)."""
    m = x >= torch.amax(x, dim=-1, keepdim=True)
    return torch.argmax(m.to(torch.int32), dim=-1)


def ich(points: torch.Tensor, mask: torch.Tensor, limit: int, max_faces: int | None = None):
    """points (N, 3), mask (N,). Returns dict faces (F, 3) i32, face_valid
    (F,), normals (F, 3), inner (3,) with F = 2·max(limit, 4) + 4: the one
    set of ``ich_batch``."""
    out = ich_batch(points[None], mask[None], limit, max_faces)
    return {k: v[0] for k, v in out.items()}


def _slot_sum(pts, faces, fmask, live):
    """Σ max(0, vol(face, p)) over the masked faces of each set, in slot
    order, for the points flagged in ``live``: pts (B, N, 3), faces (B, F,
    3), fmask (B, F), live (B, N) → (B, N), 0 at the other points. Each
    set's masked faces are gathered front-aligned in slot order and added
    one at a time from +0, the order of the kernel's sums (a library sum
    adds in an order of its own, and one ulp of a priority can move the
    greedy pick). Only the live points are evaluated: the others' priority
    is NEG whatever their sum."""
    B, N = pts.shape[:2]
    out = torch.zeros((B, N), dtype=pts.dtype, device=pts.device)
    K = int(fmask.sum(1).amax()) if fmask.numel() else 0
    b, n = torch.nonzero(live, as_tuple=True)
    if K == 0 or b.numel() == 0:
        return out
    order = torch.sort((~fmask).to(torch.int8), dim=1, stable=True).indices[:, :K]
    sel = torch.gather(fmask, 1, order)
    f = torch.gather(faces, 1, order[..., None].expand(B, K, 3))
    tp = _corners(pts, f)                                     # (B, K, 3, 3)
    v = _vol(tp[b], pts[b, n][:, None])                       # (A, K)
    v = torch.where(sel[b], torch.clamp(v, min=0.0), torch.zeros_like(v))
    s = torch.zeros_like(v[:, 0])
    for j in range(K):
        s = s + v[:, j]
    out[b, n] = s
    return out


def _corners(pts, idx):
    """pts (B, N, 3) gathered at idx (B, ...) → (B, ..., 3)."""
    B = pts.shape[0]
    b = torch.arange(B, device=pts.device).view((B,) + (1,) * (idx.dim() - 1))
    return pts[b, idx]


def ich_batch(points: torch.Tensor, mask: torch.Tensor, limit: int,
              max_faces: int | None = None):
    """``ich`` of B independent point sets at once: points (B, N, 3), mask
    (B, N). Returns faces (B, F, 3) i32, face_valid (B, F), normals
    (B, F, 3), inner (B, 3); each set's result is what ``ich`` gives for it
    alone. Every step is a tensor op over the batch (one per insertion, not
    one per set); the insertions run ``max(min(limit, N) - 4, 0)`` times
    with N the padded set size."""
    B, N = points.shape[:2]
    dev = points.device
    F = max_faces if max_faces is not None else 2 * max(limit, 4) + 4
    pts = points
    neg = torch.tensor(NEG, dtype=pts.dtype, device=dev)
    bidx = torch.arange(B, device=dev)

    i1 = _first_argmax(torch.where(mask, pts[..., 0], neg))
    p1 = pts[bidx, i1]
    r = pts - p1[:, None]
    i2 = _first_argmax(torch.where(mask, dot3(r, r), neg))
    e12 = pts[bidx, i2] - p1
    cr = _cross(e12[:, None].expand_as(pts), pts - p1[:, None])
    i3 = _first_argmax(torch.where(mask, dot3(cr, cr), neg))
    tri = torch.stack([p1, pts[bidx, i2], pts[bidx, i3]], dim=1)   # (B, 3, 3)
    i4 = _first_argmax(torch.where(mask, _vol(tri[:, None], pts), neg))

    idx4 = torch.stack([i1, i2, i3, i4], dim=1)                    # (B, 4)
    q = _corners(pts, idx4)
    inner = (((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]) * 0.25
    init = torch.stack(
        [
            torch.stack([i1, i2, i3], dim=1),
            torch.stack([i1, i2, i4], dim=1),
            torch.stack([i1, i3, i4], dim=1),
            torch.stack([i2, i3, i4], dim=1),
        ],
        dim=1,
    )                                                              # (B, 4, 3)
    flip = _vol(_corners(pts, init), inner[:, None]) < 0
    init = torch.where(flip[..., None], init[..., [0, 2, 1]], init)

    faces = torch.zeros((B, F, 3), dtype=torch.long, device=dev)
    faces[:, :4] = init
    fvalid = torch.zeros((B, F), dtype=torch.bool, device=dev)
    fvalid[:, :4] = True
    processed = torch.zeros((B, N), dtype=torch.bool, device=dev)
    processed.scatter_(1, idx4, True)

    live = mask & ~processed
    priority = torch.where(live, _slot_sum(pts, faces, fvalid, live), neg)

    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    trash_f = torch.zeros((B, 1, 3), dtype=torch.long, device=dev)
    trash_v = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    n_insert = max(min(limit, N) - 4, 0)
    for _ in range(n_insert):
        k = _first_argmax(priority)                                # (B,)
        p = pts[bidx, k]
        can = priority[bidx, k] > NEG / 2
        volf = torch.where(fvalid, _vol(_corners(pts, faces), p[:, None]), zero)
        visible = fvalid & (volf < 0)
        any_vis = torch.any(visible, dim=1) & can

        fe0 = faces.reshape(B, -1)                                 # (B, 3F)
        fe1 = torch.roll(faces, -1, dims=2).reshape(B, -1)
        owner_vis = visible.repeat_interleave(3, dim=1)
        owner_val = fvalid.repeat_interleave(3, dim=1)
        twin = (fe0[:, :, None] == fe1[:, None, :]) & (fe1[:, :, None] == fe0[:, None, :])
        twin = twin & (owner_val & ~owner_vis)[:, None, :]
        horizon = owner_vis & owner_val & torch.any(twin, dim=2)

        fvalid_mid = fvalid & ~(visible & any_vis[:, None])
        free_order = torch.sort(fvalid_mid.to(torch.int32), dim=1, stable=True).indices
        hz = horizon.to(torch.long)
        rank = torch.cumsum(hz, 1) - hz
        slot = torch.gather(free_order, 1, torch.clamp(rank, max=F - 1))
        new_face = torch.stack([fe0, fe1, torch.zeros_like(fe0) + k[:, None]], dim=2)
        nv = _vol(_corners(pts, new_face), inner[:, None])
        new_face = torch.where((nv < 0)[..., None], new_face[..., [0, 2, 1]], new_face)
        do = horizon & any_vis[:, None]
        tgt = torch.where(do, slot, torch.full_like(slot, F))
        rows = bidx[:, None].expand_as(tgt)
        faces2 = torch.cat([faces, trash_f], dim=1)
        faces2[rows, tgt] = new_face
        faces2 = faces2[:, :F]
        fvalid2 = torch.cat([fvalid_mid, trash_v], dim=1)
        fvalid2[rows, tgt] = do
        fvalid2 = fvalid2[:, :F]

        live = mask & ~processed
        dp = (_slot_sum(pts, faces2, fvalid2 & ~fvalid_mid, live)
              - _slot_sum(pts, faces, visible, live))
        priority2 = torch.where(live, priority + dp, neg)
        processed = processed.clone()
        processed[bidx, k] = processed[bidx, k] | can
        priority2[bidx, k] = neg
        prio_skip = priority.clone()
        prio_skip[bidx, k] = neg

        av = any_vis[:, None]
        faces = torch.where(av[..., None], faces2, faces)
        fvalid = torch.where(av, fvalid2, fvalid)
        priority = torch.where(av, priority2, prio_skip)

    tp = _corners(pts, faces)
    nrm = _cross(tp[..., 1, :] - tp[..., 0, :], tp[..., 2, :] - tp[..., 0, :])
    ln = sqrt_rn(dot3(nrm, nrm))[..., None]
    nrm = nrm / torch.clamp(ln, min=1e-30)
    fvalid = fvalid & (ln[..., 0] > 1e-20)
    return {
        "faces": faces.to(torch.int32),
        "face_valid": fvalid,
        "normals": torch.where(fvalid[..., None], nrm, torch.zeros_like(nrm)),
        "inner": inner,
    }


def tetra_hull(points: torch.Tensor, mask: torch.Tensor):
    """Seed tetrahedron only (the ``limit <= 4`` ICH), batched over leading
    axes: points (..., N, 3), mask (..., N). Returns normals (..., 4, 3),
    face_valid (..., 4), inner (..., 3). Extremes are first-of-ties."""
    dtype = points.dtype
    neg = torch.tensor(NEG, dtype=dtype, device=points.device)

    def at_max(score):
        i = _first_argmax(score)
        return torch.gather(points, -2, i[..., None, None].expand(i.shape + (1, 3)))[..., 0, :]

    p1 = at_max(torch.where(mask, points[..., 0], neg))
    r = points - p1[..., None, :]
    d1 = torch.where(mask, dot3(r, r), neg)
    p2 = at_max(d1)
    e12 = p2 - p1
    cr = _cross(e12[..., None, :].expand_as(points), points - p1[..., None, :])
    area = torch.where(mask, dot3(cr, cr), neg)
    p3 = at_max(area)
    a = p1[..., None, :] - points
    b = p2[..., None, :] - points
    c = p3[..., None, :] - points
    v4 = torch.where(mask, dot3(a, _cross(b, c)), neg)
    p4 = at_max(v4)

    inner = (p1 + p2 + p3 + p4) * 0.25
    nrms, valids = [], []
    for (fa, fb, fc) in ((p1, p2, p3), (p1, p2, p4), (p1, p3, p4), (p2, p3, p4)):
        n = _cross(fb - fa, fc - fa)
        s = dot3(n, inner - fa)[..., None]
        n = torch.where(s > 0, -n, n)
        ln = sqrt_rn(dot3(n, n))[..., None]
        nrms.append(n / torch.clamp(ln, min=1e-30))
        valids.append(ln[..., 0] > 1e-20)
    normals = torch.stack(nrms, dim=-2)
    face_valid = torch.stack(valids, dim=-1)
    normals = torch.where(face_valid[..., None], normals, torch.zeros_like(normals))
    return {"normals": normals, "face_valid": face_valid, "inner": inner}


def ich_contains(hull: dict, points: torch.Tensor, pts_pool: torch.Tensor) -> torch.Tensor:
    """Containment in an ICH (ConvexHull::Contains): a point (P, 3) is
    inside iff vol(face, p) > 0 for every valid face of ``hull`` (its
    ``faces`` index ``pts_pool``)."""
    tp = pts_pool[hull["faces"].long()]                       # (F, 3, 3)
    v = _vol(tp[None], points[:, None])                       # (P, F)
    ok = (v > 0) | ~hull["face_valid"][None, :]
    return torch.all(ok, dim=1)
