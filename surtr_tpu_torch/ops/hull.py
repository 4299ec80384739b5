"""Limited incremental convex hull (counterpart of ``surtr_tpu/ops/hull.py``;
reference VMACH::ConvexHull).

Greedy volume-max insertion capped at ``limit`` points: a seed tetrahedron
from extreme points (max x, farthest, max area, max volume), then per step
the unprocessed point with the largest Σ max(0, vol(face, p)), the horizon
by twin-edge matching, new faces on free slots in stable slot order, each
oriented outward against the seed centroid. Plain PyTorch; the hand-written
kernel is in ``hull_cuda.py``.
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.ops.linalg import dot3, sqrt_rn

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
    (F,), normals (F, 3), inner (3,) with F = 2·max(limit, 4) + 4."""
    N = points.shape[0]
    dev = points.device
    F = max_faces if max_faces is not None else 2 * max(limit, 4) + 4
    pts = points
    neg = torch.tensor(NEG, dtype=pts.dtype, device=dev)

    i1 = _first_argmax(torch.where(mask, pts[:, 0], neg))
    r = pts - pts[i1]
    d1 = torch.where(mask, dot3(r, r), neg)
    i2 = _first_argmax(d1)
    e12 = pts[i2] - pts[i1]
    cr = _cross(e12.expand_as(pts), pts - pts[i1])
    area = torch.where(mask, dot3(cr, cr), neg)
    i3 = _first_argmax(area)
    tri = torch.stack([pts[i1], pts[i2], pts[i3]])
    i4 = _first_argmax(torch.where(mask, _vol(tri, pts), neg))

    idx4 = torch.stack([i1, i2, i3, i4])
    q = pts[idx4]
    inner = (((q[0] + q[1]) + q[2]) + q[3]) * 0.25
    init = torch.stack(
        [
            torch.stack([i1, i2, i3]),
            torch.stack([i1, i2, i4]),
            torch.stack([i1, i3, i4]),
            torch.stack([i2, i3, i4]),
        ]
    )
    flip = _vol(pts[init], inner) < 0
    init = torch.where(flip[:, None], init[:, [0, 2, 1]], init)

    faces = torch.zeros((F, 3), dtype=torch.long, device=dev)
    faces[:4] = init
    fvalid = torch.zeros((F,), dtype=torch.bool, device=dev)
    fvalid[:4] = True
    processed = torch.zeros((N,), dtype=torch.bool, device=dev)
    processed[idx4] = True

    def vols_all(faces, fv):
        tp = pts[faces]                                       # (F, 3, 3)
        v = _vol(tp[None], pts[:, None])                      # (N, F)
        return torch.where(fv[None, :], v, torch.zeros_like(v))

    priority = torch.sum(torch.clamp(vols_all(faces, fvalid), min=0.0), dim=1)
    priority = torch.where(mask & ~processed, priority, neg)

    n_insert = max(min(limit, N) - 4, 0)
    for _ in range(n_insert):
        k = _first_argmax(priority)
        p = pts[k]
        can = priority[k] > NEG / 2
        volf = torch.where(fvalid, _vol(pts[faces], p), torch.zeros((), dtype=pts.dtype, device=dev))
        visible = fvalid & (volf < 0)
        any_vis = torch.any(visible) & can

        fe0 = faces.reshape(-1)
        fe1 = torch.roll(faces, -1, dims=1).reshape(-1)
        owner_vis = visible.repeat_interleave(3)
        owner_val = fvalid.repeat_interleave(3)
        twin = (fe0[:, None] == fe1[None, :]) & (fe1[:, None] == fe0[None, :])
        twin = twin & owner_val[None, :]
        twin_hidden = torch.any(twin & ~owner_vis[None, :], dim=1)
        horizon = owner_vis & owner_val & twin_hidden

        fvalid_mid = fvalid & ~(visible & any_vis)
        free_order = torch.sort(fvalid_mid.to(torch.int32), stable=True).indices
        hz = horizon.to(torch.long)
        rank = torch.cumsum(hz, 0) - hz
        slot = free_order[torch.clamp(rank, max=F - 1)]
        new_face = torch.stack([fe0, fe1, torch.zeros_like(fe0) + k], dim=1)
        nv = _vol(pts[new_face], inner)
        new_face = torch.where((nv < 0)[:, None], new_face[:, [0, 2, 1]], new_face)
        do = horizon & any_vis
        tgt = torch.where(do, slot, torch.full_like(slot, F))
        faces2 = torch.cat([faces, torch.zeros((1, 3), dtype=torch.long, device=dev)])
        faces2[tgt] = new_face
        faces2 = faces2[:F]
        fvalid2 = torch.cat([fvalid_mid, torch.zeros((1,), dtype=torch.bool, device=dev)])
        fvalid2[tgt] = do
        fvalid2 = fvalid2[:F]

        v_old = vols_all(faces, visible)
        v_new = vols_all(faces2, fvalid2 & ~fvalid_mid)
        dp = torch.sum(torch.clamp(v_new, min=0.0), 1) - torch.sum(torch.clamp(v_old, min=0.0), 1)
        priority2 = torch.where(mask & ~processed, priority + dp, neg)
        processed = processed.clone()
        processed[k] = processed[k] | can
        priority2[k] = neg
        prio_skip = priority.clone()
        prio_skip[k] = neg

        faces = torch.where(any_vis, faces2, faces)
        fvalid = torch.where(any_vis, fvalid2, fvalid)
        priority = torch.where(any_vis, priority2, prio_skip)

    tp = pts[faces]
    nrm = _cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
    ln = sqrt_rn(dot3(nrm, nrm))[:, None]
    nrm = nrm / torch.clamp(ln, min=1e-30)
    fvalid = fvalid & (ln[:, 0] > 1e-20)
    return {
        "faces": faces.to(torch.int32),
        "face_valid": fvalid,
        "normals": torch.where(fvalid[:, None], nrm, torch.zeros_like(nrm)),
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
