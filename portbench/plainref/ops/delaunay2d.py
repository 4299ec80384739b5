"""2-D Delaunay triangulation (Bowyer–Watson; counterpart of
``surtr_tpu/ops/delaunay2d.py``, the reference's header-only DT, dead code
on its shipping path but kept as a capability).

The padded-table design of ``ops/delaunay.py`` one dimension down: a
(T, 3) triangle table with a valid mask, a super-triangle in the last
three rows of the extended points, one loop iteration per inserted point.
Plain PyTorch; the circumcircle is written out (2×2 Cramer), as the JAX
package writes it.
"""

from __future__ import annotations

import torch

from plainref.ops.delaunay import insert_cavities, sq_norm, super_points

_EDGES = ((0, 1), (1, 2), (0, 2))


def circumcircle(tri_pts: torch.Tensor):
    """Circumcentre and squared radius of triangles (..., 3, 2); a
    degenerate triangle (|det| <= 1e-20) gets r2 = -1."""
    a, b, c = tri_pts[..., 0, :], tri_pts[..., 1, :], tri_pts[..., 2, :]
    M = torch.stack([b - a, c - a], dim=-2) * 2.0
    rhs = torch.stack([sq_norm(b) - sq_norm(a), sq_norm(c) - sq_norm(a)], dim=-1)
    det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    ok = torch.abs(det) > 1e-20
    one = torch.ones_like(det)
    inv_det = torch.where(ok, one / torch.where(ok, det, one), torch.zeros_like(det))
    cx = (rhs[..., 0] * M[..., 1, 1] - rhs[..., 1] * M[..., 0, 1]) * inv_det
    cy = (rhs[..., 1] * M[..., 0, 0] - rhs[..., 0] * M[..., 1, 0]) * inv_det
    center = torch.stack([cx, cy], dim=-1)
    r2 = torch.where(ok, sq_norm(center - a), torch.full_like(det, -1.0))
    return center, r2


@torch.no_grad()
def delaunay2d(points: torch.Tensor, mask: torch.Tensor, max_tris: int | None = None):
    """points (N, 2) padded, mask (N,). Returns dict with tris (T, 3) i32
    into the extended points (N + 3, 2) whose last 3 rows are the
    super-triangle, T = max(4N, 32) by default; tri_valid (T,) (triangles
    touching the super-triangle left out) and circumcenters (T, 2)."""
    N = points.shape[0]
    dev = points.device
    pts = super_points(points, mask, [[-1.5, -1.0], [1.5, -1.0], [0.0, 1.8]], 16.0)
    T = max_tris if max_tris is not None else max(4 * N, 32)
    tris = torch.zeros((T, 3), dtype=torch.int32, device=dev)
    tris[0] = torch.arange(N, N + 3, dtype=torch.int32, device=dev)
    valid = torch.zeros((T,), dtype=torch.bool, device=dev)
    valid[0] = True
    cc, r2 = circumcircle(pts[tris.long()])
    tris, valid, cc, _ = insert_cavities(tris, valid, cc, r2, pts, mask, N, circumcircle,
                                         _EDGES)
    touches_super = torch.any(tris >= N, dim=1)
    return {"points": pts, "tris": tris, "tri_valid": valid & ~touches_super,
            "circumcenters": cc}
