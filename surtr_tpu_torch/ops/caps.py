"""Cut-face matching (counterpart of ``match_cut_faces`` in
``surtr_tpu/ops/caps.py``). The exact closed-mesh caps of that module are
not ported yet (``exact_caps=True`` raises in the pipeline)."""

from __future__ import annotations

import torch

from surtr_tpu_torch.ops.linalg import supports


def match_cut_faces(poly, cut_planes, cut_mask, scale, tol: float = 1e-4):
    """(..., F) bool — faces of ``poly`` whose plane equals one of the cut
    planes (..., Kc, 4) (cap faces carry their cut plane bitwise, so a loose
    tolerance suffices)."""
    n = poly.planes[..., :3]
    d = poly.planes[..., 3]
    ndot = supports(n, cut_planes[..., :3].expand(n.shape[:-2] + cut_planes.shape[-2:-1] + (3,)))
    dm = torch.abs(d[..., None] - cut_planes[..., None, :, 3])
    hit = (torch.abs(ndot - 1.0) < tol) & (dm < tol * scale) & cut_mask[..., None, :]
    return torch.any(hit, dim=-1) & poly.face_mask()
