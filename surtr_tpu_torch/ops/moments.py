"""Polytope volume and centroid (counterpart of ``surtr_tpu/ops/moments.py``).

Divergence-theorem fan accumulation of the reference's Poly::Moments: per
face, fan triangles (p0, pk, pk+1) about the vertex mean contribute
dV = p0·(pk × pk+1); V = ΣdV / 6, centroid = Σ(p0+pk+pk+1)·dV / (24 V).
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.types import ConvexPoly


def _fan_terms(poly: ConvexPoly):
    fv = poly.face_verts
    nv = poly.n_verts
    S = poly.S
    sm = poly.slot_mask()
    total = torch.clamp(sm.sum(dim=(-1, -2)), min=1).to(fv.dtype)
    origin = torch.sum(torch.where(sm[..., None], fv, 0.0), dim=(-2, -3)) / total[..., None]
    p = fv - origin[..., None, None, :]
    slot = torch.arange(S, dtype=torch.int32, device=fv.device)
    fan_mask = (slot >= 1) & (slot <= nv[..., None] - 2)
    fan_mask = fan_mask & poly.face_mask()[..., None]
    p0 = p[..., :, 0:1, :]
    pk1 = torch.roll(p, -1, dims=-2)
    return origin, p0, p, pk1, fan_mask


def moments(poly: ConvexPoly):
    """Returns (volume, centroid); batch-shaped."""
    origin, p0, pk, pk1, fm = _fan_terms(poly)
    dV = torch.sum(p0 * torch.linalg.cross(pk, pk1, dim=-1), dim=-1)
    dV = torch.where(fm, dV, 0.0)
    vol = torch.sum(dV, dim=(-1, -2)) / 6.0
    csum = torch.sum((p0 + pk + pk1) * dV[..., None], dim=(-2, -3))
    denom = 24.0 * vol
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    centroid = csum / safe[..., None] + origin
    centroid = torch.where(torch.abs(vol)[..., None] > 1e-30, centroid, origin)
    return vol, centroid
