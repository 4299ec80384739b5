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


def _outer(x: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * x[..., None, :]


def inertia(poly: ConvexPoly, density: float = 10.0):
    """Returns (mass, com, I_com), I_com the 3×3 inertia about the centroid:
    the second moment of each signed fan tetra (o, a, b, c) is
    det/120 · (Σ pᵢpᵢᵀ + s sᵀ), s = a + b + c, moved to the centroid by the
    parallel-axis rule (reference: updateMassAndInertia at density 10)."""
    origin, p0, pk, pk1, fm = _fan_terms(poly)
    dV = torch.sum(p0 * torch.linalg.cross(pk, pk1, dim=-1), dim=-1)
    dV = torch.where(fm, dV, 0.0)
    vol = torch.sum(dV, dim=(-1, -2)) / 6.0

    a, b, c = p0.expand_as(pk), pk, pk1
    s = a + b + c
    c_tet = _outer(a) + _outer(b) + _outer(c) + _outer(s)
    C = torch.sum(c_tet * dV[..., None, None], dim=(-3, -4)) / 120.0

    csum = torch.sum(s * dV[..., None], dim=(-2, -3))
    denom = 24.0 * vol
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    com_local = csum / safe[..., None]
    com = com_local + origin

    C_c = C - vol[..., None, None] * _outer(com_local)
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    trace = C_c.diagonal(dim1=-2, dim2=-1).sum(-1)
    I_com = density * (trace[..., None, None] * eye - C_c)
    return density * vol, com, I_com
