"""Polytope volume and centroid (counterpart of ``surtr_tpu/ops/moments.py``).

Divergence-theorem fan accumulation of the reference's Poly::Moments: per
face, fan triangles (p0, pk, pk+1) about the vertex mean contribute
dV = p0·(pk × pk+1); V = ΣdV / 6, centroid = Σ(p0+pk+pk+1)·dV / (24 V).

The sums over a polytope's slots are taken in float64 and rounded once to
float32, the cross and dot products are written out and the constant
divisions are true divisions (``div_rn``): the card and the CPU then give
the same bits, though each reduces in its own order, but for a sum that
lies next to a float32 rounding boundary (the volumes order pieces and
jobs, so one ulp decides which of two near-equal pieces comes first).
"""

from __future__ import annotations

import torch

from plainref.ops.hull import _cross
from plainref.ops.linalg import div_rn, dot3
from plainref.types import ConvexPoly


def _fsum(x: torch.Tensor, dim) -> torch.Tensor:
    """Sum over ``dim`` in float64, rounded once to ``x``'s type."""
    return torch.sum(x.double(), dim=dim).to(x.dtype)


def _fan_terms(poly: ConvexPoly):
    fv = poly.face_verts
    nv = poly.n_verts
    S = poly.S
    sm = poly.slot_mask()
    total = torch.clamp(sm.sum(dim=(-1, -2)), min=1).to(fv.dtype)
    origin = _fsum(torch.where(sm[..., None], fv, 0.0), (-2, -3)) / total[..., None]
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
    dV = dot3(p0, _cross(pk, pk1))
    dV = torch.where(fm, dV, 0.0)
    vol = div_rn(_fsum(dV, (-1, -2)), 6.0)
    csum = _fsum((p0 + pk + pk1) * dV[..., None], (-2, -3))
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
    dV = dot3(p0, _cross(pk, pk1))
    dV = torch.where(fm, dV, 0.0)
    vol = div_rn(_fsum(dV, (-1, -2)), 6.0)

    a, b, c = p0.expand_as(pk), pk, pk1
    s = a + b + c
    c_tet = _outer(a) + _outer(b) + _outer(c) + _outer(s)
    C = div_rn(_fsum(c_tet * dV[..., None, None], (-3, -4)), 120.0)

    csum = _fsum(s * dV[..., None], (-2, -3))
    denom = 24.0 * vol
    safe = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    com_local = csum / safe[..., None]
    com = com_local + origin

    C_c = C - vol[..., None, None] * _outer(com_local)
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    trace = (C_c[..., 0, 0] + C_c[..., 1, 1]) + C_c[..., 2, 2]
    I_com = density * (trace[..., None, None] * eye - C_c)
    return density * vol, com, I_com


def aabb(poly: ConvexPoly):
    """Masked axis-aligned bounds: (min, max), each (..., 3)."""
    sm = poly.slot_mask()[..., None]
    fv = poly.face_verts
    lo = torch.amin(torch.where(sm, fv, 3.4e38).flatten(-3, -2), dim=-2)
    hi = torch.amax(torch.where(sm, fv, -3.4e38).flatten(-3, -2), dim=-2)
    return lo, hi


def all_verts(poly: ConvexPoly):
    """Flattened (possibly duplicated) vertex pool: ((..., F·S, 3), mask)."""
    fv = poly.face_verts.reshape(poly.batch_shape + (poly.F * poly.S, 3))
    m = poly.slot_mask().reshape(poly.batch_shape + (poly.F * poly.S,))
    return fv, m
