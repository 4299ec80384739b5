"""Helpers on the contact-slot layout shared by contact prep, the solver
and the compound-body path: C = K·M + G slots per row, slot = m·K + k for
pair slots, then G ground slots. Plain PyTorch on both devices, each in the
kernels' own order of operations.
"""

from __future__ import annotations

import torch

from plainref.ops.linalg import sqrt_rn


def expand_slots(block: torch.Tensor, M: int, G: int) -> torch.Tensor:
    """(Np, K) per-pair values → (Np, C): tiled over M, zero ground slots."""
    return torch.cat([block.repeat(1, M), block.new_zeros((block.shape[0], G))], dim=1)


def slot_rows(raw: torch.Tensor, r: int, M: int) -> torch.Tensor:
    """Row r of every manifold point of the (Np, K, 5+6M) pair records →
    (Np, M·K), slot = m·K + k."""
    Np, K = raw.shape[:2]
    return raw[:, :, r::6][:, :, :M].permute(0, 2, 1).reshape(Np, M * K)


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """(Np, C, ...) → (Np, 1, ...), summed slot by slot from 0 (the kernels'
    order)."""
    s = torch.zeros_like(x[:, :1])
    for c in range(x.shape[1]):
        s = s + x[:, c : c + 1]
    return s


def tangent_basis(nx, ny, nz):
    """Deterministic tangent basis (û, v̂) of unit normals given
    componentwise: û = normalize(e × n) with e the axis of n's smallest
    component (first of ties), v̂ = n × û. The warm-start frame of the JAX
    package's accumulated solver mode."""
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    ex = ((ax <= ay) & (ax <= az)).to(nx.dtype)
    ey = ((ay < ax) & (ay <= az)).to(nx.dtype)
    ez = 1.0 - ex - ey
    ux = ey * nz - ez * ny
    uy = ez * nx - ex * nz
    uz = ex * ny - ey * nx
    ul = sqrt_rn((ux * ux + uy * uy) + uz * uz)
    inv = 1.0 / torch.clamp(ul, min=1e-12)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    return (ux, uy, uz), (vx, vy, vz)
