"""Bounded 3-D Voronoi cells (counterpart of ``surtr_tpu/ops/voronoi.py``;
reference voro++): the cell of seed i is the domain clipped by the
bisector half-spaces toward its k nearest seeds, nearest first."""

from __future__ import annotations

import torch

from plainref.ops.clip_cuda import clip_planes_batch
from plainref.ops.linalg import dot3, sqrt_rn
from plainref.types import ConvexPoly, unit_cube

BIG = 3.4e38


def nearest_first(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, largest first, lower index
    first among ties (exact; the order of ``jax.lax.top_k``)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def bisector_planes(seed: torch.Tensor, others: torch.Tensor, other_mask: torch.Tensor):
    """Half-spaces keeping points closer to ``seed`` (..., 3) than to each of
    ``others`` (..., K, 3): n = (o - s)/|o - s|, d = -n·midpoint. Returns
    ((..., K, 4), (..., K) mask)."""
    seed = seed[..., None, :]
    diff = others - seed
    dist = sqrt_rn(dot3(diff, diff))[..., None]
    ok = other_mask & (dist[..., 0] > 1e-12)
    n = diff / torch.clamp(dist, min=1e-30)
    mid = (others + seed) * 0.5
    d = -dot3(n, mid)[..., None]
    return torch.cat([n, d], dim=-1), ok


def voronoi_cells(seeds: torch.Tensor, seed_mask: torch.Tensor | None = None,
                  k: int = 48, F: int = 32, S: int = 16) -> ConvexPoly:
    """Voronoi cells of ``seeds`` (N, 3) in the unit cube; cells of invalid
    seeds are empty."""
    N = seeds.shape[0]
    dev = seeds.device
    if seed_mask is None:
        seed_mask = torch.ones((N,), dtype=torch.bool, device=dev)
    k = min(k, max(N - 1, 1))
    r = seeds[:, None] - seeds[None, :]
    d2 = dot3(r, r)
    d2 = torch.where(seed_mask[None, :], d2, torch.full_like(d2, BIG))
    d2.fill_diagonal_(BIG)
    idx = nearest_first(-d2, k)
    nb_ok = torch.gather(d2, 1, idx) < BIG / 2
    planes, pm = bisector_planes(seeds, seeds[idx], nb_ok)
    dom = unit_cube(F=F, S=S, dtype=seeds.dtype, device=dev).map(
        lambda a: a[None].expand((N,) + a.shape).contiguous()
    )
    cells = clip_planes_batch(dom, planes, pm)
    nv = torch.where(seed_mask[:, None], cells.n_verts, torch.zeros_like(cells.n_verts))
    return ConvexPoly(cells.face_verts, nv, cells.planes)
