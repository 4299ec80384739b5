"""Seeded fracture patterns (counterpart of ``surtr_tpu/fracture/pattern.py``).

Uniform cube seeds U(-0.5, 0.5)^3 for the initial decomposition and radial
impact patterns (uniform direction × exponential length clamped to
[1e-12, 0.5]). Randomness comes from an explicit ``torch.Generator``; it
does not reproduce ``jax.random`` streams, so parity tests pass the JAX
package's own seeds in.
"""

from __future__ import annotations

import torch

from plainref.ops.voronoi import voronoi_cells
from plainref.types import ConvexPoly


def uniform_seeds(gen: torch.Generator, n: int, device=None) -> torch.Tensor:
    return (torch.rand((n, 3), generator=gen) - 0.5).to(device)


def radial_seeds(gen: torch.Generator, n: int, mean: float, device=None) -> torch.Tensor:
    d = torch.rand((n, 3), generator=gen) * 2.0 - 1.0
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    ln = torch.empty((n,)).exponential_(generator=gen) * mean
    ln = torch.clamp(ln, 1e-12, 0.5)
    return (d * ln[:, None]).to(device)


def pattern_cells(seeds: torch.Tensor, k: int | None, F: int, S: int) -> ConvexPoly:
    """Voronoi cells of a seed cloud in the unit cube; k=None uses all-pairs
    bisectors (required for the clustered radial patterns)."""
    n = seeds.shape[0]
    if k is None:
        k = n - 1
    return voronoi_cells(seeds, k=min(k, n - 1), F=F, S=S)
