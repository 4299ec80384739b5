"""The general traffic generator: every input of an event is drawn from
``--seed`` and the event's index alone, so a run's inputs repeat exactly
for its seed and do not depend on how fast earlier events ran."""

from __future__ import annotations

import math

import numpy as np
import torch


def stream(seed: int, *index: int) -> torch.Generator:
    """A host ``torch.Generator`` for (``seed``, ``index``...): any whole
    ``seed`` (past 64 bits too) mixed with the indices by numpy's
    ``SeedSequence``."""
    words = [int(seed) % (1 << 128), *(int(i) for i in index)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32))


def uniform_seeds(g: torch.Generator, n: int) -> torch.Tensor:
    """``n`` Voronoi seeds uniform in the unit cube [-0.5, 0.5]³."""
    return torch.rand((n, 3), generator=g) - 0.5


def radial_seeds(g: torch.Generator, n: int, mean: float) -> torch.Tensor:
    """``n`` impact-pattern seeds: a uniform direction times an exponential
    length of mean ``mean``, clamped to [1e-12, 0.5]."""
    d = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    ln = torch.clamp(torch.empty((n,)).exponential_(generator=g) * mean, 1e-12, 0.5)
    return d * ln[:, None]


def fracture_seeds(seed: int, i: int, fcfg: dict):
    """Event ``i``'s seed triple for a decomposition at the configuration
    ``fcfg`` (its dict): uniform, partial pattern, general pattern."""
    g = stream(seed, 1, i)
    return (uniform_seeds(g, fcfg["initial_decompose_cell_cnt"]),
            radial_seeds(g, fcfg["partial_pattern_cell_cnt"], fcfg["partial_pattern_dist"]),
            radial_seeds(g, fcfg["general_pattern_cell_cnt"], fcfg["general_pattern_dist"]))


def down_ray(seed: int, i: int, traffic: dict):
    """Event ``i``'s ray: straight down from height ``ray_y`` at a point
    uniform by area over the ring ``ray_radius`` = [r0, r1] about the y
    axis → (origin, direction) as Python floats."""
    g = stream(seed, 2, i)
    u = torch.rand((2,), generator=g, dtype=torch.float64).tolist()
    r0, r1 = traffic["ray_radius"]
    r = math.sqrt(r0 * r0 + u[0] * (r1 * r1 - r0 * r0))
    a = 2.0 * math.pi * u[1]
    return (r * math.cos(a), float(traffic["ray_y"]), r * math.sin(a)), tuple(
        float(c) for c in traffic["direction"])


def sample_index(seed: int, below: int) -> int:
    """The event whose output a run holds against the reference: drawn from
    ``seed`` in [0, ``below``)."""
    return int(torch.randint(0, below, (1,), generator=stream(seed, 3)))
