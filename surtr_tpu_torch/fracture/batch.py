"""Batched multi-mesh fracture (counterpart of ``surtr_tpu/fracture/batch.py``;
BASELINE config 2: 1k Voronoi seeds per event across 64 meshes).

On one device the mesh batch is a loop of ``prepare_fracture`` calls, each
of which already fills the card through its cells × faces × slots work,
and the results are stacked once after the loop. The multi-device variant,
``sharded_batch_decompose`` of the JAX package, waits for a multi-GPU host
(ROADMAP A13).
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.config import FractureConfig
from surtr_tpu_torch.fracture.pipeline import prepare_fracture
from surtr_tpu_torch.types import stack_tree


@torch.no_grad()
def batch_decompose(verts, vmask, tri_corners, tmask, sphere_cloud, cfg: FractureConfig,
                    seeds=None, partial_seeds=None, general_seeds=None,
                    generator: torch.Generator | None = None):
    """Decompose M meshes, each with its own seeds.

    verts (M, V, 3), vmask (M, V), tri_corners (M, T, 3, 3), tmask (M, T);
    ``sphere_cloud`` is shared. ``seeds`` (M, C, 3), ``partial_seeds``
    (M, Cp, 3) and ``general_seeds`` (M, Cg, 3) give each mesh its seeds;
    those left None are drawn per mesh, in mesh order, from ``generator``
    (a ``torch.Generator``, seeded from ``cfg.seed`` when None). Returns
    (PieceSet, metrics dict), every field with a leading (M,) axis."""
    M = verts.shape[0]
    if generator is None and (seeds is None or partial_seeds is None or general_seeds is None):
        generator = torch.Generator().manual_seed(cfg.seed)
    pick = lambda a, i: None if a is None else a[i]  # noqa: E731
    pieces, metrics = [], []
    for i in range(M):
        p, _, met = prepare_fracture(verts[i], vmask[i], tri_corners[i], tmask[i], sphere_cloud,
                                     cfg, pick(seeds, i), pick(partial_seeds, i),
                                     pick(general_seeds, i), generator=generator)
        pieces.append(p)
        metrics.append(met)
    return stack_tree(pieces), stack_tree(metrics)
