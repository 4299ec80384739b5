"""Batched multi-mesh fracture (counterpart of ``surtr_tpu/fracture/batch.py``;
BASELINE config 2: 1k Voronoi seeds per event across 64 meshes).

On one device the mesh batch is a loop of ``prepare_fracture`` calls, each
of which already fills the card through its cells × faces × slots work,
and the results are stacked once after the loop. ``sharded_batch_decompose``
splits the batch evenly over a list of devices, one shard a device, from one
process (the single-controller counterpart of the JAX package's
``shard_map``), and sums the piece counts of all shards.
"""

from __future__ import annotations

import torch

from plainref.config import FractureConfig
from plainref.fracture.pipeline import draw_seeds, prepare_fracture
from plainref.types import device_context, map_tree, shard_bounds, stack_tree


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


@torch.no_grad()
def sharded_batch_decompose(devices, verts, vmask, tri_corners, tmask, sphere_cloud,
                            cfg: FractureConfig, seeds=None, partial_seeds=None,
                            general_seeds=None, generator: torch.Generator | None = None):
    """``batch_decompose`` with the mesh batch split evenly over ``devices``
    (a list of torch devices; one device may repeat): shard i runs on
    ``devices[i]``. Seeds left None are drawn first, per mesh in mesh
    order, as ``batch_decompose`` draws them, so each shard equals the same
    meshes' slice of one ``batch_decompose`` call. Returns (the shards'
    PieceSets, each on its device, and Σ piece_cnt over all meshes as a 0-d
    tensor on ``devices[0]``)."""
    M = verts.shape[0]
    bounds = shard_bounds(M, devices)
    given = (seeds, partial_seeds, general_seeds)
    if any(a is None for a in given):
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        drawn = [draw_seeds(cfg, generator, *(None if a is None else a[i] for a in given))
                 for i in range(M)]
        seeds, partial_seeds, general_seeds = (torch.stack(d) for d in zip(*drawn))
    shards, total = [], None
    for dev, sl in zip(devices, bounds):
        part = map_tree((verts, vmask, tri_corners, tmask, seeds, partial_seeds, general_seeds),
                        lambda a: a[sl].to(dev))
        v, vm, tc, tm, s, ps, gs = part
        with device_context(dev):
            pieces, met = batch_decompose(v, vm, tc, tm, sphere_cloud.to(dev), cfg, seeds=s,
                                          partial_seeds=ps, general_seeds=gs)
        shards.append(pieces)
        cnt = met["piece_cnt"].sum().to(devices[0])
        total = cnt if total is None else total + cnt
    return shards, total
