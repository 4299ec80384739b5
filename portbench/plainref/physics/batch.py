"""Batched multi-scene stepping (counterpart of ``surtr_tpu/physics/batch.py``:
config 2's mesh batch extended to dynamics).

A batch is one ``PhysicsScene`` whose every field has a leading (M,) axis
(``stack_scenes``). On one device ``batch_step`` steps each scene in turn
and restacks the results. ``sharded_batch_step`` splits the batch evenly
over a list of devices, one shard a device, from one process (the
single-controller counterpart of the JAX package's ``shard_map``), and sums
an activity tally over all shards.
"""

from __future__ import annotations

import torch

from plainref.config import PhysicsConfig
from plainref.physics.scene import PhysicsScene
from plainref.physics.step import physics_step
from plainref.types import device_context, index_tree, map_tree, shard_bounds, stack_tree


def stack_scenes(scenes: list[PhysicsScene]) -> PhysicsScene:
    """M like-shaped scenes → one scene with a leading (M,) axis on every
    field."""
    return stack_tree(scenes)


def unstack_scenes(batch: PhysicsScene) -> list[PhysicsScene]:
    """The inverse of ``stack_scenes``."""
    return [index_tree(batch, i) for i in range(batch.piece_owner.shape[0])]


@torch.no_grad()
def batch_step(scenes: PhysicsScene, cfg: PhysicsConfig, n_steps: int = 1) -> PhysicsScene:
    """Step M independent scenes (a stacked ``PhysicsScene``) ``n_steps``
    times each. Returns the stepped batch."""
    out = []
    for scene in unstack_scenes(scenes):
        for _ in range(n_steps):
            scene = physics_step(scene, cfg)
        out.append(scene)
    return stack_scenes(out)


def activity(scenes: PhysicsScene) -> torch.Tensor:
    """Σ active·(|v|² + |ω|²) over every body of a (stacked) scene, a
    mass-free motion tally (not kinetic energy), summed in float64."""
    b = scenes.bodies
    sq = b.v.double() ** 2 + b.w.double() ** 2
    return torch.sum(torch.where(b.active[..., None], sq, 0.0))


@torch.no_grad()
def sharded_batch_step(devices, scenes: PhysicsScene, cfg: PhysicsConfig, n_steps: int = 1):
    """``batch_step`` with the scene batch split evenly over ``devices`` (a
    list of torch devices; one device may repeat): shard i is stepped on
    ``devices[i]``. Returns (the stepped shards, each on its device, and
    ``activity`` summed over all shards in float64 and rounded once to
    float32, a 0-d tensor on ``devices[0]``)."""
    shards, total = [], None
    for dev, sl in zip(devices, shard_bounds(scenes.piece_owner.shape[0], devices)):
        with device_context(dev):
            out = batch_step(map_tree(index_tree(scenes, sl), lambda a: a.to(dev)), cfg, n_steps)
        shards.append(out)
        a = activity(out).to(devices[0])
        total = a if total is None else total + a
    return shards, total.to(scenes.bodies.v.dtype)
