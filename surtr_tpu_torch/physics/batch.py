"""Batched multi-scene stepping (counterpart of ``surtr_tpu/physics/batch.py``:
config 2's mesh batch extended to dynamics).

A batch is one ``PhysicsScene`` whose every field has a leading (M,) axis
(``stack_scenes``). On one device ``batch_step`` steps each scene in turn
and restacks the results. The multi-device variant, ``sharded_batch_step``
of the JAX package, waits for a multi-GPU host (ROADMAP A13).
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.config import PhysicsConfig
from surtr_tpu_torch.physics.scene import PhysicsScene
from surtr_tpu_torch.physics.step import physics_step
from surtr_tpu_torch.types import index_tree, stack_tree


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
