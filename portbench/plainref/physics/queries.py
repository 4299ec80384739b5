"""Scene queries for impact picking (counterpart of
``surtr_tpu/physics/queries.py``): ``raycast``, the nearest piece a ray hits
(slab method against each piece's world planes), and ``sphere_overlap``,
the pieces that overlap the impact sphere. Both run on the scene's device
and return device tensors (no host sync).
"""

from __future__ import annotations

import torch

from plainref.ops.linalg import dot3, rot_points
from plainref.physics.rigid import quat_to_mat
from plainref.physics.scene import PhysicsScene, piece_world_verts

BIG = 3.4e38


def _world_planes(scene: PhysicsScene):
    """Piece face planes in world space: (normals (Np, F, 3), offsets (Np, F))."""
    owner = torch.clamp(scene.piece_owner, 0, scene.B - 1).long()
    R = quat_to_mat(scene.bodies.q)[owner]
    x = scene.bodies.x[owner]
    n = rot_points(R, scene.piece_planes[..., :3])
    d = scene.piece_planes[..., 3] - dot3(n, x[:, None, :])
    return n, d


def raycast(scene: PhysicsScene, origin: torch.Tensor, direction: torch.Tensor):
    """Ray against every piece convex. Returns (piece index, t) as 0-d
    tensors; index -1 and t -1 on a miss, the first piece on ties."""
    n, d = _world_planes(scene)
    pm = scene.piece_pmask & scene.piece_valid[:, None]
    no = dot3(n, origin) + d
    nd = dot3(n, direction)
    t_hit = -no / torch.where(torch.abs(nd) > 1e-12, nd, 1e-12)
    # Entering faces (nd < 0) bound t from below, the others from above.
    entering = nd < 0
    t_enter = torch.where(pm & entering, t_hit, -BIG).amax(1)
    t_exit = torch.where(pm & ~entering, t_hit, BIG).amin(1)
    # Outside a face the ray runs parallel to: a miss.
    outside_parallel = torch.any(pm & (torch.abs(nd) <= 1e-12) & (no > 0), dim=1)
    # A piece with no valid plane must never report a hit.
    has_planes = torch.any(pm, dim=1)
    hit = (scene.piece_valid & has_planes & (t_enter <= t_exit) & (t_exit > 0)
           & ~outside_parallel)
    t0 = torch.where(t_enter > 0, t_enter, 0.0)
    t_best = torch.where(hit, t0, BIG)
    idx = torch.argmin(t_best)
    tb = t_best[idx]
    found = tb < BIG / 2
    return torch.where(found, idx, -1), torch.where(found, tb, -1.0)


def sphere_overlap(scene: PhysicsScene, center: torch.Tensor, radius) -> torch.Tensor:
    """(Np,) bool — pieces whose convex meets the sphere: every plane
    distance of the centre at most ``radius``, or a hull corner within it.
    Pieces with no valid plane never read as inside."""
    n, d = _world_planes(scene)
    pm = scene.piece_pmask & scene.piece_valid[:, None]
    s = dot3(n, center) + d
    maxs = torch.where(pm, s, -BIG).amax(1)
    near = (maxs <= radius) & torch.any(pm, dim=1)
    wv, wm = piece_world_verts(scene)
    rel = wv - center
    vert_near = torch.any(wm & (dot3(rel, rel) <= radius * radius), dim=1)
    return scene.piece_valid & (near | vert_near)


def body_of_piece(scene: PhysicsScene, piece_idx):
    """The body owning a piece index, -1 for a negative index."""
    piece_idx = torch.as_tensor(piece_idx, device=scene.piece_owner.device)
    return torch.where(piece_idx >= 0, scene.piece_owner[torch.clamp(piece_idx, min=0)], -1)
