"""The scene API (counterpart of ``surtr_tpu/scene.py``): load a model,
prepare the initial compound, step physics at a fixed 1/120 s, fire impacts
that refracture compounds, render shadow-mapped frames.

``interactive_frame`` is the reference application's whole tick: raycast
impact → radial target selection → bake → refracture → rigid rebuild with
velocity transfer → one physics step → shadow-mapped render. It runs every
stage on every frame: a ray that misses still runs ``do_fracture`` with an
empty target mask, the rebuild and the transfer, as the JAX package's one
fused dispatch does. Work runs on the scene's device; the camera and light
matrices are built on the CPU and copied.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from plainref.config import RenderConfig, SceneConfig
from plainref.fracture.pipeline import do_fracture, prepare_fracture
from plainref.fracture.types import PieceSet
from plainref.io.models import get_model, sphere_point_cloud
from plainref.ops.hull import _cross
from plainref.ops.linalg import div_rn, dot3, matvec3, rot_points, sqrt_rn
from plainref.ops.moments import moments
from plainref.physics.queries import raycast, sphere_overlap
from plainref.physics.rigid import quat_to_mat
from plainref.physics.scene import PhysicsScene, build_scene
from plainref.physics.step import physics_step
from plainref.render.camera import camera_view_proj, light_view_proj
from plainref.render.raster import render_scene
from plainref.types import ConvexPoly

LIGHT_DIR = (-0.4, -1.0, -0.3)
LIGHT_CENTER = (0.0, 1.0, 0.0)
LIGHT_RADIUS = 14.0
GROUND_HALF = 48.0


def _bake_pieces(pieces: PieceSet, phys: PhysicsScene, x0: torch.Tensor) -> PieceSet:
    """Each piece's geometry under its body's current transform
    p ↦ R_b (p − x0_b) + x_b, stored geometry being in the world frame of
    the last rebuild."""
    B, P = phys.B, pieces.P
    owner = torch.clamp(torch.where(pieces.valid, pieces.group, 0), 0, B - 1).long()
    R = quat_to_mat(phys.bodies.q)[owner]
    t = phys.bodies.x[owner] - matvec3(R, x0[owner])
    fv = pieces.convex.face_verts
    fv = rot_points(R, fv.reshape(P, -1, 3)).reshape(fv.shape) + t[:, None, None, :]
    n = rot_points(R, pieces.convex.planes[..., :3])
    d = pieces.convex.planes[..., 3:4] - dot3(n, t[:, None, :])[..., None]
    mesh = rot_points(R, pieces.mesh.reshape(P, -1, 3)).reshape(pieces.mesh.shape) \
        + t[:, None, None, :]
    return PieceSet(convex=ConvexPoly(fv, pieces.convex.n_verts, torch.cat([n, d], -1)),
                    mesh=mesh, mesh_valid=pieces.mesh_valid, valid=pieces.valid,
                    group=pieces.group, tag=pieces.tag)


def _transfer_velocities(phys: PhysicsScene, old: PhysicsScene, group, tag, valid):
    """New body velocity = its representative old body's (the largest tag
    among its pieces) velocity at the new COM; bodies of fresh fragments
    only (tag -1 everywhere) stay at rest."""
    B = phys.B
    gid = torch.where(valid & (group >= 0) & (group < B), group, B).long()
    t = torch.where(valid, tag, -1).to(torch.int32)
    rep = torch.full((B + 1,), -1, dtype=torch.int32, device=gid.device)
    rep = rep.scatter_reduce(0, gid, t, "amax")[:B]
    has = (rep >= 0)[:, None]
    repc = torch.clamp(rep, 0, old.B - 1).long()
    v_old, w_old, x_old = old.bodies.v[repc], old.bodies.w[repc], old.bodies.x[repc]
    v_new = v_old + _cross(w_old, phys.bodies.x - x_old)
    act = phys.bodies.active[:, None]
    v = torch.where(has & act, v_new, 0.0)
    w = torch.where(has & act, w_old, 0.0)
    return dataclasses.replace(phys, bodies=dataclasses.replace(phys.bodies, v=v, w=w))


def _piece_colors(world: PieceSet, highlight: bool) -> torch.Tensor:
    """(P·T, 3) per-triangle colors: a gray stone tint from the piece id's
    hash (pid · 2654435761 mod 2³²) >> 24, red for fresh fragments when
    ``highlight``."""
    P, T = world.P, world.T
    dev = world.valid.device
    pid = torch.arange(P, dtype=torch.int64, device=dev).repeat_interleave(T)
    h = ((pid * 2654435761) & 0xFFFFFFFF) >> 24
    tint = 0.38 + div_rn(h.to(torch.float32), 255.0) * 0.22
    colors = torch.stack([tint, tint, tint], dim=-1)
    if highlight:
        fresh = (world.tag < 0).repeat_interleave(T) & world.valid.repeat_interleave(T)
        red = torch.stack([tint * 1.8 + 0.15, tint * 0.7, tint * 0.7], dim=-1)
        colors = torch.where(fresh[:, None], red, colors)
    return colors


def render_pieces_frame(world: PieceSet, highlight: bool, eye, target, light_dir,
                        rcfg: RenderConfig, ground_y: float, wireframe: bool = False):
    """Shadow-mapped frame of world-space pieces on a ground quad (the core
    of ``Scene.render``). Returns the (H, W, 3) image."""
    P, T = world.P, world.T
    dev = world.valid.device
    tris = world.mesh.reshape(P * T, 3, 3)
    tvalid = world.mesh_valid.reshape(P * T)
    g, gy = GROUND_HALF, float(ground_y)
    ground = torch.tensor([[[-g, gy, -g], [-g, gy, g], [g, gy, g]],
                           [[-g, gy, -g], [g, gy, g], [g, gy, -g]]],
                          dtype=torch.float32, device=dev)
    tris = torch.cat([tris, ground])
    tvalid = torch.cat([tvalid, torch.ones(2, dtype=torch.bool, device=dev)])
    colors = torch.cat([_piece_colors(world, highlight),
                        torch.full((2, 3), 0.45, dtype=torch.float32, device=dev)])
    cam = camera_view_proj(eye, target, rcfg.fov_deg, rcfg.width / rcfg.height, rcfg.z_near,
                           rcfg.z_far)
    lvp = light_view_proj(light_dir, LIGHT_CENTER, LIGHT_RADIUS)
    img, _ = render_scene(tris, tvalid, colors, cam, lvp, light_dir, W=rcfg.width,
                          H=rcfg.height, shadow_size=rcfg.shadow_size, cfg=rcfg,
                          wireframe=wireframe)
    return img


def _host_ray(origin, direction):
    """Origin and unit direction as float32 CPU tensors."""
    o = torch.as_tensor(origin, dtype=torch.float32).detach().cpu().reshape(3)
    d = torch.as_tensor(direction, dtype=torch.float32).detach().cpu().reshape(3)
    return o, d / torch.clamp(sqrt_rn(dot3(d, d)), min=1e-12)


def _tagged(baked: PieceSet) -> PieceSet:
    """Pieces tagged with their current body id (untouched compounds keep
    their momentum through the rebuild)."""
    return dataclasses.replace(baked, tag=torch.where(baked.valid, baked.group, -1))


@torch.no_grad()
def interactive_frame(pieces: PieceSet, phys: PhysicsScene, x0, ctx, origin, direction, eye,
                      target, cfg: SceneConfig):
    """One whole frame: raycast impact → radial target selection → bake →
    refracture → rebuild with velocity transfer → physics step → render.
    ``origin``, ``direction``, ``eye`` and ``target`` are host values.
    Returns (pieces', phys', x0', image, fracture metrics)."""
    fcfg, pcfg = cfg.fracture, cfg.physics
    dev = pieces.valid.device
    o, d = _host_ray(origin, direction)
    o, d = o.to(dev), d.to(dev)
    pidx, t = raycast(phys, o, d)
    hit = pidx >= 0
    impact = o + d * (t + fcfg.target_adder)
    B = phys.B

    if fcfg.radial_mode:
        ov = sphere_overlap(phys, impact, fcfg.impact_radius / 2.0)
    else:
        ov = torch.arange(phys.Np, device=dev) == torch.clamp(pidx, 0, phys.Np - 1)
    own_ok = phys.piece_owner >= 0
    bt = torch.zeros((B,), dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.clamp(phys.piece_owner, 0, B - 1).long(), (ov & own_ok).to(torch.int32),
        "amax") > 0
    # Dynamic bodies only (the reference's mass filter).
    bt = bt & (phys.bodies.inv_mass > 0) & hit

    baked = _tagged(_bake_pieces(pieces, phys, x0))
    tmask = baked.valid & (baked.group >= 0) & bt[torch.clamp(baked.group, 0, B - 1).long()]
    pieces2, met = do_fracture(baked, ctx, impact, tmask, fcfg, partial=fcfg.partial_fracture)
    phys2 = build_scene(pieces2, pcfg)
    phys2 = _transfer_velocities(phys2, phys, pieces2.group, pieces2.tag, pieces2.valid)
    x0_new = phys2.bodies.x
    phys3 = physics_step(phys2, pcfg)
    world = _bake_pieces(pieces2, phys3, x0_new)
    img = render_pieces_frame(world, True, eye, target, LIGHT_DIR, cfg.render, pcfg.ground_y)
    return pieces2, phys3, x0_new, img, met


class Scene:
    """One simulated world: compounds of convex pieces and rigid dynamics,
    on ``device`` ("cuda" unless the caller asks for "cpu").

    Example:
        sc = Scene("cube")
        sc.step(120)                       # 1 second at 1/120
        sc.fire_impact((0, 10, 0), (0, -1, 0))
        frames = sc.positions()
    """

    def __init__(self, model: str | tuple = "cube", config: SceneConfig | None = None,
                 spawn: Sequence[float] = (0.0, 5.0, 0.0), seed: int | None = None,
                 device="cuda"):
        self.cfg = config or SceneConfig()
        self.device = torch.device(device)
        fcfg = self.cfg.fracture
        verts, tris = get_model(model) if isinstance(model, str) else model
        verts = np.asarray(verts, np.float32) + np.asarray(spawn, np.float32)
        tris = np.asarray(tris)
        # Convex models take the refit-face caps, which are exact for them
        # (the hull's volume is within 1% of the mesh's).
        if fcfg.exact_caps:
            from scipy.spatial import ConvexHull

            v64 = verts.astype(np.float64)
            hull_vol = ConvexHull(v64).volume
            mesh_vol = abs(float(np.einsum("ij,ij->i", v64[tris[:, 0]],
                                           np.cross(v64[tris[:, 1]], v64[tris[:, 2]])).sum()
                                 / 6.0))
            if mesh_vol > 0 and hull_vol <= mesh_vol * 1.01:
                fcfg = dataclasses.replace(fcfg, exact_caps=False)
                self.cfg = dataclasses.replace(self.cfg, fracture=fcfg)
        seed = fcfg.seed if seed is None else seed
        # The JAX package's PRNGKey(seed) layout, kept for snapshots.
        self.key = np.array([0, seed], np.uint32)
        dev = self.device
        self.pieces, self.ctx, self.prepare_metrics = prepare_fracture(
            torch.as_tensor(verts, device=dev), torch.ones(len(verts), dtype=torch.bool, device=dev),
            torch.as_tensor(verts[tris], device=dev),
            torch.ones(len(tris), dtype=torch.bool, device=dev),
            torch.as_tensor(sphere_point_cloud(), device=dev), fcfg,
            generator=torch.Generator().manual_seed(seed))
        self._rebuild(old_phys=None)
        self.time = 0.0
        self.events = []

    def _rebuild(self, old_phys: PhysicsScene | None):
        """(Re)create rigid bodies from the pieces, velocities carried over
        by tag."""
        phys = build_scene(self.pieces, self.cfg.physics)
        if old_phys is not None:
            phys = _transfer_velocities(phys, old_phys, self.pieces.group, self.pieces.tag,
                                        self.pieces.valid)
        self.phys = phys
        self._x0 = phys.bodies.x

    def step(self, n: int = 1):
        for _ in range(n):
            self.phys = physics_step(self.phys, self.cfg.physics)
        self.time += n * self.cfg.physics.dt
        return self

    def interactive_frame(self, origin, direction, eye=(8.0, 6.0, 8.0), target=(0.0, 1.0, 0.0)):
        """One whole frame (module-level ``interactive_frame``); returns
        (image, fracture metrics)."""
        self.pieces, self.phys, self._x0, img, met = interactive_frame(
            self.pieces, self.phys, self._x0, self.ctx, origin, direction, eye, target,
            cfg=self.cfg)
        self.time += self.cfg.physics.dt
        self.events.append({"impact": None, "targets": "fused"})
        return img, met

    # ------------------------------------------------------------------
    def world_pieces(self) -> PieceSet:
        """Pieces baked to current world coordinates."""
        return _bake_pieces(self.pieces, self.phys, self._x0)

    def positions(self) -> np.ndarray:
        return self.phys.bodies.x.cpu().numpy()

    def num_bodies(self) -> int:
        return int(self.phys.bodies.active.sum())

    def num_pieces(self) -> int:
        return int(self.pieces.valid.sum())

    def total_volume(self) -> float:
        v, _ = moments(self.pieces.convex)
        return float(torch.where(self.pieces.valid, v, 0.0).sum())

    def stats(self) -> dict:
        """Fragment count, volume, kinetic energy and speeds of the active
        bodies."""
        b = self.phys.bodies
        act = b.active.cpu().numpy()
        v = b.v.cpu().numpy()[act]
        w = b.w.cpu().numpy()[act]
        inv_m = b.inv_mass.cpu().numpy()[act]
        m = np.where(inv_m > 0, 1.0 / np.maximum(inv_m, 1e-12), 0.0)
        return {
            "time": self.time,
            "pieces": self.num_pieces(),
            "bodies": int(act.sum()),
            "total_volume": self.total_volume(),
            "kinetic_energy": float(0.5 * (m * (v ** 2).sum(1)).sum()),
            "max_speed": float(np.abs(v).max()) if len(v) else 0.0,
            "max_spin": float(np.abs(w).max()) if len(w) else 0.0,
            "events": len(self.events),
        }

    def render(self, eye=(8.0, 6.0, 8.0), target=(0.0, 1.0, 0.0), light_dir=LIGHT_DIR,
               wireframe=False, highlight_last_impact=True):
        """Shadow-mapped frame of the current state: the (H, W, 3) image."""
        return render_pieces_frame(self.world_pieces(),
                                   bool(highlight_last_impact and self.events), eye, target,
                                   light_dir, self.cfg.render, self.cfg.physics.ground_y,
                                   wireframe=wireframe)

    # ------------------------------------------------------------------
    def fire_impact(self, origin, direction, partial: bool | None = None):
        """Raycast into the scene and fracture the bodies the impact sphere
        touches (or the hit piece's body outside radial mode). Returns a
        metrics dict, empty if the ray misses."""
        fcfg = self.cfg.fracture
        o, d = _host_ray(origin, direction)
        o, d = o.to(self.device), d.to(self.device)
        pidx, t = raycast(self.phys, o, d)
        if int(pidx) < 0:
            return {}
        impact = o + d * (t + fcfg.target_adder)
        owner = self.phys.piece_owner
        if fcfg.radial_mode:
            ov = sphere_overlap(self.phys, impact, fcfg.impact_radius / 2.0)
            targets = torch.unique(owner[ov]).tolist()
        else:
            targets = [int(owner[int(pidx)])]
        # Dynamic bodies only (the reference's mass filter).
        inv_mass = self.phys.bodies.inv_mass
        targets = [b for b in targets if b >= 0 and float(inv_mass[b]) > 0]
        return self.impact_at(impact, targets, partial=partial)

    def impact_at(self, impact, target_bodies, partial: bool | None = None):
        """Fracture the given bodies at an impact position, in one event."""
        fcfg = self.cfg.fracture
        partial = fcfg.partial_fracture if partial is None else partial
        if not len(target_bodies):
            return {}
        impact = torch.as_tensor(impact, dtype=torch.float32, device=self.device)
        baked = _tagged(_bake_pieces(self.pieces, self.phys, self._x0))
        old_phys = self.phys
        tb = torch.as_tensor(np.asarray(target_bodies, np.int32).reshape(-1), device=self.device)
        target_mask = baked.valid & torch.any(baked.tag[:, None] == tb[None, :], dim=1)
        pieces, met = do_fracture(baked, self.ctx, impact, target_mask, fcfg, partial=partial)
        self.pieces = pieces
        self._rebuild(old_phys=old_phys)
        impact_np = impact.cpu().numpy()
        self.events.append({"impact": impact_np, "targets": target_bodies})
        return {"targets": target_bodies, "impact": impact_np,
                "metrics": [{k: v.cpu().numpy() for k, v in met.items()}]}
