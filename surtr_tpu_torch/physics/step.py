"""The rigid-body step, single-piece fast path (counterpart of
``surtr_tpu/physics/step.py``: the fused path of ``_physics_step_body``
with ``_fused_prep_solve``, ``_finish_step`` and ``_integrate``).

One call is one fixed ``cfg.dt`` step:
  1. world transforms, 26-DOP intervals and AABBs in one pass (kernel B5);
  2. exact broadphase (``broadphase.py``) made mutual;
  3. pair narrowphase: SAT normal, depth and an M-point manifold (B7);
     ground contacts: the G deepest corners below ``ground_y``;
  4. contact prep (B8), then ceil(iters / substeps) Jacobi solver
     iterations (B9), the island-wake flag riding along;
  5. sleep bookkeeping and symplectic Euler with quaternion
     renormalization.

Every body owns one piece (row i is body i). On CUDA tensors the four
kernels run; on CPU tensors their plain versions. What the JAX package does
off this path raises ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import torch

from surtr_tpu_torch.config import PhysicsConfig
from surtr_tpu_torch.ops.linalg import dot3
from surtr_tpu_torch.physics.broadphase import broadphase_exact, mutual
from surtr_tpu_torch.physics.narrowphase_cuda import narrowphase
from surtr_tpu_torch.physics.pack_cuda import transform_pack
from surtr_tpu_torch.physics.prep_cuda import prep_contacts
from surtr_tpu_torch.physics.rigid import quat_integrate, world_inv_inertia
from surtr_tpu_torch.physics.scene import PhysicsScene
from surtr_tpu_torch.physics.solver_cuda import solve

BIG = 3.4e38


def _check_slice(scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int) -> None:
    """Raise for every configuration the port does not run yet."""
    if profile_stage != 99:
        raise NotImplementedError(
            "physics_step: profile_stage truncation is not ported (ROADMAP A14, profiling)")
    if not (cfg.pallas_narrowphase and cfg.fused_prep):
        raise NotImplementedError(
            "physics_step: the XLA narrowphase and unfused prep (_assemble_and_solve) are not "
            "ported (ROADMAP A9)")
    if not (cfg.single_piece_bodies and scene.Np == scene.B):
        raise NotImplementedError(
            "physics_step: compound bodies (_assemble_and_solve, segment sums) are not ported "
            "(ROADMAP A9)")
    if cfg.warm_start:
        raise NotImplementedError(
            "physics_step: warm start and the solver's accumulated mode are not ported "
            "(ROADMAP A9)")
    mode = cfg.broadphase
    if mode == "auto":
        mode = "exact" if scene.Np <= cfg.broadphase_block else "exact_pallas"
    if mode != "exact":
        missing = {
            "exact_pallas": "the Pallas sweep-and-prune, kernel B6 (ROADMAP B6)",
            "sorted": "the Morton-window sweep, kernel B12 (ROADMAP B12)",
            "grid": "the uniform-grid sweep, which the port leaves out (ROADMAP A, Leave out)",
        }.get(mode, "an unknown broadphase")
        raise NotImplementedError(
            f"physics_step: broadphase={cfg.broadphase!r} at Np={scene.Np} needs {missing}, "
            "not ported; broadphase='exact' runs the exact block sweep")


def physics_step(scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int = 99,
                 mark=None) -> PhysicsScene:
    """One fixed step. ``mark``, when given, is called with each stage's name
    as the stage's work has been issued (pack, broadphase, narrowphase,
    glue, prep, solver, finish), for stage timing."""
    _check_slice(scene, cfg, profile_stage)
    if cfg.sleep_velocity > 0 and cfg.skip_all_asleep:
        # Nothing inside the step can wake a scene whose every active body
        # sleeps (a wake needs a moving contact): the step is the identity.
        b = scene.bodies
        asleep = (scene.sleep_frames >= cfg.sleep_frames) | ~b.active
        if bool(torch.all(asleep) & torch.any(b.active)):
            return scene
    return _step_body(scene, cfg, mark or (lambda name: None))


def _ground_contacts(cfg: PhysicsConfig, wverts, wmask, pvalid):
    """The G deepest corners below y = ground_y: (points (Np, G, 3), depths
    (Np, G), hits (Np, G)). Stable selection: ties (a resting cube's four
    bottom corners) keep corner order, as jax.lax.top_k does."""
    depth_v = cfg.ground_y - wverts[..., 1]
    below = wmask & (depth_v > -cfg.contact_slop)
    s = torch.sort(torch.where(below, depth_v, -BIG), dim=1, descending=True, stable=True)
    G = cfg.max_ground_contacts
    gd, gidx = s.values[:, :G], s.indices[:, :G]
    g_hit = (gd > -cfg.contact_slop) & pvalid[:, None]
    g_pts = torch.gather(wverts, 1, gidx[..., None].expand(-1, -1, 3))
    return g_pts, gd, g_hit


def _wake_seed(v0, w0, active, cfg: PhysicsConfig):
    """(Np,) 0/1 island-wake seed: bodies above wake_speed before the solve."""
    if cfg.wake_hops <= 0:
        return torch.zeros_like(v0[:, 0])
    speed2 = dot3(v0, v0) + dot3(w0, w0)
    return ((speed2 > cfg.wake_speed ** 2) & active).to(v0.dtype)


def _step_body(scene: PhysicsScene, cfg: PhysicsConfig, mark) -> PhysicsScene:
    bodies = scene.bodies
    Np = scene.Np
    K, G = cfg.max_neighbors, cfg.max_ground_contacts
    M = max(1, cfg.manifold_points)
    Ne = max(cfg.max_edge_dirs, 0)
    Vh, Fp = scene.piece_verts.shape[1], scene.piece_planes.shape[1]
    f32 = scene.piece_verts.dtype
    owner = torch.clamp(scene.piece_owner, 0, scene.B - 1).long()
    pvalid = scene.piece_valid & (scene.piece_owner >= 0)

    # 1. World transforms + packing (B5).
    packed, aabb = transform_pack(
        scene.piece_verts, scene.piece_vmask, scene.piece_planes, scene.piece_pmask,
        scene.piece_edges, scene.piece_emask, bodies.q[owner], bodies.x[owner], pvalid,
        cfg.contact_slop * 4.0,
    )
    mark("pack")

    # 2. Exact broadphase, mutual pairs only.
    pidx, pok = broadphase_exact(aabb[:, 6:9], aabb[:, 0:3], aabb[:, 3:6], scene.piece_owner,
                                 pvalid, K, cfg.broadphase_block)
    pok = mutual(pidx, pok)
    mark("broadphase")

    # 3. Pair narrowphase (B7).
    raw = narrowphase(packed, pidx, pok, Vh, Fp, Ne, M, cfg.contact_slop)   # (Np, K, 5+6M)
    mark("narrowphase")

    # Ground contacts and the prep tables (slot = m·K + k, then G ground).
    wverts = packed[:, : 3 * Vh].reshape(Np, 3, Vh).transpose(1, 2)
    g_pts, gd, g_hit = _ground_contacts(cfg, wverts, scene.piece_vmask, pvalid)

    def slots(r):  # manifold row r of every point → (Np, M·K)
        return raw[:, :, r::6].permute(0, 2, 1).reshape(Np, M * K)

    val, mh, px, py, pz = (slots(r) for r in range(5, 10))
    pn3 = raw[:, :, 0:3].permute(0, 2, 1).reshape(Np, 3 * K)
    pt3 = torch.cat([px, g_pts[..., 0], py, g_pts[..., 1], pz, g_pts[..., 2]], dim=1)
    dh = torch.cat([torch.clamp(val, min=0.0), torch.clamp(gd, min=0.0), mh, g_hit.to(f32)],
                   dim=1)

    dt = cfg.dt
    inv_m = bodies.inv_mass
    inv_I = world_inv_inertia(bodies.q, bodies.inv_inertia_body).reshape(Np, 9)
    if cfg.sleep_velocity > 0:
        asleep_in = (scene.sleep_frames >= cfg.sleep_frames) & bodies.active
    else:
        asleep_in = torch.zeros_like(bodies.active)
    gravity = torch.tensor([0.0, cfg.gravity, 0.0], dtype=f32, device=bodies.x.device)
    grav_on = (inv_m > 0) & ~asleep_in
    v0 = bodies.v + dt * gravity * grav_on[:, None]
    w0 = bodies.w
    btab = torch.cat([bodies.x, inv_m[:, None], inv_I, v0, w0, asleep_in.to(f32)[:, None]],
                     dim=1)                                                     # (Np, 20)
    pb = torch.clamp(pidx.long(), 0, Np - 1)
    btf = btab[pb].transpose(1, 2).reshape(Np, 20 * K)
    own = torch.cat([bodies.x, v0, w0, inv_m[:, None], inv_I], dim=1)
    wake0 = _wake_seed(v0, w0, bodies.active, cfg)
    mark("glue")

    # 4. Contact prep (B8) and the solver iterations (B9).
    *tables, vn0 = prep_contacts(
        pt3, dh, pn3, btf, own, K=K, M=M, G=G, dt=dt, slop=cfg.contact_slop,
        baumgarte=cfg.baumgarte, restitution=cfg.restitution, bounce_thr=cfg.bounce_threshold,
    )
    mark("prep")
    vw0 = torch.cat([v0, w0, wake0[:, None], torch.zeros_like(wake0[:, None])], dim=1)
    vw = solve(vw0, pb, tables, K=K, M=M, G=G, iters=cfg.solver_iters,
               substeps=cfg.solver_substeps, mu=cfg.dynamic_friction)
    mark("solver")

    C = K * M + G
    hs = tables[4]
    out = _finish_step(scene, vw[:, 0:3], vw[:, 3:6], cfg, vn0, hs[:, :C] > 0.5,
                       hs[:, C:] > 0.5, vw[:, 6] > 0.5)
    mark("finish")
    return out


def _finish_step(scene, v1, w1, cfg: PhysicsConfig, vn0, hit, is_static, wake_prop):
    """Sleep bookkeeping (single-piece bodies) + stage-5 integration."""
    bodies = scene.bodies
    sleep_frames = scene.sleep_frames
    push_frames = scene.push_frames
    if cfg.sleep_velocity > 0:
        # Wake on a fast contact approach, or (island wake) when the solver
        # spread a wake flag to this body.
        moving = hit & ~is_static
        disturbed = torch.any(moving & (torch.abs(vn0) > cfg.wake_speed), dim=1)
        if cfg.wake_hops > 0:
            disturbed = disturbed | wake_prop
        # Sustained-push wake: a sleeper pushed for wake_push_frames steps.
        push = torch.any(moving & (torch.abs(vn0) >= cfg.sleep_velocity), dim=1)
        was_asleep = sleep_frames >= cfg.sleep_frames
        push_frames = torch.where(was_asleep & push, push_frames + 1, 0).to(torch.int32)
        disturbed = disturbed | (push_frames >= cfg.wake_push_frames)
        speed2 = dot3(v1, v1) + dot3(w1, w1)
        slow = speed2 < cfg.sleep_velocity ** 2
        cnt = torch.where(
            disturbed, 0,
            torch.where(slow, torch.clamp(sleep_frames + 1, max=cfg.sleep_frames + 1), 0),
        ).to(torch.int32)
        asleep = (cnt >= cfg.sleep_frames) & ~disturbed & bodies.active
        v1 = torch.where(asleep[:, None], 0.0, v1)
        w1 = torch.where(asleep[:, None], 0.0, w1)
        sleep_frames = cnt
    return _integrate(scene, v1, w1, cfg.dt, sleep_frames, push_frames)


def _integrate(scene, v1, w1, dt, sleep_frames, push_frames):
    """Stage 5: symplectic Euler + quaternion renormalization."""
    b = scene.bodies
    act = b.active[:, None]
    v1 = torch.where(act, v1, 0.0)
    w1 = torch.where(act, w1, 0.0)
    bodies = dataclasses.replace(b, x=b.x + dt * v1, q=quat_integrate(b.q, w1, dt), v=v1, w=w1)
    return dataclasses.replace(scene, bodies=bodies, sleep_frames=sleep_frames,
                               push_frames=push_frames)
