"""The rigid-body step (counterpart of ``surtr_tpu/physics/step.py``
``physics_step``, every ``PhysicsConfig`` route of ``_physics_step_body``).

One call is one fixed ``cfg.dt`` step:
  1. world transforms, 26-DOP intervals and AABBs in one pass: kernel B5,
     which also packs the narrowphase's rows; with ``pallas_narrowphase``
     off, B5's plain version on either device (the JAX package's XLA
     stage 1 computes the same rows and values);
  2. broadphase, mutual pairs only, dispatched as the JAX package does:
     "auto" takes the exact block sweep (``broadphase.py``) up to
     ``broadphase_block`` pieces, the sweep-and-prune B6 up to
     ``MAX_EXACT_NP`` and beyond that the Morton window with a
     ``RecallDegradedWarning`` (without ``pallas_broadphase`` the XLA
     window sweep past ``broadphase_block``); "sorted" runs B12 for K <=
     2·window with ``pallas_broadphase``, else the XLA window sweep
     (``morton_window_sweep``); "grid" the uniform-grid sweep
     (``grid_sweep``); "exact" and "exact_pallas" one of the first two;
  3. pair narrowphase: SAT normal, depth and an M-point manifold (B7, or
     with ``pallas_narrowphase`` off the JAX package's XLA formulation:
     B7's plain version with ``divide=True``, on either device);
     ground contacts: the G deepest corners below ``ground_y``;
  4. single-piece bodies (row i is body i) with ``fused_prep``: contact
     prep (B8), the matched warm impulses under ``warm_start``, then
     ceil(iters / substeps) Jacobi iterations (B9, accumulated mode under
     ``warm_start``), the island-wake flag riding along. Otherwise the slot
     assembly and contact prep in plain PyTorch (the JAX package's
     ``_assemble_and_solve``), then B9 for single-piece bodies and, for
     compound bodies, the Jacobi solver with per-body segment sums in plain
     PyTorch, as the JAX package runs it in XLA on every device;
  5. sleep bookkeeping and symplectic Euler with quaternion
     renormalization.

On CUDA tensors the kernels run; on CPU tensors their plain versions.
The ``force_pallas_*`` fields are no-ops here: the kernel route is the
default on both devices, as the JAX package's forced route is off its TPU.
``profile_stage`` truncates the step after stage 1, 2, 3, 35 (contact prep
without the solver) or 4, at the JAX package's points, returning the scene
with ``bodies.x + Σ·1e-30`` (``_stage_out``); ``stage_arrays`` returns the
arrays that sum is taken over.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import torch

from plainref.config import PhysicsConfig
from plainref.ops.hull import _cross
from plainref.ops.linalg import dot3, matvec3, sqrt_rn
from plainref.physics.broadphase import (block_sweep, grid_sweep, morton_window_sweep,
                                                mutual)
from plainref.physics.broadphase_cuda import (MAX_EXACT_NP, apply_theta_mutual,
                                                     broadphase_exact, broadphase_sorted)
from plainref.physics.narrowphase_cuda import narrowphase, narrowphase_reference
from plainref.physics.pack_cuda import (pack_layout, transform_pack_owned,
                                               transform_pack_owned_reference)
from plainref.physics.prep_cuda import prep_from_records, warm_preapply
from plainref.physics.rigid import quat_integrate, world_inv_inertia
from plainref.physics.scene import PhysicsScene
from plainref.physics.slots import slot_rows, slot_sum
from plainref.physics.solver_cuda import solve, solve_warm
from plainref.profiling import fence_sum

BIG = 3.4e38


class RecallDegradedWarning(UserWarning):
    """broadphase="auto" beyond ``MAX_EXACT_NP`` pieces falls back to the
    Morton-window sweep, which can miss overlapping pairs: the fallback is
    made loud."""


def _broadphase_mode(cfg: PhysicsConfig, Np: int) -> str:
    """The broadphase the JAX package's dispatch picks: "exact",
    "exact_pallas" (B6), "sorted" (B12), "sorted_xla" or "grid"."""
    mode = cfg.broadphase
    if mode == "auto":
        if Np <= cfg.broadphase_block:
            return "exact"
        if cfg.pallas_broadphase and Np <= MAX_EXACT_NP:
            return "exact_pallas"
        why = (f"> MAX_EXACT_NP={MAX_EXACT_NP}" if cfg.pallas_broadphase
               else "and pallas_broadphase=False (no kernel broadphase)")
        warnings.warn(
            f"broadphase='auto' with Np={Np} {why}: falling back to the Morton-window sweep, "
            "which can MISS overlapping pairs on dense piles. Set broadphase='sorted' to "
            "acknowledge, or 'grid'/'exact' for full recall at higher cost.",
            RecallDegradedWarning, stacklevel=3)
        mode = "sorted"
    if mode == "sorted":
        if cfg.pallas_broadphase and cfg.max_neighbors <= 2 * cfg.broadphase_window:
            return "sorted"
        return "sorted_xla"
    if mode not in ("exact", "exact_pallas", "grid"):
        raise ValueError(f"physics_step: unknown broadphase {cfg.broadphase!r}")
    return mode


def physics_step(scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int = 99,
                 mark=None) -> PhysicsScene:
    """One fixed step. ``mark``, when given, is called with each stage's name
    as the stage's work has been issued (pack, broadphase, narrowphase,
    glue, prep, solver, finish; without ``fused_prep`` or with compound
    bodies there is no prep stage), for
    stage timing. ``profile_stage`` < 99 truncates the step (module
    docstring)."""
    mode = _broadphase_mode(cfg, scene.Np)
    if cfg.sleep_velocity > 0 and cfg.skip_all_asleep and profile_stage >= 99:
        # Nothing inside the step can wake a scene whose every active body
        # sleeps (a wake needs a moving contact): the step is the identity.
        b = scene.bodies
        asleep = (scene.sleep_frames >= cfg.sleep_frames) | ~b.active
        if bool(torch.all(asleep) & torch.any(b.active)):
            return scene
    out = _step_body(scene, cfg, mode, mark or (lambda name: None), profile_stage)
    return _stage_out(scene, *out) if isinstance(out, _Stage) else out


def stage_arrays(scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int,
                 mark=None) -> tuple:
    """The arrays the step truncated at ``profile_stage`` folds into
    ``bodies.x`` (their ``profiling.fence_sum`` is the fence), for reading
    a stage's output. On the kernel route, stage 3's are B7's raw records,
    whose unfilled points hold -BIG, so their fence is -inf there as in the
    JAX package."""
    out = _step_body(scene, cfg, _broadphase_mode(cfg, scene.Np), mark or (lambda name: None),
                     profile_stage)
    if not isinstance(out, _Stage):
        raise ValueError(f"stage_arrays: profile_stage {profile_stage} truncates nothing")
    return tuple(out)


class _Stage(tuple):
    """What a truncated step body returns: the stage's arrays."""


def _stage_out(scene: PhysicsScene, *arrays) -> PhysicsScene:
    """The truncated step's result: ``bodies.x`` plus 1e-30 times the sum of
    every element of ``arrays`` (the JAX package's fence). The sum runs in
    float64 and is rounded once, so its value does not depend on the
    device's reduction order."""
    b = scene.bodies
    x = b.x + fence_sum(*arrays).to(b.x.dtype) * 1e-30
    return dataclasses.replace(scene, bodies=dataclasses.replace(b, x=x))


def _broadphase(mode, cfg: PhysicsConfig, centers, lo, hi, owner, valid):
    """(pidx (Np, K) i32, pok (Np, K) bool), mutual pairs only."""
    K = cfg.max_neighbors
    if mode == "exact_pallas":
        pidx, pok, mut = broadphase_exact(centers, lo, hi, owner, valid, K)
        return pidx, apply_theta_mutual(pidx, pok, mut)
    if mode == "sorted":
        return broadphase_sorted(centers, lo, hi, owner, valid, K, cfg.broadphase_window)
    if mode == "exact":
        pidx, pok = block_sweep(centers, lo, hi, owner, valid, K, cfg.broadphase_block)
    elif mode == "grid":
        pidx, pok = grid_sweep(centers, lo, hi, owner, valid, K, cfg.broadphase_bucket_cap)
    else:
        pidx, pok = morton_window_sweep(centers, lo, hi, owner, valid, K, cfg.broadphase_window)
    return pidx, mutual(pidx, pok)


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


@functools.lru_cache(maxsize=None)
def _gravity_vector(g: float, dtype, device) -> torch.Tensor:
    """(0, g, 0), one tensor per (g, dtype, device): building it from a list
    every step would copy from host memory, which on the card waits for the
    stream."""
    return torch.tensor([0.0, g, 0.0], dtype=dtype, device=device)


def _start_velocities(scene: PhysicsScene, cfg: PhysicsConfig):
    """(asleep_in, v0, w0): the bodies asleep at the start, and the start
    velocities with gravity on awake dynamic bodies."""
    bodies = scene.bodies
    if cfg.sleep_velocity > 0:
        asleep_in = (scene.sleep_frames >= cfg.sleep_frames) & bodies.active
    else:
        asleep_in = torch.zeros_like(bodies.active)
    gravity = _gravity_vector(cfg.gravity, bodies.v.dtype, bodies.v.device)
    grav_on = (bodies.inv_mass > 0) & ~asleep_in
    return asleep_in, bodies.v + cfg.dt * gravity * grav_on[:, None], bodies.w


def _step_body(scene: PhysicsScene, cfg: PhysicsConfig, mode: str, mark,
               profile_stage: int = 99) -> PhysicsScene:
    bodies = scene.bodies
    Np = scene.Np
    M = max(1, cfg.manifold_points)
    Ne = max(cfg.max_edge_dirs, 0)
    Vh, Fp = scene.piece_verts.shape[1], scene.piece_planes.shape[1]
    single = cfg.single_piece_bodies and Np == scene.B
    use_fast = cfg.pallas_narrowphase and single and cfg.fused_prep
    margin = cfg.contact_slop * 4.0

    # 1. World transforms + packing at the owners' poses (B5, or its plain
    # version on either device, which gives the XLA formulation's values).
    pack = transform_pack_owned if cfg.pallas_narrowphase else transform_pack_owned_reference
    packed, aabb = pack(
        scene.piece_verts, scene.piece_vmask, scene.piece_planes, scene.piece_pmask,
        scene.piece_edges, scene.piece_emask, scene.piece_owner, scene.piece_valid,
        bodies.q, bodies.x, margin,
    )
    mark("pack")
    if profile_stage <= 1:
        if use_fast:
            return _Stage((aabb,))
        o = pack_layout(Vh, Fp, Ne)[0]["lod"][0]
        return _Stage((aabb[:, 6:9], packed[:, o : o + 26]))

    # 2. Broadphase, mutual pairs only.
    pvalid = scene.piece_valid & (scene.piece_owner >= 0)
    pidx, pok = _broadphase(mode, cfg, aabb[:, 6:9], aabb[:, 0:3], aabb[:, 3:6],
                            scene.piece_owner, pvalid)
    mark("broadphase")
    if profile_stage <= 2:
        return _Stage((pidx, pok))

    # 3. Pair narrowphase (B7 or the XLA formulation) and the ground contacts.
    if cfg.pallas_narrowphase:
        raw = narrowphase(packed, pidx, pok, Vh, Fp, Ne, M, cfg.contact_slop)   # (Np, K, 5+6M)
    else:
        raw = narrowphase_reference(packed, pidx, pok, Vh, Fp, Ne, M, cfg.contact_slop,
                                    divide=True)
    mark("narrowphase")
    if use_fast and profile_stage <= 3:
        return _Stage((raw,))
    wverts = packed[:, : 3 * Vh].reshape(Np, 3, Vh).transpose(1, 2)
    ground = _ground_contacts(cfg, wverts, scene.piece_vmask, pvalid)

    if single and cfg.fused_prep and profile_stage > 3:
        return _fused_prep_solve(scene, cfg, raw, pidx, ground, mark, profile_stage)
    owner = torch.clamp(scene.piece_owner, 0, scene.B - 1).long()
    return _assemble_and_solve(scene, cfg, raw, pidx, owner, ground, mark, single, profile_stage)


def _warm_match(scene: PhysicsScene, pidx, fid, K: int, M: int, G: int):
    """The previous step's accumulated impulses carried to this step's slots
    by (partner, feature id): one dense (Np, M, K, M', K') compare. Returns
    (Np, C, 3), zero on ground slots and unmatched slots."""
    Np = pidx.shape[0]
    wp = scene.warm_pair                                   # (Np, K')
    wf = scene.warm_fid.reshape(Np, M, K)                  # (Np, M', K')
    wl = scene.warm_lam.reshape(Np, M, K, 3)
    fidc = fid.reshape(Np, M, K)
    pm = (pidx[:, :, None] == wp[:, None, :]) & (wp >= 0)[:, None, :]          # (Np, K, K')
    fm = (fidc[:, :, :, None, None] == wf[:, None, None, :, :]) & (fidc > 0)[..., None, None]
    sel = fm & pm[:, None, :, None, :]
    lam = torch.sum(torch.where(sel[..., None], wl[:, None, None], 0.0), dim=(3, 4))
    return torch.cat([lam.reshape(Np, M * K, 3), lam.new_zeros((Np, G, 3))], dim=1)


def _fused_prep_solve(scene: PhysicsScene, cfg: PhysicsConfig, raw, pidx, ground, mark,
                      profile_stage: int = 99):
    """Single-piece bodies: prep (B8) and the solver iterations (B9)."""
    bodies = scene.bodies
    Np, K = pidx.shape
    M, G = max(1, cfg.manifold_points), cfg.max_ground_contacts
    C = K * M + G
    g_pts, gd, g_hit = ground
    inv_I = world_inv_inertia(bodies.q, bodies.inv_inertia_body).reshape(Np, 9)
    asleep_in, v0, w0 = _start_velocities(scene, cfg)
    pb = torch.clamp(pidx.long(), 0, Np - 1)
    wake0 = _wake_seed(v0, w0, bodies.active, cfg)
    mark("glue")

    # 4. Contact prep from the pair records (B8, which assembles the slots
    # and gathers the partners itself) and the solver iterations (B9).
    *tables, vn0 = prep_from_records(
        raw, pidx, g_pts, gd, g_hit, bodies.x, v0, w0, bodies.inv_mass, inv_I, asleep_in,
        K=K, M=M, G=G, dt=cfg.dt, slop=cfg.contact_slop, baumgarte=cfg.baumgarte,
        restitution=cfg.restitution, bounce_thr=cfg.bounce_threshold,
    )
    if profile_stage == 35:   # contact prep only
        return _Stage(tables)
    kw = dict(K=K, M=M, G=G, iters=cfg.solver_iters, substeps=cfg.solver_substeps,
              mu=cfg.dynamic_friction)
    warm = None
    if cfg.warm_start:
        fid = slot_rows(raw, 10, M).to(torch.int32)
        v0, w0, lam0 = warm_preapply(v0, w0, _warm_match(scene, pidx, fid, K, M, G), tables,
                                     C=C)
        mark("prep")
        vw0 = torch.cat([v0, w0, wake0[:, None], torch.zeros_like(wake0[:, None])], dim=1)
        vw, lam = solve_warm(vw0, lam0.permute(0, 2, 1).reshape(Np, 3 * C), pb, tables, **kw)
        MK = M * K
        lam_pairs = torch.stack([lam[:, :MK], lam[:, C : C + MK], lam[:, 2 * C : 2 * C + MK]], -1)
        warm = (pidx, fid, lam_pairs.reshape(Np, MK * 3))
    else:
        mark("prep")
        vw0 = torch.cat([v0, w0, wake0[:, None], torch.zeros_like(wake0[:, None])], dim=1)
        vw = solve(vw0, pb, tables, **kw)
    mark("solver")

    hs = tables[4]
    out = _finish_step(scene, vw[:, 0:3], vw[:, 3:6], cfg, vn0, hs[:, :C] > 0.5, hs[:, C:] > 0.5,
                       wake_prop=vw[:, 6] > 0.5, warm=warm, profile_stage=profile_stage)
    mark("finish")
    return out


def _segment_sums(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Per-body sums of piece rows (pieces sorted by owner): a cumsum down
    the rows, then the difference at the segment ends, as the JAX package
    computes them (no scatter); (Np, D) → (B, D). The cumsum runs in
    float64 and each difference is rounded once to float32: PyTorch's
    float32 cumsum accumulates in float64 on the CPU and in float32 on the
    card, which parted the two runs by a few ulps."""
    v = vals.double()
    csum = torch.cat([torch.zeros_like(v[:1]), torch.cumsum(v, dim=0)])
    seg = seg_start.long()
    return (csum[seg[1:]] - csum[seg[:-1]]).to(vals.dtype)


def _segment_any(flags: torch.Tensor, myb: torch.Tensor, B: int) -> torch.Tensor:
    """(B,) bool: any piece flag per owner body (segment max)."""
    out = torch.zeros((B,), dtype=torch.int32, device=flags.device)
    return out.scatter_reduce(0, myb, flags.to(torch.int32), "amax") > 0


def _assemble_and_solve(scene: PhysicsScene, cfg: PhysicsConfig, raw, pidx, owner, ground, mark,
                        single: bool = False, profile_stage: int = 99):
    """The JAX package's ``_assemble_and_solve``, plain PyTorch on both
    devices up to the solver: (Np, C) slot assembly, sleeping partners made
    static, contact prep (lever arms, effective masses, targets, mass
    splitting). Single-piece bodies (row i is body i, no gathers through
    the owner) then take B9 on the same tables; compound bodies the Jacobi
    solver over body velocities with per-body segment sums."""
    bodies = scene.bodies
    Np, K = pidx.shape
    B = scene.B
    M, G = max(1, cfg.manifold_points), cfg.max_ground_contacts
    C = K * M + G
    dt = cfg.dt
    f32 = raw.dtype
    dev = raw.device
    g_pts, gd, g_hit = ground
    MK = M * K

    # Contact slots: pairs (slot m·K + k), then G ground slots.
    pc_p = torch.stack([slot_rows(raw, r, M) for r in (7, 8, 9)], dim=-1)      # (Np, MK, 3)
    up = torch.zeros((Np, G, 3), dtype=f32, device=dev)
    up[..., 1] = 1.0
    nrm = torch.cat([raw[:, :, 0:3].repeat(1, M, 1), up], dim=1)                # (Np, C, 3)
    pts = torch.cat([pc_p, g_pts], dim=1)
    dep = torch.cat([torch.clamp(slot_rows(raw, 5, M), min=0.0), torch.clamp(gd, min=0.0)], 1)
    hit = torch.cat([slot_rows(raw, 6, M) > 0.5, g_hit], dim=1)
    partner = torch.cat([pidx.long().repeat(1, M),
                         torch.full((Np, G), -1, dtype=torch.long, device=dev)], dim=1)
    is_static = partner < 0
    partner_body = torch.where(is_static, 0, owner[torch.clamp(partner, 0, Np - 1)])

    # Sleeping bodies act as static toward their partners.
    asleep_in, v0, w0 = _start_velocities(scene, cfg)
    if cfg.sleep_velocity > 0:
        is_static = is_static | (asleep_in[partner_body] & ~is_static)
    if profile_stage <= 3:
        return _Stage((nrm, pts, dep, hit))

    inv_m = bodies.inv_mass
    inv_I = world_inv_inertia(bodies.q, bodies.inv_inertia_body)               # (B, 3, 3)
    myb = owner
    own = (lambda a: a) if single else (lambda a: a[myb])  # noqa: E731
    pair_body = owner[torch.clamp(pidx.long(), 0, Np - 1)]                      # (Np, K)
    btab = torch.cat([bodies.x, inv_m[:, None], inv_I.reshape(B, 9), v0, w0], dim=1)
    bt_pair = btab[pair_body]                                                   # (Np, K, 19)

    def tile_slots(a):  # (Np, K, L) → (Np, C, L); ground slots zero
        return torch.cat([a.repeat(1, M, 1), a.new_zeros((Np, G, a.shape[2]))], dim=1)

    stat3 = is_static[..., None]
    xB = tile_slots(bt_pair[..., 0:3])
    iB_m = torch.where(is_static, 0.0, tile_slots(bt_pair[..., 3:4])[..., 0])
    iB_I = torch.where(stat3[..., None], 0.0, tile_slots(bt_pair[..., 4:13]).reshape(Np, C, 3, 3))
    rA = pts - bodies.x[myb][:, None]
    rB = pts - xB
    iA_m = own(inv_m)[:, None]                                                  # (Np, 1)
    iA_I = own(inv_I)[:, None].expand(Np, C, 3, 3)

    def k_term(im, iI, r):
        rxn = _cross(r, nrm)
        return im + dot3(rxn, matvec3(iI, rxn))

    kn = k_term(iA_m, iA_I, rA) + k_term(iB_m, iB_I, rB)
    m_eff = torch.where(hit & (kn > 1e-12), 1.0 / torch.clamp(kn, min=1e-12), 0.0)

    def partner_vel(v, w):
        vwB = torch.cat([v, w], dim=1)[pair_body]                               # (Np, K, 6)
        vB = tile_slots(vwB[..., 0:3])
        wB = tile_slots(vwB[..., 3:6])
        return torch.where(stat3, 0.0, vB + _cross(wB, rB))

    def own_vel(v, w):
        return own(v)[:, None] + _cross(own(w)[:, None].expand(rA.shape), rA)

    vB0 = torch.where(stat3, 0.0, tile_slots(bt_pair[..., 13:16])
                      + _cross(tile_slots(bt_pair[..., 16:19]), rB))
    vn0 = dot3(own_vel(v0, w0) - vB0, nrm)
    bounce = -cfg.restitution * torch.clamp(vn0 + cfg.bounce_threshold, max=0.0)
    bias = (cfg.baumgarte / dt) * torch.clamp(dep - cfg.contact_slop, min=0.0)
    sleeper = is_static & (torch.arange(C, device=dev) < MK)
    target = torch.maximum(bounce, torch.where(sleeper, 0.0, bias))

    # Mass splitting: per-body hit counts.
    seg = scene.seg_start
    cnt_piece = torch.sum(hit, dim=1, keepdim=True).to(f32)
    cnt_body = (cnt_piece if single else _segment_sums(cnt_piece, seg))[:, 0]
    split_body = 1.0 / torch.clamp(cnt_body, min=1.0)
    sA = own(split_body)[:, None]                                              # (Np, 1)
    if profile_stage == 35:   # contact prep only
        return _Stage((m_eff, target, sA, rA, rB, v0, w0))
    mark("glue")

    mu = cfg.dynamic_friction
    S = max(1, cfg.solver_substeps)
    if single:
        # B9 on the assembled tables (the JAX package's solve_contacts_pallas).
        planar = lambda a: torch.cat([a[..., 0], a[..., 1], a[..., 2]], dim=1)  # noqa: E731
        tables = (planar(rA), planar(rB), planar(nrm), torch.cat([m_eff, target], 1),
                  torch.cat([hit.to(f32), is_static.to(f32)], 1),
                  torch.cat([iA_m * sA, sA], 1), inv_I.reshape(Np, 9))
        wake0 = _wake_seed(v0, w0, bodies.active, cfg)
        vw0 = torch.cat([v0, w0, wake0[:, None], torch.zeros_like(wake0[:, None])], dim=1)
        vw = solve(vw0, torch.clamp(pidx.long(), 0, Np - 1), tables, K=K, M=M, G=G,
                   iters=cfg.solver_iters, substeps=S, mu=mu)
        mark("solver")
        out = _finish_step(scene, vw[:, 0:3], vw[:, 3:6], cfg, vn0, hit, is_static,
                           wake_prop=vw[:, 6] > 0.5, profile_stage=profile_stage)
        mark("finish")
        return out

    v, w = v0, w0
    for _ in range((cfg.solver_iters + S - 1) // S):
        # Chaotic-relaxation Jacobi: partner velocities once per outer
        # iteration, own body every substep.
        vB_full = partner_vel(v, w)
        for _ in range(S):
            vr = own_vel(v, w) - vB_full
            vn = dot3(vr, nrm)
            lam_n = torch.clamp(-(vn - target) * m_eff, min=0.0)
            vt = vr - vn[..., None] * nrm
            vt_len = sqrt_rn(dot3(vt, vt))
            t_dir = vt / torch.clamp(vt_len, min=1e-9)[..., None]
            lam_t = torch.minimum(vt_len * m_eff, mu * lam_n)
            imp = torch.where(hit[..., None], lam_n[..., None] * nrm - lam_t[..., None] * t_dir,
                              0.0)
            piece_dv = slot_sum(imp)[:, 0] * iA_m * sA
            piece_dw = slot_sum(matvec3(iA_I, _cross(rA, imp)) * sA[..., None])[:, 0]
            v = v + _segment_sums(piece_dv, seg)
            w = w + _segment_sums(piece_dw, seg)
    mark("solver")

    out = _finish_step(scene, v, w, cfg, vn0, hit, is_static, myb=myb, pidx=pidx,
                       profile_stage=profile_stage)
    mark("finish")
    return out


def _finish_step(scene, v1, w1, cfg: PhysicsConfig, vn0, hit, is_static, wake_prop=None,
                 myb=None, pidx=None, warm=None, profile_stage: int = 99):
    """Sleep bookkeeping + stage-5 integration. Single-piece bodies bring the
    solver's island-wake flag (``wake_prop``); compound bodies (``myb``, the
    owner of each piece row) spread wake sources ``wake_hops`` hops over the
    pair-contact graph here, then reduce per body."""
    if profile_stage <= 4:
        return _Stage((v1, w1))
    bodies = scene.bodies
    sleep_frames = scene.sleep_frames
    push_frames = scene.push_frames
    if cfg.sleep_velocity > 0:
        moving = hit & ~is_static
        dist_piece = torch.any(moving & (torch.abs(vn0) > cfg.wake_speed), dim=1)
        push_piece = torch.any(moving & (torch.abs(vn0) >= cfg.sleep_velocity), dim=1)
        if myb is None:
            if cfg.wake_hops > 0:
                dist_piece = dist_piece | wake_prop
            disturbed, push = dist_piece, push_piece
        else:
            B, Np = scene.B, pidx.shape[0]
            if cfg.wake_hops > 0:
                K, M = pidx.shape[1], max(1, cfg.manifold_points)
                # The JAX package's (Np, K, M) view of the slot-major pair
                # slots, kept as it is.
                pair_hit = torch.any(hit[:, : K * M].reshape(Np, K, M), dim=2)
                pb = torch.clamp(pidx.long(), 0, Np - 1)
                fast_b = (dot3(v1, v1) + dot3(w1, w1) > cfg.wake_speed ** 2) & bodies.active
                src = dist_piece | fast_b[myb]
                for _ in range(cfg.wake_hops):
                    src = src | torch.any(pair_hit & src[pb], dim=1)
                dist_piece = src
            disturbed = _segment_any(dist_piece, myb, B)
            push = _segment_any(push_piece, myb, B)
        # Sustained-push wake: a sleeper pushed for wake_push_frames steps.
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
    return _integrate(scene, v1, w1, cfg.dt, sleep_frames, push_frames, warm)


def _integrate(scene, v1, w1, dt, sleep_frames, push_frames, warm=None):
    """Stage 5: symplectic Euler + quaternion renormalization; ``warm`` =
    (pairs, feature ids, accumulated impulses) kept for the next step's
    warm start."""
    b = scene.bodies
    act = b.active[:, None]
    v1 = torch.where(act, v1, 0.0)
    w1 = torch.where(act, w1, 0.0)
    bodies = dataclasses.replace(b, x=b.x + dt * v1, q=quat_integrate(b.q, w1, dt), v=v1, w=w1)
    extra = {}
    if warm is not None:
        extra = dict(warm_pair=warm[0].to(torch.int32), warm_fid=warm[1], warm_lam=warm[2])
    return dataclasses.replace(scene, bodies=bodies, sleep_frames=sleep_frames,
                               push_frames=push_frames, **extra)
