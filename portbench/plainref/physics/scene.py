"""Physics scene construction from fracture output (counterpart of
``surtr_tpu/physics/scene.py``; reference InitCompound): each piece group
becomes one rigid body whose shapes are its pieces' convexes, with mass and
inertia from the geometry at ``cfg.density``. Piece hulls are stored in the
body frame (COM at the origin), pieces sorted by owner.
"""

from __future__ import annotations

import dataclasses

import torch

from plainref.config import PhysicsConfig
from plainref.fracture.types import PieceSet
from plainref.ops.linalg import dot3, rot_points, sqrt_rn
from plainref.ops.moments import inertia
from plainref.physics.rigid import quat_to_mat
from plainref.types import RigidState


@dataclasses.dataclass
class PhysicsScene:
    """bodies (B,) rigid states; pieces (Np,) convex shapes owned by bodies,
    sorted by owner. ``warm_*`` hold the warm-start state of the JAX
    package's layout; the ported fast path runs without warm start and
    carries them through unchanged."""

    bodies: RigidState
    piece_owner: torch.Tensor   # (Np,) i32 body index or -1, ascending
    piece_valid: torch.Tensor   # (Np,) bool
    piece_verts: torch.Tensor   # (Np, Vh, 3) body-frame hull corners
    piece_vmask: torch.Tensor   # (Np, Vh) bool
    piece_planes: torch.Tensor  # (Np, F, 4) body-frame face planes
    piece_pmask: torch.Tensor   # (Np, F) bool
    piece_edges: torch.Tensor   # (Np, Ne, 3) distinct body-frame edge dirs
    piece_emask: torch.Tensor   # (Np, Ne) bool
    seg_start: torch.Tensor     # (B+1,) i32 piece-run offsets per body
    sleep_frames: torch.Tensor  # (B,) i32 consecutive slow steps
    push_frames: torch.Tensor   # (B,) i32 steps a sleeper felt sustained push
    warm_pair: torch.Tensor     # (Np, K) i32
    warm_fid: torch.Tensor      # (Np, M·K) i32
    warm_lam: torch.Tensor      # (Np, M·K·3) f32

    @property
    def B(self) -> int:
        return self.bodies.N

    @property
    def Np(self) -> int:
        return self.piece_owner.shape[-1]


def _dedup_verts(fv: torch.Tensor, sm: torch.Tensor, Vh: int):
    """(P, F, S, 3) face soups → ((P, Vh, 3) first-occurrence unique corner
    pools, (P, Vh) mask). Exact-equality dedup: corners shared by faces are
    bitwise equal, and the pool holds copies of them."""
    P = fv.shape[0]
    pts = fv.reshape(P, -1, 3)
    m = sm.reshape(P, -1)
    n = pts.shape[1]
    eq = torch.all(pts[:, :, None] == pts[:, None], dim=-1) & m[:, None, :] & m[:, :, None]
    idx = torch.arange(n, device=fv.device)
    first = torch.amin(torch.where(eq, idx, n), dim=-1)
    is_first = m & (first == idx)
    tgt = torch.cumsum(is_first.to(torch.int32), dim=-1) - is_first.to(torch.int32)
    keep = is_first & (tgt < Vh)
    slot = torch.where(keep, tgt, Vh).long()
    out = torch.zeros((P, Vh + 1, 3), dtype=fv.dtype, device=fv.device)
    out.scatter_(1, slot[..., None].expand(P, n, 3), pts)
    cnt = torch.clamp(is_first.sum(-1), max=Vh)
    return out[:, :Vh], torch.arange(Vh, device=fv.device) < cnt[:, None]


def _edge_dirs(fv: torch.Tensor, nv: torch.Tensor, Ne: int):
    """Up to ``Ne`` distinct edge directions per convex: greedy max-min
    angular selection over the face-loop edges, first of ties.

    fv (P, F, S, 3) face loops; nv (P, F). Returns ((P, Ne, 3) unit dirs in
    canonical sign, (P, Ne) mask)."""
    P, F, S = fv.shape[:3]
    if Ne == 0:
        return fv.new_zeros((P, 0, 3)), torch.zeros((P, 0), dtype=torch.bool, device=fv.device)
    slot = torch.arange(S, dtype=torch.int32, device=fv.device)
    m = slot < nv[..., None]
    rolled = torch.cat([fv[:, :, 1:], fv[:, :, :1]], dim=2)
    is_last = slot == nv[..., None] - 1
    v_next = torch.where(is_last[..., None], fv[:, :, :1], rolled)
    d = (v_next - fv).reshape(P, F * S, 3)
    ln = sqrt_rn(dot3(d, d))
    valid = m.reshape(P, F * S) & (ln > 1e-9)
    u = d / torch.clamp(ln, min=1e-30)[..., None]
    # Canonical sign: first significant component positive.
    zero = torch.zeros_like(u[..., 0])
    sx = torch.where(torch.abs(u[..., 0]) > 1e-4, torch.sign(u[..., 0]), zero)
    sy = torch.where(torch.abs(u[..., 1]) > 1e-4, torch.sign(u[..., 1]), zero)
    sz = torch.where(u[..., 2] >= 0, 1.0, -1.0)
    s = torch.where(sx != 0, sx, torch.where(sy != 0, sy, sz))
    u = u * s[..., None]

    chosen, cmask = [], []
    dissim = torch.where(valid, 2.0, -1.0)
    for _ in range(Ne):
        score = torch.where(valid, dissim, -1.0)
        best = torch.argmax(score, dim=-1)      # first of ties
        c = torch.gather(u, 1, best[:, None, None].expand(P, 1, 3))[:, 0]
        chosen.append(c)
        cmask.append(torch.amax(score, dim=-1) > 2e-2)
        dissim = torch.minimum(dissim, 1.0 - torch.abs(dot3(u, c[:, None])))
    return torch.stack(chosen, 1), torch.stack(cmask, 1)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse as adjugate / determinant, written out: the same
    bits on every device (the card's batched solver and the CPU's LAPACK
    round their steps differently). Callers pass float64 and round once."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    det = (a * A + b * B) + c * C
    adj = torch.stack([A, c * h - b * i, b * f - c * e,
                       B, a * i - c * g, c * d - a * f,
                       C, b * g - a * h, a * e - b * d], -1).reshape(m.shape)
    return adj / det[..., None, None]


def _segment_sum(x: torch.Tensor, gid: torch.Tensor, B: int) -> torch.Tensor:
    """Per-body sums of piece rows, accumulated in float64 and rounded once.
    The card's ``index_add_`` still adds in no fixed order; in float64 that
    order moves the float32 result only where the sum lies next to a
    float32 rounding boundary, so the card agrees with the CPU but for such
    rare sums."""
    out = torch.zeros((B + 1,) + x.shape[1:], dtype=torch.float64, device=x.device)
    return out.index_add_(0, gid.long(), x.double())[:B].to(x.dtype)


def build_scene(pieces: PieceSet, cfg: PhysicsConfig, max_bodies: int | None = None) -> PhysicsScene:
    """Rigid bodies from piece groups, at rest (the reference gives new
    fragments no velocity)."""
    P = pieces.P
    B = max_bodies if max_bodies is not None else P
    Vh = cfg.max_hull_verts
    dev = pieces.valid.device
    conv = pieces.convex

    mass_p, com_p, I_p = inertia(conv, density=cfg.density)
    mass_p = torch.where(pieces.valid, mass_p, 0.0)
    gid = torch.where(pieces.valid, pieces.group, B)   # invalid → dump row B

    m_b = _segment_sum(mass_p, gid, B)
    com_b = _segment_sum(com_p * mass_p[:, None], gid, B) / torch.clamp(m_b, min=1e-12)[:, None]

    # Inertia about the body COM (parallel axis per piece).
    d = com_p - com_b[torch.clamp(gid, 0, B - 1).long()]
    d2 = dot3(d, d)
    eye = torch.eye(3, device=dev)
    shift = mass_p[:, None, None] * (d2[:, None, None] * eye - d[:, :, None] * d[:, None, :])
    I_b = _segment_sum(I_p + shift, gid, B)
    body_valid = m_b > 0

    inv_m = torch.where(body_valid, 1.0 / torch.clamp(m_b, min=1e-12), 0.0)
    I_safe = torch.where(body_valid[:, None, None], I_b, eye)
    inv_I = _inv3((I_safe + 1e-9 * eye).double()).to(I_safe.dtype)
    inv_I = torch.where(body_valid[:, None, None], inv_I, 0.0)

    q = torch.zeros((B, 4), device=dev)
    q[:, 0] = 1.0
    bodies = RigidState(
        x=com_b, q=q, v=torch.zeros((B, 3), device=dev), w=torch.zeros((B, 3), device=dev),
        inv_mass=inv_m, inv_inertia_body=inv_I, active=body_valid,
    )

    # Piece hulls in body frame.
    shift_p = com_b[torch.clamp(gid, 0, B - 1).long()]
    fv_local = conv.face_verts - shift_p[:, None, None, :]
    verts, vmask = _dedup_verts(fv_local, conv.slot_mask(), Vh)
    n = conv.planes[..., :3]
    dpl = conv.planes[..., 3:4] + dot3(n, shift_p[:, None, :])[..., None]
    planes_local = torch.cat([n, dpl], dim=-1)
    edges, emask = _edge_dirs(fv_local, conv.n_verts, cfg.max_edge_dirs)

    # Sort pieces by owner (stable, as jnp.argsort) so each body's pieces
    # form one run starting at seg_start.
    owner_raw = torch.where(pieces.valid, pieces.group, -1).to(torch.int32)
    sort_key = torch.where(owner_raw >= 0, owner_raw, B)
    order = torch.argsort(sort_key, stable=True)
    seg_start = torch.searchsorted(
        sort_key[order].contiguous(), torch.arange(B + 1, dtype=sort_key.dtype, device=dev)
    ).to(torch.int32)
    valid_p = pieces.valid
    owner_s = owner_raw[order]
    valid_s = valid_p[order] & (owner_s >= 0) & body_valid[torch.clamp(owner_s, 0, B - 1).long()]
    K = cfg.max_neighbors
    MK = max(1, cfg.manifold_points) * K
    return PhysicsScene(
        bodies=bodies,
        piece_owner=owner_s,
        piece_valid=valid_s,
        piece_verts=torch.where(vmask[..., None], verts, 0.0)[order],
        piece_vmask=(vmask & valid_p[:, None])[order],
        piece_planes=planes_local[order],
        piece_pmask=(conv.face_mask() & valid_p[:, None])[order],
        piece_edges=edges[order],
        piece_emask=(emask & valid_p[:, None])[order],
        seg_start=seg_start,
        sleep_frames=torch.zeros((B,), dtype=torch.int32, device=dev),
        push_frames=torch.zeros((B,), dtype=torch.int32, device=dev),
        warm_pair=torch.full((P, K), -1, dtype=torch.int32, device=dev),
        warm_fid=torch.zeros((P, MK), dtype=torch.int32, device=dev),
        warm_lam=torch.zeros((P, MK * 3), dtype=torch.float32, device=dev),
    )


def piece_world_verts(scene: PhysicsScene):
    """World-space hull corners per piece: ((Np, Vh, 3), mask)."""
    owner = torch.clamp(scene.piece_owner, 0, scene.B - 1).long()
    R = quat_to_mat(scene.bodies.q)[owner]
    x = scene.bodies.x[owner]
    return rot_points(R, scene.piece_verts) + x[:, None], scene.piece_vmask
