"""Exact cut-surface caps for clipped closed meshes (counterpart of
``surtr_tpu/ops/caps.py``).

A candidate piece's cap on cut plane t is face t of its pre-refit convex
intersected with the solid's cross-section at t, emitted as a signed fan:

* dA, the cap boundary on the solid's surface: the edges of the clipped
  surface triangles whose two ends lie on plane t, traversed opposite to
  their triangle (closed-mesh orientation);
* dB, the cap boundary on the other cut planes: the convex face's loop
  edges, split at their 2-D crossings with the dA segments, each piece
  kept when it is not already covered by a dA segment and both probes
  beside its midpoint (nudged into the face, then ±n off the plane) lie
  inside the solid.

Candidate edge records [p, q, face, kind] are compacted into a pool of
``cap_edge_pool`` slots before any inside-solid probe. Everything is
batched over the leading candidate axis (the JAX package's ``vmap``).
The loop centre is summed slot by slot, the JAX package's order; the fan
origins' sums, whose order the device picks, run in float64 and round once
to float32. The one-hot contractions of the JAX package are gathers plus
+0 (a one-hot sum turns -0 into +0).
"""

from __future__ import annotations

import torch

from plainref.ops.clip import plane_basis
from plainref.ops.hull import _cross
from plainref.ops.linalg import compact, dot3, sqrt_rn, supports
from plainref.ops.mesh_clip import parity_grid_inside, point_in_mesh
from plainref.profiling import fence_sum


def match_cut_faces(poly, cut_planes, cut_mask, scale, tol: float = 1e-4):
    """(..., F) bool — faces of ``poly`` whose plane equals one of the cut
    planes (..., Kc, 4) (cap faces carry their cut plane bitwise, so a loose
    tolerance suffices)."""
    n = poly.planes[..., :3]
    d = poly.planes[..., 3]
    ndot = supports(n, cut_planes[..., :3].expand(n.shape[:-2] + cut_planes.shape[-2:-1] + (3,)))
    dm = torch.abs(d[..., None] - cut_planes[..., None, :, 3])
    hit = (torch.abs(ndot - 1.0) < tol) & (dm < tol * scale) & cut_mask[..., None, :]
    return torch.any(hit, dim=-1) & poly.face_mask()


def _take(a, idx):
    """a (N, M, ...) gathered along axis 1 at idx (N, K) → (N, K, ...)."""
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
        idx.shape + a.shape[2:]))


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _cap_candidates(conv, mtris, mmask, cut_planes, cut_mask, mas, cfg, profile_stage: int = 99):
    """Candidate cap-boundary edge records of a candidate batch: rec (N, RT,
    8) [p, q, face, kind (0 dA, 1 dB)], flag (N, RT) live before any probe,
    pls (N, CF, 4) the cut faces' planes, n_over (N,) the cut faces and dA
    edges lost to capacity. RT = CF·NA + CF·S·(X+1). ``profile_stage`` 1-4
    returns the fence after the face selection and on-plane edge masks (1),
    the dA compaction (2), the crossing parameters (3) or the dA coverage
    (4), the JAX package's ``_cap_candidates_one`` stages summed over the
    batch."""
    N, F, S = conv.face_verts.shape[:3]
    CF, NA, X = cfg.cap_faces, cfg.cap_edges, cfg.cap_crossings
    Tp = mtris.shape[1]
    dev, dt = mtris.device, mtris.dtype
    tol_on = 1e-5 * torch.clamp(mas, min=1.0)
    eps = 1e-6 * torch.clamp(mas, min=1.0)
    eps2 = eps * eps

    # The cut faces, front-compacted in face order.
    cut_sel = match_cut_faces(conv, cut_planes, cut_mask, mas)            # (N, F)
    fidx, n_cf = compact(torch.arange(F, device=dev).expand(N, F)[..., None], cut_sel, CF)
    fidx = fidx[..., 0]                                                   # (N, CF)
    cf_ok = torch.arange(CF, device=dev) < n_cf[:, None]
    n_cf_over = torch.clamp(cut_sel.sum(1) - CF, min=0)
    loops = torch.where(cf_ok[..., None, None], _take(conv.face_verts, fidx) + 0.0, 0.0)
    nv = torch.where(cf_ok, _take(conv.n_verts, fidx), 0)
    pls = torch.where(cf_ok[..., None], _take(conv.planes, fidx) + 0.0, 0.0)

    # dA: on-plane edges of the clipped surface soup.
    m4 = mtris[:, None]                                                   # (N, 1, Tp, 3, 3)
    pl = pls[:, :, None, None, :]
    dv = pl[..., 0] * m4[..., 0] + pl[..., 1] * m4[..., 1] + pl[..., 2] * m4[..., 2] + pl[..., 3]
    on = torch.abs(dv) < tol_on
    all_on = torch.all(on, dim=-1)
    nxt = torch.tensor([1, 2, 0], device=dev)
    e_on = on & on[..., nxt] & mmask[:, None, :, None] & ~all_on[..., None]
    e_ok = e_on.reshape(N, CF, 3 * Tp)
    ea = mtris.reshape(N, 1, 3 * Tp, 3).expand(N, CF, 3 * Tp, 3)
    eb = mtris[:, :, nxt].reshape(N, 1, 3 * Tp, 3).expand(N, CF, 3 * Tp, 3)
    n_a_over = (torch.clamp(e_ok.sum(-1) - NA, min=0) * cf_ok).sum(1)
    if profile_stage <= 1:
        return fence_sum(e_ok, loops, dv)
    # The cap traverses the shared edge opposite to its surface triangle.
    packed, n_a = compact(torch.cat([eb, ea], dim=-1), e_ok, NA)         # (N, CF, NA, 6)
    if profile_stage <= 2:
        return fence_sum(packed, n_a)
    a_p, a_q = packed[..., 0:3], packed[..., 3:6]
    dpq = a_p - a_q
    a_ok = ((torch.arange(NA, device=dev) < n_a[..., None]) & cf_ok[..., None]
            & (dot3(dpq, dpq) > eps2))

    # dB: sub-intervals of each cut face's loop edges between crossings.
    u, v = plane_basis(pls[..., :3])                                      # (N, CF, 3)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    live = slot < nv[..., None]                                           # (N, CF, S)
    # The loop centre summed slot by slot from +0: XLA's order for this
    # reduce, written out so that both devices take it.
    lm = torch.where(live[..., None], loops, 0.0)
    cen = 0.0 + lm[..., 0, :]
    for k in range(1, S):
        cen = cen + lm[..., k, :]
    cen = cen / torch.clamp(nv, min=1)[..., None].to(dt)

    def p2(x):                                                            # x (N, CF, M, 3)
        r = x - cen[:, :, None]
        return torch.stack([dot3(r, u[:, :, None]), dot3(r, v[:, :, None])], dim=-1)

    w2 = p2(loops)                                                        # (N, CF, S, 2)
    is_last = (slot == nv[..., None] - 1)[..., None]
    w_next = torch.where(is_last, loops[..., 0:1, :], torch.roll(loops, -1, dims=-2))
    w2n = torch.where(is_last, w2[..., 0:1, :], torch.roll(w2, -1, dims=-2))
    edge_ok = live & cf_ok[..., None]

    q0 = p2(a_p)                                                          # (N, CF, NA, 2)
    q1 = p2(a_q)
    r = w2n - w2                                                          # (N, CF, S, 2)
    s = q1 - q0                                                           # (N, CF, NA, 2)
    den = _cross2(r[..., :, None, :], s[..., None, :, :])                 # (N, CF, S, NA)
    dq = q0[..., None, :, :] - w2[..., :, None, :]                        # (N, CF, S, NA, 2)
    tnum = _cross2(dq, s[..., None, :, :])
    unum = _cross2(dq, r[..., :, None, :])
    big_den = torch.abs(den) > 1e-12
    safe = torch.where(big_den, den, 1.0)
    tt = tnum / safe
    uu = unum / safe
    # Generous slack on the dA parameter: an extra split is harmless, a
    # missed junction misclassifies a whole interval.
    xv = (big_den & a_ok[..., None, :] & (tt > 1e-6) & (tt < 1.0 - 1e-6)
          & (uu > -0.05) & (uu < 1.05))
    # X passes of the minimum, ascending, each masking every tie.
    tt_m = torch.where(xv, tt, 1.0)
    ts = []
    for _ in range(X):
        m = torch.amin(tt_m, dim=-1, keepdim=True)                        # (N, CF, S, 1)
        ts.append(m)
        tt_m = torch.where(tt_m <= m, 1.0, tt_m)
    if profile_stage <= 3:
        return fence_sum(ts)
    ones = torch.ones_like(ts[0])
    bounds = torch.cat([ones * 0.0, *ts, ones], dim=-1)                   # (N, CF, S, X+2)
    e3 = w_next - loops                                                   # (N, CF, S, 3)
    pts = loops[..., None, :] + bounds[..., None] * e3[..., None, :]      # (N, CF, S, X+2, 3)
    # dA coverage: a dB interval whose midpoint lies on a dA segment yields.
    midb = 0.5 * (bounds[..., :-1] + bounds[..., 1:])                     # (N, CF, S, X+1)
    m2 = w2[..., None, :] + midb[..., None] * r[..., None, :]             # (N, CF, S, X+1, 2)
    qx = q0[:, :, None, None, :, 0]
    qy = q0[:, :, None, None, :, 1]
    sx = s[:, :, None, None, :, 0]
    sy = s[:, :, None, None, :, 1]
    dqx = m2[..., 0:1] - qx                                               # (N, CF, S, X+1, NA)
    dqy = m2[..., 1:2] - qy
    ss = s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]                    # (N, CF, NA)
    ss_safe = torch.where(ss > 1e-30, ss, 1.0)[:, :, None, None, :]
    tproj = torch.clamp((dqx * sx + dqy * sy) / ss_safe, 0.0, 1.0)
    ex = dqx - tproj * sx
    ey = dqy - tproj * sy
    d2 = ex * ex + ey * ey
    eps_cov = 3e-4 * mas
    covered = torch.any((d2 < eps_cov * eps_cov) & a_ok[:, :, None, None, :], dim=-1)
    if profile_stage <= 4:
        return fence_sum(covered, pts)
    seg = bounds[..., 1:] - bounds[..., :-1]
    seg2 = seg * seg * dot3(e3, e3)[..., None]                            # (N, CF, S, X+1)

    fcol = torch.arange(CF, dtype=dt, device=dev)[None, :, None, None]
    a_rec = torch.cat([a_p, a_q, fcol.expand(N, CF, NA, 1),
                       torch.zeros((N, CF, NA, 1), dtype=dt, device=dev)], dim=-1)
    b_rec = torch.cat([pts[..., :-1, :], pts[..., 1:, :],
                       fcol[..., None].expand(N, CF, S, X + 1, 1),
                       torch.ones((N, CF, S, X + 1, 1), dtype=dt, device=dev)], dim=-1)
    keep_b = ~covered & edge_ok[..., None] & (seg2 > eps2)
    rec = torch.cat([a_rec.reshape(N, CF * NA, 8), b_rec.reshape(N, CF * S * (X + 1), 8)], dim=1)
    flag = torch.cat([a_ok.reshape(N, CF * NA), keep_b.reshape(N, CF * S * (X + 1))], dim=1)
    return rec, flag, pls, n_cf_over + n_a_over


def cap_fans_batch(conv, mtris, mmask, cut_planes, cut_mask, solid_t, solid_m, mas, cfg,
                   solid_grid=None, profile_stage: int = 99):
    """Exact caps for a candidate batch (leading axis N).

    conv is the pre-refit candidate convex (its faces on the cut planes
    bound the true cap), mtris (N, Tp, 3, 3) / mmask (N, Tp) the clipped
    island-masked surface soup, cut_planes (N, Kc, 4) / cut_mask (N, Kc)
    the half-spaces of this round, solid_t (N, Ts, 3, 3) / solid_m (N, Ts)
    each candidate's source solid. ``solid_grid`` (``build_parity_grid``
    of one shared source solid, prepare) answers the probes; without it
    each candidate's solid is probed by ray parity.

    Returns (cap_rows (N, CT, 3, 3), cap_ok (N, CT), pool_v (N, CP, 3),
    pool_m (N, CP), dropped ()), or with ``profile_stage`` 1-4 the fence of
    that stage of ``_cap_candidates``."""
    CF, CT, CP = cfg.cap_faces, cfg.cap_tris, cfg.cap_pool
    # The record pool is never smaller than the cap count asked for.
    E = max(cfg.cap_edge_pool, cfg.cap_tris)
    dev = mtris.device
    cc = _cap_candidates(conv, mtris, mmask, cut_planes, cut_mask, mas, cfg, profile_stage)
    if profile_stage <= 4:
        return cc
    rec, flag, pls, n_over = cc
    N, RT = flag.shape

    idx, n_e = compact(torch.arange(RT, device=dev).expand(N, RT)[..., None], flag, E)
    rec_e = _take(rec, idx[..., 0])                                       # (N, E, 8)
    slot_ok = torch.arange(E, device=dev) < n_e[:, None]
    pack_over = flag.sum(1) - n_e

    p, q = rec_e[..., 0:3], rec_e[..., 3:6]
    fid = rec_e[..., 6].to(torch.int64)                                   # (N, E)
    is_b = rec_e[..., 7] > 0.5
    nrm = _take(pls[..., :3], fid) + 0.0                                  # (N, E, 3)

    # Two probes beside each edge's midpoint: an in-plane nudge to its left
    # (into the cap) plus ±n/4 of it off the plane. A true cap edge has
    # material on both sides of the cut plane; a tangent plane has it on at
    # most one.
    left = _cross(nrm, q - p)
    ln = sqrt_rn(dot3(left, left))[..., None]
    left = left / torch.where(ln > 1e-30, ln, 1.0)
    d_ = cfg.cap_probe_nudge * mas
    base = 0.5 * (p + q) + left * d_
    off = nrm * (0.25 * d_)
    probes = torch.stack([base + off, base - off], dim=2)                 # (N, E, 2, 3)
    if solid_grid is not None:
        inside = parity_grid_inside(solid_grid, probes.reshape(-1, 3)).reshape(N, E, 2)
    else:
        # Ray parity: the solids are closed (capped), and the signed fan
        # pairs that cancel cross a ray twice.
        inside = point_in_mesh(probes.reshape(N, 2 * E, 3), solid_t, solid_m).reshape(N, E, 2)
    keep = slot_ok & inside[..., 0] & inside[..., 1]                      # (N, E)

    # Fan origin per face: the mean of its kept boundary points.
    pq = torch.where(keep[..., None], p + q, 0.0).double()
    s_f = torch.zeros((N, CF, 3), dtype=torch.float64, device=dev).scatter_add_(
        1, fid[..., None].expand(N, E, 3), pq).to(p.dtype)
    cnt = 2.0 * torch.zeros((N, CF), dtype=p.dtype, device=dev).scatter_add_(
        1, fid, keep.to(p.dtype))
    origin = s_f / torch.clamp(cnt, min=1.0)[..., None]                   # (N, CF, 3)
    orig_e = _take(origin, fid) + 0.0                                     # (N, E, 3)

    tris = torch.stack([orig_e, p, q], dim=-2)                            # (N, E, 3, 3)
    cap_rows, n_cap = compact(tris.reshape(N, E, 9), keep, CT)
    cap_rows = cap_rows.reshape(N, CT, 3, 3)
    cap_ok = torch.arange(CT, device=dev) < n_cap[:, None]
    ct_over = keep.sum(1) - n_cap

    # Refit-pool points: the dB interval ends (dA ends are surface corners
    # already in the pool; fan origins are not boundary points).
    pm1 = keep & is_b
    pool_v, n_pool = compact(torch.cat([p, q], dim=1), torch.cat([pm1, pm1], dim=1), CP)
    pool_m = torch.arange(CP, device=dev) < n_pool[:, None]
    pool_over = 2 * pm1.sum(1) - n_pool

    dropped = n_over.sum() + pack_over.sum() + ct_over.sum() + pool_over.sum()
    return cap_rows, cap_ok, pool_v, pool_m, dropped
