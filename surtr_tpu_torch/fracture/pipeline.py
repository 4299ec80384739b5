"""The fracture pipeline (counterpart of ``surtr_tpu/fracture/pipeline.py``;
reference PrepareFracture and DoFracture).

``prepare_fracture``: ICH → k-DOP → ACH, then C Voronoi cells of the ACH
folded in two passes, the source mesh clipped per cell (every source
triangle against every cell, or, when a per-cell cull pool is smaller than
the source, the culled pair pool of (cell, triangle) lanes), mesh islands
split, the cells refit (tetra hull + k-DOP slabs) and capped, and the
candidates packed into a PieceSet. ``do_fracture``: the impact pattern
scaled to the model and placed at the impact, the A active pieces folded
by its C cells, the live jobs compacted and their meshes clipped, islands
split, the pieces refit and capped, out-of-sphere pieces merged back, and
every compound split into contact-connected components
(``split_groups_by_contact``).

With ``exact_caps`` (the default) each candidate's caps are its pre-refit
convex's cut faces intersected with its source solid's cross-sections
(``ops/caps.py``), and their boundary points join the refit pool; without
it the caps are the refit convex's cut faces. ``prepare_fracture`` answers
its inside-solid queries from a parity grid of the source mesh when
``island_grid_res`` > 0, C >= 64 and the mesh has >= 512 triangles.

Five hand-written kernels carry it on the GPU: the clip fold B1 (ACH,
pattern cells, the Voronoi and impact folds, the refit fold), the ICH B2
(the model hull, and the refit hulls above limit 4),
the island labels B3, the refit planes B4 and the pooled soup clip B10;
everything around them is plain PyTorch on the input tensors' device.

``profile_stage`` truncates either entry point after a stage, as the JAX
package's does, returning the stage's fence (``profiling.fence_sum`` of its
outputs) in place of the results: ``prepare_fracture`` after 1 (ICH, k-DOP,
ACH), 2 (+ cell planes), 3 (+ patterns), 4 (+ convex clip), 42-44 (inside
the culled mesh clip: + active planes and cull, + pair pack, + pooled
fold), 5 (+ mesh clip), 6 (+ islands), 45-49 (inside ``_finish_pieces``) or
7 (+ finish); ``do_fracture`` after 1 (selection and convex clip grid), 2
(+ mesh clip), 3 (+ islands), 41-49 (inside ``_finish_pieces``), 4 (+
finish) or 5 (+ merge and pack).

While torch.profiler records, ``prepare_fracture`` is the span
``prepare`` (``profiling.span``), tiled by six stage spans whose ends are
the stage fences: ``hull_cells`` (1-3), ``cell_clip`` (4), ``mesh_clip``
(5, with 42-44), ``islands`` (6), ``finish`` (7, with 45-49) and
``pack``; ``_finish_pieces`` opens ``caps`` around ``cap_fans_batch``.

The refit takes kernel B4's tetra hull at ``refitting_point_limit`` <= 4
(the default) and above it the ICH of each candidate's pool, all
candidates in one batched B2 launch (``refit_planes``), as the JAX package
takes its vmapped ``ich``. With ``mesh_pair_pool=False`` the culled mesh
clip folds each cell's own pool of ``cull_cap`` triangles (plain PyTorch,
no B10), the JAX package's per-cell fallback.
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.config import FractureConfig
from surtr_tpu_torch.fracture.pattern import pattern_cells, radial_seeds, uniform_seeds
from surtr_tpu_torch.fracture.types import FractureContext, PieceSet
from surtr_tpu_torch.ops.caps import cap_fans_batch, match_cut_faces
from surtr_tpu_torch.ops.clip import clip_poly_planes, contains_point, plane_basis
from surtr_tpu_torch.ops.clip_cuda import clip_planes_batch
from surtr_tpu_torch.ops.hull import tetra_hull
from surtr_tpu_torch.ops.hull_cuda import ich, ich_batch
from surtr_tpu_torch.ops.kdop import kdop_planes
from surtr_tpu_torch.ops.labels import adjacency_components
from surtr_tpu_torch.ops.labels_cuda import tri_soup_components_batch
from surtr_tpu_torch.ops.linalg import compact, div_rn, dot3, pack_rows, sqrt_rn
from surtr_tpu_torch.ops.mesh_clip import (build_parity_grid, clip_polys_by_rows, clip_trisoup,
                                           fan_triangles, parity_grid_inside, point_in_mesh,
                                           winding_inside)
from surtr_tpu_torch.ops.moments import moments
from surtr_tpu_torch.ops.refit_cuda import refit_planes_from_parts
from surtr_tpu_torch.ops.soup_clip_cuda import soup_clip_pooled
from surtr_tpu_torch.ops.voronoi import bisector_planes, nearest_first
from surtr_tpu_torch.profiling import fence_sum, span, spanned
from surtr_tpu_torch.types import ConvexPoly, scale_poly, translate_poly, unit_cube

BIG = 3.4e38


def _stable_front(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Indices that put flagged entries first, each group in index order,
    truncated to k (the JAX package's top_k over -arange scores)."""
    return torch.sort((~flags).to(torch.int8), dim=-1, stable=True).indices[..., :k]


def refit_planes(verts: torch.Tensor, vmask: torch.Tensor, limit: int):
    """Refitting slab planes (Surtr.cpp:2405-2413): the ICH(limit) of each
    piece's vertex pool, then the k-DOP along its face normals with no
    outward gap. verts (..., P, 3), vmask (..., P), one pool or a batch of
    them (all in one B2 launch on the card); limit <= 4 builds the seed
    tetrahedron only (plain ``tetra_hull``). Planes are masked out of a pool
    with fewer than 4 live points. Returns ((..., 2F, 4), (..., 2F))."""
    if limit <= 4:
        h = tetra_hull(verts, vmask)
    else:
        lead = verts.shape[:-2]
        pts = verts.reshape((-1,) + verts.shape[-2:])
        h = ich_batch(pts, vmask.reshape(pts.shape[:2]), limit=limit)
        h = {k: v.reshape(lead + v.shape[1:]) for k, v in h.items()}
    planes, pm = kdop_planes(verts, vmask, h["normals"], h["face_valid"], gap=0.0)
    enough = torch.sum(vmask, dim=-1) >= 4
    return planes, pm & enough[..., None]


def refit_convex(convex: ConvexPoly, verts: torch.Tensor, vmask: torch.Tensor,
                 limit: int) -> ConvexPoly:
    """Single-piece refit (Kdop::ClipWithPolyhedron): slab planes, then the
    plain clip of ``convex`` (F, S) by them."""
    planes, pm = refit_planes(verts, vmask, limit)
    out = clip_poly_planes(convex.map(lambda a: a[None]), planes[None], pm[None])
    return out.map(lambda a: a[0])


def convex_out_of_sphere(poly: ConvexPoly, cloud: torch.Tensor, center: torch.Tensor,
                         radius) -> torch.Tensor:
    """ConvexOutOfSphere: a piece is outside the impact sphere iff none of
    its vertices lies within ``radius`` of ``center`` and none of the
    sphere-cloud points (Pc, 3) lies inside the convex (n·p + d <= 0 on
    every live face, in ``dot3`` order). poly batch (...) → (...) bool."""
    fv = poly.face_verts
    r = fv - center
    d2 = dot3(r, r)
    vert_inside = torch.any((poly.slot_mask() & (d2 < radius * radius)).flatten(-2), dim=-1)
    s = dot3(poly.planes[..., None, :3], cloud) + poly.planes[..., 3:]   # (..., F, Pc)
    ok = (s <= 0) | ~poly.face_mask()[..., None]
    empty = poly.is_empty()
    cloud_inside = torch.any(torch.all(ok, dim=-2), dim=-1) & ~empty
    return ~vert_inside & ~cloud_inside & ~empty


def cut_face_tris(poly: ConvexPoly, face_sel: torch.Tensor):
    """Fan-triangulate the selected faces: ((..., F, S-2, 3, 3) fans,
    (..., F) counts)."""
    S = poly.S
    fv = poly.face_verts
    fan = torch.arange(S - 2, device=fv.device)
    tris = torch.stack(
        [fv[..., 0:1, :].expand(fv[..., : S - 2, :].shape), fv[..., fan + 1, :], fv[..., fan + 2, :]],
        dim=-2,
    )
    counts = torch.where(face_sel, torch.clamp(poly.n_verts - 2, min=0), 0)
    return tris, counts


def _append_tris(base, base_mask, extra_rows, extra_counts):
    """Place row-structured extra triangles into the free slots of masked
    triangle arrays: base (N, T, 3, 3), base_mask (N, T), extra_rows
    (N, F, Sf, 3, 3), extra_counts (N, F). The k-th free slot gets the k-th
    packed extra triangle. Returns (tris, mask, dropped (N,))."""
    N, T = base_mask.shape
    F, Sf = extra_rows.shape[1], extra_rows.shape[2]
    fan_ok = torch.arange(Sf, device=base.device) < extra_counts[..., None]
    packed, _ = compact(extra_rows.reshape(N, F * Sf, 9), fan_ok.reshape(N, F * Sf), T)
    n_extra = extra_counts.sum(-1)
    free = ~base_mask
    fi = free.to(torch.int64)
    rank = torch.cumsum(fi, -1) - fi
    take = free & (rank < n_extra[:, None])
    shifted = torch.gather(packed, 1, rank[..., None].expand(N, T, 9)).reshape(N, T, 3, 3)
    out = torch.where(take[..., None, None], shifted, base)
    out_mask = base_mask | take
    dropped = torch.clamp(n_extra - free.sum(-1), min=0)
    return out, out_mask, dropped


def _cell_plane_sets(seeds: torch.Tensor, k: int, extent, center):
    """Per-seed half-space sets in world space: the 6 unit-domain walls +
    the k nearest bisectors (exact selection), then the anisotropic scale
    and translate. Returns ((C, k+6, 4), (C, k+6) mask)."""
    C = seeds.shape[0]
    dev, dt = seeds.device, seeds.dtype
    r = seeds[:, None] - seeds[None]
    d2 = dot3(r, r)
    d2.fill_diagonal_(BIG)
    idx = nearest_first(-d2, k)
    bp, bm = bisector_planes(seeds, seeds[idx], torch.ones((C, k), dtype=torch.bool, device=dev))
    eye = torch.eye(3, dtype=dt, device=dev)
    dom = torch.cat([torch.cat([eye, -eye]), torch.full((6, 1), -0.5, dtype=dt, device=dev)], 1)
    planes_u = torch.cat([dom.expand(C, 6, 4), bp], dim=1)
    pmask = torch.cat([torch.ones((C, 6), dtype=torch.bool, device=dev), bm], dim=1)
    n = planes_u[..., :3] / extent
    ln = sqrt_rn(dot3(n, n))[..., None]
    safe = torch.where(ln > 0, ln, torch.ones_like(ln))
    # (u / extent) / safe as XLA rewrites it, u / (extent · safe): the JAX
    # package's bits.
    n = planes_u[..., :3] / (extent * safe)
    d = planes_u[..., 3:4] / safe
    d = d - dot3(n, center)[..., None]
    return torch.cat([n, d], dim=-1), pmask


def _two_pass_cell_clip(poly_b, cell_planes, cell_pmask, prefix: int):
    """Voronoi cell fold in two passes: walls + ``prefix`` nearest
    bisectors, then only the tail planes whose support over the pass-1
    cell is positive (exact: any other plane cannot cut), compacted to the
    front in their original order."""
    Kt = cell_planes.shape[1]
    K1 = 6 + prefix
    if prefix <= 0 or K1 >= Kt:
        return clip_planes_batch(poly_b, cell_planes, cell_pmask)
    conv = clip_planes_batch(poly_b, cell_planes[:, :K1], cell_pmask[:, :K1])
    fv = conv.face_verts
    tn = cell_planes[:, K1:, :3]
    td = cell_planes[:, K1:, 3]
    d = (
        tn[:, :, None, None, 0] * fv[:, None, :, :, 0]
        + tn[:, :, None, None, 1] * fv[:, None, :, :, 1]
        + tn[:, :, None, None, 2] * fv[:, None, :, :, 2]
        + td[:, :, None, None]
    )                                                          # (C, K2, F, S)
    smax = torch.amax(torch.where(conv.slot_mask()[:, None], d, -BIG), dim=(2, 3))
    need = cell_pmask[:, K1:] & (smax > 0.0)
    ord_idx = _stable_front(need, Kt - K1)
    tail = torch.gather(cell_planes[:, K1:], 1, ord_idx[..., None].expand(-1, -1, 4))
    tmask = torch.gather(need, 1, ord_idx)
    return clip_planes_batch(conv, tail, tmask)


def _active_planes(conv, cell_planes, cell_pmask, KA: int, mas):
    """Compact each cell's planes to the KA that support a face of the
    folded cell (max signed vertex distance >= -tol); dead cells get one
    all-removing plane. Returns (planes, mask, overflow count)."""
    C, Kt = cell_pmask.shape
    dev, dt = cell_planes.device, cell_planes.dtype
    tol_a = 1e-5 * mas
    vf = conv.face_verts.reshape(C, -1, 3)
    vm = conv.slot_mask().reshape(C, -1)
    pl = cell_planes
    d = (
        pl[:, :, 0:1] * vf[:, None, :, 0]
        + pl[:, :, 1:2] * vf[:, None, :, 1]
        + pl[:, :, 2:3] * vf[:, None, :, 2]
        + pl[:, :, 3:4]
    )                                                          # (C, Kt, V)
    smax = torch.amax(torch.where(vm[:, None], d, -BIG), dim=2)
    alive = torch.any(vm, dim=1)
    act = cell_pmask & (smax > -tol_a) & alive[:, None]
    idx = _stable_front(act, KA)
    sel = torch.gather(pl, 1, idx[..., None].expand(-1, -1, 4))
    selm = torch.gather(act, 1, idx)
    kill = torch.zeros((KA, 4), dtype=dt, device=dev)
    kill[0, 3] = 1e8
    killm = torch.zeros((KA,), dtype=torch.bool, device=dev)
    killm[0] = True
    sel = torch.where(alive[:, None, None], sel, kill)
    selm = torch.where(alive[:, None], selm, killm)
    over = torch.clamp(act.sum(1) - KA, min=0)
    return sel, selm, over.sum()


def _voxel_labels(conv, solid_t, solid_m, mas, VR: int, chunk: int = 64, solid_grid=None):
    """Occupancy of a VR³ grid over each candidate hull (inside the
    candidate's source solid (N, T, 3, 3), or the shared ``solid_grid``,
    and its convex), closed by 3·VR rounds of 6-neighbour min-label
    propagation. Returns (pts (N, G, 3), occ (N, G), lab (N, G))."""
    N = conv.n_verts.shape[0]
    dev, dt = conv.face_verts.device, conv.face_verts.dtype
    G = VR ** 3
    fv = conv.face_verts.reshape(N, -1, 3)
    fm = conv.slot_mask().reshape(N, -1)
    lo = torch.amin(torch.where(fm[..., None], fv, BIG), dim=1)
    hi = torch.amax(torch.where(fm[..., None], fv, -BIG), dim=1)
    ext = torch.clamp(hi - lo, min=1e-6)
    ax = (torch.arange(VR, dtype=dt, device=dev) + 0.5) / VR
    g = lo[:, None, :] + ax[None, :, None] * ext[:, None, :]  # (N, VR, 3)
    gx = g[:, :, None, None, 0].expand(N, VR, VR, VR)
    gy = g[:, None, :, None, 1].expand(N, VR, VR, VR)
    gz = g[:, None, None, :, 2].expand(N, VR, VR, VR)
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(N, G, 3)
    if solid_grid is not None:
        in_solid = parity_grid_inside(solid_grid, pts.reshape(-1, 3)).reshape(N, G)
    else:
        in_solid = torch.cat(
            [winding_inside(p, t, m)
             for p, t, m in zip(pts.split(chunk), solid_t.split(chunk), solid_m.split(chunk))]
        )
    in_conv = contains_point(
        conv.map(lambda a: a[:, None]), pts, tol=1e-4 * mas
    )
    occ = in_solid & in_conv
    occ3 = occ.reshape(N, VR, VR, VR)
    lab = torch.where(
        occ3, torch.arange(G, dtype=torch.int32, device=dev).reshape(VR, VR, VR), G
    ).to(torch.int32)
    pad = torch.tensor(G, dtype=torch.int32, device=dev)
    for _ in range(3 * VR):
        m = lab
        for dim in (1, 2, 3):
            up = torch.cat([pad.expand_as(lab.narrow(dim, 0, 1)), lab.narrow(dim, 0, VR - 1)], dim)
            dn = torch.cat([lab.narrow(dim, 1, VR - 1), pad.expand_as(lab.narrow(dim, 0, 1))], dim)
            m = torch.minimum(m, up)
            m = torch.minimum(m, dn)
        lab = torch.where(occ3, torch.minimum(lab, m), pad)
    return pts, occ, lab.reshape(N, G)


def _voxel_label_at(pts, occ, lab, c):
    """Label of the occupied voxel nearest to c (first of ties); -1 when the
    candidate has no occupied voxel. pts (N, G, 3), c (N, 3) → (N,)."""
    r = pts - c[:, None]
    d2 = dot3(r, r)
    d2 = torch.where(occ, d2, BIG)
    sel = (d2 <= torch.amin(d2, dim=1, keepdim=True)) & occ
    sel = sel & (torch.cumsum(sel.to(torch.int32), 1) == 1)
    val = torch.sum(torch.where(sel, lab, 0), dim=1)
    return torch.where(torch.any(occ, dim=1), val, -1)


def _split_mesh_islands(conv, mtris, mmask, solid_t, solid_m, mas, cfg: FractureConfig,
                        solid_grid=None):
    """CheckMeshIsland over a candidate batch; solid_t (N, T, 3, 3) /
    solid_m (N, T) are each candidate's source solid (prepare passes the
    one source mesh broadcast, do_fracture each job's source piece);
    ``solid_grid``, when given, answers the inside-solid queries instead.

    Surface components (vertex-coincidence labels, kernel B3) beyond the
    first are merged back into island 0 when a probe on the segment between
    their centroids, or the voxel connectivity of (solid ∩ convex), joins
    them; surviving secondary islands go to a global pool of
    ``cfg.island_pool`` entries. Returns (mmask0, x_cand, x_mmask, x_valid)."""
    ISL = max(1, cfg.max_islands)
    N0, T = mmask.shape
    dev = mtris.device
    labels = tri_soup_components_batch(mtris, mmask, iters=cfg.island_label_iters)
    Tcap = T + 1
    lab_valid = torch.where(mmask, labels, Tcap)
    picks = []
    prev = torch.full((N0,), -1, dtype=torch.int32, device=dev)
    for _ in range(ISL):
        nxt = torch.amin(torch.where(lab_valid > prev[:, None], lab_valid, Tcap), dim=1).to(torch.int32)
        picks.append(nxt)
        prev = nxt
    picks = torch.stack(picks, dim=1)                          # (N0, ISL)
    sub = lab_valid[:, None, :] == picks[:, :, None]           # (N0, ISL, T)
    overflow = lab_valid > picks[:, -1:]
    sub[:, 0, :] |= overflow
    sub &= mmask[:, None, :]

    tri_cent = torch.mean(mtris, dim=-2)                        # (N0, T, 3)
    c_all = torch.stack(
        [
            torch.sum(torch.where(sub[:, k, :, None], tri_cent, 0.0), dim=1)
            / torch.clamp(sub[:, k].sum(1), min=1).to(mtris.dtype)[:, None]
            for k in range(ISL)
        ],
        dim=1,
    )                                                          # (N0, ISL, 3)
    tol_c = 1e-4 * mas

    def merge_test(c0, ck):
        probes = torch.stack([c0 + (ck - c0) * t for t in (0.25, 0.5, 0.75)], dim=1)
        if solid_grid is not None:
            in_solid = parity_grid_inside(solid_grid, probes.reshape(-1, 3)).reshape(-1, 3)
        else:
            in_solid = winding_inside(probes, solid_t, solid_m)
        in_conv = contains_point(conv.map(lambda a: a[:, None]), probes, tol=tol_c)
        return torch.any(in_solid & in_conv, dim=1)

    VR = cfg.island_voxel_res
    vox = None
    if VR > 0 and bool(torch.any(sub[:, 1:, :])):
        vox = _voxel_labels(conv, solid_t, solid_m, mas, VR, solid_grid=solid_grid)

    merged = []
    for k in range(1, ISL):
        exists = torch.any(sub[:, k, :], dim=-1)
        inside_mid = merge_test(c_all[:, 0], c_all[:, k])
        if vox is not None:
            l0 = _voxel_label_at(*vox, c_all[:, 0])
            lk = _voxel_label_at(*vox, c_all[:, k])
            vox_conn = (l0 >= 0) & (l0 == lk)
        else:
            # No secondary island anywhere: the JAX package's all-empty
            # voxel grids give label -1, i.e. no connection.
            vox_conn = torch.zeros_like(exists)
        merged.append(exists & (inside_mid | vox_conn))
    absorbed = torch.zeros_like(sub[:, 0, :])
    for k in range(1, ISL):
        mk = merged[k - 1][:, None]
        absorbed |= sub[:, k, :] & mk
        sub[:, k, :] &= ~mk
    mmask0 = sub[:, 0, :] | absorbed

    E = cfg.island_pool
    flags = torch.any(sub[:, 1:, :], dim=-1).reshape(N0 * (ISL - 1))
    order = torch.sort((~flags).to(torch.int8), stable=True).indices
    take = order[:E]
    x_valid = flags[take]
    x_cand = (take // (ISL - 1)).to(torch.int64)
    x_mmask = sub[:, 1:, :].reshape(N0 * (ISL - 1), T)[take] & x_valid[:, None]
    return mmask0, x_cand, x_mmask, x_valid


def _finish_pieces(conv, mtris, mmask, cut_planes, cut_mask, solid_t, solid_m, mas,
                   cfg: FractureConfig, solid_grid=None, profile_stage: int = 99):
    """Occupancy test against each candidate's source solid (N, Ts, 3, 3)
    (or the shared ``solid_grid``), refit (kernel B4 planes, or above limit
    4 ``refit_planes`` with the batched B2, then the kernel B1 fold) and
    caps: exact closed-mesh caps (``cap_fans_batch``, their
    boundary points in the refit pool) with ``exact_caps``, else the refit
    convex's cut faces. Returns (conv2, mtris2, mmask2, cand_valid,
    cap_dropped), or the fence after the occupancy test (``profile_stage``
    45), the refit planes (46) or the refit fold (47)."""
    N = mmask.shape[0]
    has_tris = torch.any(mmask, dim=-1)
    _, cent = moments(conv)
    if solid_grid is not None:
        inside = parity_grid_inside(solid_grid, cent)
    else:
        inside = point_in_mesh(cent[:, None, :], solid_t, solid_m)[:, 0]
    cand_valid = ~conv.is_empty() & (has_tris | inside)
    if profile_stage == 45:
        return fence_sum(conv, mtris, mmask, cand_valid)

    if cfg.exact_caps:
        with span("caps"):
            cap_rows, cap_ok, cap_v, cap_m, cap_dropped = cap_fans_batch(
                conv, mtris, mmask, cut_planes, cut_mask, solid_t, solid_m, mas, cfg,
                solid_grid=solid_grid)
    else:
        cut_sel = match_cut_faces(conv, cut_planes, cut_mask, mas)
        cap_v = conv.face_verts.reshape(N, -1, 3)
        cap_m = (conv.slot_mask() & cut_sel[..., None]).reshape(N, -1)
    if cfg.refitting_point_limit <= 4:
        # The pool [mesh corners; cap points] is read from its parts (B4).
        slabs, slab_m = refit_planes_from_parts(mtris, mmask, cap_v, cap_m)
    else:
        # The ICH refit of every candidate, its pool concatenated in the JAX
        # package's order (surface corners first: ties in the hull's
        # argmaxes go to the lower index).
        pool = torch.cat([mtris.reshape(N, -1, 3), cap_v], dim=1)
        pool_m = torch.cat([mmask.repeat_interleave(3, dim=1), cap_m], dim=1)
        slabs, slab_m = refit_planes(pool, pool_m, cfg.refitting_point_limit)
    if profile_stage == 46:
        return fence_sum(conv, mtris, mmask, cand_valid, slabs, slab_m)
    conv2 = clip_planes_batch(conv, slabs, slab_m)
    if profile_stage == 47:
        return fence_sum(conv2, mtris, mmask, cand_valid)

    if cfg.exact_caps:
        mtris2, mmask2, app_drop = _append_tris(mtris, mmask, cap_rows[:, :, None],
                                                cap_ok.to(torch.int32))
        cap_dropped = cap_dropped + app_drop.sum()
    else:
        cut2 = match_cut_faces(conv2, cut_planes, cut_mask, mas)
        cap_rows, cap_counts = cut_face_tris(conv2, cut2)
        mtris2, mmask2, app_drop = _append_tris(mtris, mmask, cap_rows, cap_counts)
        cap_dropped = app_drop.sum()

    cand_valid = cand_valid & ~conv2.is_empty()
    nv = torch.where(cand_valid[:, None], conv2.n_verts, 0).to(torch.int32)
    conv2 = ConvexPoly(conv2.face_verts, nv, conv2.planes)
    mmask2 = mmask2 & cand_valid[:, None]
    return conv2, mtris2, mmask2, cand_valid, cap_dropped


def _pack_candidates(conv, mtris, mmask, valid, group, tag, vol, P: int) -> PieceSet:
    """Compact candidates into a PieceSet of capacity P, keeping the
    top-volume pieces on overflow (stable order among equal scores)."""
    C = valid.shape[0]
    dev = valid.device
    score = torch.where(valid, vol, -1.0)
    order = torch.sort(-score, stable=True).indices
    take = order[: min(P, C)]
    sel_valid = valid[take]
    if C < P:
        pad = P - C
        sel_valid = torch.cat([sel_valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
        take = torch.cat([take, torch.zeros((pad,), dtype=take.dtype, device=dev)])
    return PieceSet(
        convex=ConvexPoly(
            conv.face_verts[take],
            torch.where(sel_valid[:, None], conv.n_verts[take], 0).to(torch.int32),
            conv.planes[take],
        ),
        mesh=mtris[take],
        mesh_valid=mmask[take] & sel_valid[:, None],
        valid=sel_valid,
        group=torch.where(sel_valid, group[take], -1).to(torch.int32),
        tag=torch.where(sel_valid, tag[take], -1).to(torch.int32),
    )


def _pack_pool_fans(fans, fcnt, lane_valid, lane_seg, pstart, Tp: int):
    """Fans of a pool whose lanes are grouped by segment (cell or job) in
    contiguous runs starting at ``pstart`` (G+1,), packed into (G, Tp)
    triangle tables. A lane emits only into its segment's remaining budget
    of Tp (the per-segment clamp before the global pack), so no segment can
    starve another. Returns (mtris (G, Tp, 3, 3), mmask (G, Tp), dropped
    fans)."""
    G = pstart.shape[0] - 1
    NL, Sf = fans.shape[0], fans.shape[1]
    dev = fans.device
    ps = pstart.long()
    z = torch.zeros((1,), dtype=torch.int64, device=dev)
    cumf = torch.cat([z, torch.cumsum(fcnt, 0)])
    off = cumf[:-1] - cumf[ps][torch.clamp(lane_seg.long(), 0, G - 1)]
    allowed = torch.minimum(torch.clamp(Tp - off, min=0), fcnt.long())
    fan_drop = (fcnt * lane_valid).sum() - (allowed * lane_valid).sum()
    packed, _ = pack_rows(fans.reshape(NL, Sf, 9), allowed, G * Tp)
    fanbase = torch.cat([z, torch.cumsum(allowed, 0)])[ps]
    segfan = fanbase[1:] - fanbase[:-1]                        # (G,) <= Tp
    slot_t = torch.arange(Tp, device=dev)
    idx = torch.clamp(fanbase[:-1, None] + slot_t, 0, G * Tp - 1)
    mmask = slot_t < segfan[:, None]
    mtris = torch.where(mmask[..., None, None], packed[idx].reshape(G, Tp, 3, 3), 0.0)
    return mtris, mmask, fan_drop


def _culled_pair_pool_clip(tri_corners, tmask, cell_planes, cell_pmask, cull_cap: int, mas,
                           Tp: int, cfg: FractureConfig, profile_stage: int = 99, conv=None):
    """The mesh clip when a per-cell pool of ``cull_cap`` triangles is
    smaller than the source: triangles whose bounding sphere a cell plane
    separates are culled per cell (exact), the survivors of every cell are
    packed into one pool of (cell, triangle) lanes, and every lane is
    folded by its own cell's planes: kernel B10 for CUDA tensors,
    ``clip_polys_by_rows`` (per-cell context) for CPU tensors. With
    ``mesh_pair_pool=False`` each cell's uniform pool of ``cull_cap``
    triangles is clipped by its planes instead (``clip_trisoup``, plain on
    both devices), and the drops come per cell. Returns (mtris (C, Tp, 3,
    3), mmask (C, Tp), dropped triangles), or with ``profile_stage`` 42, 43
    or 44 the fence (with the cells' convex ``conv``) after the cull, the
    pair pack or the pooled fold."""
    C = cell_planes.shape[0]
    Tsrc = tri_corners.shape[0]
    dev = tri_corners.device
    cent_t = div_rn((tri_corners[:, 0] + tri_corners[:, 1]) + tri_corners[:, 2], 3.0)
    rel = tri_corners - cent_t[:, None]
    rad_t = torch.amax(sqrt_rn(dot3(rel, rel)), dim=1)
    tol_c = 1e-4 * mas
    pl = cell_planes[:, :, None, :]
    d = (
        pl[..., 0] * cent_t[:, 0] + pl[..., 1] * cent_t[:, 1]
        + pl[..., 2] * cent_t[:, 2] + pl[..., 3]
    )                                                          # (C, Kp, T)
    sep = torch.any((d > rad_t + tol_c) & cell_pmask[:, :, None], dim=1)
    keep = tmask & ~sep                                        # (C, T)
    cidx = _stable_front(keep, cull_cap)                       # kept first, index order
    csel = torch.gather(keep, 1, cidx)
    cull_over = torch.clamp(keep.sum(1) - cull_cap, min=0)
    if profile_stage == 42:
        return fence_sum(conv, cidx, csel)
    if cfg.mesh_pair_pool not in (True, "auto"):   # per-cell uniform pools
        mtris, mmask, mdrop = clip_trisoup(tri_corners[cidx], csel, cell_planes, cell_pmask,
                                           max_out=Tp)
        return mtris, mmask, mdrop + cull_over

    # Pool of the live (cell, triangle) pairs, grouped by cell.
    kept_cnt = csel.sum(1)
    pair_cap = int(min(C * cull_cap, max(4 * Tsrc, 1 << 15)))
    cell_ids = torch.arange(C, device=dev)[:, None].expand(C, cull_cap)
    pairs, pair_total = pack_rows(torch.stack([cell_ids, cidx], dim=-1), kept_cnt, pair_cap)
    pair_over = torch.clamp(kept_cnt.sum() - pair_total, min=0)
    pair_cell = torch.clamp(pairs[:, 0], 0, C - 1)
    pair_tri = torch.clamp(pairs[:, 1], 0, Tsrc - 1)
    pair_valid = torch.arange(pair_cap, device=dev) < pair_total
    z = torch.zeros((1,), dtype=torch.int64, device=dev)
    pstart = torch.clamp(torch.cat([z, torch.cumsum(kept_cnt, 0)]), max=pair_cap)
    ptris = tri_corners[pair_tri]
    if profile_stage == 43:
        return fence_sum(conv, ptris, cell_planes[pair_cell], cell_pmask[pair_cell])
    if ptris.is_cuda:
        poly, nvp, mrun_drops = soup_clip_pooled(ptris, pair_valid, pair_cell, cell_planes,
                                                 cell_pmask)
    else:
        poly, nvp, mrun_drops = clip_polys_by_rows(
            ptris, pair_valid, cell_planes[pair_cell], cell_pmask[pair_cell],
            seg_starts=pstart, seg_id=pair_cell)
    if profile_stage == 44:
        return fence_sum(conv, poly, nvp, mrun_drops)
    fans, fcnt = fan_triangles(poly, nvp)
    mtris, mmask, fan_drop = _pack_pool_fans(fans, fcnt, pair_valid, pair_cell, pstart, Tp)
    return mtris, mmask, cull_over.sum() + pair_over + fan_drop + mrun_drops


def density_sort(seeds: torch.Tensor) -> torch.Tensor:
    """Order seeds by nearest-neighbour distance (same set; the JAX package
    applies it for C > 128 so that cells of similar density share blocks)."""
    r = seeds[:, None] - seeds[None]
    d2 = dot3(r, r)
    d2.fill_diagonal_(BIG)
    dmin = torch.amin(d2, dim=1)
    return seeds[torch.sort(dmin, stable=True).indices]


def draw_seeds(cfg: FractureConfig, generator, seeds=None, partial_seeds=None,
               general_seeds=None):
    """The seeds of one decomposition: those given, and the missing ones
    drawn from ``generator`` (seeded from ``cfg.seed`` when None) in the
    order uniform, partial, general."""
    if seeds is None or partial_seeds is None or general_seeds is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if seeds is None:
            seeds = uniform_seeds(generator, cfg.initial_decompose_cell_cnt)
        if partial_seeds is None:
            partial_seeds = radial_seeds(generator, cfg.partial_pattern_cell_cnt,
                                         cfg.partial_pattern_dist)
        if general_seeds is None:
            general_seeds = radial_seeds(generator, cfg.general_pattern_cell_cnt,
                                         cfg.general_pattern_dist)
    return seeds, partial_seeds, general_seeds


@torch.no_grad()
@spanned("prepare")
def prepare_fracture(
    verts: torch.Tensor,
    vmask: torch.Tensor,
    tri_corners: torch.Tensor,
    tmask: torch.Tensor,
    sphere_cloud: torch.Tensor,
    cfg: FractureConfig,
    seeds: torch.Tensor | None = None,
    partial_seeds: torch.Tensor | None = None,
    general_seeds: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    profile_stage: int = 99,
):
    """Initial decomposition of a model into one compound.

    ``seeds`` (C, 3) are the raw uniform seeds in [-0.5, 0.5]^3 (density
    sorted here when C > 128); ``partial_seeds`` / ``general_seeds`` the
    radial pattern seeds. Missing seeds are drawn from ``generator`` (a
    ``torch.Generator``, seeded from ``cfg.seed`` when None). All work runs
    on ``verts.device``. Returns (PieceSet, FractureContext, metrics), or
    (fence, None, None) when ``profile_stage`` truncates it (module
    docstring)."""
    dev = verts.device
    F, S = cfg.max_faces, cfg.max_face_verts
    C = cfg.initial_decompose_cell_cnt
    P = cfg.max_pieces
    Tp = cfg.max_piece_tris
    Tsrc = tri_corners.shape[0]

    def solid(n):
        """Every candidate's source solid: the one source mesh, broadcast."""
        return tri_corners.expand((n,) + tri_corners.shape), tmask.expand(n, Tsrc)

    with span("hull_cells"):
        seeds, partial_seeds, general_seeds = draw_seeds(cfg, generator, seeds, partial_seeds,
                                                         general_seeds)
        seeds = seeds.to(dev)
        partial_seeds = partial_seeds.to(dev)
        general_seeds = general_seeds.to(dev)

        # 1-2. ICH face normals (kernel B2 on the GPU).
        h = ich(verts, vmask, limit=cfg.ich_include_point_limit)

        # 3. Bounding box.
        vm = vmask[:, None]
        bb_min = torch.amin(torch.where(vm, verts, BIG), dim=0)
        bb_max = torch.amax(torch.where(vm, verts, -BIG), dim=0)
        bb_center = (bb_min + bb_max) * 0.5
        extent = bb_max - bb_min
        mas = torch.amax(extent)

        # 4-6. ACH: 2×BB cube clipped by the ICH-normal k-DOP slabs.
        planes, pm = kdop_planes(verts, vmask, h["normals"], h["face_valid"],
                                 gap=mas / cfg.ach_plane_gap_inverse)
        ach = translate_poly(
            scale_poly(unit_cube(F=F, S=S, dtype=verts.dtype, device=dev), extent * 2.0),
            bb_center,
        )
        ach = clip_planes_batch(ach.map(lambda a: a[None]), planes[None], pm[None])
        if profile_stage <= 1:
            return fence_sum(ach), None, None

        # 8. Initial Voronoi decomposition as half-space lists.
        if C > 128:
            seeds = density_sort(seeds)
        kN = min(cfg.voronoi_neighbors, C - 1)
        cell_planes, cell_pmask = _cell_plane_sets(seeds, kN, extent, bb_center)
        if profile_stage <= 2:
            return fence_sum(ach, cell_planes, cell_pmask), None, None

        # 9. Impact patterns in unit space (all-pairs bisectors).
        pp = pattern_cells(partial_seeds, k=None, F=F, S=S)
        gp = pattern_cells(general_seeds, k=None, F=F, S=S)
    if profile_stage <= 3:
        return fence_sum(ach, cell_planes, pp, gp), None, None

    # 10. Initial pieces: ACH ∩ cell (two-pass fold), mesh ∩ cell.
    with span("cell_clip"):
        ctx = FractureContext(
            bb_center=bb_center, bb_min=bb_min, bb_max=bb_max, max_axis_scale=mas,
            partial_pattern=pp, general_pattern=gp, sphere_cloud=sphere_cloud,
        )
        ach_b = ach.map(lambda a: a.expand((C,) + a.shape[1:]).contiguous())
        conv = _two_pass_cell_clip(ach_b, cell_planes, cell_pmask, cfg.voronoi_prefix)
    if profile_stage <= 4:
        return fence_sum(conv, cell_planes, pp, gp), None, None

    with span("mesh_clip"):
        Kt_cell = cell_planes.shape[1]
        KA = min(Kt_cell, 32)
        act_over = torch.zeros((), dtype=torch.int64, device=dev)
        if KA < Kt_cell:
            cell_planes_a, cell_pmask_a, act_over = _active_planes(
                conv, cell_planes, cell_pmask, KA, mas)
        else:
            cell_planes_a, cell_pmask_a = cell_planes, cell_pmask

        cull_cap = min(Tsrc, max(4 * Tp, -(-6 * Tsrc // max(C, 1))))
        if cull_cap < Tsrc:
            out = _culled_pair_pool_clip(tri_corners, tmask, cell_planes_a, cell_pmask_a,
                                         cull_cap, mas, Tp, cfg, profile_stage, conv)
            if 42 <= profile_stage <= 44:
                return out, None, None
            mtris, mmask, mdrop = out
            # Per cell on the per-cell fallback: the overflow count is added
            # to every cell's, as the JAX package does there.
            mdrop = (mdrop + act_over).sum()
        else:
            mtris, mmask, mdrop = clip_trisoup(tri_corners, tmask, cell_planes_a, cell_pmask_a,
                                               max_out=Tp)
            # The overflow count is added to every cell's drop count before
            # the sum, as the JAX package does on this branch.
            mdrop = (mdrop + act_over).sum()
    if profile_stage <= 5:
        return fence_sum(conv, mtris, mmask, mdrop, pp, gp), None, None

    with span("islands"):
        # Every candidate shares the one closed source solid: above this size
        # a parity grid of it answers the island and cap queries.
        solid_grid = None
        if cfg.island_grid_res > 0 and C >= 64 and Tsrc >= 512:
            solid_grid = build_parity_grid(tri_corners, tmask, res=cfg.island_grid_res)

        cpl, cpm = cell_planes_a, cell_pmask_a
        cand_ok = torch.ones((C,), dtype=torch.bool, device=dev)
        if cfg.max_islands > 1 and cfg.island_pool > 0:
            mmask0, x_cand, x_mmask, x_valid = _split_mesh_islands(
                conv, mtris, mmask, *solid(C), mas, cfg, solid_grid=solid_grid)
            conv = conv.map(lambda a: torch.cat([a, a[x_cand]]))
            mtris = torch.cat([mtris, mtris[x_cand]])
            mmask = torch.cat([mmask0, x_mmask])
            cpl = torch.cat([cell_planes, cell_planes[x_cand]])
            cpm = torch.cat([cell_pmask, cell_pmask[x_cand]])
            cand_ok = torch.cat([cand_ok, x_valid])
    if profile_stage <= 6:
        return fence_sum(conv, mtris, mmask, cand_ok, pp, gp), None, None

    with span("finish"):
        out = _finish_pieces(conv, mtris, mmask, cpl, cpm, *solid(cand_ok.shape[0]), mas, cfg,
                             solid_grid=solid_grid,
                             profile_stage=profile_stage if 45 <= profile_stage <= 49 else 99)
        if 45 <= profile_stage <= 49:   # the finish's own sub-stages
            return out, None, None
        conv, mtris, mmask, cand_valid, cap_drop = out
        mdrop = mdrop + cap_drop
        cand_valid = cand_valid & cand_ok
        N = cand_valid.shape[0]
    if profile_stage <= 7:
        return fence_sum(conv, mtris, mmask, cand_valid, pp, gp), None, None

    with span("pack"):
        vol, _ = moments(conv)
        pieces = _pack_candidates(
            conv, mtris, mmask, cand_valid,
            torch.zeros((N,), dtype=torch.int32, device=dev),
            torch.full((N,), -1, dtype=torch.int32, device=dev),
            vol, P,
        )
        metrics = {
            "ich_face_cnt": h["face_valid"].sum(),
            "piece_cnt": cand_valid.sum(),
            "total_volume": torch.sum(torch.where(cand_valid, vol, 0.0)),
            "mesh_tris_dropped": mdrop,
        }
    return pieces, ctx, metrics


def _pooled_job_mesh_clip(jmesh, jmmask, jcpl, jcpm, Tp: int, on_card: bool | None = None):
    """Clip each job's triangle pool by its own plane list as one pool of
    (job, triangle) lanes. jmesh (J, Tj, 3, 3), jmmask (J, Tj), jcpl
    (J, K, 4), jcpm (J, K). Returns (mtris (J, Tp, 3, 3), mmask (J, Tp),
    dropped), the contract of the per-job ``clip_trisoup``.

    ``on_card`` (default: the tensors lie on a GPU) takes the branch the
    JAX package runs on its accelerator: lanes whose triangle's bounding
    sphere a job plane separates are culled (exact: they clip to empty),
    and for pools of at least 8,192 lanes the survivors are packed stably
    (job-major) into 3/8 of the pool, dead lanes carrying the sentinel job
    J, which reads no planes; then kernel B10. Pool overflow drops whole
    lanes, counted. Otherwise no pack and ``clip_polys_by_rows`` with
    per-job context, the JAX package's CPU branch."""
    if on_card is None:
        on_card = jmesh.is_cuda
    J, Tj = jmmask.shape
    PC = J * Tj
    dev = jmesh.device
    pair_job = torch.arange(J, dtype=torch.int32, device=dev).repeat_interleave(Tj)
    pair_valid = jmmask.reshape(PC)
    pair_tris = jmesh.reshape(PC, 3, 3)
    over_drop = torch.zeros((), dtype=torch.int64, device=dev)
    if on_card and PC >= 8192:
        tcent = torch.mean(jmesh, dim=2)                          # (J, Tj, 3)
        rel = jmesh - tcent[:, :, None]
        trad = sqrt_rn(torch.amax(dot3(rel, rel), dim=-1))        # (J, Tj)
        dist = dot3(tcent[:, :, None, :], jcpl[:, None, :, :3]) + jcpl[:, None, :, 3]
        sep = torch.any(jcpm[:, None, :] & (dist > trad[..., None] + 1e-6), dim=-1)
        pair_valid = pair_valid & ~sep.reshape(PC)
        ppool = min(PC, max(2048, (PC * 3) // 8))
        sel = _stable_front(pair_valid, ppool)
        sel_ok = pair_valid[sel]
        over_drop = pair_valid.sum() - sel_ok.sum()
        pair_tris = pair_tris[sel]
        pair_valid = sel_ok
        pair_job = torch.where(sel_ok, pair_job[sel], J).to(torch.int32)
        pstart = torch.searchsorted(pair_job, torch.arange(J + 1, dtype=torch.int32, device=dev))
    else:
        pstart = torch.arange(J + 1, device=dev) * Tj
    if on_card:
        poly, nvp, mrun_drops = soup_clip_pooled(pair_tris, pair_valid, pair_job, jcpl, jcpm)
    else:
        poly, nvp, mrun_drops = clip_polys_by_rows(
            pair_tris, pair_valid, jcpl[pair_job.long()], jcpm[pair_job.long()],
            seg_starts=pstart, seg_id=pair_job)
    fans, fcnt = fan_triangles(poly, nvp)
    mtris, mmask, fan_drop = _pack_pool_fans(fans, fcnt, pair_valid, pair_job, pstart, Tp)
    return mtris, mmask, fan_drop + mrun_drops + over_drop


@torch.no_grad()
def do_fracture(pieces: PieceSet, ctx: FractureContext, impact_pos, target_group,
                cfg: FractureConfig, partial: bool = True, profile_stage: int = 99):
    """Refracture compounds at an impact point. Returns (PieceSet, metrics).

    ``target_group`` is a scalar group id or a (P,) boolean piece mask.
    partial=True uses the impact-local pattern and leaves out-of-sphere
    candidates attached to their parent compound; partial=False uses the
    general pattern on every target piece. Runs on the pieces' device.
    With ``profile_stage`` < 99 returns (fence, None) after that stage
    (module docstring)."""
    A = cfg.max_active_pieces
    P = cfg.max_pieces
    Tp = cfg.max_piece_tris
    mas = ctx.max_axis_scale
    dev = pieces.valid.device
    impact_pos = torch.as_tensor(impact_pos, dtype=torch.float32, device=dev)

    pattern = ctx.partial_pattern if partial else ctx.general_pattern
    C = pattern.n_verts.shape[0]
    # The pattern scaled ×(2·maxAxisScale) and translated to the impact.
    cells = translate_poly(scale_poly(pattern, 2.0 * mas), impact_pos)
    cells_fm = cells.face_mask()
    cloud = ctx.sphere_cloud * cfg.impact_radius + impact_pos

    tg = torch.as_tensor(target_group, device=dev)
    target_mask = pieces.group == tg.to(torch.int32) if tg.dim() == 0 else tg.to(torch.bool)
    in_target = pieces.valid & target_mask
    if partial:
        outside = convex_out_of_sphere(pieces.convex, cloud, impact_pos, cfg.impact_radius)
    else:
        outside = torch.zeros_like(pieces.valid)
    active = in_target & ~outside

    # Up to A active pieces, largest first (stable); overflow stays whole.
    vol0, _ = moments(pieces.convex)
    score = torch.where(active, vol0, -1.0)
    sel = torch.sort(-score, stable=True).indices[:A]
    sel_ok = active[sel]
    active_overflow = torch.clamp(active.sum() - A, min=0)
    selected = torch.zeros_like(pieces.valid)
    selected[sel] = sel_ok
    src_conv = pieces.convex.map(lambda a: a[sel])
    src_mesh = pieces.mesh[sel]
    src_mmask = pieces.mesh_valid[sel] & sel_ok[:, None]

    # A × C grid of (piece, cell) jobs. Partial mode culls jobs whose piece
    # bounding sphere a cell plane separates (exact) into a pool of JPOOL,
    # ascending job index first.
    N0 = A * C
    JPOOL = min(N0, max(256, N0 // 4)) if partial else N0
    if JPOOL < N0:
        fvs = src_conv.face_verts
        smA = src_conv.slot_mask()
        cntA = torch.clamp(smA.sum((1, 2)), min=1)
        centA = torch.sum(torch.where(smA[..., None], fvs, 0.0), dim=(1, 2)) / cntA[:, None]
        radA = sqrt_rn(torch.amax(torch.where(
            smA, dot3(fvs - centA[:, None, None], fvs - centA[:, None, None]), 0.0), dim=(1, 2)))
        distAC = (dot3(cells.planes[None, :, :, :3], centA[:, None, None, :])
                  + cells.planes[None, :, :, 3])                        # (A, C, F)
        sepAC = torch.any(cells_fm[None] & (distAC > radA[:, None, None] + 1e-5 * mas), dim=-1)
        alive0 = (sel_ok[:, None] & ~sepAC & ~cells.is_empty()[None]).reshape(N0)
        jsel = _stable_front(alive0, JPOOL)
        jsel_ok = alive0[jsel]
        precull_over = torch.clamp(alive0.sum() - JPOOL, min=0)
    else:
        jsel = torch.arange(N0, device=dev)
        jsel_ok = sel_ok.repeat_interleave(C)
        precull_over = torch.zeros((), dtype=torch.int64, device=dev)
    a_of = jsel // C
    c_of = jsel % C
    conv = clip_planes_batch(src_conv.map(lambda a: a[a_of]), cells.planes[c_of], cells_fm[c_of])
    # An empty cell gives an empty piece; culled or unselected jobs are empty.
    conv = ConvexPoly(conv.face_verts, torch.where(jsel_ok[:, None], conv.n_verts, 0),
                      conv.planes)
    if profile_stage <= 1:
        return fence_sum(conv, src_mesh, src_mmask), None

    # Job compaction: the JCAP largest live jobs (stable), overflow counted.
    alive_job = ~conv.is_empty() & jsel_ok
    JCAP = min(JPOOL, max(128, N0 // (8 if partial else 2)))
    volj, _ = moments(conv)
    jtake = torch.sort(-torch.where(alive_job, volj, -1.0), stable=True).indices[:JCAP]
    jvalid = alive_job[jtake]
    conv = conv.map(lambda a: a[jtake])
    cell_of = c_of[jtake]
    src_of = a_of[jtake]
    src_valid = jvalid
    job_overflow = torch.clamp(alive_job.sum() - JCAP, min=0) + precull_over

    # Mesh clip on the live-job pool.
    jmesh = src_mesh[src_of]
    jmmask = src_mmask[src_of] & jvalid[:, None]
    jcpl = cells.planes[cell_of]
    jcpm = cells_fm[cell_of]
    if cfg.mesh_pair_pool == "auto":
        use_pool = jmmask.numel() >= 65536
    else:
        use_pool = bool(cfg.mesh_pair_pool)
    if use_pool:
        mtris, mmask, mdrop = _pooled_job_mesh_clip(jmesh, jmmask, jcpl, jcpm, Tp)
    else:
        mtris, mmask, mdrop = clip_trisoup(jmesh, jmmask, jcpl, jcpm, max_out=Tp)
    if profile_stage <= 2:
        return fence_sum(conv, mtris, mmask, mdrop), None

    # Mesh islands against each job's source piece.
    if cfg.max_islands > 1 and cfg.island_pool > 0:
        mmask0, x_cand, x_mmask, x_valid = _split_mesh_islands(
            conv, mtris, mmask, src_mesh[src_of], src_mmask[src_of], mas, cfg)
        conv = conv.map(lambda a: torch.cat([a, a[x_cand]]))
        mtris = torch.cat([mtris, mtris[x_cand]])
        mmask = torch.cat([mmask0, x_mmask])
        cell_of = torch.cat([cell_of, cell_of[x_cand]])
        src_of = torch.cat([src_of, src_of[x_cand]])
        src_valid = torch.cat([src_valid, src_valid[x_cand] & x_valid])
    N = conv.n_verts.shape[0]
    if profile_stage <= 3:
        return fence_sum(conv, mtris, mmask, src_valid), None

    out = _finish_pieces(conv, mtris, mmask, cells.planes[cell_of], cells_fm[cell_of],
                         src_mesh[src_of], src_mmask[src_of], mas, cfg,
                         profile_stage=profile_stage)
    if 41 <= profile_stage <= 49:   # the finish's own sub-stages
        return out, None
    conv2, mtris2, mmask2, cand_valid, cap_drop = out
    mdrop = mdrop.sum() + cap_drop
    cand_valid = cand_valid & src_valid
    if profile_stage <= 4:
        return fence_sum(conv2, mtris2, mmask2, cand_valid), None

    # MergeOutOfImpact: partial-mode candidates outside the sphere rejoin
    # their parent compound; the others get a fresh group per (parent, cell).
    if partial:
        cand_out = convex_out_of_sphere(conv2, cloud, impact_pos, cfg.impact_radius)
    else:
        cand_out = torch.zeros((N,), dtype=torch.bool, device=dev)
    gmax = torch.amax(torch.where(pieces.valid, pieces.group, 0))
    parent_of = pieces.group[sel][src_of]
    cand_group = torch.where(cand_out, parent_of, gmax + 1 + parent_of * C + cell_of)

    # Merge with the surviving pieces and compact to P.
    keep_orig = pieces.valid & ~selected
    vol_new, _ = moments(conv2)
    packed = _pack_candidates(
        ConvexPoly(*(torch.cat([a, b]) for a, b in zip(
            (pieces.convex.face_verts, pieces.convex.n_verts, pieces.convex.planes),
            (conv2.face_verts, conv2.n_verts, conv2.planes)))),
        torch.cat([pieces.mesh, mtris2]),
        torch.cat([pieces.mesh_valid & keep_orig[:, None], mmask2]),
        torch.cat([keep_orig, cand_valid]),
        torch.cat([pieces.group, cand_group.to(torch.int32)]),
        torch.cat([pieces.tag, torch.full((N,), -1, dtype=torch.int32, device=dev)]),
        torch.cat([torch.where(keep_orig, vol0, -1.0), vol_new]),
        P,
    )
    piece_overflow = torch.clamp(keep_orig.sum() + cand_valid.sum() - P, min=0)
    if profile_stage <= 5:
        return fence_sum(packed.valid, packed.convex, piece_overflow), None

    # HandleConvexIsland: every compound split into contact components.
    packed, split_overflow = split_groups_by_contact(packed, eps=1e-3 * mas,
                                                     exact=cfg.exact_face_overlap)
    metrics = {
        "split_face_overflow": split_overflow,
        "active_pieces": active.sum(),
        "active_overflow": active_overflow,
        "job_overflow": job_overflow,
        "new_pieces": cand_valid.sum(),
        "piece_overflow": piece_overflow,
        "merged_out": (cand_out & cand_valid).sum(),
        "total_volume": torch.sum(torch.where(packed.valid, moments(packed.convex)[0], 0.0)),
        "mesh_tris_dropped": mdrop,
        "num_groups": packed.num_groups(),
    }
    return packed, metrics


@torch.no_grad()
def split_groups_by_contact(pieces: PieceSet, eps, exact: bool = False):
    """Split every compound (group) into face-contact-connected components.
    Returns (PieceSet, split_overflow), the overflow counting contact faces
    beyond the exact test's face pool (0 when ``exact`` is False).

    Two pieces touch when they own opposite, coplanar faces whose bounding
    spheres overlap, among each piece's KP = 32 nearest same-group pieces
    (first of ties by index); ``exact`` refines the four nearest such
    partners of every face with a 2-D separating-axis test of the two
    polygons, over a pool of the faces that have any candidate. Components
    relabel ``group``, densely renumbered."""
    P, F = pieces.P, pieces.convex.F
    S = pieces.convex.S
    dev = pieces.valid.device
    fv = pieces.convex.face_verts
    planes = pieces.convex.planes
    valid = pieces.valid
    fmask = pieces.convex.face_mask() & valid[:, None]

    # Face centroids and radii.
    sm = pieces.convex.slot_mask()
    nv = torch.clamp(pieces.convex.n_verts, min=1)[..., None]
    cent = torch.sum(torch.where(sm[..., None], fv, 0.0), dim=-2) / nv       # (P, F, 3)
    rel = fv - cent[..., None, :]
    r2 = torch.amax(torch.where(sm, dot3(rel, rel), 0.0), dim=-1)
    r_face = sqrt_rn(r2)

    pf = P * F
    n_flat = planes[..., :3].reshape(pf, 3)
    m_flat = fmask.reshape(pf)
    owner = torch.arange(P, device=dev).repeat_interleave(F)

    # Piece-level candidates: same group, both valid, bounding spheres near;
    # the KP nearest (first of ties by index).
    KP = min(32, P)
    pidx = torch.arange(P, device=dev)
    pcnt = torch.clamp(sm.sum((1, 2)), min=1)
    pcent = torch.sum(torch.where(sm[..., None], fv, 0.0), dim=(1, 2)) / pcnt[:, None]
    pr = sqrt_rn(torch.amax(torch.where(
        sm, dot3(fv - pcent[:, None, None], fv - pcent[:, None, None]), 0.0), dim=(1, 2)))
    dp = pcent[:, None] - pcent[None, :]
    pd2 = dot3(dp, dp)
    cand_ok = (
        (pieces.group[:, None] == pieces.group[None, :])
        & valid[:, None] & valid[None, :]
        & (pidx[:, None] != pidx[None, :])
        & (pd2 <= (2.0 * (pr[:, None] + pr[None, :]) + eps) ** 2)
    )
    part = torch.sort(torch.where(cand_ok, -pd2, -BIG), dim=1, descending=True,
                      stable=True).indices[:, :KP]                       # (P, KP)
    part_ok = torch.gather(cand_ok, 1, part)

    # Nearest opposite-coplanar-near face of each candidate piece, per own
    # face: (P, F, KP, F) min-reduced over the partner's faces.
    planes_k = planes[part]                                              # (P, KP, F, 4)
    cent_k = cent[part]
    rj_k = r_face[part]
    fmask_k = fmask[part]
    ndot = dot3(planes[:, :, None, None, :3], planes_k[:, None, :, :, :3])  # (P, F, KP, F)
    opp = torch.abs(ndot + 1.0) < 1e-4
    cop = torch.abs(planes[:, :, None, None, 3] + planes_k[:, None, :, :, 3]) < eps
    cd2 = (
        (cent[:, :, None, None, 0] - cent_k[:, None, :, :, 0]) ** 2
        + (cent[:, :, None, None, 1] - cent_k[:, None, :, :, 1]) ** 2
        + (cent[:, :, None, None, 2] - cent_k[:, None, :, :, 2]) ** 2
    )
    near_g = cd2 <= (r_face[:, :, None, None] + rj_k[:, None] + eps) ** 2
    score_g = torch.where(opp & cop & near_g & fmask_k[:, None], cd2, BIG)
    bdist = torch.amin(score_g, dim=-1).reshape(pf, KP)
    bface = torch.argmin(score_g, dim=-1).reshape(pf, KP)             # first of ties
    pair_ok = (bdist < BIG / 2) & m_flat[:, None] & part_ok.repeat_interleave(F, dim=0)
    part_flat = part.repeat_interleave(F, dim=0)                       # (pf, KP)

    adj = torch.zeros(((P + 1) * (P + 1),), dtype=torch.bool, device=dev)
    trash = (P + 1) * (P + 1) - 1
    if exact:
        K4 = min(4, KP)
        has_cand = torch.any(pair_ok, dim=1)
        FPOOL = min(pf, max(1024, pf // 4))
        fsel = _stable_front(has_cand, FPOOL)
        fok = has_cand[fsel]
        split_overflow = has_cand.sum() - fok.sum()
        pair_ok_p = pair_ok[fsel] & fok[:, None]                         # (FPOOL, KP)
        candk = torch.sort(torch.where(pair_ok_p, -bdist[fsel], -BIG), dim=1, descending=True,
                           stable=True).indices[:, :K4]
        cmask = torch.gather(pair_ok_p, 1, candk)
        candp = torch.gather(part_flat[fsel], 1, candk)
        cand = candp * F + torch.gather(bface[fsel], 1, candk)
        fv_flat = fv.reshape(pf, S, 3)
        nv_flat = pieces.convex.n_verts.reshape(pf)
        slot = torch.arange(S, device=dev)

        # Exact 2-D overlap of each pooled face with its K4 candidates, in
        # the face plane's basis (edge normals of both polygons as axes;
        # the edge of the last live slot runs to the next padded slot).
        u, v = plane_basis(n_flat[fsel])                                 # (FPOOL, 3)
        ai = fv_flat[fsel]
        mi = slot < nv_flat[fsel][:, None]                               # (FPOOL, S)
        a2 = torch.stack([dot3(ai, u[:, None]), dot3(ai, v[:, None])], -1)   # (FPOOL, S, 2)
        bj = fv_flat[cand]                                               # (FPOOL, K4, S, 3)
        mj = slot < nv_flat[cand][..., None]
        b2 = torch.stack([dot3(bj, u[:, None, None]), dot3(bj, v[:, None, None])], -1)

        def axes_of(p2):
            e = torch.roll(p2, -1, dims=-2) - p2
            return torch.stack([-e[..., 1], e[..., 0]], -1)

        axes = torch.cat([axes_of(a2)[:, None].expand(-1, K4, S, 2), axes_of(b2)], dim=2)
        am = torch.cat([mi[:, None].expand(-1, K4, S), mj], dim=2)       # (FPOOL, K4, 2S)
        pa = torch.sum(a2[:, None, None] * axes[:, :, :, None, :], -1)  # (FPOOL, K4, 2S, S)
        pb = torch.sum(b2[:, :, None] * axes[:, :, :, None, :], -1)
        a_lo = torch.amin(torch.where(mi[:, None, None], pa, BIG), -1)
        a_hi = torch.amax(torch.where(mi[:, None, None], pa, -BIG), -1)
        b_lo = torch.amin(torch.where(mj[:, :, None], pb, BIG), -1)
        b_hi = torch.amax(torch.where(mj[:, :, None], pb, -BIG), -1)
        sep = am & ((a_hi < b_lo - eps) | (b_hi < a_lo - eps))
        exact_ok = ~torch.any(sep, dim=-1) & cmask & fok[:, None]
        rows = owner[fsel][:, None].expand(-1, K4)
        adj[torch.where(exact_ok, rows * (P + 1) + candp, trash).reshape(-1)] = True
    else:
        ok_piece = torch.any(pair_ok.reshape(P, F, KP), dim=1)          # (P, KP)
        adj[torch.where(ok_piece, pidx[:, None] * (P + 1) + part, trash).reshape(-1)] = True
        split_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    adj = adj.reshape(P + 1, P + 1)[:P, :P]

    comp = adjacency_components(adj, valid)        # min reachable index per piece
    # Dense-renumber the incoming ids first, then pair them with the
    # component (bounded by P², no int32 overflow), and renumber again.
    g = _dense_renumber(torch.where(valid, pieces.group, -1), valid).long()
    new_group = torch.where(valid, g * P + torch.where(comp < P, comp, 0).long(), -1)
    new_group = _dense_renumber(new_group, valid)
    return PieceSet(convex=pieces.convex, mesh=pieces.mesh, mesh_valid=pieces.mesh_valid,
                    valid=valid, group=new_group, tag=pieces.tag), split_overflow


def _dense_renumber(group: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Relabel group ids to a dense 0..G-1 range, order-preserving; -1 for
    invalid slots."""
    P = group.shape[0]
    key = torch.where(valid, group.long(), torch.iinfo(torch.int32).max)
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.ones_like(valid)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    rank = torch.empty((P,), dtype=torch.int64, device=group.device)
    rank[order] = torch.cumsum(first.long(), 0) - 1
    return torch.where(valid, rank, -1).to(torch.int32)
