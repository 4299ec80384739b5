"""The initial decomposition ``prepare_fracture`` (counterpart of
``surtr_tpu/fracture/pipeline.py``; reference PrepareFracture).

ICH → k-DOP → ACH, then C Voronoi cells of the ACH folded in two passes,
the source mesh clipped per cell, mesh islands split, the cells refit
(tetra hull + k-DOP slabs) and capped, and the candidates packed into a
PieceSet. Four hand-written kernels carry it on the GPU: the clip fold
(ACH, pattern cells, both Voronoi passes, refit fold), the ICH, the island
labels and the refit planes; everything around them is plain PyTorch on
the input tensors' device.

Branches outside this slice raise ``NotImplementedError`` naming the
ROADMAP item: exact caps (A10), the culled pair-pool mesh clip with its
soup-clip kernel (A10/B10), the prepare-time parity grid (A5) and
``refitting_point_limit > 4``.
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.config import FractureConfig
from surtr_tpu_torch.fracture.pattern import pattern_cells, radial_seeds, uniform_seeds
from surtr_tpu_torch.fracture.types import FractureContext, PieceSet
from surtr_tpu_torch.ops.caps import match_cut_faces
from surtr_tpu_torch.ops.clip import contains_point
from surtr_tpu_torch.ops.clip_cuda import clip_planes_batch
from surtr_tpu_torch.ops.hull_cuda import ich
from surtr_tpu_torch.ops.kdop import kdop_planes
from surtr_tpu_torch.ops.labels_cuda import tri_soup_components_batch
from surtr_tpu_torch.ops.linalg import compact
from surtr_tpu_torch.ops.mesh_clip import clip_trisoup, point_in_mesh, winding_inside
from surtr_tpu_torch.ops.moments import moments
from surtr_tpu_torch.ops.refit_cuda import refit_planes_batch
from surtr_tpu_torch.ops.voronoi import bisector_planes, nearest_first
from surtr_tpu_torch.types import ConvexPoly, scale_poly, translate_poly, unit_cube

BIG = 3.4e38


def _stable_front(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Indices that put flagged entries first, each group in index order,
    truncated to k (the JAX package's top_k over -arange scores)."""
    return torch.sort((~flags).to(torch.int8), dim=-1, stable=True).indices[..., :k]


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
    d2 = torch.sum((seeds[:, None] - seeds[None]) ** 2, dim=-1)
    d2.fill_diagonal_(BIG)
    idx = nearest_first(-d2, k)
    bp, bm = bisector_planes(seeds, seeds[idx], torch.ones((C, k), dtype=torch.bool, device=dev))
    eye = torch.eye(3, dtype=dt, device=dev)
    dom = torch.cat([torch.cat([eye, -eye]), torch.full((6, 1), -0.5, dtype=dt, device=dev)], 1)
    planes_u = torch.cat([dom.expand(C, 6, 4), bp], dim=1)
    pmask = torch.cat([torch.ones((C, 6), dtype=torch.bool, device=dev), bm], dim=1)
    n = planes_u[..., :3] / extent
    ln = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    safe = torch.where(ln > 0, ln, torch.ones_like(ln))
    n = n / safe
    d = planes_u[..., 3:4] / safe
    d = d - torch.sum(n * center, dim=-1, keepdim=True)
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


def _voxel_labels(conv, solid_t, solid_m, mas, VR: int, chunk: int = 64):
    """Occupancy of a VR³ grid over each candidate hull (inside the source
    solid and the candidate convex), closed by 3·VR rounds of 6-neighbour
    min-label propagation. Returns (pts (N, G, 3), occ (N, G), lab (N, G))."""
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
    in_solid = torch.cat(
        [winding_inside(p.reshape(-1, 3), solid_t, solid_m).reshape(-1, G)
         for p in pts.split(chunk)]
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
    d2 = torch.sum((pts - c[:, None]) ** 2, dim=-1)
    d2 = torch.where(occ, d2, BIG)
    sel = (d2 <= torch.amin(d2, dim=1, keepdim=True)) & occ
    sel = sel & (torch.cumsum(sel.to(torch.int32), 1) == 1)
    val = torch.sum(torch.where(sel, lab, 0), dim=1)
    return torch.where(torch.any(occ, dim=1), val, -1)


def _split_mesh_islands(conv, mtris, mmask, solid_t, solid_m, mas, cfg: FractureConfig):
    """CheckMeshIsland over a candidate batch sharing one source solid.

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
        in_solid = winding_inside(probes.reshape(-1, 3), solid_t, solid_m).reshape(N0, 3)
        in_conv = contains_point(conv.map(lambda a: a[:, None]), probes, tol=tol_c)
        return torch.any(in_solid & in_conv, dim=1)

    VR = cfg.island_voxel_res
    vox = None
    if VR > 0 and bool(torch.any(sub[:, 1:, :])):
        vox = _voxel_labels(conv, solid_t, solid_m, mas, VR)

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
                   cfg: FractureConfig):
    """Occupancy test, refit (kernel B4 planes + kernel B1 fold) and caps
    from the refit convex's cut faces (``exact_caps=False``).
    Returns (conv2, mtris2, mmask2, cand_valid, cap_dropped)."""
    N = mmask.shape[0]
    has_tris = torch.any(mmask, dim=-1)
    _, cent = moments(conv)
    inside = point_in_mesh(cent, solid_t, solid_m)
    cand_valid = ~conv.is_empty() & (has_tris | inside)

    cut_sel = match_cut_faces(conv, cut_planes, cut_mask, mas)
    cap_v = conv.face_verts.reshape(N, -1, 3)
    cap_m = (conv.slot_mask() & cut_sel[..., None]).reshape(N, -1)
    pool = torch.cat([mtris.reshape(N, -1, 3), cap_v], dim=1)
    pool_m = torch.cat([mmask.repeat_interleave(3, dim=1), cap_m], dim=1)

    if cfg.refitting_point_limit > 4:
        raise NotImplementedError(
            "refitting_point_limit > 4 (ICH refit) is not ported yet (ROADMAP A10)"
        )
    slabs, slab_m = refit_planes_batch(pool, pool_m)
    conv2 = clip_planes_batch(conv, slabs, slab_m)

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


def density_sort(seeds: torch.Tensor) -> torch.Tensor:
    """Order seeds by nearest-neighbour distance (same set; the JAX package
    applies it for C > 128 so that cells of similar density share blocks)."""
    d2 = torch.sum((seeds[:, None] - seeds[None]) ** 2, -1)
    d2.fill_diagonal_(BIG)
    dmin = torch.amin(d2, dim=1)
    return seeds[torch.sort(dmin, stable=True).indices]


@torch.no_grad()
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
):
    """Initial decomposition of a model into one compound.

    ``seeds`` (C, 3) are the raw uniform seeds in [-0.5, 0.5]^3 (density
    sorted here when C > 128); ``partial_seeds`` / ``general_seeds`` the
    radial pattern seeds. Missing seeds are drawn from ``generator`` (a
    ``torch.Generator``, seeded from ``cfg.seed`` when None). All work runs
    on ``verts.device``. Returns (PieceSet, FractureContext, metrics)."""
    if cfg.exact_caps:
        raise NotImplementedError(
            "exact_caps=True (exact closed-mesh caps) is not ported yet (ROADMAP A10)"
        )
    dev = verts.device
    F, S = cfg.max_faces, cfg.max_face_verts
    C = cfg.initial_decompose_cell_cnt
    P = cfg.max_pieces
    Tp = cfg.max_piece_tris

    if seeds is None or partial_seeds is None or general_seeds is None:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if seeds is None:
            seeds = uniform_seeds(generator, C)
        if partial_seeds is None:
            partial_seeds = radial_seeds(generator, cfg.partial_pattern_cell_cnt,
                                         cfg.partial_pattern_dist)
        if general_seeds is None:
            general_seeds = radial_seeds(generator, cfg.general_pattern_cell_cnt,
                                         cfg.general_pattern_dist)
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

    # 8. Initial Voronoi decomposition as half-space lists.
    if C > 128:
        seeds = density_sort(seeds)
    kN = min(cfg.voronoi_neighbors, C - 1)
    cell_planes, cell_pmask = _cell_plane_sets(seeds, kN, extent, bb_center)

    # 9. Impact patterns in unit space (all-pairs bisectors).
    pp = pattern_cells(partial_seeds, k=None, F=F, S=S)
    gp = pattern_cells(general_seeds, k=None, F=F, S=S)
    ctx = FractureContext(
        bb_center=bb_center, bb_min=bb_min, bb_max=bb_max, max_axis_scale=mas,
        partial_pattern=pp, general_pattern=gp, sphere_cloud=sphere_cloud,
    )

    # 10. Initial pieces: ACH ∩ cell (two-pass fold), mesh ∩ cell.
    ach_b = ach.map(lambda a: a.expand((C,) + a.shape[1:]).contiguous())
    conv = _two_pass_cell_clip(ach_b, cell_planes, cell_pmask, cfg.voronoi_prefix)

    Kt_cell = cell_planes.shape[1]
    KA = min(Kt_cell, 32)
    act_over = torch.zeros((), dtype=torch.int64, device=dev)
    if KA < Kt_cell:
        cell_planes_a, cell_pmask_a, act_over = _active_planes(
            conv, cell_planes, cell_pmask, KA, mas)
    else:
        cell_planes_a, cell_pmask_a = cell_planes, cell_pmask

    Tsrc = tri_corners.shape[0]
    cull_cap = min(Tsrc, max(4 * Tp, -(-6 * Tsrc // max(C, 1))))
    if cull_cap < Tsrc:
        raise NotImplementedError(
            "culled pair-pool mesh clip (cull_cap < source triangles, soup-clip "
            "kernel B10) is not ported yet (ROADMAP A10, B10)"
        )
    mtris, mmask, mdrop = clip_trisoup(tri_corners, tmask, cell_planes_a, cell_pmask_a, max_out=Tp)
    # The overflow count is added to every cell's drop count before the sum,
    # as the JAX package does on this branch.
    mdrop = (mdrop + act_over).sum()

    if cfg.island_grid_res > 0 and C >= 64 and Tsrc >= 512:
        raise NotImplementedError(
            "prepare-time inside-solid parity grid (>= 512 source triangles) is "
            "not ported yet (ROADMAP A5)"
        )

    cpl, cpm = cell_planes_a, cell_pmask_a
    cand_ok = torch.ones((C,), dtype=torch.bool, device=dev)
    if cfg.max_islands > 1 and cfg.island_pool > 0:
        mmask0, x_cand, x_mmask, x_valid = _split_mesh_islands(
            conv, mtris, mmask, tri_corners, tmask, mas, cfg)
        conv = conv.map(lambda a: torch.cat([a, a[x_cand]]))
        mtris = torch.cat([mtris, mtris[x_cand]])
        mmask = torch.cat([mmask0, x_mmask])
        cpl = torch.cat([cell_planes, cell_planes[x_cand]])
        cpm = torch.cat([cell_pmask, cell_pmask[x_cand]])
        cand_ok = torch.cat([cand_ok, x_valid])

    conv, mtris, mmask, cand_valid, cap_drop = _finish_pieces(
        conv, mtris, mmask, cpl, cpm, tri_corners, tmask, mas, cfg)
    mdrop = mdrop + cap_drop
    cand_valid = cand_valid & cand_ok
    N = cand_valid.shape[0]

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
