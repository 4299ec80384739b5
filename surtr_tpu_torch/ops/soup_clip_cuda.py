"""Pooled triangle-soup clip with device dispatch (kernel B10,
``csrc/soup_clip.cu``). Replaces the JAX package's
``soup_clip_pooled_pallas`` (surtr_tpu/ops/soup_clip_pallas.py).

Every pooled lane is one triangle with its cell id; it becomes a polygon
of S slots folded by each of its cell's K planes with cyclic-run emission
(``mesh_clip._clip_polys_plane``). The in-plane drop rule's "this plane
removes material" context is the kernel's own: for plane k of cell c it is
true when any valid lane of cell c in the same block of ``BN`` lanes has an
original triangle corner strictly beyond the plane (and the plane is
live). ``clip_polys_by_rows`` evaluates it per cell from the current
polygons instead; the two differ only for polygons lying within tol of a
plane. A cell id outside [0, C) reads no planes (the sentinel job of the
packed pool).

``soup_clip_pooled`` runs the plain ``soup_clip_pooled_reference`` for CPU
tensors and launches the kernel, or raises, for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.linalg import dot3
from surtr_tpu_torch.ops.mesh_clip import _clip_polys_plane
from surtr_tpu_torch.profiling import spanned

launches = 0           # kernel launches since the last reset (main-path proof), every variant
general_launches = 0   # of which past S = 8 (the group and general variants)
fallback_launches = 0  # of which the "general" variant's (S > 32)

VARIANTS = ("warp", "group", "general")   # the C entry's variant codes 0, 1, 2
MAX_GROUP_S = 32                          # slots the group variant takes at most (a warp)


def group_lanes(S: int) -> int:
    """Threads a lane of the group variant: the least power of two >= S,
    at least 4."""
    return max(4, 1 << (S - 1).bit_length())


def _variant(S: int) -> str:
    """"warp" (8 threads a lane, a slot each: today's kernel) for S = 8
    slots; "group" (``group_lanes(S)`` threads a lane, a slot each) for 3 <=
    S <= 32; else "general" (a thread a lane, the polygon in device
    memory): every S the plain version takes (S >= 3) has a variant."""
    if S == 8:
        return "warp"
    return "group" if 3 <= S <= MAX_GROUP_S else "general"


def block_lanes(P: int) -> int:
    """The lane block ``BN`` over which the in-plane context is reduced:
    2048 for pools of at least 2048 lanes, else P rounded up to a multiple
    of 128 (soup_clip_pallas.py:249)."""
    return 2048 if P >= 2048 else max(128, ((P + 127) // 128) * 128)


def _lane_planes(cell_id, cell_planes, cell_pmask):
    """Per lane its cell's planes and mask; zero planes, all masked, for
    ids outside [0, C)."""
    C = cell_planes.shape[0]
    inside = (cell_id >= 0) & (cell_id < C)
    cid = torch.clamp(cell_id.long(), 0, max(C - 1, 0))
    pl = torch.where(inside[:, None, None], cell_planes[cid], 0.0)
    ok = cell_pmask[cid] & inside[:, None]
    return pl, ok, inside, cid


def soup_clip_pooled_reference(tri_corners, valid, cell_id, cell_planes, cell_pmask,
                               poly_slots: int = 8, tol: float = 1e-6, per_lane: bool = False):
    """Plain PyTorch B10: (poly (P, S, 3), n_vert (P,), multirun drops).
    ``per_lane`` adds ((P,) drops, (P,) fold steps): each lane's multirun
    drops, which sum to the total (the kernel's counter adds them up), and
    the live planes it is folded through while its polygon is not empty
    (the work the kernel does for it)."""
    P = tri_corners.shape[0]
    C, K = cell_pmask.shape
    S = poly_slots
    dev = tri_corners.device
    pl, ok, inside, cid = _lane_planes(cell_id, cell_planes, cell_pmask)
    # In-plane context per (lane block, cell, plane) from the original
    # corners: ((x·nx + y·ny) + z·nz) + d of each corner, any beyond tol.
    d3 = dot3(tri_corners[:, None, :, :], pl[:, :, None, :3]) + pl[:, :, None, 3]
    beyond = torch.amax(d3, dim=-1) > tol                      # (P, K)
    rm_lane = beyond & valid[:, None] & ok
    BN = block_lanes(P)
    blk = torch.arange(P, device=dev) // BN
    key = blk * max(C, 1) + cid
    table = torch.zeros(((P + BN - 1) // BN * max(C, 1), K), dtype=torch.int32, device=dev)
    table.index_add_(0, key, rm_lane.to(torch.int32))
    rm_ctx = (table[key] > 0) & inside[:, None]

    poly = torch.zeros((P, S, 3), dtype=tri_corners.dtype, device=dev)
    poly[:, :3] = tri_corners
    n_vert = torch.where(valid, 3, 0).to(torch.int32)
    lane_drops = torch.zeros((P,), dtype=torch.int64, device=dev)
    steps = torch.zeros((P,), dtype=torch.int64, device=dev)
    for k in range(K):
        p2, n2, mrun = _clip_polys_plane(poly, n_vert, pl[:, k], tol, any_removed=rm_ctx[:, k])
        o = ok[:, k]
        steps += o & (n_vert > 0)
        poly = torch.where(o[:, None, None], p2, poly)
        n_vert = torch.where(o, n2, n_vert)
        lane_drops += mrun & o
    if per_lane:
        return poly, n_vert, lane_drops.sum(), (lane_drops, steps)
    return poly, n_vert, lane_drops.sum()


@spanned("kernel.soup_clip", inner=True)
def _kernel(tri_corners, valid, cell_id, cell_planes, cell_pmask, S, tol):
    """Three device operations, none a cast: the memset of the scratch
    (drop counter and context table), the context launch, the fold."""
    global launches, general_launches, fallback_launches
    P = tri_corners.shape[0]
    C, K = cell_pmask.shape
    dev = tri_corners.device
    if tri_corners.dtype != torch.float32 or cell_planes.dtype != torch.float32:
        raise TypeError("soup clip kernel takes float32 triangles and planes")
    if valid.dtype != torch.bool or cell_pmask.dtype != torch.bool:
        raise TypeError("soup clip kernel takes a bool valid and plane mask")
    if cell_id.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"soup clip kernel takes int32 or int64 cell ids, got {cell_id.dtype}")
    if tri_corners.shape[1:] != (3, 3) or valid.shape != (P,) or cell_id.shape != (P,):
        raise ValueError("soup clip kernel takes (P, 3, 3) triangles, (P,) valid and cell ids")
    if cell_planes.shape != (C, K, 4):
        raise ValueError("soup clip kernel takes (C, K, 4) planes")
    for t in (valid, cell_id, cell_planes, cell_pmask):
        if t.device != dev:
            raise TypeError("soup clip kernel takes tensors on one device")
    poly = torch.empty((P, S, 3), dtype=torch.float32, device=dev)
    nv = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return poly, nv, torch.zeros((), dtype=torch.int64, device=dev)
    fn = _build.bind("surtr_soup_clip", [ctypes.c_void_p] * 3 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p])
    # Bool tensors are read as bytes in place; contiguous() copies nothing
    # for the pipeline's contiguous inputs.
    tri, v, cid, pl, pm = (t.contiguous() for t in (tri_corners, valid, cell_id, cell_planes,
                                                    cell_pmask))
    BN = block_lanes(P)
    W = max(1, (K + 31) // 32)
    words = (P + BN - 1) // BN * max(C, 1) * W
    # One int64 scratch: the drop counter, then the context table's words.
    scratch = torch.empty((1 + (words + 1) // 2,), dtype=torch.int64, device=dev)
    variant = _variant(S)
    general = variant == "general"
    tmp = torch.empty((P, S, 3), dtype=torch.float32, device=dev) if general else None
    rc = fn(tri.data_ptr(), v.data_ptr(), cid.data_ptr(), int(cid.dtype == torch.int64),
            pl.data_ptr(), pm.data_ptr(), scratch.data_ptr(), poly.data_ptr(), nv.data_ptr(),
            P, C, K, BN, W, float(tol), S, VARIANTS.index(variant),
            None if tmp is None else tmp.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, "surtr_soup_clip")
    launches += 1
    general_launches += variant != "warp"
    fallback_launches += general
    return poly, nv, scratch[0]


def soup_clip_pooled(tri_corners, valid, cell_id, cell_planes, cell_pmask,
                     poly_slots: int = 8, tol: float = 1e-6):
    """Pooled per-lane K-plane fold: (poly (P, S, 3), n_vert (P,), multirun
    drops). The kernel for CUDA tensors, the plain version for CPU tensors."""
    if tri_corners.is_cuda:
        return _kernel(tri_corners, valid, cell_id, cell_planes, cell_pmask, poly_slots, tol)
    if tri_corners.device.type != "cpu":
        raise ValueError(f"soup_clip_pooled: unsupported device {tri_corners.device}")
    return soup_clip_pooled_reference(tri_corners, valid, cell_id, cell_planes, cell_pmask,
                                      poly_slots, tol)
