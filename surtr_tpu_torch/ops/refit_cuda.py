"""Batched refit planes with device dispatch (kernel B4, ``csrc/refit.cu``).

``refit_planes_batch`` (a built pool) and ``refit_planes_from_parts`` (the
pool read from its parts: a mesh's triangles and the cap vertices, as
``_finish_pieces`` holds them; a built pool is the caps alone) run the
plain version (tetra hull + zero-gap k-DOP slabs, the ``limit <= 4`` refit
of the JAX package's ``refit_planes``) for CPU tensors and launch the hand-written kernel, or
raise, for CUDA tensors. Replaces ``refit_planes_batch_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.hull import tetra_hull
from surtr_tpu_torch.ops.kdop import kdop_planes
from surtr_tpu_torch.ops.linalg import supports
from surtr_tpu_torch.profiling import spanned

launches = 0  # kernel launches since the last reset (main-path proof)


def refit_planes_batch_reference(pool: torch.Tensor, pool_mask: torch.Tensor):
    """pool (N, Pv, 3), pool_mask (N, Pv) → ((N, 8, 4) [4 max; 4 min]
    slab planes, (N, 8) mask).

    A min plane's offset that is zero is -0 when any live support is -0
    (IEEE minimum on zeros): ``torch.amin`` leaves the sign of a ±0 tie to
    its reduction order, which differs between devices. The max planes'
    offsets are -(max + 0), whose sign no tie changes."""
    h = tetra_hull(pool, pool_mask)
    planes, pm = kdop_planes(pool, pool_mask, h["normals"], h["face_valid"], gap=0.0)
    t = supports(pool, h["normals"])                                # (N, Pv, 4)
    neg0 = (pool_mask[..., None] & (t == 0) & torch.signbit(t)).any(-2)
    off = planes[..., 4:, 3]
    zero = torch.zeros_like(off)
    off = torch.where(off == 0, torch.where(neg0, -zero, zero), off)
    planes = torch.cat([planes[..., :4, :],
                        torch.cat([planes[..., 4:, :3], off[..., None]], -1)], -2)
    enough = pool_mask.sum(-1) >= 4
    return planes, pm & enough[:, None]


def parts_pool(tris, tri_mask, caps, cap_mask):
    """The concatenated pool: point j < 3T is corner j % 3 of triangle
    j // 3, the rest are the caps."""
    N = tris.shape[0]
    pool = torch.cat([tris.reshape(N, -1, 3), caps], dim=1)
    mask = torch.cat([tri_mask.repeat_interleave(3, dim=1), cap_mask], dim=1)
    return pool, mask


def refit_planes_from_parts_reference(tris, tri_mask, caps, cap_mask):
    """Plain refit of the pool built from its parts (``parts_pool``)."""
    return refit_planes_batch_reference(*parts_pool(tris, tri_mask, caps, cap_mask))


def _bytes(mask, shape, what):
    if mask.dtype != torch.bool or mask.shape != shape:
        raise ValueError(f"refit kernel takes a {tuple(shape)} bool {what}")
    return mask.contiguous().view(torch.uint8)   # the bool bytes, no conversion launch


@spanned("kernel.refit", inner=True)
def _parts_kernel(tris, tri_mask, caps, cap_mask):
    global launches
    N, T, C = tris.shape[0], tris.shape[1], caps.shape[1]
    if (tris.dtype != torch.float32 or caps.dtype != torch.float32
            or tris.shape[2:] != (3, 3) or caps.shape != (N, C, 3)):
        raise ValueError("refit kernel takes (N, T, 3, 3) float32 triangles and (N, C, 3) "
                         "float32 cap vertices")
    if 3 * T + C < 1:
        raise ValueError("refit kernel needs at least one pool point")
    t, c = tris.contiguous(), caps.contiguous()
    tm = _bytes(tri_mask, (N, T), "triangle mask")
    cm = _bytes(cap_mask, (N, C), "cap mask")
    dev, Pv = tris.device, 3 * T + C
    planes = torch.empty((N, 8, 4), dtype=torch.float32, device=dev)
    pmask = torch.empty((N, 8), dtype=torch.bool, device=dev)
    if N == 0:
        return planes, pmask
    scratch = None   # the compacted points beyond what shared memory holds
    if Pv > _build.bind("surtr_refit_smem_points", [])():
        scratch = torch.empty((N, Pv, 4), dtype=torch.float32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.bind("surtr_refit_parts", [P, P, I, P, P, I, P, P, I, P, P])
    rc = fn(t.data_ptr(), tm.data_ptr(), T, c.data_ptr(), cm.data_ptr(), C, planes.data_ptr(),
            pmask.view(torch.uint8).data_ptr(), N,
            None if scratch is None else scratch.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, "surtr_refit_parts")
    launches += 1
    return planes, pmask


def refit_planes_batch(pool: torch.Tensor, pool_mask: torch.Tensor):
    """Tetra-hull + k-DOP refit slabs for a batch of vertex pools."""
    if pool.is_cuda:   # the kernel on the pool as its caps, with no triangles
        N = pool.shape[0]
        return _parts_kernel(pool.new_empty((N, 0, 3, 3)), pool_mask.new_empty((N, 0)), pool,
                             pool_mask)
    if pool.device.type != "cpu":
        raise ValueError(f"refit_planes_batch: unsupported device {pool.device}")
    return refit_planes_batch_reference(pool, pool_mask)


def refit_planes_from_parts(tris: torch.Tensor, tri_mask: torch.Tensor, caps: torch.Tensor,
                            cap_mask: torch.Tensor):
    """``refit_planes_batch`` of the pool [the triangles' corners; the caps]
    with no pool built: tris (N, T, 3, 3) with tri_mask (N, T), caps
    (N, C, 3) with cap_mask (N, C)."""
    if tris.is_cuda:
        return _parts_kernel(tris, tri_mask, caps, cap_mask)
    if tris.device.type != "cpu":
        raise ValueError(f"refit_planes_from_parts: unsupported device {tris.device}")
    return refit_planes_from_parts_reference(tris, tri_mask, caps, cap_mask)
