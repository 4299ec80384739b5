"""Batched refit planes with device dispatch (kernel B4, ``csrc/refit.cu``).

``refit_planes_batch`` runs ``refit_planes_batch_reference`` (tetra hull +
zero-gap k-DOP slabs, the ``limit <= 4`` refit of the JAX package's
``refit_planes``) for CPU tensors and launches the hand-written kernel, or
raises, for CUDA tensors. Replaces ``refit_planes_batch_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.hull import tetra_hull
from surtr_tpu_torch.ops.kdop import kdop_planes

launches = 0  # kernel launches since the last reset (main-path proof)


def refit_planes_batch_reference(pool: torch.Tensor, pool_mask: torch.Tensor):
    """pool (N, Pv, 3), pool_mask (N, Pv) → ((N, 8, 4) [4 max; 4 min]
    slab planes, (N, 8) mask)."""
    h = tetra_hull(pool, pool_mask)
    planes, pm = kdop_planes(pool, pool_mask, h["normals"], h["face_valid"], gap=0.0)
    enough = pool_mask.sum(-1) >= 4
    return planes, pm & enough[:, None]


def _kernel(pool, pool_mask):
    global launches
    N, Pv = pool.shape[0], pool.shape[1]
    if pool.dtype != torch.float32 or pool.shape != (N, Pv, 3) or pool_mask.shape != (N, Pv):
        raise ValueError("refit kernel takes (N, Pv, 3) float32 points and an (N, Pv) mask")
    if Pv < 1:
        raise ValueError("refit kernel needs at least one pool point")
    dev = pool.device
    fn = _build.bind("surtr_refit", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    p = pool.contiguous()
    m = pool_mask.to(torch.uint8).contiguous()
    planes = torch.empty((N, 8, 4), dtype=torch.float32, device=dev)
    pmask = torch.empty((N, 8), dtype=torch.uint8, device=dev)
    if N == 0:
        return planes, pmask.bool()
    rc = fn(p.data_ptr(), m.data_ptr(), planes.data_ptr(), pmask.data_ptr(), N, Pv,
            _build.stream_ptr(dev))
    _build.check(rc, "surtr_refit")
    launches += 1
    return planes, pmask.bool()


def refit_planes_batch(pool: torch.Tensor, pool_mask: torch.Tensor):
    """Tetra-hull + k-DOP refit slabs for a batch of vertex pools."""
    if pool.is_cuda:
        return _kernel(pool, pool_mask)
    if pool.device.type != "cpu":
        raise ValueError(f"refit_planes_batch: unsupported device {pool.device}")
    return refit_planes_batch_reference(pool, pool_mask)
