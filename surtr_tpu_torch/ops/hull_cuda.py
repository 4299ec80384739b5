"""Limited incremental hull with device dispatch (kernel B2, ``csrc/ich.cu``).

``ich`` (one point set: the model hull) and ``ich_batch`` (B sets at once:
the refit hull of every fracture candidate at ``refitting_point_limit`` >
4) run their plain versions ``ich_reference`` and ``ich_batch_reference``
(``ops/hull.py``) for CPU tensors and launch the hand-written kernel, or
raise, for CUDA tensors: one block for ``ich``, one block a set for
``ich_batch``. Replaces the JAX package's ``ich_pallas`` (and its vmapped
XLA ``ich`` in the refit). Returns normals, face_valid and inner (the
contract of ``ich_pallas``) plus the face index table.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.hull import ich as ich_reference
from surtr_tpu_torch.ops.hull import ich_batch as ich_batch_reference

launches = 0          # B2 launches since the last reset, both entries and variants (main-path proof)
batch_launches = 0    # of which batched (``ich_batch``) launches
general_launches = 0  # of which the general variant's

MAX_FACES = 128      # face slots of the warp variant (MAXF in the kernel)
STAGE_POINTS = 12288  # points the warp variant stages in shared memory a set


def _variant(F: int) -> str:
    """"warp" (warp 0 does the face work on 32-slot words in registers,
    the face table in shared memory: today's kernel) for F <= 128 face
    slots, else "general" (the face table in a device scratch, one thread
    doing the face work): every F the plain version takes has a variant."""
    return "warp" if F <= MAX_FACES else "general"


def _kernel(points, mask, limit, F, batched):
    global launches, batch_launches, general_launches
    B, N = points.shape[:2]
    if points.dtype != torch.float32 or points.shape != (B, N, 3) or mask.shape != (B, N):
        raise ValueError("ich kernel takes (B, N, 3) float32 points and a (B, N) mask")
    if N < 1:
        raise ValueError("ich kernel takes sets of at least one point")
    general = _variant(F) == "general"
    dev = points.device
    normals = torch.empty((B, F, 3), dtype=torch.float32, device=dev)
    fvalid = torch.empty((B, F), dtype=torch.uint8, device=dev)
    inner = torch.empty((B, 3), dtype=torch.float32, device=dev)
    faces = torch.empty((B, F, 3), dtype=torch.int32, device=dev)
    if B == 0:
        return {"faces": faces, "face_valid": fvalid.bool(), "normals": normals, "inner": inner}
    pts = points.contiguous()
    m = mask.to(torch.uint8).contiguous()
    # (x, y, z, priority) per point; the warp variant stages them in shared
    # memory up to 12,288 points a set and uses this scratch beyond; the
    # general variant keeps them here, and its face tables (50F ints a set)
    # in `table`.
    scratch = torch.empty((B, N, 4) if N > STAGE_POINTS or general else (1, 4),
                          dtype=torch.float32, device=dev)
    table = torch.empty((B, 50 * F), dtype=torch.int32, device=dev) if general else None
    n_insert = max(min(limit, N) - 4, 0)
    ptrs = (normals.data_ptr(), fvalid.data_ptr(), inner.data_ptr(), faces.data_ptr(),
            _build.stream_ptr(dev))
    tab = None if table is None else table.data_ptr()
    if batched:
        fn = _build.bind("surtr_ich_batch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p] * 5)
        rc = fn(pts.data_ptr(), m.data_ptr(), scratch.data_ptr(), tab, B, N, F, n_insert, *ptrs)
        _build.check(rc, "surtr_ich_batch")
        batch_launches += 1
    else:
        fn = _build.bind("surtr_ich", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p] * 5)
        rc = fn(pts.data_ptr(), m.data_ptr(), scratch.data_ptr(), tab, N, F, n_insert, *ptrs)
        _build.check(rc, "surtr_ich")
    launches += 1
    general_launches += general
    return {"faces": faces, "face_valid": fvalid.bool(), "normals": normals, "inner": inner}


def _faces(limit, max_faces):
    return max_faces if max_faces is not None else 2 * max(limit, 4) + 4


def _check_cpu(points, name):
    if points.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {points.device}")


def ich(points: torch.Tensor, mask: torch.Tensor, limit: int, max_faces: int | None = None):
    """Greedy limited hull of one point set (N, 3) with mask (N,)."""
    if points.is_cuda:
        out = _kernel(points[None], mask[None], limit, _faces(limit, max_faces), False)
        return {k: v[0] for k, v in out.items()}
    _check_cpu(points, "ich")
    return ich_reference(points, mask, limit, max_faces)


def ich_batch(points: torch.Tensor, mask: torch.Tensor, limit: int,
              max_faces: int | None = None):
    """Greedy limited hulls of B point sets (B, N, 3) with masks (B, N), in
    one launch; every output gains a leading (B,) axis."""
    if points.is_cuda:
        return _kernel(points, mask, limit, _faces(limit, max_faces), True)
    _check_cpu(points, "ich_batch")
    return ich_batch_reference(points, mask, limit, max_faces)
