"""Limited incremental hull with device dispatch (kernel B2, ``csrc/ich.cu``).

``ich`` runs the plain ``ich_reference`` (``ops/hull.py``) for CPU tensors
and launches the hand-written kernel, or raises, for CUDA tensors.
Replaces the JAX package's ``ich_pallas``. Returns normals, face_valid and
inner (the contract of ``ich_pallas``) plus the face index table.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.hull import ich as ich_reference

launches = 0  # kernel launches since the last reset (main-path proof)


def _kernel(points, mask, limit, F):
    global launches
    N = points.shape[0]
    if points.dtype != torch.float32 or points.shape != (N, 3) or mask.shape != (N,):
        raise ValueError("ich kernel takes (N, 3) float32 points and an (N,) mask")
    if N < 1:
        raise ValueError("ich kernel takes at least one point")
    if F > 128:
        raise ValueError(f"ich kernel takes at most 128 faces, got {F}")
    dev = points.device
    fn = _build.bind("surtr_ich", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 5)
    pts = points.contiguous()
    m = mask.to(torch.uint8).contiguous()
    # (x, y, z, priority) per point; the kernel stages them in shared memory
    # up to 12,288 points and uses this scratch beyond.
    scratch = torch.empty((N, 4), dtype=torch.float32, device=dev)
    normals = torch.empty((F, 3), dtype=torch.float32, device=dev)
    fvalid = torch.empty((F,), dtype=torch.uint8, device=dev)
    inner = torch.empty((3,), dtype=torch.float32, device=dev)
    faces = torch.empty((F, 3), dtype=torch.int32, device=dev)
    n_insert = max(min(limit, N) - 4, 0)
    rc = fn(pts.data_ptr(), m.data_ptr(), scratch.data_ptr(), N, F, n_insert,
            normals.data_ptr(), fvalid.data_ptr(), inner.data_ptr(), faces.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(rc, "surtr_ich")
    launches += 1
    return {"faces": faces, "face_valid": fvalid.bool(), "normals": normals, "inner": inner}


def ich(points: torch.Tensor, mask: torch.Tensor, limit: int, max_faces: int | None = None):
    """Greedy limited hull of one point set (N, 3) with mask (N,)."""
    F = max_faces if max_faces is not None else 2 * max(limit, 4) + 4
    if points.is_cuda:
        return _kernel(points, mask, limit, F)
    if points.device.type != "cpu":
        raise ValueError(f"ich: unsupported device {points.device}")
    return ich_reference(points, mask, limit, max_faces)
