"""Batched triangle-soup labels with device dispatch (kernel B3,
``csrc/labels.cu``).

``tri_soup_components_batch`` runs the plain ``tri_soup_components``
(``ops/labels.py``) for CPU tensors and launches the hand-written kernel, or
raises, for CUDA tensors. Replaces the JAX package's
``tri_soup_components_batch_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.labels import label_rounds, tri_soup_components

launches = 0  # kernel launches since the last reset (main-path proof)


def tri_soup_components_batch_reference(corners, tri_valid, tol: float = 1e-5,
                                        iters: int | None = None):
    """Plain labels: corners (N, T, 3, 3), tri_valid (N, T) → (N, T) i32."""
    return tri_soup_components(corners, tri_valid, iters=iters, tol=tol)


def _kernel(corners, tri_valid, tol, iters):
    global launches
    N, T = corners.shape[0], corners.shape[1]
    if (corners.dtype != torch.float32 or corners.shape[2:] != (3, 3)
            or tri_valid.shape != (N, T) or tri_valid.dtype != torch.bool):
        raise ValueError("labels kernel takes (N, T, 3, 3) float32 corners and an (N, T) bool mask")
    if not 1 <= T <= 1024:
        raise ValueError(f"labels kernel takes 1 <= T <= 1024, got {T}")
    dev = corners.device
    fn = _build.bind("surtr_labels", [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    # Each soup's (T, 3, 3) floats must be contiguous; the soups may lie at
    # any stride (the pipeline's are rows of a wider table): no copy then.
    c = corners if corners.stride()[1:] == (9, 3, 1) else corners.contiguous()
    v = tri_valid.contiguous().view(torch.uint8)   # the bool bytes, no conversion launch
    out = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    rc = fn(c.data_ptr(), c.stride()[0], v.data_ptr(), out.data_ptr(), N, T,
            label_rounds(T, iters), float(tol), _build.stream_ptr(dev))
    _build.check(rc, "surtr_labels")
    launches += 1
    return out


def tri_soup_components_batch(corners, tri_valid, tol: float = 1e-5, iters: int | None = None):
    """(N, T) int32 component labels of N triangle soups."""
    if corners.is_cuda:
        return _kernel(corners, tri_valid, tol, iters)
    if corners.device.type != "cpu":
        raise ValueError(f"tri_soup_components_batch: unsupported device {corners.device}")
    return tri_soup_components_batch_reference(corners, tri_valid, tol, iters)
