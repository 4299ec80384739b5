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

launches = 0          # kernel launches since the last reset (main-path proof), both variants
general_launches = 0  # of which the general variant's

MAX_BLOCK_T = 1024          # triangles the block variant takes a soup (a thread each)
SCRATCH_BYTES = 256 << 20   # the general variant's soup states at most (one soup at least)
GENERAL_BLOCKS = 264        # CTAs of the general variant at most (two an SM of an H100)


def _variant(T: int) -> str:
    """"block" (one CTA a soup, a thread a triangle, the adjacency in
    shared memory: today's kernel) for 1 <= T <= 1024, else "general" (a
    CTA of 1024 threads a soup, its state in a device scratch): every T
    the plain version takes has a variant."""
    return "block" if T <= MAX_BLOCK_T else "general"


def general_words(T: int) -> int:
    """Int32 words of one soup's state in the general variant (keys,
    quantized corners, two label buffers, valid words, adjacency rows), as
    ``general_words`` in csrc/labels.cu lays them out."""
    NW = (T + 31) // 32
    return (17 * T + NW + T * NW + 1) // 2 * 2


def tri_soup_components_batch_reference(corners, tri_valid, tol: float = 1e-5,
                                        iters: int | None = None):
    """Plain labels: corners (N, T, 3, 3), tri_valid (N, T) → (N, T) i32."""
    return tri_soup_components(corners, tri_valid, iters=iters, tol=tol)


def _kernel(corners, tri_valid, tol, iters):
    global launches, general_launches
    N, T = corners.shape[0], corners.shape[1]
    if (corners.dtype != torch.float32 or corners.shape[2:] != (3, 3)
            or tri_valid.shape != (N, T) or tri_valid.dtype != torch.bool):
        raise ValueError("labels kernel takes (N, T, 3, 3) float32 corners and an (N, T) bool mask")
    dev = corners.device
    fn = _build.bind("surtr_labels", [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p])
    # Each soup's (T, 3, 3) floats must be contiguous; the soups may lie at
    # any stride (the pipeline's are rows of a wider table): no copy then.
    c = corners if corners.stride()[1:] == (9, 3, 1) else corners.contiguous()
    v = tri_valid.contiguous().view(torch.uint8)   # the bool bytes, no conversion launch
    out = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0 or T == 0:
        return out
    general = _variant(T) == "general"
    scratch, blocks = None, 0
    if general:
        words = general_words(T)
        blocks = max(1, min(N, GENERAL_BLOCKS, SCRATCH_BYTES // (4 * words)))
        scratch = torch.empty((blocks * words,), dtype=torch.int32, device=dev)
    rc = fn(c.data_ptr(), c.stride()[0], v.data_ptr(), out.data_ptr(), N, T,
            label_rounds(T, iters), float(tol), None if scratch is None else scratch.data_ptr(),
            blocks, _build.stream_ptr(dev))
    _build.check(rc, "surtr_labels")
    launches += 1
    general_launches += general
    return out


def tri_soup_components_batch(corners, tri_valid, tol: float = 1e-5, iters: int | None = None):
    """(N, T) int32 component labels of N triangle soups."""
    if corners.is_cuda:
        return _kernel(corners, tri_valid, tol, iters)
    if corners.device.type != "cpu":
        raise ValueError(f"tri_soup_components_batch: unsupported device {corners.device}")
    return tri_soup_components_batch_reference(corners, tri_valid, tol, iters)
