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
from surtr_tpu_torch.profiling import spanned

launches = 0          # kernel launches since the last reset (main-path proof), every variant
general_launches = 0  # of which the vertex variant's (past MAX_BLOCK_T), either placement

# Triangles the block variant takes a soup (a thread each): the measured
# crossover (tools/time_b3_b4.py --limits). The block kernel's adjacency
# rounds grow with a soup's live triangles, the vertex variant's do not: on
# the calls as made, and their soups padded, "block" is no slower up to T =
# 96 (the cube event's (1,024, 64) soups), and slower from T = 128 (the
# torus config-1 event's and the cube32 impact's calls) up.
MAX_BLOCK_T = 96
MAX_SMEM = 232448           # bytes of shared memory a Hopper block can use
SCRATCH_BYTES = 256 << 20   # the scratch placement's soup states at most (one soup at least)
GENERAL_BLOCKS = 264        # CTAs of the scratch placement at most (two an SM of an H100)


def _variant(T: int) -> str:
    """"block" (one CTA a soup, a thread a triangle, the T x T adjacency
    in shared memory) for 1 <= T <= ``MAX_BLOCK_T``; past it "vertex" (one CTA a
    soup, vertex ids by a hash of the quantized corners and a minimum
    label a vertex, the state in shared memory) while ``vertex_bytes(T)``
    fits a CTA, else "vertex_scratch" (the same kernel, its state in a
    device scratch): every T the plain version takes has a variant."""
    if T <= MAX_BLOCK_T:
        return "block"
    return "vertex" if vertex_bytes(T) <= MAX_SMEM else "vertex_scratch"


def hash_slots(T: int) -> int:
    """Slots of the vertex variant's hash table: a power of two >= 4T."""
    return 1 << max(0, (4 * T - 1).bit_length())


def vertex_bytes(T: int) -> int:
    """Bytes of one soup's state in the vertex variant (quantized corners,
    vertex ids, vertex minima, two label buffers, the hash table), as
    ``vertex_words`` in csrc/labels.cu lays them out."""
    return 4 * (17 * T + hash_slots(T))


def tri_soup_components_batch_reference(corners, tri_valid, tol: float = 1e-5,
                                        iters: int | None = None):
    """Plain labels: corners (N, T, 3, 3), tri_valid (N, T) → (N, T) i32."""
    return tri_soup_components(corners, tri_valid, iters=iters, tol=tol)


@spanned("kernel.labels", inner=True)
def _kernel(corners, tri_valid, tol, iters):
    global launches, general_launches
    N, T = corners.shape[0], corners.shape[1]
    if (corners.dtype != torch.float32 or corners.shape[2:] != (3, 3)
            or tri_valid.shape != (N, T) or tri_valid.dtype != torch.bool):
        raise ValueError("labels kernel takes (N, T, 3, 3) float32 corners and an (N, T) bool mask")
    dev = corners.device
    # Each soup's (T, 3, 3) floats must be contiguous; the soups may lie at
    # any stride (the pipeline's are rows of a wider table): no copy then.
    c = corners if corners.stride()[1:] == (9, 3, 1) else corners.contiguous()
    v = tri_valid.contiguous().view(torch.uint8)   # the bool bytes, no conversion launch
    out = torch.empty((N, T), dtype=torch.int32, device=dev)
    if N == 0 or T == 0:
        return out
    variant = _variant(T)
    P, I = ctypes.c_void_p, ctypes.c_int
    args = (c.data_ptr(), c.stride()[0], v.data_ptr(), out.data_ptr(), N, T,
            label_rounds(T, iters), float(tol))
    if variant == "block":
        fn = _build.bind("surtr_labels", [P, ctypes.c_longlong, P, P, I, I, I, ctypes.c_float, P])
        _build.check(fn(*args, _build.stream_ptr(dev)), "surtr_labels")
    else:
        fn = _build.bind("surtr_labels_vertex", [P, ctypes.c_longlong, P, P, I, I, I,
                                                 ctypes.c_float, P, I, P])
        scratch, blocks = None, 0
        if variant == "vertex_scratch":
            blocks = max(1, min(N, GENERAL_BLOCKS, SCRATCH_BYTES // vertex_bytes(T)))
            scratch = torch.empty((blocks * vertex_bytes(T) // 4,), dtype=torch.int32, device=dev)
        _build.check(fn(*args, None if scratch is None else scratch.data_ptr(), blocks,
                        _build.stream_ptr(dev)), "surtr_labels_vertex")
        general_launches += 1
    launches += 1
    return out


def tri_soup_components_batch(corners, tri_valid, tol: float = 1e-5, iters: int | None = None):
    """(N, T) int32 component labels of N triangle soups."""
    if corners.is_cuda:
        return _kernel(corners, tri_valid, tol, iters)
    if corners.device.type != "cpu":
        raise ValueError(f"tri_soup_components_batch: unsupported device {corners.device}")
    return tri_soup_components_batch_reference(corners, tri_valid, tol, iters)
