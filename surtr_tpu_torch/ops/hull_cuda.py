"""Limited incremental hull with device dispatch (kernel B2, ``csrc/ich.cu``).

``ich`` (one point set: the model hull) and ``ich_batch`` (B sets at once:
the refit hull of every fracture candidate at ``refitting_point_limit`` >
4) run their plain versions ``ich_reference`` and ``ich_batch_reference``
(``ops/hull.py``) for CPU tensors and launch the hand-written kernel, or
raise, for CUDA tensors: one variant of it, which ``_variant`` picks from
the shapes alone. Replaces the JAX package's ``ich_pallas`` (and its
vmapped XLA ``ich`` in the refit). Returns normals, face_valid and inner
(the contract of ``ich_pallas``) plus the face index table.
"""

from __future__ import annotations

import ctypes

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.hull import ich as ich_reference
from surtr_tpu_torch.ops.hull import ich_batch as ich_batch_reference
from surtr_tpu_torch.profiling import spanned

launches = 0           # B2 launches since the last reset, both entries and variants (main-path proof)
batch_launches = 0     # of which batched (``ich_batch``) launches
general_launches = 0   # of which the general variant's
warp_set_launches = 0  # of which the warp-a-set variant's

MAX_FACES = 128            # face slots of the block and warp-a-set variants (MAXF in the kernel)
STAGE_POINTS = 12288       # points the block variant stages in shared memory a set
WARP_SET_BYTES = 48 * 1024  # a warp-a-set set's points and face table, at most
GENERAL_SMEM = 200 * 1024   # the general variant's dynamic shared memory, at most


def table_words(F: int) -> int:
    """32-bit words of one set's face table (``table_words`` in the kernel):
    21 words a slot over F rounded up to 32 slots, and three bit words a 32
    slots rounded up to 4."""
    nw = -(-F // 32)
    return 21 * 32 * nw + (3 * nw + 3) // 4 * 4


def set_bytes(N: int, F: int) -> int:
    """Shared-memory bytes of one set of the warp-a-set variant: up to N
    staged points (x, y, z, priority), their slots (N words rounded up to
    4) and its face table (``set_bytes`` in the kernel)."""
    return 16 * N + 4 * (-(-N // 4) * 4) + 4 * table_words(F)


def general_stage(N: int, F: int) -> int:
    """What the general variant keeps in shared memory (``general_stage``
    in the kernel): bit 0 the points, bit 1 the face table; both while they
    fit in ``GENERAL_SMEM`` bytes, else the table alone while it fits."""
    tb = 4 * table_words(F)
    if tb + 16 * N <= GENERAL_SMEM:
        return 3
    return 2 if tb <= GENERAL_SMEM else 0


def _variant(B: int, N: int, F: int) -> str:
    """Which kernel a call of B sets of N points with F face slots takes:
    "general" past 128 face slots (a block a set, warp 0 doing the face work
    over F / 32 words); else "warp_set" for B > 1 sets that fit a warp's
    ``WARP_SET_BYTES`` (a warp a set: the refit pools); else "block" (the
    one-set kernel, a block a set: the model hull, and batches of sets too
    large for a warp). Every shape the plain version takes has a variant."""
    if F > MAX_FACES:
        return "general"
    if B > 1 and set_bytes(N, F) <= WARP_SET_BYTES:
        return "warp_set"
    return "block"


VARIANT_CODE = {"block": 0, "warp_set": 1, "general": 2}
# Each variant's kernel, as a device trace names it.
KERNEL_NAME = {"block": "ich_kernel", "warp_set": "ich_warp_set_kernel",
               "general": "ich_general_kernel"}


@spanned("kernel.ich", inner=True)
def _kernel(points, mask, limit, F, batched):
    global launches, batch_launches, general_launches, warp_set_launches
    B, N = points.shape[:2]
    if points.dtype != torch.float32 or points.shape != (B, N, 3) or mask.shape != (B, N):
        raise ValueError("ich kernel takes (B, N, 3) float32 points and a (B, N) mask")
    if mask.dtype != torch.bool:
        raise ValueError("ich kernel takes a bool mask")
    if N < 1:
        raise ValueError("ich kernel takes sets of at least one point")
    variant = _variant(B, N, F)
    dev = points.device
    normals = torch.empty((B, F, 3), dtype=torch.float32, device=dev)
    fvalid = torch.empty((B, F), dtype=torch.bool, device=dev)
    inner = torch.empty((B, 3), dtype=torch.float32, device=dev)
    faces = torch.empty((B, F, 3), dtype=torch.int32, device=dev)
    out = {"faces": faces, "face_valid": fvalid, "normals": normals, "inner": inner}
    if B == 0:
        return out
    pts = points.contiguous()
    m = mask.contiguous()   # a bool is one byte, 0 or 1: the kernel reads it as is
    # (x, y, z, priority) per point and the face tables (table_words a set)
    # in device scratches where the variant does not stage them in shared
    # memory: the block variant's points above 12,288 a set, the general
    # variant's as general_stage says.
    if variant == "general":
        stage = general_stage(N, F)
        stage_pts, stage_tab = stage & 1, stage & 2
    else:
        stage_pts, stage_tab = variant == "warp_set" or N <= STAGE_POINTS, True
    scratch = None if stage_pts else torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    table = None if stage_tab else torch.empty((B, table_words(F)), dtype=torch.int32, device=dev)
    scr, tab = (None if t is None else t.data_ptr() for t in (scratch, table))
    n_insert = max(min(limit, N) - 4, 0)
    ptrs = (normals.data_ptr(), fvalid.data_ptr(), inner.data_ptr(), faces.data_ptr(),
            _build.stream_ptr(dev))
    if batched:
        fn = _build.bind("surtr_ich_batch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p] * 5)
        rc = fn(pts.data_ptr(), m.data_ptr(), scr, tab, B, N, F, n_insert,
                VARIANT_CODE[variant], *ptrs)
        _build.check(rc, "surtr_ich_batch")
        batch_launches += 1
    else:
        fn = _build.bind("surtr_ich", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p] * 5)
        rc = fn(pts.data_ptr(), m.data_ptr(), scr, tab, N, F, n_insert, *ptrs)
        _build.check(rc, "surtr_ich")
    launches += 1
    general_launches += variant == "general"
    warp_set_launches += variant == "warp_set"
    return out


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
