"""Batched plane fold with device dispatch (kernel B1, ``csrc/clip_fold.cu``).

``clip_planes_batch`` is the public function: for CPU tensors it runs the
plain fold ``clip_planes_batch_reference``; for CUDA tensors it launches the
hand-written kernel or raises. Replaces the JAX package's
``clip_planes_batch`` / ``clip_planes_batch_pallas``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from surtr_tpu_torch import _build
from surtr_tpu_torch.ops.clip import DEFAULT_TOL, clip_poly_planes
from surtr_tpu_torch.profiling import spanned
from surtr_tpu_torch.types import ConvexPoly

MAX_SMEM = 232448  # bytes of shared memory a Hopper block can use
SCRATCH_BYTES = 256 << 20  # a scratch variant's state at most (4 slices at least)
CTA_SLOTS = 132            # CTAs of the CTA variant with its vertices in a scratch, at most

launches = 0          # kernel launches since the last reset (main-path proof), every variant
general_launches = 0  # of which the CTA variant's, either placement (one a call)
global_launches = 0   # of which the global variant's (one a batch of polytopes)


def _variant(N: int, F: int, S: int) -> str:
    """The kernel variant for an (N, F, S) polytope batch: "shared" (a
    warp's state in shared memory, up to 4 a CTA) where two polytopes'
    states fit a CTA's shared memory (where only one does, the CTA variant
    measured 1.5-2.7× faster on the same calls); past it "cta" (one CTA a
    polytope, a warp a live face and a lane a slot, its whole state in
    shared memory) where ``cta_bytes`` fits, "cta_scratch" (the same kernel
    with its vertex buffers in a device scratch) where ``cta_aux_bytes``
    fits, else "global" (the shared fold with the state in a device
    scratch). Every shape the plain fold takes has a variant."""
    if F <= 1024 and 2 * poly_bytes(F, S) <= MAX_SMEM:
        return "shared"
    if cta_bytes(F, S) <= MAX_SMEM:
        return "cta"
    return "cta_scratch" if cta_aux_bytes(F) <= MAX_SMEM else "global"


def poly_bytes(F: int, S: int) -> int:
    """Bytes of one polytope's fold state (``poly_words`` in the kernel):
    two vertex buffers, planes, cap candidates and pool, per-face counts."""
    return (6 * S + 41) * F * 4


CTA_RED = 160   # the CTA variant's vote words, chunk bitmask and flag (``RED``)


def cta_aux_bytes(F: int) -> int:
    """Bytes of the CTA variant's state without its vertex buffers
    (``cta_aux_words``): per-face counts (each array skewed to F + F / 32 +
    1 words), candidates, the dense pool."""
    return (6 * (F + F // 32 + 1) + 21 * F + CTA_RED) * 4


def cta_bytes(F: int, S: int) -> int:
    """Bytes of the CTA variant's whole state: ``cta_aux_bytes`` and the two
    face-major vertex buffers with room to align each (``cta_vert_words``)."""
    return cta_aux_bytes(F) + (6 * S * F + 8) * 4


def clip_planes_batch_reference(poly: ConvexPoly, planes: torch.Tensor,
                                plane_mask: torch.Tensor | None = None,
                                tol: float = DEFAULT_TOL) -> ConvexPoly:
    """Plain PyTorch fold: poly batch (N, F, S), planes (N, K, 4)."""
    return clip_poly_planes(poly, planes, plane_mask, tol)


@functools.lru_cache(maxsize=None)
def _fold_fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.bind("surtr_clip_fold", [P] * 5 + [I] * 2 + [P] * 3 + [I] * 4
                       + [ctypes.c_float, P])


@functools.lru_cache(maxsize=None)
def _cta_fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.bind("surtr_clip_fold_cta", [P] * 5 + [I] * 2 + [P] * 3 + [I] * 4
                       + [ctypes.c_float, P, I, P])


@functools.lru_cache(maxsize=None)
def _global_fn():
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.bind("surtr_clip_fold_global", [P] * 5 + [I] * 2 + [P] * 3 + [I] * 4
                       + [ctypes.c_float, P, I, P, P])


@spanned("kernel.clip_fold", inner=True)
def _kernel(poly, planes, plane_mask, tol):
    global launches, general_launches, global_launches
    N, F, S = poly.face_verts.shape[:3]
    K = planes.shape[1]
    dev = poly.face_verts.device
    variant = _variant(N, F, S)
    fv = poly.face_verts.contiguous()
    nv = poly.n_verts.to(torch.int32).contiguous()
    pl = poly.planes.contiguous()
    # Plane lists and masks are read in place at any row stride (the
    # two-pass Voronoi fold hands in column slices).
    cuts = planes if planes.stride()[1:] == (4, 1) else planes.contiguous()
    cm = plane_mask.to(torch.bool)
    cm = cm if cm.stride(1) == 1 else cm.contiguous()
    for t, dt in ((fv, torch.float32), (pl, torch.float32), (cuts, torch.float32)):
        if t.dtype != dt or t.device != dev:
            raise TypeError("clip fold kernel takes float32 tensors on one device")
    if planes.shape != (N, K, 4) or plane_mask.shape != (N, K) or pl.shape != (N, F, 4):
        raise ValueError("clip fold kernel: inconsistent shapes")
    if cm.device != dev:
        raise TypeError("clip fold kernel takes the plane mask on the polytopes' device")
    ofv = torch.empty_like(fv)
    onv = torch.empty_like(nv)
    opl = torch.empty_like(pl)
    if N == 0:
        return ConvexPoly(ofv, onv, opl)
    args = (fv.data_ptr(), nv.data_ptr(), pl.data_ptr(), cuts.data_ptr(), cm.data_ptr(),
            cuts.stride(0), cm.stride(0), ofv.data_ptr(), onv.data_ptr(), opl.data_ptr(),
            N, F, S, K, float(tol))
    stream = _build.stream_ptr(dev)
    if variant == "shared":
        _build.check(_fold_fn()(*args, stream), "surtr_clip_fold")
        launches += 1
    elif variant in ("cta", "cta_scratch"):
        scratch, slots = None, 0
        if variant == "cta_scratch":   # the vertex buffers of `slots` polytopes at a time
            per = cta_bytes(F, S) - cta_aux_bytes(F)
            slots = max(1, min(N, CTA_SLOTS, SCRATCH_BYTES // per))
            scratch = torch.empty((slots * per // 4,), dtype=torch.float32, device=dev)
        _build.check(_cta_fn()(*args, None if scratch is None else scratch.data_ptr(), slots,
                               stream), "surtr_clip_fold_cta")
        launches += 1
        general_launches += 1
    else:
        per = poly_bytes(F, S)   # a batch of `slots` polytopes a launch, 4 to a CTA
        slots = max(4, min(-(-N // 4), SCRATCH_BYTES // per // 4) * 4)
        scratch = torch.empty((slots * per // 4,), dtype=torch.float32, device=dev)
        n = ctypes.c_int(0)
        _build.check(_global_fn()(*args, scratch.data_ptr(), slots, ctypes.byref(n), stream),
                     "surtr_clip_fold_global")
        launches += n.value
        global_launches += n.value
    return ConvexPoly(ofv, onv, opl)


def clip_planes_batch(poly: ConvexPoly, planes: torch.Tensor,
                      plane_mask: torch.Tensor | None = None,
                      tol: float = DEFAULT_TOL) -> ConvexPoly:
    """Batched K-plane fold; the kernel for CUDA tensors, the plain fold for
    CPU tensors."""
    N, K = planes.shape[0], planes.shape[1]
    if plane_mask is None:
        plane_mask = torch.ones((N, K), dtype=torch.bool, device=planes.device)
    if poly.face_verts.is_cuda:
        return _kernel(poly, planes, plane_mask, tol)
    if poly.face_verts.device.type != "cpu":
        raise ValueError(f"clip_planes_batch: unsupported device {poly.device}")
    return clip_planes_batch_reference(poly, planes, plane_mask, tol)
