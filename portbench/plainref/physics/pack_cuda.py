"""World transform + narrowphase packing with device dispatch (kernel B5,
``csrc/pack.cu``; replaces ``surtr_tpu/physics/pack_pallas.py``
``transform_pack_pallas``).

Per piece: world hull corners, world face planes and edge directions, the
26-DOP support intervals, packed into one row of the narrowphase table in
``pack_layout`` order, plus the margin AABB row [lo3 | hi3 | center3]
(center = BIG for dead pieces). The table is piece-major (Np, D): the
narrowphase reads a partner's whole row contiguously. The entry,
``transform_pack_owned``, takes each piece's owner and valid flag and
gathers the owner's pose itself; it runs the plain version for CPU tensors
and the kernel, or raises, for CUDA tensors. ``transform_pack_reference``
takes per-piece poses (the JAX package's signature).
"""

from __future__ import annotations

import ctypes

import torch

from plainref import _build
from plainref.ops.kdop import dop26_directions

BIG = 3.4e38

launches = 0           # kernel launches since the last reset (main-path proof), every variant
general_launches = 0   # of which past the staged kernel's 48 KB (the wide and direct variants)
fallback_launches = 0  # of which the direct variant's (rows past a block's opt-in shared memory)

STAGE_BYTES = 48 * 1024    # shared memory the staged variant takes a block at most
MAX_SMEM = 232448          # shared memory a block may opt in to (H100)
WIDE_ROOM = MAX_SMEM // 3  # the wide variant's shared memory at most: 3+ CTAs an SM
WIDE_PIECES = 8            # pieces (warps) a wide CTA at most
VARIANTS = ("staged", "direct", "wide")   # the C entry's variant codes 0, 1, 2


def stage_bytes(Vh: int, F: int, Ne: int) -> int:
    """Shared bytes a block of the staged variant takes: 128 / L pieces'
    packed and AABB rows, L = 16 lanes a piece for hulls of at most 16
    corners, faces and edges, else 32 (``pack_smem`` in csrc/pack.cu)."""
    L = 16 if Vh <= 16 and F <= 16 and Ne <= 16 else 32
    return (128 // L) * (4 * Vh + 5 * F + 26 + 4 * Ne + 9) * 4


def _ru4(n: int) -> int:
    return (n + 3) // 4 * 4


def _wide_floats(Vh: int, F: int, Ne: int, p: int, stage: bool) -> int:
    D = 4 * Vh + 5 * F + 26 + 4 * Ne
    raw = _ru4(3 * Vh * p + 3) + _ru4((p * Vh + 3) // 4) if stage else 0
    return _ru4(p * D + 3) + _ru4(9 * p + 3) + raw


def wide_stage(Vh: int, F: int, Ne: int) -> bool:
    """Whether a wide CTA stages its pieces' raw corners and masks: where
    one piece's CTA with them fits ``MAX_SMEM``, else they are read in
    place."""
    return 4 * _wide_floats(Vh, F, Ne, 1, True) <= MAX_SMEM


def wide_pieces(Vh: int, F: int, Ne: int) -> int:
    """Pieces (a warp each) a CTA of the wide variant takes: the most, up
    to ``WIDE_PIECES``, whose shared memory fits ``WIDE_ROOM``; 1 when one
    piece does not."""
    st, p = wide_stage(Vh, F, Ne), WIDE_PIECES
    while p > 1 and 4 * _wide_floats(Vh, F, Ne, p, st) > WIDE_ROOM:
        p -= 1
    return p


def wide_bytes(Vh: int, F: int, Ne: int) -> int:
    """Shared bytes of a wide CTA (``surtr_pack_wide_bytes``): its pieces'
    packed rows and AABB rows and, where ``wide_stage``, their raw corners,
    each span with 3 floats of room to match its global span's alignment,
    and the corner masks' bytes."""
    return 4 * _wide_floats(Vh, F, Ne, wide_pieces(Vh, F, Ne), wide_stage(Vh, F, Ne))


def _variant(Vh: int, F: int, Ne: int) -> str:
    """"staged" (a block's rows built in shared memory, written as one
    span) where they fit 48 KB; past it "wide" (a warp a piece, the CTA's
    rows staged in opt-in shared memory, each fold over all 32 lanes)
    while one piece's CTA fits a block's 232,448 B; else "direct" (each row
    built in place in the output): any hull size has a variant."""
    if stage_bytes(Vh, F, Ne) <= STAGE_BYTES:
        return "staged"
    return "wide" if wide_bytes(Vh, F, Ne) <= MAX_SMEM else "direct"


def pack_layout(Vh: int, F: int, Ne: int):
    """(offsets {name: (start, count)}, D) of the packed row: fields back to
    back, in the JAX package's order."""
    offs = {}
    o = 0
    fields = [
        ("wvx", Vh), ("wvy", Vh), ("wvz", Vh), ("wm", Vh),
        ("pnx", F), ("pny", F), ("pnz", F), ("pd", F), ("pm", F),
        ("lod", 13), ("hid", 13),
        ("ex", Ne), ("ey", Ne), ("ez", Ne), ("em", Ne),
    ]
    for name, n in fields:
        if n:
            offs[name] = (o, n)
            o += n
    return offs, o


def _rot(q: torch.Tensor):
    """The nine rotation entries of ``rigid.quat_to_mat`` as (Np, 1)
    columns, each term as the kernel rounds it."""
    qw, qx, qy, qz = (q[:, i : i + 1] for i in range(4))
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)),
    )


def _apply(R, a, b, c):
    return tuple((r[0] * a + r[1] * b) + r[2] * c for r in R)


def _amin(x, dim):
    """``torch.amin`` with -0 below +0, as the card's ``fminf`` orders them:
    PyTorch leaves a tie of the two zeros to its reduction order (the first
    on the CPU, by position on the card), the kernels' folds do not."""
    m = torch.amin(x, dim)
    neg = torch.any((x == 0) & torch.signbit(x), dim)
    return torch.where((m == 0) & neg, -0.0, m)


def _amax(x, dim):
    """``torch.amax`` with +0 above -0 (``fmaxf``)."""
    m = torch.amax(x, dim)
    pos = torch.any((x == 0) & ~torch.signbit(x), dim)
    return torch.where((m == 0) & pos, 0.0, m)


def transform_pack_reference(piece_verts, piece_vmask, piece_planes, piece_pmask,
                             piece_edges, piece_emask, q_own, x_own, pvalid, margin: float):
    """Plain version. Inputs piece-major; ``q_own``/``x_own`` are the owner
    body's pose per piece. Returns (packed (Np, D), aabb (Np, 9))."""
    f32 = piece_verts.dtype
    R = _rot(q_own)
    x0, y0, z0 = (x_own[:, i : i + 1] for i in range(3))
    vm = piece_vmask
    wvx, wvy, wvz = _apply(R, *piece_verts.unbind(-1))
    wvx, wvy, wvz = wvx + x0, wvy + y0, wvz + z0
    wnx, wny, wnz = _apply(R, *piece_planes[..., :3].unbind(-1))
    wd = piece_planes[..., 3] - ((wnx * x0 + wny * y0) + wnz * z0)
    dop = dop26_directions(f32, piece_verts.device)
    t = (wvx[..., None] * dop[:, 0] + wvy[..., None] * dop[:, 1]) + wvz[..., None] * dop[:, 2]
    lod = _amin(torch.where(vm[..., None], t, BIG), 1)
    hid = _amax(torch.where(vm[..., None], t, -BIG), 1)
    rows = [wvx, wvy, wvz, vm.to(f32), wnx, wny, wnz, wd, piece_pmask.to(f32), lod, hid]
    if piece_edges.shape[1]:
        rows += [*_apply(R, *piece_edges.unbind(-1)), piece_emask.to(f32)]
    packed = torch.cat(rows, dim=1)

    lo = [_amin(torch.where(vm, c, BIG), 1) - margin for c in (wvx, wvy, wvz)]
    hi = [_amax(torch.where(vm, c, -BIG), 1) + margin for c in (wvx, wvy, wvz)]
    ctr = [torch.where(pvalid, (a + b) * 0.5, BIG) for a, b in zip(lo, hi)]
    return packed, torch.stack(lo + hi + ctr, dim=1)


def transform_pack_owned_reference(piece_verts, piece_vmask, piece_planes, piece_pmask,
                                   piece_edges, piece_emask, piece_owner, piece_valid, q, x,
                                   margin: float):
    """Plain version of the kernel: each piece's owner clamped to [0, B)
    gives its pose (``q`` (B, 4), ``x`` (B, 3)); a piece is valid where
    ``piece_valid`` holds and its owner is not negative. Returns (packed
    (Np, D), aabb (Np, 9))."""
    own = torch.clamp(piece_owner, 0, q.shape[0] - 1).long()
    pvalid = piece_valid & (piece_owner >= 0)
    return transform_pack_reference(piece_verts, piece_vmask, piece_planes, piece_pmask,
                                    piece_edges, piece_emask, q[own], x[own], pvalid, margin)


def _kernel(piece_verts, piece_vmask, piece_planes, piece_pmask, piece_edges, piece_emask,
            piece_owner, piece_valid, q, x, margin):
    global launches, general_launches, fallback_launches
    Np, Vh = piece_verts.shape[:2]
    F, Ne = piece_planes.shape[1], piece_edges.shape[1]
    B = q.shape[0]
    dev = piece_verts.device
    _, D = pack_layout(Vh, F, Ne)
    f = [t.contiguous() for t in (piece_verts, piece_planes, piece_edges, q, x)]
    for t in f:
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError("pack kernel takes float32 tensors on one device")
    if (f[0].shape != (Np, Vh, 3) or f[1].shape != (Np, F, 4) or f[2].shape != (Np, Ne, 3)
            or f[3].shape != (B, 4) or f[4].shape != (B, 3) or piece_owner.shape != (Np,)
            or piece_valid.shape != (Np,) or (Np and B == 0)):
        raise ValueError("pack kernel: inconsistent shapes")
    masks = []
    for t in (piece_vmask, piece_pmask, piece_emask, piece_valid):
        if t.dtype != torch.bool or t.device != dev:
            raise TypeError("pack kernel takes bool masks on the pieces' device")
        masks.append(t.contiguous().view(torch.uint8))
    own = piece_owner.to(torch.int32).contiguous()
    dop = dop26_directions(torch.float32, dev)
    packed = torch.empty((Np, D), dtype=torch.float32, device=dev)
    aabb = torch.empty((Np, 9), dtype=torch.float32, device=dev)
    if Np == 0:
        return packed, aabb
    variant = _variant(Vh, F, Ne)
    fn = _build.bind("surtr_pack", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                     + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(f[0].data_ptr(), masks[0].data_ptr(), f[1].data_ptr(), masks[1].data_ptr(),
            f[2].data_ptr(), masks[2].data_ptr(), own.data_ptr(), masks[3].data_ptr(),
            f[3].data_ptr(), f[4].data_ptr(), dop.data_ptr(), Np, B, Vh, F, Ne, float(margin),
            packed.data_ptr(), aabb.data_ptr(), VARIANTS.index(variant), _build.stream_ptr(dev))
    _build.check(rc, "surtr_pack")
    launches += 1
    general_launches += variant != "staged"
    fallback_launches += variant == "direct"
    return packed, aabb


def transform_pack_owned(piece_verts, piece_vmask, piece_planes, piece_pmask, piece_edges,
                         piece_emask, piece_owner, piece_valid, q, x, margin: float):
    """(packed (Np, D), aabb (Np, 9)) of the pieces at their owners' poses:
    the kernel for CUDA tensors, the plain version for CPU tensors. The
    step's entry: the owner gather and the valid mask happen inside."""
    args = (piece_verts, piece_vmask, piece_planes, piece_pmask, piece_edges, piece_emask,
            piece_owner, piece_valid, q, x, margin)
    if piece_verts.is_cuda:
        return _kernel(*args)
    if piece_verts.device.type != "cpu":
        raise ValueError(f"transform_pack_owned: unsupported device {piece_verts.device}")
    return transform_pack_owned_reference(*args)
