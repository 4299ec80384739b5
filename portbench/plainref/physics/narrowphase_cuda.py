"""Pair narrowphase with device dispatch (kernel B7, ``csrc/narrowphase.cu``;
replaces ``surtr_tpu/physics/narrowphase_pallas.py`` ``_narrow_kernel`` via
``narrowphase_raw_pallas``).

For each (piece i, k-th candidate j = pidx[i, k]) pair: SAT over the 13 DOP
axes, j's faces, i's faces and the Ne² edge cross axes (least penetration,
first of ties in that order) for the j → i normal and depth; then the M
deepest contained corners of either hull (first of ties) as contact points,
with the support-point fallback when none is contained, and a feature id per
point (i-corner v → v + 1, j-corner v → Vh + v + 1, fallback → 2Vh + fi·Vh +
fj + 1).

Output (Np, K, 5 + 6M) f32: [nx, ny, nz, depth, hit] then per point m
[val, hit, px, py, pz, fid] — the JAX kernel's output rows, pair-major.
``narrowphase`` runs the plain version for CPU tensors and the kernel, or
raises, for CUDA tensors: the staged kernel at Vh 8, 16, 32 and 64, the
group kernel (a group of lanes a pair, each manifold candidate scored once)
at any other shape whose rows fit a block's shared memory, the
thread-a-pair general kernel only past that (``_variant``). ``narrowphase_reference(..., divide=True)`` is
also the JAX package's XLA narrowphase (``physics_step`` with
``pallas_narrowphase`` off), plain PyTorch on either device: the XLA code
normalises the edge cross axes by division where the kernel multiplies by a
reciprocal, which moves an axis by an ulp and, through near ties, the pick.
"""

from __future__ import annotations

import ctypes

import torch

from plainref import _build
from plainref.ops.kdop import dop26_directions
from plainref.ops.linalg import sqrt_rn
from plainref.physics.pack_cuda import pack_layout

BIG = 3.4e38

launches = 0           # kernel launches since the last reset (main-path proof), every variant
general_launches = 0   # of which past the staged kernel's shapes (the group and general variants)
fallback_launches = 0  # of which the "general" variant's (rows past a block's shared memory)

MAX_SMEM = 232448  # bytes of shared memory a Hopper block can use
VARIANTS = ("staged", "group", "general")


def staged_bytes(Vh: int, K: int, F: int, Ne: int, M: int) -> int:
    """Shared bytes of the staged kernel at this shape (``launch`` in
    csrc/narrowphase.cu), 0 where it does not take it: Vh not in (8, 16,
    32, 64), or a pair's record (5 + 6M floats) wider than the staged row
    it replaces."""
    if Vh not in (8, 16, 32, 64):
        return 0
    PB = 128 // (Vh // 4)
    D = 4 * Vh + 5 * F + 26 + 4 * Ne
    own_cap = (((PB - 1) // K + 2) * D + 9) // 4 * 4
    slot = (D + 9) // 4 * 4
    if slot < 5 + 6 * M:
        return 0
    return 4 * (own_cap + PB * slot)


def group_lanes(Vh: int) -> int:
    """Lanes of a pair's group in the group variant: the least power of two
    G with 6·G >= Vh, at most 32 (a lane holds up to six corners of each
    hull in registers; past 192 it reads them from shared memory)."""
    g = 1
    while g < 32 and 6 * g < Vh:
        g *= 2
    return g


def group_bytes(Vh: int, K: int, F: int, Ne: int, M: int) -> int:
    """Shared bytes of the group variant at this shape (``group_smem`` in
    csrc/narrowphase.cu): the own rows' span of a block's 128 / G pairs,
    each pair's partner row in a slot padded so that a warp's groups start
    G banks apart, 2Vh candidate scores a pair, and a record a pair where
    it fits a row slot (wider records go straight to device memory)."""
    G = group_lanes(Vh)
    PB = 128 // G
    D = 4 * Vh + 5 * F + 26 + 4 * Ne
    own_cap = (((PB - 1) // K + 2) * D + 9) // 4 * 4
    slot = (D + 9) // 4 * 4
    if G < 32:
        slot += (max(G, 4) - slot % 32) % 32
    R = 5 + 6 * M
    return 4 * (own_cap + PB * slot + PB * 2 * Vh + (PB * R if R <= slot else 0))


def _variant(Vh: int, K: int, F: int, Ne: int, M: int) -> str:
    """"staged" (a group of Vh / 4 lanes a pair, four corners of each hull a
    lane in registers) where that kernel takes the shape and its rows fit a
    block's shared memory; else "group" (a group of ``group_lanes(Vh)``
    lanes a pair, corners read from the staged rows, each candidate scored
    once) where its rows fit; else "general" (one thread a pair, rows read
    in place): every shape the plain version takes has a variant."""
    room = MAX_SMEM - 39 * 4   # beside the DOP table
    if 0 < staged_bytes(Vh, K, F, Ne, M) <= room:
        return "staged"
    return "group" if Vh >= 1 and group_bytes(Vh, K, F, Ne, M) <= room else "general"


def out_rows(M: int) -> int:
    return 5 + 6 * M


def live_records(raw, M: int):
    """Records (..., 5 + 6M) with every field that is not live set to 0: the
    pair's [n, depth, hit] where the pair hits, each point's [val, hit, p,
    fid] where the point hits. Unfilled points hold -BIG, so a sum over the
    raw records overflows; over the live ones it does not."""
    keep = torch.zeros_like(raw, dtype=torch.bool)
    keep[..., :5] = raw[..., 4:5] > 0.5
    for m in range(M):
        o = 5 + 6 * m
        keep[..., o : o + 6] = raw[..., o + 1 : o + 2] > 0.5
    return torch.where(keep, raw, 0.0)


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def narrowphase_reference(packed, pidx, pok, Vh: int, F: int, Ne: int, M: int, slop: float,
                          divide: bool = False):
    """Plain version: packed (Np, D) from ``transform_pack_owned``, pidx (Np, K),
    pok (Np, K) → (Np, K, 5 + 6M). ``divide`` normalises the edge axes by
    division, as the JAX package's XLA narrowphase does (module docstring)."""
    Np, K = pidx.shape
    offs, _ = pack_layout(Vh, F, Ne)
    pj = packed[torch.clamp(pidx.long(), 0, Np - 1)]            # (Np, K, D)
    pi = packed[:, None, :]                                      # (Np, 1, D)

    def take(rows, name):
        o, n = offs[name]
        return rows[..., o : o + n]

    iv = [take(pi, n)[..., :, None] for n in ("wvx", "wvy", "wvz")]   # (Np,1,Vh,1)
    jv = [take(pj, n)[..., :, None] for n in ("wvx", "wvy", "wvz")]   # (Np,K,Vh,1)
    im = take(pi, "wm") > 0.5
    jm = take(pj, "wm") > 0.5
    ipn = [take(pi, n)[..., None, :] for n in ("pnx", "pny", "pnz")]  # (Np,1,1,F)
    jpn = [take(pj, n)[..., None, :] for n in ("pnx", "pny", "pnz")]
    ipd, jpd = take(pi, "pd")[..., None, :], take(pj, "pd")[..., None, :]
    ipm, jpm = take(pi, "pm") > 0.5, take(pj, "pm") > 0.5
    dop = dop26_directions(packed.dtype, packed.device)

    pens, msks, dirs = [], [], []
    # (1) 26-DOP interval axes.
    ilo, ihi, jlo, jhi = take(pi, "lod"), take(pi, "hid"), take(pj, "lod"), take(pj, "hid")
    ov = torch.minimum(ihi, jhi) - torch.maximum(ilo, jlo)       # (Np, K, 13)
    sgn = torch.where((ihi + ilo) < (jhi + jlo), -1.0, 1.0)
    pens.append(ov)
    msks.append(torch.ones_like(ov, dtype=torch.bool))
    dirs.append(sgn[..., None] * dop)
    # (2) i's corners against j's planes; (3) j's corners against i's.
    dist_ij = _dot(iv, jpn) + jpd                                # (Np, K, Vh, F)
    dist_ji = _dot(jv, ipn) + ipd
    pen_fj = -torch.amin(torch.where(im[..., :, None], dist_ij, BIG), dim=-2)
    pen_fi = -torch.amin(torch.where(jm[..., :, None], dist_ji, BIG), dim=-2)
    pens += [pen_fj, pen_fi.expand(Np, K, F)]
    msks += [jpm, ipm.expand(Np, K, F)]
    dirs += [torch.stack([p[..., 0, :] for p in jpn], -1).expand(Np, K, F, 3),
             -torch.stack([p[..., 0, :] for p in ipn], -1).expand(Np, K, F, 3)]
    # (4) edge x edge cross axes, i's edge major.
    if Ne:
        ie = [take(pi, n)[..., :, None] for n in ("ex", "ey", "ez")]  # (Np,1,Ne,1)
        je = [take(pj, n)[..., None, :] for n in ("ex", "ey", "ez")]  # (Np,K,1,Ne)
        cx = (ie[1] * je[2] - ie[2] * je[1]).reshape(Np, K, Ne * Ne)
        cy = (ie[2] * je[0] - ie[0] * je[2]).reshape(Np, K, Ne * Ne)
        cz = (ie[0] * je[1] - ie[1] * je[0]).reshape(Np, K, Ne * Ne)
        nl = sqrt_rn((cx * cx + cy * cy) + cz * cz)
        den = torch.clamp(nl, min=1e-30)
        if divide:
            c = [cx / den, cy / den, cz / den]
        else:
            inv = 1.0 / den
            c = [cx * inv, cy * inv, cz * inv]
        emk = ((take(pi, "em")[..., :, None] > 0.5) & (take(pj, "em")[..., None, :] > 0.5))
        emk = emk.reshape(Np, K, Ne * Ne) & (nl > 1e-6)
        cc = [t[..., None, :] for t in c]                        # (Np,K,1,E2)
        ti = _dot(iv, cc)                                        # (Np,K,Vh,E2)
        tj = _dot(jv, cc)
        imv, jmv = im[..., :, None], jm[..., :, None]
        ilo_e = torch.amin(torch.where(imv, ti, BIG), dim=-2)
        ihi_e = torch.amax(torch.where(imv, ti, -BIG), dim=-2)
        jlo_e = torch.amin(torch.where(jmv, tj, BIG), dim=-2)
        jhi_e = torch.amax(torch.where(jmv, tj, -BIG), dim=-2)
        se = torch.where((ihi_e + ilo_e) < (jhi_e + jlo_e), -1.0, 1.0)
        pens.append(torch.minimum(ihi_e, jhi_e) - torch.maximum(ilo_e, jlo_e))
        msks.append(emk)
        dirs.append(torch.stack([t * se for t in c], -1))

    # A masked axis counts BIG, but NaN where its penetration is not finite
    # (an edge axis against a piece with no live corner: -inf): the JAX
    # kernel masks by pen·mask + (1 - mask)·BIG. Any NaN axis makes the pair
    # depth NaN and its normal 0, as the kernel's min and one-hot pick do.
    pens, msk = torch.cat(pens, -1), torch.cat(msks, -1)
    pen_all = torch.where(msk, pens, torch.where(torch.isfinite(pens), BIG, float("nan")))
    undefined = torch.isnan(pen_all).any(-1)
    a = torch.argmin(torch.nan_to_num(pen_all, nan=BIG), dim=-1, keepdim=True)   # first of ties
    depth = torch.where(undefined, float("nan"), torch.gather(pen_all, -1, a)[..., 0])
    dir_all = torch.cat(dirs, -2)
    n = torch.gather(dir_all, -2, a[..., None].expand(Np, K, 1, 3))[..., 0, :]
    n = torch.where(undefined[..., None], 0.0, n)
    hit = pok & (depth > -slop) & (depth < BIG / 2)

    # Containment manifold, deepest first.
    nn = [n[..., c, None] for c in range(3)]                     # (Np,K,1)
    ivs = [t[..., 0] for t in iv]                                # (Np,1,Vh)
    jvs = [t[..., 0] for t in jv]
    si = _dot(ivs, nn)                                           # (Np,K,Vh)
    sj = _dot(jvs, nn)
    si_min = torch.amin(torch.where(im, si, BIG), dim=-1, keepdim=True)
    sj_max = torch.amax(torch.where(jm, sj, -BIG), dim=-1, keepdim=True)
    inside_j = torch.amax(torch.where(jpm[..., None, :], dist_ij, -BIG), dim=-1) <= slop
    inside_i = torch.amax(torch.where(ipm[..., None, :], dist_ji, -BIG), dim=-1) <= slop
    depth_iv = sj_max - si
    depth_jv = sj - si_min
    sc = torch.cat([torch.where(inside_j & im, depth_iv, -BIG),
                    torch.where(inside_i & jm, depth_jv, -BIG)], dim=-1)   # (Np,K,2Vh)
    hiv, hjv = depth_iv * 0.5, depth_jv * 0.5
    pts = torch.cat(
        [torch.stack([ivs[c] + nn[c] * hiv for c in range(3)], -1),
         torch.stack([jvs[c] - nn[c] * hjv for c in range(3)], -1)], dim=-2)  # (Np,K,2Vh,3)

    recs = []
    any_h = torch.zeros_like(hit)
    for _ in range(M):
        b = torch.argmax(sc, dim=-1, keepdim=True)               # first of ties
        mval = torch.gather(sc, -1, b)[..., 0]
        p = torch.gather(pts, -2, b[..., None].expand(Np, K, 1, 3))[..., 0, :]
        h = hit & (mval > -slop) & (mval < BIG / 2)
        any_h |= h
        recs.append([mval, h, p, (b[..., 0] + 1).to(pts.dtype)])
        sc = sc.scatter(-1, b, -BIG)

    # Fallback: deepest support corners when nothing is contained.
    none = hit & ~any_h
    fi = torch.argmax(torch.where(im, -si, -BIG), dim=-1)
    fj = torch.argmax(torch.where(jm, sj, -BIG), dim=-1)
    has_i = im.any(-1).expand(Np, K)
    has_j = jm.any(-1).expand(Np, K)
    ivv = torch.stack(ivs, -1).expand(Np, K, Vh, 3)
    jvv = torch.stack(jvs, -1)
    pick = lambda v, i: torch.gather(v, 2, i[..., None, None].expand(Np, K, 1, 3))[:, :, 0]  # noqa: E731
    pi_pt = torch.where(has_i[..., None], pick(ivv, fi), 0.0)
    pj_pt = torch.where(has_j[..., None], pick(jvv, fj), 0.0)
    fb_pt = 0.5 * (pi_pt + pj_pt)
    fid_fb = ((2.0 * Vh + torch.where(has_i, fi, 0).to(pts.dtype) * Vh)
              + torch.where(has_j, fj + 1, 0).to(pts.dtype))
    mval, h, p, fid = recs[0]
    recs[0] = [torch.where(none, depth, mval), h | none,
               torch.where(none[..., None], fb_pt, p), torch.where(none, fid_fb, fid)]

    f32 = pts.dtype
    cols = [n, depth[..., None], hit.to(f32)[..., None]]
    for mval, h, p, fid in recs:
        cols += [mval[..., None], h.to(f32)[..., None], p, fid[..., None]]
    return torch.cat(cols, dim=-1)


def _kernel(packed, pidx, pok, Vh, F, Ne, M, slop):
    global launches, general_launches, fallback_launches
    Np, K = pidx.shape
    dev = packed.device
    _, D = pack_layout(Vh, F, Ne)
    if packed.dtype != torch.float32 or packed.shape != (Np, D) or pok.shape != (Np, K):
        raise ValueError("narrowphase kernel: packed must be (Np, D) float32, pok (Np, K)")
    variant = _variant(Vh, K, F, Ne, M)
    pk = packed.contiguous()
    if pk.data_ptr() % 16 and variant != "general":   # rows are staged 16 bytes at a time
        pk = pk.clone()
    pi = pidx.to(torch.int32).contiguous()
    po = pok.to(torch.uint8).contiguous()
    for t in (pi, po):
        if t.device != dev:
            raise TypeError("narrowphase kernel takes tensors on one device")
    dop = dop26_directions(torch.float32, dev)
    out = torch.empty((Np, K, out_rows(M)), dtype=torch.float32, device=dev)
    if Np * K == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    args = (pk.data_ptr(), pi.data_ptr(), po.data_ptr(), dop.data_ptr(), Np, K, Vh, F, Ne, M,
            float(slop))
    if variant == "group":
        name = "surtr_narrowphase_group"
        fn = _build.bind(name, [P] * 4 + [I] * 6 + [ctypes.c_float, P, P])
        rc = fn(*args, out.data_ptr(), _build.stream_ptr(dev))
    else:
        name = "surtr_narrowphase"
        fn = _build.bind(name, [P] * 4 + [I] * 6 + [ctypes.c_float, I, P, P])
        rc = fn(*args, int(variant == "general"), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    launches += 1
    general_launches += variant != "staged"
    fallback_launches += variant == "general"
    return out


def narrowphase(packed, pidx, pok, Vh: int, F: int, Ne: int, M: int, slop: float):
    """(Np, K, 5 + 6M) pair records: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if packed.is_cuda:
        return _kernel(packed, pidx, pok, Vh, F, Ne, M, slop)
    if packed.device.type != "cpu":
        raise ValueError(f"narrowphase: unsupported device {packed.device}")
    return narrowphase_reference(packed, pidx, pok, Vh, F, Ne, M, slop)
