"""Contact prep with device dispatch (kernel B8, ``csrc/prep.cu``; replaces
``surtr_tpu/physics/prep_pallas.py`` ``_prep_kernel`` via
``prep_contacts_pallas``).

Single-piece bodies: row i is body i. C = K·M + G contact slots per row,
slot = m·K + k for pair slots, then G ground slots. The step's entry,
``prep_from_records``, takes the narrowphase's pair records (Np, K, 5+6M),
the partners, the ground contacts and the bodies' fields; its kernel
assembles the slots and gathers the partners itself. Its plain version is
``slot_tables`` (that assembly in PyTorch) followed by
``prep_contacts_reference``, whose inputs are the assembled slot tables as
the JAX package lays them out:

  pt3 (Np, 3C)  [px | py | pz] contact points
  dh  (Np, 2C)  [depth | hit]
  pn3 (Np, 3K)  per-pair normals [nx | ny | nz] (ground slots get +y)
  btf (Np, 20K) per-pair partner fields, field-major:
                [xB(3) | inv_m | inv_I(9) | v0(3) | w0(3) | asleep]
  own (Np, 19)  [x(3) | v0(3) | w0(3) | inv_m | inv_I(9)]

Per slot: lever arms rA, rB; the effective mass 1/(kA + kB) of the normal
row; the restitution/Baumgarte target with the bounce threshold (no bias
against a sleeping partner); the pre-solve normal velocity vn0. Per row:
the mass-splitting scale 1/max(#hits, 1). Outputs, tight (no lane padding):

  rA, rB, n (Np, 3C) [x | y | z];  mt (Np, 2C) [m_eff | target];
  hs (Np, 2C) [hit | static];  scale (Np, 2) [inv_m·split, split];
  iAI (Np, 9) own world inverse inertia;  vn0 (Np, C)

``prep_from_records`` runs the plain version for CPU tensors and the
kernel, or raises, for CUDA tensors; ``prep_contacts`` takes the slot
tables and the CPU only.
"""

from __future__ import annotations

import ctypes

import torch

from plainref import _build
from plainref.physics.slots import expand_slots, slot_rows, slot_sum, tangent_basis

launches = 0          # kernel launches since the last reset (main-path proof), every variant
general_launches = 0  # of which the wide variant's, either kind (one a call)

STAGE_BYTES = 48 * 1024    # shared memory the shared variant takes a block at most
MAX_SMEM = 232448          # shared memory a block may opt in to (H100)
WIDE_ROOM = MAX_SMEM // 3  # the wide variant's shared memory at most: 3+ CTAs an SM
VARIANTS = ("shared", "wide", "wide_inplace")   # the C entry's variant codes 0, 1, 2


def row_bytes(K: int, M: int, G: int) -> int:
    """Bytes one row stages: its K records, K partners' fields (stride 21),
    own 19 fields, G ground slots (5 floats) and C slot hits."""
    return 4 * (K * (5 + 6 * M) + K * 21 + 19 + 5 * G + K * M + G)


def wide_partners(K: int, M: int, stage: bool) -> int:
    """Partners a pass of the wide variant takes: as many as ``WIDE_ROOM``
    holds at 21 floats each and, with ``stage``, their 5 + 6M record floats
    (4 floats of room to align the records' copy), at most K; 0 when one
    does not fit."""
    per = (5 + 6 * M if stage else 0) + 21
    return min(K, (WIDE_ROOM // 4 - (4 if stage else 0)) // per)


def wide_bytes(K: int, M: int, stage: bool) -> int:
    """Shared bytes of the wide variant's CTA."""
    per = (5 + 6 * M if stage else 0) + 21
    return 4 * (wide_partners(K, M, stage) * per + (4 if stage else 0))


def _variant(K: int, M: int, G: int) -> str:
    """"shared" (rows staged in shared memory, ~256 / C rows a block) where
    one row fits 48 KB; past it "wide" (a CTA a row, its partners' fields
    and records staged a pass of ``wide_partners`` at a time in opt-in
    shared memory, the ground slots read in place, the hit count a block
    vote) where one partner's record fits ``WIDE_ROOM``, else
    "wide_inplace" (the same with the records read in place): every shape
    the plain version takes has a variant."""
    if row_bytes(K, M, G) <= STAGE_BYTES:
        return "shared"
    return "wide" if wide_partners(K, M, True) >= 1 else "wide_inplace"


def prep_contacts_reference(pt3, dh, pn3, btf, own, *, K: int, M: int, G: int, dt: float,
                            slop: float, baumgarte: float, restitution: float,
                            bounce_thr: float):
    """Plain version; every formula in the kernel's order."""
    Np = pt3.shape[0]
    C = K * M + G
    ptx, pty, ptz = pt3[:, :C], pt3[:, C : 2 * C], pt3[:, 2 * C :]
    dep, hit = dh[:, :C], dh[:, C:]
    ground = (torch.arange(C, device=pt3.device) >= K * M).to(pt3.dtype).expand(Np, C)
    nx = expand_slots(pn3[:, :K], M, G)
    ny = expand_slots(pn3[:, K : 2 * K], M, G) + ground
    nz = expand_slots(pn3[:, 2 * K :], M, G)

    bf = [expand_slots(btf[:, i * K : (i + 1) * K], M, G) for i in range(20)]
    xBx, xBy, xBz, iBm = bf[0], bf[1], bf[2], bf[3]
    iB = bf[4:13]
    vB0x, vB0y, vB0z, wB0x, wB0y, wB0z = bf[13:19]
    stat = torch.clamp(bf[19] + ground, max=1.0)
    live = 1.0 - stat

    o = [own[:, i : i + 1] for i in range(19)]
    ox, oy, oz, v0x, v0y, v0z, w0x, w0y, w0z, invm = o[:10]
    II = o[10:19]

    rAx, rAy, rAz = ptx - ox, pty - oy, ptz - oz
    rBx, rBy, rBz = ptx - xBx, pty - xBy, ptz - xBz

    cAx = rAy * nz - rAz * ny
    cAy = rAz * nx - rAx * nz
    cAz = rAx * ny - rAy * nx
    tAx = (II[0] * cAx + II[1] * cAy) + II[2] * cAz
    tAy = (II[3] * cAx + II[4] * cAy) + II[5] * cAz
    tAz = (II[6] * cAx + II[7] * cAy) + II[8] * cAz
    kA = ((invm + cAx * tAx) + cAy * tAy) + cAz * tAz
    cBx = rBy * nz - rBz * ny
    cBy = rBz * nx - rBx * nz
    cBz = rBx * ny - rBy * nx
    tBx = (iB[0] * cBx + iB[1] * cBy) + iB[2] * cBz
    tBy = (iB[3] * cBx + iB[4] * cBy) + iB[5] * cBz
    tBz = (iB[6] * cBx + iB[7] * cBy) + iB[8] * cBz
    kB = live * (((iBm + cBx * tBx) + cBy * tBy) + cBz * tBz)
    kn = kA + kB
    meff = torch.where((hit > 0.5) & (kn > 1e-12), 1.0 / torch.clamp(kn, min=1e-12), 0.0)

    vAx = v0x + (w0y * rAz - w0z * rAy)
    vAy = v0y + (w0z * rAx - w0x * rAz)
    vAz = v0z + (w0x * rAy - w0y * rAx)
    vBx = live * (vB0x + (wB0y * rBz - wB0z * rBy))
    vBy = live * (vB0y + (wB0z * rBx - wB0x * rBz))
    vBz = live * (vB0z + (wB0x * rBy - wB0y * rBx))
    vn0 = ((vAx - vBx) * nx + (vAy - vBy) * ny) + (vAz - vBz) * nz
    bounce = -restitution * torch.clamp(vn0 + bounce_thr, max=0.0)
    bias = (baumgarte / dt) * torch.clamp(torch.clamp(dep, min=0.0) - slop, min=0.0)
    sleeper = stat * (1.0 - ground)
    bias = bias * (1.0 - sleeper)
    targ = torch.maximum(bounce, bias)

    # Mass splitting: per-row hit count (a sum of 0/1, exact in any order).
    split = 1.0 / torch.clamp(torch.sum(hit, dim=1, keepdim=True), min=1.0)
    return (
        torch.cat([rAx, rAy, rAz], 1), torch.cat([rBx, rBy, rBz], 1), torch.cat([nx, ny, nz], 1),
        torch.cat([meff, targ], 1), torch.cat([hit, stat], 1),
        torch.cat([invm * split, split], 1), torch.cat(II, 1), vn0,
    )


def slot_tables(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in, *, M: int):
    """(pt3, dh, pn3, btf, own) of ``prep_contacts_reference`` from the pair
    records: the slot assembly and partner gather the kernel does itself,
    as the step's glue did them in plain PyTorch."""
    Np, K = pidx.shape
    f32 = raw.dtype
    val, mh, px, py, pz = (slot_rows(raw, r, M) for r in range(5, 10))
    pn3 = raw[:, :, 0:3].permute(0, 2, 1).reshape(Np, 3 * K)
    pt3 = torch.cat([px, g_pts[..., 0], py, g_pts[..., 1], pz, g_pts[..., 2]], dim=1)
    dh = torch.cat([torch.clamp(val, min=0.0), torch.clamp(gd, min=0.0), mh, g_hit.to(f32)],
                   dim=1)
    btab = torch.cat([x, inv_m[:, None], inv_I, v0, w0, asleep_in.to(f32)[:, None]],
                     dim=1)                                                     # (Np, 20)
    pb = torch.clamp(pidx.long(), 0, Np - 1)
    btf = btab[pb].transpose(1, 2).reshape(Np, 20 * K)
    own = torch.cat([x, v0, w0, inv_m[:, None], inv_I], dim=1)
    return pt3, dh, pn3, btf, own


def prep_from_records_reference(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in,
                                *, K: int, M: int, G: int, dt: float, slop: float,
                                baumgarte: float, restitution: float, bounce_thr: float):
    """Plain version of the kernel: ``slot_tables`` then
    ``prep_contacts_reference``."""
    tabs = slot_tables(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in, M=M)
    return prep_contacts_reference(*tabs, K=K, M=M, G=G, dt=dt, slop=slop, baumgarte=baumgarte,
                                   restitution=restitution, bounce_thr=bounce_thr)


def _kernel(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in, K, M, G, dt, slop,
            baumgarte, restitution, bounce_thr):
    global launches, general_launches
    Np = pidx.shape[0]
    C = K * M + G
    dev = raw.device
    f = [t.contiguous() for t in (raw, g_pts, x, v0, w0, inv_m, inv_I)]
    shapes = ((Np, K, 5 + 6 * M), (Np, G, 3), (Np, 3), (Np, 3), (Np, 3), (Np,), (Np, 9))
    for t, shape in zip(f, shapes):
        if t.dtype != torch.float32 or t.device != dev or t.shape != shape:
            raise ValueError("prep kernel: float32 raw (Np, K, 5+6M), g_pts (Np, G, 3), x, v0, "
                             "w0 (Np, 3), inv_m (Np,), inv_I (Np, 9) on one device")
    if gd.dtype != torch.float32 or gd.device != dev or gd.shape != (Np, G):
        raise ValueError("prep kernel: gd must be float32 (Np, G) on the records' device")
    if G and Np and gd.stride(1) != 1:
        gd = gd.contiguous()
    flags = []
    for t, shape in ((g_hit, (Np, G)), (asleep_in, (Np,))):
        if t.dtype != torch.bool or t.device != dev or t.shape != shape:
            raise ValueError("prep kernel: g_hit (Np, G) and asleep_in (Np,) are bool on the "
                             "records' device")
        flags.append(t.contiguous().view(torch.uint8))
    if pidx.shape != (Np, K) or pidx.device != dev:
        raise ValueError("prep kernel: pidx must be (Np, K) on the records' device")
    pi = pidx.to(torch.int32).contiguous()
    e = lambda w: torch.empty((Np, w), dtype=torch.float32, device=dev)  # noqa: E731
    outs = [e(3 * C), e(3 * C), e(3 * C), e(2 * C), e(2 * C), e(2), e(9), e(C)]
    if Np == 0:
        return tuple(outs)
    variant = _variant(K, M, G)
    fn = _build.bind("surtr_prep", [ctypes.c_void_p] * 4 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                     + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(f[0].data_ptr(), pi.data_ptr(), f[1].data_ptr(), gd.data_ptr(),
            gd.stride(0) if G else 0, flags[0].data_ptr(), *[t.data_ptr() for t in f[2:]],
            flags[1].data_ptr(), *[t.data_ptr() for t in outs], Np, K, M, G, float(slop),
            float(baumgarte / dt), float(-restitution), float(bounce_thr),
            VARIANTS.index(variant), _build.stream_ptr(dev))
    _build.check(rc, "surtr_prep")
    launches += 1
    general_launches += variant != "shared"
    return tuple(outs)


def prep_from_records(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in, *, K: int,
                      M: int, G: int, dt: float, slop: float, baumgarte: float,
                      restitution: float, bounce_thr: float):
    """The solver's tables from the narrowphase's pair records (Np, K, 5+6M),
    the partners ``pidx`` (Np, K), the ground contacts (``g_pts`` (Np, G, 3),
    ``gd`` (Np, G), ``g_hit`` (Np, G) bool) and the bodies' ``x``, start
    velocities ``v0``, ``w0``, ``inv_m``, world ``inv_I`` (Np, 9) and
    ``asleep_in`` (Np,) bool: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    kw = dict(K=K, M=M, G=G, dt=dt, slop=slop, baumgarte=baumgarte, restitution=restitution,
              bounce_thr=bounce_thr)
    args = (raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in)
    if raw.is_cuda:
        return _kernel(*args, **kw)
    if raw.device.type != "cpu":
        raise ValueError(f"prep_from_records: unsupported device {raw.device}")
    return prep_from_records_reference(*args, **kw)


def prep_contacts(pt3, dh, pn3, btf, own, *, K: int, M: int, G: int, dt: float, slop: float,
                  baumgarte: float, restitution: float, bounce_thr: float):
    """The solver's tables from assembled slot tables (the JAX package's
    ``prep_contacts_pallas`` signature), for CPU tensors. On the card the
    step calls ``prep_from_records``, whose kernel assembles the slots
    itself."""
    if pt3.device.type != "cpu":
        raise ValueError(f"prep_contacts: CPU tensors only, got {pt3.device}; on the card "
                         "call prep_from_records")
    return prep_contacts_reference(pt3, dh, pn3, btf, own, K=K, M=M, G=G, dt=dt, slop=slop,
                                   baumgarte=baumgarte, restitution=restitution,
                                   bounce_thr=bounce_thr)


def warm_preapply(v0, w0, lam0, tables, *, C: int):
    """The matched warm impulse λn·n̂ + λu·û + λv·v̂ applied to the start
    velocities before the accumulated-mode iterations, with the solver's
    own mass-splitting scales and tangent basis (the JAX package's
    ``prep_and_solve`` warm branch). lam0 (Np, C, 3); ``tables`` are B8's
    outputs. Returns (v0, w0, lam0 masked to hit slots). Plain PyTorch on
    both devices, summed in slot order."""
    rA, _, nrm, _, hs, scale, iAI = tables[:7]
    hit = hs[:, :C]
    lam0 = lam0 * (hit > 0.5).to(lam0.dtype)[..., None]
    nx, ny, nz = nrm[:, :C], nrm[:, C : 2 * C], nrm[:, 2 * C :]
    (ux, uy, uz), (vx, vy, vz) = tangent_basis(nx, ny, nz)
    ln, lu, lv = lam0[..., 0], lam0[..., 1], lam0[..., 2]
    ix = (ln * nx + lu * ux) + lv * vx
    iy = (ln * ny + lu * uy) + lv * vy
    iz = (ln * nz + lu * uz) + lv * vz
    rAx, rAy, rAz = rA[:, :C], rA[:, C : 2 * C], rA[:, 2 * C :]
    m_s, s_s = scale[:, 0:1], scale[:, 1:2]
    II = [iAI[:, i : i + 1] for i in range(9)]
    v0 = v0 + m_s * torch.cat([slot_sum(ix), slot_sum(iy), slot_sum(iz)], dim=1)
    tqx = slot_sum(rAy * iz - rAz * iy)
    tqy = slot_sum(rAz * ix - rAx * iz)
    tqz = slot_sum(rAx * iy - rAy * ix)
    w0 = w0 + s_s * torch.cat([(II[0] * tqx + II[1] * tqy) + II[2] * tqz,
                               (II[3] * tqx + II[4] * tqy) + II[5] * tqz,
                               (II[6] * tqx + II[7] * tqy) + II[8] * tqz], dim=1)
    return v0, w0, lam0
